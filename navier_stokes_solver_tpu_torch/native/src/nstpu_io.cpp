// Native (C++) IO runtime of the PyTorch port of the Navier-Stokes solver.
//
// Plays the role the reference's native libraries play for IO: deal.II's
// DataOut::write_vtu_with_pvtu_record (NSSolver.cpp:789-793) and
// GridIn::read_msh (NSSolver.cpp:155-161) are C++; this library provides
// the same services for the host side of the solver.  A plain C ABI,
// consumed through ctypes (no PyTorch headers).
//
// Build: ../__init__.py compiles it at first use with
// g++ -O3 -std=c++17 -shared -fPIC into the package's build/ directory.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// base64 (VTU appended/inline binary encoding)
// ---------------------------------------------------------------------------

const char B64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

void b64_encode(const uint8_t* data, size_t n, std::string& out) {
  out.reserve(out.size() + ((n + 2) / 3) * 4);
  size_t i = 0;
  for (; i + 3 <= n; i += 3) {
    uint32_t v = (data[i] << 16) | (data[i + 1] << 8) | data[i + 2];
    out.push_back(B64[(v >> 18) & 63]);
    out.push_back(B64[(v >> 12) & 63]);
    out.push_back(B64[(v >> 6) & 63]);
    out.push_back(B64[v & 63]);
  }
  if (i + 1 == n) {
    uint32_t v = data[i] << 16;
    out.push_back(B64[(v >> 18) & 63]);
    out.push_back(B64[(v >> 12) & 63]);
    out.push_back('=');
    out.push_back('=');
  } else if (i + 2 == n) {
    uint32_t v = (data[i] << 16) | (data[i + 1] << 8);
    out.push_back(B64[(v >> 18) & 63]);
    out.push_back(B64[(v >> 12) & 63]);
    out.push_back(B64[(v >> 6) & 63]);
    out.push_back('=');
  }
}

// VTU "binary" format: base64( <u32 byte count> <payload> )
void b64_block(const void* data, size_t nbytes, std::string& out) {
  std::vector<uint8_t> buf(4 + nbytes);
  uint32_t header = static_cast<uint32_t>(nbytes);
  std::memcpy(buf.data(), &header, 4);
  std::memcpy(buf.data() + 4, data, nbytes);
  b64_encode(buf.data(), buf.size(), out);
}

void data_array(std::string& s, const char* dtype, const char* name,
                int ncomp, const void* data, size_t nbytes) {
  s += "<DataArray type=\"";
  s += dtype;
  s += "\"";
  if (name) {
    s += " Name=\"";
    s += name;
    s += "\"";
  }
  if (ncomp > 1) {
    char tmp[64];
    std::snprintf(tmp, sizeof tmp, " NumberOfComponents=\"%d\"", ncomp);
    s += tmp;
  }
  s += " format=\"binary\">";
  b64_block(data, nbytes, s);
  s += "</DataArray>\n";
}

}  // namespace

extern "C" {

// Write a single-piece UnstructuredGrid VTU file with velocity/pressure
// point data and a per-cell partitioning field.  Returns 0 on success.
int nstpu_write_vtu(const char* path,
                    const double* points,   // [n_pts * 3]
                    int64_t n_pts,
                    const int32_t* conn,    // [n_cells * 4] quad corners
                    int64_t n_cells,
                    const double* velocity, // [n_pts * 3]
                    const double* pressure, // [n_pts]
                    const double* partitioning /* [n_cells] */) {
  std::string s;
  s.reserve(static_cast<size_t>(n_pts) * 48 + static_cast<size_t>(n_cells) * 8 +
            4096);
  char tmp[160];
  s += "<?xml version=\"1.0\"?>\n";
  s += "<VTKFile type=\"UnstructuredGrid\" version=\"0.1\" "
       "byte_order=\"LittleEndian\">\n<UnstructuredGrid>\n";
  std::snprintf(tmp, sizeof tmp,
                "<Piece NumberOfPoints=\"%lld\" NumberOfCells=\"%lld\">\n",
                static_cast<long long>(n_pts), static_cast<long long>(n_cells));
  s += tmp;

  s += "<Points>\n";
  data_array(s, "Float64", nullptr, 3, points, sizeof(double) * 3 * n_pts);
  s += "</Points>\n<Cells>\n";
  data_array(s, "Int32", "connectivity", 1, conn, sizeof(int32_t) * 4 * n_cells);
  std::vector<int32_t> offsets(n_cells);
  for (int64_t i = 0; i < n_cells; ++i) offsets[i] = 4 * (i + 1);
  data_array(s, "Int32", "offsets", 1, offsets.data(),
             sizeof(int32_t) * n_cells);
  std::vector<uint8_t> types(n_cells, 9);  // VTK_QUAD
  data_array(s, "UInt8", "types", 1, types.data(), n_cells);
  s += "</Cells>\n<PointData Vectors=\"velocity\">\n";
  data_array(s, "Float64", "velocity", 3, velocity,
             sizeof(double) * 3 * n_pts);
  data_array(s, "Float64", "pressure", 1, pressure, sizeof(double) * n_pts);
  s += "</PointData>\n<CellData>\n";
  data_array(s, "Float64", "partitioning", 1, partitioning,
             sizeof(double) * n_cells);
  s += "</CellData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n";

  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  size_t written = std::fwrite(s.data(), 1, s.size(), f);
  std::fclose(f);
  return written == s.size() ? 0 : 2;
}

// ---------------------------------------------------------------------------
// gmsh MSH1 / MSH2 / MSH4.1 parser (GridIn::read_msh equivalent,
// NSSolver.cpp:155-161; deal.II accepts formats 1, 2.x and 4.1)
// ---------------------------------------------------------------------------
//
// Two-phase protocol for ctypes:
//   1. nstpu_msh_open(path) -> handle (parses the whole file), or 0 on error
//   2. nstpu_msh_counts(handle, &n_nodes, &n_tri, &n_quad, &n_edges, &n_tet)
//   3. nstpu_msh_fill(handle, nodes_xy, tri, tri_tag, quad, quad_tag,
//                     edges, edge_tag, tet, tet_tag)  (0-based connectivity)
//   4. nstpu_msh_close(handle)
//
// Physical tags: MSH2 = first element tag; MSH4.1 = first physical tag of
// the owning entity (via $Entities); MSH1 = reg-phys field.

struct MshData {
  std::vector<double> nodes_xy;     // [n_nodes * 2]
  std::vector<int64_t> node_ids;    // original 1-based gmsh ids
  std::vector<int32_t> tri;         // [n_tri * 3]
  std::vector<int32_t> tri_tag;     // physical tag
  std::vector<int32_t> quad;        // [n_quad * 4]
  std::vector<int32_t> quad_tag;
  std::vector<int32_t> edges;       // [n_edges * 2]
  std::vector<int32_t> edge_tag;
  std::vector<int32_t> tet;         // [n_tet * 4]
  std::vector<int32_t> tet_tag;

  std::vector<int64_t> id_map;  // gmsh node id -> 0-based index

  void build_id_map() {
    int64_t max_id = 0;
    for (int64_t id : node_ids) max_id = id > max_id ? id : max_id;
    id_map.assign(max_id + 1, -1);
    for (size_t i = 0; i < node_ids.size(); ++i)
      id_map[node_ids[i]] = static_cast<int64_t>(i);
  }

  // nullptr-safe id remap; returns false on unknown node id
  bool remap(long long gid, int32_t* out) {
    if (gid < 0 || gid >= static_cast<long long>(id_map.size()) ||
        id_map[gid] < 0)
      return false;
    *out = static_cast<int32_t>(id_map[gid]);
    return true;
  }

  bool add_element(int etype, int tag, const int32_t* v) {
    switch (etype) {
      case 1:
        edges.insert(edges.end(), v, v + 2);
        edge_tag.push_back(tag);
        return true;
      case 2:
        tri.insert(tri.end(), v, v + 3);
        tri_tag.push_back(tag);
        return true;
      case 3:
        quad.insert(quad.end(), v, v + 4);
        quad_tag.push_back(tag);
        return true;
      case 4:
        tet.insert(tet.end(), v, v + 4);
        tet_tag.push_back(tag);
        return true;
      default:
        return true;  // points / higher-order: skipped, like GridIn
    }
  }
};

int nverts_of(int etype) {
  return etype == 1 ? 2 : etype == 2 ? 3 : (etype == 3 || etype == 4) ? 4 : 0;
}

// MSH 2.x body: "$Nodes\n n\n id x y z ..." / "$Elements\n n\n
// id type ntags tags... verts..."
bool parse_msh2(FILE* f, MshData* d) {
  char line[512];
  while (std::fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "$Nodes", 6) == 0) {
      long long n = 0;
      if (!std::fgets(line, sizeof line, f) ||
          std::sscanf(line, "%lld", &n) != 1)
        return false;
      d->nodes_xy.reserve(2 * n);
      d->node_ids.reserve(n);
      for (long long i = 0; i < n; ++i) {
        long long id;
        double x, y, z;
        if (!std::fgets(line, sizeof line, f) ||
            std::sscanf(line, "%lld %lf %lf %lf", &id, &x, &y, &z) != 4)
          return false;
        d->node_ids.push_back(id);
        d->nodes_xy.push_back(x);
        d->nodes_xy.push_back(y);
      }
    } else if (std::strncmp(line, "$Elements", 9) == 0) {
      d->build_id_map();
      long long n = 0;
      if (!std::fgets(line, sizeof line, f) ||
          std::sscanf(line, "%lld", &n) != 1)
        return false;
      for (long long i = 0; i < n; ++i) {
        if (!std::fgets(line, sizeof line, f)) return false;
        long long eid;
        int etype, ntags;
        int pos = 0;
        if (std::sscanf(line, "%lld %d %d%n", &eid, &etype, &ntags, &pos) < 3)
          return false;
        const char* p = line + pos;
        int tag = 0;
        for (int t = 0; t < ntags; ++t) {
          int v, adv;
          if (std::sscanf(p, "%d%n", &v, &adv) != 1) return false;
          if (t == 0) tag = v;  // physical tag
          p += adv;
        }
        int nv = nverts_of(etype);
        if (nv == 0) continue;
        int32_t v[4];
        for (int k = 0; k < nv; ++k) {
          long long gid;
          int adv;
          if (std::sscanf(p, "%lld%n", &gid, &adv) != 1 || !d->remap(gid, &v[k]))
            return false;
          p += adv;
        }
        d->add_element(etype, tag, v);
      }
    }
  }
  return true;
}

// MSH 4.1 body: $Entities physical map + entity-blocked $Nodes/$Elements
bool parse_msh41(FILE* f, MshData* d) {
  char line[1024];
  // (dim, entity_tag) -> first physical tag; dims 0..3 kept separately
  std::vector<std::pair<int64_t, int32_t>> phys[4];
  auto phys_of = [&](int dim, int64_t etag) -> int32_t {
    if (dim < 0 || dim > 3) return 0;
    for (auto& kv : phys[dim])
      if (kv.first == etag) return kv.second;
    return 0;
  };
  while (std::fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "$Entities", 9) == 0) {
      long long cnt[4] = {0, 0, 0, 0};
      if (!std::fgets(line, sizeof line, f) ||
          std::sscanf(line, "%lld %lld %lld %lld", &cnt[0], &cnt[1], &cnt[2],
                      &cnt[3]) != 4)
        return false;
      for (int dim = 0; dim < 4; ++dim) {
        for (long long i = 0; i < cnt[dim]; ++i) {
          if (!std::fgets(line, sizeof line, f)) return false;
          // points: tag x y z nphys phys...
          // dim>=1: tag min(3) max(3) nphys phys... nbnd bnd...
          long long etag;
          int pos = 0;
          if (std::sscanf(line, "%lld%n", &etag, &pos) != 1) return false;
          const char* p = line + pos;
          int nskip = dim == 0 ? 3 : 6;
          double dummy;
          int adv;
          for (int k = 0; k < nskip; ++k) {
            if (std::sscanf(p, "%lf%n", &dummy, &adv) != 1) return false;
            p += adv;
          }
          long long nphys = 0;
          if (std::sscanf(p, "%lld%n", &nphys, &adv) != 1) return false;
          p += adv;
          int32_t tag = 0;
          if (nphys > 0) {
            long long t;
            if (std::sscanf(p, "%lld%n", &t, &adv) != 1) return false;
            tag = static_cast<int32_t>(t);
          }
          phys[dim].emplace_back(etag, tag);
        }
      }
    } else if (std::strncmp(line, "$Nodes", 6) == 0) {
      long long nblocks = 0, ntotal = 0;
      if (!std::fgets(line, sizeof line, f) ||
          std::sscanf(line, "%lld %lld", &nblocks, &ntotal) != 2)
        return false;
      d->nodes_xy.reserve(2 * ntotal);
      d->node_ids.reserve(ntotal);
      for (long long b = 0; b < nblocks; ++b) {
        long long dim, etag, param, nb;
        if (!std::fgets(line, sizeof line, f) ||
            std::sscanf(line, "%lld %lld %lld %lld", &dim, &etag, &param,
                        &nb) != 4)
          return false;
        for (long long i = 0; i < nb; ++i) {
          long long id;
          if (!std::fgets(line, sizeof line, f) ||
              std::sscanf(line, "%lld", &id) != 1)
            return false;
          d->node_ids.push_back(id);
        }
        for (long long i = 0; i < nb; ++i) {
          double x, y;
          if (!std::fgets(line, sizeof line, f) ||
              std::sscanf(line, "%lf %lf", &x, &y) != 2)
            return false;
          d->nodes_xy.push_back(x);
          d->nodes_xy.push_back(y);
        }
      }
    } else if (std::strncmp(line, "$Elements", 9) == 0) {
      d->build_id_map();
      long long nblocks = 0;
      if (!std::fgets(line, sizeof line, f) ||
          std::sscanf(line, "%lld", &nblocks) != 1)
        return false;
      for (long long b = 0; b < nblocks; ++b) {
        long long dim, etag, etype, nb;
        if (!std::fgets(line, sizeof line, f) ||
            std::sscanf(line, "%lld %lld %lld %lld", &dim, &etag, &etype,
                        &nb) != 4)
          return false;
        int32_t tag = phys_of(static_cast<int>(dim), etag);
        int nv = nverts_of(static_cast<int>(etype));
        for (long long i = 0; i < nb; ++i) {
          if (!std::fgets(line, sizeof line, f)) return false;
          if (nv == 0) continue;
          long long eid;
          int pos = 0;
          if (std::sscanf(line, "%lld%n", &eid, &pos) != 1) return false;
          const char* p = line + pos;
          int32_t v[4];
          bool ok = true;
          for (int k = 0; k < nv; ++k) {
            long long gid;
            int adv;
            if (std::sscanf(p, "%lld%n", &gid, &adv) != 1 ||
                !d->remap(gid, &v[k])) {
              ok = false;
              break;
            }
            p += adv;
          }
          if (!ok) return false;
          d->add_element(static_cast<int>(etype), tag, v);
        }
      }
    }
  }
  return true;
}

// MSH 1 body ($NOD/$ELM): "id x y z" / "id type reg-phys reg-elem n verts"
bool parse_msh1(FILE* f, MshData* d) {
  char line[512];
  // caller consumed the "$NOD" line already
  long long n = 0;
  if (!std::fgets(line, sizeof line, f) || std::sscanf(line, "%lld", &n) != 1)
    return false;
  for (long long i = 0; i < n; ++i) {
    long long id;
    double x, y, z;
    if (!std::fgets(line, sizeof line, f) ||
        std::sscanf(line, "%lld %lf %lf %lf", &id, &x, &y, &z) != 4)
      return false;
    d->node_ids.push_back(id);
    d->nodes_xy.push_back(x);
    d->nodes_xy.push_back(y);
  }
  while (std::fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "$ELM", 4) != 0) continue;
    d->build_id_map();
    if (!std::fgets(line, sizeof line, f) || std::sscanf(line, "%lld", &n) != 1)
      return false;
    for (long long i = 0; i < n; ++i) {
      if (!std::fgets(line, sizeof line, f)) return false;
      long long eid;
      int etype, reg_phys, reg_elem, nverts;
      int pos = 0;
      if (std::sscanf(line, "%lld %d %d %d %d%n", &eid, &etype, &reg_phys,
                      &reg_elem, &nverts, &pos) != 5)
        return false;
      int nv = nverts_of(etype);
      if (nv == 0) continue;
      const char* p = line + pos;
      int32_t v[4];
      for (int k = 0; k < nv; ++k) {
        long long gid;
        int adv;
        if (std::sscanf(p, "%lld%n", &gid, &adv) != 1 || !d->remap(gid, &v[k]))
          return false;
        p += adv;
      }
      d->add_element(etype, reg_phys, v);
    }
  }
  return true;
}

void* nstpu_msh_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* d = new MshData();
  bool ok = false;
  char line[512];
  if (std::fgets(line, sizeof line, f)) {
    if (std::strncmp(line, "$NOD", 4) == 0) {
      ok = parse_msh1(f, d);
    } else if (std::strncmp(line, "$MeshFormat", 11) == 0) {
      double version = 0;
      if (std::fgets(line, sizeof line, f) &&
          std::sscanf(line, "%lf", &version) == 1) {
        if (version >= 2.0 && version < 3.0)
          ok = parse_msh2(f, d);
        else if (version >= 4.0 && version < 5.0)
          ok = parse_msh41(f, d);
      }
    }
  }
  std::fclose(f);
  if (!ok) {
    delete d;
    return nullptr;
  }
  return d;
}

void nstpu_msh_counts(void* handle, int64_t* n_nodes, int64_t* n_tri,
                      int64_t* n_quad, int64_t* n_edges, int64_t* n_tet) {
  auto* d = static_cast<MshData*>(handle);
  *n_nodes = static_cast<int64_t>(d->node_ids.size());
  *n_tri = static_cast<int64_t>(d->tri_tag.size());
  *n_quad = static_cast<int64_t>(d->quad_tag.size());
  *n_edges = static_cast<int64_t>(d->edge_tag.size());
  *n_tet = static_cast<int64_t>(d->tet_tag.size());
}

void nstpu_msh_fill(void* handle, double* nodes_xy, int32_t* tri,
                    int32_t* tri_tag, int32_t* quad, int32_t* quad_tag,
                    int32_t* edges, int32_t* edge_tag, int32_t* tet,
                    int32_t* tet_tag) {
  auto* d = static_cast<MshData*>(handle);
  std::memcpy(nodes_xy, d->nodes_xy.data(),
              d->nodes_xy.size() * sizeof(double));
  std::memcpy(tri, d->tri.data(), d->tri.size() * sizeof(int32_t));
  std::memcpy(tri_tag, d->tri_tag.data(), d->tri_tag.size() * sizeof(int32_t));
  std::memcpy(quad, d->quad.data(), d->quad.size() * sizeof(int32_t));
  std::memcpy(quad_tag, d->quad_tag.data(),
              d->quad_tag.size() * sizeof(int32_t));
  std::memcpy(edges, d->edges.data(), d->edges.size() * sizeof(int32_t));
  std::memcpy(edge_tag, d->edge_tag.data(),
              d->edge_tag.size() * sizeof(int32_t));
  std::memcpy(tet, d->tet.data(), d->tet.size() * sizeof(int32_t));
  std::memcpy(tet_tag, d->tet_tag.data(),
              d->tet_tag.size() * sizeof(int32_t));
}

void nstpu_msh_close(void* handle) { delete static_cast<MshData*>(handle); }

}  // extern "C"
