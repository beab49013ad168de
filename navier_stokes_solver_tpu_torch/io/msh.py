"""gmsh MSH1 / MSH2 / MSH4.1 import, MSH2 export of meshes.

The port of the JAX package's ``io/msh.py``: the same parsers and writer,
byte for byte in what they return and write.

Export: equivalent of the reference's ``GridOut::write_msh(mesh, "mesh.msh")``
(NSSolver.cpp:108-110): quad elements with the boundary edges tagged with
their physical ids (6 wall, 7 inlet, 8 outlet, 10 cylinder).

Import: equivalent of ``GridIn::read_msh`` used by the ``-M`` CLI path
(NSSolver.cpp:155-161).  deal.II's reader accepts gmsh format versions
1 (``$NOD``/``$ELM``), 2.x (``$Nodes``/``$Elements`` with per-element
tag lists) and 4.1 (entity blocks; physical tags resolved through
``$Entities``) — all three are supported here, covering every ``.msh``
shipped with the reference (``lab_new/mesh/*.msh`` are 4.1 except
``new_mesh.msh`` which is 2.2; the reference's own ``GridOut`` output
``mesh.msh`` is MSH1).  The C++ parser in ``native/`` is the fast path,
with the pure-Python parsers here as its plain version.

Physical-tag notes (matching deal.II semantics):
- MSH2: the first tag is the physical id.
- MSH4.1: an element inherits the FIRST physical tag of the entity its
  block belongs to (0 if the entity has none).
- MSH1: the ``reg-phys`` field.
- ``2dMesh{,Coarse,Normal,ReallyCoarse}.msh`` tag the cylinder curve
  into physical 6 "borders" (together with the channel walls) rather
  than id 10 (``2dMeshCylinder``/``2dMeshFine``/``new_mesh`` use 10);
  a lift/drag integral over boundary id 10 is therefore empty (zero
  force) on the borders-tagged meshes — exactly what the reference's
  ``compute_lift_drag`` (NSSolver.cpp:884-890, boundary_id == 10
  filter) computes there.  Velocity BCs are unaffected (walls and
  cylinder are both no-slip under tag 6).
"""

from __future__ import annotations

import numpy as np

from navier_stokes_solver_tpu_torch.geometry.channel import ChannelGeometry, INTERIOR
from navier_stokes_solver_tpu_torch.native import read_msh_native

__all__ = ["write_msh", "read_msh"]


# gmsh element type -> vertex count for the linear types we keep
# (1 line, 2 triangle, 3 quad, 4 tetrahedron)
_NVERTS = {1: 2, 2: 3, 3: 4, 4: 4}


class _MshAccum:
    """Shared element accumulator for the three format parsers."""

    def __init__(self):
        self.nodes_xy: list[tuple[float, float]] = []
        self.node_ids: list[int] = []
        self.buckets = {1: ([], []), 2: ([], []), 3: ([], []), 4: ([], [])}

    def add_element(self, etype: int, tag: int, verts: list[int]):
        if etype not in self.buckets:
            return  # points / higher-order elements: skipped, like GridIn
        conn, tags = self.buckets[etype]
        conn.append(verts)
        tags.append(tag)

    def finish(self) -> dict:
        def pack(etype, width):
            conn, tags = self.buckets[etype]
            return (
                np.asarray(conn, dtype=np.int32).reshape(-1, width),
                np.asarray(tags, dtype=np.int32),
            )

        edges, edge_tag = pack(1, 2)
        tri, tri_tag = pack(2, 3)
        quad, quad_tag = pack(3, 4)
        tet, tet_tag = pack(4, 4)
        return dict(
            nodes_xy=np.asarray(self.nodes_xy, dtype=np.float64).reshape(
                -1, 2
            ),
            tri=tri, tri_tag=tri_tag,
            quad=quad, quad_tag=quad_tag,
            edges=edges, edge_tag=edge_tag,
            tet=tet, tet_tag=tet_tag,
        )


def _parse_msh2(lines, acc: _MshAccum):
    """MSH 2.x: $Nodes (id x y z), $Elements (id type ntags tags... verts)."""
    for line in lines:
        if line.startswith("$Nodes"):
            n = int(next(lines))
            for _ in range(n):
                parts = next(lines).split()
                acc.node_ids.append(int(parts[0]))
                acc.nodes_xy.append((float(parts[1]), float(parts[2])))
        elif line.startswith("$Elements"):
            id_map = {g: i for i, g in enumerate(acc.node_ids)}
            n = int(next(lines))
            for _ in range(n):
                parts = next(lines).split()
                etype = int(parts[1])
                ntags = int(parts[2])
                tag = int(parts[3]) if ntags else 0
                if etype not in _NVERTS:
                    continue
                verts = [id_map[int(v)] for v in parts[3 + ntags :]]
                acc.add_element(etype, tag, verts)


def _parse_msh41(lines, acc: _MshAccum):
    """MSH 4.1: $Entities physical-tag map + entity-blocked nodes/elements."""
    # (dim, entity_tag) -> first physical tag (deal.II: material/boundary id)
    phys: dict[tuple[int, int], int] = {}
    for line in lines:
        if line.startswith("$Entities"):
            counts = [int(v) for v in next(lines).split()]  # pts crv srf vol
            for dim, cnt in enumerate(counts):
                for _ in range(cnt):
                    parts = next(lines).split()
                    # points: tag x y z nphys phys...
                    # dim>=1: tag min(3) max(3) nphys phys... nbnd bnd...
                    base = 4 if dim == 0 else 7
                    nphys = int(parts[base])
                    tag = int(parts[base + 1]) if nphys else 0
                    phys[(dim, int(parts[0]))] = tag
        elif line.startswith("$Nodes"):
            nblocks = int(next(lines).split()[0])
            for _ in range(nblocks):
                _, _, _, nb = (int(v) for v in next(lines).split())
                ids = [int(next(lines)) for _ in range(nb)]
                acc.node_ids.extend(ids)
                for _ in range(nb):
                    parts = next(lines).split()
                    acc.nodes_xy.append((float(parts[0]), float(parts[1])))
        elif line.startswith("$Elements"):
            id_map = {g: i for i, g in enumerate(acc.node_ids)}
            nblocks = int(next(lines).split()[0])
            for _ in range(nblocks):
                dim, etag, etype, nb = (int(v) for v in next(lines).split())
                tag = phys.get((dim, etag), 0)
                for _ in range(nb):
                    parts = next(lines).split()
                    if etype not in _NVERTS:
                        continue
                    verts = [id_map[int(v)] for v in parts[1:]]
                    acc.add_element(etype, tag, verts)


def _parse_msh1(first_line, lines, acc: _MshAccum):
    """MSH 1 ($NOD/$ELM): id x y z; id type reg-phys reg-elem nverts verts."""
    line = first_line
    while line is not None:
        if line.startswith("$NOD"):
            n = int(next(lines))
            for _ in range(n):
                parts = next(lines).split()
                acc.node_ids.append(int(parts[0]))
                acc.nodes_xy.append((float(parts[1]), float(parts[2])))
        elif line.startswith("$ELM"):
            id_map = {g: i for i, g in enumerate(acc.node_ids)}
            n = int(next(lines))
            for _ in range(n):
                parts = next(lines).split()
                etype = int(parts[1])
                tag = int(parts[2])  # reg-phys
                nverts = int(parts[4])
                if etype not in _NVERTS:
                    continue
                verts = [id_map[int(v)] for v in parts[5 : 5 + nverts]]
                acc.add_element(etype, tag, verts)
        line = next(lines, None)


def _read_msh_python(path: str) -> dict:
    """gmsh MSH1/MSH2/MSH4.1 parser (nodes + line/tri/quad/tet elements)."""
    acc = _MshAccum()
    with open(path) as f:
        lines = iter(f)
        first = next(lines, "")
        if first.startswith("$NOD"):
            _parse_msh1(first, lines, acc)
        elif first.startswith("$MeshFormat"):
            version = next(lines).split()[0]
            if version.startswith("2"):
                _parse_msh2(lines, acc)
            elif version.startswith("4"):
                _parse_msh41(lines, acc)
            else:
                raise ValueError(
                    f"unsupported gmsh format {version!r} in {path!r}"
                )
        else:
            raise ValueError(f"{path!r} is not a gmsh mesh file")
    return acc.finish()


def read_msh(path: str) -> dict:
    """Parse a gmsh MSH1 / MSH2 / MSH4.1 file (the native C++ parser, or the
    Python one when the native library is unavailable).

    Returns dict(nodes_xy [n,2], tri [t,3], tri_tag, quad [q,4], quad_tag,
    edges [e,2], edge_tag, tet [k,4], tet_tag) with 0-based connectivity --
    the arrays of the JAX package's reader.
    """
    out = read_msh_native(path)
    return out if out is not None else _read_msh_python(path)


def write_msh(geo: ChannelGeometry, path: str) -> str:
    nx, ny = geo.nx, geo.ny
    xs = geo.x0 + np.arange(nx + 1) * geo.hx
    ys = geo.y0 + np.arange(ny + 1) * geo.hy

    def vid(iy, ix):
        return iy * (nx + 1) + ix + 1  # gmsh ids are 1-based

    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str((nx + 1) * (ny + 1))]
    for iy in range(ny + 1):
        for ix in range(nx + 1):
            lines.append(f"{vid(iy, ix)} {xs[ix]:.16g} {ys[iy]:.16g} 0")
    lines.append("$EndNodes")

    elements = []
    eid = 0
    # boundary edges first (element type 1 = 2-node line)
    # face order (W, E, S, N); edge endpoints in the corner lattice
    edge_nodes = {
        0: lambda iy, ix: (vid(iy, ix), vid(iy + 1, ix)),
        1: lambda iy, ix: (vid(iy, ix + 1), vid(iy + 1, ix + 1)),
        2: lambda iy, ix: (vid(iy, ix), vid(iy, ix + 1)),
        3: lambda iy, ix: (vid(iy + 1, ix), vid(iy + 1, ix + 1)),
    }
    for f in range(4):
        for iy in range(ny):
            for ix in range(nx):
                bid = geo.face_id[f, iy, ix]
                if bid == INTERIOR:
                    continue
                a, b = edge_nodes[f](iy, ix)
                eid += 1
                elements.append(f"{eid} 1 2 {bid} {bid} {a} {b}")
    # quads (element type 3), material id as physical tag
    for iy in range(ny):
        for ix in range(nx):
            if not geo.cell_active[iy, ix]:
                continue
            mat = 10 if geo.cell_ring[iy, ix] else 0
            eid += 1
            elements.append(
                f"{eid} 3 2 {mat} {mat} "
                f"{vid(iy, ix)} {vid(iy, ix + 1)} "
                f"{vid(iy + 1, ix + 1)} {vid(iy + 1, ix)}"
            )

    lines += ["$Elements", str(eid), *elements, "$EndElements"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
