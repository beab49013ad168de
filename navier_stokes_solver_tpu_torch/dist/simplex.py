"""1-D x-strip decomposition of the ``-M`` simplex mesh, one strip per rank.

The port of the JAX package's ``dist/simplex.py`` (the reference's
MPI-distributed triangulation on the ``-M`` mesh-file path, deal.II
``parallel::fullydistributed``, Trilinos ghost exchange --
NSSolver.cpp:98-102, :560-562):

  * the elements are split into ``n_dev`` contiguous strips by centroid x
    (equal element counts); each strip keeps a local copy of every node its
    elements touch, so the nodes on a strip boundary are duplicated (the
    ghost DoFs);
  * every strip's tables are padded to one shape and stacked on a leading
    strip axis (the JAX package's layout, built here on the host in numpy,
    table for table);
  * on a strip, the operator scatters complete their seam sums with the
    neighbour strips (``dist.mesh.Mesh.strip_seam_sum``), inner products
    weigh the duplicated nodes by 1 / multiplicity and sum over the ranks,
    and lift and drag sum over the ranks (Utilities::MPI::sum).

Where the JAX package stacks every strip inside one program, each rank here
holds its own: ``decompose_simplex_disc`` builds the stacked host tables
(the same on every rank), ``simplex_strip`` lowers one strip to tensors on
a rank's device, and ``scatter_simplex_blocks`` / ``gather_simplex_blocks``
convert between a global (u, p) and the stacked layout.  The host-driven
solvers, the fused step and every preconditioner then run unchanged on the
strip (``unstructured.ops``, ``unstructured.pmg``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.ops.blocks import Blocks
from navier_stokes_solver_tpu_torch.unstructured.tri import (
    SeamTables,
    SimplexDisc,
    invert_scatter,
    make_simplex_disc,
)

__all__ = [
    "DecomposedSimplex",
    "decompose_simplex_disc",
    "simplex_strip",
    "scatter_simplex_blocks",
    "gather_simplex_blocks",
    "strip_blocks",
    "all_gather_simplex_blocks",
]

# the stacked per-strip tables of ``DecomposedSimplex.tables``, by kind
INDEX_TABLES = ("dofs_v", "dofs_p", "cyl_tri", "cyl_edge", "gather_v", "gather_p",
                "pmg_vert", "pmg_edge", "pmg_vert_v", "pmg_mid")
FLOAT_TABLES = ("coords_v", "coords_p", "invJ", "detJ", "inlet_profile1", "neumann_rhs1",
                "cyl_len", "cyl_normal")
BOOL_TABLES = ("u_dirichlet", "u_inlet", "p_outlet")
SEAM_TABLES = ("send_l", "send_r", "add_l", "add_r", "weight")


class DecomposedSimplex(NamedTuple):
    """The strip-stacked host tables of a decomposed mesh and the
    local <-> global maps: ``tables`` {name: [n_dev, ...] array} under the
    JAX package's ``SimplexDisc`` field names, ``seam_v`` / ``seam_p``
    {name: [n_dev, ...] array} under its ``SeamTables`` names."""

    tables: dict
    seam_v: dict
    seam_p: dict
    # [n_dev, n_loc_max] global node id per local slot, -1 on padding
    v_global: np.ndarray
    p_global: np.ndarray
    n_nodes_v_global: int
    n_nodes_p_global: int
    p_mg: bool

    @property
    def n_dev(self) -> int:
        return self.v_global.shape[0]

    # the local (padded) node and element counts, the same on every strip
    @property
    def n_nodes_v(self) -> int:
        return self.v_global.shape[1]

    @property
    def n_nodes_p(self) -> int:
        return self.p_global.shape[1]

    @property
    def n_tri(self) -> int:
        return self.tables["dofs_v"].shape[1]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _local_numbering(global_ids_per_tile):
    """Per-strip local numbering sorted by global id: (padded [n_dev,
    n_loc_max] global ids, -1 on padding; a {global id -> local id} dict
    per strip; n_loc_max)."""
    n_loc_max = max(len(g) for g in global_ids_per_tile)
    out = np.full((len(global_ids_per_tile), n_loc_max), -1, dtype=np.int64)
    lut = []
    for t, g in enumerate(global_ids_per_tile):
        out[t, : len(g)] = g
        lut.append({int(gi): li for li, gi in enumerate(g)})
    return out, lut, n_loc_max


def _seam_tables(globals_pad, lut, n_loc, n_dev) -> dict:
    """The stacked seam tables of one DoF space.  Nodes may be shared only
    by adjacent strips (the exchange has a left and a right neighbour)."""
    sets = [set(g[g >= 0].tolist()) for g in globals_pad]
    for t in range(n_dev):
        for u in range(t + 2, n_dev):
            both = sets[t] & sets[u]
            if both:
                raise ValueError(
                    f"strips {t} and {u} share {len(both)} nodes; "
                    "non-adjacent sharing is unsupported -- use fewer, "
                    "wider strips"
                )
    shared_r = [sorted(sets[t] & sets[t + 1]) if t + 1 < n_dev else [] for t in range(n_dev)]
    B = max(1, max(len(s) for s in shared_r))
    send_l = np.full((n_dev, B), n_loc, dtype=np.int32)
    send_r = np.full((n_dev, B), n_loc, dtype=np.int32)
    add_l = np.full((n_dev, n_loc), B, dtype=np.int32)
    add_r = np.full((n_dev, n_loc), B, dtype=np.int32)
    weight = np.zeros((n_dev, n_loc))
    for t in range(n_dev):
        for k, g in enumerate(shared_r[t]):  # shared with the right neighbour
            send_r[t, k] = lut[t][g]
            add_r[t, lut[t][g]] = k
            # the right neighbour receives this buffer "from the left"
            send_l[t + 1, k] = lut[t + 1][g]
            add_l[t + 1, lut[t + 1][g]] = k
        mult = np.zeros(n_loc)
        for li, g in enumerate(globals_pad[t]):
            if g < 0:
                continue
            mult[li] = sum(1 for s in sets if int(g) in s)
        weight[t] = np.where(mult > 0, 1.0 / np.maximum(mult, 1), 0.0)
    return dict(send_l=send_l, send_r=send_r, add_l=add_l, add_r=add_r, weight=weight)


def decompose_simplex_disc(
    nodes_xy: np.ndarray,
    tri: np.ndarray,
    bedges: np.ndarray,
    bedge_tag: np.ndarray,
    n_dev: int,
    *,
    global_disc: SimplexDisc | None = None,
    dtype: torch.dtype = torch.float64,
) -> DecomposedSimplex:
    """Split a triangle mesh into ``n_dev`` x-strips of elements and build
    every strip's tables, stacked on a leading strip axis (host arrays).

    The global disc (``global_disc``, or built here in ``dtype`` on the
    CPU) gives the boundary masks, the inlet profile, the Neumann rhs and
    the cylinder edges, so they are globally consistent; every nodal
    quantity is sliced to the strip's local nodes (the global values
    replicate onto the seam copies), and partial sums are made per strip
    and completed by the seam exchange at run time.
    """
    g = global_disc if global_disc is not None else make_simplex_disc(
        nodes_xy, tri, bedges, bedge_tag, dtype=dtype, device="cpu")
    gdofs_v = _host(g.dofs_v)
    gdofs_p = _host(g.dofs_p)
    n_tri = gdofs_v.shape[0]

    # ---- strip partition by element centroid x (equal counts) ----
    cx = np.asarray(nodes_xy, dtype=np.float64)[np.asarray(tri, dtype=np.int64)][:, :, 0].mean(axis=1)
    order = np.argsort(cx, kind="stable")
    parts = np.array_split(order, n_dev)
    if min(len(p) for p in parts) == 0:
        raise ValueError(f"mesh has too few elements for {n_dev} strips")
    n_tri_max = max(len(p) for p in parts)

    # ---- per-strip local numbering (sorted by global id) ----
    v_ids = [np.unique(gdofs_v[p]) for p in parts]
    p_ids = [np.unique(gdofs_p[p]) for p in parts]
    v_pad, v_lut, n_v = _local_numbering(v_ids)
    p_pad, p_lut, n_p = _local_numbering(p_ids)
    if n_p == n_v:
        # the seam-weighted dot tells the u and p weights apart by the
        # vectors' length (unstructured.ops.make_dot): one extra dead
        # pressure slot keeps the lengths apart
        p_pad = np.concatenate([p_pad, np.full((n_dev, 1), -1, dtype=p_pad.dtype)], axis=1)
        n_p += 1

    seam_v = _seam_tables(v_pad, v_lut, n_v, n_dev)
    seam_p = _seam_tables(p_pad, p_lut, n_p, n_dev)

    # ---- per-strip element tables (padded with zero-measure elements) ----
    def remap(dofs, lut):
        return np.vectorize(lambda gid: lut[int(gid)])(dofs).astype(np.int32)

    dofs_v_t = np.zeros((n_dev, n_tri_max, 6), dtype=np.int32)
    dofs_p_t = np.zeros((n_dev, n_tri_max, 3), dtype=np.int32)
    invJ_t = np.zeros((n_dev, n_tri_max, 2, 2))
    detJ_t = np.zeros((n_dev, n_tri_max))
    ginvJ = _host(g.invJ)
    gdetJ = _host(g.detJ)
    for t, p in enumerate(parts):
        k = len(p)
        dofs_v_t[t, :k] = remap(gdofs_v[p], v_lut[t])
        dofs_p_t[t, :k] = remap(gdofs_p[p], p_lut[t])
        invJ_t[t, :k] = ginvJ[p]
        detJ_t[t, :k] = gdetJ[p]

    def stacked_inverse(dofs_t, n_nodes):
        # invert_scatter pads rows to each strip's own max degree; unify the
        # widths (the sentinel, the flat element-slot count, is the same on
        # every strip: the element arrays are padded to n_tri_max)
        per = [invert_scatter(dofs_t[t], n_nodes) for t in range(n_dev)]
        k = max(a.shape[1] for a in per)
        sent = dofs_t[0].size
        return np.stack([np.pad(a, ((0, 0), (0, k - a.shape[1])), constant_values=sent) for a in per])

    gather_v_t = stacked_inverse(dofs_v_t, n_v)
    gather_p_t = stacked_inverse(dofs_p_t, n_p)

    # ---- per-strip P2 -> P1 transfer tables (the sentinels of
    # make_simplex_disc).  Every midpoint's edge endpoints are vertices of
    # a local element, so the p_lut lookups cannot miss. ----
    n_vg = g.n_nodes_p  # the global vertex count: v-ids below it are vertices
    guniq = _host(g.edge_verts)
    pmg_vert_t = np.full((n_dev, n_v), n_p, dtype=np.int32)
    pmg_edge_t = np.full((n_dev, n_v, 2), n_p, dtype=np.int32)
    pmg_vertv_t = np.full((n_dev, n_p), n_v, dtype=np.int32)
    mids_per_tile = []
    for t in range(n_dev):
        mids: list[list[int]] = [[] for _ in range(n_p)]
        for li, gid in enumerate(v_pad[t]):
            if gid < 0:
                continue
            if gid < n_vg:
                pl = p_lut[t][int(gid)]
                pmg_vert_t[t, li] = pl
                pmg_vertv_t[t, pl] = li
            else:
                a, b = guniq[int(gid) - n_vg]
                pa, pb = p_lut[t][int(a)], p_lut[t][int(b)]
                pmg_edge_t[t, li] = (pa, pb)
                mids[pa].append(li)
                mids[pb].append(li)
        mids_per_tile.append(mids)
    k_mid = max(1, max(len(m) for mids in mids_per_tile for m in mids))
    pmg_mid_t = np.full((n_dev, n_p, k_mid), n_v, dtype=np.int32)
    for t, mids in enumerate(mids_per_tile):
        for pl, m in enumerate(mids):
            pmg_mid_t[t, pl, : len(m)] = m

    # ---- nodal quantities: slices of the global vectors (padding reads
    # ``fill``) ----
    def slice_nodal(vec, ids_pad, fill=0.0):
        vec = _host(vec)
        out = np.full(vec.shape[:-1] + ids_pad.shape, fill, dtype=vec.dtype)
        for t in range(n_dev):
            sel = ids_pad[t] >= 0
            out[..., t, sel] = vec[..., ids_pad[t][sel]]
        return np.moveaxis(out, -2, 0)

    # ---- cylinder boundary edges -> their owning strip ----
    gcyl_tri = _host(g.cyl_tri)
    owner = np.empty(n_tri, dtype=np.int64)
    local_pos = np.empty(n_tri, dtype=np.int64)
    for t, p in enumerate(parts):
        owner[p] = t
        local_pos[p] = np.arange(len(p))
    n_ce_max = 1
    if gcyl_tri.size:
        n_ce_max = max(1, max(int(np.sum(owner[gcyl_tri] == t)) for t in range(n_dev)))
    cyl_tri_t = np.zeros((n_dev, n_ce_max), dtype=np.int32)
    cyl_edge_t = np.zeros((n_dev, n_ce_max), dtype=np.int32)
    cyl_len_t = np.zeros((n_dev, n_ce_max))
    cyl_nrm_t = np.zeros((n_dev, n_ce_max, 2))
    if gcyl_tri.size:
        gce, gcl, gcn = _host(g.cyl_edge), _host(g.cyl_len), _host(g.cyl_normal)
        for t in range(n_dev):
            sel = owner[gcyl_tri] == t
            k = int(sel.sum())
            cyl_tri_t[t, :k] = local_pos[gcyl_tri[sel]]
            cyl_edge_t[t, :k] = gce[sel]
            cyl_len_t[t, :k] = gcl[sel]
            cyl_nrm_t[t, :k] = gcn[sel]

    tables = dict(
        dofs_v=dofs_v_t,
        dofs_p=dofs_p_t,
        coords_v=slice_nodal(_host(g.coords_v).T, v_pad).swapaxes(-1, -2),
        coords_p=slice_nodal(_host(g.coords_p).T, p_pad).swapaxes(-1, -2),
        invJ=invJ_t,
        detJ=detJ_t,
        u_dirichlet=slice_nodal(g.u_dirichlet, v_pad, fill=False),
        u_inlet=slice_nodal(g.u_inlet, v_pad, fill=False),
        inlet_profile1=slice_nodal(g.inlet_profile1, v_pad),
        neumann_rhs1=slice_nodal(g.neumann_rhs1, v_pad),
        cyl_tri=cyl_tri_t,
        cyl_edge=cyl_edge_t,
        cyl_len=cyl_len_t,
        cyl_normal=cyl_nrm_t,
        gather_v=gather_v_t.astype(np.int32),
        gather_p=gather_p_t.astype(np.int32),
        pmg_vert=pmg_vert_t,
        pmg_edge=pmg_edge_t,
        pmg_vert_v=pmg_vertv_t,
        pmg_mid=pmg_mid_t,
        # padding slots read True: they stay identity rows of the
        # pressure-Laplacian Schur legs (SimplexDisc.p_free)
        p_outlet=slice_nodal(g.p_outlet, p_pad, fill=True),
    )
    return DecomposedSimplex(
        tables=tables, seam_v=seam_v, seam_p=seam_p, v_global=v_pad, p_global=p_pad,
        n_nodes_v_global=g.n_nodes_v, n_nodes_p_global=g.n_nodes_p, p_mg=g.p_mg,
    )


def simplex_strip(dd: DecomposedSimplex, t: int, *, device, dtype: torch.dtype = torch.float64,
                  mesh=None) -> SimplexDisc:
    """Strip ``t`` of ``dd`` as a ``SimplexDisc`` of ``dtype`` on
    ``device``, with ``mesh`` (a ``dist.Mesh``; None builds a strip without
    collectives, e.g. to compare tables) -- the counterpart of
    ``dist.decompose_disc`` for the lattice.  No dense Schur inverse is
    attached: a strip's operators are partial sums, not the global
    matrices, so its pressure legs iterate."""
    from navier_stokes_solver_tpu_torch.unstructured.elements import make_simplex_tables

    if not 0 <= t < dd.n_dev:
        raise ValueError(f"strip {t} outside the {dd.n_dev} strips")
    device = torch.device(device)
    ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    fl = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device).to(dtype)
    bl = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
    kw = {k: ix(dd.tables[k][t]) for k in INDEX_TABLES}
    kw.update({k: fl(dd.tables[k][t]) for k in FLOAT_TABLES})
    kw.update({k: bl(dd.tables[k][t]) for k in BOOL_TABLES})
    seams = {
        name: SeamTables(**{k: (fl if k == "weight" else ix)(s[k][t]) for k in SEAM_TABLES})
        for name, s in (("seam_v", dd.seam_v), ("seam_p", dd.seam_p))
    }
    tabs = make_simplex_tables()
    return SimplexDisc(
        n_nodes_v=dd.n_nodes_v, n_nodes_p=dd.n_nodes_p, n_tri=dd.n_tri,
        edge_verts=None, gather_ev=None,
        phi_v=fl(tabs.phi_v), dphi_v=fl(tabs.dphi_v), phi_p=fl(tabs.phi_p), dphi_p=fl(tabs.dphi_p),
        w_q=fl(tabs.w_q), phi_v_edge=fl(tabs.phi_v_edge), dphi_v_edge=fl(tabs.dphi_v_edge),
        phi_p_edge=fl(tabs.phi_p_edge), w_e=fl(tabs.w_e),
        p_mg=dd.p_mg, halo_n=dd.n_dev, halo_ix=t, mesh=mesh,
        **kw, **seams,
    )


def scatter_simplex_blocks(x: Blocks, dd: DecomposedSimplex) -> Blocks:
    """Global (u, p) -> strip-stacked vectors (seam nodes duplicated,
    padding 0) as host arrays: the JAX package's layout."""
    u, p = _host(x.u), _host(x.p)
    n_dev, n_v = dd.v_global.shape
    n_p = dd.p_global.shape[1]
    us = np.zeros((n_dev, 2, n_v), dtype=u.dtype)
    ps = np.zeros((n_dev, n_p), dtype=p.dtype)
    for t in range(n_dev):
        sv = dd.v_global[t] >= 0
        sp = dd.p_global[t] >= 0
        us[t][:, sv] = u[:, dd.v_global[t][sv]]
        ps[t][sp] = p[dd.p_global[t][sp]]
    return Blocks(u=us, p=ps)


def gather_simplex_blocks(xs: Blocks, dd: DecomposedSimplex) -> Blocks:
    """Strip-stacked vectors -> global (u, p) as host arrays (the seam
    copies agree; the last strip's copy is written last, as in the JAX
    package)."""
    us, ps = _host(xs.u), _host(xs.p)
    u = np.zeros((2, dd.n_nodes_v_global), dtype=us.dtype)
    p = np.zeros((dd.n_nodes_p_global,), dtype=ps.dtype)
    for t in range(dd.n_dev):
        sv = dd.v_global[t] >= 0
        sp = dd.p_global[t] >= 0
        u[:, dd.v_global[t][sv]] = us[t][:, sv]
        p[dd.p_global[t][sp]] = ps[t][sp]
    return Blocks(u=u, p=p)


def strip_blocks(x: Blocks, sdisc: SimplexDisc, dd: DecomposedSimplex) -> Blocks:
    """This strip's part of the global (u, p), as tensors on its device."""
    xs = scatter_simplex_blocks(x, dd)
    put = lambda a: torch.as_tensor(a[sdisc.halo_ix], device=sdisc.device).to(sdisc.dtype)
    return Blocks(u=put(xs.u), p=put(xs.p))


def all_gather_simplex_blocks(x: Blocks, sdisc: SimplexDisc, dd: DecomposedSimplex, *,
                              stacked: bool = False) -> Blocks:
    """Every strip's part of ``x`` (this rank's strip; a collective over the
    strips), as the global (u, p) host arrays on every rank -- or, with
    ``stacked``, as the strip-stacked host arrays."""
    xs = Blocks(*(np.stack([_host(t) for t in sdisc.mesh.all_gather(a)]) for a in x))
    return xs if stacked else gather_simplex_blocks(xs, dd)
