"""Unstructured P2/P1 triangle discretization (the ``-M`` file-mesh path).

The port of the JAX package's ``unstructured/tri.py``.  The
reference's ``-M`` flag reads a gmsh mesh into a triangulation and switches
to simplex elements (NSSolver.cpp:144-209, test.cpp:66-70).  A triangle mesh
(from ``io.read_msh``, or by triangulating the internal channel grid) lowers
to a ``SimplexDisc``: flat DoF vectors, per-element affine maps, and index
tables that drive the gather / padded-gather-sum operators of
``unstructured.ops``.

DoF layout (component-wise block renumbering analog, NSSolver.cpp:212-247):
velocity ``[2, n_nodes_v]`` with P2 nodes = vertices then edge midpoints;
pressure ``[n_nodes_p]`` at vertices.  Boundary ids follow the reference:
6 wall, 7 inlet, 8 outlet, 10 cylinder (Dirichlet on {6, 7, 10}, Neumann on
8).

A ``SimplexDisc`` with ``seam_v`` / ``seam_p`` set is one x-strip of a
decomposed mesh (``dist/simplex.py``): its node vectors are the strip's
local, padded numbering, its scatters complete their seam sums with the
neighbour strips through ``mesh`` (a ``dist.Mesh``), and its products
weigh the seam nodes by ``SeamTables.weight``.  Without strips every such
field is None and the disc is the whole mesh.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.geometry.channel import (
    BOUNDARY_CYLINDER,
    BOUNDARY_INLET,
    BOUNDARY_OUTLET,
    ChannelGeometry,
)
from navier_stokes_solver_tpu_torch.unstructured.elements import (
    EDGE_VERTICES,
    make_simplex_tables,
)

__all__ = [
    "SeamTables",
    "SimplexDisc",
    "invert_scatter",
    "make_simplex_disc",
    "triangulate_channel",
    "triangulate_channel_curved",
]

_DIRICHLET_IDS = (6, 7, 10)

# Floating tensor fields (``SimplexDisc.to`` casts them all, the element
# tables and the dense Schur inverses included, as the JAX package's
# floating-leaf cast does).
_FLOAT_FIELDS = (
    "coords_v", "coords_p", "invJ", "detJ", "inlet_profile1", "neumann_rhs1",
    "cyl_len", "cyl_normal",
    "phi_v", "dphi_v", "phi_p", "dphi_p", "w_q", "phi_v_edge", "dphi_v_edge",
    "phi_p_edge", "w_e",
)
_OPTIONAL_FLOAT_FIELDS = ("dense_mp_raw_inv", "dense_lp_inv")


@dataclasses.dataclass(frozen=True, eq=False)
class SeamTables:
    """The seam-exchange tables of one DoF space on one x-strip.

    The strip's node vectors are padded to ``n_loc``; the nodes it shares
    with its left / right neighbour strip are listed in ``send_l`` /
    ``send_r`` (local indices, sentinel ``n_loc``: an unused buffer slot),
    both sides ordered by global node id so that the buffers align.
    ``add_l`` / ``add_r`` map each local node to its slot in the buffer
    received from that neighbour (sentinel ``B``, the buffer length:
    nothing to add).  ``weight`` is 1 / multiplicity per node (0 on
    padding): the seam-weighted inner product (the Trilinos owned-DoF dot
    analog)."""

    send_l: torch.Tensor  # [B]
    send_r: torch.Tensor  # [B]
    add_l: torch.Tensor  # [n_loc]
    add_r: torch.Tensor  # [n_loc]
    weight: torch.Tensor  # [n_loc]


@dataclasses.dataclass(frozen=True, eq=False)
class SimplexDisc:
    """Unstructured discretization on one device.  Index tensors are int64
    (torch's indexing type); sentinels index an appended zero (or an
    appended ``False``)."""

    n_nodes_v: int
    n_nodes_p: int
    n_tri: int

    dofs_v: torch.Tensor  # [n_tri, 6]
    dofs_p: torch.Tensor  # [n_tri, 3]
    coords_v: torch.Tensor  # [n_nodes_v, 2] P2 node coordinates
    coords_p: torch.Tensor  # [n_nodes_p, 2] vertex coordinates
    invJ: torch.Tensor  # [n_tri, 2, 2]  (d xi / d x)
    detJ: torch.Tensor  # [n_tri]
    u_dirichlet: torch.Tensor  # [n_nodes_v] bool
    u_inlet: torch.Tensor  # [n_nodes_v] bool
    inlet_profile1: torch.Tensor  # [n_nodes_v] parabola at u_max = 1
    neumann_rhs1: torch.Tensor  # [2, n_nodes_v] outlet Neumann rhs at p_out = 1
    # cylinder boundary edges (lift/drag): element, local edge, length, normal
    cyl_tri: torch.Tensor  # [n_ce]
    cyl_edge: torch.Tensor  # [n_ce] (0..2)
    cyl_len: torch.Tensor  # [n_ce]
    cyl_normal: torch.Tensor  # [n_ce, 2] outward (into the cylinder)
    # unique-edge endpoint vertices ([n_edges, 2]; midpoint node n_verts + i
    # sits on edge i); None on a strip (its pmg_* tables replace them)
    edge_verts: torch.Tensor | None
    # scatter-inverse tables (``invert_scatter``): row n lists the flat
    # element-contribution slots that add into node n, padded with the
    # sentinel (the flat length).  Every scatter is a padded gather plus a
    # sum over the small padded axis: deterministic, no atomics.
    gather_v: torch.Tensor  # [n_nodes_v, Kv] into [n_tri * 6]
    gather_p: torch.Tensor  # [n_nodes_p, Kp] into [n_tri * 3]
    gather_ev: torch.Tensor | None  # [n_verts, Ke] into [2 * n_edges]; None on a strip
    # pressure nodes on the outlet boundary (id 8): Dirichlet rows of the
    # pressure Laplacian / convection-diffusion Schur legs
    p_outlet: torch.Tensor  # [n_nodes_p] bool
    # P2 -> P1 p-multigrid transfer tables (unstructured/pmg.py), in local
    # indices (the whole mesh's or a strip's):
    #   pmg_vert:   v-node -> its P1 (vertex) node, sentinel n_nodes_p
    #   pmg_edge:   midpoint v-node -> its edge's endpoint P1 nodes,
    #               sentinel n_nodes_p on vertex and padding nodes
    #   pmg_vert_v: P1 node -> its v-node, sentinel n_nodes_v on a strip's
    #               padding
    #   pmg_mid:    P1 node -> adjacent midpoint v-nodes (padded),
    #               sentinel n_nodes_v
    pmg_vert: torch.Tensor  # [n_nodes_v]
    pmg_edge: torch.Tensor  # [n_nodes_v, 2]
    pmg_vert_v: torch.Tensor  # [n_nodes_p]
    pmg_mid: torch.Tensor  # [n_nodes_p, K]

    # ---- element tables in dtype on device (make_simplex_tables) ----
    phi_v: torch.Tensor  # [n_q, 6]
    dphi_v: torch.Tensor  # [n_q, 6, 2] reference gradients
    phi_p: torch.Tensor  # [n_q, 3]
    dphi_p: torch.Tensor  # [n_q, 3, 2]
    w_q: torch.Tensor  # [n_q] (sums to 1/2)
    phi_v_edge: torch.Tensor  # [3, n_qe, 6]
    dphi_v_edge: torch.Tensor  # [3, n_qe, 6, 2]
    phi_p_edge: torch.Tensor  # [3, n_qe, 3]
    w_e: torch.Tensor  # [n_qe]

    # f32 dense inverses of the (constant per-mesh) pressure mass and
    # pressure Laplacian: the Schur legs as one matrix-vector product each
    # (unstructured/dense.py; None = iterative legs)
    dense_mp_raw_inv: torch.Tensor | None = None
    dense_lp_inv: torch.Tensor | None = None
    # the P2 -> P1 p-multigrid velocity preconditioner (unstructured/pmg.py)
    p_mg: bool = False
    # x-strip decomposition (dist/simplex.py): the strip count, this
    # strip's index, the velocity / pressure seam tables and the rank mesh
    # of the collectives (a dist.Mesh; None builds a strip without
    # collectives, e.g. to compare tables).  No strips: 1, 0, None, None.
    halo_n: int = 1
    halo_ix: int = 0
    seam_v: SeamTables | None = None
    seam_p: SeamTables | None = None
    mesh: object = None

    @property
    def dtype(self) -> torch.dtype:
        return self.detJ.dtype

    @property
    def device(self) -> torch.device:
        return self.detJ.device

    # --- interface shared with the structured Disc ---
    @property
    def mg(self):
        return None

    @property
    def decomposed(self) -> bool:
        """True on an x-strip of a decomposed mesh."""
        return self.seam_v is not None

    @property
    def halo_ny(self) -> int:
        return 1

    @property
    def halo_iy(self) -> int:
        return 0

    @property
    def NV(self) -> tuple[int]:
        return (self.n_nodes_v,)

    @property
    def NP(self) -> tuple[int]:
        return (self.n_nodes_p,)

    def zeros_u(self) -> torch.Tensor:
        return torch.zeros((2, self.n_nodes_v), dtype=self.dtype, device=self.device)

    def zeros_p(self) -> torch.Tensor:
        return torch.zeros((self.n_nodes_p,), dtype=self.dtype, device=self.device)

    # Per-element quantities the operators read on every call, formed once
    # per disc (eager PyTorch would launch them again on each call).  The
    # operators apply per-element dense matrices assembled from the same
    # weak form as the JAX package's quadrature-point pipeline: one batched
    # matrix product per element block instead of evaluate / physics /
    # project (unstructured/ops.py).
    @functools.cached_property
    def wq(self) -> torch.Tensor:
        """Quadrature weights times |J|: [n_tri, n_q]."""
        return self.detJ[:, None] * self.w_q[None, :]

    @functools.cached_property
    def Dv(self) -> torch.Tensor:
        """Physical P2 gradients [n_tri, 2 (d/dx_k), n_q, 6]."""
        return torch.einsum("qmd,tdk->tkqm", self.dphi_v, self.invJ).contiguous()

    @functools.cached_property
    def Dp(self) -> torch.Tensor:
        """Physical P1 gradients [n_tri, 2, n_q, 3]."""
        return torch.einsum("qnd,tdk->tkqn", self.dphi_p, self.invJ).contiguous()

    @functools.cached_property
    def PWv(self) -> torch.Tensor:
        """P2 test functions times the weights: [n_tri, 6, n_q]."""
        return (self.phi_v.T[None] * self.wq[:, None, :]).contiguous()

    @functools.cached_property
    def PWp(self) -> torch.Tensor:
        """P1 test functions times the weights: [n_tri, 3, n_q]."""
        return (self.phi_p.T[None] * self.wq[:, None, :]).contiguous()

    @functools.cached_property
    def PDWv(self) -> torch.Tensor:
        """[PWv | weighted P2 gradients]: [n_tri, 6, 3 n_q], the projection
        of (values, gradients (k, q)) onto the P2 test functions."""
        dw = self.Dv * self.wq[:, None, :, None]  # [T, 2, q, 6]
        T, _, n_q, m = dw.shape
        return torch.cat([self.PWv, dw.permute(0, 3, 1, 2).reshape(T, m, 2 * n_q)], dim=2)

    @functools.cached_property
    def Kv(self) -> torch.Tensor:
        """P2 stiffness (grad phi_m, grad phi_n): [n_tri, 6, 6]."""
        return torch.einsum("tkqm,tkqn->tmn", self.Dv * self.wq[:, None, :, None], self.Dv)

    @functools.cached_property
    def Mv(self) -> torch.Tensor:
        """P2 mass (phi_m, phi_n): [n_tri, 6, 6]."""
        return self.PWv @ self.phi_v

    @functools.cached_property
    def Be(self) -> torch.Tensor:
        """(psi_n, d phi_m / d x_c): [n_tri, 3, 12], columns (m, c) -- the
        element divergence; ``apply_B`` is -Be (Stokes) or +Be (Newton),
        ``apply_Bt`` is -Be^T."""
        T = self.n_tri
        return torch.einsum("tnq,tcqm->tnmc", self.PWp, self.Dv).reshape(T, 3, 12)

    @functools.cached_property
    def Mpe(self) -> torch.Tensor:
        """P1 mass (psi_n, psi_j): [n_tri, 3, 3]."""
        return self.PWp @ self.phi_p

    @functools.cached_property
    def Lpe(self) -> torch.Tensor:
        """P1 stiffness (grad psi_n, grad psi_j): [n_tri, 3, 3]."""
        return torch.einsum("tkqn,tkqj->tnj", self.Dp * self.wq[:, None, :, None], self.Dp)

    @functools.cached_property
    def p_free(self) -> torch.Tensor:
        """Pressure nodes off the outlet: the rows the pressure Laplacian,
        ``apply_Fp`` and ``apply_Mp_raw`` do not eliminate.  A strip's
        padding slots (weight 0, outlet-flagged) touch no element and stay
        identity rows."""
        free = ~self.p_outlet
        if self.seam_p is not None:
            free = free & (self.seam_p.weight > 0)
        return free

    @functools.cached_property
    def u_dirichlet_p1(self) -> torch.Tensor:
        """The Dirichlet mask on the P1 (vertex) velocity nodes (False on a
        strip's padding)."""
        pad = torch.zeros(1, dtype=torch.bool, device=self.device)
        return torch.cat([self.u_dirichlet, pad])[self.pmg_vert_v]

    def replace(self, **kw) -> "SimplexDisc":
        return dataclasses.replace(self, **kw)

    def to(self, dtype: torch.dtype) -> "SimplexDisc":
        """The same discretization with every floating tensor in ``dtype``;
        ``self`` when already there."""
        if dtype == self.dtype:
            return self
        kw = {f: getattr(self, f).to(dtype) for f in _FLOAT_FIELDS}
        for f in _OPTIONAL_FLOAT_FIELDS:
            v = getattr(self, f)
            kw[f] = None if v is None else v.to(dtype)
        for f in ("seam_v", "seam_p"):
            v = getattr(self, f)
            kw[f] = None if v is None else dataclasses.replace(v, weight=v.weight.to(dtype))
        return dataclasses.replace(self, **kw)


def triangulate_channel(geo: ChannelGeometry):
    """Split each active quad of the internal channel grid into two
    triangles; returns (nodes_xy, tri, edges, edge_tag) in ``read_msh``
    layout.  The role of the reference's gmsh geometry (2dMeshFine.geo) for
    tests and for ``-M`` runs without a mesh file."""
    nx, ny = geo.nx, geo.ny
    xs = geo.x0 + np.arange(nx + 1) * geo.hx
    ys = geo.y0 + np.arange(ny + 1) * geo.hy
    X, Y = np.meshgrid(xs, ys)
    nodes_xy = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(iy, ix):
        return iy * (nx + 1) + ix

    iy, ix = np.nonzero(geo.cell_active)
    v00, v10 = vid(iy, ix), vid(iy, ix + 1)
    v11, v01 = vid(iy + 1, ix + 1), vid(iy + 1, ix)
    tri = np.concatenate(
        [np.stack([v00, v10, v11], axis=1), np.stack([v00, v11, v01], axis=1)]
    ).astype(np.int32)

    edges, edge_tag = [], []
    edge_nodes = {0: (v00, v01), 1: (v10, v11), 2: (v00, v10), 3: (v01, v11)}
    for f in range(4):
        bid = geo.face_id[f][iy, ix]
        sel = bid >= 0
        a, b = edge_nodes[f]
        for aa, bb, t in zip(a[sel], b[sel], bid[sel]):
            edges.append((aa, bb))
            edge_tag.append(t)
    return (
        nodes_xy,
        tri,
        np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        np.asarray(edge_tag, dtype=np.int32),
    )


def triangulate_channel_curved(
    nx: int,
    ny: int,
    *,
    cx: float = 0.2,
    cy: float = 0.2,
    r: float = 0.05,
    L: float = 2.2,
    H: float = 0.41,
):
    """Curved-cylinder channel triangulation (the gmsh-geometry analog).

    The reference generates its ``-M`` meshes from an OpenCASCADE
    rectangle-minus-circle geometry (2dMeshFine.geo:1-55: 2.2 x 0.41
    channel, circle r = 0.05 at (0.2, 0.2), physical ids 7 inlet / 8
    outlet / 6 wall / 10 cylinder).  gmsh's linear triangles approximate
    the circle by a polygon whose vertices lie exactly on it; this builds
    the same class of mesh without gmsh: background grid points (those
    within 0.7 h of the circle removed), ring points exactly on the circle
    at ~h spacing, Delaunay triangulation, triangles whose centroid falls
    inside the circle dropped.  Returns (nodes_xy, tri, edges, edge_tag) in
    ``io.read_msh`` layout.
    """
    from scipy.spatial import Delaunay

    xs = np.linspace(0.0, L, nx + 1)
    ys = np.linspace(0.0, H, ny + 1)
    X, Y = np.meshgrid(xs, ys)
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    h = min(L / nx, H / ny)
    d = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
    pts = pts[d > r + 0.7 * h]
    n_ring = max(12, int(np.ceil(2.0 * np.pi * r / h)))
    th = 2.0 * np.pi * np.arange(n_ring) / n_ring
    ring = np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=1)
    nodes = np.concatenate([pts, ring])
    tri = Delaunay(nodes).simplices.astype(np.int32)
    cent = nodes[tri].mean(axis=1)
    tri = tri[np.hypot(cent[:, 0] - cx, cent[:, 1] - cy) >= r]

    # boundary edges = edges referenced by exactly one remaining triangle
    pairs = np.sort(
        np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]]), axis=1
    )
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    bedges = uniq[counts == 1]

    def _tag(e):
        a, b = nodes[e[0]], nodes[e[1]]
        tol = 1e-9
        if abs(a[0]) < tol and abs(b[0]) < tol:
            return BOUNDARY_INLET
        if abs(a[0] - L) < tol and abs(b[0] - L) < tol:
            return BOUNDARY_OUTLET
        on_circle = (
            abs(np.hypot(*(a - [cx, cy])) - r) < 1e-9
            and abs(np.hypot(*(b - [cx, cy])) - r) < 1e-9
        )
        if on_circle:
            return BOUNDARY_CYLINDER
        return 6  # walls (y = 0 / y = H)

    btags = np.asarray([_tag(e) for e in bedges], dtype=np.int32)
    return nodes, tri, bedges.astype(np.int32), btags


def invert_scatter(idx: np.ndarray, n_nodes: int) -> np.ndarray:
    """Invert a scatter-add index map into a padded gather table.

    ``idx`` (any shape, values in [0, n_nodes)) assigns each flat source
    slot to a destination node.  Returns ``[n_nodes, K]`` int32 where row
    ``n`` lists the flat source positions contributing to node ``n`` in
    ascending order, padded with the sentinel ``idx.size`` (callers append
    one zero to the flattened source so the sentinel gathers 0.0).
    """
    flat = np.asarray(idx).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_nodes = flat[order]
    counts = np.bincount(sorted_nodes, minlength=n_nodes)
    k_max = int(counts.max()) if counts.size else 0
    out = np.full((n_nodes, max(k_max, 1)), flat.size, dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(flat.size) - starts[sorted_nodes]
    out[sorted_nodes, pos] = order
    return out


def _affine(nodes_xy, tri):
    v0 = nodes_xy[tri[:, 0]]
    e1 = nodes_xy[tri[:, 1]] - v0
    e2 = nodes_xy[tri[:, 2]] - v0
    return e1, e2, e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]


def _edge_dofs(tri, n_verts):
    """Unique sorted edges and each element's three midpoint node ids."""
    n_tri = tri.shape[0]
    pairs = np.concatenate([np.sort(tri[:, list(e)], axis=1) for e in EDGE_VERTICES])
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    mids = np.stack([n_verts + inv[k * n_tri : (k + 1) * n_tri] for k in range(3)], axis=1)
    return uniq, mids


def make_simplex_disc(
    nodes_xy: np.ndarray,
    tri: np.ndarray,
    bedges: np.ndarray,
    bedge_tag: np.ndarray,
    *,
    dtype: torch.dtype,
    device: torch.device | str,
    H: float = 0.41,
) -> SimplexDisc:
    """Lower a triangle mesh to tensors of ``dtype`` on ``device``.

    ``bedges``/``bedge_tag``: boundary line elements with physical ids.
    Inverted triangles are flipped to positive orientation.
    """
    nodes_xy = np.asarray(nodes_xy, dtype=np.float64)
    tri = np.array(tri, dtype=np.int64)
    n_verts = nodes_xy.shape[0]
    n_tri = tri.shape[0]

    # ---- affine maps, orientation ----
    e1, e2, detJ = _affine(nodes_xy, tri)
    if np.any(detJ <= 0):
        flip = detJ <= 0
        tri[flip, 1], tri[flip, 2] = tri[flip, 2].copy(), tri[flip, 1].copy()
        e1, e2, detJ = _affine(nodes_xy, tri)
    J = np.stack([e1, e2], axis=-1)  # [n_tri, 2, 2], columns e1, e2
    invJ = np.linalg.inv(J)  # d xi / d x

    # ---- unique edges -> P2 midpoint numbering ----
    uniq, mids = _edge_dofs(tri, n_verts)
    n_edges = uniq.shape[0]
    dofs_v = np.concatenate([tri, mids], axis=1).astype(np.int32)
    coords_v = np.concatenate([nodes_xy, 0.5 * (nodes_xy[uniq[:, 0]] + nodes_xy[uniq[:, 1]])])
    n_nodes_v = n_verts + n_edges

    # ---- boundary node masks ----
    bedges_s = np.sort(np.asarray(bedges, dtype=np.int64).reshape(-1, 2), axis=1)
    bedge_tag = np.asarray(bedge_tag).reshape(-1)
    u_dir = np.zeros(n_nodes_v, dtype=bool)
    u_inl = np.zeros(n_nodes_v, dtype=bool)
    edge_lookup = {tuple(e): i for i, e in enumerate(map(tuple, uniq.tolist()))}
    for (a, b), tag in zip(map(tuple, bedges_s.tolist()), bedge_tag):
        mid = edge_lookup.get((a, b))
        ids = [a, b] + ([n_verts + mid] if mid is not None else [])
        if tag in _DIRICHLET_IDS:
            u_dir[ids] = True
        if tag == BOUNDARY_INLET:
            u_inl[ids] = True

    y_v = coords_v[:, 1]
    inlet_profile1 = 4.0 * y_v * (H - y_v) / (H * H)

    p_out_mask = np.zeros(n_verts, dtype=bool)
    for (a, b), tag in zip(map(tuple, bedges_s.tolist()), bedge_tag):
        if tag == BOUNDARY_OUTLET:
            p_out_mask[[a, b]] = True

    # ---- boundary edge -> (tri, local edge): the first element, in
    # (local edge, element) order, that has the edge ----
    order = [(t, k) for k in range(3) for t in range(n_tri)]
    keys = np.concatenate([np.sort(tri[:, list(e)], axis=1) for e in EDGE_VERTICES])
    tri_edge_lookup = dict(zip(map(tuple, keys[::-1].tolist()), order[::-1]))

    def boundary_edge_data(tag_sel):
        tris, ledges, lens, normals = [], [], [], []
        for (a, b), tag in zip(map(tuple, bedges_s.tolist()), bedge_tag):
            if tag != tag_sel:
                continue
            hit = tri_edge_lookup.get((a, b))
            if hit is None:
                continue
            t, k = hit
            va, vb = EDGE_VERTICES[k]
            pa, pb = nodes_xy[tri[t, va]], nodes_xy[tri[t, vb]]
            d = pb - pa
            length = float(np.hypot(*d))
            n = np.array([d[1], -d[0]]) / max(length, 1e-300)
            centroid = nodes_xy[tri[t]].mean(axis=0)
            if np.dot(n, centroid - 0.5 * (pa + pb)) > 0:
                n = -n
            tris.append(t)
            ledges.append(k)
            lens.append(length)
            normals.append(n)
        return (
            np.asarray(tris, dtype=np.int64),
            np.asarray(ledges, dtype=np.int64),
            np.asarray(lens, dtype=np.float64),
            np.asarray(normals, dtype=np.float64).reshape(-1, 2),
        )

    cyl_tri, cyl_edge, cyl_len, cyl_normal = boundary_edge_data(BOUNDARY_CYLINDER)

    # ---- outlet Neumann rhs at p_out = 1 (NSSolver.cpp:528-551) ----
    tabs = make_simplex_tables()
    out = np.zeros((2, n_nodes_v))
    for t, k, length, n in zip(*boundary_edge_data(BOUNDARY_OUTLET)):
        loc = -np.einsum("q,qm->m", tabs.w_e * length, tabs.phi_v_edge[k])
        for c in range(2):
            if n[c] == 0.0:
                continue
            np.add.at(out[c], dofs_v[t], loc * n[c])

    # ---- P2 -> P1 p-multigrid transfer tables ----
    pmg_vert = np.full(n_nodes_v, n_verts, dtype=np.int64)
    pmg_vert[:n_verts] = np.arange(n_verts)
    pmg_edge = np.full((n_nodes_v, 2), n_verts, dtype=np.int64)
    pmg_edge[n_verts:] = uniq
    ge = invert_scatter(np.concatenate([uniq[:, 0], uniq[:, 1]]), n_verts)
    pmg_mid = np.where(ge == 2 * n_edges, n_nodes_v, n_verts + (ge % max(n_edges, 1)))

    fl = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device).to(dtype)
    ix = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    bl = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
    return SimplexDisc(
        n_nodes_v=n_nodes_v,
        n_nodes_p=n_verts,
        n_tri=n_tri,
        dofs_v=ix(dofs_v),
        dofs_p=ix(tri),
        coords_v=fl(coords_v),
        coords_p=fl(nodes_xy),
        invJ=fl(invJ),
        detJ=fl(detJ),
        u_dirichlet=bl(u_dir),
        u_inlet=bl(u_inl),
        inlet_profile1=fl(inlet_profile1),
        neumann_rhs1=fl(out),
        cyl_tri=ix(cyl_tri),
        cyl_edge=ix(cyl_edge),
        cyl_len=fl(cyl_len),
        cyl_normal=fl(cyl_normal),
        edge_verts=ix(uniq),
        gather_v=ix(invert_scatter(dofs_v, n_nodes_v)),
        gather_p=ix(invert_scatter(tri, n_verts)),
        gather_ev=ix(invert_scatter(uniq.T, n_verts)),  # [2*n_edges] = [ep0..., ep1...]
        p_outlet=bl(p_out_mask),
        pmg_vert=ix(pmg_vert),
        pmg_edge=ix(pmg_edge),
        pmg_vert_v=ix(np.arange(n_verts)),
        pmg_mid=ix(pmg_mid),
        phi_v=fl(tabs.phi_v),
        dphi_v=fl(tabs.dphi_v),
        phi_p=fl(tabs.phi_p),
        dphi_p=fl(tabs.dphi_p),
        w_q=fl(tabs.w_q),
        phi_v_edge=fl(tabs.phi_v_edge),
        dphi_v_edge=fl(tabs.dphi_v_edge),
        phi_p_edge=fl(tabs.phi_p_edge),
        w_e=fl(tabs.w_e),
    )
