"""1-D/2-D domain decomposition of the structured channel, one tile per rank.

The port of the JAX package's ``dist/halo.py`` (the reference's MPI
decomposition, deal.II ``parallel::fullydistributed::Triangulation`` with
Trilinos ghost exchange, NSSolver.cpp:98-102, :560-562).  The channel
splits into ``n_x x n_y`` tiles of cells; each tile stores its node slab
*including* the seam columns and rows it shares with its neighbours (the
ghost DoFs).  On a tile the operators complete their seam sums with the
neighbours (``ops.lattice._seam_sum``, the x-exchange before the
y-exchange), inner products weigh the seams 1/2 per sharing tile and sum
over the tiles (``ops.matfree.make_dot``), and lift and drag sum over the
tiles.

Where the JAX package stacks every tile on a leading axis inside one
program, each rank here holds its own tile: ``decompose_disc`` is a pure
function of ``(disc, n_x, n_y, iy, ix)`` that returns one tile (so a test
builds any tile without a process group), and the host-side
``scatter_blocks`` / ``gather_blocks`` convert between a global (u, p)
and the tile-stacked layout ``[n_y * n_x, ...]`` (y-major) of the JAX
package, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.elements import make_taylor_hood
from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
from navier_stokes_solver_tpu_torch.ops.blocks import Blocks
from navier_stokes_solver_tpu_torch.ops.disc import Disc, MGEdge, _element_fields, make_disc
from navier_stokes_solver_tpu_torch.precond.mg import _coarse_shape, _interp_1d

__all__ = [
    "decompose_disc",
    "scatter_blocks",
    "gather_blocks",
    "all_gather_blocks",
    "tile_blocks",
]


def _check_divisible(n: int, parts: int, what: str):
    if n % parts != 0:
        raise ValueError(
            f"{what} = {n} not divisible by {parts}; choose a mesh size "
            "that splits across the tiles"
        )


def _decomposed_mg_chain(disc: Disc, n_x: int, n_y: int, iy: int, ix: int, *, mesh, device,
                         make_geometry, min_cells: int, max_levels: int):
    """The tile's MG chain, by per-tile ceil-halving of the cell counts
    (every level's global counts are the tile counts times the tile grid,
    so every level divides).  Transfers are tile-local (evaluated on the
    tile's unit-interval grids): prolongation of a continuous nodal
    function is tile-local exact, and restriction becomes exact after the
    seam weighting and the seam exchange (``precond.mg._restrict``).  The
    matrices are the same on every tile."""
    tables = make_taylor_hood(disc.deg_v, disc.deg_p, disc.n_q1d)
    nodes_v, nodes_p = tables.nodes_v, tables.nodes_p
    kv, kp = disc.deg_v, disc.deg_p
    # fixed physical tile extent (aspect-aware semi-coarsening)
    Wt = disc.hx * disc.nx / n_x
    Ht = disc.hy * disc.ny / n_y
    put = lambda a: torch.as_tensor(a, device=device).to(disc.dtype)

    def build(nxl: int, nyl: int, level: int):
        nxl_c, nyl_c = _coarse_shape(nxl, nyl, Wt / nxl, Ht / nyl)
        nx_c, ny_c = nxl_c * n_x, nyl_c * n_y
        if (
            level >= max_levels
            or nx_c * ny_c < min_cells
            or ny_c < 2
            or (nxl_c == nxl and nyl_c == nyl)
        ):
            return None
        space_c = make_fe_space(make_geometry(nx_c, ny_c), kv, kp)
        coarse = decompose_disc(
            make_disc(space_c, disc.dtype, "cpu"), n_x, n_y, iy, ix,
            mesh=mesh, device=device, multigrid=False,
        )
        edge_down = build(nxl_c, nyl_c, level + 1)
        if edge_down is not None:
            coarse = coarse.replace(mg=edge_down)
        return MGEdge(
            coarse=coarse,
            Pvx=put(_interp_1d(nxl_c, nxl, kv, nodes_v)),
            Pvy=put(_interp_1d(nyl_c, nyl, kv, nodes_v)),
            Evx=put(_interp_1d(nxl, nxl_c, kv, nodes_v)),
            Evy=put(_interp_1d(nyl, nyl_c, kv, nodes_v)),
            Ppx=put(_interp_1d(nxl_c, nxl, kp, nodes_p)),
            Ppy=put(_interp_1d(nyl_c, nyl, kp, nodes_p)),
        )

    return build(disc.nx // n_x, disc.ny // n_y, 0)


def decompose_disc(
    disc: Disc,
    n_x: int,
    n_y: int = 1,
    iy: int = 0,
    ix: int = 0,
    *,
    mesh=None,
    device=None,
    multigrid: bool | None = None,
    make_geometry=make_channel_geometry,
    mg_min_cells: int = 48,
    mg_max_levels: int = 8,
) -> Disc:
    """Tile ``(iy, ix)`` of an ``n_x x n_y`` split of the global ``disc``.

    The tile has the local cell counts (``nx / n_x``, ``ny / n_y``), its
    slices of every mask and profile (lattice slabs with the seam nodes
    duplicated), the halo fields, ``mesh`` (a ``dist.Mesh``; None builds a
    tile without collectives, e.g. to compare tiles) and lives on
    ``device`` (default: the global disc's).

    ``multigrid``: attach the decomposition-aware chain
    (``_decomposed_mg_chain``; its coarse levels are
    ``make_geometry(nx, ny)`` like ``precond.attach_mg``'s); default: when
    the global disc has one.
    """
    _check_divisible(disc.nx, n_x, "nx")
    _check_divisible(disc.ny, n_y, "ny")
    if not (0 <= ix < n_x and 0 <= iy < n_y):
        raise ValueError(f"tile ({iy}, {ix}) outside the {n_y} x {n_x} tile grid")
    device = disc.device if device is None else torch.device(device)
    if multigrid is None:
        multigrid = disc.mg is not None
    nxl, nyl = disc.nx // n_x, disc.ny // n_y
    kv, kp = disc.deg_v, disc.deg_p

    def lat(a, k):
        return a[..., k * iy * nyl: k * (iy + 1) * nyl + 1, k * ix * nxl: k * (ix + 1) * nxl + 1]

    def cells(a):
        return a[..., iy * nyl: (iy + 1) * nyl, ix * nxl: (ix + 1) * nxl]

    put = lambda a: a.to(device).contiguous()
    cell_mask = put(cells(disc.cell_mask))
    mg = None
    if multigrid:
        mg = _decomposed_mg_chain(
            disc, n_x, n_y, iy, ix, mesh=mesh, device=device, make_geometry=make_geometry,
            min_cells=mg_min_cells, max_levels=mg_max_levels,
        )
    return Disc(
        nx=nxl,
        ny=nyl,
        deg_v=kv,
        deg_p=kp,
        n_q1d=disc.n_q1d,
        hx=disc.hx,
        hy=disc.hy,
        cell_mask=cell_mask,
        u_active=put(lat(disc.u_active, kv)),
        p_active=put(lat(disc.p_active, kp)),
        u_dirichlet=put(lat(disc.u_dirichlet, kv)),
        u_inlet=put(lat(disc.u_inlet, kv)),
        inlet_profile1=put(disc.inlet_profile1[kv * iy * nyl: kv * (iy + 1) * nyl + 1]),
        neumann_rhs1=put(lat(disc.neumann_rhs1, kv)),
        cyl_face_mask=put(cells(disc.cyl_face_mask)),
        forcing_rhs=None if disc.forcing_rhs is None else put(lat(disc.forcing_rhs, kv)),
        mg=mg,
        halo_n=n_x,
        halo_ny=n_y,
        halo_ix=ix,
        halo_iy=iy,
        mesh=mesh,
        **_element_fields(make_taylor_hood(kv, kp, disc.n_q1d), disc.hx, disc.hy, cell_mask),
    )


def _as_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def scatter_blocks(x: Blocks, sdisc: Disc) -> Blocks:
    """Global (u, p) -> tile-stacked slabs ``[n_y * n_x, ...]`` (y-major,
    seams duplicated) as host arrays: the JAX package's layout, bit for
    bit.  ``sdisc``: any tile of the decomposition."""
    nx_t, ny_t = sdisc.halo_n, sdisc.halo_ny
    nxl, nyl = sdisc.nx, sdisc.ny

    def split(a, k):
        a = _as_numpy(a)
        return np.stack([
            a[..., k * iy * nyl: k * (iy + 1) * nyl + 1, k * ix * nxl: k * (ix + 1) * nxl + 1]
            for iy in range(ny_t)
            for ix in range(nx_t)
        ])

    return Blocks(u=split(x.u, sdisc.deg_v), p=split(x.p, sdisc.deg_p))


def gather_blocks(xs: Blocks, sdisc: Disc) -> Blocks:
    """Tile-stacked slabs -> global (u, p) as host arrays, dropping the
    duplicate seams (each seam node from its lower tile)."""
    nx_t, ny_t = sdisc.halo_n, sdisc.halo_ny

    def join(a):
        a = _as_numpy(a)
        rows = []
        for iy in range(ny_t):
            row = np.concatenate(
                [a[iy * nx_t + ix][..., (1 if ix > 0 else 0):] for ix in range(nx_t)], axis=-1
            )
            rows.append(row[..., (1 if iy > 0 else 0):, :])
        return np.concatenate(rows, axis=-2)

    return Blocks(u=join(xs.u), p=join(xs.p))


def tile_blocks(x: Blocks, sdisc: Disc) -> Blocks:
    """This tile's slab of the global (u, p), as tensors on its device."""
    i = sdisc.halo_iy * sdisc.halo_n + sdisc.halo_ix
    xs = scatter_blocks(x, sdisc)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a[i]), device=sdisc.device).to(sdisc.dtype)
    return Blocks(u=put(xs.u), p=put(xs.p))


def all_gather_blocks(x: Blocks, sdisc: Disc, *, stacked: bool = False) -> Blocks:
    """Every tile's slab of ``x`` (this rank's tile; a collective over the
    tiles), as the global (u, p) host arrays on every rank -- or, with
    ``stacked``, as the tile-stacked host arrays."""
    mesh = sdisc.mesh
    xs = Blocks(*(np.stack([_as_numpy(t) for t in mesh.all_gather(a)]) for a in x))
    return xs if stacked else gather_blocks(xs, sdisc)

