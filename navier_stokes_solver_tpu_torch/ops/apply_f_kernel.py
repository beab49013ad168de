"""The velocity-block apply F in one launch: CUDA kernel wrapper and plain
version.

``apply_F_fused`` computes what the cell kernel and the ordered scatter
compute one after the other -- ``scatter_v_bc(disc,
cell_apply_F_lattice(disc, nu, inv_dt, linq, x_u, stokes=...),
bc_diag=..., x_u=x_u)`` -- in one launch of ``csrc/apply_f_fused.cu``,
bit for bit.  A block owns a tile of cells and the lattice nodes they
start, recomputes the halo row and column of cells whose results its
edge nodes also sum, keeps the cell-local results in shared memory and
pulls each owned node's contributions in the scatter's order (ascending
local index, from +0.0) before the boundary rows.  The tile is one of
a few block shapes, picked per launch from the cells it covers
(``block_shape``: larger tiles recompute fewer cells, smaller ones spread
a small mesh over more SMs); all give the same bits.  It replaces the JAX
package's Pallas kernel ``navier_stokes_solver_tpu/ops/pallas_cell.py::_run``
with the XLA scatter and ``where``s of its ``apply_F``; the two kernels
it fused (``ops/cell_kernel.py``, ``ops/scatter_kernel.py``) stay built
and callable, as the card-side oracle it is checked against.

Every variant of the two: f32 and f64, velocity degree 2 and 3, Stokes
and Newton, with and without the boundary rows, the member axis (an
ensemble: lattices [B, 2, NY, NX], the linearization [n_q, B, ...],
``nu`` a [B] tensor on the card), and a dense lattice in any axis order.
CPU tensors take ``apply_F_fused_plain``; a CUDA tensor launches the
kernel or raises.  On a tile of a domain decomposition the kernel runs
with its rows off, then the seam exchange, then the rows
(``ops/scatter_kernel.py`` says why).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from navier_stokes_solver_tpu_torch.ops.blocks import is_batched
from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
    _check_common,
    cell_apply_F_lattice_plain,
    check_operand,
)
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.ops.lattice import _seam_sum
from navier_stokes_solver_tpu_torch.ops.scatter_kernel import _boundary_rows, scatter_v_bc_plain

__all__ = ["apply_F_fused", "apply_F_fused_plain", "BLOCK_SHAPES", "block_shape", "block_tile"]

# The block shapes the kernel is built with, per velocity degree: the
# cells (rows, columns) a block computes; the tile it owns is one row and
# one column fewer (its halo).  Every shape gives the same bits.
BLOCK_SHAPES = {3: ((4, 16), (4, 8), (3, 16)), 2: ((7, 16), (4, 16))}
# The shape a launch takes, from the cells it covers (the members'
# included): the first (least cells, shape) that applies.  A larger tile
# recomputes fewer halo cells, a smaller one spreads a small mesh over
# more SMs; the thresholds are the H100's (``scripts/torch_apply_f_ab.py
# --shapes``, PERF.md).
SHAPE_BY_CELLS = {3: ((15_000, 0), (3_000, 2), (0, 1)), 2: ((20_000, 0), (0, 1))}


def block_shape(k: int, cells: int) -> int:
    """The block shape (an index into ``BLOCK_SHAPES[k]``) of a launch
    over ``cells`` cells."""
    return next(shape for least, shape in SHAPE_BY_CELLS[k] if cells >= least)


def block_tile(k: int, shape: int = 0) -> tuple[int, int]:
    """The cells (rows, columns) a block owns at velocity degree ``k``."""
    rows, cols = BLOCK_SHAPES[k][shape]
    return rows - 1, cols - 1


def apply_F_fused_plain(disc: Disc, nu, inv_dt, linq, x_u, *, stokes: bool, bc_diag=None):
    """The same function in plain PyTorch: the plain cell apply, then the
    plain ordered scatter with the boundary rows."""
    loc = cell_apply_F_lattice_plain(disc, nu, inv_dt, linq, x_u, stokes=stokes)
    return scatter_v_bc_plain(disc, loc, bc_diag=bc_diag, x_u=x_u)


def apply_F_fused(disc: Disc, nu, inv_dt, linq, x_u, *, stokes: bool, bc_diag=None):
    """Velocity-block apply on the lattice ``x_u`` [(B,) 2, NY, NX] (dense:
    contiguous or with its axes permuted; read in place through its
    strides) -> [(B,) 2, NY, NX] contiguous, with the boundary rows when
    ``bc_diag`` [(B,) 2, NY, NX] (contiguous) is given.

    Every operand is checked before the launch; a shape, dtype, device or
    layout the kernel does not take raises ``ValueError``.
    ``apply_F_fused.launches`` counts the kernel's launches,
    ``apply_F_fused.launches_by_shape`` the same by ``(nx, ny, stokes,
    dtype name)`` (and ``"B<members>"`` for a batched launch).
    """
    lead = tuple(x_u.shape[:-3])
    _check_common(disc, nu, linq, stokes, lead)
    lattice = lead + (2,) + disc.NV
    check_operand("apply_F_fused", "x_u", x_u, lattice, disc.dtype, disc.device, dense=True)
    if bc_diag is not None:
        check_operand("apply_F_fused", "bc_diag", bc_diag, lattice, disc.dtype, disc.device)
        for name in ("u_dirichlet", "u_active"):
            check_operand("apply_F_fused", name, getattr(disc, name), disc.NV, torch.bool, disc.device)
    if disc.device.type == "cpu":
        return apply_F_fused_plain(disc, nu, inv_dt, linq, x_u, stokes=stokes, bc_diag=bc_diag)
    if disc.device.type != "cuda":
        raise ValueError(f"apply_F_fused: no kernel for device {disc.device}")
    if disc.decomposed:
        # a tile: the kernel without its rows, the seam sum, then the rows
        y = _seam_sum(disc, _launch(disc, nu, inv_dt, linq, x_u, None, stokes, lead))
        return y if bc_diag is None else _boundary_rows(disc, y, bc_diag, x_u)
    return _launch(disc, nu, inv_dt, linq, x_u, bc_diag, stokes, lead)


def _launch(disc: Disc, nu, inv_dt, linq, x_u, bc_diag, stokes: bool, lead: tuple, shape=None):
    """One launch into a new lattice tensor, the boundary rows fused when
    ``bc_diag`` is given; ``shape``: the block shape (``BLOCK_SHAPES``),
    by default ``block_shape``'s."""
    from navier_stokes_solver_tpu_torch import _ext

    lib = _ext.load()
    device, dtype = disc.device, disc.dtype
    ny, nx = disc.ny, disc.nx
    if shape is None:
        shape = block_shape(disc.deg_v, nx * ny * (lead[0] if lead else 1))
    out = torch.empty(lead + (2,) + disc.NV, dtype=dtype, device=device)
    s_m, s_c, s_y, s_x = (0,) * (1 - len(lead)) + x_u.stride()
    uq, guq = (None, None) if stokes else (linq.u.data_ptr(), linq.gradu.data_ptr())
    # a batched nu is read on the card; a number is passed by value
    nu_b, nu_h = (nu.data_ptr(), 0.0) if is_batched(nu) else (None, float(nu))
    if bc_diag is None:
        bc = (None, None, None)
    else:
        bc = (bc_diag.data_ptr(), disc.u_dirichlet.data_ptr(), disc.u_active.data_ptr())
    err = lib.nstt_apply_f_fused(
        1 if dtype == torch.float64 else 0,
        disc.deg_v,
        int(stokes),
        x_u.data_ptr(),
        s_m, s_c, s_y, s_x,
        uq,
        guq,
        disc.cell_w.data_ptr(),
        disc.cell_tabs.data_ptr(),
        ctypes.c_double(nu_h),
        nu_b,
        ctypes.c_double(float(inv_dt)),
        *bc,
        out.data_ptr(),
        nx,
        ny,
        lead[0] if lead else 1,
        shape,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"apply_F_fused: kernel launch failed ({_ext.error_string(err)})")
    apply_F_fused.launches += 1
    apply_F_fused.launches_by_shape[(nx, ny, bool(stokes), str(dtype)[6:]) + tuple(f"B{b}" for b in lead)] += 1
    return out


apply_F_fused.launches = 0
apply_F_fused.launches_by_shape = collections.Counter()
