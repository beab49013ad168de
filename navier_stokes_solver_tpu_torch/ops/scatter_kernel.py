"""Ordered velocity scatter with apply_F's boundary rows: CUDA kernel wrapper
and plain version.

Kernel B (``csrc/scatter_v.cu``): the second of the two launches that
``apply_F`` made before it became one (``ops/apply_f_kernel.py``, whose
epilogue is this kernel's pull); only the card-side checks launch it now,
as the oracle the one-launch kernel is held against bit for bit.  It
sums the cell kernel's local results onto the velocity lattice -- at every
node its up-to-four contributions in ascending local index, from +0.0, the
JAX package's order -- and, given ``bc_diag``, applies the boundary rows
``where(u_dirichlet, bc_diag * x, y)`` then ``where(u_active, y, x)``.
With a leading member axis (an ensemble) one launch serves the B members,
each bit for bit as its own launch would.  One
thread per lattice node pulls its contributions: no atomics, the same bits
as the plain version on every run.  It replaces the JAX package's XLA
scatter and ``where`` (``navier_stokes_solver_tpu/ops/matfree.py``
``_scatter`` and ``apply_F``), which the port had run as eight PyTorch
launches.  CPU tensors take the plain version; a CUDA tensor launches the
kernel or raises.

On a tile of a domain decomposition the boundary rows cannot ride in the
kernel: a Dirichlet node on a seam would get ``bc_diag * x`` from both
tiles, twice its value after the seam sum.  There the kernel runs with
its rows off, then the seam exchange, then the two ``where``s -- the
JAX package's order (seam sum inside the scatter, rows after it).
"""

from __future__ import annotations

import collections

import torch

from navier_stokes_solver_tpu_torch.ops.cell_kernel import check_operand
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.ops.lattice import _scatter_v, _seam_sum

__all__ = ["scatter_v_bc", "scatter_v_bc_plain"]


def scatter_v_bc_plain(disc: Disc, loc, *, bc_diag=None, x_u=None):
    """``_scatter_v`` and, given ``bc_diag``, the two boundary ``where``s."""
    y = _scatter_v(disc, loc)
    if bc_diag is not None:
        y = _boundary_rows(disc, y, bc_diag, x_u)
    return y


def _boundary_rows(disc: Disc, y, bc_diag, x_u):
    y = torch.where(disc.u_dirichlet, bc_diag * x_u, y)
    return torch.where(disc.u_active, y, x_u)


def scatter_v_bc(disc: Disc, loc, *, bc_diag=None, x_u=None):
    """Scatter ``loc`` [n_v, (B,) 2, ny, nx] (contiguous) onto the velocity
    lattice [(B,) 2, NY, NX], with the boundary rows when ``bc_diag``
    [(B,) 2, NY, NX] (contiguous) is given; ``x_u`` [(B,) 2, NY, NX] (dense,
    read through its strides) is then the operand of those rows, and is not
    read otherwise.  (B,): the optional member axis.

    ``scatter_v_bc.launches`` counts the kernel's launches,
    ``scatter_v_bc.launches_by_shape`` the same by ``(nx, ny, dtype name)``
    (and ``"B<members>"`` for a batched launch).
    """
    k, ny, nx = disc.deg_v, disc.ny, disc.nx
    lead = tuple(loc.shape[1:-3])
    dtype, device = disc.dtype, disc.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"scatter_v_bc: unsupported dtype {dtype}")
    if k not in (2, 3):
        raise ValueError(f"scatter_v_bc: no kernel for velocity degree {k}")
    check_operand("scatter_v_bc", "loc", loc, ((k + 1) ** 2, *lead, 2, ny, nx), dtype, device)
    lattice = lead + (2,) + disc.NV
    if bc_diag is not None:
        if x_u is None:
            raise ValueError("scatter_v_bc: the boundary rows need x_u")
        check_operand("scatter_v_bc", "bc_diag", bc_diag, lattice, dtype, device)
        check_operand("scatter_v_bc", "x_u", x_u, lattice, dtype, device, dense=True)
    if device.type == "cpu":
        return scatter_v_bc_plain(disc, loc, bc_diag=bc_diag, x_u=x_u)
    if device.type != "cuda":
        raise ValueError(f"scatter_v_bc: no kernel for device {device}")
    if disc.decomposed:
        # a tile: the kernel without its rows, the seam sum, then the rows
        y = _seam_sum(disc, _launch(disc, loc, None, None, lead))
        return y if bc_diag is None else _boundary_rows(disc, y, bc_diag, x_u)
    return _launch(disc, loc, bc_diag, x_u, lead)


def _launch(disc: Disc, loc, bc_diag, x_u, lead):
    """One launch of the kernel (with the boundary rows when ``bc_diag``
    is given) into a new lattice tensor."""
    k, ny, nx = disc.deg_v, disc.ny, disc.nx
    dtype, device = disc.dtype, disc.device
    lattice = lead + (2,) + disc.NV

    from navier_stokes_solver_tpu_torch import _ext

    lib = _ext.load()
    out = torch.empty(lattice, dtype=dtype, device=device)
    if bc_diag is None:
        bc = (None, 0, 0, 0, 0, None, None, None)
    else:
        for m in (disc.u_dirichlet, disc.u_active):
            if m.dtype != torch.bool or not m.is_contiguous():
                raise ValueError("scatter_v_bc: the boundary masks must be contiguous bool")
        bc = (
            x_u.data_ptr(), *((0,) if not lead else ()), *x_u.stride(), bc_diag.data_ptr(),
            disc.u_dirichlet.data_ptr(), disc.u_active.data_ptr(),
        )
    err = lib.nstt_scatter_v(
        1 if dtype == torch.float64 else 0,
        k,
        loc.data_ptr(),
        nx,
        ny,
        *bc,
        out.data_ptr(),
        lead[0] if lead else 1,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"scatter_v_bc: kernel launch failed ({_ext.error_string(err)})")
    scatter_v_bc.launches += 1
    scatter_v_bc.launches_by_shape[(nx, ny, str(dtype)[6:]) + tuple(f"B{b}" for b in lead)] += 1
    return out


scatter_v_bc.launches = 0
scatter_v_bc.launches_by_shape = collections.Counter()
