"""Fused per-cell velocity-block apply: CUDA kernel wrapper and plain version.

Replaces the JAX package's Pallas TPU kernel
``navier_stokes_solver_tpu/ops/pallas_cell.py::_run`` (wrapper
``cell_apply_F_pallas``).  Per cell it evaluates the gradients (and, in
the Newton regime, the values) of the gathered velocity DoFs at the
quadrature points, applies the physics -- the flux ``nu grad x`` plus, in
the Newton regime, ``(u_k . grad) x + (x . grad) u_k + x / dt`` -- and
projects back onto the test functions weighted by JxW and the active-cell
mask.

On the H100 the kernel (``csrc/cell_apply_f.cu``) runs one thread per
cell.  Each cell reads about 2 n_v + 6 n_q + n_q words (its DoFs, the
linearization state and its quadrature weights), writes 2 n_v, and does
about 10 n_q n_v flops per velocity component: a few flops per byte, so
per byte it would be bound by memory.  At the main path's 100x70 it is
bound by latency instead: one thread per cell is 7,000 threads, about one
64-thread block per SM, too few to hide the load latency, so a call runs
at a few percent of the HBM roofline (PERF.md).  The design keeps the
bytes minimal -- every input read once, coalesced along the contiguous
cell axis; the three [n_q, n_v] tables in shared memory (6 KB in f64),
read as broadcasts; all intermediates in registers -- and leaves the fill
of the card to later work: more threads per cell (one per quadrature
point or per local DoF), and fusing the gather into the kernel.  It is
launched on the current stream and allocates nothing.
"""

from __future__ import annotations

import ctypes

import torch

from navier_stokes_solver_tpu_torch.ops.disc import Disc

__all__ = ["cell_apply_F", "cell_apply_F_plain"]


def cell_apply_F_plain(disc: Disc, nu, inv_dt, linq, x_loc, *, stokes: bool):
    """The same function as the kernel, in plain PyTorch (einsum).

    ``x_loc``: gathered input DoFs [n_v, 2, ny, nx]; ``linq``: the
    LinearizationQ at quadrature points (ignored in the Stokes regime).
    Returns the local test-function contributions [n_v, 2, ny, nx].
    """
    P, Dx, Dy = disc.cell_tabs
    w = disc.cell_w  # [n_q, ny, nx]
    gx = torch.einsum("qm,mcyx->qcyx", Dx, x_loc)
    gy = torch.einsum("qm,mcyx->qcyx", Dy, x_loc)
    y = torch.einsum("qm,qcyx->mcyx", Dx, nu * gx * w[:, None]) + torch.einsum(
        "qm,qcyx->mcyx", Dy, nu * gy * w[:, None]
    )
    if not stokes:
        v = torch.einsum("qm,mcyx->qcyx", P, x_loc)
        u, gu = linq.u, linq.gradu
        # (u_k . grad) dv + (dv . grad) u_k + dv / dt, per component c
        f_v = (
            u[:, 0:1] * gx
            + u[:, 1:2] * gy
            + v[:, 0:1] * gu[:, :, 0]
            + v[:, 1:2] * gu[:, :, 1]
            + inv_dt * v
        )
        y = y + torch.einsum("qm,qcyx->mcyx", P, f_v * w[:, None])
    return y


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device):
    if t.dtype != dtype or t.device != device:
        raise ValueError(
            f"cell_apply_F: {name} is {t.dtype} on {t.device}, "
            f"expected {dtype} on {device}"
        )
    if tuple(t.shape) != shape:
        raise ValueError(f"cell_apply_F: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"cell_apply_F: {name} must be contiguous")


def cell_apply_F(disc: Disc, nu, inv_dt, linq, x_loc, *, stokes: bool):
    """Fused per-cell compute of the velocity-block apply.

    Takes and returns the layout of the JAX ``cell_apply_F_pallas``:
    ``x_loc`` [n_v, 2, ny, nx] -> [n_v, 2, ny, nx].  A CUDA tensor goes
    through the hand-written kernel (and counts one in
    ``cell_apply_F.launches``); a CPU tensor through
    ``cell_apply_F_plain``.
    """
    n_q, n_v = disc.cell_tabs.shape[1:]
    ny, nx = disc.ny, disc.nx
    dtype, device = disc.dtype, disc.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"cell_apply_F: unsupported dtype {dtype}")
    if n_v != n_q or n_v not in (9, 16):
        raise ValueError(f"cell_apply_F: no kernel for n_v={n_v}, n_q={n_q}")
    _check("x_loc", x_loc, (n_v, 2, ny, nx), dtype, device)
    if not stokes:
        if linq is None:
            raise ValueError("cell_apply_F: the Newton regime needs linq")
        _check("linq.u", linq.u, (n_q, 2, ny, nx), dtype, device)
        _check("linq.gradu", linq.gradu, (n_q, 2, 2, ny, nx), dtype, device)
    if device.type == "cpu":
        return cell_apply_F_plain(disc, nu, inv_dt, linq, x_loc, stokes=stokes)
    if device.type != "cuda":
        raise ValueError(f"cell_apply_F: no kernel for device {device}")

    from navier_stokes_solver_tpu_torch import _ext

    lib = _ext.load()
    y = torch.empty_like(x_loc)
    # the Stokes variant never reads the state; any valid pointer will do
    uq, guq = (x_loc, x_loc) if stokes else (linq.u, linq.gradu)
    err = lib.nstt_cell_apply_f(
        1 if dtype == torch.float64 else 0,
        n_v,
        int(stokes),
        x_loc.data_ptr(),
        uq.data_ptr(),
        guq.data_ptr(),
        disc.cell_w.data_ptr(),
        disc.cell_tabs.data_ptr(),
        ctypes.c_double(float(nu)),
        ctypes.c_double(float(inv_dt)),
        y.data_ptr(),
        ny * nx,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cell_apply_F: kernel launch failed ({_ext.error_string(err)})")
    cell_apply_F.launches += 1
    return y


cell_apply_F.launches = 0
