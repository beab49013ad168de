"""Fused per-cell velocity-block apply: CUDA kernel wrappers and plain version.

Replaces the JAX package's Pallas TPU kernel
``navier_stokes_solver_tpu/ops/pallas_cell.py::_run`` (wrapper
``cell_apply_F_pallas``).  Per cell it evaluates the gradients (and, in
the Newton regime, the values) of the cell's velocity DoFs at the
quadrature points, applies the physics -- the flux ``nu grad x`` plus, in
the Newton regime, ``(u_k . grad) x + (x . grad) u_k + x / dt`` -- and
projects back onto the test functions weighted by JxW and the active-cell
mask.

Two entry points launch the same kernel (``csrc/cell_apply_f.cu``); the
solver's ``apply_F`` no longer does (``ops/apply_f_kernel.py`` runs the
same per-cell code, ``csrc/cell_apply_f.cuh``, with the scatter in one
launch), so only the card-side checks launch it, as the oracle that
kernel is held against:

* ``cell_apply_F_lattice`` takes the velocity lattice [2, NY, NX] and
  reads it in place through the strides of its cell-local view
  (``ops/lattice.py::lattice_view``): no gather copy;
* ``cell_apply_F`` takes gathered DoFs [n_v, 2, ny, nx], the layout of
  the JAX ``cell_apply_F_pallas``.

Both take an optional member axis (an ensemble, ``ensemble/``): lattices
[B, 2, NY, NX], gathered DoFs and results [n_v, B, 2, ny, nx], the
linearization [n_q, B, ...], and ``nu`` a [B] tensor on the card (read by
the kernel through a pointer: no host readback per launch).  One launch
serves the B members; member b's result is the unbatched launch's on its
operands, bit for bit.

A block owns a tile of consecutive cells of one cell row.  It stages the
tile's lattice strip and the tables in shared memory, then one thread per
(quadrature point, cell) forms the fluxes and one thread per (local DoF,
cell) projects them: n_q threads per cell instead of one, a few tens of
registers each.  Per call the kernel moves about 4.5 MB at 100x70 f32 in
the Newton regime (bound 1.4 us at 3.35 TB/s; ~46 MFLOP is 0.7 us at
67 TFLOP/s), so it is bound by memory; the sums keep the order of the
first, one-thread-per-cell version, so its f32 results are unchanged.
CPU tensors take the plain PyTorch version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from navier_stokes_solver_tpu_torch.ops.blocks import is_batched, per_member
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view

__all__ = [
    "cell_apply_F",
    "cell_apply_F_lattice",
    "cell_apply_F_plain",
    "cell_apply_F_lattice_plain",
    "is_dense",
    "check_operand",
]


def cell_apply_F_plain(disc: Disc, nu, inv_dt, linq, x_loc, *, stokes: bool):
    """The same function as the kernel, in plain PyTorch (einsum).

    ``x_loc``: gathered input DoFs [n_v, (B,) 2, ny, nx]; ``linq``: the
    LinearizationQ at quadrature points (ignored in the Stokes regime);
    ``nu`` a number or, with the member axis, a [B] tensor.  Returns the
    local test-function contributions [n_v, (B,) 2, ny, nx].
    """
    P, Dx, Dy = disc.cell_tabs
    # JxW [n_q, ny, nx], broadcast over the member and component axes
    w = disc.cell_w
    w = w.reshape(w.shape[:1] + (1,) * (x_loc.dim() - 3) + w.shape[1:])
    nu = per_member(nu, x_loc.dim(), 1)
    gx = torch.einsum("qm,m...->q...", Dx, x_loc)
    gy = torch.einsum("qm,m...->q...", Dy, x_loc)
    y = torch.einsum("qm,q...->m...", Dx, nu * gx * w) + torch.einsum(
        "qm,q...->m...", Dy, nu * gy * w
    )
    if not stokes:
        v = torch.einsum("qm,m...->q...", P, x_loc)
        u, gu = linq.u, linq.gradu
        # (u_k . grad) dv + (dv . grad) u_k + dv / dt, per component c
        f_v = (
            u[..., 0:1, :, :] * gx
            + u[..., 1:2, :, :] * gy
            + v[..., 0:1, :, :] * gu[..., 0, :, :]
            + v[..., 1:2, :, :] * gu[..., 1, :, :]
            + inv_dt * v
        )
        y = y + torch.einsum("qm,q...->m...", P, f_v * w)
    return y


def cell_apply_F_lattice_plain(disc: Disc, nu, inv_dt, linq, x_u, *, stokes: bool):
    """``cell_apply_F_lattice`` in plain PyTorch: gather, then the plain
    cell apply.  ``x_u``: velocity lattice [(B,) 2, NY, NX]."""
    return cell_apply_F_plain(disc, nu, inv_dt, linq, _gather_v(disc, x_u), stokes=stokes)


def is_dense(t: torch.Tensor) -> bool:
    """True when ``t`` covers its memory without gaps or overlaps: its
    strides are those of a contiguous tensor with the axes permuted, as
    every PyTorch operator's output has."""
    expect = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size == 1:
            continue
        if stride != expect:
            return False
        expect *= size
    return True


def check_operand(who: str, name: str, t: torch.Tensor, shape: tuple, dtype, device, *, dense=False):
    """Raise ``ValueError`` unless ``t`` has this dtype, device and shape
    and is contiguous (or, with ``dense``, dense: see ``is_dense``)."""
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{who}: {name} is {t.dtype} on {t.device}, expected {dtype} on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, expected {shape}")
    if dense and not is_dense(t):
        raise ValueError(
            f"{who}: {name} has strides {t.stride()}; the kernel takes a "
            "dense tensor (a contiguous one, or one with its axes permuted)"
        )
    if not dense and not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_common(disc: Disc, nu, linq, stokes: bool, lead: tuple):
    """Dtypes, variant, the linearization's shapes (``lead``: () or the
    member count (B,)) and a batched ``nu``'s."""
    n_q, n_v = disc.cell_tabs.shape[1:]
    dtype, device = disc.dtype, disc.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"cell_apply_F: unsupported dtype {dtype}")
    if n_v != n_q or n_v not in (9, 16):
        raise ValueError(f"cell_apply_F: no kernel for n_v={n_v}, n_q={n_q}")
    if not stokes:
        if linq is None:
            raise ValueError("cell_apply_F: the Newton regime needs linq")
        ny, nx = disc.ny, disc.nx
        check_operand("cell_apply_F", "linq.u", linq.u, (n_q, *lead, 2, ny, nx), dtype, device)
        check_operand("cell_apply_F", "linq.gradu", linq.gradu, (n_q, *lead, 2, 2, ny, nx), dtype, device)
    if is_batched(nu):
        check_operand("cell_apply_F", "nu", nu, lead, dtype, device)


def _launch(disc: Disc, nu, inv_dt, linq, view: torch.Tensor, *, lattice: bool, stokes: bool):
    """Launch the kernel on ``view``, the [k+1, k+1, (B,) 2, ny, nx]
    cell-local view of the input (the lattice's when ``lattice``), read
    through its strides."""
    device = disc.device
    if device.type != "cuda":
        raise ValueError(f"cell_apply_F: no kernel for device {device}")
    from navier_stokes_solver_tpu_torch import _ext

    lib = _ext.load()
    n_v = disc.cell_tabs.shape[2]
    ny, nx = disc.ny, disc.nx
    lead = tuple(view.shape[2:-3])  # (B,) with the member axis
    sa, sb, *s_m, sc, sy, sx = view.stride()
    y = torch.empty((n_v, *lead, 2, ny, nx), dtype=disc.dtype, device=device)
    uq, guq = (None, None) if stokes else (linq.u.data_ptr(), linq.gradu.data_ptr())
    # a batched nu is read on the card; a number is passed by value
    nu_b, nu_h = (nu.data_ptr(), 0.0) if is_batched(nu) else (None, float(nu))
    err = lib.nstt_cell_apply_f(
        1 if disc.dtype == torch.float64 else 0,
        disc.deg_v,
        int(stokes),
        view.data_ptr(),
        sa, sb, s_m[0] if s_m else 0, sc, sy, sx,
        int(lattice),
        uq,
        guq,
        disc.cell_w.data_ptr(),
        disc.cell_tabs.data_ptr(),
        ctypes.c_double(nu_h),
        nu_b,
        ctypes.c_double(float(inv_dt)),
        y.data_ptr(),
        nx,
        ny,
        lead[0] if lead else 1,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"cell_apply_F: kernel launch failed ({_ext.error_string(err)})")
    cell_apply_F.launches += 1
    cell_apply_F.launches_by_shape[(nx, ny, bool(stokes), str(disc.dtype)[6:]) + tuple(f"B{b}" for b in lead)] += 1
    return y


def cell_apply_F(disc: Disc, nu, inv_dt, linq, x_loc, *, stokes: bool):
    """Fused per-cell compute of the velocity-block apply on gathered DoFs.

    Takes and returns the layout of the JAX ``cell_apply_F_pallas``:
    ``x_loc`` [n_v, (B,) 2, ny, nx] (contiguous) -> the same shape.  A CUDA
    tensor goes through the hand-written kernel; a CPU tensor through
    ``cell_apply_F_plain``.  ``cell_apply_F.launches`` counts the kernel's
    launches through either entry point, ``cell_apply_F.launches_by_shape``
    the same by ``(nx, ny, stokes, dtype name)`` (and ``"B<members>"`` for
    a batched launch).
    """
    lead = tuple(x_loc.shape[1:-3])
    _check_common(disc, nu, linq, stokes, lead)
    k, ny, nx = disc.deg_v, disc.ny, disc.nx
    check_operand("cell_apply_F", "x_loc", x_loc, ((k + 1) ** 2, *lead, 2, ny, nx), disc.dtype, disc.device)
    if disc.device.type == "cpu":
        return cell_apply_F_plain(disc, nu, inv_dt, linq, x_loc, stokes=stokes)
    view = x_loc.view(k + 1, k + 1, *lead, 2, ny, nx)
    return _launch(disc, nu, inv_dt, linq, view, lattice=False, stokes=stokes)


def cell_apply_F_lattice(disc: Disc, nu, inv_dt, linq, x_u, *, stokes: bool):
    """The same apply on the velocity lattice ``x_u`` [(B,) 2, NY, NX], read
    in place: the gather is fused into the kernel.

    ``x_u`` must be dense (contiguous, or with its axes permuted, as the
    multigrid transfers' einsum outputs are): the kernel indexes in 32
    bits, which every offset into a dense lattice fits.  Its strides are
    passed to the kernel.  Returns [n_v, (B,) 2, ny, nx] contiguous.  A
    CPU tensor takes ``cell_apply_F_lattice_plain``.
    """
    lead = tuple(x_u.shape[:-3])
    _check_common(disc, nu, linq, stokes, lead)
    check_operand("cell_apply_F", "x_u", x_u, lead + (2,) + disc.NV, disc.dtype, disc.device, dense=True)
    if disc.device.type == "cpu":
        return cell_apply_F_lattice_plain(disc, nu, inv_dt, linq, x_u, stokes=stokes)
    view = lattice_view(x_u, disc.deg_v, disc.ny, disc.nx)
    return _launch(disc, nu, inv_dt, linq, view, lattice=True, stokes=stokes)


cell_apply_F.launches = 0
cell_apply_F.launches_by_shape = collections.Counter()
