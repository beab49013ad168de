"""Cell-block additive Schwarz smoother for the velocity block.

The port of the JAX package's ``precond/schwarz.py``.  Point-Jacobi
smoothing is weak for high-order (Q3) elements: most of the spectrum lives
in intra-cell couplings the diagonal cannot see.  One block per cell: the
local 2 n_v x 2 n_v velocity matrix of every cell is built in batched
products, inverted in one batched ``torch.linalg.inv_ex`` (no error-check
synchronization), and applied as gather -> batched matvec ->
multiplicity-weighted ordered scatter (``ops/lattice.py``, the JAX
package's summation order).

Constrained lattice nodes (Dirichlet rows, nodes of the cylinder hole) are
decoupled in the local matrices (identity row and column) and smoothed
exactly by the global diagonal.
"""

from __future__ import annotations

import torch

from navier_stokes_solver_tpu_torch.ops.blocks import per_member
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, _scatter_v
from navier_stokes_solver_tpu_torch.ops.matfree import LinearizationQ

__all__ = ["make_schwarz_smoother"]


def _cell_major(disc: Disc, loc: torch.Tensor) -> torch.Tensor:
    """Cell-local velocity DoFs [n_v, (B,) 2, ny, nx] -> [(B,) ny, nx,
    2 n_v], index c * n_v + m (component-major)."""
    n = loc.dim()
    lead = tuple(range(1, n - 3))
    return loc.permute(lead + (n - 2, n - 1, n - 3, 0)).reshape(loc.shape[1 : n - 3] + (disc.ny, disc.nx, -1))


def _local_major(dv: torch.Tensor, n_v: int) -> torch.Tensor:
    """``_cell_major``'s inverse: [(B,) ny, nx, 2 n_v] -> [n_v, (B,) 2, ny, nx]."""
    d = dv.reshape(dv.shape[:-1] + (2, n_v))
    m = d.dim()
    return d.permute((m - 1,) + tuple(range(m - 4)) + (m - 2, m - 4, m - 3))


def _field_block(w, a, b, f) -> torch.Tensor:
    """sum_q w_q a[q, m] b[q, n] f[q, ...] -> [..., m, n], one matmul."""
    n_q, n_v = a.shape
    k = (w[:, None, None] * a[:, :, None] * b[:, None, :]).reshape(n_q, n_v * n_v)
    return (f.reshape(n_q, -1).T @ k).reshape(f.shape[1:] + (n_v, n_v))


def _cell_matrices(
    disc: Disc, nu, inv_dt, linq: LinearizationQ | None, *, stokes: bool
) -> torch.Tensor:
    """Batched local velocity-block matrices [(B,) ny, nx, 2 n_v, 2 n_v]
    (a leading member axis for an ensemble's [B] ``nu``).

    Row/column index = c * n_v + m (component-major), matching the weak
    form of ``apply_F``: viscous nu (grad phi_n, grad phi_m), implicit-Euler
    mass, and the linearized convection (NSSolver.cpp:424-453).
    """
    w = disc.w_q
    phi = disc.phi_v  # [q, m]
    dx = disc.dphi_v[:, :, 0] / disc.hx
    dy = disc.dphi_v[:, :, 1] / disc.hy
    n_v = phi.shape[1]
    ny, nx = disc.ny, disc.nx

    # cell-independent: viscous + mass  [m, n]
    visc = torch.einsum("q,qm,qn->mn", w, dx, dx) + torch.einsum("q,qm,qn->mn", w, dy, dy)
    base = per_member(nu, 3, 0) * visc  # [(B,) m, n]
    if not stokes:
        base = base + inv_dt * torch.einsum("q,qm,qn->mn", w, phi, phi)
    lead = base.shape[:-2]
    diag_blk = base[..., None, None, :, :].expand(lead + (ny, nx, n_v, n_v))

    if not stokes and linq is not None:
        # (u_k . grad phi_n) phi_m  -- component-diagonal
        u = lambda c: linq.u[..., c, :, :]
        conv1 = _field_block(w, phi, dx, u(0)) + _field_block(w, phi, dy, u(1))
        # phi_n (grad u_k)_{c,c'} phi_m  -- couples components
        g = lambda c, cp: _field_block(w, phi, phi, linq.gradu[..., c, cp, :, :])
        a00 = diag_blk + conv1 + g(0, 0)
        a01 = g(0, 1)
        a10 = g(1, 0)
        a11 = diag_blk + conv1 + g(1, 1)
    else:
        a00 = a11 = diag_blk
        a01 = a10 = torch.zeros_like(diag_blk)

    A = torch.cat([torch.cat([a00, a01], dim=-1), torch.cat([a10, a11], dim=-1)], dim=-2)

    # inactive cells -> identity (their nodes never receive corrections)
    eye = torch.eye(2 * n_v, dtype=disc.dtype, device=disc.device)
    A = torch.where(disc.cell_mask[:, :, None, None] > 0, A, eye)

    # constrained nodes: decouple (identity row/col) so local solves do not
    # push corrections through Dirichlet boundaries / the cylinder hole
    constrained = (disc.u_dirichlet | ~disc.u_active).to(disc.dtype)
    cmask = _cell_major(disc, _gather_v(disc, torch.stack([constrained, constrained])))
    keep = 1.0 - cmask
    A = A * keep[:, :, :, None] * keep[:, :, None, :]
    return A + torch.diag_embed(cmask)


def make_schwarz_smoother(
    disc: Disc,
    nu,
    inv_dt,
    linq: LinearizationQ | None,
    global_diag: torch.Tensor,
    *,
    stokes: bool,
):
    """Build ``prec(r) -> d``: one weighted additive-Schwarz sweep.

    ``global_diag``: assembled diagonal of the velocity block (used to
    smooth constrained rows exactly).  With an ensemble's [B] ``nu`` (and
    its linearization, diagonal and vectors [B, 2, NY, NX]) every member
    gets its own cell matrices, all B x ny x nx inverted in one call.
    """
    A = _cell_matrices(disc, nu, inv_dt, linq, stokes=stokes)
    # One cell's own contribution to a shared node's diagonal misses the
    # neighbour cells' parts, leaving interior local blocks singular (the
    # per-cell pure-Neumann stiffness annihilates constants).  Substitute
    # the globally assembled diagonal, which carries every contribution.
    gd = _cell_major(disc, _gather_v(disc, global_diag))
    eye = torch.eye(A.shape[-1], dtype=disc.dtype, device=disc.device)
    A = A * (1.0 - eye) + torch.diag_embed(gd)
    A_inv, _ = torch.linalg.inv_ex(A)  # batched; no error-check sync

    # node multiplicity (how many cells share each lattice node)
    n_v = A.shape[-1] // 2
    mult = _scatter_v(disc, torch.ones((n_v, 2, disc.ny, disc.nx), dtype=disc.dtype, device=disc.device))
    wmult = 1.0 / torch.clamp_min(mult, 1.0)

    constrained = disc.u_dirichlet | ~disc.u_active
    dinv = 1.0 / global_diag

    def prec(r):
        rv = _cell_major(disc, _gather_v(disc, r))
        dv = torch.matmul(A_inv, rv[..., None])[..., 0]
        d = _scatter_v(disc, _local_major(dv, n_v)) * wmult
        # constrained rows: exact (Jacobi) solve with the global diagonal
        return torch.where(constrained, dinv * r, d)

    return prec
