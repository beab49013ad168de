"""Matrix-free cell-local operators on the structured Taylor-Hood grid.

The port of the JAX package's ``ops/matfree.py`` (single-device part), which
replaces the reference's assembled Jacobian / residual
(``NSSolver::assemble_system``, NSSolver.cpp:313-599) and Trilinos SpMV.
Each operator application is:

    strided gather (cell-local DoFs)
      -> einsum against reference-element tables
      -> pointwise physics at quadrature points
      -> einsum with test functions
      -> ordered strided scatter-add back to the node lattice

The velocity block ``apply_F`` runs all five steps, with the boundary
rows, as one kernel launch that reads the lattice in place
(``ops/apply_f_kernel.py``); the plain gather and scatter live in
``ops/lattice.py``.  The voxelized cylinder is
handled by masking inactive cells (``disc.cell_mask``); lattice nodes that
do not exist in the reference triangulation behave as identity rows.

Sign conventions follow the reference exactly, including the regime split:
Stokes / first-iteration regime (NSSolver.cpp:381-409) versus the Newton
regime (NSSolver.cpp:411-519), which adds linearized convection and the
implicit-Euler mass term and flips the continuity coupling sign.
Dirichlet rows follow ``MatrixTools::apply_boundary_values`` with
``eliminate_columns = false`` (NSSolver.cpp:596-597): constrained rows
become ``diag * x_i`` and the rhs entry ``diag * g_i``.

Member axis (an ensemble, ``ensemble/``).  Every operator also takes B
members at once: lattices [B, 2, NY, NX] and [B, NPy, NPx], quadrature
and cell-local tensors with the member axis after their leading q or
local-DoF axis ([n_q, B, ...]), and ``nu`` a [B] tensor.  The geometry,
masks and tables are shared; ``dirichlet_values`` and ``diag_Lp`` do not
depend on the member.  A member's arithmetic is the unbatched call's.

Domain decomposition (``dist/``).  On a tile (``Disc.decomposed``) every
scatter ends with the seam exchange (``ops.lattice._seam_sum``), inner
products weigh the seams (``make_dot``), only the rightmost tiles own the
outlet (``Disc.p_outlet``) and lift and drag are summed over the tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from navier_stokes_solver_tpu_torch.krylov.solvers import WeightedDot
from navier_stokes_solver_tpu_torch.ops.apply_f_kernel import apply_F_fused
from navier_stokes_solver_tpu_torch.ops.blocks import Blocks, is_batched, per_member
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.ops.lattice import (  # noqa: F401 (_gather, _scatter: tests)
    _gather,
    _gather_p,
    _gather_v,
    _scatter,
    _scatter_p,
    _scatter_v,
)

__all__ = [
    "LinearizationQ",
    "eval_state",
    "apply_F",
    "apply_B",
    "apply_Bt",
    "apply_Mp",
    "p_outlet_mask",
    "apply_Lp",
    "apply_Fp",
    "apply_Mp_raw",
    "apply_jacobian",
    "residual",
    "dirichlet_values",
    "diag_F",
    "diag_Mp",
    "diag_Lp",
    "lift_drag_forces",
    "make_apply_F",
    "make_apply_jacobian",
    "make_dot",
]

# the member axis of an ensemble's linearization: after the quadrature axis
LINQ_MEMBER_AXIS = 1


# ---------------------------------------------------------------------------
# Quadrature-point evaluation (deal.II FEValues::get_function_{values,gradients})
# ---------------------------------------------------------------------------


def _eval_v(disc: Disc, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Velocity values [n_q, (B,) 2, ny, nx] and physical gradients
    [n_q, (B,) 2(comp), 2(dim), ny, nx] at volume quadrature points (both
    contiguous: the fused cell kernel reads them directly)."""
    loc = _gather_v(disc, u)
    vals = torch.einsum("qm,m...->q...", disc.phi_v, loc).contiguous()
    gx = torch.einsum("qm,m...->q...", disc.dphi_v[:, :, 0], loc) / disc.hx
    gy = torch.einsum("qm,m...->q...", disc.dphi_v[:, :, 1], loc) / disc.hy
    return vals, torch.stack([gx, gy], dim=-3)


def _eval_p(disc: Disc, p: torch.Tensor) -> torch.Tensor:
    return torch.einsum("qn,n...->q...", disc.phi_p, _gather_p(disc, p))


class LinearizationQ(NamedTuple):
    """Current Newton state evaluated at quadrature points."""

    u: torch.Tensor  # [n_q, (B,) 2, ny, nx]
    gradu: torch.Tensor  # [n_q, (B,) 2, 2, ny, nx]
    p: torch.Tensor | None  # [n_q, (B,) ny, nx]


def eval_state(disc: Disc, st: Blocks) -> LinearizationQ:
    vals, grads = _eval_v(disc, st.u)
    return LinearizationQ(u=vals, gradu=grads, p=_eval_p(disc, st.p))


# ---------------------------------------------------------------------------
# Projection back onto test functions (the transpose of evaluation)
# ---------------------------------------------------------------------------


def _project_v(disc: Disc, f_val, f_grad) -> torch.Tensor:
    """R[m,c] = sum_q JxW (f_val[q,c] phi_m + f_grad[q,c,:] . grad phi_m),
    masked by active cells, scattered to the velocity lattice.

    Either of ``f_val`` [n_q,(B,)2,ny,nx] / ``f_grad`` [n_q,(B,)2,2,ny,nx]
    may be None.
    """
    w = disc.w_q
    mask = disc.cell_mask
    loc = None
    if f_val is not None:
        phi_w = disc.phi_v * w[:, None]
        loc = torch.einsum("qm,q...->m...", phi_w, f_val * mask)
    if f_grad is not None:
        dxw = disc.dphi_v[:, :, 0] * (w / disc.hx)[:, None]
        dyw = disc.dphi_v[:, :, 1] * (w / disc.hy)[:, None]
        g = f_grad * mask
        term = torch.einsum("qm,q...->m...", dxw, g[..., 0, :, :]) + torch.einsum(
            "qm,q...->m...", dyw, g[..., 1, :, :]
        )
        loc = term if loc is None else loc + term
    return _scatter_v(disc, loc)


def _project_p(disc: Disc, f_val: torch.Tensor) -> torch.Tensor:
    """R[n] = sum_q JxW f_val[q] psi_n, masked and scattered."""
    phi_w = disc.phi_p * disc.w_q[:, None]
    return _scatter_p(disc, torch.einsum("qn,q...->n...", phi_w, f_val * disc.cell_mask))


# ---------------------------------------------------------------------------
# Block operators
# ---------------------------------------------------------------------------


def _convection_linearized(linq: LinearizationQ, xv, xg) -> torch.Tensor:
    """Frechet derivative of the convective term at u_k (NSSolver.cpp:424-441):
    conv[c] = sum_l u_k[l] * dx[c,l] + xv[l] * gradu_k[c,l]."""
    return torch.einsum("q...lyx,q...clyx->q...cyx", linq.u, xg) + torch.einsum(
        "q...lyx,q...clyx->q...cyx", xv, linq.gradu
    )


def _apply_F_unfused(disc: Disc, nu, inv_dt, linq, x_u, *, stokes: bool):
    """The separate eval / physics / project pipeline of the JAX package's
    XLA path -- the reference the tests hold ``apply_F`` against."""
    xv, xg = _eval_v(disc, x_u)
    nu = per_member(nu, xg.dim(), 1)
    if stokes:
        return _project_v(disc, None, nu * xg)
    f_val = _convection_linearized(linq, xv, xg) + inv_dt * xv
    return _project_v(disc, f_val, nu * xg)


def apply_F(
    disc: Disc,
    nu: float,
    inv_dt: float,
    linq: LinearizationQ | None,
    x_u: torch.Tensor,
    *,
    stokes: bool,
    bc_diag: torch.Tensor | None = None,
) -> torch.Tensor:
    """Velocity-block (0,0) operator application.

    Stokes regime: nu * (grad du, grad v) (NSSolver.cpp:383-388).
    Newton regime: adds linearized convection + du . v / dt
    (NSSolver.cpp:424-453).  ``inv_dt = 0`` gives the stationary variant.

    On CUDA tensors, one kernel launch in both dtypes
    (``apply_F_fused``): it reads ``x_u``'s lattice in place, keeps the
    cell-local results on chip and applies the boundary rows as it writes.
    CPU tensors take its plain version.

    ``bc_diag``: if given, constrained rows are replaced by ``diag * x``
    (the post-``apply_boundary_values`` matrix, as used for preconditioner
    inner solves on the velocity block, NSSolver.cpp:609).
    """
    return apply_F_fused(disc, nu, inv_dt, linq, x_u, stokes=stokes, bc_diag=bc_diag)


def make_apply_F(disc: Disc, nu, inv_dt, linq, *, stokes: bool, bc_diag=None):
    """``x_u -> apply_F(...)`` of one linearization (the interface the
    simplex backend implements with element matrices assembled once)."""
    return lambda x_u: apply_F(disc, nu, inv_dt, linq, x_u, stokes=stokes, bc_diag=bc_diag)


def _eye2(disc: Disc) -> torch.Tensor:
    return torch.eye(2, dtype=disc.dtype, device=disc.device)[None, :, :, None, None]


def apply_Bt(
    disc: Disc, x_p: torch.Tensor, *, zero_dirichlet_rows: bool = False
) -> torch.Tensor:
    """Pressure-gradient coupling into velocity rows: -(div v, dp)
    (same sign in both regimes: NSSolver.cpp:391-393 and :456-458).

    ``zero_dirichlet_rows=True`` gives the post-BC block(0,1) whose
    constrained rows were eliminated (NSSolver.cpp:649).
    """
    pv = _eval_p(disc, x_p)
    y = _project_v(disc, None, -pv[..., None, None, :, :] * _eye2(disc))
    if zero_dirichlet_rows:
        y = torch.where(disc.u_dirichlet | ~disc.u_active, 0.0, y)
    return y


def apply_B(disc: Disc, x_u: torch.Tensor, *, stokes: bool) -> torch.Tensor:
    """Continuity coupling into pressure rows: -(div du, q) in the Stokes
    regime (NSSolver.cpp:401-403), +(div du, q) in the Newton regime
    (NSSolver.cpp:461-463)."""
    _, xg = _eval_v(disc, x_u)
    div = xg[..., 0, 0, :, :] + xg[..., 1, 1, :, :]
    return _project_p(disc, -div if stokes else div)


def apply_Mp(disc: Disc, nu, x_p: torch.Tensor) -> torch.Tensor:
    """Pressure mass matrix scaled by 1/nu (NSSolver.cpp:406-408), with
    identity on non-existent pressure lanes."""
    pv = _eval_p(disc, x_p)
    y = _project_p(disc, pv / per_member(nu, pv.dim(), 1))
    return torch.where(disc.p_active, y, x_p)


# ---------------------------------------------------------------------------
# Pressure-side operators of the Cahouet-Chabard and PCD Schur legs
# ---------------------------------------------------------------------------


def p_outlet_mask(disc: Disc) -> torch.Tensor:
    """Pressure-lattice nodes on the outlet boundary (id 8, x = 2.2)."""
    return disc.p_outlet


def _p_grads(disc: Disc, loc: torch.Tensor):
    """Physical pressure gradients [n_q, ny, nx] x 2 of gathered nodes."""
    gx = torch.einsum("qn,n...->q...", disc.dphi_p[:, :, 0], loc) / disc.hx
    gy = torch.einsum("qn,n...->q...", disc.dphi_p[:, :, 1], loc) / disc.hy
    return gx, gy


def _p_diffusion(disc: Disc, gx, gy) -> torch.Tensor:
    """Cell-local (grad p, grad psi_n) from gradients at quadrature points."""
    w = disc.w_q
    dxw = disc.dphi_p[:, :, 0] * (w / disc.hx)[:, None]
    dyw = disc.dphi_p[:, :, 1] * (w / disc.hy)[:, None]
    mask = disc.cell_mask
    return torch.einsum("qn,q...->n...", dxw, gx * mask) + torch.einsum(
        "qn,q...->n...", dyw, gy * mask
    )


def apply_Lp(disc: Disc, x_p: torch.Tensor) -> torch.Tensor:
    """Pressure Laplacian (grad psi_j, grad psi_i) on active cells.

    Not an operator of the reference: it is the second leg of the
    Cahouet-Chabard Schur approximation for the unsteady regime,
    S^-1 ~ nu Mp^-1 + (1/dt) Lp^-1 (Cahouet & Chabard, Int. J. Numer.
    Methods Fluids 8, 1988).  Natural (Neumann) conditions on the
    velocity-Dirichlet boundaries, identity rows on the outlet column where
    the velocity is free (which makes it nonsingular), identity rows on
    non-existent lattice nodes.  Constrained rows AND columns are
    eliminated, so the operator is exactly symmetric (it feeds CG and
    Chebyshev).
    """
    free = disc.p_free
    loc = _gather_p(disc, torch.where(free, x_p, 0.0))
    y = _scatter_p(disc, _p_diffusion(disc, *_p_grads(disc, loc)))
    return torch.where(free, y, x_p)


def apply_Fp(disc: Disc, nu, inv_dt, linq, x_p: torch.Tensor) -> torch.Tensor:
    """Pressure convection-diffusion operator (the PCD middle factor):

        Fp = inv_dt * Mp_raw + nu * Lp + N_p(u_k),

    N_p the convection (u_k . grad p, psi) from the Newton linearization at
    the volume quadrature points, with ``apply_Lp``'s symmetric outlet and
    inactive elimination.  ``Mp_raw`` is the unscaled pressure mass.  With
    ``linq=None`` and inv_dt = 0, Fp = nu Lp.  No reference analog (Elman,
    Silvester & Wathen, "Finite Elements and Fast Iterative Solvers",
    ch. 9).
    """
    free = disc.p_free
    loc = _gather_p(disc, torch.where(free, x_p, 0.0))
    pv = torch.einsum("qn,n...->q...", disc.phi_p, loc)
    gx, gy = _p_grads(disc, loc)
    diff = _p_diffusion(disc, gx, gy)
    out = per_member(nu, diff.dim(), 1) * diff
    # reaction + convection legs: (p/dt + u_k . grad p, psi)
    f_val = inv_dt * pv
    if linq is not None:
        f_val = f_val + linq.u[..., 0, :, :] * gx + linq.u[..., 1, :, :] * gy
    phi_w = disc.phi_p * disc.w_q[:, None]
    out = out + torch.einsum("qn,q...->n...", phi_w, f_val * disc.cell_mask)
    y = _scatter_p(disc, out)
    return torch.where(free, y, x_p)


def apply_Mp_raw(disc: Disc, x_p: torch.Tensor) -> torch.Tensor:
    """Unscaled pressure mass with the PCD elimination (identity on outlet
    and non-existent rows; ``apply_Mp`` keeps the reference's 1/nu scaling
    and eliminates nothing)."""
    free = disc.p_free
    y = _project_p(disc, _eval_p(disc, torch.where(free, x_p, 0.0)))
    return torch.where(free, y, x_p)


def apply_jacobian(
    disc: Disc,
    nu,
    inv_dt,
    linq: LinearizationQ | None,
    bc_diag: torch.Tensor,
    x: Blocks,
    *,
    stokes: bool,
) -> Blocks:
    """Full 2x2 block Jacobian application with Dirichlet row elimination.

    Matches the system solved by the reference's outer Krylov
    (NSSolver.cpp:601-672): rows at Dirichlet velocity DoFs are
    ``diag * x`` (columns NOT eliminated), non-existent lattice lanes are
    identity.  It evaluates and projects on its own (one gather of u for
    the F, B and Bt terms together), so it does not go through the fused
    cell kernel.
    """
    xv, xg = _eval_v(disc, x.u)
    pv = _eval_p(disc, x.p)
    f_grad = per_member(nu, xg.dim(), 1) * xg - pv[..., None, None, :, :] * _eye2(disc)
    if stokes:
        yu = _project_v(disc, None, f_grad)
    else:
        f_val = _convection_linearized(linq, xv, xg) + inv_dt * xv
        yu = _project_v(disc, f_val, f_grad)
    div = xg[..., 0, 0, :, :] + xg[..., 1, 1, :, :]
    yp = _project_p(disc, -div if stokes else div)

    yu = torch.where(disc.u_dirichlet, bc_diag * x.u, yu)
    yu = torch.where(disc.u_active, yu, x.u)
    yp = torch.where(disc.p_active, yp, x.p)
    return Blocks(u=yu, p=yp)


def make_apply_jacobian(disc: Disc, nu, inv_dt, linq, bc_diag, *, stokes: bool):
    """``x -> apply_jacobian(...)`` of one linearization."""
    return lambda x: apply_jacobian(disc, nu, inv_dt, linq, bc_diag, x, stokes=stokes)


def residual(
    disc: Disc,
    nu,
    inv_dt,
    st: Blocks,
    u_old: torch.Tensor,
    bc_diag: torch.Tensor,
    *,
    stokes: bool,
    inlet_amp: float,
    p_out: float = 1.0,
    consistent: bool = False,
) -> Blocks:
    """Assembled rhs = -R(u_k) after BC application.

    Newton regime terms (all negated, NSSolver.cpp:477-519): time term
    (u - u_old) . v / dt, viscous a(u_k, v), convective c(u_k; u_k, v),
    +b(v, p_k), +b(u_k, q); plus the outlet Neumann term (:528-551) and
    Dirichlet rows ``diag * g`` (:564-598).  Stokes regime: rhs = Neumann
    term only (the i-loop is skipped, NSSolver.cpp:472-475).  Both regimes
    add the body force's ``disc.forcing_rhs`` when there is one (it is
    state independent, so it broadcasts over an ensemble's members).

    ``inlet_amp``: amplitude of the inlet parabola lifted into the Dirichlet
    rows -- U_m on the very first assembly, 0 afterwards (increment
    formulation, NSSolver.cpp:573-580).

    ``consistent``: ``False`` keeps the reference's Newton-regime continuity
    rhs, +(q, div u_k) (NSSolver.cpp:517-519), whose sign disagrees with
    the Jacobian's +(q, div du) row (NSSolver.cpp:461-463); ``True``
    assembles the Jacobian-consistent -(q, div u_k).
    """
    if stokes:
        ru = p_out * disc.neumann_rhs1
        rp = disc.zeros_p()
        if disc.forcing_rhs is not None:
            ru = ru + disc.forcing_rhs
    else:
        linq = eval_state(disc, st)
        u_old_q, _ = _eval_v(disc, u_old)
        conv = torch.einsum("q...lyx,q...clyx->q...cyx", linq.u, linq.gradu)
        f_val = -inv_dt * (linq.u - u_old_q) - conv
        nu = per_member(nu, linq.gradu.dim(), 1)
        f_grad = -nu * linq.gradu + linq.p[..., None, None, :, :] * _eye2(disc)
        ru = _project_v(disc, f_val, f_grad) + p_out * disc.neumann_rhs1
        if disc.forcing_rhs is not None:
            ru = ru + disc.forcing_rhs
        div = linq.gradu[..., 0, 0, :, :] + linq.gradu[..., 1, 1, :, :]
        rp = _project_p(disc, -div if consistent else div)

    g = dirichlet_values(disc, inlet_amp)
    ru = torch.where(disc.u_dirichlet, bc_diag * g, ru)
    ru = torch.where(disc.u_active, ru, 0.0)
    rp = torch.where(disc.p_active, rp, 0.0)
    return Blocks(u=ru, p=rp)


def dirichlet_values(disc: Disc, inlet_amp: float) -> torch.Tensor:
    """Dirichlet boundary values g: inlet parabola (x-component) scaled by
    ``inlet_amp`` on id-7 nodes, zero on ids 6/10 (NSSolver.cpp:573-594)."""
    gx = torch.where(disc.u_inlet, inlet_amp * disc.inlet_profile1[:, None], 0.0)
    return torch.stack([gx, torch.zeros_like(gx)])


# ---------------------------------------------------------------------------
# Diagonals (for BC rows and the Jacobi smoother layer)
# ---------------------------------------------------------------------------


def diag_F(
    disc: Disc, nu, inv_dt, linq: LinearizationQ | None, *, stokes: bool
) -> torch.Tensor:
    """Diagonal of the velocity block, matrix-free.

    Per cell, per local dof (m, c) (derived from NSSolver.cpp:424-453):
      JxW * [ nu |grad phi_m|^2
              + (Newton) phi_m^2 / dt + phi_m (u_k . grad phi_m)
              + (Newton) phi_m^2 (grad u_k)_{cc} ].
    Non-existent lanes get 1.0 so the result is safely invertible.  With a
    [B] ``nu`` the result is [B, 2, NY, NX].
    """
    n_v = disc.phi_v.shape[1]
    w = disc.w_q
    phi = disc.phi_v
    dx = disc.dphi_v[:, :, 0] / disc.hx
    dy = disc.dphi_v[:, :, 1] / disc.hy

    # [(B,) n_v] -> local layout [n_v, (B,) 2, ny, nx]
    visc = torch.einsum("q,...qm->...m", w, per_member(nu, 3, 0) * (dx * dx + dy * dy))
    visc = visc.movedim(-1, 0)
    loc = visc.reshape(visc.shape + (1, 1, 1)).expand(visc.shape + (2, disc.ny, disc.nx))
    if not stokes:
        mass = torch.einsum("q,qm->m", w, phi * phi) * inv_dt
        loc = loc + mass.reshape((n_v,) + (1,) * (loc.dim() - 1))
        # field terms: phi (u_k . grad phi)  and  phi^2 (grad u_k)_{cc}
        conv1 = torch.einsum(
            "qm,q...->m...", w[:, None] * phi * dx, linq.u[..., 0, :, :]
        ) + torch.einsum("qm,q...->m...", w[:, None] * phi * dy, linq.u[..., 1, :, :])
        phi2w = w[:, None] * phi * phi
        conv2 = torch.stack(
            [
                torch.einsum("qm,q...->m...", phi2w, linq.gradu[..., 0, 0, :, :]),
                torch.einsum("qm,q...->m...", phi2w, linq.gradu[..., 1, 1, :, :]),
            ],
            dim=-3,
        )  # [n_v, (B,) 2, ny, nx]
        loc = loc + conv1[..., None, :, :] + conv2
    d = _scatter_v(disc, loc * disc.cell_mask)
    return torch.where(disc.u_active, d, 1.0)


def diag_Mp(disc: Disc, nu) -> torch.Tensor:
    """Diagonal of the (1/nu-scaled) pressure mass matrix ([B, NPy, NPx]
    with a [B] ``nu``)."""
    loc = torch.einsum("q,qn->n", disc.w_q, disc.phi_p * disc.phi_p)
    loc = (loc[:, None] if is_batched(nu) else loc) / nu  # [n_p, (B,)]
    d = _scatter_p(
        disc, loc[..., None, None].expand(loc.shape + (disc.ny, disc.nx)) * disc.cell_mask
    )
    return torch.where(disc.p_active, d, 1.0)


def diag_Lp(disc: Disc) -> torch.Tensor:
    """Diagonal of the pressure Laplacian; constrained and non-existent rows
    get 1.0."""
    n_p = disc.phi_p.shape[1]
    dx = disc.dphi_p[:, :, 0] / disc.hx
    dy = disc.dphi_p[:, :, 1] / disc.hy
    loc = torch.einsum("q,qn->n", disc.w_q, dx * dx + dy * dy)
    d = _scatter_p(
        disc, loc[:, None, None].expand(n_p, disc.ny, disc.nx) * disc.cell_mask
    )
    d = torch.where(disc.p_outlet, 1.0, d)
    return torch.where(disc.p_active, d, 1.0)


# ---------------------------------------------------------------------------
# Lift / drag face integral (NSSolver.cpp:839-938)
# ---------------------------------------------------------------------------


def lift_drag_forces(disc: Disc, nu, st: Blocks) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate the full stress over the cylinder boundary (id-10 faces).

    sigma = nu (grad u + grad u^T) - p I; per face quadrature point the force
    is -sigma . n * JxW with n the cell-outward normal (pointing into the
    cylinder), matching NSSolver.cpp:892-927.  Returns (drag, lift) =
    (F_x, F_y) as 0-dim tensors, or [B] tensors with the member axis.
    """
    t = disc.tables
    put = lambda a: torch.as_tensor(a, device=disc.device).to(disc.dtype)
    u_loc = _gather_v(disc, st.u)  # [n_v, (B,) 2, ny, nx]
    p_loc = _gather_p(disc, st.p)
    face_h = (disc.hy, disc.hy, disc.hx, disc.hx)
    drag = torch.zeros((), dtype=disc.dtype, device=disc.device)
    lift = torch.zeros((), dtype=disc.dtype, device=disc.device)
    # a sum over the cells of each member (all of one run's)
    cells = (lambda f: torch.sum(f)) if st.u.dim() == 3 else (lambda f: f.sum((-2, -1)))
    for f in range(4):
        mask = disc.cyl_face_mask[f]
        dphi = put(t.dphi_v_face[f])
        phip = put(t.phi_p_face[f])
        wf = put(t.w_qf) * face_h[f]
        n = put(t.normals[f])

        gx = torch.einsum("qm,m...->q...", dphi[:, :, 0], u_loc) / disc.hx
        gy = torch.einsum("qm,m...->q...", dphi[:, :, 1], u_loc) / disc.hy
        grad = torch.stack([gx, gy], dim=-3)  # [qf, (B,) c, d, ny, nx]
        pv = torch.einsum("qn,n...->q...", phip, p_loc)

        sig = per_member(nu, grad.dim(), 1) * (grad + grad.transpose(-4, -3))
        sig = sig - pv[..., None, None, :, :] * _eye2(disc)
        # force[c] = -sum_d sig[c,d] n[d] * JxW_f, masked to id-10 faces
        force = -torch.einsum("q...cdyx,d,q->...cyx", sig, n, wf)
        drag = drag + cells(force[..., 0, :, :] * mask)
        lift = lift + cells(force[..., 1, :, :] * mask)
    if disc.decomposed:
        # every cylinder face lies in one tile: the sum over the tiles
        # (Utilities::MPI::sum, NSSolver.cpp:933-934)
        drag, lift = disc.mesh.all_reduce(torch.stack([drag, lift])).unbind(0)
    return drag, lift


def make_dot(disc) -> WeightedDot | None:
    """The inner product of a tile's vectors: the seam nodes weighted 1/2
    per sharing tile (corners 1/4, exactly), the tile sums all-reduced (the
    Trilinos dot-product allreduce); None (the plain ``tvdot``) on any
    other disc (not decomposed, or not a lattice)."""
    if not isinstance(disc, Disc) or not disc.decomposed:
        return None
    if disc.mesh is None:
        raise ValueError("a tile built without a process mesh cannot reduce its products")
    wv, wp = disc.seam_weights(disc.deg_v), disc.seam_weights(disc.deg_p)
    return WeightedDot({wv.shape[-1]: wv, wp.shape[-1]: wp}, disc.mesh.all_reduce)
