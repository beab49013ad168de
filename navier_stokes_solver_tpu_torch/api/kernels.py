"""The numerical steps below the solver classes' host control flow.

The reference's outer control flow (continuation, Newton, line search)
stays in the solver classes; these plain functions are the steps it calls:
residual assembly, one tangent solve, the solution update and the lift/drag
integral.
"""

from __future__ import annotations

import torch

from navier_stokes_solver_tpu_torch.krylov import fgmres, gmres
from navier_stokes_solver_tpu_torch.ops import Blocks, matfree, norm
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.precond import (
    LinearContext,
    make_krylov_lo,
    make_preconditioner,
)

__all__ = ["assemble_kernel", "solve_kernel", "update_solution", "lift_drag_kernel"]


def assemble_kernel(
    disc: Disc, nu, inv_dt, st: Blocks, u_old, inlet_amp, *, stokes, consistent=False
):
    """Residual assembly + norm (the reference's assemble_system + l2_norm,
    NSSolver.cpp:700-707).  Returns ``(rhs, ||rhs||)``, the norm a 0-dim
    tensor."""
    linq = None if stokes else matfree.eval_state(disc, st)
    dF = matfree.diag_F(disc, nu, inv_dt, linq, stokes=stokes)
    rhs = matfree.residual(
        disc, nu, inv_dt, st, u_old, dF, stokes=stokes, inlet_amp=inlet_amp,
        consistent=consistent,
    )
    return rhs, norm(rhs)


def solve_kernel(
    disc: Disc,
    nu,
    inv_dt,
    st: Blocks,
    rhs: Blocks,
    delta_prev: Blocks,
    inlet_amp,
    tol,
    *,
    stokes: bool,
    solver_type: int,
    prec_type: int,
    variant: str,
    maxiter: int,
    project_x0: bool = True,
    precond_cfg=None,
    basis: int = 30,
):
    """One tangent solve (NSSolver::solve_system, NSSolver.cpp:601-672).

    The Krylov initial guess mirrors deal.II's ``apply_boundary_values``
    side effect: constrained entries of the persistent ``delta_owned`` are
    set to the boundary values, interior entries warm-start from the
    previous solve.  ``project_x0=False`` skips that projection -- used by
    continuation chunks of one logical solve.
    """
    if solver_type not in (0, 1):
        raise NotImplementedError(
            "solver_type 2 (BiCGStab) is not ported yet (ROADMAP.md A.D2)"
        )
    linq = None if stokes else matfree.eval_state(disc, st)
    dF = matfree.diag_F(disc, nu, inv_dt, linq, stokes=stokes)
    ctx = LinearContext(
        disc=disc, nu=nu, inv_dt=inv_dt, stokes=stokes, linq=linq, diag_f=dF,
        state_u=None if stokes else st.u,
    )
    M = make_preconditioner(prec_type, ctx, variant=variant, cfg=precond_cfg)

    def A(x: Blocks) -> Blocks:
        return matfree.apply_jacobian(disc, nu, inv_dt, linq, dF, x, stokes=stokes)

    x0 = delta_prev
    if project_x0:
        g = matfree.dirichlet_values(disc, inlet_amp)
        x0u = torch.where(disc.u_dirichlet, g, delta_prev.u)
        x0 = Blocks(
            u=torch.where(disc.u_active, x0u, 0.0),
            p=torch.where(disc.p_active, delta_prev.p, 0.0),
        )
    lo = make_krylov_lo(prec_type, ctx, variant=variant, cfg=precond_cfg)
    solver = gmres if solver_type == 0 else fgmres
    return solver(A, rhs, x0, tol=tol, maxiter=maxiter, M=M, basis=basis, lo=lo)


def update_solution(evaluation_point: Blocks, delta: Blocks, alpha: float) -> Blocks:
    """solution = evaluation_point + alpha * delta (NSSolver.cpp:729-731)."""
    return Blocks(
        u=evaluation_point.u + alpha * delta.u,
        p=evaluation_point.p + alpha * delta.p,
    )


def lift_drag_kernel(disc: Disc, nu, st: Blocks):
    return matfree.lift_drag_forces(disc, nu, st)
