"""The numerical steps below the solver classes' host control flow.

The reference's outer control flow (continuation, Newton, line search)
stays in the solver classes; these plain functions are the steps it calls:
residual assembly, one tangent solve, the solution update and the lift/drag
integral.  Each also takes an ensemble's B members at once: ``nu`` a [B]
tensor and state with a leading member axis (``ops.matfree``); norms and
Krylov counts are then per member.
"""

from __future__ import annotations

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.krylov import (
    bicgstab,
    bicgstab_batched,
    bnorm,
    fgmres,
    fgmres_batched,
    gmres,
    gmres_batched,
    norm_of,
)
from navier_stokes_solver_tpu_torch.ops import Blocks, matfree
from navier_stokes_solver_tpu_torch.ops.blocks import is_batched
from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.precond import (
    LinearContext,
    make_krylov_lo,
    make_preconditioner,
)
from navier_stokes_solver_tpu_torch.unstructured import ops as simplex_ops

__all__ = ["assemble_kernel", "solve_kernel", "update_solution", "lift_drag_kernel"]

_SOLVERS = {0: gmres, 1: fgmres, 2: bicgstab}
_SOLVERS_BATCHED = {0: gmres_batched, 1: fgmres_batched, 2: bicgstab_batched}


def _ops_for(disc):
    """Backend operators: the structured lattice (``ops.matfree``) or the
    simplex mesh (``unstructured.ops``)."""
    return matfree if isinstance(disc, Disc) else simplex_ops


def assemble_kernel(
    disc: Disc, nu, inv_dt, st: Blocks, u_old, inlet_amp, *, stokes, consistent=False
):
    """Residual assembly + norm (the reference's assemble_system + l2_norm,
    NSSolver.cpp:700-707).  Returns ``(rhs, ||rhs||)``, the norm a 0-dim
    tensor ([B] per-member norms for an ensemble's [B] ``nu``)."""
    ops = _ops_for(disc)
    linq = None if stokes else ops.eval_state(disc, st)
    dF = ops.diag_F(disc, nu, inv_dt, linq, stokes=stokes)
    rhs = ops.residual(
        disc, nu, inv_dt, st, u_old, dF, stokes=stokes, inlet_amp=inlet_amp,
        consistent=consistent,
    )
    if is_batched(nu):
        return rhs, bnorm(rhs)
    return rhs, norm_of(ops.make_dot(disc) if disc.decomposed else None)(rhs)


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
    active=None,
):
    """One tangent solve (NSSolver::solve_system, NSSolver.cpp:601-672).

    The Krylov initial guess mirrors deal.II's ``apply_boundary_values``
    side effect: constrained entries of the persistent ``delta_owned`` are
    set to the boundary values, interior entries warm-start from the
    previous solve.  ``project_x0=False`` skips that projection -- used by
    continuation chunks of one logical solve.  BiCGStab (``solver_type``
    2) takes no restart basis and no GMRES-IR cycles.

    With an ensemble's [B] ``nu`` the B members are solved together
    (``krylov.gmres_batched``/``fgmres_batched``/``bicgstab_batched``, the
    GMRES-IR cycles per member): ``active`` ([B] bool, host) selects the
    members that iterate -- the others keep ``delta_prev``, and the direct
    LU does not factor their matrices -- and ``SolveInfo``'s fields are [B]
    arrays.
    """
    batched = is_batched(nu)
    ops = _ops_for(disc)
    linq = None if stokes else ops.eval_state(disc, st)
    dF = ops.diag_F(disc, nu, inv_dt, linq, stokes=stokes)
    ctx = LinearContext(
        disc=disc, nu=nu, inv_dt=inv_dt, stokes=stokes, linq=linq, diag_f=dF,
        state_u=None if stokes else st.u, ops=ops,
        active=None if active is None or not batched else np.asarray(active, bool),
    )
    M = make_preconditioner(prec_type, ctx, variant=variant, cfg=precond_cfg)
    A = ctx.jacobian()

    x0 = delta_prev
    if project_x0:
        g = ops.dirichlet_values(disc, inlet_amp)
        x0 = Blocks(u=torch.where(disc.u_dirichlet, g, delta_prev.u), p=delta_prev.p)
        if isinstance(disc, Disc):  # zero on the lattice's non-existent nodes
            x0 = Blocks(
                u=torch.where(disc.u_active, x0.u, 0.0),
                p=torch.where(disc.p_active, x0.p, 0.0),
            )
    kw = {} if solver_type == 2 else dict(
        basis=basis, lo=make_krylov_lo(prec_type, ctx, variant=variant, cfg=precond_cfg)
    )
    if batched:
        return _SOLVERS_BATCHED[solver_type](
            A, rhs, x0, tol=tol, maxiter=maxiter, M=M, active=active, **kw
        )
    return _SOLVERS[solver_type](A, rhs, x0, tol=tol, maxiter=maxiter, M=M, dot=ctx.dot, **kw)


def update_solution(evaluation_point: Blocks, delta: Blocks, alpha: float) -> Blocks:
    """solution = evaluation_point + alpha * delta (NSSolver.cpp:729-731)."""
    return Blocks(
        u=evaluation_point.u + alpha * delta.u,
        p=evaluation_point.p + alpha * delta.p,
    )


def lift_drag_kernel(disc, nu, st: Blocks):
    return _ops_for(disc).lift_drag_forces(disc, nu, st)
