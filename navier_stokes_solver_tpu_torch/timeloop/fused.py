"""The fused time loop: the JAX package's on-device step, as a host loop.

Numerics of the JAX package's ``timeloop/fused.py``, which differ from the
reference-faithful host path (``api.unsteady.NSSolver.solve``) by design:

  * no per-step Reynolds continuation ramp -- each step solves at the
    target viscosity directly, warm-started from the previous step
    (``make_stokes_init`` covers a cold start);
  * Newton with a backtracking line search (accept on ||r|| <= prev,
    NSSolver.cpp:727-742) and the Krylov stagnation break (iters == 0);
    one Krylov call of at most ``krylov_maxiter`` iterations per Newton
    iteration, from a zero start;
  * lift and drag (NSSolver.cpp:839-938) on the final state of every step.

The JAX package runs each step as ``lax.while_loop``s inside one
``lax.scan``; PyTorch is eager, so here each loop is a Python ``while``
that reads back one scalar per Newton iteration and per line-search trial.
The state's scalars stay 0-dim tensors on the disc's device, in the JAX
state's dtypes: ``step`` and the iteration counts int32, ``time``, ``drag``,
``lift`` and the residual in the disc's dtype.
"""

from __future__ import annotations

import time as _time
from typing import NamedTuple

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.api import kernels
from navier_stokes_solver_tpu_torch.ops import Blocks

__all__ = [
    "TimeState",
    "StepStats",
    "initial_state",
    "make_time_step",
    "make_stokes_init",
    "run_time_loop",
]


class StepStats(NamedTuple):
    newton_iters: torch.Tensor
    krylov_iters: torch.Tensor  # total across Newton iterations
    final_residual: torch.Tensor


class TimeState(NamedTuple):
    solution: Blocks
    time: torch.Tensor
    step: torch.Tensor
    drag: torch.Tensor
    lift: torch.Tensor
    stats: StepStats


def _int32(n: int, device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def initial_state(disc) -> TimeState:
    z = torch.zeros((), dtype=disc.dtype, device=disc.device)
    return TimeState(
        solution=Blocks(u=disc.zeros_u(), p=disc.zeros_p()),
        time=z,
        step=_int32(0, disc.device),
        drag=z,
        lift=z,
        stats=StepStats(
            newton_iters=_int32(0, disc.device),
            krylov_iters=_int32(0, disc.device),
            final_residual=z,
        ),
    )


def _solve_tangent(disc, nu, inv_dt, sol: Blocks, rhs: Blocks, delta0: Blocks, *, stokes,
                   solver_type, prec_type, tol, maxiter, basis=30, precond_cfg=None):
    """One Krylov call of at most ``maxiter`` iterations from ``delta0`` as
    given (no Dirichlet projection, no chunking), in the unsteady variant's
    tolerances."""
    return kernels.solve_kernel(
        disc, nu, inv_dt, sol, rhs, delta0, 0.0, tol, stokes=stokes,
        solver_type=solver_type, prec_type=prec_type, variant="unsteady",
        maxiter=maxiter, project_x0=False, precond_cfg=precond_cfg, basis=basis,
    )


def make_time_step(
    disc,
    *,
    solver_type: int = 1,
    prec_type: int = 1,
    tol: float = 1e-9,
    newton_max: int = 10,
    newton_tol: float = 1e-9,
    krylov_maxiter: int = 2000,
    inlet_amp: float = 0.3,
    basis: int = 30,
    precond_cfg=None,
    consistent: bool = False,
):
    """Build ``step(state, nu, dt) -> TimeState``.

    ``inlet_amp``: inlet amplitude U_m lifted into the Dirichlet rows on
    the first assembly of the run (step 0; ``apply_first``,
    NSSolver.cpp:573-580; U_m = 0.3 per NSSolver.hpp:88); afterwards the
    increment formulation keeps boundary updates at zero.

    ``consistent``: the Jacobian-consistent Newton continuity rhs
    (``ops.matfree.residual``)."""

    def assemble(sol: Blocks, u_old, nu, inv_dt, amp=0.0):
        return kernels.assemble_kernel(
            disc, nu, inv_dt, sol, u_old, amp, stokes=False, consistent=consistent
        )

    def step(ts: TimeState, nu, dt) -> TimeState:
        inv_dt = 1.0 / dt
        u_old = ts.solution.u
        amp0 = inlet_amp if int(ts.step) == 0 else 0.0
        sol = ts.solution
        rhs, rn = assemble(sol, u_old, nu, inv_dt, amp0)
        prev = rn + 1.0
        n_iter = kry = 0
        stall = False
        while n_iter < newton_max and bool(rn > newton_tol) and not stall:
            zero = Blocks(u=torch.zeros_like(sol.u), p=torch.zeros_like(sol.p))
            delta, info = _solve_tangent(
                disc, nu, inv_dt, sol, rhs, zero, stokes=False,
                solver_type=solver_type, prec_type=prec_type, tol=tol,
                maxiter=krylov_maxiter, basis=basis, precond_cfg=precond_cfg,
            )
            stall = info.iters == 0
            # backtracking line search (NSSolver.cpp:727-742); alpha in the
            # residual's dtype, as the JAX carry holds it.  Without an
            # accepted trial the last one stands.
            alpha = torch.ones((), dtype=rn.dtype)
            accepted = False
            while not accepted and bool(alpha > 1e-12):
                a = float(alpha)
                trial = Blocks(u=sol.u + a * delta.u, p=sol.p + a * delta.p)
                t_rhs, t_rn = assemble(trial, u_old, nu, inv_dt)
                accepted = bool(t_rn <= prev)
                alpha = alpha * 0.1
            sol, rhs, rn = trial, t_rhs, t_rn
            prev = rn
            n_iter += 1
            kry += info.iters

        drag, lift = kernels.lift_drag_kernel(disc, nu, sol)
        return TimeState(
            solution=sol,
            time=ts.time + dt,
            step=ts.step + 1,
            drag=drag,
            lift=lift,
            stats=StepStats(
                newton_iters=_int32(n_iter, disc.device),
                krylov_iters=_int32(kry, disc.device),
                final_residual=rn,
            ),
        )

    return step


def make_stokes_init(
    disc,
    *,
    solver_type: int = 1,
    prec_type: int = 1,
    tol: float = 1e-9,
    krylov_maxiter: int = 2000,
    inlet_amp: float = 0.3,
    basis: int = 30,
    precond_cfg=None,
):
    """Cold-start Stokes solve with the inlet profile lifted (the reference's
    first Newton iteration of the first time step, NSSolver.cpp:695-706):
    ``init(nu) -> Blocks``."""
    ops = kernels._ops_for(disc)

    def init(nu) -> Blocks:
        zero = Blocks(u=disc.zeros_u(), p=disc.zeros_p())
        rhs, _ = kernels.assemble_kernel(disc, nu, 0.0, zero, zero.u, inlet_amp, stokes=True)
        g = ops.dirichlet_values(disc, inlet_amp)
        x0 = Blocks(u=torch.where(disc.u_dirichlet, g, 0.0), p=disc.zeros_p())
        sol, _ = _solve_tangent(
            disc, nu, 0.0, zero, rhs, x0, stokes=True, solver_type=solver_type,
            prec_type=prec_type, tol=tol, maxiter=krylov_maxiter, basis=basis,
            precond_cfg=precond_cfg,
        )
        return sol

    return init


_OUTPUTS = ("drag", "lift", "newton_iters", "krylov_iters")


def run_time_loop(step_fn, ts0: TimeState, nu, dt, n_steps: int, *, chunk: int | None = None,
                  progress=None, on_chunk=None):
    """Run ``n_steps`` implicit-Euler steps; returns the final state and the
    per-step history as host arrays: ``drag``, ``lift`` (the disc's dtype),
    ``newton_iters``, ``krylov_iters`` (int32) -- the JAX package's four --
    and, beyond them, ``final_residual`` and ``seconds`` (each step's wall,
    its outputs read back).

    ``chunk``: steps between host hooks (None = all of them).  The chunk
    boundary only decides when the hooks run: chunked and unchunked runs
    are bitwise identical.

    ``progress``: optional ``fn(steps_done, n_steps, chunk_wall_s)`` after
    each chunk.

    ``on_chunk``: optional ``fn(ts, out_host)`` after each chunk, with the
    current ``TimeState`` and that chunk's host arrays ``(drag, lift,
    newton_iters, krylov_iters)`` -- the checkpoint hook for elastic
    restart of long runs."""
    ts = ts0
    rows = []  # per step: (drag, lift, newton_iters, krylov_iters, final_residual) host arrays
    seconds = []
    done = 0
    while done < n_steps:
        k = min(chunk or n_steps, n_steps - done)
        t_chunk = _time.perf_counter()
        for _ in range(k):
            t0 = _time.perf_counter()
            ts = step_fn(ts, nu, dt)
            st = ts.stats
            rows.append(tuple(
                t.cpu().numpy()
                for t in (ts.drag, ts.lift, st.newton_iters, st.krylov_iters, st.final_residual)
            ))
            seconds.append(_time.perf_counter() - t0)
        done += k
        if on_chunk is not None:
            on_chunk(ts, tuple(np.stack([r[i] for r in rows[-k:]]) for i in range(4)))
        if progress is not None:
            progress(done, n_steps, _time.perf_counter() - t_chunk)
    cols = [np.stack([r[i] for r in rows]) if rows else np.zeros((0,)) for i in range(5)]
    hist = dict(zip(_OUTPUTS + ("final_residual",), cols))
    hist["seconds"] = np.asarray(seconds)
    return ts, hist
