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

``make_batched_time_step`` is the same step for an ensemble's B members
(``ensemble/``; the JAX package's ``vmap`` of the step): every leaf gains a
leading member axis and each loop level keeps a per-member active mask.
"""

from __future__ import annotations

import time as _time
from typing import NamedTuple

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.api import kernels
from navier_stokes_solver_tpu_torch.ops import Blocks
from navier_stokes_solver_tpu_torch.ops.blocks import per_member
from navier_stokes_solver_tpu_torch.precond.blocks import PrecondConfig

__all__ = [
    "TimeState",
    "StepStats",
    "initial_state",
    "make_time_step",
    "make_batched_time_step",
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


def initial_state(disc, batch: int | None = None) -> TimeState:
    """The zero state at step 0 on either backend; with ``batch``, every
    leaf broadcast over a leading axis of B members (contiguous, as the
    kernels read it)."""
    z = torch.zeros((), dtype=disc.dtype, device=disc.device)
    ts = TimeState(
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
    if batch is None:
        return ts
    return _map_state(lambda t: t.expand((batch,) + t.shape).contiguous(), ts)


def _map_state(fn, ts: TimeState) -> TimeState:
    return TimeState(
        solution=Blocks(*map(fn, ts.solution)),
        time=fn(ts.time),
        step=fn(ts.step),
        drag=fn(ts.drag),
        lift=fn(ts.lift),
        stats=StepStats(*map(fn, ts.stats)),
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
    return _make_step(
        disc, False, solver_type=solver_type, prec_type=prec_type, tol=tol, newton_max=newton_max,
        newton_tol=newton_tol, krylov_maxiter=krylov_maxiter, inlet_amp=inlet_amp, basis=basis,
        precond_cfg=precond_cfg, consistent=consistent,
    )


def make_batched_time_step(
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
    """Build ``step(state, nus, dt) -> TimeState`` for B members at once:
    ``make_time_step``'s step with a leading member axis on every leaf of
    the state and ``nus`` a [B] tensor in the disc's dtype on its device.

    The JAX package runs it as ``vmap`` over the step, whose loops then run
    while any member's condition holds, each member keeping its carry once
    its own condition is false.  Here each loop level has a per-member
    active mask, read back once per iteration as one [B] row: Newton
    (``n_iter < newton_max``, ``rn > newton_tol``, no stagnation), the line
    search (per-member ``alpha`` and acceptance, the last trial standing
    where nothing was accepted), and the Krylov solves below them
    (``api.kernels.solve_kernel``'s ``active``).  A member whose Newton
    loop has ended is selected out with ``torch.where``: its state is
    unchanged by the later iterations.  So each member's counts are its
    standalone step's, and its fields differ from that step's by the
    rounding of the batched products only.

    The inlet lift applies at step 0, which all members share.  Every
    solver and preconditioner (the direct LU too), the GMRES-IR cycles and
    either backend (the structured lattice or the ``-M`` simplex disc)
    batch."""
    return _make_step(
        disc, True, solver_type=solver_type, prec_type=prec_type, tol=tol, newton_max=newton_max,
        newton_tol=newton_tol, krylov_maxiter=krylov_maxiter, inlet_amp=inlet_amp, basis=basis,
        precond_cfg=precond_cfg, consistent=consistent,
    )


def _pick(mask: np.ndarray, a, b):
    """``a`` where the host mask is true, else ``b``, per member (the mask
    [B] against the leading axis of tensors [B, ...], or 0-dim against
    0-dim ones): no operation where the mask is uniform."""
    if mask.all():
        return a
    if not mask.any():
        return b
    m = torch.as_tensor(mask, device=a.device)
    return torch.where(m.reshape(m.shape + (1,) * (a.dim() - m.dim())), a, b)


def _make_step(disc, batched: bool, *, solver_type, prec_type, tol, newton_max, newton_tol,
               krylov_maxiter, inlet_amp, basis, precond_cfg, consistent):
    """The step of ``make_time_step`` (``batched`` False: 0-dim scalars) and
    of ``make_batched_time_step`` (a leading member axis): one Newton and
    line-search policy, run on host copies of the residual norms with
    per-member masks -- 0-dim for one member, where every select is
    uniform and costs nothing.  ``precond_cfg`` is checked here, once (what
    is not ported raises before the first step)."""
    (precond_cfg or PrecondConfig()).check()

    def assemble(sol: Blocks, u_old, nu, inv_dt, amp=0.0):
        return kernels.assemble_kernel(
            disc, nu, inv_dt, sol, u_old, amp, stokes=False, consistent=consistent
        )

    def pick(mask, a: Blocks, b: Blocks) -> Blocks:
        return Blocks(*(_pick(mask, x, y) for x, y in zip(a, b)))

    def step(ts: TimeState, nu, dt) -> TimeState:
        inv_dt = 1.0 / dt
        u_old = ts.solution.u
        first = ts.step.cpu().numpy() == 0
        if first.any() and not first.all():
            raise ValueError("the members of an ensemble step together: mixed step counters")
        sol = ts.solution
        rhs, rn = assemble(sol, u_old, nu, inv_dt, inlet_amp if first.all() else 0.0)
        rn_h = rn.cpu()  # host copies in the residual's dtype, as the JAX carry's
        prev = rn_h + 1.0
        n_iter = np.zeros(rn_h.shape, np.int64)
        kry = np.zeros(rn_h.shape, np.int64)
        stall = np.zeros(rn_h.shape, bool)
        while True:
            act = (n_iter < newton_max) & (rn_h > newton_tol).numpy() & ~stall
            if not act.any():
                break
            zero = Blocks(u=torch.zeros_like(sol.u), p=torch.zeros_like(sol.p))
            delta, info = kernels.solve_kernel(
                disc, nu, inv_dt, sol, rhs, zero, 0.0, tol, stokes=False,
                solver_type=solver_type, prec_type=prec_type, variant="unsteady",
                maxiter=krylov_maxiter, project_x0=False, precond_cfg=precond_cfg,
                basis=basis, active=act if batched else None,
            )
            stall = np.where(act, np.asarray(info.iters) == 0, stall)
            # backtracking line search (NSSolver.cpp:727-742); alpha in the
            # residual's dtype, as the JAX carry holds it.  Without an
            # accepted trial the last one stands.
            alpha = torch.ones(rn_h.shape, dtype=rn_h.dtype)
            accepted = np.zeros(rn_h.shape, bool)
            t_sol, t_rhs, t_rn, t_rn_h = sol, rhs, rn, rn_h
            while True:
                ls = act & ~accepted & (alpha > 1e-12).numpy()
                if not ls.any():
                    break
                if batched:
                    a = alpha.to(device=disc.device, dtype=sol.u.dtype)
                    trial = Blocks(u=sol.u + per_member(a, delta.u.dim(), 0) * delta.u,
                                   p=sol.p + per_member(a, delta.p.dim(), 0) * delta.p)
                else:
                    a = float(alpha)
                    trial = Blocks(u=sol.u + a * delta.u, p=sol.p + a * delta.p)
                r_rhs, r_rn = assemble(trial, u_old, nu, inv_dt)
                r_rn_h = r_rn.cpu()
                t_sol, t_rhs, t_rn = pick(ls, trial, t_sol), pick(ls, r_rhs, t_rhs), _pick(ls, r_rn, t_rn)
                t_rn_h = _pick(ls, r_rn_h, t_rn_h)
                accepted = accepted | (ls & (r_rn_h <= prev).numpy())
                alpha = _pick(ls, alpha * 0.1, alpha)
            sol, rhs, rn = pick(act, t_sol, sol), pick(act, t_rhs, rhs), _pick(act, t_rn, rn)
            rn_h = _pick(act, t_rn_h, rn_h)
            prev = _pick(act, rn_h, prev)
            n_iter = n_iter + act
            kry = kry + np.where(act, info.iters, 0)

        drag, lift = kernels.lift_drag_kernel(disc, nu, sol)
        count = lambda c: torch.as_tensor(c.astype(np.int32), device=disc.device)
        return TimeState(
            solution=sol,
            time=ts.time + dt,
            step=ts.step + 1,
            drag=drag,
            lift=lift,
            stats=StepStats(newton_iters=count(n_iter), krylov_iters=count(kry), final_residual=rn),
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
