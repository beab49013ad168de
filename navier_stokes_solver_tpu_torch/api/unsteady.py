"""Time-dependent Navier-Stokes solver (NSSolver, reference parity).

Implicit-Euler time loop (NSSolver.cpp:799-837) with a Newton solve per step
(NSSolver.cpp:674-754), including the per-step Reynolds continuation ramp
1 -> target by +10 (a target of 100 stops at nu = 1/91) and the
``apply_first`` inlet-lifting flag: the inlet profile is lifted only on the
very first assembly of the run; afterwards the increment formulation keeps
the boundary updates at zero.
"""

from __future__ import annotations

import json
import os
import time as _time

from navier_stokes_solver_tpu_torch.api import kernels
from navier_stokes_solver_tpu_torch.api.base import NSSolverBase

__all__ = ["NSSolver"]


class NSSolver(NSSolverBase):
    VARIANT = "unsteady"
    KRYLOV_MAXITER = 100_000  # SolverControl (NSSolver.cpp:604)
    NEWTON_MAX_ITERS = 10  # NSSolver.cpp:678
    NEWTON_TOL = 1e-9  # NSSolver.cpp:679
    U_M = 0.3  # inlet amplitude (NSSolver.hpp:88)

    def __init__(self, options=None, **kwargs):
        super().__init__(options, **kwargs)
        self.apply_first = True  # NSSolver.hpp:387
        self.time = 0.0
        self.time_step_index = 0
        self.newton_residual = float("nan")  # ||r|| where the last Newton loop ended

    @property
    def inv_dt(self) -> float:
        return 1.0 / self.options.time_step

    def _inlet_amp(self, lifting: bool) -> float:
        return self.U_M if lifting else 0.0

    def _inlet_u_max(self) -> float:
        return self.U_M

    # ------------------------------------------------------------------
    def solve_newton(self, *, ramp: bool = True):
        """NSSolver::solve_newton (NSSolver.cpp:674-754).

        ``ramp=False`` skips the per-step Reynolds continuation and runs
        Newton once at the ramp's final level 1 + 10 floor((Re - 1) / 10),
        warm-started from the previous time step (``solve(direct=True)``).
        """
        self.log("===============================================")
        target_Re = self.Re
        first_iter = True
        self.log(f"Target Re = {target_Re}")

        if ramp:
            # IEEE-identical stepping to the reference loop
            # (NSSolver.cpp:684: current_Re = 1; current_Re <= Re; += 10)
            levels = []
            current_Re = 1.0
            while current_Re <= target_Re:
                levels.append(current_Re)
                current_Re += 10.0
        else:
            levels = [1.0 + 10.0 * ((target_Re - 1.0) // 10.0) if target_Re >= 1.0 else target_Re]
        for current_Re in levels:
            self.log("===============================================")
            self.nu = 1.0 / current_Re
            self.log(f"Solving for Re = {self.get_reynolds()}")

            n_iter = 0
            residual_norm = self.NEWTON_TOL + 1
            prev_residual = 0.0

            while n_iter < self.NEWTON_MAX_ITERS and residual_norm > self.NEWTON_TOL:
                if first_iter:
                    first_iter = False
                    stokes_now = n_iter == 0
                    # the inlet profile is lifted only while apply_first
                    # (first time step), NSSolver.cpp:573-580
                    residual_norm = self.assemble_system(
                        stokes_now, lifting=stokes_now and self.apply_first
                    )
                else:
                    stokes_now = False
                    residual_norm = self.assemble_system(False, lifting=False)

                prev_residual = residual_norm + 1 if n_iter == 0 else prev_residual
                self.log(
                    f"Newton iteration {n_iter}/{self.NEWTON_MAX_ITERS}"
                    f" - ||r|| = {residual_norm:.6e}"
                )

                if residual_norm > self.NEWTON_TOL:
                    t_solve = _time.perf_counter()
                    krylov_iter = self.solve_system(
                        stokes_now, lifting=stokes_now and self.apply_first
                    )
                    self.history.append(
                        dict(
                            phase="stokes" if stokes_now else "ns",
                            time=self.time,
                            nu=self.nu,
                            n_iter=n_iter,
                            residual=residual_norm,
                            krylov_iters=krylov_iter,
                            # beyond the JAX package's entry: the tangent
                            # solve's wall time
                            seconds=_time.perf_counter() - t_solve,
                        )
                    )
                    if krylov_iter == 0:
                        break

                    evaluation_point = self.solution
                    alpha = 1.0
                    while alpha > 1e-12:
                        self.solution = kernels.update_solution(
                            evaluation_point, self.delta, alpha
                        )
                        residual_norm = self.assemble_system(False, lifting=False)
                        self.log(f"  Evaluating alpha={alpha}, ||r||={residual_norm}")
                        # NSSolver.cpp:738 uses <= (the stationary solver: <)
                        if residual_norm <= prev_residual:
                            break
                        alpha *= 0.1
                    prev_residual = residual_norm
                else:
                    self.log(" < tolerance")
                    break
                n_iter += 1
            self.newton_residual = residual_norm

        self.log("===============================================")

    # ------------------------------------------------------------------
    def solve(self, *, direct: bool = False):
        """Implicit-Euler time loop (NSSolver.cpp:799-837).

        ``direct=True`` (an extension of the reference): each step runs one
        Newton solve at the ramp's final viscosity, warm-started from the
        previous step, instead of replaying the Re continuation.
        """
        self.log("===============================================")
        self.time = 0.0
        self.output(0)
        self.log("-----------------------------------------------")

        o = self.options
        T, delta_t = o.time_span, o.time_step
        self.time_step_index = 0
        while self.time < T - 0.5 * delta_t:
            t0 = _time.perf_counter()
            self.time += delta_t
            self.time_step_index += 1
            self.solution_old = self.solution
            self.log(f"n = {self.time_step_index:3d}, t = {self.time:5.2f}")
            self.solve_newton(ramp=not direct)
            self.apply_first = False
            self.output(self.time_step_index)
            self.compute_lift_drag()
            self.print_lift_coeff()
            self.print_drag_coeff()
            self.history.append(
                dict(
                    phase="step",
                    time=self.time,
                    step=self.time_step_index,
                    drag_force=self.drag_force,
                    lift_force=self.lift_force,
                    drag_coeff=self.drag_coeff,
                    lift_coeff=self.lift_coeff,
                    # beyond the JAX package's entry: the Newton residual
                    # the step ended with, and the step's wall time
                    newton_residual=self.newton_residual,
                    seconds=_time.perf_counter() - t0,
                )
            )
            self.log("")

    # ------------------------------------------------------------------
    def solve_fused(self, *, newton_max: int | None = None,
                    newton_tol: float | None = None,
                    krylov_maxiter: int = 2000,
                    chunk_steps: int | None = None,
                    checkpoint_dir: str | None = None,
                    max_steps_this_call: int | None = None):
        """The fused time loop (``timeloop``): every step one Newton solve at
        the ramp's final viscosity 1 + 10 floor((Re - 1) / 10), warm-started
        from the previous step, capped at ``newton_max`` iterations of one
        Krylov call of at most ``krylov_maxiter`` iterations each.  Returns
        the per-step history of ``run_time_loop``.

        ``checkpoint_dir``: write the ``TimeState`` and the per-step
        (drag, lift, Newton iterations, Krylov iterations) history after
        every ``chunk_steps`` steps (default 1 with a checkpoint and on the
        card), and resume from that checkpoint on entry if one exists --
        elastic restart of long runs; the JAX package's format, so either
        package resumes the other's.  ``max_steps_this_call``: stop, with a
        checkpoint written, after this many steps; callers detect a partial
        run by ``self.time_step_index < round(T / dt)``.

        Under dd every rank steps its tile (``make_time_step`` on the tile);
        the state's scalars are all-reduced, the same on every rank, and
        the checkpoint holds the tile-stacked slabs, written by rank 0 --
        it resumes only into the same tile grid.
        """
        from navier_stokes_solver_tpu_torch.io import load_time_state, save_time_state
        from navier_stokes_solver_tpu_torch.timeloop import (
            initial_state,
            make_time_step,
            run_time_loop,
        )

        if self.Re < 1.0:
            # the reference's ramp (current_Re = 1; current_Re <= target)
            # never solves for targets below 1 (NSSolver.cpp:684)
            raise ValueError(
                "solve_fused requires Re >= 1: the reference's per-step "
                "continuation never solves for targets below 1, so there "
                "is no host trajectory to reproduce"
            )
        o = self.options
        n_steps = int(round(o.time_span / o.time_step))
        step = make_time_step(
            self.disc,
            solver_type=o.solver_type,
            prec_type=o.preconditioner_type,
            tol=o.tolerance,
            newton_max=newton_max or self.NEWTON_MAX_ITERS,
            newton_tol=newton_tol or self.NEWTON_TOL,
            krylov_maxiter=krylov_maxiter,
            basis=max(1, int(o.krylov_basis)),
            precond_cfg=o.precond_config,
            consistent=o.consistent_continuity,
        )
        ts0 = initial_state(self.disc)._replace(solution=self.solution)

        # elastic resume: the TimeState and per-step history written by an
        # earlier (interrupted or step-budgeted) call
        start, prior = 0, []
        if checkpoint_dir is not None and os.path.exists(
            os.path.join(checkpoint_dir, "time_state.npz")
        ):
            ts0 = load_time_state(self.disc, checkpoint_dir, template=ts0)
            start = int(ts0.step)
            hist_path = os.path.join(checkpoint_dir, "history.json")
            if os.path.exists(hist_path):
                with open(hist_path) as f:
                    prior = json.load(f)
            if len(prior) != start:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} is inconsistent: "
                    f"TimeState.step={start} but history has {len(prior)} entries"
                )
            if start >= n_steps:
                raise ValueError(
                    f"checkpoint at {checkpoint_dir} already covers all {n_steps} steps"
                )
            self.log(f"  fused: resuming from checkpoint at step {start}/{n_steps}")
        # the reference's ramp current_Re = 1, 11, 21, ... ends at
        # 1 + 10 k (NSSolver.cpp:684-687): its final viscosity
        self.nu = 1.0 / (1.0 + 10.0 * ((self.Re - 1.0) // 10.0))
        if checkpoint_dir is not None or self.device.type != "cpu":
            chunk_steps = chunk_steps or 1

        todo = n_steps - start
        if max_steps_this_call is not None:
            todo = min(todo, max(1, int(max_steps_this_call)))

        acc = [list(h) for h in prior]
        on_chunk = None
        if checkpoint_dir is not None:

            def on_chunk(ts, out_host):
                d, l, ni, ki = out_host
                acc.extend([float(a), float(b), int(c), int(e)] for a, b, c, e in zip(d, l, ni, ki))
                save_time_state(ts, checkpoint_dir, disc=self.disc)  # a collective under dd
                if self.is_root:
                    tmp = os.path.join(checkpoint_dir, "history.json.tmp")
                    with open(tmp, "w") as f:
                        json.dump(acc, f)
                    os.replace(tmp, os.path.join(checkpoint_dir, "history.json"))
                if self.mesh is not None:  # no rank reads ahead of the history
                    self.mesh.barrier()

        final, hist = run_time_loop(
            step, ts0, self.nu, o.time_step, todo, chunk=chunk_steps,
            progress=lambda done, total, w: self.log(
                f"  fused: step {start + done}/{n_steps} retired ({w:.1f} s)"
            ),
            on_chunk=on_chunk,
        )

        self.solution = final.solution
        self.time = float(final.time)
        self.time_step_index = int(final.step)
        self.drag_force = float(final.drag)
        self.lift_force = float(final.lift)
        self.compute_drag_coeff()
        self.compute_lift_coeff()
        rows = [tuple(h) for h in prior] + list(
            zip(*(hist[k] for k in ("drag", "lift", "newton_iters", "krylov_iters")))
        )
        for i, (d, l, ni, ki) in enumerate(rows):
            entry = dict(
                phase="step",
                time=(i + 1) * o.time_step,
                step=i + 1,
                drag_force=float(d),
                lift_force=float(l),
                newton_iters=int(ni),
                krylov_iters=int(ki),
            )
            if i >= start:
                # beyond the JAX package's entry: the Newton residual the
                # step ended with, and the step's wall time
                entry.update(
                    newton_residual=float(hist["final_residual"][i - start]),
                    seconds=float(hist["seconds"][i - start]),
                )
            self.history.append(entry)
        if start + todo < n_steps:
            self.log(
                f"  fused: stopped after {start + todo}/{n_steps} steps "
                "(max_steps_this_call); resume from the checkpoint"
            )
        return hist
