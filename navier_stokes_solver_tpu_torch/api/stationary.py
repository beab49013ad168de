"""Stationary Navier-Stokes solver (NSSolverStationary, reference parity).

Continuation structure replicated from NSSolverStationary.cpp:649-758:
Stokes-first solve with the inlet profile lifted once (u = 0.1), an inlet
"ramp" loop (0.1 -> 1.0 by +0.15; boundary values after the very first
assembly are zero in the increment formulation,
NSSolverStationary.cpp:546-556), and a Reynolds ramp 10 -> target by +20
(so a target of 100 stops at nu = 1/90).
"""

from __future__ import annotations

from navier_stokes_solver_tpu_torch.api import kernels
from navier_stokes_solver_tpu_torch.api.base import NSSolverBase

__all__ = ["NSSolverStationary", "InletVelocityRamp"]


class InletVelocityRamp:
    """NSSolverStationary.hpp:60-111, with identical IEEE float stepping."""

    def __init__(self):
        self.u = 0.1
        self.U_m = 1.0

    def get_velocity(self) -> float:
        return self.u

    def increment(self, re: float) -> bool:
        if self.u == self.U_m:
            return True
        self.u += 0.15
        if re == 0.0:  # dead branch kept for parity (hpp:101-102)
            self.u = 0.01
        if self.u > self.U_m:
            self.u = self.U_m
        return False


class NSSolverStationary(NSSolverBase):
    VARIANT = "stationary"
    KRYLOV_MAXITER = 20_000  # SolverControl (NSSolverStationary.cpp:580)
    NEWTON_MAX_ITERS = 15  # NSSolverStationary.cpp:653
    NEWTON_TOL = 1e-9  # NSSolverStationary.cpp:654

    def __init__(self, options=None, **kwargs):
        super().__init__(options, **kwargs)
        self.inlet_velocity = InletVelocityRamp()

    def _inlet_amp(self, lifting: bool) -> float:
        return self.inlet_velocity.get_velocity() if lifting else 0.0

    def _inlet_u_max(self) -> float:
        return self.inlet_velocity.get_velocity()

    # ------------------------------------------------------------------
    def solve_newton(self):
        """NSSolverStationary::solve_newton (NSSolverStationary.cpp:649-758)."""
        self.log("===============================================")
        target_Re = self.Re
        global_first_iter = True
        computing_stokes = True
        stokes_accepted = False  # skip_futile_stokes bookkeeping
        self.log(f"Target Re = {target_Re}")

        current_Re = 10.0
        while current_Re <= target_Re:
            self.log("===============================================")
            self.nu = 1.0 / current_Re
            inlet_reached = False
            self.log(f"Solving for nu = {self.nu}, Re = {self.get_reynolds()}")

            while not inlet_reached:
                self.log(
                    f"Solving for inlet velocity: {self.inlet_velocity.get_velocity()}"
                )
                if global_first_iter:
                    self.log("Solving Stokes adding BCs")
                elif computing_stokes:
                    self.log("Solving Stokes without adding BCs")
                else:
                    self.log("Solving NS")

                n_iter = 0
                residual_norm = self.NEWTON_TOL + 1
                prev_residual = 0.0

                while n_iter < self.NEWTON_MAX_ITERS and residual_norm > self.NEWTON_TOL:
                    if global_first_iter:
                        global_first_iter = False
                        residual_norm = self.assemble_system(True, lifting=True)
                        stokes_now = True
                    else:
                        stokes_now = computing_stokes
                        residual_norm = self.assemble_system(stokes_now, lifting=False)

                    prev_residual = residual_norm + 1 if n_iter == 0 else prev_residual
                    self.log(
                        f"Newton iteration {n_iter}/{self.NEWTON_MAX_ITERS}"
                        f" - ||r|| = {residual_norm:.6e}"
                    )

                    if (
                        stokes_now
                        and self.options.skip_futile_stokes
                        and (n_iter >= 1 or stokes_accepted)
                    ):
                        # The Stokes-regime rhs is state-independent, so once
                        # one Stokes solution has been accepted every further
                        # Stokes-regime solve at this nu is futile (rejected
                        # by the strict-< line search).
                        self.log("  [skip] repeated Stokes solve (state-"
                                 "independent rhs; update always rejected)")
                        self.history.append(
                            dict(phase="stokes_skipped", nu=self.nu, n_iter=n_iter)
                        )
                        break

                    if residual_norm > self.NEWTON_TOL:
                        krylov_iter = self.solve_system(stokes_now, lifting=False)
                        self.history.append(
                            dict(
                                phase="stokes" if stokes_now else "ns",
                                nu=self.nu,
                                n_iter=n_iter,
                                residual=residual_norm,
                                krylov_iters=krylov_iter,
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
                            residual_norm = self.assemble_system(
                                computing_stokes, lifting=False
                            )
                            self.log(f"  Evaluating alpha={alpha}, ||r||={residual_norm}")
                            # NSSolverStationary.cpp:733 uses strict <
                            if residual_norm < prev_residual:
                                break
                            alpha *= 0.1
                        prev_residual = residual_norm
                        if stokes_now:
                            stokes_accepted = True
                    else:
                        self.log(" < tolerance")
                        break
                    n_iter += 1

                inlet_reached = self.inlet_velocity.increment(self.get_reynolds())
                if inlet_reached:
                    computing_stokes = False
            current_Re += 20.0
        self.log("===============================================")
