"""User-facing solver API, mirroring the reference's lifecycle:
``NSSolverStationary(SolverOptions(...)).setup(); solve_newton();
compute_lift_drag(); print_drag_coeff()``, and the time-dependent
``NSSolver(...).setup(); solve()``."""

from navier_stokes_solver_tpu_torch.api.base import (
    SolverOptions,
    state_from_numpy,
    time_state_from_numpy,
)
from navier_stokes_solver_tpu_torch.api.stationary import NSSolverStationary
from navier_stokes_solver_tpu_torch.api.unsteady import NSSolver

__all__ = [
    "SolverOptions",
    "NSSolver",
    "NSSolverStationary",
    "state_from_numpy",
    "time_state_from_numpy",
]
