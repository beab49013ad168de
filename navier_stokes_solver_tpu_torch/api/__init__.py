"""User-facing solver API, mirroring the reference's lifecycle:
``NSSolverStationary(SolverOptions(...)).setup(); solve_newton();
compute_lift_drag(); print_drag_coeff()``."""

from navier_stokes_solver_tpu_torch.api.base import SolverOptions, state_from_numpy
from navier_stokes_solver_tpu_torch.api.stationary import NSSolverStationary

__all__ = ["SolverOptions", "NSSolverStationary", "state_from_numpy"]
