"""Block preconditioners for the Navier-Stokes saddle system: blockDiagonal,
blockTriangular and aSIMPLE in their stationary and unsteady variants,
with a geometric-multigrid velocity leg (GMRES, Chebyshev-Jacobi or
cell-block Schwarz smoothing; the reference's AMG equivalence layer) and a
mass, Cahouet-Chabard or PCD pressure leg, run in f32 inside the f64 outer
Krylov."""

from navier_stokes_solver_tpu_torch.precond.blocks import (
    LinearContext,
    PrecondConfig,
    make_krylov_lo,
    make_preconditioner,
)
from navier_stokes_solver_tpu_torch.precond.mg import attach_mg, make_lp_vcycle, make_mg_vcycle

__all__ = [
    "LinearContext",
    "PrecondConfig",
    "make_preconditioner",
    "make_krylov_lo",
    "attach_mg",
    "make_mg_vcycle",
    "make_lp_vcycle",
]
