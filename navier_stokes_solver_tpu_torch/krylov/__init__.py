"""Krylov solvers (GMRES / FGMRES with GMRES-IR cycles, CG) over tensors and
(u, p) block vectors, with the deal.II ``SolverControl`` semantics the
reference relies on (NSSolver.cpp:601-672)."""

from navier_stokes_solver_tpu_torch.krylov.solvers import (
    LowCycle,
    SolveInfo,
    cg,
    fgmres,
    gmres,
    tnorm,
    tvdot,
)

__all__ = ["gmres", "fgmres", "cg", "tvdot", "tnorm", "SolveInfo", "LowCycle"]
