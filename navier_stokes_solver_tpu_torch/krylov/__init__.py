"""Krylov solvers (GMRES / FGMRES with GMRES-IR cycles, BiCGStab, CG) over tensors and
(u, p) block vectors, with the deal.II ``SolverControl`` semantics the
reference relies on (NSSolver.cpp:601-672)."""

from navier_stokes_solver_tpu_torch.krylov.solvers import (
    LowCycle,
    SolveInfo,
    bicgstab,
    cg,
    fgmres,
    gmres,
    tnorm,
    tvdot,
)

__all__ = ["gmres", "fgmres", "bicgstab", "cg", "tvdot", "tnorm", "SolveInfo", "LowCycle"]
