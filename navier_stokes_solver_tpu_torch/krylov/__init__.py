"""Krylov solvers (GMRES / FGMRES with GMRES-IR cycles, BiCGStab, CG) over tensors and
(u, p) block vectors, with the deal.II ``SolverControl`` semantics the
reference relies on (NSSolver.cpp:601-672); batched (F)GMRES, BiCGStab and CG advance
an ensemble's members together (``krylov/batched.py``)."""

from navier_stokes_solver_tpu_torch.krylov.solvers import (
    LowCycle,
    SolveInfo,
    bicgstab,
    cg,
    fgmres,
    gmres,
    norm_of,
    tnorm,
    tvdot,
)
from navier_stokes_solver_tpu_torch.krylov.batched import (
    bicgstab_batched,
    bnorm,
    bvdot,
    cg_batched,
    fgmres_batched,
    gmres_batched,
)

__all__ = [
    "gmres", "fgmres", "bicgstab", "cg", "tvdot", "tnorm", "norm_of", "SolveInfo", "LowCycle",
    "gmres_batched", "fgmres_batched", "bicgstab_batched", "cg_batched", "bvdot", "bnorm",
]
