"""Matrix-free operators for the Navier-Stokes block system on torch tensors.

Cell-local dense operator application over the structured grid (strided
gathers, einsum contractions against the reference-element tables, ordered
strided scatter-adds) in place of the reference's assembled Trilinos
``BlockSparseMatrix`` + SpMV (NSSolver.cpp:275-300, :553-562).
"""

from navier_stokes_solver_tpu_torch.ops.blocks import Blocks, axpy, norm, vdot
from navier_stokes_solver_tpu_torch.ops.disc import Disc, disc_from_numpy, make_disc
from navier_stokes_solver_tpu_torch.ops.matfree import (
    LinearizationQ,
    apply_B,
    apply_Bt,
    apply_F,
    apply_jacobian,
    apply_Mp,
    diag_F,
    diag_Mp,
    dirichlet_values,
    eval_state,
    lift_drag_forces,
    residual,
)

__all__ = [
    "Blocks",
    "vdot",
    "norm",
    "axpy",
    "Disc",
    "make_disc",
    "disc_from_numpy",
    "LinearizationQ",
    "eval_state",
    "apply_F",
    "apply_B",
    "apply_Bt",
    "apply_Mp",
    "apply_jacobian",
    "residual",
    "dirichlet_values",
    "diag_F",
    "diag_Mp",
    "lift_drag_forces",
]
