"""PyTorch/CUDA port of the Navier-Stokes solver.

A second package beside the JAX reference ``navier_stokes_solver_tpu``: the
same matrix-free Q3/Q2 (or Q2/Q1) Taylor-Hood discretization of the
Schaefer-Turek channel (or the lid-driven cavity, with an optional body
force), stationary Newton continuation and the unsteady
implicit-Euler loop, GMRES / FGMRES (with GMRES-IR restart cycles) /
BiCGStab and the blockDiagonal, blockTriangular and aSIMPLE preconditioners
with a geometric-multigrid velocity leg, and the reference's two command-line
programs (``cli/``) -- written as plain functions on torch tensors.  The
velocity-block apply is one hand-written CUDA kernel per call
(``csrc/apply_f_fused.cu``, bound in ``ops/apply_f_kernel.py``); VTU output and
the gmsh reader have a native C++ path (``native/``, built with ``g++``).

Numeric settings, fixed at import (no device is chosen here: every object
that owns tensors takes an explicit ``device``):

  * tensors default to float64 -- the reference solves with absolute
    tolerances down to 1e-12;
  * float32 matrix products and convolutions run in full float32, never
    TF32: reduced-precision f32 contractions inflate the GMRES-IR and
    multigrid iteration counts (the JAX package pins the same on its
    device).

This package never imports ``jax``.
"""

import torch

torch.set_default_dtype(torch.float64)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
