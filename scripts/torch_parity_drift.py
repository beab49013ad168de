#!/usr/bin/env python3
"""How far the PyTorch port and the JAX package drift apart in a long
Krylov solve under an inexact block preconditioner, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_parity_drift.py [--mesh 16,8]

BASELINE config 1 cut to the mesh given: the first (Stokes-regime) tangent
solve of the stationary continuation, GMRES + blockDiagonal, all-f64
preconditioner, from the same assembled system in both packages.  For
each iteration cap it prints the iterations run, both residual norms and
the largest difference of the iterates relative to the JAX iterate's
largest entry; then the whole solve's count in each package (tol 1e-8).
The port imports no JAX; this script, like the parity tests, imports
both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="16,8")
    ap.add_argument("--caps", default="10,30,60,120,240")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.environ.setdefault("NSTPU_KRYLOV_CHUNK", "960")
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from navier_stokes_solver_tpu.api import NSSolverStationary as JSolver
    from navier_stokes_solver_tpu.api import SolverOptions as JOptions
    from navier_stokes_solver_tpu.api import kernels as jk
    from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
    from navier_stokes_solver_tpu_torch.api import NSSolverStationary, SolverOptions
    from navier_stokes_solver_tpu_torch.api import kernels as tk
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    mesh = tuple(int(v) for v in args.mesh.split(","))
    base = dict(mesh_size=mesh, Re=20.0, solver_type=0, preconditioner_type=0, tolerance=1e-8, verbose=False)
    f64 = dict(vmult_dtype=None, mg_dtype=None)
    j = JSolver(JOptions(precond_config=JCfg(**f64), **base)).setup()
    t = NSSolverStationary(SolverOptions(precond_config=PrecondConfig(**f64), device="cpu", **base)).setup()
    j.nu = t.nu = 0.1  # the continuation's first level, Re 10
    j.assemble_system(True, lifting=True)
    t.assemble_system(True, lifting=True)
    kw = dict(stokes=True, solver_type=0, prec_type=0, variant="stationary", basis=30)
    for n in (int(v) for v in args.caps.split(",")):
        jx, ji = jk.solve_kernel(j.disc, j.nu, 0.0, j.solution, j.rhs, j.delta, 0.1, 1e-8,
                                 maxiter=n, precond_cfg=j.options.precond_config, **kw)
        tx, ti = tk.solve_kernel(t.disc, t.nu, 0.0, t.solution, t.rhs, t.delta, 0.1, 1e-8,
                                 maxiter=n, precond_cfg=t.options.precond_config, **kw)
        ju = np.asarray(jx.u)
        print(json.dumps({
            "cap": n, "iterations": [int(ji.iters), ti.iters],
            "resnorm": [float(ji.resnorm), ti.resnorm],
            "iterate_rel_diff": float(np.abs(ju - tx.u.numpy()).max() / np.abs(ju).max()),
        }))
    whole = {"jax": j.solve_system(True, lifting=False), "torch": t.solve_system(True, lifting=False)}
    print(json.dumps({"whole_solve_iterations": whole}))


if __name__ == "__main__":
    main()
