"""Does the unsteady aSIMPLE tangent solve reach its Krylov cap at config 5's
width in the JAX package too, or only in the port?

One fused implicit-Euler step from rest (``timeloop.make_time_step``) at
BASELINE config 5's width (60x40 Q2/Q1, dt 0.01, tol 1e-9, newton_max 3),
one member (B = 1), FGMRES + aSIMPLE (the ensemble matrix's combination
(a)), the default precision (f32 preconditioner), the reference's
continuity sign, and a Krylov cap of ``--maxiter`` (2,000 by default: far
above config 5's 200, i.e. uncapped for this question), run on the CPU in
one package.  Prints one JSON line: the package, the step's Newton
iterations, its Krylov total and final residual, the drag and the wall.

    JAX_PLATFORMS=cpu python scripts/torch_asimple_cap.py --package jax
    python scripts/torch_asimple_cap.py --package torch

``--f64`` runs the preconditioner in f64, ``--consistent`` takes the
Jacobian-consistent sign, ``--re`` the Reynolds number (100, config 5's
top member, by default).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_jax(a):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from navier_stokes_solver_tpu.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu.ops import make_disc
    from navier_stokes_solver_tpu.precond import PrecondConfig, attach_mg
    from navier_stokes_solver_tpu.timeloop import initial_state, make_time_step

    disc = attach_mg(make_disc(make_fe_space(make_channel_geometry(*a.mesh), 2, 1)))
    cfg = PrecondConfig(vmult_dtype=None, mg_dtype=None) if a.f64 else None
    step = jax.jit(make_time_step(disc, solver_type=1, prec_type=2, tol=1e-9, newton_max=3,
                                  krylov_maxiter=a.maxiter, precond_cfg=cfg, consistent=a.consistent))
    t0 = time.perf_counter()
    ts = step(initial_state(disc), 1.0 / a.re, 0.01)
    st = ts.stats
    return dict(newton_iters=int(st.newton_iters), krylov_iters=int(st.krylov_iters),
                final_residual=float(st.final_residual), drag=float(ts.drag),
                wall_s=time.perf_counter() - t0)


def run_torch(a):
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig, attach_mg
    from navier_stokes_solver_tpu_torch.timeloop import initial_state, make_time_step

    disc = attach_mg(make_disc(make_fe_space(make_channel_geometry(*a.mesh), 2, 1), torch.float64, "cpu"))
    cfg = PrecondConfig(vmult_dtype=None, mg_dtype=None) if a.f64 else None
    step = make_time_step(disc, solver_type=1, prec_type=2, tol=1e-9, newton_max=3,
                          krylov_maxiter=a.maxiter, precond_cfg=cfg, consistent=a.consistent)
    t0 = time.perf_counter()
    ts = step(initial_state(disc), 1.0 / a.re, 0.01)
    st = ts.stats
    return dict(newton_iters=int(st.newton_iters), krylov_iters=int(st.krylov_iters),
                final_residual=float(st.final_residual), drag=float(ts.drag),
                wall_s=time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=("jax", "torch"), required=True)
    p.add_argument("--mesh", default="60,40")
    p.add_argument("--re", type=float, default=100.0)
    p.add_argument("--maxiter", type=int, default=2000)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--consistent", action="store_true")
    a = p.parse_args(argv)
    a.mesh = tuple(int(v) for v in a.mesh.split(","))
    out = (run_jax if a.package == "jax" else run_torch)(a)
    print(json.dumps(dict(package=a.package, mesh=a.mesh, re=a.re, maxiter=a.maxiter, f64=a.f64,
                          consistent=a.consistent, **out)))


if __name__ == "__main__":
    main()
