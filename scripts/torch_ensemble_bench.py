#!/usr/bin/env python
"""BASELINE config-5 measurement on the PyTorch/CUDA port: a batched
Reynolds-sweep ensemble.

The port's twin of ``scripts/ensemble_bench.py``: B unsteady fused runs,
one viscosity each (Re ``--re-min``..``--re-max``, ``linspace``), advanced
together by the port's batched step (``navier_stokes_solver_tpu_torch.
ensemble``), FGMRES + blockTriangular with the geometric-MG velocity leg and
the Cahouet-Chabard Schur leg (one Lp V-cycle), f32 preconditioner.  One
untimed warm-up step (it lifts the inlet and builds the kernels), then
``--steps`` timed steps: member-steps per second; with ``--control`` also
a B = 1 run at the middle viscosity (its own warm-up step, then the same
number of timed steps) for ``batch_efficiency_vs_single`` = t_1 B / t_B.

Usage:
  python scripts/torch_ensemble_bench.py [--mesh 60,40] [--batch 64]
      [--steps 5] [--tol 1e-9] [--control] [--device cuda|cpu]

Prints one JSON line (the keys of ``scripts/ensemble_bench.py``; on a CUDA
device ``extra.card`` holds nvidia-smi's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card(device) -> str | None:
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="60,40")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--newton-max", type=int, default=3)
    ap.add_argument("--krylov-maxiter", type=int, default=200)
    ap.add_argument("--re-min", type=float, default=20.0)
    ap.add_argument("--re-max", type=float, default=100.0)
    ap.add_argument("--schur", default="cahouet", choices=("mass", "cahouet", "pcd"),
                    help="Schur treatment of blockTriangular's pressure leg")
    ap.add_argument("--control", action="store_true",
                    help="also time a B=1 run for the batching-overhead ratio")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import initial_ensemble_state, make_ensemble_step
    from navier_stokes_solver_tpu_torch.ensemble.sweep import as_viscosities
    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig, attach_mg
    from navier_stokes_solver_tpu_torch.timeloop import initial_state, make_time_step

    device = torch.device("cpu" if args.cpu else args.device)
    mx, my = (int(v) for v in args.mesh.split(","))
    disc = attach_mg(make_disc(make_fe_space(make_channel_geometry(mx, my), 2, 1), torch.float64, device))
    n_dofs = 2 * int(np.prod(disc.NV)) + int(np.prod(disc.NP))
    kw = dict(
        solver_type=1, prec_type=1, tol=args.tol,
        newton_max=args.newton_max, krylov_maxiter=args.krylov_maxiter,
        precond_cfg=PrecondConfig(schur_mode=args.schur, cc_lp_cycles=1),
    )
    B = args.batch
    nus = as_viscosities(disc, 1.0 / np.linspace(args.re_min, args.re_max, B))
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    step = make_ensemble_step(disc, **kw)
    ts = initial_ensemble_state(disc, B)
    t0 = time.perf_counter()
    ts = step(ts, nus, args.dt)  # warm-up: the inlet lift, the kernel build
    sync()
    first_s = time.perf_counter() - t0

    per_step = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        ts = step(ts, nus, args.dt)
        sync()
        per_step.append(time.perf_counter() - t0)

    control_s = None
    if args.control:
        sstep = make_time_step(disc, **kw)
        nu1 = float(nus[B // 2])
        t1 = sstep(initial_state(disc), nu1, args.dt)  # warm-up
        walls = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            t1 = sstep(t1, nu1, args.dt)
            sync()
            walls.append(time.perf_counter() - t0)
        control_s = float(np.median(walls))

    med = float(np.median(per_step))
    out = {
        "metric": f"ensemble_sweep_{mx}x{my}_B{B}_tol{args.tol}_schur{args.schur}_torch_h100",
        "value": B / med,
        "unit": "member-steps/s",
        "extra": {
            "n_dofs_per_member": n_dofs,
            "batch": B,
            "steps_timed": args.steps,
            "per_step_s": per_step,
            "median_step_s": med,
            "compile_plus_first_step_s": first_s,
            "krylov_iters_last_step": int(ts.stats.krylov_iters.max()),
            "newton_iters_last_step": ts.stats.newton_iters.tolist(),
            "drag_finite": bool(torch.isfinite(ts.drag).all()),
            "dof_member_steps_per_s": n_dofs * B / med,
            "single_run_step_s": control_s,
            "batch_efficiency_vs_single": control_s * B / med if control_s else None,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
            "card": _card(device),
        },
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
