#!/usr/bin/env python
"""BASELINE config-3 lift/drag trajectory through the PyTorch port.

The port's twin of ``scripts/config3_liftdrag.py``, with the same flags,
except that ``--device`` (default ``cuda``) replaces ``--cpu``: the per-step
lift/drag coefficient history of the ``-M`` simplex backend written as the
reference's ``{drag,lift}_coefficient_<Re>.txt`` files (NSSolver.cpp:
976-1018) to ``--outdir``, and one JSON line of per-step walls and counts.

Default drive: the fused time loop (``NSSolver.solve_fused``) at the SLURM
benchmark shape (run_sim_unsteady.sh:21: -m 60,40 -s 1 -p 1 -t 1e-9);
``--host`` switches to the host loop with the per-step Re continuation.
``--ckpt DIR`` resumes automatically from the checkpoint in DIR (the JAX
package's format, so either package's); ``--segment-steps N`` stops after
N steps of this process with the checkpoint written and exit code 3 --
relaunch to continue.  Each step's wall, Newton and Krylov counts and final
Newton residual accumulate across segments in ``DIR/steps_torch.json``.

Usage:
  python scripts/torch_config3_liftdrag.py -T 8,0.01 --direct-lu --consistent \\
      --outdir lift_drag_out --ckpt lift_drag_out/ckpt --segment-steps 200
  python scripts/torch_config3_liftdrag.py --mesh 16,8 -T 0.02,0.01 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS_FILE = "steps_torch.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="60,40")
    ap.add_argument("--mesh-file", default=None,
                    help="gmsh .msh file; overrides --mesh's internal triangulation")
    ap.add_argument("--re", type=float, default=1.0)
    ap.add_argument("-T", "--time", default="0.31,0.01")
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--solver", type=int, default=1)
    ap.add_argument("--prec", type=int, default=1)
    ap.add_argument("--host", action="store_true",
                    help="the host loop solve() (per-step Re ramp) instead of the fused loop")
    ap.add_argument("--chunk-steps", type=int, default=1,
                    help="fused: steps between checkpoints")
    ap.add_argument("--krylov-maxiter", type=int, default=2000,
                    help="fused: Krylov cap of one tangent solve")
    ap.add_argument("--newton-max", type=int, default=None)
    ap.add_argument("--outdir", default="lift_drag_out")
    ap.add_argument("--ckpt", default=None,
                    help="fused: checkpoint dir; resumes automatically if a checkpoint exists")
    ap.add_argument("--segment-steps", type=int, default=None,
                    help="fused: stop (exit code 3, checkpoint written) after this many steps")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    ap.add_argument("--schur", choices=("mass", "cahouet", "pcd"), default="mass",
                    help="Schur treatment (PrecondConfig.schur_mode)")
    ap.add_argument("--lp-cycles", type=int, default=None,
                    help="PrecondConfig.cc_lp_cycles")
    ap.add_argument("--direct-lu", action="store_true",
                    help="PrecondConfig.direct_lu: dense f32 LU of the saddle Jacobian")
    ap.add_argument("--consistent", action="store_true",
                    help="the Jacobian-consistent Newton continuity rhs")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    mx, my = (int(v) for v in args.mesh.split(","))
    span, dt = (float(v) for v in args.time.split(","))
    precond_cfg = None
    if args.schur != "mass" or args.lp_cycles is not None or args.direct_lu:
        precond_cfg = PrecondConfig(schur_mode=args.schur, direct_lu=args.direct_lu,
                                    cc_lp_cycles=args.lp_cycles)
    s = NSSolver(SolverOptions(
        mesh_size=(mx, my), read_mesh_from_file=True, mesh_file_name=args.mesh_file or "",
        Re=args.re, solver_type=args.solver, tolerance=args.tol,
        preconditioner_type=args.prec, time_span=span, time_step=dt,
        verbose=bool(os.environ.get("NSTPU_CONFIG3_VERBOSE")), output_dir=args.outdir,
        consistent_continuity=args.consistent, precond_config=precond_cfg, device=args.device,
    ))
    s.setup()
    os.makedirs(args.outdir, exist_ok=True)

    n_steps = int(round(span / dt))
    t0 = time.perf_counter()
    if args.host:
        s.solve()
    else:
        s.solve_fused(chunk_steps=args.chunk_steps, krylov_maxiter=args.krylov_maxiter,
                      newton_max=args.newton_max, checkpoint_dir=args.ckpt,
                      max_steps_this_call=args.segment_steps)
    wall = time.perf_counter() - t0
    steps = [h for h in s.history if h.get("phase") == "step"]
    # [step, wall s, Newton iterations, Krylov iterations, final Newton
    # residual] of each step this process ran, after those of earlier segments
    record = {"segment_walls_s": [], "steps": []}
    path = os.path.join(args.ckpt, STEPS_FILE) if args.ckpt else None
    if path and os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
    record["segment_walls_s"].append(wall)
    record["steps"] += [
        [h["step"], h["seconds"], h.get("newton_iters"), h.get("krylov_iters"), h["newton_residual"]]
        for h in steps if "seconds" in h
    ]
    if path:
        os.makedirs(args.ckpt, exist_ok=True)
        with open(path + ".tmp", "w") as f:
            json.dump(record, f)
        os.replace(path + ".tmp", path)
    if not args.host and s.time_step_index < n_steps:
        print(json.dumps({"partial": True, "steps_done": s.time_step_index, "n_steps": n_steps,
                          "segment_wall_s": wall}))
        return 3

    # the reference's per-Re files, written anew from the whole history
    re_tag = f"{s.get_reynolds():.2f}"
    for name in ("drag_coefficient", "lift_coefficient"):
        path = os.path.join(args.outdir, f"{name}_{re_tag}.txt")
        if os.path.exists(path):
            os.remove(path)
    for h in steps:
        s.drag_force, s.lift_force = h["drag_force"], h["lift_force"]
        s.compute_drag_coeff()
        s.compute_lift_coeff()
        s.write_lift_drag_to_file(args.outdir)

    import torch

    device = torch.cuda.get_device_name(0) if s.device.type == "cuda" else "cpu"
    mesh_tag = os.path.splitext(os.path.basename(args.mesh_file))[0] if args.mesh_file else f"{mx}x{my}"
    total = sum(record["segment_walls_s"])
    print(json.dumps({
        "metric": f"config3_{mesh_tag}_re{args.re}_{'host' if args.host else 'fused'}"
                  f"{'_consistent' if args.consistent else ''}_torch",
        "value": total,
        "unit": "s",
        "extra": {
            "n_steps": n_steps,
            "n_dofs": s.n_dofs,
            "schur": args.schur,
            "lp_cycles": args.lp_cycles,
            "direct_lu": args.direct_lu,
            "newton_max": args.newton_max,
            "segment_walls_s": record["segment_walls_s"],
            # over the steps this script ran (a resumed run starts past step 0)
            "s_per_step": total / max(1, len(record["steps"])),
            "tol": args.tol,
            "drag_coeff_last": s.drag_coeff,
            "lift_coeff_last": s.lift_coeff,
            "steps": record["steps"],
            "device": device,
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
