#!/usr/bin/env python3
"""Whole 16x8 solves of the PyTorch port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_whole_solve_parity.py stop [--seeds N] [--first-seed K]
    JAX_PLATFORMS=cpu python3 scripts/torch_whole_solve_parity.py rho [--cap N]
    JAX_PLATFORMS=cpu python3 scripts/torch_whole_solve_parity.py spread [--entries NAME,...] [--seeds N] [--first-seed K]
    python3 scripts/torch_whole_solve_parity.py summary LOG...

All-f64 preconditioner (``vmult_dtype=None``, ``mg_dtype=None``),
``skip_futile_stokes``, stationary tol 1e-8, and the same fixed Krylov
chunks in both packages (``NSTPU_KRYLOV_CHUNK=960``).

``stop``: the stationary ``-s 2 -p 1`` Re 20 solve (BiCGStab +
blockTriangular, the reference's inner tolerances) in each package.  Every
Krylov chunk prints its iterations, its converged and failed flags and its
residual; the run ends with the solve's outcome -- converged, or the
``RuntimeError`` that a breakdown raises -- and where it stopped.  With
``--seeds``, the perturbed starts described below.

``rho``: that run's first tangent solve, capped at ``--cap`` iterations, in
each package: BiCGStab's rho = <rbar, r> and the residual norm at every
iteration.  It shows where the two trajectories stagnate and how close rho
comes to the breakdown guard's exact-zero test.

``spread``: the entries whose long Krylov solves are chaotic (rounding
differences grow until the stopping iteration moves), each run ``--seeds``
times in each package.  Seed 0 is the plain run; seed k > 0 adds
1e-14 x a seeded normal vector (numpy, the same in both packages) to the
free entries of the persistent Krylov start ``delta`` (the state itself
would not do: the Stokes-regime rhs does not depend on it).  It prints
each run's Krylov counts per solve, their total and the drag and lift
coefficients, then per package the range, mean and spread of the totals
and of the last drag.  The two packages should draw from one
distribution: overlapping count and drag ranges, and drag means that
differ by no more than their standard error allows.  ``summary`` prints
the same summary over the records of several ``spread`` outputs, e.g. of
seeds run as separate processes with ``--first-seed``.

The port imports no JAX; this script, like the parity tests, imports both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (16, 8)
PERTURB = 1e-14
# (unsteady, SolverOptions fields): configurations whose long Krylov solves are chaotic
ENTRIES = {
    "stationary -s 0 -p 0 Re 20": (False, dict(solver_type=0, preconditioner_type=0, Re=20.0)),
    "stationary -s 1 -p 2 Re 30": (False, dict(solver_type=1, preconditioner_type=2, Re=30.0)),
    "unsteady -s 1 -p 0 Re 20": (True, dict(solver_type=1, preconditioner_type=0, Re=20.0)),
    "unsteady -s 1 -p 2 Re 20": (True, dict(solver_type=1, preconditioner_type=2, Re=20.0)),
}
STOP = (False, dict(solver_type=2, preconditioner_type=1, Re=20.0))


def packages():
    from navier_stokes_solver_tpu import api as japi
    from navier_stokes_solver_tpu.api import kernels as jk
    from navier_stokes_solver_tpu.ops import Blocks as JBlocks
    from navier_stokes_solver_tpu.precond import PrecondConfig as JCfg
    from navier_stokes_solver_tpu_torch import api as tapi
    from navier_stokes_solver_tpu_torch.api import kernels as tk
    from navier_stokes_solver_tpu_torch.ops import Blocks
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    return {
        "torch": dict(api=tapi, kernels=tk, blocks=Blocks, cfg=PrecondConfig, opts=dict(device="cpu")),
        "jax": dict(api=japi, kernels=jk, blocks=JBlocks, cfg=JCfg, opts={}),
    }


def make_solver(pkg, unsteady, fields):
    api = pkg["api"]
    o = dict(
        mesh_size=MESH, degree_velocity=3, degree_pressure=2, verbose=False,
        precond_config=pkg["cfg"](vmult_dtype=None, mg_dtype=None), **pkg["opts"], **fields,
    )
    if unsteady:
        s = api.NSSolver(api.SolverOptions(tolerance=1e-9, time_span=0.02, time_step=0.01, **o))
    else:
        s = api.NSSolverStationary(api.SolverOptions(tolerance=1e-8, skip_futile_stokes=True, **o))
    return s.setup()


def perturb(name, pkg, s, seed):
    """Add 1e-14 x a seeded normal vector to the free entries of the
    first Krylov start (seed 0: unchanged)."""
    import numpy as np

    if seed == 0:
        return
    u, p = (np.asarray(a, dtype=np.float64) for a in (s.delta.u, s.delta.p))
    d = s.disc
    free_u = np.asarray(d.u_active) & ~np.asarray(d.u_dirichlet)
    rng = np.random.default_rng(seed)
    u = u + PERTURB * rng.standard_normal(u.shape) * free_u
    p = p + PERTURB * rng.standard_normal(p.shape) * np.asarray(d.p_active)
    if name == "jax":
        import jax.numpy as jnp

        s.delta = pkg["blocks"](jnp.asarray(u), jnp.asarray(p))
    else:
        import torch

        s.delta = pkg["blocks"](torch.as_tensor(u), torch.as_tensor(p))


def run(name, pkg, unsteady, fields, seed=0):
    s = make_solver(pkg, unsteady, fields)
    perturb(name, pkg, s, seed)
    t0 = time.perf_counter()
    error = None
    try:
        if unsteady:
            s.solve()
        else:
            s.solve_newton()
            s.compute_lift_drag()
            s.compute_drag_coeff()
            s.compute_lift_coeff()
    except RuntimeError as e:  # a Krylov breakdown (deal.II NoConvergence)
        error = str(e)
    solves = [h.get("krylov_iters", 0) for h in s.history if h["phase"] not in ("step", "stokes_skipped")]
    if unsteady:
        forces = [(h["drag_coeff"], h["lift_coeff"]) for h in s.history if h["phase"] == "step"]
    else:
        forces = [(s.drag_coeff, s.lift_coeff)]
    return dict(
        package=name, seed=seed, wall_s=time.perf_counter() - t0, krylov_per_solve=solves,
        krylov_total=sum(solves), drag_lift=forces, error=error,
    )


def cmd_stop(seeds):
    """Wrap each package's ``solve_kernel`` to record every chunk."""
    for seed in seeds:
        for name, pkg in packages().items():
            k = pkg["kernels"]
            chunks = []
            orig = k.solve_kernel

            def recording(*a, _orig=orig, _chunks=chunks, _name=name, **kw):
                x, info = _orig(*a, **kw)
                _chunks.append(dict(
                    stokes=kw["stokes"], project_x0=kw["project_x0"], iterations=int(info.iters),
                    converged=bool(info.converged), failed=bool(info.failed), resnorm=float(info.resnorm),
                ))
                print(json.dumps({"package": _name, "seed": seed, "chunk": len(_chunks) - 1, **_chunks[-1]}), flush=True)
                return x, info

            s = make_solver(pkg, *STOP)
            perturb(name, pkg, s, seed)
            if name == "jax":
                s.K = types.SimpleNamespace(**{n: getattr(k, n) for n in dir(k) if not n.startswith("_")})
                s.K.solve_kernel = recording
            else:
                k.solve_kernel = recording
            t0 = time.perf_counter()
            error = None
            try:
                s.solve_newton()
            except RuntimeError as e:
                error = str(e)
            finally:
                if name == "torch":
                    k.solve_kernel = orig
            print(json.dumps({
                "package": name, "seed": seed, "entry": "stationary -s 2 -p 1 Re 20",
                "wall_s": time.perf_counter() - t0,
                "tangent_solves": [h.get("krylov_iters") for h in s.history],
                "chunks": len(chunks), "outcome": "raised" if error else "returned", "error": error,
                "last_chunk": chunks[-1] if chunks else None,
            }), flush=True)


class _FirstChunk(Exception):
    """Stops a solve after its first Krylov chunk."""


def cmd_rho(cap):
    """The first tangent solve of ``stop``, capped at ``cap`` iterations,
    in each package: BiCGStab's rho = <rbar, r> and residual norm per
    iteration, read from the dot products of the outer loop (the only ones
    on both blocks: five per iteration after one for the start residual)."""
    import jax
    import numpy as np

    import navier_stokes_solver_tpu.krylov.solvers as jsol
    import navier_stokes_solver_tpu_torch.krylov.solvers as tsol

    dots = {"jax": [], "torch": []}
    j_dot, t_dot = jsol.tvdot, tsol.tvdot

    def j_rec(x, y):
        v = j_dot(x, y)
        if len(jax.tree_util.tree_leaves(x)) == 2:
            jax.debug.callback(lambda a: dots["jax"].append(float(a)), v, ordered=True)
        return v

    def t_rec(x, y):
        v = t_dot(x, y)
        if isinstance(x, tuple):
            dots["torch"].append(float(v))
        return v

    jsol.tvdot, tsol.tvdot = j_rec, t_rec
    for name, pkg in packages().items():
        k = pkg["kernels"]
        orig = k.solve_kernel

        def once(*a, _orig=orig, **kw):
            _orig(*a, **kw)
            raise _FirstChunk

        s = make_solver(pkg, *STOP)
        s.KRYLOV_MAXITER = cap
        if name == "jax":
            s.K = types.SimpleNamespace(**{n: getattr(k, n) for n in dir(k) if not n.startswith("_")})
            s.K.solve_kernel = once
        else:
            k.solve_kernel = once
        try:
            s.solve_newton()
        except _FirstChunk:
            pass
        finally:
            k.solve_kernel = orig
    jsol.tvdot, tsol.tvdot = j_dot, t_dot
    per_it = {n: np.asarray(v[1:]).reshape(-1, 5) for n, v in dots.items()}
    for i in range(max(len(v) for v in per_it.values())):
        row = {"iteration": i + 1}
        for n, v in per_it.items():
            if i < len(v):
                row[n] = {"rho": v[i, 0], "resnorm": float(np.sqrt(v[i, 4]))}
        print(json.dumps(row), flush=True)


def summarize(entry, records):
    """Per package: the count and last-step drag of every run, their range,
    mean and standard deviation; then whether the count ranges overlap and
    the difference of the drag means over its standard error."""
    import statistics as st

    summary = {}
    for name in ("torch", "jax"):
        rs = [r for r in records if r["package"] == name]
        totals = [r["krylov_total"] for r in rs]
        drags = [r["drag_lift"][-1][0] for r in rs if r["error"] is None]
        summary[name] = dict(
            runs=len(rs), errors=len(rs) - len(drags), totals=totals,
            total_range=[min(totals), max(totals)], total_mean=st.mean(totals),
            drag_range=[min(drags), max(drags)], drag_mean=st.mean(drags),
            drag_sd=st.stdev(drags) if len(drags) > 1 else 0.0,
        )
    t, j = summary["torch"], summary["jax"]
    se = (t["drag_sd"] ** 2 / t["runs"] + j["drag_sd"] ** 2 / j["runs"]) ** 0.5
    print(json.dumps({
        "entry": entry, "summary": summary,
        "count_ranges_overlap": t["total_range"][0] <= j["total_range"][1] and j["total_range"][0] <= t["total_range"][1],
        "drag_ranges_overlap": t["drag_range"][0] <= j["drag_range"][1] and j["drag_range"][0] <= t["drag_range"][1],
        "drag_mean_difference": t["drag_mean"] - j["drag_mean"],
        "drag_mean_difference_over_se": (t["drag_mean"] - j["drag_mean"]) / se if se > 0 else None,
    }), flush=True)


def cmd_spread(entries, seeds):
    pk = packages()
    for entry in entries:
        unsteady, fields = ENTRIES[entry]
        records = []
        for seed in seeds:
            for name, pkg in pk.items():
                records.append({"entry": entry, **run(name, pkg, unsteady, fields, seed)})
                print(json.dumps(records[-1]), flush=True)
        summarize(entry, records)


def cmd_summary(paths):
    """``summarize`` over the run records in ``spread`` outputs (e.g. of
    seeds run as separate processes)."""
    by_entry = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.startswith('{"entry"') and '"package"' in line:
                    r = json.loads(line)
                    by_entry.setdefault(r["entry"], {})[(r["package"], r["seed"])] = r
    for entry, recs in by_entry.items():
        summarize(entry, [recs[k] for k in sorted(recs)])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command", choices=("stop", "rho", "spread", "summary"))
    ap.add_argument("logs", nargs="*", help="summary: files holding spread output")
    ap.add_argument("--cap", type=int, default=140, help="rho: iterations of the first tangent solve")
    ap.add_argument("--entries", default=",".join(ENTRIES), help="comma-separated names from ENTRIES")
    ap.add_argument("--seeds", type=int, default=None, help="runs per package (stop: 1, spread: 4)")
    ap.add_argument("--first-seed", type=int, default=0)
    args = ap.parse_args()
    n = args.seeds or (1 if args.command == "stop" else 4)
    seeds = range(args.first_seed, args.first_seed + n)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("NSTPU_KRYLOV_CHUNK", "960")
    import torch

    torch.set_num_threads(1)
    if args.command == "summary":
        cmd_summary(args.logs)
    elif args.command == "stop":
        cmd_stop(seeds)
    elif args.command == "rho":
        cmd_rho(args.cap)
    else:
        cmd_spread([e for e in args.entries.split(",") if e], seeds)


if __name__ == "__main__":
    main()
