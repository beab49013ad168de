"""Unsteady command-line program (test.cpp:21-155 parity)."""

from __future__ import annotations

import json
import sys
import time

from navier_stokes_solver_tpu_torch.api import NSSolver
from navier_stokes_solver_tpu_torch.cli.common import echo_config, parse_options, profiled, run_ranks


def run(argv) -> NSSolver | None:
    """Everything ``main`` does; returns the solver (None where ``--dd``
    spawned the ranks: each ran this in its own process), with the wall of its
    time loop (setup excluded) in ``solve_seconds``.  ``--fused`` runs
    ``solve_fused`` (before ``--direct``) and then prints the last step's
    coefficients."""
    orig, argv = list(argv), list(argv)
    # extension flag (stationary CLI cousin): one Newton solve per step at
    # the ramp's final viscosity instead of the per-step Re continuation
    direct = "--direct" in argv
    if direct:
        argv.remove("--direct")
    opts = parse_options(argv, unsteady=True)
    if run_ranks("navier_stokes_solver_tpu_torch.cli.unsteady", orig, opts):
        return None
    echo_config(opts, unsteady=True)
    problem = NSSolver(opts)
    problem.setup()
    t0 = time.perf_counter()
    with profiled(opts.profile_dir):
        if opts.fused:
            problem.solve_fused()
        else:
            problem.solve(direct=direct)
    problem.solve_seconds = time.perf_counter() - t0
    if opts.fused:
        problem.print_lift_coeff()
        problem.print_drag_coeff()
    if opts.verbose and problem.is_root:
        print("phase timings:", json.dumps(problem.timer.summary()))
    return problem


def main(argv=None):
    run(argv if argv is not None else sys.argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
