"""Stationary command-line program (testStationary.cpp:19-139 parity)."""

from __future__ import annotations

import json
import sys
import time

from navier_stokes_solver_tpu_torch.api import NSSolverStationary
from navier_stokes_solver_tpu_torch.cli.common import echo_config, parse_options, profiled


def run(argv) -> NSSolverStationary:
    """Everything ``main`` does; returns the solver, with the wall of its
    solve (setup excluded) in ``solve_seconds``."""
    argv = list(argv)
    # extension: skip the reference's Re-continuation ramp and Newton at
    # exactly nu = 1/Re (NSSolverStationary.solve_direct)
    direct = "--direct" in argv
    if direct:
        argv.remove("--direct")
    opts = parse_options(argv, unsteady=False)
    echo_config(opts, unsteady=False)
    problem = NSSolverStationary(opts)
    problem.setup()
    solve = problem.solve_direct if direct else problem.solve_newton
    t0 = time.perf_counter()
    with profiled(opts.profile_dir):
        solve()
    problem.solve_seconds = time.perf_counter() - t0
    problem.output()
    problem.compute_lift_drag()
    problem.print_lift_coeff()
    problem.print_drag_coeff()
    if opts.verbose:
        print("phase timings:", json.dumps(problem.timer.summary()))
    return problem


def main(argv=None):
    run(argv if argv is not None else sys.argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
