"""Unsteady command-line program (test.cpp:21-155 parity)."""

from __future__ import annotations

import json
import sys

from navier_stokes_solver_tpu_torch.api import NSSolver
from navier_stokes_solver_tpu_torch.cli.common import echo_config, parse_options, profiled


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    # extension flag (stationary CLI cousin): one Newton solve per step at
    # the ramp's final viscosity instead of the per-step Re continuation
    direct = "--direct" in argv
    if direct:
        argv.remove("--direct")
    opts = parse_options(argv, unsteady=True)
    echo_config(opts, unsteady=True)
    problem = NSSolver(opts)  # --fused raises here (ROADMAP.md A.D5b)
    problem.setup()
    with profiled(opts.profile_dir):
        problem.solve(direct=direct)
    if opts.verbose:
        print("phase timings:", json.dumps(problem.timer.summary()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
