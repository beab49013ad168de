"""Shared CLI argument handling (getopt_long parity, test.cpp:37-105): the
JAX package's flags, defaults and error messages, plus ``--device``.

Flags whose feature is not ported (``--dd``, ``--ir mixed``) parse as in
the JAX CLI; the run then stops when the solver is built, with the
``NotImplementedError`` that names the feature's ROADMAP item.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from navier_stokes_solver_tpu_torch.api.base import (
    PRECONDITIONER_NAMES,
    SOLVER_NAMES,
    SolverOptions,
)
from navier_stokes_solver_tpu_torch.obs import trace_to
from navier_stokes_solver_tpu_torch.precond import PrecondConfig

__all__ = ["build_parser", "parse_options", "echo_config", "profiled"]


def build_parser(unsteady: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="NSSolver" if unsteady else "StationaryNSSolver",
        description="PyTorch/CUDA incompressible Navier-Stokes solver "
        "(flow past a cylinder in a channel, or the lid-driven cavity).",
    )
    if unsteady:
        p.add_argument(
            "-T",
            "--timespan-step",
            default="1.0,0.01",
            metavar="T,D",
            help="time span and time step (two floats separated by a comma)",
        )
        p.add_argument(
            "--fused",
            action="store_true",
            help="the fused time loop (NSSolver.solve_fused): one Newton solve "
            "per step at the target viscosity, warm-started from the previous "
            "step (skips the per-step Re continuation ramp)",
        )
    p.add_argument(
        "-M",
        "--read-mesh-from-file",
        nargs="?",
        const="",
        default=None,
        metavar="FILE",
        help="use the unstructured P2/P1 simplex backend (switches FE "
        "degrees to 2,1).  With FILE, read a gmsh .msh; without, "
        "triangulate the internal channel at the requested resolution. "
        "(The reference hardcodes its mesh path, test.cpp:147, and its "
        "getopt optstring declares 'M:' so '-M' eats the next token, "
        "test.cpp:39 -- here the argument is real and optional.)",
    )
    p.add_argument(
        "-m",
        "--mesh-size",
        default="100,100",
        metavar="X,Y",
        help="mesh size (two integers separated by a comma)",
    )
    p.add_argument("-r", "--reynolds", type=float, default=100.0, metavar="N")
    p.add_argument(
        "-s",
        "--solver",
        type=int,
        default=1,
        metavar="N",
        help="0: GMRES, 1: FGMRES, 2: Bicgstab",
    )
    p.add_argument("-t", "--tolerance", type=float, default=1e-6, metavar="D")
    p.add_argument(
        "-p",
        "--preconditioner",
        type=int,
        default=0,
        metavar="N",
        help="0: blockDiagonal, 1: blockTriangular, 2: aSIMPLE",
    )
    p.add_argument(
        "--dd",
        default="",
        metavar="X[,Y]",
        help="domain-decompose over X x Y tiles (not ported yet: ROADMAP.md A.D9)",
    )
    p.add_argument(
        "--basis",
        type=int,
        default=30,
        metavar="N",
        help="outer GMRES/FGMRES restart basis (30 = deal.II-default parity)",
    )
    p.add_argument(
        "--ir",
        nargs="?",
        const="float32",
        default=None,
        choices=("float32", "mixed"),
        help="GMRES-IR: run the outer Krylov restart cycles in reduced "
        "precision with f64 restart residuals (automatic f64 fallback on "
        "stall).  Bare --ir = f32 cycles; 'mixed' is not ported (ROADMAP.md A.14)",
    )
    p.add_argument(
        "--schur",
        choices=("mass", "cahouet", "pcd"),
        default="mass",
        metavar="MODE",
        help="Schur treatment for blockDiagonal/blockTriangular: 'mass' "
        "(reference parity), 'cahouet' (adds the (1/dt) Lp^-1 leg) or "
        "'pcd' (pressure convection-diffusion)",
    )
    p.add_argument(
        "--stokes-schur",
        choices=("shat", "mass"),
        default="shat",
        metavar="MODE",
        help="aSIMPLE (-p 2) Stokes-regime Schur surrogate: 'shat' "
        "(reference parity, S-hat = B diag(F)^-1 B^T) or 'mass' (the "
        "Stokes-correct pressure-mass solve)",
    )
    p.add_argument(
        "--direct-lu",
        action="store_true",
        help="direct dense-LU preconditioner: factor the full saddle "
        "Jacobian in f32 once per tangent solve and apply the exact solve "
        "(the outer Krylov converges in a handful of f64 iterations).  "
        "Ignored above DIRECT_LU_MAX_N (precond/blocks.py) unknowns -- the "
        "solution vector's length, which on the structured lattice also "
        "counts the inactive nodes inside the cylinder; the -p "
        "preconditioner applies there, and setup says so.  Default off = parity",
    )
    p.add_argument(
        "--cavity",
        action="store_true",
        help="solve the lid-driven cavity (unit box, moving top lid) "
        "instead of the channel -- an extension beyond the reference "
        "(geometry/cavity.py; Ghia et al. 1982 benchmark geometry)",
    )
    p.add_argument(
        "--skip-futile-stokes",
        action="store_true",
        help="stationary: skip the reference's repeat Stokes-regime "
        "tangent solves (state-independent rhs; every update after the "
        "first accepted Stokes solution is rejected by the strict-< "
        "line search).  Default off = reference parity",
    )
    p.add_argument(
        "--consistent-continuity",
        action="store_true",
        help="assemble the Newton continuity rhs with the "
        "Jacobian-consistent sign -(q, div u_k) instead of the reference's "
        "+(q, div u_k) (NSSolver.cpp:461-463 vs :517-519).  Default off "
        "= reference parity",
    )
    p.add_argument("--output", action="store_true",
                   help="write VTU snapshots into --output-dir")
    p.add_argument("--output-dir", default=".", metavar="DIR")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile-dir", default="", metavar="DIR",
                   help="capture a torch.profiler trace of the solve")
    p.add_argument("--f32", action="store_true", help="fp32 throughput mode")
    p.add_argument(
        "--device",
        default="cuda",
        metavar="DEV",
        help="torch device of the solve (default: cuda, the card; 'cpu' "
        "runs on the CPU)",
    )
    return p


def _pair(s: str, cast, flag: str):
    if "," not in s:
        print(f"Error: {flag} requires two values separated by comma", file=sys.stderr)
        raise SystemExit(1)
    a, b = s.split(",", 1)
    return cast(a), cast(b)


def parse_options(argv, unsteady: bool) -> SolverOptions:
    args = build_parser(unsteady).parse_args(argv)
    mx, my = _pair(args.mesh_size, int, "mesh-size")
    opts = SolverOptions(
        mesh_size=(mx, my),
        Re=args.reynolds,
        solver_type=args.solver,
        tolerance=args.tolerance,
        preconditioner_type=args.preconditioner,
        read_mesh_from_file=args.read_mesh_from_file is not None,
        mesh_file_name=args.read_mesh_from_file or "",
        geometry="cavity" if args.cavity else "channel",
        verbose=not args.quiet,
        write_output=args.output,
        output_dir=args.output_dir,
        profile_dir=args.profile_dir,
        consistent_continuity=args.consistent_continuity,
        skip_futile_stokes=args.skip_futile_stokes,
        device=args.device,
    )
    if unsteady:
        ts, dt = _pair(args.timespan_step, float, "timespan-step")
        opts.time_span, opts.time_step = ts, dt
        opts.fused = args.fused
        if dt <= 0 or ts <= 0:
            print(
                "Error: time_step, time_span, and tolerance must be positive",
                file=sys.stderr,
            )
            raise SystemExit(1)
    if args.tolerance <= 0:
        print("Error: tolerance must be positive", file=sys.stderr)
        raise SystemExit(1)
    # reference validation (test.cpp:75-92): solver/preconditioner ids 0..2
    if args.solver not in (0, 1, 2):
        print(
            "Error: solver must be 0 (GMRES), 1 (FGMRES) or 2 (Bicgstab)",
            file=sys.stderr,
        )
        raise SystemExit(1)
    if args.preconditioner not in (0, 1, 2):
        print(
            "Error: preconditioner must be 0 (blockDiagonal), "
            "1 (blockTriangular) or 2 (aSIMPLE)",
            file=sys.stderr,
        )
        raise SystemExit(1)
    if args.f32:
        opts.dtype = torch.float32
    opts.krylov_basis = args.basis
    if (
        args.ir is not None
        or args.schur != "mass"
        or args.stokes_schur != "shat"
        or args.direct_lu
    ):
        opts.precond_config = PrecondConfig(
            krylov_cycle_dtype=args.ir,
            schur_mode=args.schur,
            asimple_stokes_schur=args.stokes_schur,
            direct_lu=args.direct_lu,
        )
    if args.dd:
        if "," in args.dd:
            opts.dd = _pair(args.dd, int, "dd")
        else:
            opts.dd = (int(args.dd), 1)
    return opts


def echo_config(opts: SolverOptions, unsteady: bool):
    """Configuration echo (test.cpp:116-145)."""
    if not opts.verbose:
        return
    print("--------- CONFIGURATION PARAMETERS --------- ")
    if unsteady:
        print(f"Time span: {opts.time_span}")
        print(f"Time step: {opts.time_step}")
    print(f"Mesh size: {opts.mesh_size[0]}x{opts.mesh_size[1]}")
    print(f"Reynolds number: {opts.Re}")
    print(f"Solver type: {SOLVER_NAMES.get(opts.solver_type, '?')}")
    print(f"Tolerance: {opts.tolerance}")
    print(f"Preconditioner: {PRECONDITIONER_NAMES.get(opts.preconditioner_type, '?')}")
    print("-----------------------------------------------")


def profiled(profile_dir: str):
    """``trace_to(profile_dir)`` when a directory is given, else a no-op."""
    return trace_to(profile_dir) if profile_dir else contextlib.nullcontext()
