#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; none catches another's).  They run in this
order, except that phases 21 and 24 run right after phase 4, phase 19 right
after phase 10 (on its solver), phases 23, 25 and 26 after phase 19, phase
8 after phase 26, and phases 8, 12, 13, 14, 18, 22 and 27 together after
it: the CPU sides of the card-vs-CPU phases (8, 12, 14, 18, 22, 27) run in
three spawned worker processes meanwhile (18's, 22's and 27's when a
worker is free), which are joined before phase 15 -- so the timed paths
before and after them have the host to themselves; phase 20 runs after
phase 16, and phase 28 after phase 17:

  1. device   -- require CUDA; print the card (nvidia-smi name and power
                limit) and the torch / CUDA versions;
  2. build    -- compile the hand-written kernels from ``csrc/`` (one nvcc
                per source, started together) and print ptxas's register
                and spill report;
  3. check    -- each kernel against its plain PyTorch version on the card,
                at 100x70, 300x100 and 100x33 Q3/Q2 (the three main paths),
                20x9 Q2/Q1 and every multigrid level of the main paths:
                ``cell_apply_F`` (both
                entry points, and a permuted lattice layout) within rtol =
                atol 1e-5 (f32) and 1e-12 (f64); ``scatter_v_bc`` bit for
                bit (max |diff| == 0), with and without the boundary rows;
                every operand's largest element offset must fit the
                kernels' 32-bit indexing;
  4. time     -- at every multigrid level of the three main paths, f32,
                both regimes:
                each kernel's device time (CUDA events around 200
                back-to-back launches queued behind a sleep kernel, so the
                host cannot starve the card, divided by 200), its
                host-inclusive time (events around one call, median of 50),
                its plain version's time, the library yardstick's and the
                bound;
  5. launches -- one ``apply_F`` on CUDA in a ``torch.profiler`` window must
                run exactly two device kernels, these two (the tracer drops
                a trace's first activities: every trace runs a warm-up
                call, three marker kernels, the recorded call and a marker,
                and is taken again, up to five times, when it lacks the
                leading or the trailing markers: ``profile_call``);
  6. main     -- the stationary 100x70 Q3/Q2 solve at the tuned ``bench.py``
                configuration through ``NSSolverStationary``, ``SOLVES``
                times (once: a depth cut): the drag must match
                ``BENCH_r05.json`` within rtol 1e-7, the outer Krylov count
                stay within 2 x 589, and every kernel of the path must have
                launched (counts zeroed just before each solve, read just
                after);
  7. outer    -- at the converged state, device kernels, device time, wall
                and host readbacks (device-to-host copies) per outer FGMRES
                iteration in each regime, from profiler windows of 1 and 4
                outer iterations (difference);
  8. unsteady-check -- ``NSSolver.solve()`` (the per-step Re ramp) at 32x12
                Q3/Q2, Re 20, ``CHECK_STEPS`` (two) steps, so the second
                starts from carried state, all-f64 preconditioner, once on the
                card and once on the CPU (the plain versions): per-solve
                Krylov counts equal (or each within 1, printed), drag and
                lift per step within rtol 1e-7, fields within 1e-6 of their
                largest magnitude;
  9. unsteady-main -- the north-star unsteady configuration at full width:
                300x100 Q3/Q2 (657,740 DoFs), Re 100, dt 0.01,
                ``UNSTEADY_STEPS`` (one) of the 800 steps of T = 8, tol 1e-9, FGMRES basis 30, blockTriangular
                with the Cahouet-Chabard leg (one Lp V-cycle), f32
                preconditioner, ``NSSolver.solve(direct=True)``: setup and
                per-step walls, Newton iterations, outer counts, final
                Newton residual (each <= 1e-9), coefficients (finite), kernel
                launches (counts zeroed just before, read just after: each
                kernel must have launched);
 10. unsteady-outer -- phase 7's profile in the unsteady Newton regime at
                the state the run ended in, with our kernels' share;
 11. config1  -- (run after phase 5) BASELINE.json configs[0] through the
                port's CLI, in this process (``cli.stationary.run``), not
                cut: 100x33 Q3/Q2
                (73,180 DoFs), Re 20, GMRES + blockDiagonal (the
                reference's default preconditioner), tol 1e-8: setup and
                solve walls, outers per tangent solve and in total (at most
                2 x the 1,846 on record), the drag coefficient within rtol
                1e-6 of the ``PERF_NORTHSTAR.json`` value, launches of both
                kernels (counts zeroed just before, read just after), then
                phase 7's profile in its (Stokes) regime;
 12. matrix   -- the slice's options on the card against the CPU, all-f64,
                at 24x10: whole solves where the two trajectories agree
                (blockDiagonal Re 30, the jacobi and schwarz smoothers,
                ``inner_mode="fixed"``, ``multigrid=False``: counts within
                1 per solve, drag and lift rtol 1e-7, fields 1e-6 of their
                magnitude); tangent solves capped inside the agreeing
                stretch for the chaotic ones (GMRES, BiCGStab, aSIMPLE,
                unsteady blockDiagonal: counts equal, residual and iterate
                within 1e-10); whole aSIMPLE and BiCGStab solves on the
                card alone (finite, converged);
 13. profile  -- a small CLI solve with ``--profile-dir``: the Chrome trace
                must name both kernels;
 14. simplex-check -- the ``-M`` P2/P1 simplex backend on the card against
                the CPU, all-f64, at 24x10: whole solves (stationary Re 20
                blockTriangular with the p-multigrid and the dense Schur
                legs; the same with ``--direct-lu``): Krylov counts within 1
                per solve, drag and lift rtol 1e-7, fields 1e-6 of their
                magnitude; the two-step unsteady run (per-step Re ramp, the
                reference's continuity sign, iterative Schur legs): drag and
                lift per step rtol 1e-7, fields 1e-6, counts printed (its
                400-600-outer Newton-regime solves are chaotic: a rounding
                difference moves their stopping iteration); capped tangent
                solves (``SIMPLEX_TANGENT``) carry the count gate there.
                The CPU side runs in one worker process beside the card's;
 15. config3  -- BASELINE config 3, the reference's unsteady script
                (run_sim_unsteady.sh:21) through ``cli.unsteady.run``: -M
                60x40 (21,997 DoFs), T = 0.03 in steps of 0.01 (its own
                three steps, not cut), tol 1e-9, FGMRES + blockTriangular,
                Re 1, with the Jacobian-consistent continuity sign; f32
                preconditioner, p-MG, dense Schur legs: setup, per-step
                walls, Newton iterations, outers per step; every step's
                Newton residual <= 1e-9, finite coefficients; then phase 7's
                profile in its Newton regime with the costliest device ops;
 16. config3-lu -- the same with ``--direct-lu``, T = 0.12 (12 of the 800
                steps of the record): matrix-build, factor and solve
                seconds per tangent solve; the last step's drag within rtol
                1e-5 of the 800-step record (``PERF_NORTHSTAR.json``);
 17. simplex-file -- a curved-cylinder mesh of >= 100k DoFs from the port's
                ``triangulate_channel_curved``, written as MSH2 to a
                temporary directory and read back through ``-M FILE``: one
                step (T = 0.01), Re 1, Cahouet-Chabard, consistent sign:
                id-10 curved edges present, Newton residual <= 1e-9, finite
                positive drag;
 18. fused-check -- ``NSSolver.solve_fused`` (the fused time loop) on the
                card against the CPU, all-f64 (``FUSED_CHECK``): structured
                16x8 Re 10, tol 1e-8, ``newton_max`` 3, ``krylov_maxiter``
                200, three steps; ``-M`` 24x10 Re 1 (consistent sign,
                iterative Schur legs), two steps with every tangent solve
                capped at 40 iterations (whole -M Newton-regime solves run
                past the stretch where card and CPU agree, phase 14): Newton
                and Krylov counts per step within 1, drag and lift per step
                rtol 1e-7, fields 1e-6 of their magnitude; then the first
                case split after step 1 through a checkpoint directory
                (save -> load -> resume in a fresh ``solve_fused``) must
                equal its unsplit card run bit for bit.  The CPU side runs
                in a worker process;
 19. fused-main -- the fused loop at full width, on phase 9's solver: its
                host step's state written as a step-1 checkpoint, then
                ``FUSED_MAIN_STEPS`` (two) fused steps, each one
                ``solve_fused(checkpoint_dir=..., max_steps_this_call=1)``
                call resuming from the directory, phase 9's preconditioner
                (Cahouet-Chabard, one Lp V-cycle, f32, basis 30, tol 1e-9):
                per-step wall, Newton iterations, outers, final residual
                (each <= 1e-9), finite coefficients, launches of both kernels
                (counts zeroed just before, read just after);
 20. config3-lu-fused -- phase 16 through ``cli.unsteady.run --fused``,
                ``CONFIG3_LU_STEPS`` steps: per-step walls, Newton iterations,
                outers, residuals (each <= 1e-9), factorizations; the last
                drag within rtol 1e-5 of the 800-step record (a fused run);
 21. ensemble-kernels -- both kernels with the member axis at every
                level of BASELINE config 5's multigrid chain (60x40 Q2/Q1
                and its coarse levels, B = 64), f32 and f64, both regimes:
                each batched launch against its plain version (phase 3's
                tolerances) and, bit for bit, against B unbatched launches
                on the members' operands and against itself on a permuted
                lattice layout; the 32-bit index check over the batched
                operands; then, at 60x40, phase 4's timings of the batched
                launch (f32), with the library call's (a batched matmul of
                the per-member Stokes element matrices; ``index_add_`` over
                all members) and the bound (phase 4's reckoning over B
                members, the operands they share counted once);
 22. ensemble-check -- a small ensemble (16x8 Q2/Q1, B = 3, Re 20/60/100,
                two steps, all-f64, tangent solves capped at 20) on the
                card against the CPU: per step and member the Newton and
                Krylov counts within 1, drag and lift rtol 1e-7, fields 1e-6
                of their magnitude.  The CPU side runs in a worker process;
 23. ensemble-main -- BASELINE config 5 at full width through
                ``ensemble.make_ensemble_step``: 60x40 Q2/Q1 (22,103 DoFs
                per member), B = 64, Re 20..100, dt 0.01, tol 1e-9,
                ``newton_max`` 3, ``krylov_maxiter`` 200, Cahouet-Chabard
                with one Lp V-cycle, f32 preconditioner: one warm-up step
                (the inlet lift) and ``ENSEMBLE_STEPS`` (two) timed steps --
                per-step walls, member-steps/s, per-member Newton
                iterations, Krylov totals and final residuals (each member
                at or under 1e-9, or at the Newton cap, listed), finite drag
                and lift for every member, launches of both kernels (counts
                zeroed just before, read just after); then the B = 1
                control (member B//2's state after the warm-up, stepped as
                many times by the unbatched step) and
                ``batch_efficiency_vs_single`` = t_1 B / t_B, each beside
                the card's name and power limit; then phase 7's profile of
                one outer iteration of the batched tangent solve;
 24. cavity-kernels -- both kernels at every level of the 128x128 Q2/Q1
                lid-driven cavity's multigrid chain (128^2 down to 8^2: a
                cavity at every level, square cells, no inactive node, the
                lid's corner nodes Dirichlet), f32 and f64, both regimes,
                with phase 3's checks and tolerances; then phase 4's
                timings at 128x128;
 25. cavity-ghia -- the slice at full width: the cavity at 128x128 Q2/Q1
                (148,739 DoFs), Re 100, ``NSSolverStationary.solve_direct``
                with the options of tests/test_cavity.py (FGMRES,
                blockTriangular, tol 1e-10, basis 60), f32 preconditioner,
                the Jacobian-consistent continuity sign: per tangent solve
                the outers, wall and launches; the final Newton residual
                (<= 1e-9), both centerline deviations from Ghia, Ghia &
                Shin (1982) Tables I-II (each < 2.5e-2), launches of both
                kernels (counts zeroed just before, read just after); then
                phase 7's profile in the Newton regime;
 26. cavity-cli -- ``cli.stationary --cavity -m 32,32 -r 100 --output``
                (the continuation, ``output()`` at each of its call sites)
                into a temporary directory: the record's two files exist
                and decode to ``fields()`` at the cell corners bit for bit;
                both kernels launched;
 27. cavity-check -- a 32x32 Q2/Q1 cavity with a body force at Re 100,
                ``solve_direct``, all-f64, on the card against the CPU:
                outers within 1 per tangent solve, fields within 1e-6 of
                their magnitude (the pressure's mean removed);
 28. native-io -- the native C++ IO library must build (``g++``): phase
                9's 300x100 Q3/Q2 state through the native and the Python
                VTU writers (byte for byte, both timed), config 3's state
                through ``write_vtu_tri`` (decoded to its fields), and
                phase 17's curved MSH2 mesh through the native and the
                Python gmsh readers (arrays equal, both timed);
 29. report   -- one JSON line of per-kernel results (launches from phase
                25 and times at its finest level, 128x128 Q2/Q1 Stokes,
                with every path's launches -- the fused 300x100 path's,
                the ensemble's and the cavity CLI's among them, 0 on the
                simplex paths, which run no hand-written kernel -- and every
                shape's times beside them, the batched launches' included),
                the nvidia-smi line, then the final ``{"ok": true,
                "device": ...}`` line.

If the script outgrows its time budget, depth is cut, in this order: the
stationary bench solve to one run (``SOLVES``), then the unsteady run to
one step (``UNSTEADY_STEPS``), then config3-lu to 12 steps
(``CONFIG3_LU_STEPS``, which config3-lu-fused shares), then phase 12's
unsteady card-only entry -- all four taken: the whole script took 1,040.8 s
of its 1,200 s on a slow card without the last three -- then fused-main to
one step (``FUSED_MAIN_STEPS``; its checkpoint resume is still the one
from phase 9's state, and fused-check keeps its own round trip) -- never a
mesh, config3's three steps, the simplex check, the fused check, the
unsteady check's second step, the ensemble's B = 64 or its two timed
steps, nor a kernel check's shape.  If the cavity phases ever need room,
cavity-ghia goes to 64x64 (Ghia's own 129^2 velocity grid).  The cuts are
printed.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the ``bench.py`` tuned configuration (FGMRES + blockTriangular, tol 1e-12,
# basis 60, f32 GMRES-IR cycles, skip_futile_stokes, Stokes inner rel 1e-4)
BENCH_MESH = (100, 70)
BENCH_OUTER_ITERS = 589  # BENCH_r05.json parsed.extra.total_krylov_iters
DRAG_RTOL = 1e-7
# kernel vs plain tolerances: summation order differs (tests/test_pallas.py)
KERNEL_TOL = {"float64": 1e-12, "float32": 1e-5}
KERNEL_NU, KERNEL_INV_DT = 0.05, 100.0  # inv_dt of the unsteady path (dt 0.01)
# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
TIMED_CALLS, HOST_CALLS, PLAIN_CALLS = 200, 50, 20
OUTER_WINDOW = 4
# profiler windows (``profile_call``): a recorded call bracketed by marker
# kernels, taken again when the tracer dropped the markers
PROFILE_ATTEMPTS, PROFILE_LEAD = 5, 3
PROFILE_MARKER, PROFILE_MARKER_CYCLES = "spin_kernel", 1000
PROFILE_WINDOWS = []  # per window: (traces taken again, leading markers the tracer dropped)
SOLVES = 1  # stationary runs (cut from 2 to 1 to make room for phases 12-14)
# the unsteady north star (BASELINE.json): 300x100 Q3/Q2, Re 100, dt 0.01
UNSTEADY_MESH = (300, 100)
UNSTEADY_DOFS = 657_740
UNSTEADY_DT = 0.01
UNSTEADY_STEPS = 1  # of the 800 steps of T = 8 (the second depth cut, from 2)
CHECK_MESH = (32, 12)  # unsteady-check: card against CPU
CHECK_RE, CHECK_STEPS = 20.0, 2
FIELD_GATE = 1e-6  # BASELINE.md, relative to each field's largest magnitude
INDEX_LIMIT = 2**31  # the kernels index in 32 bits
# BASELINE.json configs[0] through the port's CLI, not cut: 100x33 Q3/Q2
# (73,180 DoFs), Re 20, GMRES + blockDiagonal (the reference's default
# preconditioner), tol 1e-8, default f32 preconditioner
CONFIG1_MESH = (100, 33)
CONFIG1_ARGV = ["-m", "100,33", "-r", "20", "-s", "0", "-p", "0", "-t", "1e-8", "--quiet"]
CONFIG1_METRIC = "stationary_100x33_Re20_GMRES_blockDiagonal_tol1e-8"  # PERF_NORTHSTAR.json
CONFIG1_DOFS = 73_180
CONFIG1_DRAG_RTOL = 1e-6
# card-vs-CPU matrix of the slice's options, all-f64, at 24x10 (the 32x12
# matrix did not fit the time limit).  Left-preconditioned GMRES, BiCGStab
# and aSIMPLE under inexact inner solves are chaotic: a rounding difference
# grows until the stopping iteration moves, and whole solves on the card and
# the CPU end many outers apart.  Those configurations are
# compared as tangent solves capped inside the stretch where the two
# trajectories agree, and run whole on the card alone; the others are
# compared as whole solves.
MATRIX_MESH = (24, 10)
MATRIX = [  # stationary whole solves, card vs CPU: (entry, SolverOptions fields, PrecondConfig fields)
    ("stationary -p 0 Re 30", dict(preconditioner_type=0, Re=30.0), {}),
    ("stationary Re 20 mg_smoother=jacobi", {}, dict(mg_smoother="jacobi")),
    ("stationary Re 20 mg_smoother=schwarz", {}, dict(mg_smoother="schwarz")),
    ("stationary Re 20 inner_mode=fixed", {}, dict(inner_mode="fixed")),
    ("stationary Re 20 multigrid=False", dict(multigrid=False), {}),
]
MATRIX_CARD_ONLY = [  # stationary whole solves on the card: they must converge
    ("stationary -p 2 Re 20 --stokes-schur mass", dict(preconditioner_type=2),
     dict(asimple_stokes_schur="mass")),
    # BiCGStab needs a near-linear preconditioner: with the reference's
    # inexact inner solves it stagnates until rho = <rbar, r> vanishes
    ("stationary -s 2 -p 1 Re 20 (inner rel 1e-6)", dict(solver_type=2, preconditioner_type=1),
     dict(tri_rel_u_stokes=1e-6, tri_rel_p_stokes=1e-6)),
]
MATRIX_TANGENT = {  # capped tangent solves, card vs CPU: (solver, prec, variant, stokes, maxiter, cfg)
    "fgmres aSIMPLE stationary stokes (mass)": (1, 2, "stationary", True, 30, dict(asimple_stokes_schur="mass")),
    "fgmres aSIMPLE stationary newton": (1, 2, "stationary", False, 30, {}),
    "fgmres blockDiagonal unsteady newton": (1, 0, "unsteady", False, 30, {}),
    "fgmres aSIMPLE unsteady newton": (1, 2, "unsteady", False, 30, {}),
    "gmres blockDiagonal stationary stokes": (0, 0, "stationary", True, 30, {}),
    "bicgstab blockTriangular stationary stokes": (2, 1, "stationary", True, 5, {}),
    "bicgstab aSIMPLE unsteady newton": (2, 2, "unsteady", False, 5, {}),
}
MATRIX_FIELD_GATE = 1e-6  # relative to each field's largest magnitude
# the -M simplex path (the reference's mesh path, BASELINE config 3)
SIMPLEX_CHECK_MESH = (24, 10)
SIMPLEX_CHECK = [  # whole runs, card vs CPU, all-f64: (entry, unsteady, SolverOptions fields, PrecondConfig fields)
    ("-M stationary -p 1 Re 20 (p-MG, dense Schur legs)", False, {}, {}),
    ("-M stationary -p 1 Re 20 --direct-lu", False, {}, dict(direct_lu=True)),
    ("-M unsteady -p 1 Re 20, two steps, per-step ramp (iterative Schur legs)", True,
     dict(dense_schur=False), {}),
]
# capped tangent solves, card vs CPU, all-f64, unsteady Newton regime from a
# seeded state: (dense Schur legs, iterations, iterate gate).  The dense legs
# multiply in f32 (the inverses are stored in f32, as in the JAX package), and
# cuBLAS and the CPU's BLAS round differently: f32 rounding from the first
# iteration on (port against JAX package on the CPU, 16x8: 3.3e-6 after 5
# iterations, 1.3e-6 after 30), so their gate is 1e-5.
CPU_SIDE_THREADS = 2  # torch threads of each CPU-side worker process
SIMPLEX_TANGENT = {
    "fgmres blockTriangular unsteady newton, p-MG + dense Schur legs": (True, 30, 1e-5),
    "fgmres blockTriangular unsteady newton, p-MG + iterative Schur legs": (False, 30, 1e-10),
}
# BASELINE config 3: the reference's unsteady script, run_sim_unsteady.sh:21
# (-M -T 0.03,0.01 -t 1e-9 -m 60,40 -s 1 -r 1.0 -p 1), plus the
# Jacobian-consistent continuity sign (with the reference's the Newton loop
# stalls above 1e-9)
CONFIG3_ARGV = ["-M", "-T", "0.03,0.01", "-t", "1e-9", "-m", "60,40", "-s", "1", "-r", "1.0", "-p", "1",
                "--consistent-continuity", "--quiet"]
CONFIG3_DOFS = 21_997
CONFIG3_METRIC = "config3_60x40_re1.0_fused_consistent"  # PERF_NORTHSTAR.json, its 800-step row
CONFIG3_LU_STEPS = 12  # of the record's 800 (the third depth cut, from 20)
CONFIG3_LU_DRAG_RTOL = 1e-5
# simplex-file: a curved-cylinder mesh of the class of the reference's
# new_mesh.msh (117,273 DoFs); 264x49 background points give 116,995 DoFs
SIMPLEX_FILE_GRID = (264, 49)
SIMPLEX_FILE_MIN_DOFS = 100_000
SIMPLEX_FILE_ARGV = ["-T", "0.01,0.01", "-t", "1e-9", "-s", "1", "-r", "1.0", "-p", "1", "--schur", "cahouet",
                     "--consistent-continuity", "--quiet"]
# fused-check: ``solve_fused`` on the card against the CPU, all-f64, FGMRES +
# blockTriangular: (entry, SolverOptions fields, solve_fused keywords).  The
# -M case caps every tangent solve at 40 iterations: whole -M Newton-regime
# solves run past the stretch where card and CPU agree (phase 14), so its
# count gate stands on capped solves
FUSED_CHECK = [
    ("structured 16x8 Q3/Q2 Re 10, tol 1e-8, three steps",
     dict(mesh_size=(16, 8), Re=10.0, tolerance=1e-8, time_span=3 * UNSTEADY_DT),
     dict(newton_max=3, krylov_maxiter=200)),
    ("-M 24x10 Re 1, consistent sign, iterative Schur legs, two steps, tangent solves capped at 40",
     dict(mesh_size=SIMPLEX_CHECK_MESH, read_mesh_from_file=True, Re=1.0, tolerance=1e-9,
          time_span=2 * UNSTEADY_DT, dense_schur=False, consistent_continuity=True),
     dict(newton_max=3, krylov_maxiter=40)),
]
# fused-main: fused steps after phase 9's host step, on its solver and state
FUSED_MAIN_STEPS = 2
# BASELINE config 5 (BASELINE.json configs[4]): the batched Reynolds-sweep
# ensemble at scripts/ensemble_bench.py's defaults -- 60x40 Q2/Q1 (22,103
# DoFs per member), B = 64, Re 20..100 (linspace), dt 0.01, tol 1e-9,
# newton_max 3, krylov_maxiter 200, FGMRES + blockTriangular, Cahouet-Chabard
# with one Lp V-cycle, f32 preconditioner
ENSEMBLE_MESH = (60, 40)
ENSEMBLE_DOFS = 22_103
ENSEMBLE_B = 64
ENSEMBLE_RE = (20.0, 100.0)
ENSEMBLE_STEPS = 2  # timed steps after the warm-up (never cut below 2)
ENSEMBLE_NEWTON_MAX = 3
ENSEMBLE_METRIC = "ensemble_sweep_60x40_B64_tol1e-09_schurcahouet"  # PERF_NORTHSTAR.json: the JAX package's TPU record
# ensemble-check, card vs CPU, all-f64: 16x8 Q2/Q1, B = 3 (Re 20, 60, 100),
# two steps, newton_max 3, tangent solves capped at 20 (tests/test_torch_ensemble.py)
ENSEMBLE_CHECK_MESH = (16, 8)
ENSEMBLE_CHECK_RE = (20.0, 60.0, 100.0)
ENSEMBLE_CHECK_STEPS = 2
# the lid-driven cavity (geometry/cavity.py): Ghia, Ghia & Shin, J. Comput.
# Phys. 48 (1982), Re 100, at 128x128 Q2/Q1 (148,739 DoFs; twice Ghia's 129^2
# grid in each direction) through solve_direct with the options of
# tests/test_cavity.py:111-124, f32 preconditioner, and the Jacobian-consistent
# continuity sign (cavity_solver)
CAVITY_MESH = (128, 128)
CAVITY_DOFS = 148_739
CAVITY_CHAIN = [(128, 128), (64, 64), (32, 32), (16, 16), (8, 8)]
CAVITY_RE = 100.0
GHIA_GATE = 2.5e-2
# Ghia et al. (1982) Table I: u along the vertical centerline x = 0.5, Re 100
# (y, u); Table II: v along the horizontal centerline y = 0.5 (x, v)
GHIA_U = [(1.0000, 1.00000), (0.9766, 0.84123), (0.9688, 0.78871), (0.9609, 0.73722), (0.9531, 0.68717),
          (0.8516, 0.23151), (0.7344, 0.00332), (0.6172, -0.13641), (0.5000, -0.20581), (0.4531, -0.21090),
          (0.2813, -0.15662), (0.1719, -0.10150), (0.1016, -0.06434), (0.0703, -0.04775), (0.0625, -0.04192),
          (0.0547, -0.03717), (0.0000, 0.00000)]
GHIA_V = [(1.0000, 0.00000), (0.9688, -0.05906), (0.9609, -0.07391), (0.9531, -0.08864), (0.9453, -0.10313),
          (0.9063, -0.16914), (0.8594, -0.22445), (0.8047, -0.24533), (0.5000, 0.05454), (0.2344, 0.17527),
          (0.2266, 0.17507), (0.1563, 0.16077), (0.0938, 0.12317), (0.0781, 0.10890), (0.0703, 0.10091),
          (0.0625, 0.09233), (0.0000, 0.00000)]
# cavity-cli: the stationary program's continuation with VTU output
CAVITY_CLI_ARGV = ["--cavity", "-m", "32,32", "-r", "100", "--output", "--quiet"]
# cavity-check: card against CPU, all-f64, with a body force (cavity_force)
CAVITY_CHECK_MESH = (32, 32)
SOURCES = {
    "cell_apply_F": "navier_stokes_solver_tpu_torch/csrc/cell_apply_f.cu",
    "scatter_v_bc": "navier_stokes_solver_tpu_torch/csrc/scatter_v.cu",
}
REPLACES = {
    "cell_apply_F": "navier_stokes_solver_tpu/ops/pallas_cell.py:62",
    # XLA on the TPU (sum of dilated pads, then apply_F's two where), no Pallas kernel
    "scatter_v_bc": "navier_stokes_solver_tpu/ops/matfree.py:91",
}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; needs one CUDA GPU")
    print(f"[device] nvidia-smi: {nvidia_smi()}")
    print(
        f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}"
    )
    return torch.device("cuda", 0)


def phase_build():
    from navier_stokes_solver_tpu_torch import _ext

    t0 = time.perf_counter()
    path, log = _ext.build()
    _ext.load()
    print(f"[build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")) or "error" in line.lower():
            print(f"[build] {line.strip()}")


# ---------------------------------------------------------------------------
# inputs, timing and bounds
# ---------------------------------------------------------------------------


def kernel_case(device, mesh, deg, dtype, seed=0, make_geometry=None):
    """Disc, linearization, velocity lattice and boundary diagonal at one
    shape of the channel (or of ``make_geometry``'s geometry), made from a
    numpy seed: ``(disc, linq, x_u, bc_diag)``."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import Blocks, diag_F, eval_state, make_disc

    geo = (make_geometry or make_channel_geometry)(*mesh)
    disc = make_disc(make_fe_space(geo, *deg), dtype, device)
    rng = np.random.default_rng(seed)
    put = lambda a: torch.as_tensor(a, device=device).to(dtype)
    x = put(rng.standard_normal((2,) + disc.NV))
    st = Blocks(put(0.3 * rng.standard_normal((2,) + disc.NV)), put(rng.standard_normal(disc.NP)))
    linq = eval_state(disc, st)
    return disc, linq, x, diag_F(disc, KERNEL_NU, KERNEL_INV_DT, linq, stokes=False)


def device_ms(fn, n=TIMED_CALLS):
    """Device time per call of ``fn``: CUDA events around ``n`` calls in a
    row, queued behind a sleep kernel that outlasts the host's enqueueing,
    so the card runs them back to back; divided by ``n``.  After warm-up."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * enqueue_s) + 1_000_000)  # ~2x the enqueue time at <= 2 GHz
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, n=HOST_CALLS):
    """Host-inclusive time per call: events around one call, median of
    ``n`` (the card idles while the host launches)."""
    import torch

    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops):
    """(bound in ms, what sets it) on an H100 SXM, f32."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_F32
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def cell_apply_cost(disc, stokes, batch=None):
    """Bytes (each input read once, y written once) and flops of one
    ``cell_apply_F_lattice`` call; ``batch``: B members in one launch --
    the lattice, the linearization, the output and the viscosities are per
    member, ``cell_w`` and the tables are read once for all of them."""
    n_q, n_v = disc.cell_tabs.shape[1:]
    C = disc.nx * disc.ny
    NY, NX = disc.NV
    member = 2 * NY * NX + 2 * n_v * C
    shared = n_q * C + 3 * n_q * n_v
    if stokes:
        flops = C * (16 * n_q * n_v + 8 * n_q)
    else:
        member += 6 * n_q * C
        flops = C * (24 * n_q * n_v + 28 * n_q)
    words = shared + member if batch is None else shared + batch * (member + 1)
    return words * disc.cell_w.element_size(), flops * (batch or 1)


def scatter_cost(disc, with_bc, batch=None):
    """Bytes and flops of one ``scatter_v_bc`` call; ``batch``: B members
    in one launch -- the local contributions, the output, x and the
    diagonal are per member, the two bool masks are read once."""
    n_v = disc.cell_tabs.shape[2]
    NY, NX = disc.NV
    member = 2 * n_v * disc.nx * disc.ny + 2 * NY * NX
    nbytes = 0
    if with_bc:
        member += 4 * NY * NX  # x, diag
        nbytes = 2 * NY * NX  # the two bool masks
    n = batch or 1
    return n * member * disc.cell_w.element_size() + nbytes, n * (2 * n_v * disc.nx * disc.ny + 2 * NY * NX)


# ---------------------------------------------------------------------------
# 3. check
# ---------------------------------------------------------------------------


def kernel_shapes(device):
    """(mesh, degree) pairs: the 100x70, 300x100 and 100x33 Q3/Q2 main
    paths, 20x9 Q2/Q1, and every coarse level of the main paths' multigrid
    chains (each shape once)."""
    fine = [(BENCH_MESH, (3, 2)), ((20, 9), (2, 1)), (UNSTEADY_MESH, (3, 2)), (CONFIG1_MESH, (3, 2))]
    coarse = [s for s in chain_shapes(device) if s not in (BENCH_MESH, UNSTEADY_MESH, CONFIG1_MESH)]
    return fine + [(s, (3, 2)) for s in coarse]


def chain_shapes(device):
    """Every multigrid level of the three main paths, finest first, each
    shape once."""
    shapes = mg_shapes(device, BENCH_MESH) + mg_shapes(device, UNSTEADY_MESH) + mg_shapes(device, CONFIG1_MESH)
    return list(dict.fromkeys(shapes))


def mg_shapes(device, mesh):
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc
    from navier_stokes_solver_tpu_torch.precond.mg import attach_mg, mg_level_shapes

    fine = make_disc(make_fe_space(make_channel_geometry(*mesh), 3, 2), torch.float32, device)
    return mg_level_shapes(attach_mg(fine))


def max_offset(t) -> int:
    """The largest element offset a kernel computes into ``t``'s storage."""
    return sum((n - 1) * st for n, st in zip(t.shape, t.stride()))


def check_shape(device, mesh, deg, dtype, make_geometry=None, label=""):
    """Both kernels against their plain versions at one shape and dtype, in
    both regimes (``cell_apply_F`` through both entry points and a permuted
    lattice layout within ``KERNEL_TOL``, ``scatter_v_bc`` bit for bit,
    with and without the boundary rows), after the 32-bit offset check of
    every operand: returns the largest |kernel - plain| of each."""
    import torch

    from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
        cell_apply_F,
        cell_apply_F_lattice,
        cell_apply_F_lattice_plain,
    )
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    err_a = err_b = 0.0
    disc, linq, x, bc = kernel_case(device, mesh, deg, dtype, make_geometry=make_geometry)
    # the layout a multigrid transfer's einsum hands the kernel
    x_perm = x.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    tol = KERNEL_TOL[str(dtype)[6:]]
    shape = f"{label}{mesh[0]}x{mesh[1]} Q{deg[0]}/Q{deg[1]} {str(dtype)[6:]}"
    views = {"lattice view": lattice_view(x, deg[0], *mesh[::-1]), "permuted view": lattice_view(x_perm, deg[0], *mesh[::-1]), "linq.gradu": linq.gradu, "output": _gather_v(disc, x)}
    offsets = {k: max_offset(v) for k, v in views.items()}
    print(f"[check] {shape}: largest element offsets {json.dumps(offsets)} (32-bit limit {INDEX_LIMIT})")
    if max(offsets.values()) >= INDEX_LIMIT:
        raise RuntimeError(f"an operand at {shape} exceeds the kernels' 32-bit indexing: {offsets}")
    for stokes in (True, False):
        tag = f"{shape} {'stokes' if stokes else 'newton'}"
        args = (disc, KERNEL_NU, KERNEL_INV_DT, None if stokes else linq)
        want = cell_apply_F_lattice_plain(*args, x, stokes=stokes)
        got = {
            "lattice": cell_apply_F_lattice(*args, x, stokes=stokes),
            "lattice, permuted": cell_apply_F_lattice(*args, x_perm, stokes=stokes),
            "gathered": cell_apply_F(*args, _gather_v(disc, x), stokes=stokes),
        }
        torch.cuda.synchronize()
        for entry, g in got.items():
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"cell_apply_F ({entry}): non-finite output at {tag}")
            err = (g - want).abs()
            bad = int((err > tol + tol * want.abs()).sum())
            e = float(err.max())
            err_a = max(err_a, e)
            print(f"[check] cell_apply_F ({entry}) {tag}: max|kernel-plain| {e:.3e} (max|plain| {float(want.abs().max()):.3e}), {bad} entries outside rtol=atol={tol:g}")
            if bad:
                raise RuntimeError(f"cell_apply_F ({entry}) disagrees with its plain version at {tag}")
        for b_, xx, what in ((None, x, "raw"), (bc, x, "bc"), (bc, x_perm, "bc, permuted x")):
            g = scatter_v_bc(disc, want, bc_diag=b_, x_u=xx)
            w = scatter_v_bc_plain(disc, want, bc_diag=b_, x_u=xx)
            e = float((g - w).abs().max())
            err_b = max(err_b, e)
            same = torch.equal(g, w)
            print(f"[check] scatter_v_bc ({what}) {tag}: max|kernel-plain| {e!r}, bitwise equal {same}")
            if e != 0.0 or not same:
                raise RuntimeError(f"scatter_v_bc ({what}) is not bit-identical to its plain version at {tag}")
    return err_a, err_b


def phase_check(device):
    import torch

    err_a = err_b = 0.0
    for mesh, deg in kernel_shapes(device):
        dtypes = (torch.float32, torch.float64) if mesh in (BENCH_MESH, (20, 9), UNSTEADY_MESH, CONFIG1_MESH) else (torch.float32,)
        for dtype in dtypes:
            a, b = check_shape(device, mesh, deg, dtype)
            err_a, err_b = max(err_a, a), max(err_b, b)
    return {"cell_apply_F": err_a, "scatter_v_bc": err_b}


# ---------------------------------------------------------------------------
# 4. time
# ---------------------------------------------------------------------------


def time_shape(device, mesh, deg, make_geometry=None, label=""):
    """Phase 4's records of both kernels at one shape, f32: {kernel: {tag:
    record}} -- each kernel's device time, host-inclusive time, plain
    version's time, library yardstick's time and bound, in both regimes."""
    import torch

    from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
        cell_apply_F_lattice,
        cell_apply_F_lattice_plain,
    )
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    out = {"cell_apply_F": {}, "scatter_v_bc": {}}
    disc, linq, x, bc = kernel_case(device, mesh, deg, torch.float32, make_geometry=make_geometry)
    shape = f"{label}{mesh[0]}x{mesh[1]} Q{deg[0]}/Q{deg[1]} float32"
    for stokes in (True, False):
        args = (disc, KERNEL_NU, KERNEL_INV_DT, None if stokes else linq, x)
        rec = {
            "ms": device_ms(lambda: cell_apply_F_lattice(*args, stokes=stokes)),
            "host_ms": host_ms(lambda: cell_apply_F_lattice(*args, stokes=stokes)),
            "plain_ms": device_ms(lambda: cell_apply_F_lattice_plain(*args, stokes=stokes), PLAIN_CALLS),
            "library_ms": None,
        }
        if stokes:
            # the Stokes element matrix K = nu sum_q w_q (Dx^T Dx + Dy^T Dy)
            # applied to x_loc [n_v, 2C] in one matmul (mask left out)
            _, Dx, Dy = disc.cell_tabs
            K = KERNEL_NU * (Dx.T @ (disc.w_q[:, None] * Dx) + Dy.T @ (disc.w_q[:, None] * Dy))
            xl = _gather_v(disc, x).reshape(K.shape[0], -1)
            rec["library_ms"] = device_ms(lambda: torch.matmul(K, xl))
        rec["bound_ms"], rec["bound_by"] = bound(*cell_apply_cost(disc, stokes))
        tag = f"{shape} {'stokes' if stokes else 'newton'}"
        out["cell_apply_F"][tag] = rec
        print(f"[time] cell_apply_F {tag}: {json.dumps(rec)}")
    loc = cell_apply_F_lattice(disc, KERNEL_NU, KERNEL_INV_DT, linq, x, stokes=False)
    # yardstick: one index_add_ of loc onto the lattice (scatter only,
    # atomics, no boundary rows)
    NY, NX = disc.NV
    idx = lattice_view(torch.arange(2 * NY * NX, device=device).view(2, NY, NX), deg[0], disc.ny, disc.nx)
    idx = idx.reshape(-1)
    acc = torch.zeros(2 * NY * NX, dtype=torch.float32, device=device)
    src = loc.reshape(-1)
    rec = {
        "ms": device_ms(lambda: scatter_v_bc(disc, loc, bc_diag=bc, x_u=x)),
        "host_ms": host_ms(lambda: scatter_v_bc(disc, loc, bc_diag=bc, x_u=x)),
        "plain_ms": device_ms(lambda: scatter_v_bc_plain(disc, loc, bc_diag=bc, x_u=x), PLAIN_CALLS),
        "library_ms": device_ms(lambda: acc.index_add_(0, idx, src)),
    }
    rec["bound_ms"], rec["bound_by"] = bound(*scatter_cost(disc, True))
    tag = f"{shape} bc"
    out["scatter_v_bc"][tag] = rec
    print(f"[time] scatter_v_bc {tag}: {json.dumps(rec)}")
    return out


def phase_time(device):
    """Per kernel: {shape tag: timing record}, f32, at every multigrid
    level of the three main paths."""
    out = {"cell_apply_F": {}, "scatter_v_bc": {}}
    for mesh in chain_shapes(device):
        for name, recs in time_shape(device, mesh, (3, 2)).items():
            out[name].update(recs)
    return out


# ---------------------------------------------------------------------------
# 5. launches per apply_F
# ---------------------------------------------------------------------------


def device_events(prof):
    """The device-side activities (kernels, copies, fills) of a profile."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_call(fn):
    """``(device activities, result, wall seconds)`` of one call of ``fn``.
    The tracer drops the first activities of a trace -- none, one, or (after
    much untraced work) thousands -- so a warm-up call of ``fn`` runs inside
    the trace and is discarded, then ``PROFILE_LEAD`` marker kernels
    (``torch.cuda._sleep``'s ``spin_kernel``), the recorded call and one
    marker.  A trace that lacks every leading or the trailing marker is
    taken again, up to ``PROFILE_ATTEMPTS`` times.  Only the activities
    between the last leading and the trailing marker are returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize()
        events = sorted(device_events(prof), key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if PROFILE_MARKER in e.name]
        if len(marks) >= 2 and marks[-1] == len(events) - 1:
            PROFILE_WINDOWS.append((attempt, PROFILE_LEAD + 1 - len(marks)))
            return events[marks[-2] + 1 : marks[-1]], out, wall
        print(f"[profile] trace {attempt + 1} of {PROFILE_ATTEMPTS} holds {len(marks)} of its {PROFILE_LEAD + 1} "
              f"markers ({len(events)} device activities): taken again")
    raise RuntimeError(f"the profiler dropped the leading or the trailing markers in all {PROFILE_ATTEMPTS} traces")


def phase_launches(device):
    import torch

    from navier_stokes_solver_tpu_torch.ops import apply_F

    disc, linq, x, bc = kernel_case(device, BENCH_MESH, (3, 2), torch.float32)
    for stokes in (True, False):
        call = lambda: apply_F(disc, KERNEL_NU, KERNEL_INV_DT, None if stokes else linq, x, stokes=stokes, bc_diag=bc)
        names = [e.name for e in profile_call(call)[0]]
        print(f"[launches] one apply_F ({'stokes' if stokes else 'newton'}): {len(names)} device kernels: {names}")
        if len(names) != 2 or "cell_apply_f_kernel" not in names[0] or "scatter_v_kernel" not in names[1]:
            raise RuntimeError(f"one apply_F ran {len(names)} device kernels, not the two of ours: {names}")


# ---------------------------------------------------------------------------
# 6. main, 7. outer
# ---------------------------------------------------------------------------


def bench_options(device):
    from navier_stokes_solver_tpu_torch.api import SolverOptions
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    return SolverOptions(
        mesh_size=BENCH_MESH,
        degree_velocity=3,
        degree_pressure=2,
        Re=100.0,
        solver_type=1,  # FGMRES
        tolerance=1e-12,
        preconditioner_type=1,  # blockTriangular
        verbose=False,
        krylov_basis=60,
        skip_futile_stokes=True,
        precond_config=PrecondConfig(
            krylov_cycle_dtype="float32", tri_rel_u_stokes=1e-4, tri_rel_p_stokes=1e-4
        ),
        device=device,
    )


def counters():
    from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc

    return {"cell_apply_F": cell_apply_F, "scatter_v_bc": scatter_v_bc}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0
        fn.launches_by_shape.clear()


def read_counts():
    return {
        name: {"launches": fn.launches, "by_shape": {" ".join(map(str, k)): v for k, v in sorted(fn.launches_by_shape.items())}}
        for name, fn in counters().items()
    }


def run_solve(device, ref):
    import numpy as np

    from navier_stokes_solver_tpu_torch.api import NSSolverStationary

    reset_counts()
    s = NSSolverStationary(bench_options(device)).setup()
    t0 = time.perf_counter()
    s.solve_newton()
    wall = time.perf_counter() - t0
    counts = read_counts()
    s.compute_lift_drag()
    s.compute_drag_coeff()
    s.compute_lift_coeff()
    total = sum(h.get("krylov_iters", 0) for h in s.history)
    u, p = s.fields()
    print(f"[main] n_dofs {s.n_dofs}, setup {s.setup_seconds:.3f} s, solve_newton wall {wall!r} s")
    print(f"[main] phases {json.dumps(s.timer.summary())}")
    print(f"[main] outer Krylov iterations {total} (reference {ref['total_krylov_iters']}, difference {total - ref['total_krylov_iters']:+d}) over {s.timer.counts['krylov_solve']} krylov_solve calls; history entries {len(s.history)}")
    print(f"[main] per solve {[h.get('krylov_iters') for h in s.history]}")
    print(f"[main] drag coefficient {s.drag_coeff!r} (reference {ref['drag_coeff']!r}, rel diff {abs(s.drag_coeff - ref['drag_coeff']) / abs(ref['drag_coeff']):.3e}), lift coefficient {s.lift_coeff!r}")
    print(f"[main] launches {json.dumps(counts)}")
    if s.n_dofs != ref["n_dofs"]:
        raise RuntimeError(f"DoF count {s.n_dofs} != {ref['n_dofs']}")
    if u.shape != (2,) + s.disc.NV or p.shape != s.disc.NP or not (np.isfinite(u).all() and np.isfinite(p).all()):
        raise RuntimeError("solution fields are not finite or have the wrong shape")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise RuntimeError(f"the main path never launched {name}")
    if not abs(s.drag_coeff - ref["drag_coeff"]) <= DRAG_RTOL * abs(ref["drag_coeff"]):
        raise RuntimeError(f"drag coefficient {s.drag_coeff!r} is not within rtol {DRAG_RTOL} of {ref['drag_coeff']!r}")
    if total > 2 * BENCH_OUTER_ITERS:
        raise RuntimeError(f"{total} outer iterations exceed 2 x {BENCH_OUTER_ITERS}")
    return s, {"wall_s": wall, "outer": total, "drag": s.drag_coeff, "counts": counts}


def outer_profile(s, stokes, iters=OUTER_WINDOW):
    """Device kernels, device ms, wall ms and host readbacks (device-to-host
    copies) per outer FGMRES iteration of one tangent solve of solver ``s``
    at its current state: profiler windows of a 1-iteration and a
    (1 + ``iters``)-iteration solve (tolerance 0, so neither stops early),
    differenced so that the per-solve set-up cancels."""
    from navier_stokes_solver_tpu_torch.api import kernels
    from navier_stokes_solver_tpu_torch.ops import Blocks

    disc, o = s.disc, s.options
    rhs, _ = kernels.assemble_kernel(
        s.disc_nomg, s.nu, s.inv_dt, s.solution, s.solution_old.u, 0.0,
        stokes=stokes, consistent=o.consistent_continuity,
    )
    zero = Blocks(disc.zeros_u(), disc.zeros_p())

    def solve(n):
        return kernels.solve_kernel(
            disc, s.nu, s.inv_dt, s.solution, rhs, zero, 0.0, 0.0, stokes=stokes,
            solver_type=o.solver_type, prec_type=o.preconditioner_type,
            variant=s.VARIANT, maxiter=n, precond_cfg=o.precond_config,
            basis=o.krylov_basis,
        )

    return profile_solve(solve, iters)


def profile_solve(solve, iters=OUTER_WINDOW):
    """Per outer iteration of ``solve(n)`` (a tangent solve of ``n``
    iterations at tolerance 0): profiler windows of ``n`` = 1 and 1 +
    ``iters``, differenced.  An ensemble's solve counts its iterations per
    member: the windows take the largest."""
    import numpy as np

    ours = {"cell_apply_F": "cell_apply_f_kernel", "scatter_v_bc": "scatter_v_kernel"}
    win, by_name = {}, {}
    for n in (1, 1 + iters):
        ev, (_, info), wall = profile_call(lambda: solve(n))
        by_name[n] = {}
        for e in ev:
            by_name[n][e.name] = by_name[n].get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        win[n] = {
            "iters": int(np.max(info.iters)),
            "kernels": len(ev),
            "device_ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3,
            "wall_ms": 1e3 * wall,
            "readbacks": sum("DtoH" in e.name for e in ev),
            "ours_ms": sum(e.time_range.elapsed_us() for e in ev if any(k in e.name for k in ours.values())) / 1e3,
            **{name: sum(k in e.name for e in ev) for name, k in ours.items()},
        }
    a, b = win[1], win[1 + iters]
    d = b["iters"] - a["iters"]
    keys = ("kernels", "device_ms", "wall_ms", "readbacks", "ours_ms", *ours)
    per = {k: (b[k] - a[k]) / d for k in keys}
    per["busy"] = per["device_ms"] / per["wall_ms"]
    per["ours_share"] = per["ours_ms"] / per["device_ms"]
    per["outer_iterations"] = d
    ms = {k: (v - by_name[1].get(k, 0.0)) / d for k, v in by_name[1 + iters].items()}
    per["top_device_ops_ms"] = [(k[:100], v) for k, v in sorted(ms.items(), key=lambda kv: -kv[1])[:10]]
    return per


def phase_outer(s, regimes=(False, True), tag="outer"):
    out = {}
    for stokes in regimes:
        regime = "stokes" if stokes else "newton"
        per = outer_profile(s, stokes)
        out[regime] = per
        print(f"[{tag}] per outer iteration, {regime} regime at the converged state (profiled): {json.dumps(per)}")
    return out


# ---------------------------------------------------------------------------
# 8. unsteady-check, 9. unsteady-main
# ---------------------------------------------------------------------------


def unsteady_solver(device, mesh, Re, steps, cfg, *, consistent=False):
    from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions

    return NSSolver(SolverOptions(
        mesh_size=mesh,
        degree_velocity=3,
        degree_pressure=2,
        Re=Re,
        solver_type=1,  # FGMRES
        tolerance=1e-9,
        preconditioner_type=1,  # blockTriangular
        krylov_basis=30,
        time_step=UNSTEADY_DT,
        time_span=steps * UNSTEADY_DT,
        verbose=False,
        precond_config=cfg,
        consistent_continuity=consistent,
        device=device,
    )).setup()


def _history(s):
    return s["history"] if isinstance(s, dict) else s.history


def solves_of(s):
    return [h for h in _history(s) if h["phase"] != "step"]


def steps_of(s):
    return [h for h in _history(s) if h["phase"] == "step"]


def fused_steps(s, entries, tag):
    """Per-step records of ``solve_fused`` history entries (wall, Newton
    iterations, outers, final Newton residual, coefficients), printed."""
    ua = s.get_avg_inlet_velocity()
    coeff = lambda f: 2.0 * f / (ua * ua * 0.1)
    steps = []
    for h in entries:
        rec = {
            "step": h["step"], "wall_s": h["seconds"], "newton_iterations": h["newton_iters"],
            "outer": h["krylov_iters"], "newton_residual": h["newton_residual"],
            "drag_coeff": coeff(h["drag_force"]), "lift_coeff": coeff(h["lift_force"]),
        }
        steps.append(rec)
        print(f"[{tag}] fused step {json.dumps(rec)}")
    return steps


def step_report(s, tag):
    """Per-step records of an unsteady run (wall, Newton iterations, outers
    per tangent solve, final Newton residual, coefficients), printed."""
    if s.options.fused:
        return fused_steps(s, [h for h in steps_of(s) if "seconds" in h], tag)
    steps = []
    for h in steps_of(s):
        sv = [x for x in solves_of(s) if x["time"] == h["time"]]
        rec = {
            "step": h["step"], "wall_s": h["seconds"], "newton_iterations": len(sv),
            "outer_per_solve": [(x["phase"], x["krylov_iters"]) for x in sv],
            "outer": sum(x["krylov_iters"] for x in sv),
            "newton_residual": h["newton_residual"],
            "drag_coeff": h["drag_coeff"], "lift_coeff": h["lift_coeff"],
        }
        steps.append(rec)
        print(f"[{tag}] step {json.dumps(rec)}")
    return steps


def check_steps(s, steps, tag):
    """Fields finite and of the disc's shape; every step's Newton residual
    <= the Newton tolerance; finite coefficients."""
    import numpy as np

    u, p = s.fields()
    if u.shape != (2,) + s.disc.NV or p.shape != s.disc.NP or not (np.isfinite(u).all() and np.isfinite(p).all()):
        raise RuntimeError(f"{tag}: fields are not finite or have the wrong shape")
    for rec in steps:
        if not rec["newton_residual"] <= s.NEWTON_TOL:
            raise RuntimeError(f"{tag}: step {rec['step']} ended with Newton residual {rec['newton_residual']!r} > {s.NEWTON_TOL}")
        if not (np.isfinite(rec["drag_coeff"]) and np.isfinite(rec["lift_coeff"])):
            raise RuntimeError(f"{tag}: step {rec['step']}: non-finite coefficient")


def unsteady_check_run(device):
    """The unsteady check's run on one device, as plain data: history, host
    fields, wall."""
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    cfg = PrecondConfig(schur_mode="cahouet", vmult_dtype=None, mg_dtype=None)
    s = unsteady_solver(device, CHECK_MESH, CHECK_RE, CHECK_STEPS, cfg)
    t0 = time.perf_counter()
    s.solve()
    return {"history": s.history, "fields": s.fields(), "wall_s": time.perf_counter() - t0}


def phase_unsteady_check(device, cpu_side):
    """The per-step ramp path on the card against the same run on the CPU
    (``cpu_side``: the future of ``cpu_job("unsteady-check")``)."""
    import numpy as np

    runs = {"card": unsteady_check_run(device), "cpu": cpu_side.result()}
    for where, s in runs.items():
        print(f"[unsteady-check] {CHECK_MESH[0]}x{CHECK_MESH[1]} Re {CHECK_RE} on the {where}: solve wall {s['wall_s']!r} s, per solve {[(h['phase'], h['nu'], h['n_iter'], h['krylov_iters']) for h in solves_of(s)]}")
    g, c = runs["card"], runs["cpu"]
    key = lambda h: (h["phase"], h["nu"], h["n_iter"])
    if [key(h) for h in solves_of(g)] != [key(h) for h in solves_of(c)]:
        raise RuntimeError("unsteady-check: the card's Newton history differs from the CPU's")
    diffs = [hg["krylov_iters"] - hc["krylov_iters"] for hg, hc in zip(solves_of(g), solves_of(c))]
    print(f"[unsteady-check] Krylov counts card - CPU per solve {diffs}: {'equal' if not any(diffs) else 'within 1' if max(map(abs, diffs)) <= 1 else 'DIFFERENT'}")
    if any(abs(d) > 1 for d in diffs):
        raise RuntimeError(f"unsteady-check: Krylov counts differ by more than 1: {diffs}")
    for hg, hc in zip(steps_of(g), steps_of(c)):
        for k in ("drag_coeff", "lift_coeff"):
            # the lift of this symmetric-inlet mesh is rounding: floor at the drag
            err, floor = abs(hg[k] - hc[k]), 1e-7 * abs(hc["drag_coeff"])
            print(f"[unsteady-check] step {hg['step']} {k}: card {hg[k]!r}, CPU {hc[k]!r}, |diff| {err:.3e}")
            if not err <= max(1e-7 * abs(hc[k]), floor if k == "lift_coeff" else 0.0):
                raise RuntimeError(f"unsteady-check: {k} at step {hg['step']} outside rtol 1e-7")
    for name, a, b in zip(("velocity", "pressure"), g["fields"], c["fields"]):
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"[unsteady-check] {name}: max|card - CPU| {err:.3e} (max|CPU| {scale:.3e})")
        if not err <= FIELD_GATE * scale:
            raise RuntimeError(f"unsteady-check: {name} fields differ by {err} > {FIELD_GATE} x {scale}")


def phase_unsteady_main(device):
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    cfg = PrecondConfig(schur_mode="cahouet", cc_lp_cycles=1)
    reset_counts()
    # The Jacobian-consistent continuity sign: with the reference's sign the
    # iterate's divergence doubles on every accepted full Newton step and
    # the step stalls above the 1e-9 tolerance (docs/PERF.md, "x2-per-step")
    s = unsteady_solver(device, UNSTEADY_MESH, 100.0, UNSTEADY_STEPS, cfg, consistent=True)
    t0 = time.perf_counter()
    s.solve(direct=True)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"[unsteady-main] {UNSTEADY_MESH[0]}x{UNSTEADY_MESH[1]} Q3/Q2 Re 100, n_dofs {s.n_dofs}, setup {s.setup_seconds:.3f} s, solve wall {wall!r} s over {len(steps_of(s))} steps")
    steps = step_report(s, "unsteady-main")
    print(f"[unsteady-main] phases {json.dumps(s.timer.summary())}")
    print(f"[unsteady-main] launches {json.dumps(counts)}")
    if s.n_dofs != UNSTEADY_DOFS:
        raise RuntimeError(f"DoF count {s.n_dofs} != {UNSTEADY_DOFS}")
    check_steps(s, steps, "unsteady-main")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise RuntimeError(f"the unsteady path never launched {name}")
    return s, {"wall_s": wall, "steps": steps, "counts": counts}


# ---------------------------------------------------------------------------
# 12. config1, 13. matrix, 14. profile
# ---------------------------------------------------------------------------


def northstar(metric, n_steps=None):
    """The ``PERF_NORTHSTAR.json`` record (one JSON object per line) of
    ``metric`` (the one of ``n_steps`` time steps, when given)."""
    with open(os.path.join(ROOT, "PERF_NORTHSTAR.json")) as f:
        for line in f:
            rec = json.loads(line) if line.strip() else {}
            if rec.get("metric") == metric and n_steps in (None, rec["extra"].get("n_steps")):
                return rec
    raise RuntimeError(f"PERF_NORTHSTAR.json has no {metric!r} record of {n_steps} steps")


def phase_config1(device):
    """BASELINE config 1 through the port's CLI, in this process (so the
    launch counts read): counts zeroed just before, read just after."""
    import numpy as np

    from navier_stokes_solver_tpu_torch.cli import stationary as cli

    ref = northstar(CONFIG1_METRIC)["extra"]
    argv = CONFIG1_ARGV + ["--device", str(device)]
    reset_counts()
    s = cli.run(argv)
    counts = read_counts()
    per_solve = [h.get("krylov_iters") for h in s.history]
    total = sum(x or 0 for x in per_solve)
    u, p = s.fields()
    rel = abs(s.drag_coeff - ref["drag_coeff"]) / abs(ref["drag_coeff"])
    print(f"[config1] cli.stationary {' '.join(argv)}: n_dofs {s.n_dofs}, setup {s.setup_seconds:.3f} s, solve wall {s.solve_seconds!r} s")
    print(f"[config1] phases {json.dumps(s.timer.summary())}")
    print(f"[config1] outer iterations {total} (JAX package on the TPU {ref['total_krylov_iters']}, gate 2 x that) over {s.timer.counts['krylov_solve']} tangent solves; per solve {per_solve}")
    print(f"[config1] drag coefficient {s.drag_coeff!r} (recorded {ref['drag_coeff']!r}, rel diff {rel:.3e}, gate {CONFIG1_DRAG_RTOL:g}), lift coefficient {s.lift_coeff!r}")
    print(f"[config1] launches {json.dumps(counts)}")
    if s.n_dofs != CONFIG1_DOFS:
        raise RuntimeError(f"config1: DoF count {s.n_dofs} != {CONFIG1_DOFS}")
    if u.shape != (2,) + s.disc.NV or p.shape != s.disc.NP or not (np.isfinite(u).all() and np.isfinite(p).all()):
        raise RuntimeError("config1: solution fields are not finite or have the wrong shape")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise RuntimeError(f"config1 never launched {name}")
    if not rel <= CONFIG1_DRAG_RTOL:
        raise RuntimeError(f"config1: drag coefficient {s.drag_coeff!r} not within rtol {CONFIG1_DRAG_RTOL} of {ref['drag_coeff']!r}")
    if total > 2 * ref["total_krylov_iters"]:
        raise RuntimeError(f"config1: {total} outer iterations exceed 2 x {ref['total_krylov_iters']}")
    return s, {"wall_s": s.solve_seconds, "setup_s": s.setup_seconds, "outer": total, "per_solve": per_solve, "drag": s.drag_coeff, "counts": counts}


def matrix_run(device, fields, cfg):
    """One matrix entry's whole stationary solve on one device, as plain
    data: history, host fields, (drag, lift), wall."""
    from navier_stokes_solver_tpu_torch.api import NSSolverStationary, SolverOptions
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    t0 = time.perf_counter()
    o = dict(
        mesh_size=MATRIX_MESH, degree_velocity=3, degree_pressure=2, Re=20.0, solver_type=1,
        verbose=False, device=device, tolerance=1e-8, skip_futile_stokes=True,
        precond_config=PrecondConfig(vmult_dtype=None, mg_dtype=None, **cfg),
    )
    s = NSSolverStationary(SolverOptions(**{**o, **fields})).setup()
    s.solve_newton()
    s.compute_lift_drag()
    s.compute_drag_coeff()
    s.compute_lift_coeff()
    forces = [(s.drag_coeff, s.lift_coeff)]
    return {"history": s.history, "fields": s.fields(), "forces": forces, "wall_s": time.perf_counter() - t0}


def phase_matrix(device, cpu_side):
    """``MATRIX`` on the card and on the CPU (the plain versions; ``cpu_side``:
    the future of ``cpu_job("matrix")``), all-f64: Newton histories equal,
    Krylov counts per solve within 1, drag and lift within rtol 1e-7 (the
    lift floored at 1e-7 of the drag), fields within 1e-6 of their
    magnitude.  Then ``MATRIX_TANGENT`` (card vs CPU) and
    ``MATRIX_CARD_ONLY``."""
    import numpy as np

    key = lambda h: (h["phase"], h["nu"], h["n_iter"])
    t_all = time.perf_counter()
    card = [matrix_run(device, fields, cfg) for _, fields, cfg in MATRIX]
    card_tangent = matrix_tangent_run(device)
    cpu, cpu_tangent = cpu_side.result()
    for (name, _, _), g, c in zip(MATRIX, card, cpu):
        gf, cf = g["forces"], c["forces"]
        sg, sc = solves_of(g), solves_of(c)
        counts = [(hg.get("krylov_iters", 0), hc.get("krylov_iters", 0)) for hg, hc in zip(sg, sc)]
        print(f"[matrix] {name}: walls card {g['wall_s']:.2f} s, CPU {c['wall_s']:.2f} s; Krylov counts (card, CPU) per solve {counts}")
        if [key(h) for h in sg] != [key(h) for h in sc]:
            raise RuntimeError(f"matrix {name}: the card's Newton history differs from the CPU's")
        if any(abs(a - b) > 1 for a, b in counts):
            raise RuntimeError(f"matrix {name}: Krylov counts {counts} differ by more than 1")
        for (dg, lg), (dc, lc) in zip(gf, cf):
            print(f"[matrix] {name}: drag card {dg!r} CPU {dc!r} (|diff| {abs(dg - dc):.3e}); lift card {lg!r} CPU {lc!r} (|diff| {abs(lg - lc):.3e})")
            if not (abs(dg - dc) <= 1e-7 * abs(dc) and abs(lg - lc) <= 1e-7 * max(abs(lc), abs(dc))):
                raise RuntimeError(f"matrix {name}: drag/lift outside rtol 1e-7")
        for field, a, b in zip(("velocity", "pressure"), g["fields"], c["fields"]):
            err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
            print(f"[matrix] {name}: {field} max|card - CPU| {err:.3e} (max|CPU| {scale:.3e})")
            if not err <= MATRIX_FIELD_GATE * scale:
                raise RuntimeError(f"matrix {name}: {field} differs by {err} > {MATRIX_FIELD_GATE} x {scale}")
    for (name, (_, _, _, _, n, _)), (gi, gf, gr, gx), (ci, cf, cr, cx) in zip(MATRIX_TANGENT.items(), card_tangent, cpu_tangent):
        err = max(float(np.abs(a - b).max()) / float(np.abs(b).max()) for a, b in zip(gx, cx))
        print(f"[matrix] tangent {name}: iterations card {gi} CPU {ci}, residual card {gr!r} CPU {cr!r}, iterate rel diff {err:.3e}")
        if (gi, gf) != (ci, cf) or gi != n:
            raise RuntimeError(f"matrix tangent {name}: iterations/flags differ: card {(gi, gf)}, CPU {(ci, cf)}")
        if not (abs(gr - cr) <= 1e-10 * abs(cr) and err <= 1e-10):
            raise RuntimeError(f"matrix tangent {name}: card and CPU differ beyond 1e-10")
    for name, fields, cfg in MATRIX_CARD_ONLY:
        run = matrix_run(device, fields, cfg)
        (u, p), forces = run["fields"], run["forces"]
        counts = [h.get("krylov_iters", 0) for h in solves_of(run)]
        print(f"[matrix] {name} (card only): wall {run['wall_s']:.2f} s, Krylov counts per solve {counts}, drag and lift {forces}")
        if not (np.isfinite(u).all() and np.isfinite(p).all() and np.isfinite(forces).all()) or sum(counts) <= 0:
            raise RuntimeError(f"matrix {name}: no finite converged solve on the card")
    print(f"[matrix] {len(MATRIX)} whole-solve entries, {len(MATRIX_TANGENT)} tangent solves and {len(MATRIX_CARD_ONLY)} card-only solves at {MATRIX_MESH[0]}x{MATRIX_MESH[1]} in {time.perf_counter() - t_all:.1f} s")


def matrix_tangent_run(device):
    """Each ``MATRIX_TANGENT`` solve (``api.kernels.solve_kernel``: method,
    preconditioner and initial-guess projection) from one seeded state on
    one device, capped at ``maxiter`` (tol 1e-14 stops none): a list of
    (iterations, failed, residual norm, host iterate)."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.api import kernels
    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import Blocks, make_disc
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig, attach_mg

    d = attach_mg(make_disc(make_fe_space(make_channel_geometry(*MATRIX_MESH), 3, 2), torch.float64, device))
    rng = np.random.default_rng(1)
    u = 0.3 * rng.standard_normal((2,) + d.NV) * d.u_active.cpu().numpy()
    p = rng.standard_normal(d.NP) * d.p_active.cpu().numpy()
    st = Blocks(torch.as_tensor(u, device=device), torch.as_tensor(p, device=device))
    nu = 1.0 / 20.0
    out = []
    for solver, prec, variant, stokes, n, cfg in MATRIX_TANGENT.values():
        inv_dt = 1.0 / UNSTEADY_DT if variant == "unsteady" else 0.0
        rhs, _ = kernels.assemble_kernel(d, nu, inv_dt, st, st.u, 0.0, stokes=stokes)
        x, info = kernels.solve_kernel(
            d, nu, inv_dt, st, rhs, st, 0.0, 1e-14, stokes=stokes, solver_type=solver,
            prec_type=prec, variant=variant, maxiter=n,
            precond_cfg=PrecondConfig(vmult_dtype=None, mg_dtype=None, **cfg),
        )
        out.append((info.iters, info.failed, info.resnorm, [a.cpu().numpy() for a in x]))
    return out


def phase_profile(device):
    """A small CLI solve with ``--profile-dir``: the trace file must exist
    and name both kernels.  Written under the git-ignored ``_chip/`` and
    removed after the check."""
    import shutil

    from navier_stokes_solver_tpu_torch.cli import stationary as cli
    from navier_stokes_solver_tpu_torch.obs import TRACE_FILE

    d = os.path.join(ROOT, "_chip", "profile")
    for attempt in range(PROFILE_ATTEMPTS):  # the tracer can drop a window (``profile_call``)
        shutil.rmtree(d, ignore_errors=True)
        cli.run(["-m", "16,8", "-r", "20", "-p", "1", "-t", "1e-1", "--direct", "--quiet", "--profile-dir", d,
                 "--device", str(device)])
        path = os.path.join(d, TRACE_FILE)
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        size = os.path.getsize(path)
        shutil.rmtree(d)
        found = {k: any(k in n for n in names) for k in ("cell_apply_f_kernel", "scatter_v_kernel")}
        print(f"[profile] --profile-dir trace {size} bytes, {len(names)} distinct event names; kernels found {json.dumps(found)}")
        if all(found.values()):
            return
    raise RuntimeError(f"the --profile-dir trace does not name both kernels in {PROFILE_ATTEMPTS} runs: {found}")


# ---------------------------------------------------------------------------
# 14. simplex-check, 15. config3, 16. config3-lu, 17. simplex-file
# ---------------------------------------------------------------------------


def simplex_run(device, unsteady, fields, cfg):
    """One ``-M`` run at ``SIMPLEX_CHECK_MESH``, Re 20, FGMRES +
    blockTriangular, all-f64 -- the stationary continuation (tol 1e-8) or
    two unsteady steps with the per-step ramp (tol 1e-9) -- as plain data:
    DoFs, history, host fields, (drag, lift) per solve or step."""
    from navier_stokes_solver_tpu_torch.api import NSSolver, NSSolverStationary, SolverOptions
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    o = dict(
        mesh_size=SIMPLEX_CHECK_MESH, read_mesh_from_file=True, Re=20.0, solver_type=1,
        preconditioner_type=1, verbose=False, device=device,
        precond_config=PrecondConfig(vmult_dtype=None, mg_dtype=None, **cfg),
    )
    if unsteady:
        s = NSSolver(SolverOptions(**o, tolerance=1e-9, time_span=2 * UNSTEADY_DT, time_step=UNSTEADY_DT,
                                   **fields)).setup()
        s.solve()
        forces = [(h["drag_coeff"], h["lift_coeff"]) for h in steps_of(s)]
    else:
        s = NSSolverStationary(SolverOptions(**o, tolerance=1e-8, **fields)).setup()
        s.solve_newton()
        s.compute_lift_drag()
        s.compute_drag_coeff()
        s.compute_lift_coeff()
        forces = [(s.drag_coeff, s.lift_coeff)]
    return {"n_dofs": s.n_dofs, "history": s.history, "fields": s.fields(), "forces": forces}


def simplex_tangent_run(device, dense, n):
    """One ``SIMPLEX_TANGENT`` solve (``api.kernels.solve_kernel``) from a
    seeded state on the -M disc, capped at ``n`` iterations (tol 1e-14
    stops none): (iterations, failed, residual norm, host iterate)."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.api import kernels
    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry
    from navier_stokes_solver_tpu_torch.ops import Blocks
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig
    from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc, triangulate_channel
    from navier_stokes_solver_tpu_torch.unstructured.dense import attach_dense_schur

    mesh = triangulate_channel(make_channel_geometry(*SIMPLEX_CHECK_MESH))
    nu, inv_dt = 1.0 / 20.0, 1.0 / UNSTEADY_DT
    d = make_simplex_disc(*mesh, dtype=torch.float64, device=device).replace(p_mg=True)
    if dense:
        d = attach_dense_schur(d)
    rng = np.random.default_rng(1)
    put = lambda a: torch.as_tensor(a, device=device)
    st = Blocks(put(0.3 * rng.standard_normal((2, d.n_nodes_v))), put(rng.standard_normal(d.n_nodes_p)))
    rhs, _ = kernels.assemble_kernel(d, nu, inv_dt, st, st.u, 0.0, stokes=False)
    x, info = kernels.solve_kernel(
        d, nu, inv_dt, st, rhs, st, 0.0, 1e-14, stokes=False, solver_type=1, prec_type=1,
        variant="unsteady", maxiter=n, precond_cfg=PrecondConfig(vmult_dtype=None, mg_dtype=None),
    )
    return info.iters, info.failed, info.resnorm, [a.cpu().numpy() for a in x]


def cpu_job(name):
    """The CPU side of one card-vs-CPU phase -- "unsteady-check", "matrix",
    "simplex-check", "fused-check", "ensemble-check" or "cavity-check" -- as
    plain data, for a worker process."""
    import torch

    torch.set_num_threads(CPU_SIDE_THREADS)
    cpu = torch.device("cpu")
    if name == "unsteady-check":
        return unsteady_check_run(cpu)
    if name == "matrix":
        return [matrix_run(cpu, f, c) for _, f, c in MATRIX], matrix_tangent_run(cpu)
    if name == "simplex-check":
        return (
            [simplex_run(cpu, unsteady, fields, cfg) for _, unsteady, fields, cfg in SIMPLEX_CHECK],
            [simplex_tangent_run(cpu, dense, n) for dense, n, _ in SIMPLEX_TANGENT.values()],
        )
    if name == "fused-check":
        return [fused_run(cpu, fields, kw) for _, fields, kw in FUSED_CHECK]
    if name == "ensemble-check":
        return ensemble_check_run(cpu)
    if name == "cavity-check":
        return cavity_check_run(cpu)
    raise ValueError(f"no CPU side named {name!r}")


def cpu_pool(workers):
    """Spawned worker processes for ``cpu_job`` (joined when the ``with``
    block that holds the pool ends)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def phase_simplex_check(device, cpu_side=None):
    """``SIMPLEX_CHECK`` and ``SIMPLEX_TANGENT`` on the card against the same
    on the CPU (``cpu_side``: the future of ``cpu_job("simplex-check")``; by
    default one worker process started here)."""
    import numpy as np

    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_simplex_check(device, pool.submit(cpu_job, "simplex-check"))
    key = lambda h: (h["phase"], h["nu"], h["n_iter"])
    t_all = time.perf_counter()
    card, walls = [], []
    for _, unsteady, fields, cfg in SIMPLEX_CHECK:
        t0 = time.perf_counter()
        card.append(simplex_run(device, unsteady, fields, cfg))
        walls.append(time.perf_counter() - t0)
    card_tangent = [simplex_tangent_run(device, dense, n) for dense, n, _ in SIMPLEX_TANGENT.values()]
    t_card = time.perf_counter() - t_all
    cpu, cpu_tangent = cpu_side.result()
    print(f"[simplex-check] card side {t_card:.1f} s; waited {time.perf_counter() - t_all - t_card:.1f} s more for the CPU side (worker process, {CPU_SIDE_THREADS} threads)")
    for (name, unsteady, _, _), g, c, wall in zip(SIMPLEX_CHECK, card, cpu, walls):
        sg, sc = solves_of(g), solves_of(c)
        counts = [(hg["krylov_iters"], hc["krylov_iters"]) for hg, hc in zip(sg, sc)]
        print(f"[simplex-check] {name}: {g['n_dofs']} DoFs; card wall {wall:.2f} s; Krylov counts (card, CPU) per solve {counts}")
        if [key(h) for h in sg] != [key(h) for h in sc]:
            raise RuntimeError(f"simplex-check {name}: the card's Newton history differs from the CPU's")
        if not unsteady and any(abs(a - b) > 1 for a, b in counts):
            raise RuntimeError(f"simplex-check {name}: Krylov counts {counts} differ by more than 1")
        for (dg, lg), (dc, lc) in zip(g["forces"], c["forces"]):
            print(f"[simplex-check] {name}: drag card {dg!r} CPU {dc!r} (|diff| {abs(dg - dc):.3e}); lift card {lg!r} CPU {lc!r} (|diff| {abs(lg - lc):.3e})")
            if not (abs(dg - dc) <= 1e-7 * abs(dc) and abs(lg - lc) <= 1e-7 * max(abs(lc), abs(dc))):
                raise RuntimeError(f"simplex-check {name}: drag/lift outside rtol 1e-7")
        for field, a, b in zip(("velocity", "pressure"), g["fields"], c["fields"]):
            err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
            print(f"[simplex-check] {name}: {field} max|card - CPU| {err:.3e} (max|CPU| {scale:.3e})")
            if not err <= FIELD_GATE * scale:
                raise RuntimeError(f"simplex-check {name}: {field} differs by {err} > {FIELD_GATE} x {scale}")
    for (name, (_, n, gate)), (gi, gf, gr, gx), (ci, cf, cr, cx) in zip(SIMPLEX_TANGENT.items(), card_tangent, cpu_tangent):
        err = max(float(np.abs(a - b).max()) / float(np.abs(b).max()) for a, b in zip(gx, cx))
        print(f"[simplex-check] tangent {name}, capped at {n} iterations: iterations card {gi} CPU {ci}, residual card {gr!r} CPU {cr!r}, iterate rel diff {err:.3e} (gate {gate:g})")
        if (gi, gf) != (ci, cf) or gi != n:
            raise RuntimeError(f"simplex tangent {name}: iterations/flags differ: card {(gi, gf)}, CPU {(ci, cf)}")
        if not (abs(gr - cr) <= gate * abs(cr) and err <= gate):
            raise RuntimeError(f"simplex tangent {name}: card and CPU differ beyond {gate}")
    print(f"[simplex-check] {len(SIMPLEX_CHECK)} whole runs and {len(SIMPLEX_TANGENT)} capped tangent solves at -M {SIMPLEX_CHECK_MESH[0]}x{SIMPLEX_CHECK_MESH[1]} in {time.perf_counter() - t_all:.1f} s")


def unsteady_cli(device, argv, tag):
    """One run of ``cli.unsteady.run`` on the card, kernel counts zeroed just
    before and read just after; prints the setup, the walls and the steps."""
    from navier_stokes_solver_tpu_torch.cli import unsteady as cli

    argv = argv + ["--device", str(device)]
    reset_counts()
    s = cli.run(argv)
    counts = read_counts()
    print(f"[{tag}] cli.unsteady {' '.join(argv)}: n_dofs {s.n_dofs} ({s.disc.n_nodes_p} pressure nodes, {s.disc.n_tri} triangles), setup {s.setup_seconds:.3f} s, time loop {s.solve_seconds!r} s over {len(steps_of(s))} steps")
    steps = step_report(s, tag)
    print(f"[{tag}] phases {json.dumps(s.timer.summary())}")
    print(f"[{tag}] launches of the hand-written kernels (this path runs none) {json.dumps(counts)}")
    check_steps(s, steps, tag)
    return s, {"wall_s": s.solve_seconds, "setup_s": s.setup_seconds, "steps": steps, "counts": counts}


def phase_config3(device):
    s, run = unsteady_cli(device, CONFIG3_ARGV, "config3")
    if s.n_dofs != CONFIG3_DOFS:
        raise RuntimeError(f"config3: DoF count {s.n_dofs} != {CONFIG3_DOFS}")
    if len(run["steps"]) != 3:
        raise RuntimeError(f"config3 ran {len(run['steps'])} steps, not 3")
    return s, run


def phase_config3_lu(device):
    """config3 with ``--direct-lu`` over ``CONFIG3_LU_STEPS`` steps: the
    matrix-build, factor and solve seconds of each tangent solve, and the
    last step's drag against the 800-step record."""
    import torch

    from navier_stokes_solver_tpu_torch.precond import blocks

    ref = northstar(CONFIG3_METRIC, n_steps=800)["extra"]
    argv = list(CONFIG3_ARGV)
    argv[argv.index("-T") + 1] = f"{CONFIG3_LU_STEPS * UNSTEADY_DT:g},{UNSTEADY_DT:g}"
    blocks.DIRECT_LU_TIMES.clear()
    torch.cuda.reset_peak_memory_stats(device)
    s, run = unsteady_cli(device, argv + ["--direct-lu"], "config3-lu")
    print(f"[config3-lu] peak device memory {torch.cuda.max_memory_allocated(device)} bytes (the f32 matrix and its factors: 2 x {4 * s.n_dofs ** 2} bytes)")
    solves, lu = solves_of(s), list(blocks.DIRECT_LU_TIMES)
    if len(lu) != len(solves):
        raise RuntimeError(f"config3-lu: {len(lu)} factorizations for {len(solves)} tangent solves")
    per = [
        {"step": round(h["time"] / UNSTEADY_DT), "n": t["n"], "build_s": t["build_s"], "factor_s": t["factor_s"],
         "solve_s": h["seconds"] - t["build_s"] - t["factor_s"], "outer": h["krylov_iters"]}
        for h, t in zip(solves, lu)
    ]
    for rec in per:
        print(f"[config3-lu] tangent solve {json.dumps(rec)}")
    drag = run["steps"][-1]["drag_coeff"]
    rel = abs(drag - ref["drag_coeff_last"]) / abs(ref["drag_coeff_last"])
    print(f"[config3-lu] outers per step {[r['outer'] for r in run['steps']]}; last step drag {drag!r} (800-step record {ref['drag_coeff_last']!r}, rel diff {rel:.3e}, gate {CONFIG3_LU_DRAG_RTOL:g})")
    if s.n_dofs != CONFIG3_DOFS:
        raise RuntimeError(f"config3-lu: DoF count {s.n_dofs} != {CONFIG3_DOFS}")
    if not rel <= CONFIG3_LU_DRAG_RTOL:
        raise RuntimeError(f"config3-lu: drag {drag!r} not within rtol {CONFIG3_LU_DRAG_RTOL} of {ref['drag_coeff_last']!r}")
    run["lu"] = per
    return s, run


def write_msh2(path, nodes, tri, edges, tags):
    """A triangle mesh as gmsh MSH2: boundary lines with their physical ids,
    then the triangles (the layout of ``scripts/generate_mesh.py --tri``)."""
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(len(nodes))]
    lines += [f"{i + 1} {x:.16g} {y:.16g} 0" for i, (x, y) in enumerate(nodes)]
    elements = [f"1 2 {t} {t} {a + 1} {b + 1}" for (a, b), t in zip(edges, tags)]
    elements += [f"2 2 0 0 {a + 1} {b + 1} {c + 1}" for a, b, c in tri]
    elements = [f"{i + 1} {e}" for i, e in enumerate(elements)]
    lines += ["$EndNodes", "$Elements", str(len(elements)), *elements, "$EndElements"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def phase_simplex_file(device, directory):
    """The curved mesh written as ``directory``/curved.msh (native-io reads
    it again) and solved through ``-M FILE``."""
    import numpy as np

    from navier_stokes_solver_tpu_torch.unstructured import triangulate_channel_curved

    t0 = time.perf_counter()
    nodes, tri, edges, tags = triangulate_channel_curved(*SIMPLEX_FILE_GRID)
    path = os.path.join(directory, "curved.msh")
    write_msh2(path, nodes, tri, edges, tags)
    size = os.path.getsize(path)
    print(f"[simplex-file] triangulate_channel_curved{SIMPLEX_FILE_GRID}: {len(nodes)} vertices, {len(tri)} triangles, {int((tags == 10).sum())} id-10 edges; MSH2 file {size} bytes in {time.perf_counter() - t0:.2f} s")
    s, run = unsteady_cli(device, ["-M", path] + SIMPLEX_FILE_ARGV, "simplex-file")
    n_cyl = int(s.disc.cyl_tri.numel())
    drag = run["steps"][-1]["drag_coeff"]
    print(f"[simplex-file] {s.n_dofs} DoFs, {n_cyl} curved id-10 edges in the disc, outers {[r['outer'] for r in run['steps']]}, drag {drag!r}")
    if s.n_dofs < SIMPLEX_FILE_MIN_DOFS:
        raise RuntimeError(f"simplex-file: {s.n_dofs} DoFs < {SIMPLEX_FILE_MIN_DOFS}")
    if n_cyl <= 0:
        raise RuntimeError("simplex-file: no id-10 cylinder edges")
    if not (np.isfinite(drag) and drag > 0):
        raise RuntimeError(f"simplex-file: drag {drag!r} is not finite and positive")
    return s, run


# ---------------------------------------------------------------------------
# 18. fused-check, 19. fused-main, 20. config3-lu-fused
# ---------------------------------------------------------------------------


def fused_run(device, fields, kw, checkpoint_dir=None, max_steps=None):
    """One ``FUSED_CHECK`` entry's ``solve_fused`` on one device, all-f64, as
    plain data: history, host fields, wall."""
    from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    s = NSSolver(SolverOptions(
        solver_type=1, preconditioner_type=1, time_step=UNSTEADY_DT, verbose=False, device=device,
        precond_config=PrecondConfig(vmult_dtype=None, mg_dtype=None), **fields,
    )).setup()
    t0 = time.perf_counter()
    s.solve_fused(checkpoint_dir=checkpoint_dir, max_steps_this_call=max_steps, **kw)
    return {"history": s.history, "fields": s.fields(), "wall_s": time.perf_counter() - t0,
            "steps_done": s.time_step_index}


def phase_fused_check(device, cpu_side=None):
    """``FUSED_CHECK`` on the card against the same on the CPU (``cpu_side``:
    the future of ``cpu_job("fused-check")``; by default one worker process
    started here): Newton and Krylov counts per step within 1, drag and
    lift per step rtol 1e-7 (the lift floored at 1e-7 of the drag), fields
    1e-6 of their magnitude.  Then a save -> load -> resume round trip on
    the card: the first case split after step 1 through a checkpoint
    directory equals its unsplit run bit for bit."""
    import tempfile

    import numpy as np

    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_fused_check(device, pool.submit(cpu_job, "fused-check"))
    t_all = time.perf_counter()
    card = [fused_run(device, fields, kw) for _, fields, kw in FUSED_CHECK]
    _, fields, kw = FUSED_CHECK[0]
    with tempfile.TemporaryDirectory() as ck:
        first = fused_run(device, fields, kw, checkpoint_dir=ck, max_steps=1)
        split = fused_run(device, fields, kw, checkpoint_dir=ck)
    t_card = time.perf_counter() - t_all
    cpu = cpu_side.result()
    print(f"[fused-check] card side {t_card:.1f} s; waited {time.perf_counter() - t_all - t_card:.1f} s more for the CPU side")
    key = ("newton_iters", "krylov_iters")
    for (name, _, _), g, c in zip(FUSED_CHECK, card, cpu):
        counts = [(tuple(hg[k] for k in key), tuple(hc[k] for k in key)) for hg, hc in zip(g["history"], c["history"])]
        print(f"[fused-check] {name}: walls card {g['wall_s']:.2f} s, CPU {c['wall_s']:.2f} s; (Newton, Krylov) per step (card, CPU) {counts}")
        if len(g["history"]) != len(c["history"]) or not g["history"]:
            raise RuntimeError(f"fused-check {name}: {len(g['history'])} steps on the card, {len(c['history'])} on the CPU")
        if any(abs(a - b) > 1 for gc, cc in counts for a, b in zip(gc, cc)):
            raise RuntimeError(f"fused-check {name}: counts {counts} differ by more than 1")
        for hg, hc in zip(g["history"], c["history"]):
            dg, dc, lg, lc = hg["drag_force"], hc["drag_force"], hg["lift_force"], hc["lift_force"]
            print(f"[fused-check] {name}: step {hg['step']} drag card {dg!r} CPU {dc!r} (|diff| {abs(dg - dc):.3e}); lift card {lg!r} CPU {lc!r} (|diff| {abs(lg - lc):.3e}); final residual card {hg['newton_residual']:.3e} CPU {hc['newton_residual']:.3e}")
            if not (abs(dg - dc) <= 1e-7 * abs(dc) and abs(lg - lc) <= 1e-7 * max(abs(lc), abs(dc))):
                raise RuntimeError(f"fused-check {name}: drag/lift at step {hg['step']} outside rtol 1e-7")
        for field, a, b in zip(("velocity", "pressure"), g["fields"], c["fields"]):
            err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
            print(f"[fused-check] {name}: {field} max|card - CPU| {err:.3e} (max|CPU| {scale:.3e})")
            if not err <= FIELD_GATE * scale:
                raise RuntimeError(f"fused-check {name}: {field} differs by {err} > {FIELD_GATE} x {scale}")
    whole = card[0]
    same = (
        first["steps_done"] == 1 and split["steps_done"] == len(whole["history"])
        and [tuple(h[k] for k in ("step", "drag_force", "lift_force") + key) for h in split["history"]]
        == [tuple(h[k] for k in ("step", "drag_force", "lift_force") + key) for h in whole["history"]]
        and all(np.array_equal(a, b) for a, b in zip(split["fields"], whole["fields"]))
    )
    print(f"[fused-check] round trip on the card ({FUSED_CHECK[0][0]}): step 1 to a checkpoint directory, resumed to step {split['steps_done']} in a fresh solve_fused: bit-identical to the unsplit run {same}")
    if not same:
        raise RuntimeError("fused-check: the checkpointed split run differs from the unsplit run")
    print(f"[fused-check] {len(FUSED_CHECK)} cases and the round trip in {time.perf_counter() - t_all:.1f} s")


def phase_fused_main(su):
    """``FUSED_MAIN_STEPS`` fused steps at the north-star width, on phase 9's
    solver from the state its host step ended in: that state is written as
    a step-1 checkpoint, and each fused step is one ``solve_fused`` call
    resuming from the directory (``max_steps_this_call=1``).  Counts zeroed
    just before, read just after."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.io import save_time_state
    from navier_stokes_solver_tpu_torch.timeloop import initial_state

    host = steps_of(su)[-1]
    n_host = int(host["step"])
    su.options = dataclasses.replace(su.options, time_span=(n_host + FUSED_MAIN_STEPS) * UNSTEADY_DT)
    scalar = lambda v: torch.tensor(v, dtype=su.disc.dtype, device=su.device)
    ts = initial_state(su.disc)._replace(
        solution=su.solution, time=scalar(su.time), step=torch.tensor(n_host, dtype=torch.int32, device=su.device),
        drag=scalar(host["drag_force"]), lift=scalar(host["lift_force"]),
    )
    hist = [[h["drag_force"], h["lift_force"], len([x for x in solves_of(su) if x["time"] == h["time"]]),
             sum(x["krylov_iters"] for x in solves_of(su) if x["time"] == h["time"])] for h in steps_of(su)]
    fresh = []
    with tempfile.TemporaryDirectory() as ck:
        save_time_state(ts, ck)
        with open(os.path.join(ck, "history.json"), "w") as f:
            json.dump(hist, f)
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(FUSED_MAIN_STEPS):
            n = len(su.history)
            su.solve_fused(checkpoint_dir=ck, max_steps_this_call=1)
            fresh += [h for h in su.history[n:] if "seconds" in h]
        wall = time.perf_counter() - t0
        counts = read_counts()
    print(f"[fused-main] {UNSTEADY_MESH[0]}x{UNSTEADY_MESH[1]} Q3/Q2 Re 100, n_dofs {su.n_dofs}: steps {n_host + 1}-{n_host + FUSED_MAIN_STEPS} from phase 9's step-{n_host} state, one solve_fused call each (checkpoint resume), {wall!r} s")
    steps = fused_steps(su, fresh, "fused-main")
    print(f"[fused-main] launches {json.dumps(counts)}")
    if [r["step"] for r in steps] != list(range(n_host + 1, n_host + FUSED_MAIN_STEPS + 1)):
        raise RuntimeError(f"fused-main ran steps {[r['step'] for r in steps]}")
    check_steps(su, steps, "fused-main")
    u, _ = su.fields()
    if not np.isfinite(u).all():
        raise RuntimeError("fused-main: non-finite velocity")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise RuntimeError(f"the fused path never launched {name}")
    return {"wall_s": wall, "steps": steps, "counts": counts}


def phase_config3_lu_fused(device):
    """config3-lu through ``cli.unsteady.run --fused``, ``CONFIG3_LU_STEPS``
    steps: the last step's drag against the 800-step record (itself a fused
    run)."""
    from navier_stokes_solver_tpu_torch.precond import blocks

    ref = northstar(CONFIG3_METRIC, n_steps=800)["extra"]
    argv = list(CONFIG3_ARGV)
    argv[argv.index("-T") + 1] = f"{CONFIG3_LU_STEPS * UNSTEADY_DT:g},{UNSTEADY_DT:g}"
    blocks.DIRECT_LU_TIMES.clear()
    s, run = unsteady_cli(device, argv + ["--direct-lu", "--fused"], "config3-lu-fused")
    lu = list(blocks.DIRECT_LU_TIMES)
    drag = run["steps"][-1]["drag_coeff"]
    rel = abs(drag - ref["drag_coeff_last"]) / abs(ref["drag_coeff_last"])
    print(f"[config3-lu-fused] {len(lu)} factorizations (factor {min(t['factor_s'] for t in lu):.3f}-{max(t['factor_s'] for t in lu):.3f} s); Newton iterations per step {[r['newton_iterations'] for r in run['steps']]}, outers per step {[r['outer'] for r in run['steps']]} (800-step record's first 12 {ref['krylov_iters_per_step'][:CONFIG3_LU_STEPS]}); last step drag {drag!r} (record {ref['drag_coeff_last']!r}, rel diff {rel:.3e}, gate {CONFIG3_LU_DRAG_RTOL:g})")
    if s.n_dofs != CONFIG3_DOFS or len(run["steps"]) != CONFIG3_LU_STEPS:
        raise RuntimeError(f"config3-lu-fused: {s.n_dofs} DoFs, {len(run['steps'])} steps")
    if not rel <= CONFIG3_LU_DRAG_RTOL:
        raise RuntimeError(f"config3-lu-fused: drag {drag!r} not within rtol {CONFIG3_LU_DRAG_RTOL} of {ref['drag_coeff_last']!r}")
    return s, run


# ---------------------------------------------------------------------------
# 21. ensemble-kernels, 22. ensemble-check, 23. ensemble-main
# ---------------------------------------------------------------------------


def ensemble_viscosities(disc, res, batch):
    """[B] viscosities 1 / linspace(Re_min, Re_max, B) in the disc's dtype
    on its device (``scripts/ensemble_bench.py``'s sweep)."""
    import numpy as np

    from navier_stokes_solver_tpu_torch.ensemble.sweep import as_viscosities

    return as_viscosities(disc, 1.0 / np.linspace(res[0], res[-1], batch))


def ensemble_disc(device, mesh, dtype):
    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc
    from navier_stokes_solver_tpu_torch.precond import attach_mg

    return attach_mg(make_disc(make_fe_space(make_channel_geometry(*mesh), 2, 1), dtype, device))


def ensemble_kernel_case(device, mesh, dtype, seed=0):
    """Config 5's kernel operands at one level of its multigrid chain, made
    from a numpy seed: ``(disc, nus, linq, x_u, bc_diag)`` with B = 64
    members -- lattices [B, 2, NY, NX], the linearization [n_q, B, ...],
    viscosities [B]."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import Blocks, diag_F, eval_state, make_disc

    disc = make_disc(make_fe_space(make_channel_geometry(*mesh), 2, 1), dtype, device)
    nus = ensemble_viscosities(disc, ENSEMBLE_RE, ENSEMBLE_B)
    rng = np.random.default_rng(seed)
    put = lambda a: torch.as_tensor(a, device=device).to(dtype)
    B = ENSEMBLE_B
    x = put(rng.standard_normal((B, 2) + disc.NV))
    st = Blocks(put(0.3 * rng.standard_normal((B, 2) + disc.NV)), put(rng.standard_normal((B,) + disc.NP)))
    linq = eval_state(disc, st)
    return disc, nus, linq, x, diag_F(disc, nus, KERNEL_INV_DT, linq, stokes=False)


def ensemble_kernel_check(disc, nus, linq, x, bc, name, errs):
    """One shape of phase 21's checks: the 32-bit index check over the
    batched operands, each batched launch against its plain version and,
    bit for bit, against B unbatched launches and the same launch on a
    permuted lattice layout; the largest errors go into ``errs``."""
    import torch

    from navier_stokes_solver_tpu_torch.ops import LinearizationQ
    from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F_lattice, cell_apply_F_lattice_plain
    from navier_stokes_solver_tpu_torch.ops.lattice import lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    B, mx, my = x.shape[0], disc.nx, disc.ny
    tol = KERNEL_TOL[name]
    loc_shape = (disc.cell_tabs.shape[2], B, 2, my, mx)
    offsets = {
        "lattice view": max_offset(lattice_view(x, 2, my, mx)), "linq.gradu": max_offset(linq.gradu),
        "output": max_offset(torch.empty(loc_shape, device="meta")), "lattice": max_offset(x),
    }
    print(f"[ensemble-kernels] {mx}x{my} Q2/Q1 B {B} {name}: largest element offsets {json.dumps(offsets)} (32-bit limit {INDEX_LIMIT})")
    if max(offsets.values()) >= INDEX_LIMIT:
        raise RuntimeError(f"a batched operand exceeds the kernels' 32-bit indexing: {offsets}")
    # the layout a batched multigrid transfer's einsum may hand the kernels
    x_perm = x.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    members = [LinearizationQ(linq.u[:, b].contiguous(), linq.gradu[:, b].contiguous(), None) for b in range(B)]
    nu_h = nus.tolist()
    for stokes in (True, False):
        tag = f"{mx}x{my} Q2/Q1 {name} B{B} {'stokes' if stokes else 'newton'}"
        lq = None if stokes else linq
        want = cell_apply_F_lattice_plain(disc, nus, KERNEL_INV_DT, lq, x, stokes=stokes)
        got = cell_apply_F_lattice(disc, nus, KERNEL_INV_DT, lq, x, stokes=stokes)
        got_perm = cell_apply_F_lattice(disc, nus, KERNEL_INV_DT, lq, x_perm, stokes=stokes)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"cell_apply_F (batched): non-finite output at {tag}")
        if not torch.equal(got, got_perm):
            raise RuntimeError(f"cell_apply_F (batched): a permuted lattice layout changes the result at {tag}")
        err = (got - want).abs()
        bad = int((err > tol + tol * want.abs()).sum())
        e = float(err.max())
        errs["cell_apply_F"] = max(errs["cell_apply_F"], e)
        same = sum(
            torch.equal(got[:, b], cell_apply_F_lattice(
                disc, nu_h[b], KERNEL_INV_DT, None if stokes else members[b], x[b], stokes=stokes))
            for b in range(B)
        )
        print(f"[ensemble-kernels] cell_apply_F (batched) {tag}: max|kernel-plain| {e:.3e} (max|plain| {float(want.abs().max()):.3e}), {bad} entries outside rtol=atol={tol:g}; members bit-identical to their unbatched launch {same} of {B}")
        if bad:
            raise RuntimeError(f"cell_apply_F (batched) disagrees with its plain version at {tag}")
        if same != B:
            raise RuntimeError(f"cell_apply_F (batched): {B - same} members differ from their unbatched launch at {tag}")
        for b_, xx, what in ((None, x, "raw"), (bc, x, "bc"), (bc, x_perm, "bc, permuted x")):
            g = scatter_v_bc(disc, want, bc_diag=b_, x_u=xx)
            w = scatter_v_bc_plain(disc, want, bc_diag=b_, x_u=xx)
            e = float((g - w).abs().max())
            errs["scatter_v_bc"] = max(errs["scatter_v_bc"], e)
            same = sum(
                torch.equal(g[b], scatter_v_bc(disc, want[:, b].contiguous(), bc_diag=None if b_ is None else b_[b], x_u=xx[b].contiguous()))
                for b in range(B)
            )
            print(f"[ensemble-kernels] scatter_v_bc (batched, {what}) {tag}: max|kernel-plain| {e!r}, bitwise equal {torch.equal(g, w)}; members bit-identical to their unbatched launch {same} of {B}")
            if e != 0.0 or not torch.equal(g, w) or same != B:
                raise RuntimeError(f"scatter_v_bc (batched, {what}) is not bit-identical at {tag}")


def phase_ensemble_kernels(device):
    """Both kernels with the member axis at every level of BASELINE config
    5's multigrid chain (60x40 Q2/Q1 down to its coarsest level, B = 64),
    f32 and f64, both regimes: ``ensemble_kernel_check``.  Then, at 60x40
    f32, phase 4's timings of the batched launch: device time,
    host-inclusive time, the plain version's, the library call's (a
    batched matmul of the per-member Stokes element matrices;
    ``index_add_`` of all members) and the bound (``cell_apply_cost`` /
    ``scatter_cost`` over B members: the shared operands counted once).
    Returns ``(max errors, {kernel: {tag: record}})``."""
    import torch

    from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F_lattice, cell_apply_F_lattice_plain
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    B, (mx, my) = ENSEMBLE_B, ENSEMBLE_MESH
    errs = {"cell_apply_F": 0.0, "scatter_v_bc": 0.0}
    times = {"cell_apply_F": {}, "scatter_v_bc": {}}
    from navier_stokes_solver_tpu_torch.precond.mg import mg_level_shapes

    levels = mg_level_shapes(ensemble_disc(device, ENSEMBLE_MESH, torch.float32))
    print(f"[ensemble-kernels] multigrid levels of the ensemble disc: {levels}")
    for mesh in levels:
        for dtype in (torch.float32, torch.float64):
            ensemble_kernel_check(*ensemble_kernel_case(device, mesh, dtype), str(dtype)[6:], errs)
    disc, nus, linq, x, bc = ensemble_kernel_case(device, ENSEMBLE_MESH, torch.float32)
    for stokes in (True, False):
        lq = None if stokes else linq
        args = (disc, nus, KERNEL_INV_DT, lq, x)
        rec = {
            "ms": device_ms(lambda: cell_apply_F_lattice(*args, stokes=stokes)),
            "host_ms": host_ms(lambda: cell_apply_F_lattice(*args, stokes=stokes)),
            "plain_ms": device_ms(lambda: cell_apply_F_lattice_plain(*args, stokes=stokes), PLAIN_CALLS),
            "library_ms": None,
        }
        if stokes:
            # each member's Stokes element matrix nu_b K applied to its
            # x_loc [n_v, 2C]: one batched matmul (mask left out)
            _, Dx, Dy = disc.cell_tabs
            K = Dx.T @ (disc.w_q[:, None] * Dx) + Dy.T @ (disc.w_q[:, None] * Dy)
            Kb = nus[:, None, None] * K
            xl = _gather_v(disc, x).reshape(K.shape[0], B, -1).transpose(0, 1).contiguous()
            rec["library_ms"] = device_ms(lambda: torch.matmul(Kb, xl))
        rec["bound_ms"], rec["bound_by"] = bound(*cell_apply_cost(disc, stokes, B))
        tag = f"{mx}x{my} Q2/Q1 float32 B{B} {'stokes' if stokes else 'newton'}"
        times["cell_apply_F"][tag] = rec
        print(f"[time] cell_apply_F {tag}: {json.dumps(rec)}")
    loc = cell_apply_F_lattice(disc, nus, KERNEL_INV_DT, linq, x, stokes=False)
    NY, NX = disc.NV
    idx = lattice_view(torch.arange(B * 2 * NY * NX, device=device).view(B, 2, NY, NX), 2, my, mx).reshape(-1)
    acc = torch.zeros(B * 2 * NY * NX, dtype=torch.float32, device=device)
    src = loc.reshape(-1)
    rec = {
        "ms": device_ms(lambda: scatter_v_bc(disc, loc, bc_diag=bc, x_u=x)),
        "host_ms": host_ms(lambda: scatter_v_bc(disc, loc, bc_diag=bc, x_u=x)),
        "plain_ms": device_ms(lambda: scatter_v_bc_plain(disc, loc, bc_diag=bc, x_u=x), PLAIN_CALLS),
        "library_ms": device_ms(lambda: acc.index_add_(0, idx, src)),
    }
    rec["bound_ms"], rec["bound_by"] = bound(*scatter_cost(disc, True, B))
    tag = f"{mx}x{my} Q2/Q1 float32 B{B} bc"
    times["scatter_v_bc"][tag] = rec
    print(f"[time] scatter_v_bc {tag}: {json.dumps(rec)}")
    return errs, times


def ensemble_check_run(device):
    """The ensemble check's run on one device, as plain data: per-step
    history [T, B], host fields [B, ...], wall."""
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import run_sweep
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    disc = ensemble_disc(device, ENSEMBLE_CHECK_MESH, torch.float64)
    nus = [1.0 / re for re in ENSEMBLE_CHECK_RE]
    cfg = PrecondConfig(schur_mode="cahouet", cc_lp_cycles=1, vmult_dtype=None, mg_dtype=None)
    t0 = time.perf_counter()
    final, hist = run_sweep(disc, nus, UNSTEADY_DT, ENSEMBLE_CHECK_STEPS, precond_cfg=cfg, solver_type=1,
                            prec_type=1, tol=1e-9, newton_max=3, krylov_maxiter=20)
    return {"hist": {k: v.cpu().numpy() for k, v in hist.items()},
            "fields": tuple(t.cpu().numpy() for t in final.solution), "wall_s": time.perf_counter() - t0}


def phase_ensemble_check(device, cpu_side=None):
    """A small ensemble on the card against the same on the CPU
    (``cpu_side``: the future of ``cpu_job("ensemble-check")``; by default
    one worker process started here): per step and member the Newton and
    Krylov counts within 1, drag and lift rtol 1e-7 (the lift floored at
    1e-7 of the drag), each member's fields within 1e-6 of its magnitude."""
    import numpy as np

    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_ensemble_check(device, pool.submit(cpu_job, "ensemble-check"))
    g = ensemble_check_run(device)
    c = cpu_side.result()
    mx, my = ENSEMBLE_CHECK_MESH
    where = f"{mx}x{my} Q2/Q1, Re {list(ENSEMBLE_CHECK_RE)}, {ENSEMBLE_CHECK_STEPS} steps"
    print(f"[ensemble-check] {where}: walls card {g['wall_s']:.2f} s, CPU {c['wall_s']:.2f} s")
    for k in ("newton_iters", "krylov_iters"):
        a, b = g["hist"][k], c["hist"][k]
        print(f"[ensemble-check] {k} per step and member: card {a.tolist()}, CPU {b.tolist()}")
        if a.shape != b.shape or np.abs(a.astype(int) - b.astype(int)).max() > 1:
            raise RuntimeError(f"ensemble-check: {k} differ by more than 1")
    dg, dc, lg, lc = g["hist"]["drag"], c["hist"]["drag"], g["hist"]["lift"], c["hist"]["lift"]
    print(f"[ensemble-check] drag card {dg.tolist()} CPU {dc.tolist()}; max rel diff {float((np.abs(dg - dc) / np.abs(dc)).max()):.3e}; lift max |diff| {float(np.abs(lg - lc).max()):.3e}")
    if not (np.all(np.abs(dg - dc) <= 1e-7 * np.abs(dc)) and np.all(np.abs(lg - lc) <= 1e-7 * np.maximum(np.abs(lc), np.abs(dc)))):
        raise RuntimeError("ensemble-check: drag/lift outside rtol 1e-7")
    for field, a, b in zip(("velocity", "pressure"), g["fields"], c["fields"]):
        for m in range(a.shape[0]):
            err, scale = float(np.abs(a[m] - b[m]).max()), float(np.abs(b[m]).max())
            print(f"[ensemble-check] member {m} {field} max|card - CPU| {err:.3e} (max|CPU| {scale:.3e})")
            if not err <= FIELD_GATE * scale:
                raise RuntimeError(f"ensemble-check: member {m} {field} differs by {err} > {FIELD_GATE} x {scale}")


def ensemble_outer_profile(disc, nus, ts, cfg, dt):
    """Phase 7's per-outer-iteration profile of the tangent solve at the
    state ``ts``: the batched one (all B members iterating) for [B] ``nus``,
    the unbatched one for a number."""
    import torch

    from navier_stokes_solver_tpu_torch.api import kernels
    from navier_stokes_solver_tpu_torch.ops import Blocks

    rhs, _ = kernels.assemble_kernel(disc, nus, 1.0 / dt, ts.solution, ts.solution.u, 0.0, stokes=False)
    zero = Blocks(torch.zeros_like(ts.solution.u), torch.zeros_like(ts.solution.p))

    def solve(n):
        return kernels.solve_kernel(
            disc, nus, 1.0 / dt, ts.solution, rhs, zero, 0.0, 0.0, stokes=False, solver_type=1,
            prec_type=1, variant="unsteady", maxiter=n, project_x0=False, precond_cfg=cfg, basis=30,
        )

    return profile_solve(solve)


def phase_ensemble_main(device):
    """BASELINE config 5 at full width: ``ENSEMBLE_B`` members, one warm-up
    step (the inlet lift), then ``ENSEMBLE_STEPS`` timed steps of the
    batched fused step (counts zeroed just before the warm-up, read after
    the timed steps); then the B = 1 control -- member B//2's state after
    the warm-up, stepped as many times by the unbatched step -- and one
    profiled outer iteration of the batched tangent solve."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import initial_ensemble_state, make_ensemble_step
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig
    from navier_stokes_solver_tpu_torch.timeloop import TimeState, make_time_step

    card = nvidia_smi()
    B, (mx, my), dt = ENSEMBLE_B, ENSEMBLE_MESH, UNSTEADY_DT
    disc = ensemble_disc(device, ENSEMBLE_MESH, torch.float64)
    n_dofs = 2 * int(np.prod(disc.NV)) + int(np.prod(disc.NP))
    if n_dofs != ENSEMBLE_DOFS:
        raise RuntimeError(f"ensemble-main: {n_dofs} DoFs per member, not {ENSEMBLE_DOFS}")
    nus = ensemble_viscosities(disc, ENSEMBLE_RE, B)
    cfg = PrecondConfig(schur_mode="cahouet", cc_lp_cycles=1)
    kw = dict(solver_type=1, prec_type=1, tol=1e-9, newton_max=ENSEMBLE_NEWTON_MAX, krylov_maxiter=200,
              precond_cfg=cfg)
    step = make_ensemble_step(disc, **kw)
    ts = initial_ensemble_state(disc, B)
    reset_counts()
    steps, warm = [], None
    for k in range(1 + ENSEMBLE_STEPS):
        t0 = time.perf_counter()
        ts = step(ts, nus, dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if k == 0:
            warm = ts
        st = ts.stats
        rec = {
            "step": int(ts.step[0]), "timed": k > 0, "wall_s": wall,
            "newton_iters": st.newton_iters.tolist(), "krylov_iters": st.krylov_iters.tolist(),
            "final_residual": st.final_residual.tolist(), "drag": ts.drag.tolist(), "lift": ts.lift.tolist(),
        }
        steps.append(rec)
        print(f"[ensemble-main] step {rec['step']} ({'timed' if k else 'warm-up, the inlet lift'}): wall {wall!r} s; {json.dumps({k_: rec[k_] for k_ in ('newton_iters', 'krylov_iters', 'final_residual')})}")
    counts = read_counts()
    timed = [r["wall_s"] for r in steps[1:]]
    t_b = statistics.median(timed)
    rate = B / t_b
    for rec in steps:
        n, res = np.asarray(rec["newton_iters"]), np.asarray(rec["final_residual"])
        capped = [int(m) for m in np.flatnonzero((n >= ENSEMBLE_NEWTON_MAX) & (res > 1e-9))]
        on_tol = res <= 1e-9
        print(f"[ensemble-main] step {rec['step']}: Newton stopped on tolerance (residual <= 1e-9) for {int(on_tol.sum())} of {B} members; at the cap ({ENSEMBLE_NEWTON_MAX}) above it: members {capped}; Krylov totals {int(np.min(rec['krylov_iters']))}-{int(np.max(rec['krylov_iters']))}, residuals {float(res.min()):.3e}-{float(res.max()):.3e}")
        other = [int(m) for m in np.flatnonzero(~on_tol & (n < ENSEMBLE_NEWTON_MAX))]
        if other:
            raise RuntimeError(f"ensemble-main: step {rec['step']}: members {other} stopped above the Newton tolerance before the cap")
        if not (np.isfinite(rec["drag"]).all() and np.isfinite(rec["lift"]).all()):
            raise RuntimeError(f"ensemble-main: step {rec['step']}: non-finite drag or lift")
    u = ts.solution.u
    if tuple(u.shape) != (B, 2) + disc.NV or not bool(torch.isfinite(u).all() and torch.isfinite(ts.solution.p).all()):
        raise RuntimeError("ensemble-main: the final fields are not finite or have the wrong shape")
    print(f"[ensemble-main] {mx}x{my} Q2/Q1, {n_dofs} DoFs per member, B {B} ({B * n_dofs} DoFs), Re {ENSEMBLE_RE[0]:g}..{ENSEMBLE_RE[1]:g}: timed step walls {timed} s, median {t_b!r} s, {rate!r} member-steps/s ({card}); launches {json.dumps(counts)}")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise RuntimeError(f"the ensemble path never launched {name}")
    # the B = 1 control: member B//2 after the warm-up, the same timed steps
    m = B // 2
    one = TimeState(*(type(f)(*(t[m].contiguous() for t in f)) if isinstance(f, tuple) else f[m].contiguous()
                      for f in warm))
    sstep = make_time_step(disc, **kw)
    nu_m = float(nus[m])
    walls, c_steps = [], []
    for _ in range(ENSEMBLE_STEPS):
        t0 = time.perf_counter()
        one = sstep(one, nu_m, dt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        c_steps.append((int(one.stats.newton_iters), int(one.stats.krylov_iters), float(one.drag)))
    t_1 = statistics.median(walls)
    eff = t_1 * B / t_b
    batched_m = [(r["newton_iters"][m], r["krylov_iters"][m], r["drag"][m]) for r in steps[1:]]
    print(f"[ensemble-main] B = 1 control (member {m}, Re {1.0 / nu_m:.6g}): step walls {walls} s, median {t_1!r} s; (Newton, Krylov, drag) per step {c_steps}, the batched member's {batched_m}; batch_efficiency_vs_single = t_1 B / t_B = {eff!r} ({card})")
    per = ensemble_outer_profile(disc, nus, ts, cfg, dt)
    print(f"[ensemble-outer] per outer iteration of the batched tangent solve (B {B}, profiled): {json.dumps(per)}")
    per1 = ensemble_outer_profile(disc, nu_m, one, cfg, dt)
    print(f"[ensemble-outer] per outer iteration of the B = 1 control's tangent solve (profiled): {json.dumps(per1)}")
    print(f"[ensemble-outer] B = {B} against B = 1 per outer iteration: kernels x{per['kernels'] / per1['kernels']:.3f}, device ms x{per['device_ms'] / per1['device_ms']:.3f}, wall ms x{per['wall_ms'] / per1['wall_ms']:.3f}, readbacks x{per['readbacks'] / per1['readbacks']:.3f}")
    ref = northstar(ENSEMBLE_METRIC)
    print(f"[ensemble-main] the JAX package's record (PERF_NORTHSTAR.json, {ref['extra']['device']}, another chip): {ref['value']} member-steps/s, median step {ref['extra']['median_step_s']} s")
    return {"counts": counts, "steps": steps, "median_step_s": t_b, "member_steps_per_s": rate,
            "control_step_s": t_1, "batch_efficiency_vs_single": eff, "outer": per, "outer_single": per1}


# ---------------------------------------------------------------------------
# 24. cavity-kernels, 25. cavity-ghia, 26. cavity-cli, 27. cavity-check,
# 28. native-io
# ---------------------------------------------------------------------------


def cavity_force(x, y):
    """cavity-check's body force, varying in both directions; amplitude 0.1
    (at 1 the forced Stokes flow is ~10x the lid's speed, an effective Re
    of ~1,000, and the Newton tangent solves run past 1,000 outers)."""
    import numpy as np

    return 0.1 * np.sin(np.pi * x) * np.cos(np.pi * y), 0.1 * x * y


def phase_cavity_kernels(device):
    """Both kernels against their plain versions at every level of the
    cavity's chain, f32 and f64, both regimes (phase 3's checks and
    tolerances), then phase 4's timings at 128x128."""
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_cavity_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc
    from navier_stokes_solver_tpu_torch.precond.mg import attach_mg, mg_level_shapes

    fine = make_disc(make_fe_space(make_cavity_geometry(*CAVITY_MESH), 2, 1), torch.float32, device)
    shapes = mg_level_shapes(attach_mg(fine, make_cavity_geometry))
    print(f"[cavity-kernels] the cavity's multigrid chain: {shapes}")
    if shapes != CAVITY_CHAIN:
        raise RuntimeError(f"cavity-kernels: the chain is {shapes}, not {CAVITY_CHAIN}")
    errs = {"cell_apply_F": 0.0, "scatter_v_bc": 0.0}
    for mesh in shapes:
        for dtype in (torch.float32, torch.float64):
            a, b = check_shape(device, mesh, (2, 1), dtype, make_cavity_geometry, "cavity ")
            errs = {"cell_apply_F": max(errs["cell_apply_F"], a), "scatter_v_bc": max(errs["scatter_v_bc"], b)}
    return errs, time_shape(device, CAVITY_MESH, (2, 1), make_cavity_geometry, "cavity ")


def cavity_solver(device, mesh, cfg=None, forcing=None):
    """``NSSolverStationary`` on the Q2/Q1 cavity at Re 100 with the options
    of tests/test_cavity.py:111-124 (FGMRES, blockTriangular, tol 1e-10,
    basis 60), set up -- and the Jacobian-consistent continuity sign: with
    the reference's, Newton stalls a little above the 1e-9 tolerance (1.43e-9
    at 32x32 on the CPU, the stall config 3 and the unsteady path show)."""
    from navier_stokes_solver_tpu_torch.api import NSSolverStationary, SolverOptions

    return NSSolverStationary(SolverOptions(
        mesh_size=mesh, degree_velocity=2, degree_pressure=1, Re=CAVITY_RE, solver_type=1, tolerance=1e-10,
        preconditioner_type=1, krylov_basis=60, geometry="cavity", verbose=False, precond_config=cfg,
        forcing=forcing, consistent_continuity=True, device=device,
    )).setup()


def record_solves(s):
    """Per tangent solve of solver ``s`` from here on: Stokes or Newton,
    outers, wall, and (on the card) both kernels' launches."""
    import torch

    out, solve = [], s.solve_system

    def timed(stokes, lifting):
        before = {k: v["launches"] for k, v in read_counts().items()}
        t0 = time.perf_counter()
        n = solve(stokes, lifting)
        if s.device.type == "cuda":
            torch.cuda.synchronize(s.device)
        out.append({"stokes": stokes, "outer": n, "wall_s": time.perf_counter() - t0,
                    "launches": {k: v["launches"] - before[k] for k, v in read_counts().items()}})
        return n

    s.solve_system = timed
    return out


def ghia_deviation(s):
    """Largest |u - Ghia| on the vertical and |v - Ghia| on the horizontal
    centerline, the solution interpolated linearly along the lattice line."""
    import numpy as np

    u, _ = s.fields()
    x, y = s.space.x_v, s.space.y_v
    icx, icy = int(np.argmin(np.abs(x - 0.5))), int(np.argmin(np.abs(y - 0.5)))
    if abs(x[icx] - 0.5) > 1e-12 or abs(y[icy] - 0.5) > 1e-12:
        raise RuntimeError("the cavity lattice has no node line at x = 0.5 or y = 0.5")
    gu, gv = np.array(GHIA_U), np.array(GHIA_V)
    err_u = float(np.max(np.abs(np.interp(gu[:, 0], y, u[0, :, icx]) - gu[:, 1])))
    err_v = float(np.max(np.abs(np.interp(gv[:, 0], x, u[1, icy, :]) - gv[:, 1])))
    return err_u, err_v


def phase_cavity_ghia(device):
    """The lid-driven cavity at 128x128 Q2/Q1, Re 100, through
    ``NSSolverStationary.solve_direct`` on the card, f32 preconditioner:
    counts zeroed just before, read just after; gates: the final Newton
    residual, both Ghia centerline deviations."""
    import numpy as np

    card = nvidia_smi()
    reset_counts()
    s = cavity_solver(device, CAVITY_MESH)
    solves = record_solves(s)
    t0 = time.perf_counter()
    s.solve_direct()
    wall = time.perf_counter() - t0
    counts = read_counts()
    final = s.assemble_system(False, lifting=False)
    err_u, err_v = ghia_deviation(s)
    u, p = s.fields()
    print(f"[cavity-ghia] {CAVITY_MESH[0]}x{CAVITY_MESH[1]} Q2/Q1 Re {CAVITY_RE:g}, n_dofs {s.n_dofs}, setup {s.setup_seconds:.3f} s (the chain {s.disc.nx}x{s.disc.ny} ... 8x8 included), solve_direct wall {wall!r} s ({card})")
    for i, r in enumerate(solves):
        print(f"[cavity-ghia] tangent solve {i} ({'Stokes init' if r['stokes'] else 'Newton'}): {r['outer']} outers, wall {r['wall_s']!r} s, {r['wall_s'] / max(r['outer'], 1) * 1e3:.2f} ms per outer, launches {json.dumps(r['launches'])}")
    print(f"[cavity-ghia] outers per tangent solve {[r['outer'] for r in solves]} (total {sum(r['outer'] for r in solves)}); final Newton residual {final:.3e} (gate {s.NEWTON_TOL:g}); phases {json.dumps(s.timer.summary())}")
    print(f"[cavity-ghia] max deviation from Ghia, Ghia & Shin (1982) Tables I-II at Re 100: u on x = 0.5 {err_u:.4e}, v on y = 0.5 {err_v:.4e} (gate {GHIA_GATE:g} each)")
    print(f"[cavity-ghia] launches {json.dumps(counts)}")
    if s.n_dofs != CAVITY_DOFS:
        raise RuntimeError(f"cavity-ghia: DoF count {s.n_dofs} != {CAVITY_DOFS}")
    if not (np.isfinite(u).all() and np.isfinite(p).all()):
        raise RuntimeError("cavity-ghia: the fields are not finite")
    if not final <= s.NEWTON_TOL:
        raise RuntimeError(f"cavity-ghia: final Newton residual {final} > {s.NEWTON_TOL}")
    if not (err_u < GHIA_GATE and err_v < GHIA_GATE):
        raise RuntimeError(f"cavity-ghia: centerline deviations {err_u}, {err_v} not below {GHIA_GATE}")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise RuntimeError(f"the cavity path never launched {name}")
    return s, {"wall_s": wall, "setup_s": s.setup_seconds, "solves": solves, "final_residual": final,
               "ghia": (err_u, err_v), "counts": counts}


def phase_cavity_cli(device):
    """``cli.stationary --cavity -m 32,32 -r 100 --output`` on the card (the
    continuation, ``output()`` at each of its call sites): the record's
    files, decoded, are ``fields()`` at the cell corners, bit for bit."""
    import numpy as np

    from navier_stokes_solver_tpu_torch.api import NSSolverStationary
    from navier_stokes_solver_tpu_torch.cli import stationary as cli
    from navier_stokes_solver_tpu_torch.io.vtu import read_vtu

    calls, output = [], NSSolverStationary.output

    def timed_output(self, *a):
        t0 = time.perf_counter()
        output(self, *a)
        calls.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as d:
        argv = CAVITY_CLI_ARGV + ["--output-dir", d, "--device", str(device)]
        NSSolverStationary.output = timed_output
        try:
            reset_counts()
            s = cli.run(argv)
            counts = read_counts()
        finally:
            NSSolverStationary.output = output
        files = sorted(os.listdir(d))
        got = read_vtu(os.path.join(d, "output_000.0.vtu"))
    u, p = s.fields()
    kv, kp = s.space.deg_v, s.space.deg_p
    want_v, want_p = u[:, ::kv, ::kv].reshape(2, -1), p[::kp, ::kp].ravel()
    same = (np.array_equal(got["velocity"][:, :2].T, want_v) and not got["velocity"][:, 2].any()
            and np.array_equal(got["pressure"], want_p))
    per_solve = [h.get("krylov_iters") for h in s.history]
    print(f"[cavity-cli] cli.stationary {' '.join(argv[:-4])} ...: n_dofs {s.n_dofs}, setup {s.setup_seconds:.3f} s, solve wall {s.solve_seconds!r} s, outers per solve {per_solve}; output() {len(calls)} calls, {sum(calls):.3f} s in all; files {files}; decoded fields equal fields() at the corners bit for bit: {same}")
    print(f"[cavity-cli] launches {json.dumps(counts)}")
    if files != ["output_000.0.vtu", "output_000.pvtu"]:
        raise RuntimeError(f"cavity-cli: the output directory holds {files}")
    if not same:
        raise RuntimeError("cavity-cli: the VTU fields are not fields() at the cell corners")
    if len(calls) < 2 or not np.isfinite(u).all():
        raise RuntimeError(f"cavity-cli: {len(calls)} output() calls, finite fields {np.isfinite(u).all()}")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise RuntimeError(f"the cavity CLI path never launched {name}")
    return s, {"wall_s": s.solve_seconds, "outer": per_solve, "output_calls": len(calls), "counts": counts}


def cavity_check_run(device):
    """cavity-check's forced 32x32 solve on one device, all-f64, as plain
    data: outers per tangent solve, fields (pressure mean removed), wall."""
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    s = cavity_solver(device, CAVITY_CHECK_MESH, PrecondConfig(vmult_dtype=None, mg_dtype=None), cavity_force)
    solves = record_solves(s)
    t0 = time.perf_counter()
    s.solve_direct()
    u, p = s.fields()
    return {"outer": [r["outer"] for r in solves], "fields": (u, p - p.mean()), "wall_s": time.perf_counter() - t0}


def phase_cavity_check(device, cpu_side=None):
    """A forced 32x32 Q2/Q1 cavity at Re 100 on the card against the CPU
    (``cpu_side``: the future of ``cpu_job("cavity-check")``): outers within
    1 per tangent solve, fields within 1e-6 of their magnitude."""
    import numpy as np

    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_cavity_check(device, pool.submit(cpu_job, "cavity-check"))
    g, c = cavity_check_run(device), cpu_side.result()
    for where, r in (("card", g), ("CPU", c)):
        print(f"[cavity-check] {CAVITY_CHECK_MESH[0]}x{CAVITY_CHECK_MESH[1]} Q2/Q1 Re {CAVITY_RE:g} with a body force on the {where}: wall {r['wall_s']!r} s, outers per tangent solve {r['outer']}")
    if len(g["outer"]) != len(c["outer"]):
        raise RuntimeError("cavity-check: the card and the CPU ran different numbers of tangent solves")
    diffs = [a - b for a, b in zip(g["outer"], c["outer"])]
    if any(abs(d) > 1 for d in diffs):
        raise RuntimeError(f"cavity-check: outers differ by more than 1: {diffs}")
    for name, a, b in zip(("velocity", "pressure (mean removed)"), g["fields"], c["fields"]):
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"[cavity-check] {name}: max|card - CPU| {err:.3e} (max|CPU| {scale:.3e})")
        if not err <= FIELD_GATE * scale:
            raise RuntimeError(f"cavity-check: {name} differs by {err} > {FIELD_GATE} x {scale}")
    return {"diffs": diffs}


def best_of(fn, n=3):
    """(smallest wall of ``n`` calls of ``fn``, its last result)."""
    walls, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t0)
    return min(walls), out


def phase_native_io(state300, simplex3, msh_path):
    """The native C++ IO library: phase 9's 300x100 Q3/Q2 state through the
    native and the Python VTU writers (byte for byte, both timed); a config-3
    state through ``write_vtu_tri``; the simplex-file mesh through the
    native and the Python gmsh readers (arrays equal, both timed)."""
    import numpy as np

    from unittest import mock

    from navier_stokes_solver_tpu_torch import native
    from navier_stokes_solver_tpu_torch.io import vtu
    from navier_stokes_solver_tpu_torch.io.msh import _read_msh_python

    card = nvidia_smi()
    t0 = time.perf_counter()
    if not native.native_available():
        raise RuntimeError("native-io: the native IO library did not build (g++)")
    print(f"[native-io] {os.path.relpath(native.library_path(), ROOT)} loaded in {time.perf_counter() - t0:.3f} s")
    space, u, p = state300
    disc3, u3, p3 = simplex3
    with tempfile.TemporaryDirectory() as d:
        paths = {k: os.path.join(d, f"{k}.vtu") for k in ("native", "python", "tri")}
        t_nat, _ = best_of(lambda: vtu.write_vtu(space, u, p, paths["native"]))
        with mock.patch.object(vtu, "write_vtu_native", lambda *a: False):  # the plain version
            t_py, _ = best_of(lambda: vtu.write_vtu(space, u, p, paths["python"]))
        with open(paths["native"], "rb") as f:
            a = f.read()
        with open(paths["python"], "rb") as f:
            b = f.read()
        t_tri, _ = best_of(lambda: vtu.write_vtu_tri(disc3, u3, p3, paths["tri"]))
        tri = vtu.read_vtu(paths["tri"])
    n_v = tri["pressure"].shape[0]
    tri_ok = np.array_equal(tri["velocity"][:, :2].T, u3[:, :n_v]) and np.array_equal(tri["pressure"], p3)
    print(f"[native-io] write_vtu {space.geo.nx}x{space.geo.ny} Q{space.deg_v}/Q{space.deg_p} ({space.n_dofs} DoFs, {len(a)} bytes): native {t_nat * 1e3:.2f} ms, Python {t_py * 1e3:.2f} ms (best of 3), byte for byte equal: {a == b} ({card})")
    print(f"[native-io] write_vtu_tri config 3 ({n_v} vertices): {t_tri * 1e3:.2f} ms, decoded fields equal: {tri_ok}")
    t_rn, got = best_of(lambda: native.read_msh_native(msh_path))
    t_rp, want = best_of(lambda: _read_msh_python(msh_path))
    same = set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    print(f"[native-io] read_msh {os.path.getsize(msh_path)} bytes ({len(want['nodes_xy'])} vertices, {len(want['tri'])} triangles): native {t_rn * 1e3:.2f} ms, Python {t_rp * 1e3:.2f} ms (best of 3), arrays equal: {same} ({card})")
    if a != b:
        raise RuntimeError("native-io: the native and Python VTU writers disagree")
    if not tri_ok:
        raise RuntimeError("native-io: write_vtu_tri's fields do not decode to the config-3 state")
    if not same:
        raise RuntimeError("native-io: the native and Python gmsh readers disagree")
    return {"write_native_s": t_nat, "write_python_s": t_py, "write_tri_s": t_tri, "read_native_s": t_rn,
            "read_python_s": t_rp}


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def kernel_line(errs, times, counts, counts_by_path):
    """The kernels of the slices' main paths: launches from this slice's
    (the 128x128 Q2/Q1 cavity, cavity-ghia) and times at its finest level,
    in the Stokes regime (the one with a library yardstick); launches on
    every main path, and times at every shape, beside them."""
    mesh = f"cavity {CAVITY_MESH[0]}x{CAVITY_MESH[1]} Q2/Q1 float32"
    main_tag = {"cell_apply_F": f"{mesh} stokes", "scatter_v_bc": f"{mesh} bc"}
    rows = []
    for name in ("cell_apply_F", "scatter_v_bc"):
        rec = times[name][main_tag[name]]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": counts[name]["launches"],
            "launches_by_shape": counts[name]["by_shape"],
            "launches_by_path": {path: c[name]["launches"] for path, c in counts_by_path.items()},
            "max_abs_err": errs[name],
            "shape": main_tag[name],
            "ms": rec["ms"],
            "host_ms": rec["host_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_us": 1e3 * rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "by_shape": times[name],
        })
    return json.dumps({"kernels": rows})


def main():
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    device = phase_device()
    import torch

    print(
        f"[budget] depth cuts taken: stationary bench solves {SOLVES} of 2; unsteady 300x100 steps {UNSTEADY_STEPS} of 2 "
        f"(of the 800 of T = 8); config3-lu and config3-lu-fused {CONFIG3_LU_STEPS} of 20 steps (of the record's 800); "
        f"phase 12's unsteady card-only entry dropped; fused-main {FUSED_MAIN_STEPS} of 2 steps. Not cut: "
        f"unsteady-check steps {CHECK_STEPS}, config 1, matrix at {MATRIX_MESH[0]}x{MATRIX_MESH[1]}, simplex check at "
        f"-M {SIMPLEX_CHECK_MESH[0]}x{SIMPLEX_CHECK_MESH[1]}, fused check (3 and 2 steps), config3 its 3 steps, "
        f"simplex-file one step, ensemble-main B {ENSEMBLE_B} and {ENSEMBLE_STEPS} timed steps, cavity-ghia at "
        f"{CAVITY_MESH[0]}x{CAVITY_MESH[1]}"
    )
    phase_build()
    errs = phase_check(device)
    times = phase_time(device)
    for more_errs, more_times in (phase_ensemble_kernels(device), phase_cavity_kernels(device)):
        for name in errs:
            errs[name] = max(errs[name], more_errs[name])
            times[name].update(more_times[name])
    phase_launches(device)
    s1, config1 = phase_config1(device)
    c1outer = phase_outer(s1, regimes=(True,), tag="config1-outer")
    print(f"[config1] setup {config1['setup_s']:.3f} s, solve wall {config1['wall_s']!r} s, {config1['outer']} outers; Stokes regime per outer iteration: {c1outer['stokes']['kernels']!r} device kernels, {c1outer['stokes']['device_ms']!r} device ms, {c1outer['stokes']['readbacks']!r} readbacks, busy {c1outer['stokes']['busy']:.4f}")
    del s1
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        ref = json.load(f)["parsed"]["extra"]
    runs = []
    for _ in range(SOLVES):
        s, run = run_solve(device, ref)
        runs.append(run)
    outer = phase_outer(s)
    print(f"[main] solve_newton walls {[r['wall_s'] for r in runs]} s; outer iterations {[r['outer'] for r in runs]}; kernels per outer iteration newton {outer['newton']['kernels']!r}, stokes {outer['stokes']['kernels']!r}")
    del s
    su, unsteady = phase_unsteady_main(device)
    uouter = phase_outer(su, regimes=(False,), tag="unsteady-outer")
    print(f"[unsteady-main] per-step walls {[r['wall_s'] for r in unsteady['steps']]} s; outer iterations per step {[r['outer'] for r in unsteady['steps']]}; Newton regime per outer iteration: {uouter['newton']['kernels']!r} device kernels, {uouter['newton']['readbacks']!r} readbacks, busy {uouter['newton']['busy']:.4f}")
    fused_main = phase_fused_main(su)
    state300 = (su.space, *su.fields())
    del su
    ensemble = phase_ensemble_main(device)
    print(f"[ensemble-main] {ensemble['member_steps_per_s']!r} member-steps/s, median step {ensemble['median_step_s']!r} s, B = 1 control {ensemble['control_step_s']!r} s, batch_efficiency_vs_single {ensemble['batch_efficiency_vs_single']!r}; per outer iteration {ensemble['outer']['kernels']!r} device kernels, {ensemble['outer']['device_ms']!r} device ms, {ensemble['outer']['wall_ms']!r} ms wall, {ensemble['outer']['readbacks']!r} readbacks, busy {ensemble['outer']['busy']:.4f}, our kernels {ensemble['outer']['ours_share']:.4f} of the device time")
    sc, cavity = phase_cavity_ghia(device)
    couter = phase_outer(sc, regimes=(False,), tag="cavity-outer")
    print(f"[cavity-ghia] per outer iteration at the converged state, Newton regime (the Stokes rhs of a converged cavity is zero): {couter['newton']['kernels']!r} device kernels, {couter['newton']['device_ms']!r} device ms, {couter['newton']['wall_ms']!r} ms wall, {couter['newton']['readbacks']!r} readbacks, busy {couter['newton']['busy']:.4f}")
    del sc
    _, cavity_cli = phase_cavity_cli(device)
    # the card-vs-CPU phases, after the timed paths before them and before
    # those after them: their CPU sides run meanwhile in worker processes
    t_checks = time.perf_counter()
    with cpu_pool(3) as pool:
        # the fourth to sixth CPU sides start when a worker is free
        cpu = {name: pool.submit(cpu_job, name)
               for name in ("unsteady-check", "matrix", "simplex-check", "fused-check", "ensemble-check",
                            "cavity-check")}
        phase_unsteady_check(device, cpu["unsteady-check"])
        phase_matrix(device, cpu["matrix"])
        phase_profile(device)
        phase_simplex_check(device, cpu["simplex-check"])
        phase_fused_check(device, cpu["fused-check"])
        phase_ensemble_check(device, cpu["ensemble-check"])
        phase_cavity_check(device, cpu["cavity-check"])
    print(f"[budget] card-vs-CPU phases (8, 12-14, 18, 22, 27) {time.perf_counter() - t_checks:.1f} s")
    s3, config3 = phase_config3(device)
    c3outer = phase_outer(s3, regimes=(False,), tag="config3-outer")
    print(f"[config3] setup {config3['setup_s']:.3f} s, per-step walls {[r['wall_s'] for r in config3['steps']]} s, Newton iterations per step {[r['newton_iterations'] for r in config3['steps']]}, outers per step {[r['outer'] for r in config3['steps']]}; Newton regime per outer iteration: {c3outer['newton']['kernels']!r} device kernels, {c3outer['newton']['device_ms']!r} device ms, {c3outer['newton']['wall_ms']!r} ms wall, {c3outer['newton']['readbacks']!r} readbacks, busy {c3outer['newton']['busy']:.4f}")
    simplex3 = (s3.disc, *s3.fields())
    del s3
    _, config3_lu = phase_config3_lu(device)
    _, config3_lu_fused = phase_config3_lu_fused(device)
    with tempfile.TemporaryDirectory() as tmp:
        _, simplex_file = phase_simplex_file(device, tmp)
        phase_native_io(state300, simplex3, os.path.join(tmp, "curved.msh"))
    counts_by_path = {
        "stationary": runs[0]["counts"], "unsteady": unsteady["counts"], "unsteady_fused": fused_main["counts"],
        "config1_blockdiag": config1["counts"], "simplex_config3": config3["counts"],
        "simplex_config3_lu": config3_lu["counts"], "simplex_config3_lu_fused": config3_lu_fused["counts"],
        "simplex_file": simplex_file["counts"], "ensemble": ensemble["counts"],
        "cavity_ghia": cavity["counts"], "cavity_cli": cavity_cli["counts"],
    }
    print(kernel_line(errs, times, cavity["counts"], counts_by_path))
    print(f"[profile] {len(PROFILE_WINDOWS)} profiler windows: {sum(a for a, _ in PROFILE_WINDOWS)} traces taken "
          f"again; {sum(d > 0 for _, d in PROFILE_WINDOWS)} of the kept traces lost leading markers "
          f"({sum(d for _, d in PROFILE_WINDOWS)} in all)")
    print(f"[budget] script wall {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
