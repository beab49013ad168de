#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; none catches another's).  They run in this
order, except that phase 37 runs beside phase 11, and phases 21
and 24 run right after phase 4, phase 6 right after phase 5,
phase 19 right after phase 10 (on its solver), phases 23, 32, 25, 26 and
13 after phase 19, phases 15-17, 20, 33, 28 and
11 after them (20 and 33 after 16, 28 after 17), and the card-vs-CPU
phases 8, 12, 14, 27, 18, 22, 29 and 31 with phase 30 after those, then
phases 36 and 35.  Beside them, other processes run: from phase 6 on
the CPU sides of the card-vs-CPU phases, in three spawned worker processes
(six of the host's eight cores, at niceness ``CPU_SIDE_NICE``, beside the
timed single-process paths, each of which keeps one core and the card);
in threads, from phase 6's end phase 36's four ranks (they need nothing
of phase 9 until their comparison) and from phase 36's end or phase 13's
end, whichever comes first, phase 35's (each a chain of device
synchronizations and host round trips of ranks sharing the card, which
wait for it asleep); and from phase 13's end phase 30's combinations and
the card sides of the card-vs-CPU phases, the longest first (``CARD_ORDER``),
in ``CARD_WORKERS`` worker processes on the card, beside phases 15-17, 20, 33, 28 and 11.  The
card-vs-CPU phases then only compare what the workers sent back.  Every
process that drives the card slows the others (the card switches between
their contexts): phase 36's ranks beside phase 6 made it take 2.3 times
as long, so they start after it:

  1. device   -- require CUDA; print the card (nvidia-smi name and power
                limit) and the torch / CUDA versions;
  2. build    -- compile the hand-written kernels from ``csrc/`` (one nvcc
                per source, started together) and print ptxas's register
                and spill report;
  3. check    -- each kernel against its plain PyTorch version on the card,
                at 100x70, 300x100 and 100x33 Q3/Q2 (the three main paths),
                20x9 Q2/Q1, every multigrid level of the main paths and the
                odd shapes of ``ODD_SHAPES`` (nx, ny no multiple of the
                fused kernel's tile; one cell row; one cell column):
                ``cell_apply_F`` (both
                entry points, and a permuted lattice layout) within rtol =
                atol 1e-5 (f32) and 1e-12 (f64); ``scatter_v_bc`` bit for
                bit (max |diff| == 0), with and without the boundary rows;
                ``apply_F_fused`` (the solver's one-launch ``apply_F``), with
                and without the rows, on the lattice and its permuted
                layout, bit for bit against the two launches it replaced
                (``scatter_v_bc(cell_apply_F_lattice(...))``, the card-side
                oracle) and within phase 3's tolerances of its plain
                version; every operand's largest element offset must fit
                the kernels' 32-bit indexing;
  4. time     -- at every multigrid level of the three main paths and at
                dd-north's 150x50 tile shape (``scatter_v_bc`` and
                ``apply_F_fused`` there also without their rows, as a tile
                launches them), f32, both regimes:
                each kernel's device time (CUDA events around 200
                back-to-back launches queued behind a sleep kernel, so the
                host cannot starve the card, divided by 200), its
                host-inclusive time (events around one call, median of 50),
                its plain version's time, the library yardstick's and the
                bound; ``apply_F_fused`` beside the two launches it
                replaced (their device time back to back, their
                host-inclusive time), its yardstick the Stokes
                ``torch.matmul`` plus ``index_add_``;
  5. launches -- one ``apply_F`` on CUDA in a ``torch.profiler`` window must
                run exactly one device kernel, ``apply_f_fused_kernel`` (the tracer drops
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
                after; the solve paths launch ``apply_F_fused`` and never
                ``cell_apply_F`` or ``scatter_v_bc``, which only the checks
                launch: ``check_path_launches``, on every path below);
  7. outer    -- at the converged state, device kernels, device time, wall
                and host readbacks (device-to-host copies) per outer FGMRES
                iteration in the Newton regime (the Stokes regime's: a depth
                cut), from profiler windows of 1 and 4 outer iterations
                (difference);
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
 11. config1  -- BASELINE.json configs[0] through the
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
                must name ``apply_f_fused_kernel`` and neither kernel it
                replaced;
 14. simplex-check -- the ``-M`` P2/P1 simplex backend on the card against
                the CPU, all-f64, at 24x10: whole solves (stationary Re 20
                blockTriangular with the p-multigrid and the dense Schur
                legs; the same with ``--direct-lu``): Krylov counts within 1
                per solve, drag and lift rtol 1e-7, fields 1e-6 of their
                magnitude; the unsteady run, ``SIMPLEX_CHECK_STEPS`` (one,
                a depth cut) step (per-step Re ramp, the
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
                Newton residual <= 1e-9, finite coefficients (its per-outer
                profile: a depth cut);
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
                ``FUSED_MAIN_STEPS`` (one, a depth cut) fused steps, each one
                ``solve_fused(checkpoint_dir=..., max_steps_this_call=1)``
                call resuming from the directory, phase 9's preconditioner
                (Cahouet-Chabard, one Lp V-cycle, f32, basis 30, tol 1e-9):
                per-step wall, Newton iterations, outers, final residual
                (each <= 1e-9), finite coefficients, launches of the three kernels
                (counts zeroed just before, read just after);
 20. config3-lu-fused -- phase 16 through ``cli.unsteady.run --fused``,
                ``CONFIG3_LU_STEPS`` steps: per-step walls, Newton iterations,
                outers, residuals (each <= 1e-9), factorizations; the last
                drag within rtol 1e-5 of the 800-step record (a fused run);
 21. ensemble-kernels -- the three kernels with the member axis at every
                level of BASELINE config 5's multigrid chain (60x40 Q2/Q1
                and its coarse levels, B = 64), f32 and f64, both regimes:
                each batched launch against its plain version (phase 3's
                tolerances) and, bit for bit, against B unbatched launches
                on the members' operands and against itself on a permuted
                lattice layout (``apply_F_fused`` also against the two
                batched launches it replaced); the 32-bit index check over
                the batched operands; then, at 60x40, phase 4's timings of
                the batched launch (f32), with the library call's (a
                batched matmul of the per-member Stokes element matrices;
                ``index_add_`` over all members; their sum for
                ``apply_F_fused``) and the bound (phase 4's reckoning over B
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
                (the inlet lift) and ``ENSEMBLE_STEPS`` (one) timed step --
                per-step walls, member-steps/s, per-member Newton
                iterations, Krylov totals and final residuals (each member
                at or under 1e-9, or at the Newton cap, listed), finite drag
                and lift for every member, launches of the three kernels (counts
                zeroed just before, read just after); then the B = 1
                control (member B//2's state after the warm-up, stepped as
                many times by the unbatched step) and
                ``batch_efficiency_vs_single`` = t_1 B / t_B, each beside
                the card's name and power limit; then phase 7's profile of
                one outer iteration of the batched tangent solve;
 24. cavity-kernels -- the three kernels at every level of the 128x128 Q2/Q1
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
                apply_F_fused launched, the other two not;
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
 29. ensemble-matrix-check -- phase 22 for every combination of
                ``ENSEMBLE_MATRIX`` -- (a) FGMRES + aSIMPLE, (b) GMRES +
                blockDiagonal + the mass leg, (c) BiCGStab + blockTriangular
                + Cahouet-Chabard, (d) FGMRES + blockTriangular + PCD, (e)
                FGMRES + blockTriangular + mass with ``inner_mode="fixed"``
                and the Chebyshev-Jacobi smoother, (f) FGMRES +
                blockTriangular + Cahouet-Chabard with the Schwarz smoother
                -- every tangent solve capped inside the stretch where two
                roundings agree (20; BiCGStab 10, PCD 5): the same gates.  The CPU side runs in a
                worker process;
 30. ensemble-matrix -- (b)-(f) at config 5's width (60x40 Q2/Q1, B = 64,
                1,414,592 DoFs, Re 20..100, dt 0.01, tol 1e-9, ``newton_max``
                3, ``krylov_maxiter`` 200, f32 preconditioner, the
                reference's sign), ``ENSEMBLE_MATRIX_STEPS`` (one, a depth
                cut) step each from rest, in the worker processes on the
                card beside the ``-M`` phases and the decomposed ones (the
                walls are measured while those and the other workers share
                the card and the host): step
                walls and member-steps/s, outers per
                step (the slowest member), each member's Newton count and
                final residual, the members BiCGStab marked failed, the
                launches of the three kernels (counts zeroed just before each
                combination's first step, read just after its last).
                Gates: finite drag and lift for every member, each member's
                residual at or below 1e-9 or the member at the Newton cap or
                stopped by the step's stagnation break (both listed), both
                kernels launched in each combination;
 31. ensemble-rest-check -- phase 22 for every case of
                ``ENSEMBLE_REST_CHECK``, all-f64 discs, two steps from rest,
                B = 3: (i) 16x8 Q2/Q1, Re 20/60/100, f32 GMRES-IR cycles,
                Cahouet-Chabard, whole tangent solves (cap 200), the
                consistent sign; (ii) the same members with the direct LU,
                capped at 20; (iii) ``-M`` 24x10, Re 1/50/100, iterative
                Schur legs, the consistent sign, capped at 40; (iv) the same
                with the direct LU.  The same gates, but (i)'s Krylov totals
                within the step's Newton count (f32 cycles end on an f32
                Givens estimate); the simplex drags must not be zero.  The
                CPU side runs in a worker process;
 32. ensemble-ir -- phase 23's configuration (BASELINE config 5, B = 64,
                a warm-up and ``ENSEMBLE_STEPS`` (one) timed step) with
                ``krylov_cycle_dtype="float32"``: step walls,
                member-steps/s, outers and restart cycles per step (the
                slowest member), the members at the Newton cap or stopped by
                the stagnation break (listed), launches of the three kernels
                (counts zeroed just before the warm-up, read after the last
                step), then phase 7's profile of the batched tangent solve
                beside phase 23's.  Gates: finite drag and lift for every
                member, each member at or below 1e-9 or listed, apply_F_fused
                launched and the other two not;
 33. ensemble-simplex-lu -- config 3 with ``--direct-lu`` as a Reynolds
                sweep, built from phase 20's solver (its disc with the dense
                Schur legs, its ``precond_config``, the step keywords of its
                ``solve_fused``): ``ENSEMBLE_SIMPLEX_B`` (16) members, Re
                linspace(1, 100), ``ENSEMBLE_SIMPLEX_STEPS`` (three) steps:
                per-step walls, factorizations (count, build and factor
                seconds), peak device memory, Newton iterations and outers
                per member.  Gates: member 0 (Re 1, config 3 itself) within
                rtol 1e-7 of phase 20's first three drags with equal Newton
                counts; one factorization per member tangent solve; finite
                forces; no hand-written kernel launched (B is 16, not 64: 64
                f32 factors of 1.94 GB each do not fit in 80 GB);
 35. dd-check -- domain decomposition (``dist/``, one process per tile,
                the ranks sharing the card under gloo: NCCL refuses two
                ranks on one card) against one rank on the card: the 32x12
                Q2/Q1 host step (Re 100, tol 1e-10, all-f64 Cahouet-Chabard
                with one Lp V-cycle, consistent sign) under 2 x 1 and 2 x 2
                tiles, and ``run_sweep(mesh=...)`` (B = 4, two 'ens' ranks,
                one step), the three together, beside the one-rank runs:
                equal Newton counts, Krylov totals within 1.1x + 5, drag
                within 1e-8, fields within 1e-7, the tile round trips
                (``tile_blocks`` / ``all_gather_blocks``) bit for bit, both
                kernels launched on every rank (the kernels built once,
                before the ranks start); then on every rank's tile, in f64,
                at every level of its chain (16x12 and 16x6 down), the
                kernels against their plain versions as in phase 3 --
                ``scatter_v_bc`` and ``apply_F_fused`` with their seam
                exchange and, given ``bc_diag``, their rows after it, bit for
                bit (``apply_F_fused`` against the two launches);
 36. dd-north -- this slice's full-width path: phase 9's step (300x100
                Q3/Q2, 657,740 DoFs, Re 100, f32 Cahouet-Chabard) on four
                150x50 tiles, four ranks sharing the card: Krylov total
                within 1.1x + 5 of phase 9's, drag within 1e-7, Newton
                residual <= 1e-9; the step wall (not a speedup), the
                launches per rank, the collectives per outer iteration and
                the seam bytes; then, on every rank's tile, the kernel
                checks of phase 35 in f32 at every level of the tile's
                chain (150x50 down to 10x2) and the round trip;
 37. dd-simplex -- the ``-M`` x-strips (``dist/simplex.py``, one process
                per strip, the ranks sharing the card under gloo) against
                one rank on the card, no dense Schur leg on either side (a
                strip's legs iterate), every run one Newton iteration (a
                depth cut, ``DD_SIMPLEX_NEWTON``): (a) at
                ``SIMPLEX_CHECK_MESH`` (24x10), Re 20, tol 1e-10, all-f64
                Cahouet-Chabard with one Lp cycle, consistent sign, the
                first host step on 2 and on 4 strips and one
                ``solve_fused`` step on 2, the tangent solve capped at 10
                outers (``DD_SIMPLEX_CAP``); (b) BASELINE config 3 at full
                width (``CONFIG3_ARGV``, 60x40, 21,997 DoFs, all-f64) on 2
                strips, capped at 20 (``DD_SIMPLEX_CONFIG3_CAP``); the
                one-rank references in the 4-strip run's processes after
                its strip run.  Gates: equal Newton counts, Krylov counts
                within 1 per solve (both sides stop at the cap: these two
                cannot part), the Newton residual where the step ended
                within 1e-8 of one rank's (what the capped solve reached),
                drag and both fields within 1e-8 of their largest
                magnitude, the strip round trip bit for bit, no launch of
                our kernels on any rank; per rank the seam exchanges,
                all-reduces and seam bytes per outer iteration, and the
                wall beside one rank's;
 34. report   -- one JSON line of per-kernel results, ``apply_F_fused``
                first, then ``cell_apply_F`` and ``scatter_v_bc`` (0
                launches on every path: only the checks launch them):
                launches from phase
                36 and times at its 150x50 tile shape: apply_F_fused Stokes
                without its rows, cell_apply_F Stokes, scatter_v_bc without
                its rows; max |kernel - plain| over
                phases 3, 21, 24, 35 and 36,
                with every path's launches -- the fused 300x100 path's, the
                ensemble's, the cavity's and the ensemble matrix's among
                them, 0 on the simplex paths, which run no hand-written
                kernel, phases 33 and 37 included -- and every shape's times
                beside them, the batched launches' included), the nvidia-smi
                line, then the final ``{"ok": true, "device": ...}`` line.

If the script outgrows its time budget, depth is cut, in this order: the
stationary bench solve to one run (``SOLVES``), then the unsteady run to
one step (``UNSTEADY_STEPS``), then config3-lu to 12 steps
(``CONFIG3_LU_STEPS``, which config3-lu-fused shares), then phase 12's
unsteady card-only entry -- all four taken: the whole script took 1,040.8 s
of its 1,200 s on a slow card without the last three -- then fused-main to
one step (``FUSED_MAIN_STEPS``; its checkpoint resume is still the one
from phase 9's state, and fused-check keeps its own round trip; taken for
phases 29-30, whose combinations took 477 s on the card one after the
other in this process, and now run in worker processes on the card) --
then ensemble-matrix (a) to one step
(``ENSEMBLE_MATRIX_STEPS``; its 200-iteration-capped solves set the
pooled block's wall, 245 / 189 s per step; taken for phases 31-33) -- then
config3 to one of its three steps (``CONFIG3_STEPS``) and
ensemble-simplex-lu to one (``ENSEMBLE_SIMPLEX_STEPS``) and the
ensemble's timed steps to one (``ENSEMBLE_STEPS``, ensemble-ir's
included) -- the last three taken for phases 35-36, whose collectives,
each a device synchronization and a host round trip, took 780 s before
they were cut down -- then phase 7's Stokes-regime profile and config3's
per-outer profile (taken when the fused kernel's checks came in and a
slow host ran the whole script in 1,216 s; phase 35 also moved to start
at phase 36's end when that comes before the card-vs-CPU phases' end)
-- then, when a slower host still ran the script past 1,200 s, the
simplex check's unsteady run to one of its two steps
(``SIMPLEX_CHECK_STEPS``; fused-check and ensemble-rest-check still
carry -M state across two steps) and ensemble-matrix's other five
combinations to one step, with the schedule above: phase 36 from phase
6's end, not phase 13's, and the card-vs-CPU card sides in the card
workers beside the -M phases, not in this process after the timed paths
(a schedule that ran every worker and phase 36 beside the timed paths
took 1,226 s; this one 1,021 s, up to seventeen processes driving the
card at once, each two- to threefold slower) -- then ensemble-matrix's
(a) at width, its one step (535 s there) as long as the other five
together, the card workers' long pole (its 16x8 card-vs-CPU check stays
in phase 29) -- then the new phase 37's runs to one Newton iteration
of a tangent solve capped at 10 outers, 20 for config 3
(``DD_SIMPLEX_NEWTON``, ``DD_SIMPLEX_CAP``, ``DD_SIMPLEX_CONFIG3_CAP``;
whole, its runs made the script 1,325-1,470 s, two Newton iterations
capped at 20, first and alone, 1,222 s, capped at 10 beside config 1
1,138-1,194 s), run beside config 1, whose host-bound launches leave the
card idle, its one-rank references in the 4-strip run's processes, with
the card workers four and taking their jobs longest first by their walls
in a whole run (``CARD_ORDER``)
-- never a mesh, the simplex check, the fused check,
the unsteady check's second step, the ensemble's B = 64, nor a kernel
check's shape.  If the cavity phases ever need room,
cavity-ghia goes to 64x64 (Ghia's own 129^2 velocity grid).  The cuts are
printed.

Exits non-zero without a result when no CUDA device is available.  It
reaps whatever its processes leave behind (``adopt_orphans``) and, after
the last phase or on a failure, stops every process it started that is
still there, the multiprocessing resource tracker last, and names them
(``stop_children``).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
# markers before the recorded call, and after it: the tracer drops a trace's
# head and, in long traces (~48k activities), its last activity
PROFILE_ATTEMPTS, PROFILE_LEAD, PROFILE_TAIL = 5, 3, 3
PROFILE_MARKER, PROFILE_MARKER_CYCLES = "spin_kernel", 1000
PROFILE_WINDOWS = []  # per window: (traces taken again, markers the tracer dropped)
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
# the unsteady run's steps (the tenth depth cut, from 2: a slow host ran the
# script past its 1,200 s; fused-check and ensemble-rest-check still carry
# -M state across two steps)
SIMPLEX_CHECK_STEPS = 1
SIMPLEX_CHECK = [  # whole runs, card vs CPU, all-f64: (entry, unsteady, SolverOptions fields, PrecondConfig fields)
    ("-M stationary -p 1 Re 20 (p-MG, dense Schur legs)", False, {}, {}),
    ("-M stationary -p 1 Re 20 --direct-lu", False, {}, dict(direct_lu=True)),
    ("-M unsteady -p 1 Re 20, one step, per-step ramp (iterative Schur legs)", True,
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
# config3 runs CONFIG3_STEPS of the script's three steps (the seventh depth
# cut, from 3: room for phases 35-36)
CONFIG3_STEPS = 1
CONFIG3_ARGV = ["-M", "-T", f"{CONFIG3_STEPS * 0.01:g},0.01", "-t", "1e-9", "-m", "60,40", "-s", "1", "-r", "1.0",
                "-p", "1", "--consistent-continuity", "--quiet"]
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
FUSED_MAIN_STEPS = 1  # the fifth depth cut, from 2 (room for phases 29-30)
# BASELINE config 5 (BASELINE.json configs[4]): the batched Reynolds-sweep
# ensemble at scripts/ensemble_bench.py's defaults -- 60x40 Q2/Q1 (22,103
# DoFs per member), B = 64, Re 20..100 (linspace), dt 0.01, tol 1e-9,
# newton_max 3, krylov_maxiter 200, FGMRES + blockTriangular, Cahouet-Chabard
# with one Lp V-cycle, f32 preconditioner
ENSEMBLE_MESH = (60, 40)
ENSEMBLE_DOFS = 22_103
ENSEMBLE_B = 64
ENSEMBLE_RE = (20.0, 100.0)
ENSEMBLE_STEPS = 1  # timed steps after the warm-up (the ninth depth cut, from 2: room for phases 35-36)
ENSEMBLE_NEWTON_MAX = 3
ENSEMBLE_METRIC = "ensemble_sweep_60x40_B64_tol1e-09_schurcahouet"  # PERF_NORTHSTAR.json: the JAX package's TPU record
# ensemble-check, card vs CPU, all-f64: 16x8 Q2/Q1, B = 3 (Re 20, 60, 100),
# two steps, newton_max 3, tangent solves capped at 20 (tests/test_torch_ensemble.py)
ENSEMBLE_CHECK_MESH = (16, 8)
ENSEMBLE_CHECK_RE = (20.0, 60.0, 100.0)
ENSEMBLE_CHECK_STEPS = 2
# the ensemble's solver matrix (combinations (a)-(f)): (label, step keywords,
# PrecondConfig fields, ensemble-matrix-check's Krylov cap).  ensemble-matrix
# runs each at config 5's width (f32 preconditioner), ensemble-matrix-check
# all-f64 at ENSEMBLE_CHECK_MESH with every tangent solve capped inside the
# stretch where two roundings agree (tests/_ensemble_matrix.py: BiCGStab
# 10, the PCD leg's nested solves 5, the others 20)
ENSEMBLE_MATRIX = [
    ("a FGMRES + aSIMPLE", dict(solver_type=1, prec_type=2), {}, 20),
    ("b GMRES + blockDiagonal + mass", dict(solver_type=0, prec_type=0), dict(schur_mode="mass"), 20),
    ("c BiCGStab + blockTriangular + Cahouet-Chabard", dict(solver_type=2, prec_type=1),
     dict(schur_mode="cahouet", cc_lp_cycles=1), 10),
    ("d FGMRES + blockTriangular + PCD", dict(solver_type=1, prec_type=1), dict(schur_mode="pcd"), 5),
    ("e FGMRES + blockTriangular + mass, fixed inner solves, Chebyshev-Jacobi smoother",
     dict(solver_type=1, prec_type=1), dict(schur_mode="mass", inner_mode="fixed", mg_smoother="jacobi"), 20),
    ("f FGMRES + blockTriangular + Cahouet-Chabard, Schwarz smoother", dict(solver_type=1, prec_type=1),
     dict(schur_mode="cahouet", cc_lp_cycles=1, mg_smoother="schwarz"), 20),
]
# steps from rest (the first lifts the inlet): (a)'s cut from 2 to 1 (the
# sixth depth cut, room for phases 31-33; its tangent solves all run to the
# 200-iteration cap), the others' too (the eleventh, from 2: a slow host ran
# the script past its 1,200 s)
ENSEMBLE_MATRIX_STEPS = 1
# the combinations ensemble-matrix runs at config 5's width: all but (a),
# which ensemble-matrix-check still runs on the card against the CPU (its
# one step at width took 300-598 s in a card worker, as long as the other
# five together; dropped when the depth cuts left too little to cut)
ENSEMBLE_MATRIX_WIDTH = tuple(range(1, len(ENSEMBLE_MATRIX)))
# the worker processes on the card (``card_pool``): ensemble-matrix's
# combinations and the card sides of ``CARD_SIDES``, from phase 13's end
# (four: with three, their last job ended 130 s after this process's
# phases, the script's critical path)
CARD_WORKERS = 4
# the CPU sides' worker processes run at this niceness: they have the most
# slack, and leave the host's cores first to the timed paths, the card
# workers and the decomposed ranks, which wait on the card
CPU_SIDE_NICE = 5
# ensemble-rest-check: the ensemble's GMRES-IR cycles, direct LU and -M
# simplex disc on the card against the CPU, all-f64 discs, two steps from
# rest, newton_max 3, FGMRES + blockTriangular: (label, backend, PrecondConfig
# fields, Reynolds numbers, Krylov cap, consistent continuity sign).  (i)
# runs its tangent solves whole, with the consistent sign: f32 cycles part
# two roundings early (capped at 20, the JAX package and the port end 2e-6
# apart in drag, tests/test_torch_ensemble_rest.py), and a solve that ends
# on the f32 Givens estimate may end an iteration apart, so its Krylov
# totals are held within the step's Newton count
ENSEMBLE_REST_CHECK = [
    ("i 16x8 Q2/Q1, f32 GMRES-IR cycles, Cahouet-Chabard, consistent sign", "structured",
     dict(schur_mode="cahouet", cc_lp_cycles=1, krylov_cycle_dtype="float32"), ENSEMBLE_CHECK_RE, 200, True),
    ("ii 16x8 Q2/Q1, direct LU", "structured", dict(schur_mode="cahouet", cc_lp_cycles=1, direct_lu=True),
     ENSEMBLE_CHECK_RE, 20, False),
    ("iii -M 24x10, iterative Schur legs, consistent sign", "simplex", {}, (1.0, 50.0, 100.0), 40, True),
    ("iv -M 24x10, direct LU, consistent sign", "simplex", dict(direct_lu=True), (1.0, 50.0, 100.0), 40, True),
]
# ensemble-simplex-lu: config 3 (-M 60x40, the consistent sign) with the
# direct LU as a Reynolds sweep from the 800-step record's Re 1 to BASELINE
# config 3's Re 100, built from config3-lu-fused's solver; B 16, not 64
# (reduced): 64 f32 factors of 1.94 GB each do not fit the card's 80 GB
ENSEMBLE_SIMPLEX_B = 16
ENSEMBLE_SIMPLEX_RE = (1.0, 100.0)
ENSEMBLE_SIMPLEX_STEPS = 1  # of config 3's three (the eighth depth cut, from 3: room for phases 35-36)
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
# dd-check: the decomposed host step at DD_CHECK_MESH Q2/Q1 under each tile
# grid, and run_sweep(mesh=...) over two 'ens' ranks with these viscosities
DD_CHECK_MESH = (32, 12)
DD_CHECK_TILES = ((2, 1), (2, 2))
DD_CHECK_NUS = (1 / 20.0, 1 / 40.0, 1 / 70.0, 1 / 100.0)
# dd-north: phase 9's step on four 150x50 tiles
DD_NORTH_TILES = (2, 2)
DD_NORTH_TILE = (UNSTEADY_MESH[0] // DD_NORTH_TILES[0], UNSTEADY_MESH[1] // DD_NORTH_TILES[1])
# dd-simplex: the -M x-strips (dist/simplex.py) against one rank on the card.
# (a) SIMPLEX_CHECK_MESH: the first host unsteady step on 2 strips and on
# DD_SIMPLEX_STRIPS_WIDE, one solve_fused step on 2; (b) config 3
# (CONFIG3_ARGV, 60x40, 21,997 DoFs) on 2 strips; the dense Schur legs off
# on both sides (a strip's legs iterate).  Every run is cut (the depth
# cut) to DD_SIMPLEX_NEWTON Newton iterations, its tangent solve capped at
# DD_SIMPLEX_CAP outers, config 3's at DD_SIMPLEX_CONFIG3_CAP: every
# collective of ranks sharing the card is a device synchronization and a
# host round trip, 120-190 seam exchanges and 270-390 all-reduces per outer
# on strips; whole, (a) and (b) took 154-399 s per run and made the script
# 1,324.7-1,470.4 s beside the other phases; two Newton iterations capped
# at 10 beside config 1 made config 1 2.5-2.8 times as long and the script
# 1,137.8-1,194.0 s.  Capped, the Krylov counts of both sides are the cap:
# tests/test_torch_dist_simplex.py holds whole solves on strips to one
# rank's counts and fields
DD_SIMPLEX_STRIPS_WIDE = (4, 1)
DD_SIMPLEX_RE = 20.0
DD_SIMPLEX_CAP = 10
DD_SIMPLEX_CONFIG3_CAP = 20
DD_SIMPLEX_NEWTON = 1
SOURCES = {
    "apply_F_fused": "navier_stokes_solver_tpu_torch/csrc/apply_f_fused.cu",
    "cell_apply_F": "navier_stokes_solver_tpu_torch/csrc/cell_apply_f.cu",
    "scatter_v_bc": "navier_stokes_solver_tpu_torch/csrc/scatter_v.cu",
}
# the kernels the solve paths launch (apply_F, one launch each), and the
# two it replaced there, which only the checks launch now: the card-side
# oracle the one-launch apply_F is held against bit for bit
PATH_KERNELS = ("apply_F_fused",)
ORACLES = ("cell_apply_F", "scatter_v_bc")
KERNELS = PATH_KERNELS + ORACLES
# odd shapes for phase 3: nx and ny not multiples of the fused kernel's
# cell tile (3 x 15 at Q3, 6 x 15 at Q2), one cell row, one cell column
# ((mesh, degrees))
ODD_SHAPES = [((7, 3), (3, 2)), ((37, 13), (3, 2)), ((33, 9), (2, 1)), ((9, 1), (3, 2)), ((1, 7), (3, 2)),
              ((5, 1), (2, 1))]
REPLACES = {
    # the Pallas kernel, with the XLA scatter and apply_F's where as its epilogue
    "apply_F_fused": "navier_stokes_solver_tpu/ops/pallas_cell.py:62",
    "cell_apply_F": "navier_stokes_solver_tpu/ops/pallas_cell.py:62",
    # XLA on the TPU (sum of dilated pads, then apply_F's two where), no Pallas kernel
    "scatter_v_bc": "navier_stokes_solver_tpu/ops/matfree.py:91",
}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def adopt_orphans():
    """Make this process the reaper of every process it starts, however
    deep (Linux ``PR_SET_CHILD_SUBREAPER``): a grandchild whose parent
    exits becomes this process's child, so ``stop_children`` finds it."""
    import ctypes

    ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)


def descendants() -> dict[int, str]:
    """The processes below this one still in the process table (zombies
    included): {pid: "[state] command line"}."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            name, (state, ppid) = stat[stat.find("(") + 1:stat.rfind(")")], stat.rsplit(")", 1)[1].split()[:2]
            ppid, cmd = int(ppid), f"[{state}] {cmd or name}"
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append((int(entry), cmd))
    out, todo = {}, [os.getpid()]
    while todo:
        for pid, cmd in children.get(todo.pop(), []):
            out[pid] = cmd
            todo.append(pid)
    return out


def stop_children(grace_s=10.0) -> dict[int, str]:
    """Stop every process the script started that is still there: each
    descendant but the multiprocessing resource tracker (SIGTERM, SIGKILL
    after ``grace_s``), reaped, then the tracker (closed and reaped: it
    ends once no process holds its pipe).  Returns what was found besides
    the tracker: {pid: "[state] command line"}."""
    import signal
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    others = lambda: {pid: cmd for pid, cmd in descendants().items() if pid != tracker._pid}
    found = left = others()
    deadline, sig = time.monotonic() + grace_s, signal.SIGTERM
    while left:
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        time.sleep(0.1)
        while True:  # reap this process's exited children (orphans included)
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
        left = others()
        if time.monotonic() > deadline:
            sig = signal.SIGKILL
    tracker._stop()
    return found


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
    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc

    geo = (make_geometry or make_channel_geometry)(*mesh)
    return kernel_inputs(make_disc(make_fe_space(geo, *deg), dtype, device), seed)


def kernel_inputs(disc, seed=0):
    """``kernel_case``'s ``(disc, linq, x_u, bc_diag)`` for a given disc (a
    tile of a decomposition too), on its device and in its dtype."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.ops import Blocks, diag_F, eval_state

    rng = np.random.default_rng(seed)
    put = lambda a: torch.as_tensor(a, device=disc.device).to(disc.dtype)
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


def apply_f_fused_cost(disc, stokes, with_bc, batch=None):
    """Bytes and flops of one ``apply_F_fused`` call: the cell apply's
    inputs (the lattice, the linearization, ``cell_w``, the tables, the
    viscosities) and, with the rows, ``bc_diag`` and the two bool masks,
    each read once, and the lattice written once.  The cell-local results
    stay on chip and the halo's second reads are not counted; ``batch`` as
    in ``cell_apply_cost``."""
    n_q, n_v = disc.cell_tabs.shape[1:]
    C = disc.nx * disc.ny
    NY, NX = disc.NV
    member = 4 * NY * NX  # x read, out written
    shared = n_q * C + 3 * n_q * n_v
    mask_bytes = 0
    if stokes:
        flops = C * (16 * n_q * n_v + 8 * n_q)
    else:
        member += 6 * n_q * C
        flops = C * (24 * n_q * n_v + 28 * n_q)
    flops += 2 * n_v * C  # the ordered sums
    if with_bc:
        member += 2 * NY * NX  # diag
        mask_bytes = 2 * NY * NX
    words = shared + member if batch is None else shared + batch * (member + 1)
    return words * disc.cell_w.element_size() + mask_bytes, flops * (batch or 1)


def check_path_launches(counts, what):
    """Raise unless ``counts`` (``read_counts``) show that a solve path
    launched the one-launch apply_F and neither kernel it replaced there."""
    for name in PATH_KERNELS:
        if counts[name]["launches"] <= 0:
            raise RuntimeError(f"{what} never launched {name}")
    for name in ORACLES:
        if counts[name]["launches"]:
            raise RuntimeError(f"{what} launched {name} {counts[name]['launches']} times: only the checks may")


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
    """The three kernels against their plain versions at one shape and
    dtype (``check_disc``): returns the largest |kernel - plain| of each."""
    disc, linq, x, bc = kernel_case(device, mesh, deg, dtype, make_geometry=make_geometry)
    return check_disc(disc, linq, x, bc, f"{label}{mesh[0]}x{mesh[1]} Q{deg[0]}/Q{deg[1]} {str(dtype)[6:]}")


def check_disc(disc, linq, x, bc, shape, log=print):
    """The kernels against their plain versions on ``disc`` (``shape``
    names it), in both regimes, after the 32-bit offset check of every
    operand: ``cell_apply_F`` through both entry points and a permuted
    lattice layout within ``KERNEL_TOL``; ``scatter_v_bc`` bit for bit,
    with and without the boundary rows; ``apply_F_fused``, with and
    without the rows, on the lattice and on its permuted layout, bit for
    bit against the two launches it replaced
    (``scatter_v_bc(cell_apply_F_lattice(...))``, the card-side oracle) and
    within ``KERNEL_TOL`` of its plain version.  Returns the largest
    |kernel - plain| of each, in ``KERNELS``' order.  On a tile of a
    decomposition ``scatter_v_bc`` and ``apply_F_fused`` (kernels and
    plain versions alike) complete their seams with the neighbours: every
    rank of the tile grid must call this in step.  ``log`` takes each
    line."""
    import torch

    from navier_stokes_solver_tpu_torch.ops import apply_f_kernel
    from navier_stokes_solver_tpu_torch.ops.apply_f_kernel import apply_F_fused, apply_F_fused_plain
    from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
        cell_apply_F,
        cell_apply_F_lattice,
        cell_apply_F_lattice_plain,
    )
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    err_a = err_b = err_f = 0.0
    # the layout a multigrid transfer's einsum hands the kernel
    x_perm = x.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    tol = KERNEL_TOL[str(disc.dtype)[6:]]
    views = {"lattice view": lattice_view(x, disc.deg_v, disc.ny, disc.nx), "permuted view": lattice_view(x_perm, disc.deg_v, disc.ny, disc.nx), "linq.gradu": linq.gradu, "output": _gather_v(disc, x)}
    offsets = {k: max_offset(v) for k, v in views.items()}
    log(f"[check] {shape}: largest element offsets {json.dumps(offsets)} (32-bit limit {INDEX_LIMIT})")
    if max(offsets.values()) >= INDEX_LIMIT:
        raise RuntimeError(f"an operand at {shape} exceeds the kernels' 32-bit indexing: {offsets}")
    for stokes in (True, False):
        tag = f"{shape} {'stokes' if stokes else 'newton'}"
        args = (disc, KERNEL_NU, KERNEL_INV_DT, None if stokes else linq)
        want = cell_apply_F_lattice_plain(*args, x, stokes=stokes)
        got = {
            "lattice": cell_apply_F_lattice(*args, x, stokes=stokes),
            "lattice, permuted": cell_apply_F_lattice(*args, x_perm, stokes=stokes),
            # contiguous: at nx = 1 the gather is a view, not a copy
            "gathered": cell_apply_F(*args, _gather_v(disc, x).contiguous(), stokes=stokes),
        }
        torch.cuda.synchronize()
        for entry, g in got.items():
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"cell_apply_F ({entry}): non-finite output at {tag}")
            err = (g - want).abs()
            bad = int((err > tol + tol * want.abs()).sum())
            e = float(err.max())
            err_a = max(err_a, e)
            log(f"[check] cell_apply_F ({entry}) {tag}: max|kernel-plain| {e:.3e} (max|plain| {float(want.abs().max()):.3e}), {bad} entries outside rtol=atol={tol:g}")
            if bad:
                raise RuntimeError(f"cell_apply_F ({entry}) disagrees with its plain version at {tag}")
        for b_, xx, what in ((None, x, "raw"), (bc, x, "bc"), (bc, x_perm, "bc, permuted x")):
            g = scatter_v_bc(disc, want, bc_diag=b_, x_u=xx)
            w = scatter_v_bc_plain(disc, want, bc_diag=b_, x_u=xx)
            e = float((g - w).abs().max())
            err_b = max(err_b, e)
            same = torch.equal(g, w)
            log(f"[check] scatter_v_bc ({what}) {tag}: max|kernel-plain| {e!r}, bitwise equal {same}")
            if e != 0.0 or not same:
                raise RuntimeError(f"scatter_v_bc ({what}) is not bit-identical to its plain version at {tag}")
        for b_, xx, what in ((None, x, "raw"), (bc, x, "bc"), (None, x_perm, "raw, permuted x"), (bc, x_perm, "bc, permuted x")):
            g = apply_F_fused(*args, xx, stokes=stokes, bc_diag=b_)
            two = scatter_v_bc(disc, cell_apply_F_lattice(*args, xx, stokes=stokes), bc_diag=b_, x_u=xx)
            w = apply_F_fused_plain(*args, xx, stokes=stokes, bc_diag=b_)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"apply_F_fused ({what}): non-finite output at {tag}")
            same = torch.equal(g, two)
            # every block shape the kernel is built with gives the same bits
            # (on a tile the launch is the seam sum's operand: not compared)
            shapes = [] if disc.decomposed else [
                torch.equal(apply_f_kernel._launch(*args, xx, b_, stokes, (), shape), g)
                for shape in range(len(apply_f_kernel.BLOCK_SHAPES[disc.deg_v]))]
            err = (g - w).abs()
            bad = int((err > tol + tol * w.abs()).sum())
            e = float(err.max())
            err_f = max(err_f, e)
            log(f"[check] apply_F_fused ({what}) {tag}: bitwise equal to the two launches {same} (max|diff| {float((g - two).abs().max())!r}), at each block shape {shapes}; max|kernel-plain| {e:.3e} (max|plain| {float(w.abs().max()):.3e}), {bad} entries outside rtol=atol={tol:g}")
            if not same or not all(shapes):
                raise RuntimeError(f"apply_F_fused ({what}) is not bit-identical to scatter_v_bc(cell_apply_F_lattice(...)) at {tag}")
            if bad:
                raise RuntimeError(f"apply_F_fused ({what}) disagrees with its plain version at {tag}")
    return err_f, err_a, err_b


def phase_check(device):
    import torch

    errs = dict.fromkeys(KERNELS, 0.0)
    for mesh, deg in kernel_shapes(device) + ODD_SHAPES:
        full = mesh in (BENCH_MESH, (20, 9), UNSTEADY_MESH, CONFIG1_MESH) or (mesh, deg) in ODD_SHAPES
        for dtype in (torch.float32, torch.float64) if full else (torch.float32,):
            errs = fold_errs(errs, check_shape(device, mesh, deg, dtype))
    return errs


def fold_errs(errs, more):
    """``errs`` ({kernel: largest error}) with ``more`` (a dict, or a tuple
    in ``KERNELS``' order) folded in."""
    more = more if isinstance(more, dict) else dict(zip(KERNELS, more))
    return {name: max(errs[name], more[name]) for name in KERNELS}


# ---------------------------------------------------------------------------
# 4. time
# ---------------------------------------------------------------------------


def time_shape(device, mesh, deg, make_geometry=None, label="", raw=False):
    """Phase 4's records of the three kernels at one shape, f32: {kernel:
    {tag: record}} -- each kernel's device time, host-inclusive time, plain
    version's time, library yardstick's time and bound, in both regimes;
    ``apply_F_fused`` with its rows, beside the two launches it replaced
    (``two_launch_ms``: their device time back to back;
    ``two_launch_host_ms``: their host-inclusive time), its yardstick the
    Stokes ``torch.matmul`` plus ``index_add_``; with ``raw`` also
    ``scatter_v_bc`` and ``apply_F_fused`` without their rows."""
    import torch

    from navier_stokes_solver_tpu_torch.ops.apply_f_kernel import apply_F_fused, apply_F_fused_plain
    from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
        cell_apply_F_lattice,
        cell_apply_F_lattice_plain,
    )
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    out = {name: {} for name in KERNELS}
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
            rec["library_ms"] = matmul_ms = device_ms(lambda: torch.matmul(K, xl))
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
    index_add_ms = rec["library_ms"]
    for stokes in (True, False):
        for b_ in (bc, None) if raw else (bc,):
            args = (disc, KERNEL_NU, KERNEL_INV_DT, None if stokes else linq, x)
            fused = lambda: apply_F_fused(*args, stokes=stokes, bc_diag=b_)
            two = lambda: scatter_v_bc(disc, cell_apply_F_lattice(*args, stokes=stokes), bc_diag=b_, x_u=x)
            rec = {
                "ms": device_ms(fused),
                "host_ms": host_ms(fused),
                "plain_ms": device_ms(lambda: apply_F_fused_plain(*args, stokes=stokes, bc_diag=b_), PLAIN_CALLS),
                "two_launch_ms": device_ms(two),
                "two_launch_host_ms": host_ms(two),
                "library_ms": matmul_ms + index_add_ms if stokes else None,
            }
            rec["bound_ms"], rec["bound_by"] = bound(*apply_f_fused_cost(disc, stokes, b_ is not None))
            tag = f"{shape} {'stokes' if stokes else 'newton'} {'raw' if b_ is None else 'bc'}"
            out["apply_F_fused"][tag] = rec
            print(f"[time] apply_F_fused {tag}: {json.dumps(rec)}")
    if raw:
        # without the boundary rows: a tile's launch (its rows come after
        # the seam exchange)
        rec = {
            "ms": device_ms(lambda: scatter_v_bc(disc, loc)),
            "host_ms": host_ms(lambda: scatter_v_bc(disc, loc)),
            "plain_ms": device_ms(lambda: scatter_v_bc_plain(disc, loc), PLAIN_CALLS),
            "library_ms": device_ms(lambda: acc.index_add_(0, idx, src)),
        }
        rec["bound_ms"], rec["bound_by"] = bound(*scatter_cost(disc, False))
        tag = f"{shape} raw"
        out["scatter_v_bc"][tag] = rec
        print(f"[time] scatter_v_bc {tag}: {json.dumps(rec)}")
    return out


def phase_time(device):
    """Per kernel: {shape tag: timing record}, f32, at every multigrid
    level of the three main paths, and at dd-north's tile shape (an
    undecomposed channel of that shape: the kernels' work is the tile's;
    ``scatter_v_bc`` and ``apply_F_fused`` also without their rows, as a
    tile launches them)."""
    out = {name: {} for name in KERNELS}
    for mesh in chain_shapes(device) + [DD_NORTH_TILE]:
        for name, recs in time_shape(device, mesh, (3, 2), raw=mesh == DD_NORTH_TILE).items():
            out[name].update(recs)
    return out


# ---------------------------------------------------------------------------
# 5. launches per apply_F
# ---------------------------------------------------------------------------


def device_events(prof):
    """The device-side activities (kernels, copies, fills) of a profile."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def marker_window(names):
    """``((start, end), markers)`` of a trace's activity names in time order:
    the recorded call lies between the last two runs of consecutive
    markers (the leading ones and the trailing ones), ``(start, end)`` None
    when the trace lacks either run or anything follows the trailing one."""
    marks = [i for i, n in enumerate(names) if PROFILE_MARKER in n]
    runs = []
    for i in marks:
        if runs and runs[-1][-1] == i - 1:
            runs[-1].append(i)
        else:
            runs.append([i])
    if len(runs) < 2 or runs[-1][-1] != len(names) - 1:
        return None, len(marks)
    return (runs[-2][-1] + 1, runs[-1][0]), len(marks)


def profile_call(fn, warm=None):
    """``(device activities, result, wall seconds)`` of one call of ``fn``.
    The tracer drops the first activities of a trace -- none, one, or (after
    much untraced work) thousands -- and, in long traces, the last one, so a
    warm-up call (``warm``, by default ``fn``) runs inside the trace and is
    discarded, then
    ``PROFILE_LEAD`` marker kernels (``torch.cuda._sleep``'s
    ``spin_kernel``), the recorded call and ``PROFILE_TAIL`` markers.  A
    trace that lacks every leading or every trailing marker is taken again,
    up to ``PROFILE_ATTEMPTS`` times.  Only the activities between the last
    leading and the first trailing marker are returned
    (``marker_window``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (warm or fn)()
            torch.cuda.synchronize()
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for _ in range(PROFILE_TAIL):
                torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize()
        events = sorted(device_events(prof), key=lambda e: e.time_range.start)
        window, n_marks = marker_window([e.name for e in events])
        if window is not None:
            PROFILE_WINDOWS.append((attempt, PROFILE_LEAD + PROFILE_TAIL - n_marks))
            return events[window[0] : window[1]], out, wall
        print(f"[profile] trace {attempt + 1} of {PROFILE_ATTEMPTS} holds {n_marks} of its "
              f"{PROFILE_LEAD + PROFILE_TAIL} markers ({len(events)} device activities): taken again")
    raise RuntimeError(f"the profiler dropped the leading or the trailing markers in all {PROFILE_ATTEMPTS} traces")


def phase_launches(device):
    import torch

    from navier_stokes_solver_tpu_torch.ops import apply_F

    disc, linq, x, bc = kernel_case(device, BENCH_MESH, (3, 2), torch.float32)
    for stokes in (True, False):
        call = lambda: apply_F(disc, KERNEL_NU, KERNEL_INV_DT, None if stokes else linq, x, stokes=stokes, bc_diag=bc)
        names = [e.name for e in profile_call(call)[0]]
        print(f"[launches] one apply_F ({'stokes' if stokes else 'newton'}): {len(names)} device kernels: {names}")
        if len(names) != 1 or "apply_f_fused_kernel" not in names[0]:
            raise RuntimeError(f"one apply_F ran {len(names)} device kernels, not the one of ours: {names}")


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
    from navier_stokes_solver_tpu_torch.ops.apply_f_kernel import apply_F_fused
    from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc

    return {"apply_F_fused": apply_F_fused, "cell_apply_F": cell_apply_F, "scatter_v_bc": scatter_v_bc}


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
    check_path_launches(counts, "the main path")
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

    ours = {"apply_F_fused": "apply_f_fused_kernel", "cell_apply_F": "cell_apply_f_kernel", "scatter_v_bc": "scatter_v_kernel"}
    win, by_name = {}, {}
    for n in (1, 1 + iters):
        # a one-iteration warm-up keeps the longer window's trace short
        ev, (_, info), wall = profile_call(lambda: solve(n), warm=lambda: solve(1))
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


def phase_unsteady_check(device, cpu_side, card_side=None):
    """The per-step ramp path on the card against the same run on the CPU
    (``cpu_side``: the future of ``cpu_job("unsteady-check")``;
    ``card_side``: the future of ``card_job("unsteady-check")``, by default
    run here)."""
    import numpy as np

    card = unsteady_check_run(device) if card_side is None else card_side.result()
    runs = {"card": card, "cpu": cpu_side.result()}
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
    check_path_launches(counts, "the unsteady path")
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
    check_path_launches(counts, "config1")
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


def matrix_card(device):
    """The card side of the matrix phase, as plain data: every ``MATRIX``
    run, the ``MATRIX_TANGENT`` solves, every ``MATRIX_CARD_ONLY`` run and
    the wall."""
    t0 = time.perf_counter()
    return {
        "card": [matrix_run(device, fields, cfg) for _, fields, cfg in MATRIX],
        "tangent": matrix_tangent_run(device),
        "card_only": [matrix_run(device, fields, cfg) for _, fields, cfg in MATRIX_CARD_ONLY],
        "wall_s": time.perf_counter() - t0,
    }


def phase_matrix(device, cpu_side, card_side=None):
    """``MATRIX`` on the card and on the CPU (the plain versions; ``cpu_side``:
    the future of ``cpu_job("matrix")``; ``card_side``: the future of
    ``card_job("matrix")``, by default run here), all-f64: Newton histories
    equal, Krylov counts per solve within 1, drag and lift within rtol 1e-7
    (the lift floored at 1e-7 of the drag), fields within 1e-6 of their
    magnitude.  Then ``MATRIX_TANGENT`` (card vs CPU) and
    ``MATRIX_CARD_ONLY``."""
    import numpy as np

    key = lambda h: (h["phase"], h["nu"], h["n_iter"])
    got = matrix_card(device) if card_side is None else card_side.result()
    card, card_tangent = got["card"], got["tangent"]
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
    for (name, _, _), run in zip(MATRIX_CARD_ONLY, got["card_only"], strict=True):
        (u, p), forces = run["fields"], run["forces"]
        counts = [h.get("krylov_iters", 0) for h in solves_of(run)]
        print(f"[matrix] {name} (card only): wall {run['wall_s']:.2f} s, Krylov counts per solve {counts}, drag and lift {forces}")
        if not (np.isfinite(u).all() and np.isfinite(p).all() and np.isfinite(forces).all()) or sum(counts) <= 0:
            raise RuntimeError(f"matrix {name}: no finite converged solve on the card")
    print(f"[matrix] {len(MATRIX)} whole-solve entries, {len(MATRIX_TANGENT)} tangent solves and {len(MATRIX_CARD_ONLY)} card-only solves at {MATRIX_MESH[0]}x{MATRIX_MESH[1]} in {got['wall_s']:.1f} s on the card")


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
    and name the one-launch apply_F's kernel, and neither kernel it
    replaced on the solve paths.  Written under the git-ignored ``_chip/`` and
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
        found = {k: any(k in n for n in names) for k in ("apply_f_fused_kernel", "cell_apply_f_kernel", "scatter_v_kernel")}
        print(f"[profile] --profile-dir trace {size} bytes, {len(names)} distinct event names; kernels found {json.dumps(found)}")
        if found["cell_apply_f_kernel"] or found["scatter_v_kernel"]:
            raise RuntimeError(f"the --profile-dir trace names a kernel the solve paths no longer launch: {found}")
        if found["apply_f_fused_kernel"]:
            return
    raise RuntimeError(f"the --profile-dir trace does not name apply_f_fused_kernel in {PROFILE_ATTEMPTS} runs: {found}")


# ---------------------------------------------------------------------------
# 14. simplex-check, 15. config3, 16. config3-lu, 17. simplex-file
# ---------------------------------------------------------------------------


def simplex_run(device, unsteady, fields, cfg):
    """One ``-M`` run at ``SIMPLEX_CHECK_MESH``, Re 20, FGMRES +
    blockTriangular, all-f64 -- the stationary continuation (tol 1e-8) or
    ``SIMPLEX_CHECK_STEPS`` unsteady steps with the per-step ramp (tol
    1e-9) -- as plain data:
    DoFs, history, host fields, (drag, lift) per solve or step."""
    from navier_stokes_solver_tpu_torch.api import NSSolver, NSSolverStationary, SolverOptions
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    o = dict(
        mesh_size=SIMPLEX_CHECK_MESH, read_mesh_from_file=True, Re=20.0, solver_type=1,
        preconditioner_type=1, verbose=False, device=device,
        precond_config=PrecondConfig(vmult_dtype=None, mg_dtype=None, **cfg),
    )
    if unsteady:
        s = NSSolver(SolverOptions(**o, tolerance=1e-9, time_span=SIMPLEX_CHECK_STEPS * UNSTEADY_DT, time_step=UNSTEADY_DT,
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
    "simplex-check", "fused-check", "ensemble-check", "ensemble-matrix-check",
    "cavity-check" or "ensemble-rest-check" -- as plain data, for a worker
    process."""
    import torch

    torch.set_num_threads(CPU_SIDE_THREADS)
    os.setpriority(os.PRIO_PROCESS, 0, CPU_SIDE_NICE)
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
    if name == "ensemble-matrix-check":
        return ensemble_matrix_check_run(cpu)
    if name == "cavity-check":
        return cavity_check_run(cpu)
    if name == "ensemble-rest-check":
        return ensemble_rest_check_run(cpu)
    raise ValueError(f"no CPU side named {name!r}")


# the card-vs-CPU phases, whose card sides run in the worker processes on the
# card after ensemble-matrix's combinations (``card_job``), in this order
CARD_SIDES = ("unsteady-check", "matrix", "simplex-check", "cavity-check", "fused-check", "ensemble-check",
              "ensemble-matrix-check", "ensemble-rest-check")
# the order in which the card workers take their jobs (ensemble-matrix's
# combinations by index, the card sides by name): the longest first, from
# their walls in two whole runs of this script on an NVIDIA H100 80GB HBM3,
# 700.00 W (four workers beside the -M phases) -- (d) 395-415 s,
# simplex-check 381-405 s, fused-check 308-315 s, unsteady-check ~240 s,
# matrix ~200 s, ensemble-matrix-check ~140 s, (e) 110 s, (c) 108 s,
# cavity-check 73-79 s, ensemble-rest-check ~70 s, ensemble-check 43-52 s,
# (f) 42 s, (b) 0.5 s; each worker takes the next job when it is free
CARD_ORDER = (
    ("matrix", 3), ("card", "simplex-check"), ("card", "fused-check"), ("card", "unsteady-check"),
    ("card", "matrix"), ("card", "ensemble-matrix-check"), ("matrix", 4), ("matrix", 2), ("card", "cavity-check"),
    ("card", "ensemble-rest-check"), ("card", "ensemble-check"), ("matrix", 5), ("matrix", 1),
)


def card_job(name):
    """The card side of one card-vs-CPU phase of ``CARD_SIDES``, as plain
    data, for a worker process on the card (one torch thread: a host-bound
    launch loop)."""
    import torch

    torch.set_num_threads(1)
    device = torch.device("cuda")
    if name == "unsteady-check":
        return unsteady_check_run(device)
    if name == "matrix":
        return matrix_card(device)
    if name == "simplex-check":
        return simplex_check_card(device)
    if name == "cavity-check":
        return cavity_check_run(device)
    if name == "fused-check":
        return fused_check_card(device)
    if name == "ensemble-check":
        return ensemble_check_run(device)
    if name == "ensemble-matrix-check":
        return ensemble_matrix_check_run(device)
    if name == "ensemble-rest-check":
        return ensemble_rest_check_run(device)
    raise ValueError(f"no card side named {name!r}")


def cpu_pool(workers, initializer=None):
    """Spawned worker processes for ``cpu_job``, ``card_job`` and
    ``ensemble_matrix_run`` (joined when the ``with`` block that holds the
    pool ends)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
                               initializer=initializer)


def wait_asleep():
    """Make a card worker wait for the card asleep
    (``cudaDeviceScheduleBlockingSync``, set before the card is first used),
    as the decomposed ranks do: several processes drive the card at once,
    and a spinning wait holds a host core the others need.  Nothing to set
    where PyTorch has no CUDA runtime."""
    import ctypes

    import torch  # loads the CUDA runtime it was built with

    if not torch.cuda.is_available():
        return
    try:
        cudart = ctypes.CDLL("libcudart.so.12")
    except OSError:
        return
    cudart.cudaSetDeviceFlags(4)


def simplex_check_card(device):
    """The card side of simplex-check, as plain data: every ``SIMPLEX_CHECK``
    run and its wall, the ``SIMPLEX_TANGENT`` solves and the whole wall."""
    t_all = time.perf_counter()
    card, walls = [], []
    for _, unsteady, fields, cfg in SIMPLEX_CHECK:
        t0 = time.perf_counter()
        card.append(simplex_run(device, unsteady, fields, cfg))
        walls.append(time.perf_counter() - t0)
    tangent = [simplex_tangent_run(device, dense, n) for dense, n, _ in SIMPLEX_TANGENT.values()]
    return {"card": card, "walls": walls, "tangent": tangent, "wall_s": time.perf_counter() - t_all}


def phase_simplex_check(device, cpu_side=None, card_side=None):
    """``SIMPLEX_CHECK`` and ``SIMPLEX_TANGENT`` on the card against the same
    on the CPU (``cpu_side``: the future of ``cpu_job("simplex-check")``; by
    default one worker process started here; ``card_side``: the future of
    ``card_job("simplex-check")``, by default run here)."""
    import numpy as np

    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_simplex_check(device, pool.submit(cpu_job, "simplex-check"), card_side)
    key = lambda h: (h["phase"], h["nu"], h["n_iter"])
    t_all = time.perf_counter()
    got = simplex_check_card(device) if card_side is None else card_side.result()
    card, walls, card_tangent = got["card"], got["walls"], got["tangent"]
    cpu, cpu_tangent = cpu_side.result()
    print(f"[simplex-check] card side {got['wall_s']:.1f} s; waited {time.perf_counter() - t_all:.1f} s here for both sides (CPU side: worker process, {CPU_SIDE_THREADS} threads)")
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
    print(f"[simplex-check] {len(SIMPLEX_CHECK)} whole runs and {len(SIMPLEX_TANGENT)} capped tangent solves at -M {SIMPLEX_CHECK_MESH[0]}x{SIMPLEX_CHECK_MESH[1]} in {got['wall_s']:.1f} s on the card")


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
    if len(run["steps"]) != CONFIG3_STEPS:
        raise RuntimeError(f"config3 ran {len(run['steps'])} steps, not {CONFIG3_STEPS}")
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


def fused_check_card(device):
    """The card side of fused-check, as plain data: every ``FUSED_CHECK``
    run, then the first case split after step 1 through a checkpoint
    directory (``first``, ``split``), and the wall."""
    import tempfile

    t0 = time.perf_counter()
    card = [fused_run(device, fields, kw) for _, fields, kw in FUSED_CHECK]
    _, fields, kw = FUSED_CHECK[0]
    with tempfile.TemporaryDirectory() as ck:
        first = fused_run(device, fields, kw, checkpoint_dir=ck, max_steps=1)
        split = fused_run(device, fields, kw, checkpoint_dir=ck)
    return {"card": card, "first": first, "split": split, "wall_s": time.perf_counter() - t0}


def phase_fused_check(device, cpu_side=None, card_side=None):
    """``FUSED_CHECK`` on the card against the same on the CPU (``cpu_side``:
    the future of ``cpu_job("fused-check")``; by default one worker process
    started here; ``card_side``: the future of ``card_job("fused-check")``,
    by default run here): Newton and Krylov counts per step within 1, drag
    and lift per step rtol 1e-7 (the lift floored at 1e-7 of the drag),
    fields 1e-6 of their magnitude.  Then a save -> load -> resume round
    trip on the card: the first case split after step 1 through a
    checkpoint directory equals its unsplit run bit for bit."""
    import numpy as np

    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_fused_check(device, pool.submit(cpu_job, "fused-check"), card_side)
    t_all = time.perf_counter()
    got = fused_check_card(device) if card_side is None else card_side.result()
    card, first, split = got["card"], got["first"], got["split"]
    cpu = cpu_side.result()
    print(f"[fused-check] card side {got['wall_s']:.1f} s; waited {time.perf_counter() - t_all:.1f} s here for both sides")
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
    print(f"[fused-check] {len(FUSED_CHECK)} cases and the round trip in {got['wall_s']:.1f} s on the card")


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
    check_path_launches(counts, "the fused path")
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
    permuted lattice layout; ``apply_F_fused`` also bit for bit against the
    two batched launches it replaced; the largest errors go into
    ``errs``."""
    import torch

    from navier_stokes_solver_tpu_torch.ops import LinearizationQ, apply_f_kernel
    from navier_stokes_solver_tpu_torch.ops.apply_f_kernel import apply_F_fused, apply_F_fused_plain
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
        for b_, xx, what in ((None, x, "raw"), (bc, x, "bc"), (None, x_perm, "raw, permuted x"), (bc, x_perm, "bc, permuted x")):
            g = apply_F_fused(disc, nus, KERNEL_INV_DT, lq, xx, stokes=stokes, bc_diag=b_)
            two = scatter_v_bc(disc, cell_apply_F_lattice(disc, nus, KERNEL_INV_DT, lq, xx, stokes=stokes), bc_diag=b_, x_u=xx)
            w = apply_F_fused_plain(disc, nus, KERNEL_INV_DT, lq, xx, stokes=stokes, bc_diag=b_)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"apply_F_fused (batched, {what}): non-finite output at {tag}")
            err = (g - w).abs()
            bad = int((err > tol + tol * w.abs()).sum())
            e = float(err.max())
            errs["apply_F_fused"] = max(errs["apply_F_fused"], e)
            same = sum(
                torch.equal(g[b], apply_F_fused(
                    disc, nu_h[b], KERNEL_INV_DT, None if stokes else members[b], xx[b].contiguous(),
                    stokes=stokes, bc_diag=None if b_ is None else b_[b]))
                for b in range(B)
            )
            shapes = [torch.equal(apply_f_kernel._launch(disc, nus, KERNEL_INV_DT, lq, xx, b_, stokes, (B,), shape), g)
                      for shape in range(len(apply_f_kernel.BLOCK_SHAPES[disc.deg_v]))]
            print(f"[ensemble-kernels] apply_F_fused (batched, {what}) {tag}: bitwise equal to the two batched launches {torch.equal(g, two)}, at each block shape {shapes}; max|kernel-plain| {e:.3e} (max|plain| {float(w.abs().max()):.3e}), {bad} entries outside rtol=atol={tol:g}; members bit-identical to their unbatched launch {same} of {B}")
            if not torch.equal(g, two) or same != B or not all(shapes):
                raise RuntimeError(f"apply_F_fused (batched, {what}) is not bit-identical at {tag}")
            if bad:
                raise RuntimeError(f"apply_F_fused (batched, {what}) disagrees with its plain version at {tag}")


def phase_ensemble_kernels(device):
    """Both kernels with the member axis at every level of BASELINE config
    5's multigrid chain (60x40 Q2/Q1 down to its coarsest level, B = 64),
    f32 and f64, both regimes: ``ensemble_kernel_check``.  Then, at 60x40
    f32, phase 4's timings of the batched launch: device time,
    host-inclusive time, the plain version's, the library call's (a
    batched matmul of the per-member Stokes element matrices;
    ``index_add_`` of all members) and the bound (``cell_apply_cost`` /
    ``scatter_cost`` over B members: the shared operands counted once), and
    ``apply_F_fused``'s with its rows beside the two batched launches it
    replaced (its yardstick: the batched matmul plus ``index_add_``).
    Returns ``(max errors, {kernel: {tag: record}})``."""
    import torch

    from navier_stokes_solver_tpu_torch.ops.apply_f_kernel import apply_F_fused, apply_F_fused_plain
    from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F_lattice, cell_apply_F_lattice_plain
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    B, (mx, my) = ENSEMBLE_B, ENSEMBLE_MESH
    errs = dict.fromkeys(KERNELS, 0.0)
    times = {name: {} for name in KERNELS}
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
            rec["library_ms"] = matmul_ms = device_ms(lambda: torch.matmul(Kb, xl))
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
    index_add_ms = rec["library_ms"]
    for stokes in (True, False):
        args = (disc, nus, KERNEL_INV_DT, None if stokes else linq, x)
        fused = lambda: apply_F_fused(*args, stokes=stokes, bc_diag=bc)
        two = lambda: scatter_v_bc(disc, cell_apply_F_lattice(*args, stokes=stokes), bc_diag=bc, x_u=x)
        rec = {
            "ms": device_ms(fused),
            "host_ms": host_ms(fused),
            "plain_ms": device_ms(lambda: apply_F_fused_plain(*args, stokes=stokes, bc_diag=bc), PLAIN_CALLS),
            "two_launch_ms": device_ms(two),
            "two_launch_host_ms": host_ms(two),
            "library_ms": matmul_ms + index_add_ms if stokes else None,
        }
        rec["bound_ms"], rec["bound_by"] = bound(*apply_f_fused_cost(disc, stokes, True, B))
        tag = f"{mx}x{my} Q2/Q1 float32 B{B} {'stokes' if stokes else 'newton'} bc"
        times["apply_F_fused"][tag] = rec
        print(f"[time] apply_F_fused {tag}: {json.dumps(rec)}")
    return errs, times


def ensemble_check_run(device, opts=None, fields=None, cap=20):
    """The ensemble check's run on one device, as plain data: per-step
    history [T, B], host fields [B, ...], wall.  ``opts``/``fields``: the
    step keywords and PrecondConfig fields (config 5's FGMRES +
    blockTriangular + Cahouet-Chabard by default), all-f64; ``cap``: the
    Krylov cap of every tangent solve."""
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import run_sweep
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    disc = ensemble_disc(device, ENSEMBLE_CHECK_MESH, torch.float64)
    nus = [1.0 / re for re in ENSEMBLE_CHECK_RE]
    cfg = PrecondConfig(**(fields if fields is not None else dict(schur_mode="cahouet", cc_lp_cycles=1)),
                        vmult_dtype=None, mg_dtype=None)
    opts = opts or dict(solver_type=1, prec_type=1)
    t0 = time.perf_counter()
    final, hist = run_sweep(disc, nus, UNSTEADY_DT, ENSEMBLE_CHECK_STEPS, precond_cfg=cfg, tol=1e-9, newton_max=3,
                            krylov_maxiter=cap, **opts)
    return {"hist": {k: v.cpu().numpy() for k, v in hist.items()},
            "fields": tuple(t.cpu().numpy() for t in final.solution), "wall_s": time.perf_counter() - t0}


def ensemble_matrix_check_run(device):
    """``ensemble_check_run`` of every combination of ``ENSEMBLE_MATRIX``."""
    return [ensemble_check_run(device, opts, fields, cap) for _, opts, fields, cap in ENSEMBLE_MATRIX]


def phase_ensemble_check(device, cpu_side=None, card_side=None):
    """A small ensemble on the card against the same on the CPU
    (``cpu_side``: the future of ``cpu_job("ensemble-check")``; by default
    one worker process started here; ``card_side``: the future of
    ``card_job("ensemble-check")``, by default run here):
    ``compare_ensemble_runs``."""
    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_ensemble_check(device, pool.submit(cpu_job, "ensemble-check"), card_side)
    mx, my = ENSEMBLE_CHECK_MESH
    where = f"{mx}x{my} Q2/Q1, Re {list(ENSEMBLE_CHECK_RE)}, {ENSEMBLE_CHECK_STEPS} steps"
    g = ensemble_check_run(device) if card_side is None else card_side.result()
    compare_ensemble_runs("ensemble-check", where, g, cpu_side.result())


def compare_ensemble_runs(tag, where, g, c, krylov_per_newton=False):
    """An ensemble run on the card (``g``) against the same on the CPU
    (``c``), as ``ensemble_check_run`` returns them: per step and member the
    Newton and Krylov counts within 1 (``krylov_per_newton``: the Krylov
    totals within the step's Newton count, one per tangent solve), drag and
    lift rtol 1e-7 (the lift floored at 1e-7 of the drag), each member's
    fields within 1e-6 of its magnitude."""
    import numpy as np

    print(f"[{tag}] {where}: walls card {g['wall_s']:.2f} s, CPU {c['wall_s']:.2f} s")
    for k in ("newton_iters", "krylov_iters"):
        a, b = g["hist"][k], c["hist"][k]
        slack = np.maximum(1, c["hist"]["newton_iters"]) if k == "krylov_iters" and krylov_per_newton else 1
        print(f"[{tag}] {k} per step and member: card {a.tolist()}, CPU {b.tolist()}")
        if a.shape != b.shape or np.any(np.abs(a.astype(int) - b.astype(int)) > slack):
            raise RuntimeError(f"{tag}: {where}: {k} differ by more than {'the Newton count' if np.ndim(slack) else 1}")
    dg, dc, lg, lc = g["hist"]["drag"], c["hist"]["drag"], g["hist"]["lift"], c["hist"]["lift"]
    rel = np.abs(dg - dc) / np.where(dc == 0.0, 1.0, np.abs(dc))  # (b) stops at rest: drag 0
    print(f"[{tag}] drag card {dg.tolist()} CPU {dc.tolist()}; max rel diff {float(rel.max()):.3e}; lift max |diff| {float(np.abs(lg - lc).max()):.3e}")
    if not (np.all(np.abs(dg - dc) <= 1e-7 * np.abs(dc)) and np.all(np.abs(lg - lc) <= 1e-7 * np.maximum(np.abs(lc), np.abs(dc)))):
        raise RuntimeError(f"{tag}: {where}: drag/lift outside rtol 1e-7")
    for field, a, b in zip(("velocity", "pressure"), g["fields"], c["fields"]):
        for m in range(a.shape[0]):
            err, scale = float(np.abs(a[m] - b[m]).max()), float(np.abs(b[m]).max())
            print(f"[{tag}] member {m} {field} max|card - CPU| {err:.3e} (max|CPU| {scale:.3e})")
            if not err <= FIELD_GATE * scale:
                raise RuntimeError(f"{tag}: {where}: member {m} {field} differs by {err} > {FIELD_GATE} x {scale}")


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
    check_path_launches(counts, "the ensemble path")
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
# 29. ensemble-matrix-check, 30. ensemble-matrix
# ---------------------------------------------------------------------------


def phase_ensemble_matrix_check(device, cpu_side=None, card_side=None):
    """Every combination of ``ENSEMBLE_MATRIX`` as a small ensemble on the
    card against the same on the CPU (``cpu_side``: the future of
    ``cpu_job("ensemble-matrix-check")``; by default one worker process
    started here; ``card_side``: the future of
    ``card_job("ensemble-matrix-check")``, by default run here):
    ``compare_ensemble_runs`` for each."""
    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_ensemble_matrix_check(device, pool.submit(cpu_job, "ensemble-matrix-check"), card_side)
    mx, my = ENSEMBLE_CHECK_MESH
    card = ensemble_matrix_check_run(device) if card_side is None else card_side.result()
    for (label, _, _, cap), g, c in zip(ENSEMBLE_MATRIX, card, cpu_side.result(), strict=True):
        where = (f"({label}) {mx}x{my} Q2/Q1, Re {list(ENSEMBLE_CHECK_RE)}, {ENSEMBLE_CHECK_STEPS} steps, "
                 f"tangent solves capped at {cap}")
        compare_ensemble_runs("ensemble-matrix-check", where, g, c)


def watch_tangent_solves():
    """Wrap ``api.kernels.solve_kernel`` (the fused step's tangent solves):
    returns the list it appends to, per batched call, ``(members that
    iterated, iterations, BiCGStab's failed flags)`` as host arrays, and
    the function that restores the original."""
    import numpy as np

    from navier_stokes_solver_tpu_torch.api import kernels

    calls, solve = [], kernels.solve_kernel

    def watched(*a, **kw):
        x, info = solve(*a, **kw)
        calls.append((np.asarray(kw["active"], bool), np.asarray(info.iters), np.asarray(info.failed, bool)))
        return x, info

    kernels.solve_kernel = watched

    def restore():
        kernels.solve_kernel = solve

    return calls, restore


def ensemble_matrix_run(index):
    """Combination ``ENSEMBLE_MATRIX[index]`` at config 5's width (60x40
    Q2/Q1, B = 64, Re 20..100, dt 0.01, tol 1e-9, ``newton_max`` 3,
    ``krylov_maxiter`` 200, f32 preconditioner, the reference's sign) on the
    card, as plain data, for a worker process: ``ENSEMBLE_MATRIX_STEPS``
    steps from rest through ``ensemble.make_ensemble_step``, the kernel
    counts zeroed just before the first step and read just after the last.
    Per step: wall, member-steps/s, each member's Newton count, Krylov total
    and final residual, drag and lift, the members BiCGStab marked failed
    in some tangent solve and those whose last tangent solve took no
    iteration (the step's stagnation break)."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import initial_ensemble_state, make_ensemble_step
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    torch.set_num_threads(1)  # a host-bound launch loop: leave the cores to the CPU sides
    _, opts, fields, _ = ENSEMBLE_MATRIX[index]
    device = torch.device("cuda")
    B, dt = ENSEMBLE_B, UNSTEADY_DT
    disc = ensemble_disc(device, ENSEMBLE_MESH, torch.float64)
    nus = ensemble_viscosities(disc, ENSEMBLE_RE, B)
    step = make_ensemble_step(disc, tol=1e-9, newton_max=ENSEMBLE_NEWTON_MAX, krylov_maxiter=200,
                              precond_cfg=PrecondConfig(**fields), **opts)
    ts = initial_ensemble_state(disc, B)
    calls, restore = watch_tangent_solves()
    steps = []
    try:
        reset_counts()
        for _ in range(ENSEMBLE_MATRIX_STEPS):
            del calls[:]
            t0 = time.perf_counter()
            ts = step(ts, nus, dt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = ts.stats
            failed = np.zeros(B, bool)
            stalled = np.zeros(B, bool)
            for act, iters, fl in calls:
                failed |= act & fl
                stalled = np.where(act, iters == 0, stalled)
            steps.append({
                "step": int(ts.step[0]), "wall_s": wall, "member_steps_per_s": B / wall,
                "newton_iters": st.newton_iters.tolist(), "krylov_iters": st.krylov_iters.tolist(),
                "final_residual": st.final_residual.tolist(), "drag": ts.drag.tolist(),
                "lift": ts.lift.tolist(), "outers_slowest": int(st.krylov_iters.max()),
                "bicgstab_failed": [int(m) for m in np.flatnonzero(failed)],
                "stalled": [int(m) for m in np.flatnonzero(stalled)],
            })
        counts = read_counts()
    finally:
        restore()
    finite = bool(torch.isfinite(ts.solution.u).all() and torch.isfinite(ts.solution.p).all())
    return {"steps": steps, "counts": counts, "fields_finite": finite}


def start_ensemble_matrix(pool):
    """Submit every combination of ``ENSEMBLE_MATRIX_WIDTH`` to ``pool``
    (``CARD_WORKERS`` spawned processes on the card), each as a worker
    is free.  The futures of their ``ensemble_matrix_run``."""
    return [pool.submit(ensemble_matrix_run, i) for i in ENSEMBLE_MATRIX_WIDTH]


def phase_ensemble_matrix(device, runs=None):
    """Every combination of ``ENSEMBLE_MATRIX_WIDTH`` at config 5's width
    (``runs``: the futures of ``start_ensemble_matrix``; by default its
    worker processes started here).  The card idles most of the time under
    this host-bound path, so the combinations run in worker processes
    beside other work -- in ``main``, beside the timed paths from phase 11
    on -- and their walls are measured while that work shares the card and
    the host.
    Gates: finite drag, lift and fields for every member; each member's
    final residual at or below 1e-9, or the member at the Newton cap, or
    stopped by the step's stagnation break -- the latter two listed; both
    kernels launched in each combination."""
    import numpy as np

    if runs is None:
        with cpu_pool(CARD_WORKERS) as pool:
            return phase_ensemble_matrix(device, start_ensemble_matrix(pool))
    card = nvidia_smi()
    B, (mx, my) = ENSEMBLE_B, ENSEMBLE_MESH
    runs = [r.result() for r in runs]
    out = {}
    for (label, _, _, _), run in zip([ENSEMBLE_MATRIX[i] for i in ENSEMBLE_MATRIX_WIDTH], runs, strict=True):
        steps, counts = run["steps"], run["counts"]
        for rec in steps:
            n, res = np.asarray(rec["newton_iters"]), np.asarray(rec["final_residual"])
            on_tol = res <= 1e-9
            capped = [int(m) for m in np.flatnonzero(~on_tol & (n >= ENSEMBLE_NEWTON_MAX))]
            stalled = [m for m in rec["stalled"] if not on_tol[m] and n[m] < ENSEMBLE_NEWTON_MAX]
            other = [int(m) for m in np.flatnonzero(~on_tol & (n < ENSEMBLE_NEWTON_MAX)) if m not in stalled]
            print(f"[ensemble-matrix] ({label}) step {rec['step']}: wall {rec['wall_s']!r} s, {rec['member_steps_per_s']!r} member-steps/s; outers (slowest member) {rec['outers_slowest']}, Krylov totals {int(min(rec['krylov_iters']))}-{rec['outers_slowest']}; Newton iterations per member {rec['newton_iters']}; final residuals per member {rec['final_residual']}")
            print(f"[ensemble-matrix] ({label}) step {rec['step']}: residual <= 1e-9 for {int(on_tol.sum())} of {B} members; at the Newton cap ({ENSEMBLE_NEWTON_MAX}) above it: members {capped}; stopped by the stagnation break above it: members {stalled}; BiCGStab failed (breakdown) in some tangent solve: members {rec['bicgstab_failed']}")
            if other:
                raise RuntimeError(f"ensemble-matrix: ({label}) step {rec['step']}: members {other} stopped above the Newton tolerance before the cap without a stagnation break")
            if not (np.isfinite(rec["drag"]).all() and np.isfinite(rec["lift"]).all()):
                raise RuntimeError(f"ensemble-matrix: ({label}) step {rec['step']}: non-finite drag or lift")
        if not run["fields_finite"]:
            raise RuntimeError(f"ensemble-matrix: ({label}) the final fields are not finite")
        print(f"[ensemble-matrix] ({label}) {mx}x{my} Q2/Q1, B {B}, Re {ENSEMBLE_RE[0]:g}..{ENSEMBLE_RE[1]:g}: step walls {[r['wall_s'] for r in steps]} s ({card}; measured in one of {CARD_WORKERS} worker processes on the card beside the -M phases); launches {json.dumps(counts)}")
        check_path_launches(counts, f"ensemble-matrix: ({label})")
        out[label] = run
    return out


# ---------------------------------------------------------------------------
# 31. ensemble-rest-check, 32. ensemble-ir, 33. ensemble-simplex-lu
# ---------------------------------------------------------------------------


def simplex_ensemble_disc(device, mesh, dtype):
    """The ``-M`` disc of the triangulated channel at ``mesh`` with the
    p-multigrid (no dense Schur legs: the ensemble-rest-check's iterative
    legs; the direct LU replaces the block preconditioner)."""
    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry
    from navier_stokes_solver_tpu_torch.unstructured import make_simplex_disc, triangulate_channel

    disc = make_simplex_disc(*triangulate_channel(make_channel_geometry(*mesh)), dtype=dtype, device=device)
    return disc.replace(p_mg=True)


def ensemble_rest_check_run(device):
    """Every case of ``ENSEMBLE_REST_CHECK`` on one device, as plain data
    (``ensemble_check_run``'s): per-step history [T, B], host fields, wall."""
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import run_sweep
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    out = []
    for _, backend, fields, res, cap, consistent in ENSEMBLE_REST_CHECK:
        if backend == "structured":
            disc = ensemble_disc(device, ENSEMBLE_CHECK_MESH, torch.float64)
        else:
            disc = simplex_ensemble_disc(device, SIMPLEX_CHECK_MESH, torch.float64)
        cfg = PrecondConfig(**fields, vmult_dtype=None, mg_dtype=None)
        t0 = time.perf_counter()
        final, hist = run_sweep(disc, [1.0 / re for re in res], UNSTEADY_DT, ENSEMBLE_CHECK_STEPS, solver_type=1,
                                prec_type=1, tol=1e-9, newton_max=3, krylov_maxiter=cap, precond_cfg=cfg,
                                consistent=consistent)
        out.append({"hist": {k: v.cpu().numpy() for k, v in hist.items()},
                    "fields": tuple(t.cpu().numpy() for t in final.solution),
                    "wall_s": time.perf_counter() - t0})
    return out


def phase_ensemble_rest_check(device, cpu_side=None, card_side=None):
    """Every case of ``ENSEMBLE_REST_CHECK`` on the card against the same on
    the CPU (``cpu_side``: the future of ``cpu_job("ensemble-rest-check")``;
    by default one worker process started here; ``card_side``: the future
    of ``card_job("ensemble-rest-check")``, by default run here):
    ``compare_ensemble_runs`` for each, the f32 GMRES-IR case's Krylov
    totals within the step's Newton count; the simplex cases' drag must not
    be zero (at 12x6 it is, for every member)."""
    import numpy as np

    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_ensemble_rest_check(device, pool.submit(cpu_job, "ensemble-rest-check"), card_side)
    card = ensemble_rest_check_run(device) if card_side is None else card_side.result()
    for (label, backend, fields, res, cap, consistent), g, c in zip(
            ENSEMBLE_REST_CHECK, card, cpu_side.result(), strict=True):
        mx, my = ENSEMBLE_CHECK_MESH if backend == "structured" else SIMPLEX_CHECK_MESH
        where = (f"({label}) {'-M ' if backend == 'simplex' else ''}{mx}x{my}, Re {list(res)}, "
                 f"{ENSEMBLE_CHECK_STEPS} steps, tangent solves capped at {cap}")
        compare_ensemble_runs("ensemble-rest-check", where, g, c,
                              krylov_per_newton=fields.get("krylov_cycle_dtype") is not None)
        if not np.all(np.abs(g["hist"]["drag"]) > 0.0):
            raise RuntimeError(f"ensemble-rest-check: {where}: a member's drag is zero")


def watch_ir_cycles():
    """Wrap ``krylov.batched``'s GMRES-IR loop: returns the list it appends
    to, per batched GMRES-IR solve, each member's restart cycles (a [B]
    array; the nested solves' cycles are not counted), and the function that
    restores the originals."""
    import numpy as np

    from navier_stokes_solver_tpu_torch.krylov import batched

    cycles, outer = [], []
    ir, cycle = batched._gmres_ir, batched._arnoldi_cycle

    def watched_ir(matvec, b, x0, tol_h, maxiter, basis, flexible, act, lo):
        outer.append(lo.matvec)
        cycles.append(np.zeros(act.shape[0], np.int64))
        try:
            return ir(matvec, b, x0, tol_h, maxiter, basis, flexible, act, lo)
        finally:
            outer.pop()

    def watched_cycle(r, beta, beta_w, tol_w, iters, maxiter, basis, flexible, matvec, M, run0):
        if outer and matvec is outer[-1]:
            cycles[-1] += run0
        return cycle(r, beta, beta_w, tol_w, iters, maxiter, basis, flexible, matvec, M, run0)

    batched._gmres_ir, batched._arnoldi_cycle = watched_ir, watched_cycle

    def restore():
        batched._gmres_ir, batched._arnoldi_cycle = ir, cycle

    return cycles, restore


def phase_ensemble_ir(device, main):
    """BASELINE config 5 exactly as ensemble-main runs it (``main``: its
    result, whose per-outer profile is set beside this one's), with f32
    GMRES-IR restart cycles (``krylov_cycle_dtype="float32"``): one warm-up
    step and ``ENSEMBLE_STEPS`` timed steps of the batched fused step
    (counts zeroed just before the warm-up, read after the timed steps) --
    step walls, member-steps/s, outers and restart cycles per step (the
    slowest member), the members at the Newton cap or stopped by the
    stagnation break above the tolerance (listed) -- then one profiled
    window of outer iterations.  Gates: finite drag and lift for every
    member, each member's residual at or below 1e-9 or the member listed,
    apply_F_fused launched and the other two not."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import initial_ensemble_state, make_ensemble_step
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    card = nvidia_smi()
    B, (mx, my), dt = ENSEMBLE_B, ENSEMBLE_MESH, UNSTEADY_DT
    disc = ensemble_disc(device, ENSEMBLE_MESH, torch.float64)
    nus = ensemble_viscosities(disc, ENSEMBLE_RE, B)
    cfg = PrecondConfig(schur_mode="cahouet", cc_lp_cycles=1, krylov_cycle_dtype="float32")
    step = make_ensemble_step(disc, solver_type=1, prec_type=1, tol=1e-9, newton_max=ENSEMBLE_NEWTON_MAX,
                              krylov_maxiter=200, precond_cfg=cfg)
    ts = initial_ensemble_state(disc, B)
    calls, restore_solves = watch_tangent_solves()
    cycles, restore_cycles = watch_ir_cycles()
    steps = []
    try:
        reset_counts()
        for k in range(1 + ENSEMBLE_STEPS):
            del calls[:], cycles[:]
            t0 = time.perf_counter()
            ts = step(ts, nus, dt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = ts.stats
            stalled = np.zeros(B, bool)
            for act, iters, _ in calls:
                stalled = np.where(act, iters == 0, stalled)
            restarts = np.sum(cycles, axis=0) if cycles else np.zeros(B, np.int64)
            rec = {
                "step": int(ts.step[0]), "timed": k > 0, "wall_s": wall, "member_steps_per_s": B / wall,
                "newton_iters": st.newton_iters.tolist(), "krylov_iters": st.krylov_iters.tolist(),
                "final_residual": st.final_residual.tolist(), "drag": ts.drag.tolist(), "lift": ts.lift.tolist(),
                "outers_slowest": int(st.krylov_iters.max()), "restart_cycles": restarts.tolist(),
                "stalled": [int(m) for m in np.flatnonzero(stalled)],
            }
            steps.append(rec)
            n, res = np.asarray(rec["newton_iters"]), np.asarray(rec["final_residual"])
            on_tol = res <= 1e-9
            capped = [int(m) for m in np.flatnonzero(~on_tol & (n >= ENSEMBLE_NEWTON_MAX))]
            stop = [m for m in rec["stalled"] if not on_tol[m] and n[m] < ENSEMBLE_NEWTON_MAX]
            print(f"[ensemble-ir] step {rec['step']} ({'timed' if k else 'warm-up, the inlet lift'}): wall {wall!r} s, {rec['member_steps_per_s']!r} member-steps/s; outers (slowest member) {rec['outers_slowest']}, restart cycles (slowest member) {int(restarts.max())}; Newton iterations per member {rec['newton_iters']}; Krylov totals {rec['krylov_iters']}; restart cycles {rec['restart_cycles']}; final residuals {rec['final_residual']}")
            print(f"[ensemble-ir] step {rec['step']}: residual <= 1e-9 for {int(on_tol.sum())} of {B} members; at the Newton cap ({ENSEMBLE_NEWTON_MAX}) above it: members {capped}; stopped by the stagnation break above it: members {stop}")
            other = [int(m) for m in np.flatnonzero(~on_tol & (n < ENSEMBLE_NEWTON_MAX)) if m not in stop]
            if other:
                raise RuntimeError(f"ensemble-ir: step {rec['step']}: members {other} stopped above the Newton tolerance before the cap without a stagnation break")
            if not (np.isfinite(rec["drag"]).all() and np.isfinite(rec["lift"]).all()):
                raise RuntimeError(f"ensemble-ir: step {rec['step']}: non-finite drag or lift")
        counts = read_counts()
    finally:
        restore_solves()
        restore_cycles()
    if not bool(torch.isfinite(ts.solution.u).all() and torch.isfinite(ts.solution.p).all()):
        raise RuntimeError("ensemble-ir: the final fields are not finite")
    timed = [r["wall_s"] for r in steps[1:]]
    t_b = statistics.median(timed)
    print(f"[ensemble-ir] {mx}x{my} Q2/Q1, B {B}, Re {ENSEMBLE_RE[0]:g}..{ENSEMBLE_RE[1]:g}, f32 GMRES-IR cycles: timed step walls {timed} s, median {t_b!r} s, {B / t_b!r} member-steps/s (ensemble-main, the same without the cycles: {main['median_step_s']!r} s, {main['member_steps_per_s']!r} member-steps/s; {card}); launches {json.dumps(counts)}")
    check_path_launches(counts, "the ensemble's GMRES-IR path")
    per = ensemble_outer_profile(disc, nus, ts, cfg, dt)
    print(f"[ensemble-ir-outer] per outer iteration of the batched tangent solve with f32 cycles (B {B}, profiled): {json.dumps(per)}")
    base = main["outer"]
    print(f"[ensemble-ir-outer] against ensemble-main's per outer iteration: kernels {per['kernels']!r} / {base['kernels']!r}, device ms {per['device_ms']!r} / {base['device_ms']!r}, wall ms {per['wall_ms']!r} / {base['wall_ms']!r}, busy {per['busy']:.4f} / {base['busy']:.4f}, readbacks {per['readbacks']!r} / {base['readbacks']!r}")
    return {"counts": counts, "steps": steps, "median_step_s": t_b, "member_steps_per_s": B / t_b, "outer": per}


def phase_ensemble_simplex_lu(device, s):
    """Config 3 with the direct LU as a Reynolds sweep: ``ENSEMBLE_SIMPLEX_B``
    members, Re linspace(1, 100), ``ENSEMBLE_SIMPLEX_STEPS`` steps from rest,
    built from config3-lu-fused's solver ``s`` -- its disc (the dense Schur
    legs attached as the CLI attaches them), its ``precond_config`` and the
    step keywords its ``solve_fused`` passes -- so member 0 is config 3
    itself, held against that run's history.  Per step: wall, factorizations
    (count, build and factor seconds), each member's Newton iterations and
    outers; the peak device memory.  Gates: member 0's drag per step within
    rtol 1e-7 of config3-lu-fused's first steps and its Newton iterations
    equal; finite drag and lift for every member; none of the three kernels
    launched (the simplex path runs none)."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import initial_ensemble_state, make_ensemble_step
    from navier_stokes_solver_tpu_torch.precond import blocks

    card = nvidia_smi()
    B, o, dt = ENSEMBLE_SIMPLEX_B, s.options, UNSTEADY_DT
    disc = s.disc
    nus = ensemble_viscosities(disc, ENSEMBLE_SIMPLEX_RE, B)
    if float(nus[0]) != s.nu:
        raise RuntimeError(f"ensemble-simplex-lu: member 0's viscosity {float(nus[0])!r} is not config 3's {s.nu!r}")
    step = make_ensemble_step(
        disc, solver_type=o.solver_type, prec_type=o.preconditioner_type, tol=o.tolerance,
        newton_max=s.NEWTON_MAX_ITERS, newton_tol=s.NEWTON_TOL, krylov_maxiter=2000,
        basis=max(1, int(o.krylov_basis)), precond_cfg=o.precond_config, consistent=o.consistent_continuity,
    )
    ts = initial_ensemble_state(disc, B)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    steps = []
    for _ in range(ENSEMBLE_SIMPLEX_STEPS):
        blocks.DIRECT_LU_TIMES.clear()
        t0 = time.perf_counter()
        ts = step(ts, nus, dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lu = list(blocks.DIRECT_LU_TIMES)
        st = ts.stats
        rec = {
            "step": int(ts.step[0]), "wall_s": wall, "member_steps_per_s": B / wall,
            "factorizations": len(lu), "build_s": sum(t["build_s"] for t in lu),
            "factor_s": sum(t["factor_s"] for t in lu),
            "factor_s_range": [min(t["factor_s"] for t in lu), max(t["factor_s"] for t in lu)],
            "newton_iters": st.newton_iters.tolist(), "krylov_iters": st.krylov_iters.tolist(),
            "final_residual": st.final_residual.tolist(), "drag": ts.drag.tolist(), "lift": ts.lift.tolist(),
        }
        steps.append(rec)
        print(f"[ensemble-simplex-lu] step {json.dumps(rec)}")
        if sum(rec["newton_iters"]) != len(lu):
            raise RuntimeError(f"ensemble-simplex-lu: {len(lu)} factorizations for {sum(rec['newton_iters'])} member tangent solves")
        if not (np.isfinite(rec["drag"]).all() and np.isfinite(rec["lift"]).all()):
            raise RuntimeError(f"ensemble-simplex-lu: step {rec['step']}: non-finite drag or lift")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    n = lu[0]["n"]
    ref = [(h["drag_force"], h["newton_iters"]) for h in steps_of(s)][:ENSEMBLE_SIMPLEX_STEPS]
    got = [(r["drag"][0], r["newton_iters"][0]) for r in steps]
    rel = max(abs(a - b) / abs(b) for (a, _), (b, _) in zip(got, ref))
    print(f"[ensemble-simplex-lu] -M {CONFIG3_ARGV[CONFIG3_ARGV.index('-m') + 1].replace(',', 'x')} P2/P1, {s.n_dofs} DoFs per member ({n} unknowns), B {B}, Re {ENSEMBLE_SIMPLEX_RE[0]:g}..{ENSEMBLE_SIMPLEX_RE[1]:g}: step walls {[r['wall_s'] for r in steps]} s; peak device memory {peak} bytes ({B} f32 factors: {B * 4 * n * n} bytes; {card}); launches {json.dumps(counts)}")
    print(f"[ensemble-simplex-lu] member 0 (Re {1.0 / float(nus[0]):g}) against config3-lu-fused's first {ENSEMBLE_SIMPLEX_STEPS} steps: (drag, Newton iterations) {got} vs {ref}; drag max rel diff {rel:.3e} (gate 1e-7)")
    if not rel <= 1e-7 or [a for _, a in got] != [b for _, b in ref]:
        raise RuntimeError("ensemble-simplex-lu: member 0 is not config 3's run")
    if any(c["launches"] for c in counts.values()):
        raise RuntimeError(f"ensemble-simplex-lu: the simplex path launched a hand-written kernel: {counts}")
    return {"counts": counts, "steps": steps, "peak_bytes": peak}


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
    errs = dict.fromkeys(KERNELS, 0.0)
    for mesh in shapes:
        for dtype in (torch.float32, torch.float64):
            errs = fold_errs(errs, check_shape(device, mesh, (2, 1), dtype, make_cavity_geometry, "cavity "))
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
    outers, wall, and (on the card) the kernels' launches."""
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
    check_path_launches(counts, "the cavity path")
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
    check_path_launches(counts, "the cavity CLI path")
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


def phase_cavity_check(device, cpu_side=None, card_side=None):
    """A forced 32x32 Q2/Q1 cavity at Re 100 on the card against the CPU
    (``cpu_side``: the future of ``cpu_job("cavity-check")``; ``card_side``:
    the future of ``card_job("cavity-check")``, by default run here): outers
    within 1 per tangent solve, fields within 1e-6 of their magnitude."""
    import numpy as np

    if cpu_side is None:
        with cpu_pool(1) as pool:
            return phase_cavity_check(device, pool.submit(cpu_job, "cavity-check"), card_side)
    g = cavity_check_run(device) if card_side is None else card_side.result()
    c = cpu_side.result()
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


# ---------------------------------------------------------------------------
# 35. dd-check, 36. dd-north
# ---------------------------------------------------------------------------


def dd_solver(device, mesh, degrees, Re, cfg, *, dd=None, consistent=True, tol=1e-9):
    """One host unsteady step (``solve(direct=True)``) of ``mesh`` at the
    given degrees: FGMRES basis 30, blockTriangular, ``cfg``; under ``dd``
    this rank's tile (``device`` then a device per rank)."""
    from navier_stokes_solver_tpu_torch.api import NSSolver, SolverOptions

    return NSSolver(SolverOptions(
        mesh_size=mesh, degree_velocity=degrees[0], degree_pressure=degrees[1], Re=Re, solver_type=1,
        tolerance=tol, preconditioner_type=1, krylov_basis=30, time_step=UNSTEADY_DT, time_span=UNSTEADY_DT,
        verbose=False, precond_config=cfg, consistent_continuity=consistent, device=device, dd=dd,
    )).setup()


def dd_step_run(device, mesh, degrees, Re, cfg, tol, dd=None):
    """``dd_solver``'s step on this process (one rank of ``dd``, or alone):
    the solver, and the wall, per-solve Krylov counts, Newton residual,
    drag and lift, global fields, launches (counts zeroed just before the
    step, read just after), and the rank's collectives."""
    import torch

    s = dd_solver(device, mesh, degrees, Re, cfg, dd=dd, tol=tol)
    if s.mesh is not None:
        for k in s.mesh.counts:
            s.mesh.counts[k] = 0
    reset_counts()
    t0 = time.perf_counter()
    s.solve(direct=True)
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    wall = time.perf_counter() - t0
    counts = read_counts()
    u, p = s.fields()
    return s, {"wall_s": wall, "setup_s": s.setup_seconds, "krylov": [h["krylov_iters"] for h in solves_of(s)],
               "newton_residual": s.newton_residual, "drag": s.drag_force, "lift": s.lift_force,
               "u": u, "p": p, "counts": counts, "n_dofs": s.n_dofs,
               "collectives": None if s.mesh is None else dict(s.mesh.counts)}


def tile_kernel_checks(tile, dtype):
    """``check_disc`` at every level of this rank's tile chain in
    ``dtype`` (the dtype the step's multigrid launched the kernels in), on
    the card, in step with the other ranks: {kernel: largest |kernel -
    plain|, "shapes": the levels checked}.  Launches made here are not the
    step's (its counts were read before)."""
    err, shapes = dict.fromkeys(KERNELS, 0.0), []
    d = tile.to(dtype)
    while d is not None:
        shape = f"tile ({d.halo_iy}, {d.halo_ix}) {d.nx}x{d.ny} Q{d.deg_v}/Q{d.deg_p} {str(dtype)[6:]}"
        err = fold_errs(err, check_disc(*kernel_inputs(d), shape, log=lambda line: None))
        shapes.append(f"{d.nx}x{d.ny}")
        d = None if d.mg is None else d.mg.coarse
    return {**err, "shapes": shapes}


def dd_step_rank(rank, devices, mesh, degrees, Re, cfg, tol, dd):
    """One rank of ``dd_step_run`` under ``dd`` (spawned by
    ``dist.launch``), then on its tile and process group: the kernels
    against their plain versions at every level of the tile's chain in the
    dtype the step's multigrid ran (``tile_kernel_checks``), and a seeded
    global field (the same on every rank) through ``tile_blocks`` and back
    through ``all_gather_blocks`` ("round_trip": True when every element
    comes back bit for bit).  The global fields returned by rank 0 alone."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.dist import all_gather_blocks, tile_blocks
    from navier_stokes_solver_tpu_torch.ops import Blocks

    s, out = dd_step_run(devices, mesh, degrees, Re, cfg, tol, dd)
    if rank:
        out["u"] = out["p"] = None
    dtype = s.disc.dtype if cfg.mg_dtype is None else getattr(torch, cfg.mg_dtype)
    out["tile_checks"] = tile_kernel_checks(s.disc, dtype)
    g = np.random.default_rng(0)
    (nx, ny), (kv, kp) = mesh, degrees
    x = Blocks(torch.as_tensor(g.standard_normal((2, kv * ny + 1, kv * nx + 1))),
               torch.as_tensor(g.standard_normal((kp * ny + 1, kp * nx + 1))))
    back = all_gather_blocks(tile_blocks(x, s.disc), s.disc)
    out["round_trip"] = all(np.array_equal(a, b.numpy()) for a, b in zip(back, x))
    return out


def print_tile_checks(tag, ranks):
    """The tile kernel checks of every rank (``dd_step_rank``): their
    largest errors, folded as ``phase_check``'s."""
    errs = {k: max(r["tile_checks"][k] for r in ranks) for k in KERNELS}
    print(f"[{tag}] the kernels against their plain versions on every rank's tile, at every level of its chain "
          f"{ranks[0]['tile_checks']['shapes']} (cell_apply_F Stokes and Newton, three entries, within "
          f"{json.dumps(KERNEL_TOL)}; scatter_v_bc with and without bc_diag, seam sum and rows, bit for bit; "
          f"apply_F_fused with and without bc_diag, on both lattice layouts, seam sum and rows, bit for bit "
          f"against the two launches and within {json.dumps(KERNEL_TOL)} of its plain version): "
          f"max|kernel-plain| {json.dumps(errs)}")
    return errs


def dd_sweep_rank(rank, devices, mesh, nus, kw):
    """``run_sweep(mesh=...)`` on an ``('ens',)`` mesh of len(devices) ranks
    on the card: the gathered history and final fields, and the launches
    (every rank's)."""
    import torch

    from navier_stokes_solver_tpu_torch.dist import make_mesh
    from navier_stokes_solver_tpu_torch.ensemble import run_sweep

    m = make_mesh(1, len(devices), devices=devices)
    disc = ensemble_disc(m.device, mesh, torch.float64)
    reset_counts()
    final, hist = run_sweep(disc, nus, UNSTEADY_DT, 1, mesh=m, **kw)
    if m.device.type == "cuda":
        torch.cuda.synchronize(m.device)
    return {"hist": {k: v.cpu().numpy() for k, v in hist.items()}, "counts": read_counts(),
            "u": final.solution.u.cpu().numpy(), "p": final.solution.p.cpu().numpy()}


def dd_reference_rank(rank, devices, args, nus, kw):
    """dd-check's references on one rank (a spawned process, so that this
    process's launch counters stay the other phases'): the step of
    ``dd_step_run`` and the unsharded sweep."""
    import torch

    from navier_stokes_solver_tpu_torch.ensemble import run_sweep

    device = torch.device(devices[0])
    _, one = dd_step_run(device, *args)
    final, hist = run_sweep(ensemble_disc(device, DD_CHECK_MESH, torch.float64), nus, UNSTEADY_DT, 1, **kw)
    return one, {k: v.cpu().numpy() for k, v in hist.items()}, tuple(t.cpu().numpy() for t in final.solution)


def dd_compare(tag, one, ranks, *, drag_tol, field_tol, newton=True):
    """The decomposed step (``ranks``, rank 0's fields) against the one on
    one rank: equal Newton counts (with ``newton``), Krylov totals within
    1.1x + 5, drag within ``drag_tol``, fields within ``field_tol`` (None:
    not compared); the launches of every rank summed (each kernel must have
    launched on every rank)."""
    import numpy as np

    dd = ranks[0]
    if newton and len(dd["krylov"]) != len(one["krylov"]):
        raise RuntimeError(f"{tag}: {len(dd['krylov'])} Newton iterations against {len(one['krylov'])} on one rank")
    if not sum(dd["krylov"]) <= 1.1 * sum(one["krylov"]) + 5:
        raise RuntimeError(f"{tag}: Krylov total {sum(dd['krylov'])} > 1.1 x {sum(one['krylov'])} + 5")
    gaps = {"drag": abs(dd["drag"] - one["drag"]), "lift": abs(dd["lift"] - one["lift"])}
    if not gaps["drag"] <= drag_tol:
        raise RuntimeError(f"{tag}: drag {dd['drag']!r} not within {drag_tol} of {one['drag']!r}")
    if field_tol is not None:
        gaps.update(u=float(np.abs(dd["u"] - one["u"]).max()), p=float(np.abs(dd["p"] - one["p"]).max()))
        if not max(gaps["u"], gaps["p"]) <= field_tol:
            raise RuntimeError(f"{tag}: fields {gaps['u']!r} / {gaps['p']!r} apart (> {field_tol})")
    for r, rec in enumerate(ranks):
        check_path_launches(rec["counts"], f"{tag}: rank {r}")
    return gaps, summed_counts(r["counts"] for r in ranks)


def phase_dd_check(device):
    """Domain decomposition on the card against one rank on the card:
    ``DD_CHECK_MESH`` Q2/Q1 host unsteady steps (Re 100, tol 1e-10, all-f64
    Cahouet-Chabard preconditioner with one Lp V-cycle, consistent sign)
    under each of ``DD_CHECK_TILES``, ``run_sweep(mesh=...)`` with
    ``DD_CHECK_NUS`` over two 'ens' ranks, and the tile round trips -- the
    ranks share the one card under gloo (``dist.launch``, devices
    ``cuda:0`` per rank; NCCL refuses two ranks on a card).  The three
    decomposed runs go together, beside the one-rank references in a
    process of their own (this process's launch counters stay the other
    phases': ``main`` runs this phase beside the ``-M`` phases), each a
    chain of device synchronizations and host round trips, not a
    timing.  Gates: equal Newton counts, Krylov totals within 1.1x + 5,
    drag within 1e-8, fields within 1e-7, round trips bit for bit, both
    kernels launched on every rank."""
    import numpy as np

    from navier_stokes_solver_tpu_torch.dist import launch
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    card = nvidia_smi()
    cfg = PrecondConfig(schur_mode="cahouet", cc_lp_cycles=1, vmult_dtype=None, mg_dtype=None)
    args = (DD_CHECK_MESH, (2, 1), 100.0, cfg, 1e-10)
    kw = dict(solver_type=1, prec_type=1, tol=1e-9, newton_max=3, krylov_maxiter=200,
              precond_cfg=PrecondConfig(schur_mode="cahouet", cc_lp_cycles=1, vmult_dtype=None, mg_dtype=None))
    devs = lambda n: [str(device)] * n

    def tiles(dd):
        n = dd[0] * dd[1]
        t0 = time.perf_counter()
        ranks = launch(dd_step_rank, n, devs(n), *args, dd)
        return ranks, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(DD_CHECK_TILES) + 2) as ex:
        runs = [ex.submit(tiles, dd) for dd in DD_CHECK_TILES]
        sweep = ex.submit(launch, dd_sweep_rank, 2, devs(2), DD_CHECK_MESH, list(DD_CHECK_NUS), kw)
        ref = ex.submit(launch, dd_reference_rank, 1, devs(1), args, list(DD_CHECK_NUS), kw)
        runs = [r.result() for r in runs]
        sweep = sweep.result()
        one, ref_hist, ref_fields = ref.result()[0]
    print(f"[dd-check] one rank: {DD_CHECK_MESH[0]}x{DD_CHECK_MESH[1]} Q2/Q1 host step, wall {one['wall_s']!r} s, Krylov per solve {one['krylov']}, drag {one['drag']!r}")
    out = {"counts": [], "errs": dict.fromkeys(KERNELS, 0.0)}
    for dd, (ranks, wall) in zip(DD_CHECK_TILES, runs):
        n = dd[0] * dd[1]
        gaps, counts = dd_compare(f"dd-check {dd}", one, ranks, drag_tol=1e-8, field_tol=1e-7)
        if not all(r["round_trip"] for r in ranks):
            raise RuntimeError(f"dd-check {dd}: the tile round trip on the card is not bit for bit")
        out["errs"] = fold_errs(out["errs"], print_tile_checks(f"dd-check {dd[0]} x {dd[1]}", ranks))
        print(f"[dd-check] {dd[0]} x {dd[1]} tiles ({n} ranks on {card}, gloo, beside the other decomposed runs): step wall {ranks[0]['wall_s']!r} s (launch wall {wall:.1f} s), Krylov per solve {ranks[0]['krylov']}, gaps {json.dumps(gaps)}, round trip bit for bit; rank 0's collectives {json.dumps(ranks[0]['collectives'])}; launches per rank {[{k: c['launches'] for k, c in r['counts'].items()} for r in ranks]}")
        out["counts"].append(counts)
    for r, rec in enumerate(sweep):
        h = rec["hist"]
        if not (np.array_equal(h["newton_iters"], ref_hist["newton_iters"])
                and (h["krylov_iters"] <= 1.1 * ref_hist["krylov_iters"] + 5).all()
                and np.abs(h["drag"] - ref_hist["drag"]).max() <= 1e-8
                and max(np.abs(rec["u"] - ref_fields[0]).max(), np.abs(rec["p"] - ref_fields[1]).max()) <= 1e-7):
            raise RuntimeError(f"dd-check: run_sweep(mesh=...) rank {r} does not match the unsharded sweep: {h} vs {ref_hist}")
        check_path_launches(rec["counts"], f"dd-check: sweep rank {r}")
    print(f"[dd-check] run_sweep(mesh=...) B {len(DD_CHECK_NUS)} over 2 'ens' ranks: Newton {sweep[0]['hist']['newton_iters'].tolist()}, Krylov {sweep[0]['hist']['krylov_iters'].tolist()} (unsharded {ref_hist['krylov_iters'].tolist()}), drag gap {float(np.abs(sweep[0]['hist']['drag'] - ref_hist['drag']).max())!r}")
    out["counts"].append(summed_counts(r["counts"] for r in sweep))
    out["counts"] = summed_counts(out["counts"])
    return out


def dd_north_run(device):
    """dd-north's ranks: phase 9's configuration under ``DD_NORTH_TILES``
    (``dd_step_rank`` on each tile), as plain data: the ranks' records and
    the launch wall.  It needs nothing of phase 9, so ``main`` starts it
    in a thread before phase 9 runs."""
    from navier_stokes_solver_tpu_torch.dist import launch
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    n = DD_NORTH_TILES[0] * DD_NORTH_TILES[1]
    cfg = PrecondConfig(schur_mode="cahouet", cc_lp_cycles=1)
    t0 = time.perf_counter()
    ranks = launch(dd_step_rank, n, [str(device)] * n, UNSTEADY_MESH, (3, 2), 100.0, cfg, 1e-9, DD_NORTH_TILES)
    return ranks, time.perf_counter() - t0


def phase_dd_north(device, unsteady, run=None):
    """This slice's full-width path: phase 9's configuration (BASELINE's
    north star, 300x100 Q3/Q2, 657,740 DoFs, Re 100, dt 0.01, one host
    step, f32 Cahouet-Chabard with one Lp V-cycle, consistent sign) under
    ``DD_NORTH_TILES`` -- four 150x50 tiles, four ranks sharing the card
    under gloo (``run``: the future of ``dd_north_run``, by default run
    here) -- held against phase 9's step (``unsteady``): Krylov total
    within 1.1x + 5, drag within 1e-7, Newton residual <= 1e-9; its wall
    (not a speedup: the ranks share one card and its host), the launches
    per rank, the collectives per outer iteration and the seam bytes."""
    card = nvidia_smi()
    dd = DD_NORTH_TILES
    n = dd[0] * dd[1]
    ranks, wall = dd_north_run(device) if run is None else run.result()
    r0 = ranks[0]
    if r0["n_dofs"] != UNSTEADY_DOFS:
        raise RuntimeError(f"dd-north: DoF count {r0['n_dofs']} != {UNSTEADY_DOFS}")
    if not r0["newton_residual"] <= 1e-9:
        raise RuntimeError(f"dd-north: Newton residual {r0['newton_residual']!r} > 1e-9")
    gaps, counts = dd_compare("dd-north", unsteady, ranks, drag_tol=1e-7, field_tol=None, newton=False)
    outers = sum(r0["krylov"])
    col = r0["collectives"]
    print(f"[dd-north] {UNSTEADY_MESH[0]}x{UNSTEADY_MESH[1]} Q3/Q2 Re 100, {r0['n_dofs']} DoFs, {dd[0]} x {dd[1]} tiles of {UNSTEADY_MESH[0] // dd[0]}x{UNSTEADY_MESH[1] // dd[1]} ({n} ranks sharing {card}, gloo through the host: walls on one shared card are not a dd speedup): setup {r0['setup_s']:.3f} s, step wall {r0['wall_s']!r} s (launch wall {wall:.1f} s; one card, one rank: {unsteady['wall_s']!r} s), Krylov per solve {r0['krylov']} (one rank: {unsteady['krylov']}), Newton residual {r0['newton_residual']!r}, drag {r0['drag']!r} (gap {gaps['drag']!r}), lift gap {gaps['lift']!r}")
    print(f"[dd-north] rank 0's collectives {json.dumps(col)}: per outer iteration {col['seam_exchanges'] / outers:.1f} seam exchanges, {col['all_reduces'] / outers:.1f} all-reduces, {col['seam_bytes'] / outers:.0f} seam bytes sent; launches per rank {[{k: c['launches'] for k, c in r['counts'].items()} for r in ranks]}")
    if not all(r["round_trip"] for r in ranks):
        raise RuntimeError("dd-north: the tile round trip on the card is not bit for bit")
    errs = print_tile_checks("dd-north", ranks)
    return {"wall_s": r0["wall_s"], "krylov": r0["krylov"], "counts": counts, "collectives": col, "errs": errs}


def check_no_launches(counts, what):
    """Raise unless ``counts`` (``read_counts``) show no launch of the
    hand-written kernels: the -M simplex operators apply per-element
    matrices, and no -M path launches a kernel of ours."""
    launched = {name: c["launches"] for name, c in counts.items() if c["launches"]}
    if launched:
        raise RuntimeError(f"{what} launched {launched}: no -M path may")


def dd_simplex_options(device, case, dd=None):
    """``SolverOptions`` of a dd-simplex run on this process (a rank of
    ``dd``, or alone): ``case`` "check" -- the -M ``SIMPLEX_CHECK_MESH``
    channel, Re ``DD_SIMPLEX_RE``, FGMRES basis 30 + blockTriangular, tol
    1e-10, all-f64 Cahouet-Chabard with one Lp cycle (dd-check's
    configuration), consistent sign, one step of ``UNSTEADY_DT`` --, or
    "config3": ``CONFIG3_ARGV`` under the all-f64 preconditioner; the dense
    Schur legs off in both (a strip's legs iterate)."""
    import dataclasses

    from navier_stokes_solver_tpu_torch.api import SolverOptions
    from navier_stokes_solver_tpu_torch.cli.common import parse_options
    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    if case == "config3":
        return dataclasses.replace(
            parse_options(CONFIG3_ARGV, unsteady=True), dense_schur=False, verbose=False, dd=dd, device=device,
            precond_config=PrecondConfig(vmult_dtype=None, mg_dtype=None),
        )
    return SolverOptions(
        mesh_size=SIMPLEX_CHECK_MESH, read_mesh_from_file=True, Re=DD_SIMPLEX_RE, solver_type=1, tolerance=1e-10,
        preconditioner_type=1, krylov_basis=30, time_step=UNSTEADY_DT, time_span=UNSTEADY_DT, verbose=False,
        precond_config=PrecondConfig(schur_mode="cahouet", cc_lp_cycles=1, vmult_dtype=None, mg_dtype=None),
        consistent_continuity=True, dense_schur=False, device=device, dd=dd,
    )


def dd_simplex_run(device, case, mode, dd=None):
    """One dd-simplex run on this process (a rank of ``dd``, or alone):
    ``mode`` "host" (the first step: ``solve(direct=True)``; config 3: the
    CLI's ``solve()``) or "fused" (one ``solve_fused`` step), the step cut
    to ``DD_SIMPLEX_NEWTON`` Newton iterations, each tangent solve capped
    at ``DD_SIMPLEX_CAP`` outers (config 3's at
    ``DD_SIMPLEX_CONFIG3_CAP``).  Returns the solver and the wall,
    per-solve Krylov counts, Newton counts, the Newton residual where the
    step ended, drag and lift, global fields, launches (counts zeroed just
    before the run, read just after) and the rank's collectives."""
    import torch

    from navier_stokes_solver_tpu_torch.api import NSSolver

    cap = DD_SIMPLEX_CONFIG3_CAP if case == "config3" else DD_SIMPLEX_CAP
    s = NSSolver(dd_simplex_options(device, case, dd)).setup()
    s.KRYLOV_MAXITER, s.NEWTON_MAX_ITERS = cap, DD_SIMPLEX_NEWTON
    if s.mesh is not None:
        for k in s.mesh.counts:
            s.mesh.counts[k] = 0
    reset_counts()
    t0 = time.perf_counter()
    if mode == "fused":
        s.solve_fused(newton_max=DD_SIMPLEX_NEWTON, krylov_maxiter=cap)
    else:
        s.solve(direct=case == "check")
    if s.device.type == "cuda":
        torch.cuda.synchronize(s.device)
    wall = time.perf_counter() - t0
    counts = read_counts()
    u, p = s.fields()
    if mode == "fused":
        steps = steps_of(s)
        krylov = [h["krylov_iters"] for h in steps]
        newton = [h["newton_iters"] for h in steps]
        residual = steps[-1]["newton_residual"]
    else:
        krylov = [h["krylov_iters"] for h in solves_of(s)]
        newton = [len(krylov)]
        residual = s.newton_residual
    return s, {"wall_s": wall, "setup_s": s.setup_seconds, "krylov": krylov, "newton": newton,
               "residual": float(residual), "drag": s.drag_force, "lift": s.lift_force, "u": u, "p": p,
               "counts": counts, "n_dofs": s.n_dofs,
               "collectives": None if s.mesh is None else dict(s.mesh.counts)}


def dd_simplex_rank(rank, devices, jobs, dd, refs=()):
    """The runs ``jobs`` ((case, mode) each) of ``dd_simplex_run`` one after
    another on this rank of ``dd`` (spawned by ``dist.launch``), each
    followed, on its strip, by a seeded global (u, p) through
    ``strip_blocks`` and back through ``all_gather_simplex_blocks``
    ("round_trip": True when every element comes back bit for bit); then,
    on ranks below ``len(refs)``, the one-rank reference ``refs[rank]`` (a
    (case, mode), ``dd_simplex_run`` alone, no collective), the ranks'
    references side by side.  Returns ``{"strips": [...], "reference":
    ...}``, the strips' global fields from rank 0 alone."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.dist import all_gather_simplex_blocks, strip_blocks
    from navier_stokes_solver_tpu_torch.ops import Blocks

    outs = []
    for case, mode in jobs:
        s, out = dd_simplex_run(devices, case, mode, dd)
        if rank:
            out["u"] = out["p"] = None
        tables = s.dd_simplex
        g = np.random.default_rng(0)
        # zero on the lattice points no triangle touches (inside the
        # triangulated channel's cylinder hole): no strip holds them
        held = lambda ids, n: np.isin(np.arange(n), ids[ids >= 0])
        x = Blocks(torch.as_tensor(g.standard_normal((2, tables.n_nodes_v_global))
                                   * held(tables.v_global, tables.n_nodes_v_global)),
                   torch.as_tensor(g.standard_normal(tables.n_nodes_p_global)
                                   * held(tables.p_global, tables.n_nodes_p_global)))
        back = all_gather_simplex_blocks(strip_blocks(x, s.disc, tables), s.disc, tables)
        out["round_trip"] = all(np.array_equal(a, b.numpy()) for a, b in zip(back, x))
        outs.append(out)
    ref = dd_simplex_run(torch.device(devices[rank]), *refs[rank])[1] if rank < len(refs) else None
    return {"strips": outs, "reference": ref}


def dd_simplex_compare(tag, one, ranks):
    """The strips (``ranks``, rank 0's fields) against one rank, both
    capped (a fixed sequence of operations, which the strips change only by
    the rounding of their seam sums and products): Krylov counts within 1
    per solve and equal Newton counts (both the cap: they cannot part), the
    Newton residual where the step ended, drag and both fields within 1e-8
    of their largest magnitude, the round trip bit for bit, no launch of
    our kernels on any rank.  Returns the gaps."""
    import numpy as np

    dd = ranks[0]
    if dd["newton"] != one["newton"]:
        raise RuntimeError(f"{tag}: Newton iterations {dd['newton']} against {one['newton']} on one rank")
    if len(dd["krylov"]) != len(one["krylov"]) or any(abs(a - b) > 1 for a, b in zip(dd["krylov"], one["krylov"])):
        raise RuntimeError(f"{tag}: Krylov per solve {dd['krylov']} against {one['krylov']} on one rank")
    gaps = {"residual": abs(dd["residual"] - one["residual"]), "drag": abs(dd["drag"] - one["drag"]),
            "lift": abs(dd["lift"] - one["lift"]),
            "u": float(np.abs(dd["u"] - one["u"]).max()), "p": float(np.abs(dd["p"] - one["p"]).max())}
    scale = {"residual": abs(one["residual"]), "drag": abs(one["drag"]), "u": float(np.abs(one["u"]).max()),
             "p": float(np.abs(one["p"]).max())}
    for k, v in scale.items():
        if not gaps[k] <= 1e-8 * v:
            raise RuntimeError(f"{tag}: {k} {gaps[k]!r} apart (> 1e-8 x {v!r})")
    if not all(r["round_trip"] for r in ranks):
        raise RuntimeError(f"{tag}: the strip round trip on the card is not bit for bit")
    for r, rec in enumerate(ranks):
        check_no_launches(rec["counts"], f"{tag}: rank {r}")
    return gaps


def phase_dd_simplex(device):
    """The -M x-strips (``dist/simplex.py``; one process per strip, the
    ranks sharing the card under gloo) against one rank on the card: (a)
    at ``SIMPLEX_CHECK_MESH``, the first host unsteady step on 2 strips and
    on ``DD_SIMPLEX_STRIPS_WIDE`` and one ``solve_fused`` step on 2; (b)
    config 3 at full width on 2 strips -- every run cut to one capped
    tangent solve (``DD_SIMPLEX_NEWTON``, ``DD_SIMPLEX_CAP``,
    ``DD_SIMPLEX_CONFIG3_CAP``), against one rank with the same iterative
    Schur legs (not phase 15's dense ones).  The 2-strip
    runs go one after another on one pair of ranks, beside the wide run,
    whose ranks then run the one-rank references side by side (a process
    of their own each: this process's launch counters stay the other
    phases'); each is a chain of device synchronizations and host round
    trips, not a timing.  Gates: ``dd_simplex_compare``'s."""
    from navier_stokes_solver_tpu_torch.dist import launch

    card = nvidia_smi()
    devs = lambda n: [str(device)] * n
    pair = [("check", "host"), ("check", "fused"), ("config3", "host")]
    n = DD_SIMPLEX_STRIPS_WIDE[0]
    if n < len(pair):
        raise ValueError(f"the {n}-strip run's ranks cannot hold the {len(pair)} one-rank references")

    def timed_launch(*args):
        t0 = time.perf_counter()
        return launch(*args), time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        two = ex.submit(timed_launch, dd_simplex_rank, 2, devs(2), pair, (2, 1))
        wide = ex.submit(timed_launch, dd_simplex_rank, n, devs(n), pair[:1], DD_SIMPLEX_STRIPS_WIDE, pair)
        (two, wall2), (wide, wall_n) = two.result(), wide.result()
    one = {job: wide[i]["reference"] for i, job in enumerate(pair)}
    runs = [(job, 2, [r["strips"][i] for r in two], wall2) for i, job in enumerate(pair)]
    runs.append((pair[0], n, [r["strips"][0] for r in wide], wall_n))
    out = {"counts": [], "gaps": {}, "walls": {}}
    for (case, mode), n_strips, ranks, wall in runs:
        tag = f"dd-simplex {case} {mode} {n_strips} strips"
        r0, ref_run = ranks[0], one[(case, mode)]
        if case == "config3" and r0["n_dofs"] != CONFIG3_DOFS:
            raise RuntimeError(f"{tag}: DoF count {r0['n_dofs']} != {CONFIG3_DOFS}")
        gaps = dd_simplex_compare(tag, ref_run, ranks)
        out["gaps"][tag] = gaps
        outers = max(1, sum(r0["krylov"]))
        print(f"[dd-simplex] {case} ({r0['n_dofs']} DoFs) {mode} on {n_strips} strips ({n_strips} ranks sharing {card}, gloo through the host, beside the card workers and config 1): wall {r0['wall_s']!r} s (launch wall {wall:.1f} s for its ranks' runs{', the one-rank references included' if n_strips == n else ''}; one rank on the card {ref_run['wall_s']!r} s), Newton {r0['newton']} (one rank {ref_run['newton']}), Krylov per solve {r0['krylov']} (one rank {ref_run['krylov']}), Newton residual {r0['residual']!r} (one rank {ref_run['residual']!r}), gaps {json.dumps(gaps)}, round trip bit for bit, no launch of our kernels on any rank")
        for r, rec in enumerate(ranks):
            c = rec["collectives"]
            print(f"[dd-simplex] {case} {mode} {n_strips} strips rank {r}: collectives {json.dumps(c)}; per outer iteration {c['seam_exchanges'] / outers:.1f} seam exchanges, {c['all_reduces'] / outers:.1f} all-reduces, {c['seam_bytes'] / outers:.0f} seam bytes sent")
        out["counts"].append(summed_counts(r["counts"] for r in ranks))
        out["walls"][tag] = (r0["wall_s"], ref_run["wall_s"])
    out["counts"] = summed_counts(out["counts"])
    return out


def summed_counts(runs):
    """``read_counts`` records of several runs, the launches added."""
    out = {}
    for counts in runs:
        for name, c in counts.items():
            acc = out.setdefault(name, {"launches": 0, "by_shape": {}})
            acc["launches"] += c["launches"]
            for shape, n in c["by_shape"].items():
                acc["by_shape"][shape] = acc["by_shape"].get(shape, 0) + n
    return out


def kernel_line(errs, times, counts, counts_by_path):
    """The kernels of the slices' main paths: launches from dd-north's
    (the four ranks' summed) and times at its finest level (a 150x50 Q3/Q2
    tile, f32, in the Stokes regime, the one with a library yardstick:
    ``apply_F_fused`` and ``scatter_v_bc`` without their boundary rows, as
    a tile launches them); launches on every main path (0 on the simplex
    ones; ``cell_apply_F`` and ``scatter_v_bc``, which only the checks
    launch now, 0 on every path), and times at every shape, beside them."""
    mesh = f"{DD_NORTH_TILE[0]}x{DD_NORTH_TILE[1]} Q3/Q2 float32"
    main_tag = {"apply_F_fused": f"{mesh} stokes raw", "cell_apply_F": f"{mesh} stokes", "scatter_v_bc": f"{mesh} raw"}
    rows = []
    for name in KERNELS:
        rec = times[name][main_tag[name]]
        rows.append({
            "name": name,
            "route": "cuda",
            "role": "solve paths" if name in PATH_KERNELS else "checks only (the card-side oracle)",
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
    laps = [t_start]

    def lap(name):
        """Print the wall of the phases since the previous lap."""
        now = time.perf_counter()
        print(f"[budget] {name}: {now - laps[-1]:.1f} s (script at {now - t_start:.1f} s)")
        laps.append(now)

    device = phase_device()
    import torch


    print(
        f"[budget] depth cuts taken: stationary bench solves {SOLVES} of 2; unsteady 300x100 steps {UNSTEADY_STEPS} of 2 "
        f"(of the 800 of T = 8); config3-lu and config3-lu-fused {CONFIG3_LU_STEPS} of 20 steps (of the record's 800); "
        f"phase 12's unsteady card-only entry dropped; fused-main {FUSED_MAIN_STEPS} of 2 steps; ensemble-matrix's "
        f"combinations and the card-vs-CPU phases' card sides in {CARD_WORKERS} worker processes on the card beside "
        f"the -M phases; ensemble-matrix {ENSEMBLE_MATRIX_STEPS} of 2 steps each, (a) dropped at width (its "
        f"16x8 check kept); simplex-check's unsteady run "
        f"{SIMPLEX_CHECK_STEPS} of 2 steps; ensemble-simplex-lu B {ENSEMBLE_SIMPLEX_B} of 64 "
        f"(its factors' memory); config3 {CONFIG3_STEPS} of its 3 steps; ensemble-simplex-lu {ENSEMBLE_SIMPLEX_STEPS} "
        f"of 3 steps. Not cut: "
        f"unsteady-check steps {CHECK_STEPS}, config 1, matrix at {MATRIX_MESH[0]}x{MATRIX_MESH[1]}, simplex check at "
        f"-M {SIMPLEX_CHECK_MESH[0]}x{SIMPLEX_CHECK_MESH[1]}, fused check (3 and 2 steps), "
        f"simplex-file one step, ensemble-main B {ENSEMBLE_B} and {ENSEMBLE_STEPS} timed steps, cavity-ghia at "
        f"{CAVITY_MESH[0]}x{CAVITY_MESH[1]}, ensemble-matrix B {ENSEMBLE_B}, "
        f"ensemble-ir B {ENSEMBLE_B} and {ENSEMBLE_STEPS} timed steps, "
        f"ensemble-rest-check's four cases, dd-check at {DD_CHECK_MESH[0]}x{DD_CHECK_MESH[1]} under "
        f"{len(DD_CHECK_TILES)} tile grids, dd-north at {UNSTEADY_MESH[0]}x{UNSTEADY_MESH[1]} on "
        f"{DD_NORTH_TILES[0]} x {DD_NORTH_TILES[1]} tiles. Cut: dd-simplex's runs (24x10 on 2 and "
        f"{DD_SIMPLEX_STRIPS_WIDE[0]} strips, config 3 on 2) to {DD_SIMPLEX_NEWTON} Newton iteration(s), the "
        f"tangent solve capped at {DD_SIMPLEX_CAP} outers, config 3's at {DD_SIMPLEX_CONFIG3_CAP}"
    )
    phase_build()
    errs = phase_check(device)
    times = phase_time(device)
    for more_errs, more_times in (phase_ensemble_kernels(device), phase_cavity_kernels(device)):
        for name in errs:
            errs[name] = max(errs[name], more_errs[name])
            times[name].update(more_times[name])
    phase_launches(device)
    lap("kernel build, checks, timings, launches")
    # the CPU sides of the card-vs-CPU phases start now, in three worker
    # processes (six of the host's eight cores, niced): they run beside the
    # timed single-process paths below, each of which keeps one core and
    # the card
    pool = cpu_pool(3)
    # the fourth to eighth CPU sides start when a worker is free
    cpu = {name: pool.submit(cpu_job, name)
           for name in ("unsteady-check", "matrix", "simplex-check", "fused-check", "ensemble-check",
                        "ensemble-matrix-check", "cavity-check", "ensemble-rest-check")}
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        ref = json.load(f)["parsed"]["extra"]
    runs = []
    for _ in range(SOLVES):
        s, run = run_solve(device, ref)
        runs.append(run)
    outer = phase_outer(s, regimes=(False,))
    print(f"[main] solve_newton walls {[r['wall_s'] for r in runs]} s; outer iterations {[r['outer'] for r in runs]}; kernels per outer iteration newton {outer['newton']['kernels']!r}")
    del s
    lap("stationary bench solve")
    # the decomposed phases, each a chain of device synchronizations and
    # host round trips of ranks that wait for the card asleep, run in
    # threads: dd-north's ranks from here on, beside the timed paths after
    # the headline (its comparison with phase 9 comes at the end; beside
    # the headline they made it take 2.3 times as long), and dd-check's
    # from dd-north's end or the timed paths' end, whichever comes first
    dd_pool = concurrent.futures.ThreadPoolExecutor(2)
    north_run = dd_pool.submit(dd_north_run, device)
    timed_done = threading.Event()

    def dd_check_when_free():
        while not (timed_done.is_set() or north_run.done()):
            if not threading.main_thread().is_alive():  # a phase failed
                return None
            timed_done.wait(1.0)
        return phase_dd_check(device)

    check_future = dd_pool.submit(dd_check_when_free)
    su, unsteady = phase_unsteady_main(device)
    # dd-north's reference: phase 9's step, before fused-main moves the state
    north_ref = {"wall_s": unsteady["wall_s"], "krylov": [h["krylov_iters"] for h in solves_of(su)],
                 "drag": su.drag_force, "lift": su.lift_force}
    uouter = phase_outer(su, regimes=(False,), tag="unsteady-outer")
    print(f"[unsteady-main] per-step walls {[r['wall_s'] for r in unsteady['steps']]} s; outer iterations per step {[r['outer'] for r in unsteady['steps']]}; Newton regime per outer iteration: {uouter['newton']['kernels']!r} device kernels, {uouter['newton']['readbacks']!r} readbacks, busy {uouter['newton']['busy']:.4f}")
    fused_main = phase_fused_main(su)
    lap("unsteady-main and fused-main")
    state300 = (su.space, *su.fields())
    del su
    ensemble = phase_ensemble_main(device)
    lap("ensemble-main")
    print(f"[ensemble-main] {ensemble['member_steps_per_s']!r} member-steps/s, median step {ensemble['median_step_s']!r} s, B = 1 control {ensemble['control_step_s']!r} s, batch_efficiency_vs_single {ensemble['batch_efficiency_vs_single']!r}; per outer iteration {ensemble['outer']['kernels']!r} device kernels, {ensemble['outer']['device_ms']!r} device ms, {ensemble['outer']['wall_ms']!r} ms wall, {ensemble['outer']['readbacks']!r} readbacks, busy {ensemble['outer']['busy']:.4f}, our kernels {ensemble['outer']['ours_share']:.4f} of the device time")
    ensemble_ir = phase_ensemble_ir(device, ensemble)
    lap("ensemble-ir")
    sc, cavity = phase_cavity_ghia(device)
    couter = phase_outer(sc, regimes=(False,), tag="cavity-outer")
    print(f"[cavity-ghia] per outer iteration at the converged state, Newton regime (the Stokes rhs of a converged cavity is zero): {couter['newton']['kernels']!r} device kernels, {couter['newton']['device_ms']!r} device ms, {couter['newton']['wall_ms']!r} ms wall, {couter['newton']['readbacks']!r} readbacks, busy {couter['newton']['busy']:.4f}")
    del sc
    _, cavity_cli = phase_cavity_cli(device)
    phase_profile(device)
    lap("cavity-ghia, cavity-cli and profile")
    timed_done.set()
    # from here on, beside the -M phases and config 1 in this process:
    # ensemble-matrix's combinations and the card sides of the card-vs-CPU
    # phases in CARD_WORKERS worker processes on the card, the longest
    # first (CARD_ORDER; a host-bound path: the card idles most of the
    # time under each of them)
    card_pool = cpu_pool(CARD_WORKERS, initializer=wait_asleep)
    jobs = {(kind, key): card_pool.submit(ensemble_matrix_run if kind == "matrix" else card_job, key)
            for kind, key in CARD_ORDER}
    matrix_runs = [jobs[("matrix", i)] for i in ENSEMBLE_MATRIX_WIDTH]
    card = {name: jobs[("card", name)] for name in CARD_SIDES}
    s3, config3 = phase_config3(device)
    print(f"[config3] setup {config3['setup_s']:.3f} s, per-step walls {[r['wall_s'] for r in config3['steps']]} s, Newton iterations per step {[r['newton_iterations'] for r in config3['steps']]}, outers per step {[r['outer'] for r in config3['steps']]}")
    simplex3 = (s3.disc, *s3.fields())
    del s3
    lap("config3")
    _, config3_lu = phase_config3_lu(device)
    lap("config3-lu")
    s3f, config3_lu_fused = phase_config3_lu_fused(device)
    lap("config3-lu-fused")
    simplex_lu = phase_ensemble_simplex_lu(device, s3f)
    del s3f
    lap("ensemble-simplex-lu")
    with tempfile.TemporaryDirectory() as tmp:
        _, simplex_file = phase_simplex_file(device, tmp)
        phase_native_io(state300, simplex3, os.path.join(tmp, "curved.msh"))
    lap("simplex-file and native-io")
    # dd-simplex beside config 1, in a thread: its ranks' every collective
    # waits for the card, which config 1's host-bound launches leave idle
    # (beside the other phases from phase 13's end it took 950 s and
    # slowed them all; first and alone it added 144.9 s to the script,
    # after config 1 135.7 s)
    simplex_pool = concurrent.futures.ThreadPoolExecutor(1)
    simplex_future = simplex_pool.submit(phase_dd_simplex, device)
    s1, config1 = phase_config1(device)
    c1outer = phase_outer(s1, regimes=(True,), tag="config1-outer")
    print(f"[config1] setup {config1['setup_s']:.3f} s, solve wall {config1['wall_s']!r} s, {config1['outer']} outers; Stokes regime per outer iteration: {c1outer['stokes']['kernels']!r} device kernels, {c1outer['stokes']['device_ms']!r} device ms, {c1outer['stokes']['readbacks']!r} readbacks, busy {c1outer['stokes']['busy']:.4f}")
    del s1
    lap("config1")
    dd_simplex = simplex_future.result()
    simplex_pool.shutdown()
    lap("dd-simplex (the wait for it after config1, which it ran beside)")
    # the card-vs-CPU phases: both sides ran in the worker processes
    with pool, card_pool:
        phase_unsteady_check(device, cpu["unsteady-check"], card["unsteady-check"])
        lap("unsteady-check (the wait for both sides)")
        phase_matrix(device, cpu["matrix"], card["matrix"])
        lap("matrix (the wait for both sides)")
        phase_simplex_check(device, cpu["simplex-check"], card["simplex-check"])
        lap("simplex-check (the wait for both sides)")
        phase_cavity_check(device, cpu["cavity-check"], card["cavity-check"])
        lap("cavity-check (the wait for both sides)")
        phase_fused_check(device, cpu["fused-check"], card["fused-check"])
        lap("fused-check (the wait for both sides)")
        phase_ensemble_check(device, cpu["ensemble-check"], card["ensemble-check"])
        lap("ensemble-check (the wait for both sides)")
        phase_ensemble_matrix_check(device, cpu["ensemble-matrix-check"], card["ensemble-matrix-check"])
        lap("ensemble-matrix-check (the wait for both sides)")
        phase_ensemble_rest_check(device, cpu["ensemble-rest-check"], card["ensemble-rest-check"])
        lap("ensemble-rest-check (the wait for both sides)")
        matrix = phase_ensemble_matrix(device, matrix_runs)
        lap("ensemble-matrix (the wait for its workers)")
    dd_north = phase_dd_north(device, north_ref, north_run)
    lap("dd-north (the wait for its ranks, started after the headline)")
    dd_check = check_future.result()
    dd_pool.shutdown()
    lap("dd-check (the wait for it after the phases it ran beside)")
    for name in errs:
        errs[name] = max(errs[name], dd_north["errs"][name], dd_check["errs"][name])
    counts_by_path = {
        "stationary": runs[0]["counts"], "unsteady": unsteady["counts"], "unsteady_fused": fused_main["counts"],
        "config1_blockdiag": config1["counts"], "simplex_config3": config3["counts"],
        "simplex_config3_lu": config3_lu["counts"], "simplex_config3_lu_fused": config3_lu_fused["counts"],
        "simplex_file": simplex_file["counts"], "ensemble": ensemble["counts"],
        "ensemble_matrix": summed_counts(c["counts"] for c in matrix.values()),
        "cavity_ghia": cavity["counts"], "cavity_cli": cavity_cli["counts"],
        "ensemble_ir": ensemble_ir["counts"], "ensemble_simplex_lu": simplex_lu["counts"],
        "dd_north": dd_north["counts"], "dd_check": dd_check["counts"], "dd_simplex": dd_simplex["counts"],
    }
    print(kernel_line(errs, times, counts_by_path["dd_north"], counts_by_path))
    print(f"[profile] {len(PROFILE_WINDOWS)} profiler windows: {sum(a for a, _ in PROFILE_WINDOWS)} traces taken "
          f"again; {sum(d > 0 for _, d in PROFILE_WINDOWS)} of the kept traces lost markers "
          f"({sum(d for _, d in PROFILE_WINDOWS)} in all)")
    print(f"[budget] script wall {time.perf_counter() - t_start:.1f} s")
    left = stop_children()
    print(f"[exit] processes still running after the last phase, now stopped: {json.dumps(left)}")
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    adopt_orphans()
    try:
        main()
    finally:
        if left := stop_children():
            print(f"[exit] processes still running when the script stopped, now stopped: {json.dumps(left)}", file=sys.stderr)
