#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; none catches another's):

  1. device   -- require CUDA; print the card (nvidia-smi name and power
                limit) and the torch / CUDA versions;
  2. build    -- compile the hand-written kernels from ``csrc/`` (one nvcc
                per source, started together) and print ptxas's register
                and spill report;
  3. check    -- each kernel against its plain PyTorch version on the card,
                at 100x70 Q3/Q2, 20x9 Q2/Q1, 300x100 Q3/Q2 and every
                multigrid level of both main paths: ``cell_apply_F`` (both
                entry points, and a permuted lattice layout) within rtol =
                atol 1e-5 (f32) and 1e-12 (f64); ``scatter_v_bc`` bit for
                bit (max |diff| == 0), with and without the boundary rows;
                every operand's largest element offset must fit the
                kernels' 32-bit indexing;
  4. time     -- at 100x70, 300x100 and every multigrid level of both, f32,
                both regimes:
                each kernel's device time (CUDA events around 200
                back-to-back launches queued behind a sleep kernel, so the
                host cannot starve the card, divided by 200), its
                host-inclusive time (events around one call, median of 50),
                its plain version's time, the library yardstick's and the
                bound;
  5. launches -- one ``apply_F`` on CUDA in a ``torch.profiler`` window must
                run exactly two device kernels, these two;
  6. main     -- the stationary 100x70 Q3/Q2 solve at the tuned ``bench.py``
                configuration through ``NSSolverStationary``, twice (their
                walls show the spread within one process): the drag must match
                ``BENCH_r05.json`` within rtol 1e-7, the outer Krylov count
                stay within 2 x 589, and every kernel of the path must have
                launched (counts zeroed just before each solve, read just
                after);
  7. outer    -- at the converged state, device kernels, device time, wall
                and host readbacks (device-to-host copies) per outer FGMRES
                iteration in each regime, from profiler windows of 1 and 4
                outer iterations (difference);
  8. unsteady-check -- ``NSSolver.solve()`` (the per-step Re ramp) at 32x12
                Q3/Q2, Re 20, two steps, all-f64 preconditioner, once on the
                card and once on the CPU (the plain versions): per-solve
                Krylov counts equal (or each within 1, printed), drag and
                lift per step within rtol 1e-7, fields within 1e-6 of their
                largest magnitude;
  9. unsteady-main -- the north-star unsteady configuration at full width:
                300x100 Q3/Q2 (657,740 DoFs), Re 100, dt 0.01, two of the 800
                steps of T = 8, tol 1e-9, FGMRES basis 30, blockTriangular
                with the Cahouet-Chabard leg (one Lp V-cycle), f32
                preconditioner, ``NSSolver.solve(direct=True)``: setup and
                per-step walls, Newton iterations, outer counts, final
                Newton residual (each <= 1e-9), coefficients (finite), kernel
                launches (counts zeroed just before, read just after: each
                kernel must have launched);
 10. unsteady-outer -- phase 7's profile in the unsteady Newton regime at
                the state the run ended in, with our kernels' share;
 11. report   -- one JSON line of per-kernel results, the nvidia-smi line,
                then the final ``{"ok": true, "device": ...}`` line.

If the script outgrows its time budget, depth is cut, in this order: the
stationary solve to one run (``SOLVES``), then the unsteady run to one
step (``UNSTEADY_STEPS``); never the mesh.  The cut is printed.

Exits non-zero without a result when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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
SOLVES = 2  # stationary runs (the first depth cut: 1)
# the unsteady north star (BASELINE.json): 300x100 Q3/Q2, Re 100, dt 0.01
UNSTEADY_MESH = (300, 100)
UNSTEADY_DOFS = 657_740
UNSTEADY_DT = 0.01
UNSTEADY_STEPS = 2  # of the 800 steps of T = 8 (the second depth cut: 1)
CHECK_MESH = (32, 12)  # unsteady-check: card against CPU
CHECK_RE, CHECK_STEPS = 20.0, 2
FIELD_GATE = 1e-6  # BASELINE.md, relative to each field's largest magnitude
INDEX_LIMIT = 2**31  # the kernels index in 32 bits
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


def kernel_case(device, mesh, deg, dtype, seed=0):
    """Disc, linearization, velocity lattice and boundary diagonal at one
    shape, made from a numpy seed: ``(disc, linq, x_u, bc_diag)``."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import Blocks, diag_F, eval_state, make_disc

    disc = make_disc(make_fe_space(make_channel_geometry(*mesh), *deg), dtype, device)
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


def cell_apply_cost(disc, stokes):
    """Bytes (each input read once, y written once) and flops of one
    ``cell_apply_F_lattice`` call."""
    n_q, n_v = disc.cell_tabs.shape[1:]
    C = disc.nx * disc.ny
    NY, NX = disc.NV
    words = 2 * NY * NX + n_q * C + 3 * n_q * n_v + 2 * n_v * C
    if stokes:
        flops = C * (16 * n_q * n_v + 8 * n_q)
    else:
        words += 6 * n_q * C
        flops = C * (24 * n_q * n_v + 28 * n_q)
    return words * disc.cell_w.element_size(), flops


def scatter_cost(disc, with_bc):
    """Bytes and flops of one ``scatter_v_bc`` call."""
    n_v = disc.cell_tabs.shape[2]
    NY, NX = disc.NV
    words = 2 * n_v * disc.nx * disc.ny + 2 * NY * NX
    nbytes = 0
    if with_bc:
        words += 4 * NY * NX  # x, diag
        nbytes = 2 * NY * NX  # the two bool masks
    return words * disc.cell_w.element_size() + nbytes, 2 * n_v * disc.nx * disc.ny + 2 * NY * NX


# ---------------------------------------------------------------------------
# 3. check
# ---------------------------------------------------------------------------


def kernel_shapes(device):
    """(mesh, degree) pairs: the 100x70 and 300x100 Q3/Q2 main paths, 20x9
    Q2/Q1, and every coarse level of both main paths' multigrid chains."""
    coarse = mg_shapes(device, BENCH_MESH)[1:] + mg_shapes(device, UNSTEADY_MESH)[1:]
    return [(BENCH_MESH, (3, 2)), ((20, 9), (2, 1)), (UNSTEADY_MESH, (3, 2))] + [(s, (3, 2)) for s in coarse]


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


def phase_check(device):
    import torch

    from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
        cell_apply_F,
        cell_apply_F_lattice,
        cell_apply_F_lattice_plain,
    )
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    err_a = err_b = 0.0
    for mesh, deg in kernel_shapes(device):
        dtypes = (torch.float32, torch.float64) if mesh in (BENCH_MESH, (20, 9), UNSTEADY_MESH) else (torch.float32,)
        for dtype in dtypes:
            disc, linq, x, bc = kernel_case(device, mesh, deg, dtype)
            # the layout a multigrid transfer's einsum hands the kernel
            x_perm = x.permute(2, 0, 1).contiguous().permute(1, 2, 0)
            tol = KERNEL_TOL[str(dtype)[6:]]
            views = {"lattice view": lattice_view(x, deg[0], *mesh[::-1]), "permuted view": lattice_view(x_perm, deg[0], *mesh[::-1]), "linq.gradu": linq.gradu, "output": _gather_v(disc, x)}
            offsets = {k: max_offset(v) for k, v in views.items()}
            print(f"[check] {mesh[0]}x{mesh[1]} Q{deg[0]}/Q{deg[1]} {str(dtype)[6:]}: largest element offsets {json.dumps(offsets)} (32-bit limit {INDEX_LIMIT})")
            if max(offsets.values()) >= INDEX_LIMIT:
                raise RuntimeError(f"an operand at {mesh} exceeds the kernels' 32-bit indexing: {offsets}")
            for stokes in (True, False):
                tag = f"{mesh[0]}x{mesh[1]} Q{deg[0]}/Q{deg[1]} {str(dtype)[6:]} {'stokes' if stokes else 'newton'}"
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
    return {"cell_apply_F": err_a, "scatter_v_bc": err_b}


# ---------------------------------------------------------------------------
# 4. time
# ---------------------------------------------------------------------------


def phase_time(device):
    """Per kernel: {shape tag: timing record}, f32, at 100x70 and every
    multigrid level."""
    import torch

    from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
        cell_apply_F_lattice,
        cell_apply_F_lattice_plain,
    )
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v, lattice_view
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    out = {"cell_apply_F": {}, "scatter_v_bc": {}}
    for mesh in mg_shapes(device, BENCH_MESH) + mg_shapes(device, UNSTEADY_MESH):
        disc, linq, x, bc = kernel_case(device, mesh, (3, 2), torch.float32)
        shape = f"{mesh[0]}x{mesh[1]} Q3/Q2 float32"
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
        idx = lattice_view(torch.arange(2 * NY * NX, device=device).view(2, NY, NX), 3, disc.ny, disc.nx)
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


# ---------------------------------------------------------------------------
# 5. launches per apply_F
# ---------------------------------------------------------------------------


def device_events(prof):
    """The device-side activities (kernels, copies, fills) of a profile."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_call(fn):
    """``(device activities, result, wall seconds)`` of one call of ``fn``.
    The profiler records the second of two calls: tracing can miss a kernel
    launched just as it starts, so the first call is its unrecorded
    warm-up step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    events = []
    with profile(
        activities=[ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
        on_trace_ready=lambda p: events.extend(device_events(p)),
    ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    return events, out, wall


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

    ours = {"cell_apply_F": "cell_apply_f_kernel", "scatter_v_bc": "scatter_v_kernel"}
    win = {}
    for n in (1, 1 + iters):
        ev, (_, info), wall = profile_call(lambda: solve(n))
        win[n] = {
            "iters": info.iters,
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


def solves_of(s):
    return [h for h in s.history if h["phase"] != "step"]


def steps_of(s):
    return [h for h in s.history if h["phase"] == "step"]


def phase_unsteady_check(device):
    """The per-step ramp path on the card against the same run on the CPU."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.precond import PrecondConfig

    cfg = PrecondConfig(schur_mode="cahouet", vmult_dtype=None, mg_dtype=None)
    runs = {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        s = unsteady_solver(dev, CHECK_MESH, CHECK_RE, CHECK_STEPS, cfg)
        t0 = time.perf_counter()
        s.solve()
        runs[where] = s
        print(f"[unsteady-check] {CHECK_MESH[0]}x{CHECK_MESH[1]} Re {CHECK_RE} on the {where}: solve wall {time.perf_counter() - t0!r} s, per solve {[(h['phase'], h['nu'], h['n_iter'], h['krylov_iters']) for h in solves_of(s)]}")
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
    for name, a, b in zip(("velocity", "pressure"), g.fields(), c.fields()):
        err, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
        print(f"[unsteady-check] {name}: max|card - CPU| {err:.3e} (max|CPU| {scale:.3e})")
        if not err <= FIELD_GATE * scale:
            raise RuntimeError(f"unsteady-check: {name} fields differ by {err} > {FIELD_GATE} x {scale}")


def phase_unsteady_main(device):
    import numpy as np

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
    u, p = s.fields()
    print(f"[unsteady-main] {UNSTEADY_MESH[0]}x{UNSTEADY_MESH[1]} Q3/Q2 Re 100, n_dofs {s.n_dofs}, setup {s.setup_seconds:.3f} s, solve wall {wall!r} s over {len(steps_of(s))} steps")
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
        print(f"[unsteady-main] step {json.dumps(rec)}")
    print(f"[unsteady-main] phases {json.dumps(s.timer.summary())}")
    print(f"[unsteady-main] launches {json.dumps(counts)}")
    if s.n_dofs != UNSTEADY_DOFS:
        raise RuntimeError(f"DoF count {s.n_dofs} != {UNSTEADY_DOFS}")
    if u.shape != (2,) + s.disc.NV or p.shape != s.disc.NP or not (np.isfinite(u).all() and np.isfinite(p).all()):
        raise RuntimeError("unsteady fields are not finite or have the wrong shape")
    for rec in steps:
        if not rec["newton_residual"] <= s.NEWTON_TOL:
            raise RuntimeError(f"step {rec['step']} ended with Newton residual {rec['newton_residual']!r} > {s.NEWTON_TOL}")
        if not (np.isfinite(rec["drag_coeff"]) and np.isfinite(rec["lift_coeff"])):
            raise RuntimeError(f"step {rec['step']}: non-finite coefficient")
    for name, c in counts.items():
        if c["launches"] <= 0:
            raise RuntimeError(f"the unsteady path never launched {name}")
    return s, {"wall_s": wall, "steps": steps, "counts": counts}


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def kernel_line(errs, times, counts, counts_by_path):
    """The kernels of this slice's main path (the unsteady 300x100 run):
    launches from that run, times at its finest level; launches on every
    main path beside them."""
    mesh = f"{UNSTEADY_MESH[0]}x{UNSTEADY_MESH[1]} Q3/Q2 float32"
    main_tag = {"cell_apply_F": f"{mesh} newton", "scatter_v_bc": f"{mesh} bc"}
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

    print(f"[budget] depth: stationary solves {SOLVES} of 2, unsteady steps {UNSTEADY_STEPS} of 2 (the 800 steps of T = 8 cut to 2)")
    phase_build()
    errs = phase_check(device)
    times = phase_time(device)
    phase_launches(device)
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        ref = json.load(f)["parsed"]["extra"]
    runs = []
    for _ in range(SOLVES):
        s, run = run_solve(device, ref)
        runs.append(run)
    outer = phase_outer(s)
    print(f"[main] solve_newton walls {[r['wall_s'] for r in runs]} s; outer iterations {[r['outer'] for r in runs]}; kernels per outer iteration newton {outer['newton']['kernels']!r}, stokes {outer['stokes']['kernels']!r}")
    del s
    phase_unsteady_check(device)
    su, unsteady = phase_unsteady_main(device)
    uouter = phase_outer(su, regimes=(False,), tag="unsteady-outer")
    print(f"[unsteady-main] per-step walls {[r['wall_s'] for r in unsteady['steps']]} s; outer iterations per step {[r['outer'] for r in unsteady['steps']]}; Newton regime per outer iteration: {uouter['newton']['kernels']!r} device kernels, {uouter['newton']['readbacks']!r} readbacks, busy {uouter['newton']['busy']:.4f}")
    counts_by_path = {"stationary": runs[0]["counts"], "unsteady": unsteady["counts"]}
    print(kernel_line(errs, times, unsteady["counts"], counts_by_path))
    print(f"[budget] script wall {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
