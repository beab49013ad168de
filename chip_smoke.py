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
                at 100x70 Q3/Q2, 20x9 Q2/Q1 and every multigrid level of the
                main path: ``cell_apply_F`` (both entry points, and a
                permuted lattice layout) within rtol = atol 1e-5 (f32) and
                1e-12 (f64); ``scatter_v_bc`` bit for bit (max |diff| == 0),
                with and without the boundary rows;
  4. time     -- at 100x70 and every multigrid level, f32, both regimes:
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
  7. outer    -- at the converged state, device kernels, device time and
                wall per outer FGMRES iteration in each regime, from
                profiler windows of 1 and 4 outer iterations (difference);
  8. report   -- one JSON line of per-kernel results, the nvidia-smi line,
                then the final ``{"ok": true, "device": ...}`` line.

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
KERNEL_NU, KERNEL_INV_DT = 0.05, 50.0
# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
TIMED_CALLS, HOST_CALLS, PLAIN_CALLS = 200, 50, 20
OUTER_WINDOW = 4
SOLVES = 2
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
    """(mesh, degree) pairs: the 100x70 Q3/Q2 main path, 20x9 Q2/Q1, and
    every coarse level of the main path's multigrid chain."""
    return [(BENCH_MESH, (3, 2)), ((20, 9), (2, 1))] + [(s, (3, 2)) for s in mg_shapes(device)[1:]]


def mg_shapes(device):
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc
    from navier_stokes_solver_tpu_torch.precond.mg import attach_mg, mg_level_shapes

    fine = make_disc(make_fe_space(make_channel_geometry(*BENCH_MESH), 3, 2), torch.float32, device)
    return mg_level_shapes(attach_mg(fine))


def phase_check(device):
    import torch

    from navier_stokes_solver_tpu_torch.ops.cell_kernel import (
        cell_apply_F,
        cell_apply_F_lattice,
        cell_apply_F_lattice_plain,
    )
    from navier_stokes_solver_tpu_torch.ops.lattice import _gather_v
    from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc, scatter_v_bc_plain

    err_a = err_b = 0.0
    for mesh, deg in kernel_shapes(device):
        dtypes = (torch.float32, torch.float64) if mesh in (BENCH_MESH, (20, 9)) else (torch.float32,)
        for dtype in dtypes:
            disc, linq, x, bc = kernel_case(device, mesh, deg, dtype)
            # the layout a multigrid transfer's einsum hands the kernel
            x_perm = x.permute(2, 0, 1).contiguous().permute(1, 2, 0)
            tol = KERNEL_TOL[str(dtype)[6:]]
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
    for mesh in mg_shapes(device):
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


def outer_profile(disc, nu, st, st_old_u, options, stokes, iters=OUTER_WINDOW):
    """Device kernels, device ms and wall ms per outer FGMRES iteration of
    one tangent solve at state ``st``: profiler windows of a 1-iteration and
    a (1 + ``iters``)-iteration solve (tolerance 0, so neither stops early),
    differenced so that the per-solve set-up cancels."""
    from navier_stokes_solver_tpu_torch.api import kernels
    from navier_stokes_solver_tpu_torch.ops import Blocks

    rhs, _ = kernels.assemble_kernel(disc.replace(mg=None), nu, 0.0, st, st_old_u, 0.0, stokes=stokes)
    zero = Blocks(disc.zeros_u(), disc.zeros_p())

    def solve(n):
        return kernels.solve_kernel(
            disc, nu, 0.0, st, rhs, zero, 0.0, 0.0, stokes=stokes,
            solver_type=options.solver_type, prec_type=options.preconditioner_type,
            variant="stationary", maxiter=n, precond_cfg=options.precond_config,
            basis=options.krylov_basis,
        )

    win = {}
    for n in (1, 1 + iters):
        ev, (_, info), wall = profile_call(lambda: solve(n))
        names = [e.name for e in ev]
        win[n] = {
            "iters": info.iters,
            "kernels": len(ev),
            "device_ms": sum(e.time_range.elapsed_us() for e in ev) / 1e3,
            "wall_ms": 1e3 * wall,
            "cell_apply_F": sum("cell_apply_f_kernel" in m for m in names),
            "scatter_v_bc": sum("scatter_v_kernel" in m for m in names),
        }
    a, b = win[1], win[1 + iters]
    d = b["iters"] - a["iters"]
    per = {k: (b[k] - a[k]) / d for k in ("kernels", "device_ms", "wall_ms", "cell_apply_F", "scatter_v_bc")}
    per["busy"] = per["device_ms"] / per["wall_ms"]
    per["outer_iterations"] = d
    return per


def phase_outer(s):
    out = {}
    for stokes in (False, True):
        regime = "stokes" if stokes else "newton"
        per = outer_profile(s.disc, s.nu, s.solution, s.solution_old.u, s.options, stokes)
        out[regime] = per
        print(f"[outer] per outer iteration, {regime} regime at the converged state (profiled): {json.dumps(per)}")
    return out


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


def kernel_line(errs, times, counts):
    main_tag = {
        "cell_apply_F": f"{BENCH_MESH[0]}x{BENCH_MESH[1]} Q3/Q2 float32 stokes",
        "scatter_v_bc": f"{BENCH_MESH[0]}x{BENCH_MESH[1]} Q3/Q2 float32 bc",
    }
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
    device = phase_device()
    import torch

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
    print(kernel_line(errs, times, runs[0]["counts"]))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
