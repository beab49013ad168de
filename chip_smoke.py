#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; none catches another's):

  1. device  -- require CUDA; print the card (nvidia-smi name and power
               limit) and the torch / CUDA versions;
  2. build   -- compile the hand-written kernels from ``csrc/`` with nvcc;
  3. kernels -- each kernel against its plain PyTorch version on the card,
               at the main path's shapes, with its stated tolerance, and
               timed (median of 50 calls, CUDA events) beside the plain
               version;
  4. main    -- the stationary 100x70 Q3/Q2 solve at the tuned ``bench.py``
               configuration, through ``NSSolverStationary``; the drag
               coefficient must match the recorded reference
               (``BENCH_r05.json``) and every kernel of the path must have
               launched;
  5. report  -- one JSON line of per-kernel results, then the final
               ``{"ok": true, "device": ...}`` line.

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


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; needs one CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] nvidia-smi: {smi}")
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
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build] {line.strip()}")


def _kernel_case(device, mesh, deg, dtype, seed=0):
    """Disc, linearization and gathered input at one shape, made from a
    numpy seed; returns ``(disc, linq, x_loc)``."""
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import Blocks, eval_state, make_disc
    from navier_stokes_solver_tpu_torch.ops.matfree import _gather_v

    disc = make_disc(make_fe_space(make_channel_geometry(*mesh), *deg), dtype, device)
    rng = np.random.default_rng(seed)
    put = lambda a: torch.as_tensor(a, device=device).to(dtype)
    x = put(rng.standard_normal((2,) + disc.NV))
    st = Blocks(put(0.3 * rng.standard_normal((2,) + disc.NV)), put(rng.standard_normal(disc.NP)))
    return disc, eval_state(disc, st), _gather_v(disc, x)


def _median_ms(fn, n=50, warmup=5):
    import torch

    for _ in range(warmup):
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


def _kernel_shapes(device):
    """(mesh, degree) pairs the check covers: the 100x70 Q3/Q2 main path
    and 20x9 Q2/Q1, plus every coarse level of the main path's multigrid
    chain."""
    import torch

    from navier_stokes_solver_tpu_torch.geometry import make_channel_geometry, make_fe_space
    from navier_stokes_solver_tpu_torch.ops import make_disc
    from navier_stokes_solver_tpu_torch.precond.mg import attach_mg, mg_level_shapes

    fine = make_disc(make_fe_space(make_channel_geometry(*BENCH_MESH), 3, 2), torch.float32, device)
    levels = mg_level_shapes(attach_mg(fine))
    return [(BENCH_MESH, (3, 2)), ((20, 9), (2, 1))] + [(s, (3, 2)) for s in levels[1:]]


def phase_kernels(device):
    import torch

    from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F, cell_apply_F_plain

    max_err = 0.0
    timing = {}
    for mesh, deg in _kernel_shapes(device):
        dtypes = (torch.float32, torch.float64) if mesh in (BENCH_MESH, (20, 9)) else (torch.float32,)
        for dtype in dtypes:
            disc, linq, x_loc = _kernel_case(device, mesh, deg, dtype)
            tol = KERNEL_TOL[str(dtype).split(".")[1]]
            for stokes in (True, False):
                args = (disc, KERNEL_NU, KERNEL_INV_DT, linq, x_loc)
                got = cell_apply_F(*args, stokes=stokes)
                want = cell_apply_F_plain(*args, stokes=stokes)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()):
                    raise RuntimeError(f"cell_apply_F: non-finite output at {mesh} {dtype}")
                err = (got - want).abs()
                bad = int((err > tol + tol * want.abs()).sum())
                e = float(err.max())
                max_err = max(max_err, e)
                tag = f"{mesh[0]}x{mesh[1]} Q{deg[0]}/Q{deg[1]} {str(dtype)[6:]} {'stokes' if stokes else 'newton'}"
                print(f"[kernels] cell_apply_F {tag}: max|kernel-plain| {e:.3e} (max|plain| {float(want.abs().max()):.3e}), {bad} entries outside rtol=atol={tol:g}")
                if bad:
                    raise RuntimeError(f"cell_apply_F disagrees with its plain version at {tag}")
                if mesh == BENCH_MESH:
                    ms = _median_ms(lambda: cell_apply_F(*args, stokes=stokes))
                    plain_ms = _median_ms(lambda: cell_apply_F_plain(*args, stokes=stokes))
                    timing[tag] = (ms, plain_ms)
                    print(f"[kernels] cell_apply_F {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 50)")
    main_tag = f"{BENCH_MESH[0]}x{BENCH_MESH[1]} Q3/Q2 float32 newton"
    return {"max_abs_err": max_err, "ms": timing[main_tag][0], "plain_ms": timing[main_tag][1]}


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


def phase_main(device):
    import numpy as np

    from navier_stokes_solver_tpu_torch.api import NSSolverStationary
    from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F

    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        ref = json.load(f)["parsed"]["extra"]
    cell_apply_F.launches = 0
    t0 = time.perf_counter()
    s = NSSolverStationary(bench_options(device)).setup()
    t1 = time.perf_counter()
    s.solve_newton()
    wall = time.perf_counter() - t1
    launches = cell_apply_F.launches
    s.compute_lift_drag()
    s.compute_drag_coeff()
    s.compute_lift_coeff()
    total = sum(h.get("krylov_iters", 0) for h in s.history)
    u, p = s.fields()
    print(f"[main] n_dofs {s.n_dofs}, setup {s.setup_seconds:.3f} s, solve_newton wall {wall:.3f} s (process to solve end {time.perf_counter() - t0:.3f} s)")
    print(f"[main] phases {json.dumps(s.timer.summary())}")
    print(f"[main] outer Krylov iterations {total} (reference {ref['total_krylov_iters']}, difference {total - ref['total_krylov_iters']:+d}) over {s.timer.counts['krylov_solve']} krylov_solve calls; history entries {len(s.history)}")
    print(f"[main] per solve {[h.get('krylov_iters') for h in s.history]}")
    print(f"[main] drag coefficient {s.drag_coeff!r} (reference {ref['drag_coeff']!r}, rel diff {abs(s.drag_coeff - ref['drag_coeff']) / abs(ref['drag_coeff']):.3e}), lift coefficient {s.lift_coeff!r}")
    print(f"[main] cell_apply_F launches {launches}")
    if s.n_dofs != ref["n_dofs"]:
        raise RuntimeError(f"DoF count {s.n_dofs} != {ref['n_dofs']}")
    if u.shape != (2,) + s.disc.NV or p.shape != s.disc.NP or not (np.isfinite(u).all() and np.isfinite(p).all()):
        raise RuntimeError("solution fields are not finite or have the wrong shape")
    if launches <= 0:
        raise RuntimeError("the main path never launched cell_apply_F")
    if not abs(s.drag_coeff - ref["drag_coeff"]) <= DRAG_RTOL * abs(ref["drag_coeff"]):
        raise RuntimeError(f"drag coefficient {s.drag_coeff!r} is not within rtol {DRAG_RTOL} of {ref['drag_coeff']!r}")
    if total > 2 * BENCH_OUTER_ITERS:
        raise RuntimeError(f"{total} outer iterations exceed 2 x {BENCH_OUTER_ITERS}")
    return launches


def main():
    sys.path.insert(0, ROOT)
    device = phase_device()
    import torch

    phase_build()
    kern = phase_kernels(device)
    launches = phase_main(device)
    print(json.dumps({"kernels": [{
        "name": "cell_apply_F",
        "route": "cuda",
        "source": "navier_stokes_solver_tpu_torch/csrc/cell_apply_f.cu",
        "replaces": "navier_stokes_solver_tpu/ops/pallas_cell.py:62",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
