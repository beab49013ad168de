#!/usr/bin/env python3
"""A/B of the PyTorch port's velocity-block apply between two checkouts, on
one NVIDIA GPU.

    python3 scripts/torch_apply_f_ab.py --root DIR --tag NAME [--save FILE.npz]
    python3 scripts/torch_apply_f_ab.py --root DIR --tag NAME --kernel-only
    python3 scripts/torch_apply_f_ab.py --compare A.npz B.npz

Imports ``navier_stokes_solver_tpu_torch`` from the checkout ``DIR`` (and
the timing helpers from this checkout's ``chip_smoke.py``), then measures,
at 100x70 Q3/Q2 float32 in both regimes, on inputs made from a numpy seed:

  * ``cell_apply_F`` on gathered DoFs -- the entry point every version of
    the port has -- device ms per call (200 back-to-back launches);
  * the whole ``apply_F`` with its boundary rows: the device kernels one
    call runs and the sum of their device times (``torch.profiler``; a
    run of back-to-back calls would time the host, since a call of the
    first version is ten launches);
  * per outer FGMRES iteration of a tangent solve at the bench
    configuration (state zero, nu = 1/90): device kernels, device ms and
    wall ms, from profiler windows of 1 and 5 outer iterations.

It prints one JSON line.  ``--save`` writes the f32 outputs of
``cell_apply_F`` and ``apply_F``; ``--compare`` prints, per output, the
largest difference between two such files and whether they are equal bit
for bit.  Compare checkouts only on one card in one sitting, in turns
(parent, change, change, parent): cards and their hosts differ.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str, tag: str, save: str | None):
    sys.path.insert(0, os.path.abspath(root))
    cs = _chip_smoke()
    device = cs.phase_device()
    import numpy as np
    import torch

    from navier_stokes_solver_tpu_torch.api import NSSolverStationary
    from navier_stokes_solver_tpu_torch.ops import apply_F
    from navier_stokes_solver_tpu_torch.ops.cell_kernel import cell_apply_F
    from navier_stokes_solver_tpu_torch.ops.matfree import _gather_v

    import navier_stokes_solver_tpu_torch as pkg

    print(f"[ab] {tag}: package {os.path.dirname(pkg.__file__)}")
    disc, linq, x, bc = cs.kernel_case(device, cs.BENCH_MESH, (3, 2), torch.float32)
    x_loc = _gather_v(disc, x)
    out = {"tag": tag, "card": cs.nvidia_smi()}
    arrays = {}
    for stokes in (True, False):
        regime = "stokes" if stokes else "newton"
        lin = None if stokes else linq
        cell = lambda: cell_apply_F(disc, cs.KERNEL_NU, cs.KERNEL_INV_DT, lin, x_loc, stokes=stokes)
        full = lambda: apply_F(disc, cs.KERNEL_NU, cs.KERNEL_INV_DT, lin, x, stokes=stokes, bc_diag=bc)
        arrays[f"cell_apply_F_{regime}"] = cell().cpu().numpy()
        arrays[f"apply_F_{regime}"] = full().cpu().numpy()
        events = cs.profile_call(full)[0]
        out[regime] = {
            "cell_apply_F_ms": cs.device_ms(cell),
            "apply_F_kernels": len(events),
            "apply_F_kernel_ms": sum(e.time_range.elapsed_us() for e in events) / 1e3,
        }
    s = NSSolverStationary(cs.bench_options(device)).setup()
    s.nu = 1.0 / 90.0
    for stokes in (False, True):
        regime = "stokes" if stokes else "newton"
        out[regime]["per_outer"] = cs.outer_profile(s, stokes)
    print(json.dumps(out))
    if save:
        np.savez(save, **arrays)


def kernel_only(root: str, tag: str):
    """Device ms of one cell-kernel call at 100x70 and every multigrid
    level, f32, both regimes: ``cell_apply_F_lattice`` where the checkout
    has it, else ``cell_apply_F`` on gathered DoFs."""
    sys.path.insert(0, os.path.abspath(root))
    cs = _chip_smoke()
    device = cs.phase_device()
    import torch

    from navier_stokes_solver_tpu_torch.ops import cell_kernel
    from navier_stokes_solver_tpu_torch.ops.matfree import _gather_v

    lattice = hasattr(cell_kernel, "cell_apply_F_lattice")
    out = {"tag": tag, "card": cs.nvidia_smi(), "entry": "lattice" if lattice else "gathered"}
    for mesh in cs.mg_shapes(device, cs.BENCH_MESH):
        disc, linq, x, _ = cs.kernel_case(device, mesh, (3, 2), torch.float32)
        x_in = x if lattice else _gather_v(disc, x)
        fn = cell_kernel.cell_apply_F_lattice if lattice else cell_kernel.cell_apply_F
        for stokes in (True, False):
            lin = None if stokes else linq
            out[f"{mesh[0]}x{mesh[1]} {'stokes' if stokes else 'newton'}"] = cs.device_ms(
                lambda: fn(disc, cs.KERNEL_NU, cs.KERNEL_INV_DT, lin, x_in, stokes=stokes)
            )
    print(json.dumps(out))


def compare(a: str, b: str):
    import numpy as np

    fa, fb = np.load(a), np.load(b)
    for k in sorted(fa.files):
        d = float(np.max(np.abs(fa[k] - fb[k])))
        print(f"[ab] {k}: max|a-b| {d!r}, bitwise equal {fa[k].tobytes() == fb[k].tobytes()}")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", help="checkout whose navier_stokes_solver_tpu_torch is measured")
    p.add_argument("--tag", default="", help="name printed with the results")
    p.add_argument("--save", help="write the f32 outputs to this .npz")
    p.add_argument("--compare", nargs=2, metavar="NPZ", help="compare two --save files")
    p.add_argument("--kernel-only", action="store_true",
                   help="only time the cell kernel at every multigrid level")
    a = p.parse_args()
    if a.compare:
        compare(*a.compare)
    elif a.root and a.kernel_only:
        kernel_only(a.root, a.tag)
    elif a.root:
        measure(a.root, a.tag, a.save)
    else:
        p.error("give --root or --compare")


if __name__ == "__main__":
    main()
