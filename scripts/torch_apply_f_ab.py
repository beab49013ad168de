#!/usr/bin/env python3
"""A/B of the PyTorch port's velocity-block apply between two checkouts, on
one NVIDIA GPU.

    python3 scripts/torch_apply_f_ab.py --root DIR --tag NAME [--save FILE.npz]
    python3 scripts/torch_apply_f_ab.py --root DIR --tag NAME --kernel-only [--mesh NX,NY ...] [--degree 2] [--batch] [--shapes]
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

``--kernel-only`` times the kernels alone (device ms per call, 200
back-to-back launches): ``cell_apply_F`` in both regimes and
``scatter_v_bc`` with its boundary rows, and ``apply_F_fused`` with its
rows in both regimes where the checkout has it, at every multigrid level
of 100x70 Q3/Q2, or at the ``--mesh`` shapes given (f32; Q3/Q2, or
Q2/Q1 with ``--degree 2``; ``--batch``: config 5's B = 64 members with
their viscosities, Q2/Q1).
``apply_F_fused`` is timed at the block shape a launch picks
(``apply_f_kernel.block_shape``); ``--shapes`` times it at every block
shape it is built with (``apply_f_kernel.BLOCK_SHAPES``), each output
checked bit for bit against the picked shape's, with each shape's tile and
recompute ratio (cells computed over cells owned, the halo included).

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


def recompute_ratio(nx: int, ny: int, tile) -> float:
    """Cells the fused kernel computes over the cells of the mesh, at a
    ``(rows, columns)`` tile: each tile with its halo row and column
    (none before the first row or column)."""
    ty, tx = tile
    rows = sum(min(y + ty, ny) - max(y - 1, 0) for y in range(0, ny, ty))
    cols = sum(min(x + tx, nx) - max(x - 1, 0) for x in range(0, nx, tx))
    return rows * cols / (nx * ny)


def kernel_only(root: str, tag: str, meshes=None, shapes=False, degree=3, batch=False):
    """Device ms of one cell-kernel call at 100x70 and every multigrid
    level (or at ``meshes``), f32, both regimes: ``cell_apply_F_lattice``
    where the checkout has it, else ``cell_apply_F`` on gathered DoFs; and
    of one ``scatter_v_bc`` call with the boundary rows where the checkout
    has it."""
    sys.path.insert(0, os.path.abspath(root))
    cs = _chip_smoke()
    device = cs.phase_device()
    import torch

    from navier_stokes_solver_tpu_torch.ops import cell_kernel
    from navier_stokes_solver_tpu_torch.ops.matfree import _gather_v

    try:
        from navier_stokes_solver_tpu_torch.ops.scatter_kernel import scatter_v_bc
    except ImportError:  # the first version: no scatter kernel
        scatter_v_bc = None
    try:
        from navier_stokes_solver_tpu_torch.ops import apply_f_kernel
    except ImportError:  # before the one-launch apply_F
        apply_f_kernel = None
    lattice = hasattr(cell_kernel, "cell_apply_F_lattice")
    out = {"tag": tag, "card": cs.nvidia_smi(), "entry": "lattice" if lattice else "gathered"}
    for mesh in meshes or cs.mg_shapes(device, cs.BENCH_MESH):
        if batch:
            disc, nu, linq, x, bc = cs.ensemble_kernel_case(device, mesh, torch.float32)
            lead = (x.shape[0],)
        else:
            disc, linq, x, bc = cs.kernel_case(device, mesh, (degree, degree - 1), torch.float32)
            nu, lead = cs.KERNEL_NU, ()
        x_in = x if lattice else _gather_v(disc, x)
        fn = cell_kernel.cell_apply_F_lattice if lattice else cell_kernel.cell_apply_F
        for stokes in (True, False):
            lin = None if stokes else linq
            out[f"{mesh[0]}x{mesh[1]} {'stokes' if stokes else 'newton'}"] = cs.device_ms(
                lambda: fn(disc, nu, cs.KERNEL_INV_DT, lin, x_in, stokes=stokes)
            )
        if scatter_v_bc is not None:
            loc = fn(disc, nu, cs.KERNEL_INV_DT, linq, x_in, stokes=False)
            out[f"{mesh[0]}x{mesh[1]} scatter bc"] = cs.device_ms(
                lambda: scatter_v_bc(disc, loc, bc_diag=bc, x_u=x)
            )
        if apply_f_kernel is None:
            continue
        for stokes in (True, False):
            lin = None if stokes else linq
            regime = "stokes" if stokes else "newton"
            chosen = apply_f_kernel.block_shape(disc.deg_v, disc.nx * disc.ny * (lead[0] if lead else 1))
            launch = lambda shape: apply_f_kernel._launch(disc, nu, cs.KERNEL_INV_DT, lin, x, bc, stokes, lead, shape)
            want = launch(chosen)
            out[f"{mesh[0]}x{mesh[1]} fused {regime} bc chosen shape"] = chosen
            for shape in range(len(apply_f_kernel.BLOCK_SHAPES[disc.deg_v])) if shapes else (chosen,):
                tile = apply_f_kernel.block_tile(disc.deg_v, shape)
                key = f"{mesh[0]}x{mesh[1]} fused {regime} bc shape {shape} tile {tile[0]}x{tile[1]}"
                if not torch.equal(launch(shape), want):
                    raise RuntimeError(f"{key}: the output differs from block shape {chosen}'s")
                out[key] = cs.device_ms(lambda: launch(shape))
                out[f"{key} recompute"] = recompute_ratio(disc.nx, disc.ny, tile)
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
                   help="only time the kernels, at every multigrid level or at --mesh")
    p.add_argument("--mesh", action="append", default=None, metavar="NX,NY",
                   help="with --kernel-only: a Q3/Q2 shape to time (repeatable)")
    p.add_argument("--degree", type=int, default=3, choices=(2, 3),
                   help="with --kernel-only: the velocity degree (Q3/Q2 or Q2/Q1)")
    p.add_argument("--batch", action="store_true",
                   help="with --kernel-only: config 5's 64 members (Q2/Q1) in each launch")
    p.add_argument("--shapes", action="store_true",
                   help="with --kernel-only: time apply_F_fused at each block shape it is built with")
    a = p.parse_args()
    if a.compare:
        compare(*a.compare)
    elif a.root and a.kernel_only:
        meshes = [tuple(int(v) for v in m.split(",")) for m in a.mesh] if a.mesh else None
        kernel_only(a.root, a.tag, meshes, a.shapes, a.degree, a.batch)
    elif a.root:
        measure(a.root, a.tag, a.save)
    else:
        p.error("give --root or --compare")


if __name__ == "__main__":
    main()
