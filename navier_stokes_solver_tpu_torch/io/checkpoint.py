"""Checkpoint and resume of solver state, in the JAX package's format
(version 1), so that either package resumes what the other wrote.

* ``save_time_state`` / ``load_time_state``: a fused-loop ``TimeState`` as
  ``time_state.npz`` with the keys ``u``, ``p``, ``time``, ``step``,
  ``drag`` and ``lift`` (host arrays in the state's dtypes; ``step`` int32).
* ``save_checkpoint`` / ``load_checkpoint``: a set-up solver's fields as
  ``state.npz`` (``u``, ``p``, ``u_old``, ``p_old``, ``delta_u``,
  ``delta_p``) plus ``manifest.json``.

Beyond the JAX package's writer and reader: every ``.npz`` is written to a
temporary file and moved into place with ``os.replace``, so an interrupted
save leaves the previous checkpoint readable; and a load checks the shape
and dtype of every array against the run it resumes, not only the
velocity's.

Under domain decomposition (a tile ``Disc``, ``dist/``) both formats hold
the JAX package's tile-stacked layout: every array gains a leading
y-major tile axis ``[n_y * n_x, ...]`` (the scalars of a ``TimeState``
too), gathered from the ranks; rank 0 writes, every rank reads its tile.
A checkpoint resumes only into the same layout: a single-device one into
a decomposed run, or the reverse, or another tile grid, fails the shape
check.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from navier_stokes_solver_tpu_torch.ops import Blocks

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_time_state",
    "load_time_state",
]

_FORMAT_VERSION = 1


def _save_npz(path: str, arrays: dict) -> None:
    """The tensors of ``arrays`` as ``np.savez_compressed`` to ``path``,
    through a temporary file and ``os.replace``: readers see the old file or
    the new one, never a part."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **{k: v.detach().cpu().numpy() for k, v in arrays.items()})
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _load_npz(path: str, expect: dict) -> dict:
    """The arrays of ``path`` whose keys, shapes and dtypes match ``expect``
    (key -> (shape, numpy dtype)); raises ``ValueError`` naming the first
    that does not."""
    with np.load(path) as data:
        out = {}
        for key, (shape, dtype) in expect.items():
            if key not in data.files:
                raise ValueError(f"checkpoint {path} has no array {key!r}")
            a = data[key]
            if tuple(a.shape) != tuple(shape) or a.dtype != dtype:
                raise ValueError(
                    f"checkpoint {path}: {key!r} is {a.dtype}{list(a.shape)} but this run "
                    f"expects {np.dtype(dtype)}{list(shape)} -- mesh, backend, "
                    "precision or dd layout mismatch"
                )
            out[key] = a
    return out


def _spec(t: torch.Tensor):
    """(shape, numpy dtype) of a tensor."""
    return tuple(t.shape), np.dtype(str(t.dtype).removeprefix("torch."))


def _tile_of(disc):
    """The flat tile index of a decomposed disc, else None."""
    if disc is None or not getattr(disc, "decomposed", False):
        return None
    return disc.halo_iy * disc.halo_n + disc.halo_ix


def _write(disc, path: str, name: str, arrays: dict) -> bool:
    """``arrays`` to ``path/name``: tile-stacked from every rank and written
    by rank 0 under domain decomposition (a collective, ending when the
    file is in place).  Returns whether this rank wrote."""
    tiled = _tile_of(disc) is not None
    if tiled:
        arrays = {k: torch.stack(disc.mesh.all_gather(v)) for k, v in arrays.items()}
    writer = not tiled or disc.mesh.rank == 0
    if writer:
        os.makedirs(path, exist_ok=True)
        _save_npz(os.path.join(path, name), arrays)
    return writer


def _done(disc) -> None:
    if _tile_of(disc) is not None:
        disc.mesh.barrier()


def _read(disc, file: str, arrays: dict) -> dict:
    """The arrays of ``file`` with the shapes and dtypes of ``arrays``
    (tile-stacked under domain decomposition, then this rank's tile)."""
    i = _tile_of(disc)
    if i is None:
        return _load_npz(file, {k: _spec(v) for k, v in arrays.items()})
    n = disc.halo_n * disc.halo_ny
    expect = {}
    for k, v in arrays.items():
        shape, dtype = _spec(v)
        expect[k] = ((n,) + shape, dtype)
    return {k: a[i] for k, a in _load_npz(file, expect).items()}


def save_time_state(ts, path: str, disc=None) -> str:
    """Save a fused-loop ``TimeState`` to the directory ``path``; ``disc``:
    the run's tile under domain decomposition (a collective over the
    tiles)."""
    arrays = dict(u=ts.solution.u, p=ts.solution.p, time=ts.time, step=ts.step,
                  drag=ts.drag, lift=ts.lift)
    _write(disc, path, "time_state.npz", arrays)
    _done(disc)
    return path


def load_time_state(disc, path: str, template=None):
    """Restore a ``TimeState`` saved by :func:`save_time_state` (by either
    package) onto ``disc``'s device.

    ``template``: the ``TimeState`` whose shapes and dtypes the checkpoint
    must have; default ``initial_state(disc)``.  On a tile of a domain
    decomposition the checkpoint is tile-stacked and this rank takes its
    tile."""
    from navier_stokes_solver_tpu_torch.timeloop import initial_state

    ts = template if template is not None else initial_state(disc)
    fields = dict(u=ts.solution.u, p=ts.solution.p, time=ts.time, step=ts.step,
                  drag=ts.drag, lift=ts.lift)
    data = _read(disc, os.path.join(path, "time_state.npz"), fields)
    put = lambda k: torch.as_tensor(data[k], device=disc.device)
    return ts._replace(
        solution=Blocks(u=put("u"), p=put("p")),
        time=put("time"),
        step=put("step"),
        drag=put("drag"),
        lift=put("lift"),
    )


_STATE_KEYS = ("u", "p", "u_old", "p_old", "delta_u", "delta_p")


def _solver_arrays(solver) -> dict:
    return dict(zip(_STATE_KEYS, (*solver.solution, *solver.solution_old, *solver.delta)))


def save_checkpoint(solver, path: str) -> str:
    """Save a set-up solver's state to the directory ``path`` (under domain
    decomposition a collective of its ranks, tile-stacked)."""
    if not _write(solver.disc, path, "state.npz", _solver_arrays(solver)):
        _done(solver.disc)
        return path
    manifest = {
        "format_version": _FORMAT_VERSION,
        "variant": solver.VARIANT,
        "mesh_size": list(solver.options.mesh_size),
        "degrees": [solver.options.degree_velocity, solver.options.degree_pressure],
        "Re": solver.Re,
        "nu": solver.nu,
        "time": getattr(solver, "time", 0.0),
        "time_step_index": getattr(solver, "time_step_index", 0),
        "apply_first": getattr(solver, "apply_first", True),
        "inlet_u": None,  # the JAX package's inlet_velocity.u; the port has none
    }
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, os.path.join(path, "manifest.json"))
    _done(solver.disc)
    return path


def load_checkpoint(solver, path: str) -> dict:
    """Restore state saved by ``save_checkpoint`` (by either package) into
    a set-up solver; returns the manifest."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {manifest['format_version']}")
    if manifest["mesh_size"] != list(solver.options.mesh_size):
        raise ValueError(
            f"checkpoint mesh {manifest['mesh_size']} != solver mesh "
            f"{list(solver.options.mesh_size)}"
        )
    data = _read(solver.disc, os.path.join(path, "state.npz"), _solver_arrays(solver))
    put = lambda k: torch.as_tensor(data[k], device=solver.device)
    solver.solution = Blocks(u=put("u"), p=put("p"))
    solver.solution_old = Blocks(u=put("u_old"), p=put("p_old"))
    solver.delta = Blocks(u=put("delta_u"), p=put("delta_p"))
    solver.nu = manifest["nu"]
    if hasattr(solver, "time"):
        solver.time = manifest["time"]
        solver.time_step_index = manifest["time_step_index"]
    if hasattr(solver, "apply_first"):
        solver.apply_first = manifest["apply_first"]
    return manifest
