"""Batched Reynolds sweeps of the fused unsteady step (the JAX package's
``ensemble/sweep.py``), on the structured lattice or the ``-M`` simplex
disc, under every solver and preconditioner of the step (GMRES-IR cycles
and the direct LU included)."""

from __future__ import annotations

import torch

from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.timeloop import TimeState, initial_state, make_batched_time_step
from navier_stokes_solver_tpu_torch.timeloop.fused import _map_state
from navier_stokes_solver_tpu_torch.unstructured.tri import SimplexDisc

__all__ = ["make_ensemble_step", "initial_ensemble_state", "run_sweep"]


def make_ensemble_step(disc: Disc | SimplexDisc, **step_kwargs):
    """Batched step ``step(state, nus, dt)``: the state has a leading member
    axis, ``nus`` is [B] (``timeloop.make_batched_time_step``)."""
    return make_batched_time_step(disc, **step_kwargs)


def initial_ensemble_state(disc: Disc | SimplexDisc, batch: int) -> TimeState:
    """``timeloop.initial_state`` broadcast over ``batch`` members."""
    return initial_state(disc, batch)


def as_viscosities(disc: Disc | SimplexDisc, nus) -> torch.Tensor:
    """``nus`` as the [B] tensor the batched step takes: the disc's dtype,
    on its device (the JAX package's ``jnp.asarray(nus, disc.dtype)``)."""
    nus = torch.as_tensor(nus, dtype=torch.float64).to(device=disc.device, dtype=disc.dtype)
    if nus.dim() != 1 or nus.shape[0] < 1:
        raise ValueError(f"nus must be a non-empty 1-D sequence, got shape {tuple(nus.shape)}")
    return nus.contiguous()


def run_sweep(disc: Disc | SimplexDisc, nus, dt, n_steps: int, mesh=None, **step_kwargs):
    """Run B simultaneous unsteady simulations (one per viscosity) for
    ``n_steps`` steps from rest.

    Returns the final batched state and per-step [T, B] tensors on the
    disc's device: ``drag`` and ``lift`` (the JAX package's two) and, beyond
    them, ``newton_iters``, ``krylov_iters`` and ``final_residual``.

    ``mesh``: a ``dist.make_mesh`` mesh with an ``'ens'`` axis (the JAX
    package's member sharding; the reference runs one job per parameter,
    run_sim_steady.sh): each ``ens`` rank steps its contiguous slice of the
    members (B must divide by ``n_ens``), then the final state and the
    [T, B] rows are all-gathered, so every rank returns the whole sweep.
    The batched step masks each member's loops on its own, so a member's
    result does not depend on the members that share its rank.
    """
    nus = as_viscosities(disc, nus)
    sharded = mesh is not None and mesh.n_ens > 1
    if sharded:
        if nus.shape[0] % mesh.n_ens:
            raise ValueError(f"{nus.shape[0]} members do not split over {mesh.n_ens} ens ranks")
        b = nus.shape[0] // mesh.n_ens
        nus = nus[mesh.ie * b: (mesh.ie + 1) * b]
    step = make_ensemble_step(disc, **step_kwargs)
    ts = initial_ensemble_state(disc, nus.shape[0])
    rows = []
    for _ in range(n_steps):
        ts = step(ts, nus, dt)
        rows.append((ts.drag, ts.lift, *ts.stats))
    cols = zip(*rows) if rows else [[leaf] for leaf in (ts.drag, ts.lift, *ts.stats)]
    hist = {k: torch.stack(list(v))[: len(rows)] for k, v in zip(_HISTORY, cols)}
    if sharded:
        gather = lambda t, dim: torch.cat(mesh.all_gather(t, group=mesh.ens_group), dim=dim)
        ts = _map_state(lambda t: gather(t, 0), ts)
        hist = {k: gather(v, 1) for k, v in hist.items()}
    return ts, hist


_HISTORY = ("drag", "lift", "newton_iters", "krylov_iters", "final_residual")
