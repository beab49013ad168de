"""Batched Reynolds sweeps of the fused unsteady step (the JAX package's
``ensemble/sweep.py``), on the structured lattice or the ``-M`` simplex
disc, under every solver and preconditioner of the step (GMRES-IR cycles
and the direct LU included)."""

from __future__ import annotations

import torch

from navier_stokes_solver_tpu_torch.ops.disc import Disc
from navier_stokes_solver_tpu_torch.timeloop import TimeState, initial_state, make_batched_time_step
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
    ``mesh`` (sharding the members over devices, the JAX package's ``'ens'``
    axis) is not ported.
    """
    if mesh is not None:
        raise NotImplementedError(
            "sharding the ensemble's members over a device mesh (the 'ens' axis) "
            "is not ported (ROADMAP.md A.D9)"
        )
    nus = as_viscosities(disc, nus)
    step = make_ensemble_step(disc, **step_kwargs)
    ts = initial_ensemble_state(disc, nus.shape[0])
    rows = []
    for _ in range(n_steps):
        ts = step(ts, nus, dt)
        rows.append((ts.drag, ts.lift, *ts.stats))
    cols = zip(*rows) if rows else [[leaf] for leaf in (ts.drag, ts.lift, *ts.stats)]
    hist = {k: torch.stack(list(v))[: len(rows)] for k, v in zip(_HISTORY, cols)}
    return ts, hist


_HISTORY = ("drag", "lift", "newton_iters", "krylov_iters", "final_residual")
