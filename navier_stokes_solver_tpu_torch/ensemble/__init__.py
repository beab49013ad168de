"""Ensemble (Reynolds-sweep) batching: B unsteady runs advanced together.

The reference runs parameter sweeps as separate jobs (run_sim_steady.sh);
the JAX package batches B simulations with ``vmap`` over its fused time step
(BASELINE.json config 5).  The port advances B members, one viscosity each,
through one batched step (``timeloop.make_batched_time_step``): every
launch serves all members, the one-launch ``apply_F`` included.
"""

from navier_stokes_solver_tpu_torch.ensemble.sweep import (
    initial_ensemble_state,
    make_ensemble_step,
    run_sweep,
)

__all__ = ["make_ensemble_step", "initial_ensemble_state", "run_sweep"]
