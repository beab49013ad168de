"""The fused implicit-Euler time loop (the JAX package's performance path):
Newton at the target viscosity, warm-started from the previous step, with
lift and drag on every step's final state."""

from navier_stokes_solver_tpu_torch.timeloop.fused import (
    StepStats,
    TimeState,
    initial_state,
    make_batched_time_step,
    make_stokes_init,
    make_time_step,
    run_time_loop,
)

__all__ = [
    "TimeState",
    "StepStats",
    "initial_state",
    "make_time_step",
    "make_batched_time_step",
    "make_stokes_init",
    "run_time_loop",
]
