"""Observability: phase timers (device-synchronized on CUDA)."""

from navier_stokes_solver_tpu_torch.obs.timing import PhaseTimer

__all__ = ["PhaseTimer"]
