"""Observability: phase timers (device-synchronized on CUDA) and the
profiler trace of a solve."""

from navier_stokes_solver_tpu_torch.obs.timing import TRACE_FILE, PhaseTimer, trace_to

__all__ = ["PhaseTimer", "trace_to", "TRACE_FILE"]
