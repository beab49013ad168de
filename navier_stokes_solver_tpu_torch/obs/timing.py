"""Phase timers and the profiler trace helper."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["PhaseTimer", "trace_to", "TRACE_FILE"]

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Accumulates wall-clock per named phase (setup / assemble / solve ...);
    the structured replacement for the reference's external ``date +%s.%N``
    timing (run_sim_steady.sh:20-27).

    PyTorch returns before a CUDA device finishes, so on a CUDA ``device``
    every phase ends with ``torch.cuda.synchronize()``: the time of a phase
    includes the device work it enqueued.
    """

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"seconds": self.totals[name], "calls": self.counts[name]}
            for name in sorted(self.totals)
        }


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a ``torch.profiler`` trace of the block -- host (CPU)
    activity, and the card's kernels and copies when CUDA is available --
    and write it as a Chrome trace (viewable in Perfetto) to
    ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
