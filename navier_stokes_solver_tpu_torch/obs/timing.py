"""Phase timers."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["PhaseTimer"]


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
