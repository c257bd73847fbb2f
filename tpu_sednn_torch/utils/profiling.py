"""Profiling hooks — counterpart of tpu_sednn/utils/profiling.py: replaces the
reference's single wall-clock counter ("Total cost time") with a
torch.profiler trace and first-class throughput accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace of the block (CPU activity, and CUDA
    activity where a card is present) and write it as a Chrome/Perfetto trace
    `trace.json` under log_dir; no-op when log_dir is not set.  The tracer
    can lose records of a long run: take kernel times from CUDA events."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Steady-state step timing with warm-up exclusion.

    Kernels run asynchronously to the host: callers time work that ends in
    torch.cuda.synchronize() (or a host read of the step's output) before
    rate()."""

    def __init__(self, warmup_steps: int = 1):
        self.warmup_steps = warmup_steps
        self._count = 0
        self._t0: Optional[float] = None

    def step(self) -> None:
        self._count += 1
        if self._count == self.warmup_steps:
            self._t0 = time.perf_counter()

    @property
    def measured_steps(self) -> int:
        return max(0, self._count - self.warmup_steps)

    def rate(self) -> float:
        if self._t0 is None or self.measured_steps == 0:
            return 0.0
        return self.measured_steps / (time.perf_counter() - self._t0)
