"""Profiling hooks (counterpart of devit_tpu/utils_profile.py): a
torch.profiler trace, a wall-clock step timer, and the card's memory
counters.

    with trace("/tmp/devit-trace"):
        run_steps()
    # -> a Chrome trace (*.pt.trace.json) in the directory; open it in
    #    Perfetto or chrome://tracing

    timer = StepTimer()
    for batch in ...:
        with timer:
            step(...)
    print(timer.summary())
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the block, CPU and (where a card is present) CUDA
    activity, written as a Chrome trace into `logdir`. No fallback: a
    profiler that fails to start or to write raises."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"devit.{os.getpid()}.pt.trace.json"))


class StepTimer:
    """Wall-clock step timer with a percentile summary (the analogue of
    MetricLogger's iter/data times, dist_utils.py:114-158). Time device work
    by synchronizing inside the block."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> str:
        if not self.times:
            return "no steps timed"
        a = np.asarray(self.times[1:] or self.times)  # drop the first (warm-up) step
        return (f"steps={len(self.times)} mean={a.mean() * 1e3:.1f}ms "
                f"p50={np.percentile(a, 50) * 1e3:.1f}ms p95={np.percentile(a, 95) * 1e3:.1f}ms")


def device_memory_stats() -> Optional[dict]:
    """Live and peak bytes of the CUDA caching allocator on the current
    card (torch.cuda.memory_stats), under the JAX package's names; None
    without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
