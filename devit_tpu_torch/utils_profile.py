"""Profiling hooks (counterpart of devit_tpu/utils_profile.py): a
torch.profiler trace and the card's memory counters.

    with trace("/tmp/devit-trace"):
        run_steps()
    # -> a Chrome trace (*.pt.trace.json) in the directory; open it in
    #    Perfetto or chrome://tracing

While the trace runs, the port's own spans (devit_tpu_torch/tracing.py:
the batcher's and engine's phases, a training step's mix, forward,
backward and optimizer) record and show in it by name.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

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


def device_memory_stats() -> Optional[dict]:
    """Live and peak bytes of the CUDA caching allocator on the current
    card (torch.cuda.memory_stats), under the JAX package's names; None
    without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
