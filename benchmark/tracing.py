"""The traced slice at the end of a `--trace 1` window: torch.profiler
(CUPTI) over CPU and CUDA activity, turned into the device operations'
intervals, the benchmark's host spans on the same clock, and the
`breakdown` of the result line.

The profiler's clock is tied to perf_counter by a marker span recorded
right after the profiler starts and another right before it stops; they
also bound the slice.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.metrics import _kernels

_START, _STOP = "benchmark.trace_start", "benchmark.trace_stop"


@dataclasses.dataclass
class Trace:
    """One traced slice, every time in seconds on perf_counter's clock."""

    lo: float
    hi: float
    ops: List[Tuple[str, float, float]]  # device operations: (name, start, end)
    spans: List[Tuple[str, float, float]]  # the benchmark's host spans inside [lo, hi]

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return _kernels.busy(((s, e) for _, s, e in self.ops), self.lo, self.hi)

    def ops_in(self, lo: float, hi: float, kind: Optional[str] = None):
        """Device operations that start inside [lo, hi], of one kind."""
        return [(n, s, e) for n, s, e in self.ops
                if lo <= s < hi and (kind is None or _kernels.kind(n) == kind)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the innermost host span running when each gap began."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            if self.lo <= s < self.hi:
                by_name[name[:160]] += e - s
        idle: Dict[str, float] = defaultdict(float)
        for s, e in _kernels.gaps(((a, b) for _, a, b in self.ops), self.lo, self.hi):
            inside = [sp for sp in self.spans if sp[1] <= s < sp[2]]
            label = max(inside, key=lambda sp: sp[1])[0] if inside else "outside spans"
            idle[label] += e - s
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}


class Profiler:
    """Start with start(), stop with stop(host_spans) -> Trace."""

    def __init__(self):
        self._prof = None
        self.started = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self.started = time.perf_counter()
        with record_function(_START):
            pass

    def stop(self, spans: List[Tuple[str, float, float]]) -> Trace:
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import record_function

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t_stop = time.perf_counter()
        with record_function(_STOP):
            pass
        self._prof.stop()
        events = self._prof.events()
        marks = {e.name: e.time_range.start for e in events if e.name in (_START, _STOP)}
        if set(marks) != {_START, _STOP}:
            raise RuntimeError("the profiler recorded no marker span")
        # profiler microseconds -> perf_counter seconds
        offset = self.started - marks[_START] * 1e-6
        ops = [(e.name, e.time_range.start * 1e-6 + offset, e.time_range.end * 1e-6 + offset)
               for e in events if e.device_type == DeviceType.CUDA]
        lo, hi = self.started, t_stop
        return Trace(lo=lo, hi=hi, ops=ops,
                     spans=[sp for sp in spans if sp[2] > lo and sp[1] < hi])
