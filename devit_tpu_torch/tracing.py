"""Named host spans inside the port, recorded only while a torch profiler
runs.

    from devit_tpu_torch import tracing

    with tracing.span("engine.copy_in"):
        ...
    with tracing.span("step.backward", device=True):  # also a CUDA event pair
        ...

With no profiler running, `span` returns one shared null context: the cost
is one attribute read and an empty `with` (scripts/span_cost.py times it). While one runs (torch.profiler.profile, which
`utils_profile.trace`, `fit(profile_dir=...)` and a benchmark's traced slice
start), a span records its name, its start and end on `time.perf_counter`,
its id and its parent's (a stack per thread), a `key` tying the spans of one
batch or step together (inherited from the parent where not given), and the
thread; it also opens a profiler range of the same name, so the
profiler's own trace shows the span among the operators. The range is a
function-scope RecordFunction (`torch._C._profiler._RecordFunctionFast`),
not `torch.profiler.record_function`'s user scope: under CUDA activity the
profiler mirrors each user-scope range onto the device timeline as a
`gpu_user_annotation` event spanning the kernels it launched, which a
reader of device time would count as a busy device. `device=True` adds a
timed `torch.cuda.Event` pair on the current stream at entry and exit, once
CUDA is in use.

Finished spans go into a bounded in-memory buffer: `spans()` reads them
back with each event pair's device milliseconds, `clear()` empties it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import List, Optional

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65536  # finished spans kept; the oldest go first

_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_done: deque = deque(maxlen=CAPACITY)
_local = threading.local()


@dataclasses.dataclass
class Span:
    """One finished span; times in seconds on perf_counter's clock.
    device_ms: the CUDA time between the span's entry and exit events
    (None without events, or while they are not done)."""

    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    key: Optional[int]
    thread: int
    device_ms: Optional[float] = None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "key", "device", "id", "parent", "start", "events", "rf")

    def __init__(self, name: str, key: Optional[int], device: bool):
        self.name, self.key, self.device = name, key, device

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.key is None and parent is not None:
            self.key = parent.key
        self.id = next(_ids)
        stack.append(self)
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.events = None
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.start = time.perf_counter()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        end = time.perf_counter()
        self.rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _done.append((self.name, self.start, end, self.id, self.parent, self.key,
                      threading.get_ident(), self.events))
        return False


def span(name: str, *, key: Optional[int] = None, device: bool = False):
    """A context manager that records the block as span `name` while a
    torch profiler runs, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, key, device)


def record(name: str, start: float, end: float, *, key: Optional[int] = None) -> None:
    """Record a span measured elsewhere (perf_counter stamps), with no
    parent: e.g. a request's wait in a queue, stamped on another thread."""
    if _profiler._is_profiler_enabled:
        _done.append((name, start, end, next(_ids), None, key, threading.get_ident(), None))


def _device_ms(events) -> Optional[float]:
    if events is None or not events[1].query():
        return None
    return events[0].elapsed_time(events[1])


def spans() -> List[Span]:
    """The finished spans in the order they ended."""
    return [Span(name, start, end, sid, parent, key, thread, _device_ms(events))
            for name, start, end, sid, parent, key, thread, events in list(_done)]


def clear() -> None:
    _done.clear()
