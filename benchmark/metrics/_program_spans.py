"""The program's own spans (devit_tpu_torch/tracing.py, recorded while the
traced slice's profiler runs) that lie wholly inside the slice, and the
slice's device idle time put down to them.

Idle attribution: each instant of a device idle gap goes to the innermost
span open at that instant among one family of spans (the phases the
program records on one thread: not their parent batcher.batch or step, nor
a request's queue wait), on the thread that recorded most of them; an
instant where none is open is outside the phases. A gap is split wherever a
span begins or ends inside it. So a cell's idle_in_* shares and the share
outside the phases add up to its idle_share.

Every reader returns None, and raises nothing, where the program has no
tracing module or recorded no span of the kind it reads."""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark.metrics import _kernels

# the phases the serving batcher thread and a training step record
SERVE = ("batcher.form", "engine.copy_in", "engine.forward", "engine.copy_out",
         "batcher.deliver")
TRAIN = ("step.mix", "step.forward", "step.backward", "step.optimizer")


def inside(ctx) -> list:
    """The program's spans lying wholly inside the traced slice."""
    tr = ctx.get("trace")
    if tr is None:
        return []
    try:
        from devit_tpu_torch import tracing
    except ImportError:
        return []
    return [s for s in tracing.spans() if tr.lo <= s.start and s.end <= tr.hi]


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean host length of the slice's spans `name`, in ms."""
    got = [s.end - s.start for s in inside(ctx) if s.name == name]
    return 1e3 * sum(got) / len(got) if got else None


def mean_device_ms(ctx, name: str) -> Optional[float]:
    """Mean device time between the entry and exit events of the slice's
    spans `name`, in ms."""
    got = [s.device_ms for s in inside(ctx) if s.name == name and s.device_ms is not None]
    return sum(got) / len(got) if got else None


def idle_by_span(spans, gaps: Iterable[Tuple[float, float]], lo: float,
                 hi: float) -> Dict[Optional[str], float]:
    """{name of the innermost open span, or None outside every span: idle
    seconds} over `gaps` (sorted, disjoint, inside [lo, hi]). `spans` nest,
    as one thread's spans do."""
    bounds = sorted({lo, hi} | {t for s in spans for t in (s.start, s.end) if lo < t < hi})
    labels: List[Optional[str]] = []
    for a, b in zip(bounds, bounds[1:]):
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s.start <= mid < s.end]
        # the innermost began last (and, of two that began together, ends first)
        labels.append(max(open_, key=lambda s: (s.start, -s.end)).name if open_ else None)
    out: Dict[Optional[str], float] = defaultdict(float)
    i = 0
    for gs, ge in gaps:
        while i < len(labels) and bounds[i + 1] <= gs:
            i += 1
        j = i
        while j < len(labels) and bounds[j] < ge:
            overlap = min(ge, bounds[j + 1]) - max(gs, bounds[j])
            if overlap > 0:
                out[labels[j]] += overlap
            j += 1
    return dict(out)


def idle_split(ctx, family) -> Optional[Dict[Optional[str], float]]:
    """The slice's idle seconds by innermost span of `family`; None where
    the slice has no device operation or no span of the family."""
    tr = ctx.get("trace")
    spans = [s for s in inside(ctx) if s.name in family]
    if tr is None or not tr.ops or not spans or tr.window_s <= 0:
        return None
    thread = Counter(s.thread for s in spans).most_common(1)[0][0]
    spans = [s for s in spans if s.thread == thread]
    gaps = _kernels.gaps(((a, b) for _, a, b in tr.ops), tr.lo, tr.hi)
    return idle_by_span(spans, gaps, tr.lo, tr.hi)


def idle_share_in(ctx, family, names) -> Optional[float]:
    """Percent of the slice the device idled while the innermost span of
    `family` open on the host was one of `names`."""
    split = idle_split(ctx, family)
    if split is None:
        return None
    return 100.0 * sum(v for k, v in split.items() if k in names) / ctx["trace"].window_s
