"""Open-loop serving: requests arrive on a Poisson schedule at the fixed
rate `rate_img_s` (images a second), whatever the server does, and each
latency is timed from the request's due time to its answer. Every seed
sends the same set of request sizes and gaps, in its own order: a share
`single_share` of the requests carry one image, the rest `min_images` to
`max_images`, uniform; the gaps are the exponential distribution's
quantiles. The end-to-end metric is the 95th percentile of the latencies of
every request due in the window; a request that fails or never comes
counts as missing any limit."""

from __future__ import annotations

import gc
import math
import threading
import time

import numpy as np

from benchmark import core, weights
from benchmark.drivers import _serving
from benchmark.tracing import Profiler


def schedule(traffic: dict, seconds: float, seed: int):
    """(sizes, due offsets in seconds) of one window."""
    lo, hi, single = traffic["min_images"], traffic["max_images"], traffic["single_share"]
    mean = single + (1.0 - single) * (lo + hi) / 2.0
    count = max(1, int(round(traffic["rate_img_s"] * seconds / mean)))
    ones = int(round(single * count))
    sizes = np.array([1] * ones + [lo + j % (hi - lo + 1) for j in range(count - ones)])
    gaps = -np.log1p(-(np.arange(count) + 0.5) / count)
    rng = np.random.default_rng(weights.sub_seed(seed, "traffic"))
    sizes, gaps = rng.permutation(sizes), rng.permutation(gaps)
    # the gaps scaled to span the window
    gaps *= seconds / gaps.sum()
    return sizes, np.cumsum(gaps) - gaps[0]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def drive(cell: core.Cell, served: "_serving.Served", spans: core.Spans) -> dict:
    """One window of the cell's schedule against a built server: every
    request's (offset, rows, due, answered, logits), the lateness of the
    sender, the batcher's counters at both ends, and the trace."""
    tr = cell.traffic
    batcher, pool = served.batcher, served.pool
    sizes, due = schedule(tr, cell.seconds, cell.seed)
    rng = np.random.default_rng([weights.sub_seed(cell.seed, "traffic"), 1])
    offsets = [int(rng.integers(0, len(pool) - n + 1)) for n in sizes]
    answered = [math.inf] * len(sizes)
    futures = [None] * len(sizes)
    late = [0.0] * len(sizes)

    def stamp(i):
        def done(_):
            answered[i] = time.perf_counter()
        return done

    def send(t0: float) -> None:
        for i, (n, off) in enumerate(zip(sizes, offsets)):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - (t0 + due[i])
            futures[i] = batcher.submit(pool[off:off + int(n)])
            futures[i].add_done_callback(stamp(i))

    snap0 = batcher.snapshot()
    t0 = time.perf_counter()
    sender = threading.Thread(target=send, args=(t0,), daemon=True)
    sender.start()
    prof, trace = None, None
    untraced, slice_s = core.trace_plan(cell.seconds, cell.trace, tr["trace_s"])
    time.sleep(max(0.0, t0 + untraced - time.perf_counter()))
    if cell.trace:
        prof = Profiler()
        prof.start()
        time.sleep(max(0.0, prof.started + slice_s - time.perf_counter()))
    else:
        time.sleep(max(0.0, t0 + cell.seconds - time.perf_counter()))
    t1 = time.perf_counter()
    snap1 = batcher.snapshot()
    if prof is not None:
        trace = prof.stop(spans.items)
    sender.join(timeout=120)
    deadline = time.perf_counter() + 60.0  # a minute past the close for the stragglers
    outs = []
    for f in futures:
        try:
            outs.append(f.result(timeout=max(0.0, deadline - time.perf_counter())))
        except Exception as e:  # noqa: BLE001 - a failed or missing answer is counted
            cell.log(f"request failed or never answered: {e!r}")
            outs.append(None)
    requests = [(off, int(n), t0 + d, a, o)
                for off, n, d, a, o in zip(offsets, sizes, due, answered, outs)]
    return {"requests": requests, "late": late, "t0": t0, "t1": t1, "snaps": (snap0, snap1),
            "trace": trace}


def latencies_ms(requests) -> list:
    """Due to answer, infinite for a request that failed or never came."""
    return [(a - d) * 1e3 if o is not None else math.inf for _, _, d, a, o in requests]


def run(cell: core.Cell) -> core.Outcome:
    spans = core.Spans()
    served = _serving.build(cell, spans)
    w = drive(cell, served, spans)
    reqs, t0, t1 = w["requests"], w["t0"], w["t1"]
    peak = _serving.peak_bytes(cell.device)
    lat_ms = latencies_ms(reqs)
    images = sum(r[1] for r in reqs if r[3] <= t1)
    a, b = w["snaps"]
    per_batch = (b["images"] - a["images"]) / max(1, b["batches"] - a["batches"])
    cell.log(f"{len(reqs)} requests, {sum(r[1] for r in reqs)} images offered; sender late by "
             f"{max(w['late']) * 1e3:.3f} ms at most, {percentile(w['late'], 50) * 1e3:.3f} ms "
             f"median; latency p50 {percentile(lat_ms, 50):.3f} ms; {per_batch:.1f} images a "
             "batch")
    ctx = _serving.context(cell, served, t0, t1, *w["snaps"], images, w["trace"])
    pool = served.pool
    _serving.release(served)
    del served
    gc.collect()
    numbers = _serving.check(cell, _serving.sample(reqs, cell.traffic["sample_requests"],
                                                   cell.seed), pool)
    return core.Outcome(e2e={"serve_p95_ms": percentile(lat_ms, 95)}, window_start=t0,
                        attempted=len(reqs), failed=sum(r[4] is None for r in reqs),
                        memory_peak_bytes=peak, numbers=numbers, ctx=ctx)
