"""Closed-loop serving: `clients` clients, each sending a request of
`images_per_request` images from the seeded pool into the batcher and
sending its next one the moment the answer comes (from the answer's
callback, so the load needs no thread of its own). The end-to-end metric is
the images answered inside the window over its length."""

from __future__ import annotations

import gc
import threading
import time

import numpy as np

from benchmark import core, weights
from benchmark.drivers import _serving
from benchmark.tracing import Profiler


def run(cell: core.Cell) -> core.Outcome:
    tr = cell.traffic
    spans = core.Spans()
    served = _serving.build(cell, spans)
    batcher, pool, n = served.batcher, served.pool, tr["images_per_request"]
    stop = threading.Event()
    idle = threading.Condition()
    out_of_loop = [0]  # clients whose last answer came after the stop
    records = []  # (offset, rows, sent, answered, logits)
    rngs = [np.random.default_rng([weights.sub_seed(cell.seed, "traffic"), i])
            for i in range(tr["clients"])]

    def send(i: int) -> None:
        off = int(rngs[i].integers(0, len(pool) - n + 1))
        sent = time.perf_counter()
        batcher.submit(pool[off:off + n]).add_done_callback(
            lambda fut: answered(i, off, sent, fut))

    def answered(i: int, off: int, sent: float, fut) -> None:
        now = time.perf_counter()
        try:
            logits = fut.result()
        except Exception as e:  # a failed request is counted, not raised
            cell.log(f"client {i}: request failed: {e!r}")
            logits = None
        records.append((off, n, sent, now, logits))
        if not stop.is_set():
            send(i)
        else:
            with idle:
                out_of_loop[0] += 1
                idle.notify_all()

    snap0 = batcher.snapshot()
    t0 = time.perf_counter()
    for i in range(tr["clients"]):
        send(i)
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
    stop.set()
    if prof is not None:
        trace = prof.stop(spans.items)
    with idle:
        idle.wait_for(lambda: out_of_loop[0] == tr["clients"], timeout=180)
    stuck = tr["clients"] - out_of_loop[0]
    peak = _serving.peak_bytes(cell.device)

    requests = list(records)
    in_window = [r for r in requests if r[2] <= t1]
    images = sum(r[1] for r in in_window if r[3] <= t1 and r[4] is not None)
    failed = sum(r[4] is None for r in in_window) + stuck
    ctx = _serving.context(cell, served, t0, t1, snap0, snap1, images, trace)
    _serving.release(served)
    del served, batcher
    gc.collect()
    numbers = _serving.check(cell, _serving.sample(requests, tr["sample_requests"], cell.seed),
                             pool)
    return core.Outcome(e2e={"serve_img_per_s": images / (t1 - t0)}, window_start=t0,
                        attempted=len(in_window), failed=failed, memory_peak_bytes=peak,
                        numbers=numbers, ctx=ctx)
