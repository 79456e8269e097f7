#!/usr/bin/env python3
"""Time what devit_tpu_torch.tracing's spans cost the host, off and on.

    python3 scripts/span_cost.py [--n 100000] [--repeats 5]

Prints one JSON line of nanoseconds a call, the fastest of `--repeats`
loops of `--n` calls each:
- `off`: `with span(...)` where no profiler runs (the gate's null context);
- `on_cpu`, `on_cpu_nested`, `record_on_cpu`: a span, a span inside a span
  (per inner span), and `record(...)`, under torch.profiler with CPU activity;
- on a CUDA device also `on_cuda` and `device_on_cuda` (a span with its CUDA
  event pair), under CPU and CUDA activity;
- `loop_*`: the same loop with an empty body, which the figures above include.
From these, `per_batch_us` and `per_step_us` are the spans' cost on the host
of one served batch (six spans, and one queue record for each of 16 requests)
and of one training step (five spans, four with event pairs), on the
profiled clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from devit_tpu_torch import tracing  # noqa: E402


def _best(fn, n: int, repeats: int) -> float:
    """Fastest of `repeats` timings of fn(n), in ns a call."""
    out = []
    for _ in range(repeats):
        tracing.clear()
        t0 = time.perf_counter_ns()
        fn(n)
        out.append((time.perf_counter_ns() - t0) / n)
    return min(out)


def _empty(n):
    for _ in range(n):
        pass


def _span(n):
    for _ in range(n):
        with tracing.span("x"):
            pass


def _nested(n):
    with tracing.span("outer"):
        for _ in range(n):
            with tracing.span("x"):
                pass


def _device_span(n):
    for _ in range(n):
        with tracing.span("x", device=True):
            pass


def _record(n):
    t = time.perf_counter()
    for _ in range(n):
        tracing.record("x", t, t)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=100000)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    n, r = args.n, args.repeats
    out = {"n": n, "repeats": r, "torch": torch.__version__,
           "loop_off": _best(_empty, n, r), "off": _best(_span, n, r)}
    with profile(activities=[ProfilerActivity.CPU]):
        out.update(loop_cpu=_best(_empty, n, r), on_cpu=_best(_span, n, r),
                   on_cpu_nested=_best(_nested, n, r), record_on_cpu=_best(_record, n, r))
    device = torch.cuda.is_available()
    if device:
        torch.cuda.init()
        torch.zeros(1, device="cuda")
        out["device"] = torch.cuda.get_device_name(0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            out.update(loop_cuda=_best(_empty, n, r), on_cuda=_best(_span, n, r),
                       device_on_cuda=_best(_device_span, min(n, 20000), r))
        torch.cuda.synchronize()
    on = out["on_cuda"] if device else out["on_cpu"]
    dev = out["device_on_cuda"] if device else out["on_cpu"]
    out["per_batch_us"] = (6 * on + 16 * out["record_on_cpu"]) / 1e3
    out["per_step_us"] = (on + 4 * dev) / 1e3
    tracing.clear()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
