"""The benchmark's readers of the port's own spans
(benchmark/metrics/_program_spans.py and the readers built on it): the
device's idle put down to the innermost span open at each instant, the
split adding up to the idle share, and nothing reported, and nothing
raised, where the program has no tracing module or recorded no span."""

import sys
from pathlib import Path

import pytest

from benchmark import core
from benchmark.metrics import _program_spans
from benchmark.tracing import Trace
from devit_tpu_torch import tracing

ROOT = Path(__file__).resolve().parents[2]
NEW_READERS = ("batch_form_ms.batch", "copy_in_ms.batch", "launch_ms.batch",
               "queue_wait_ms.batch", "idle_in_data.batch", "idle_in_launch.batch",
               "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
               "idle_in_mix.train", "idle_in_forward.train", "idle_in_backward.train",
               "idle_in_optimizer.train")


def _span(name, start, end, thread=1, key=None):
    return tracing.Span(name=name, start=start, end=end, id=0, parent=None, key=key,
                        thread=thread)


def test_idle_is_put_down_to_the_innermost_span_open_at_each_instant():
    # the device is busy in [1, 2] and [6, 7] of [0, 10]: idle [0,1], [2,6], [7,10]
    ops = [("k1", 1.0, 2.0), ("k2", 6.0, 7.0)]
    spans = [_span("step", 0.5, 9.0), _span("step.mix", 0.5, 1.5),
             _span("step.forward", 3.0, 4.0), _span("step.backward", 4.0, 8.0),
             _span("step", 20.0, 30.0),  # outside the slice
             _span("step.mix", 2.0, 5.0, thread=2)]  # another thread's, fewer
    ctx = {"trace": Trace(lo=0.0, hi=10.0, ops=ops, spans=[])}
    kept = [s for s in spans if s.start >= 0.0 and s.end <= 10.0]
    split = _program_spans.idle_by_span([s for s in kept if s.thread == 1],
                                        [(0.0, 1.0), (2.0, 6.0), (7.0, 10.0)], 0.0, 10.0)
    want = {None: 0.5 + 1.0, "step.mix": 0.5, "step": 1.0 + 1.0,
            "step.forward": 1.0, "step.backward": 2.0 + 1.0}
    assert split.keys() == want.keys()
    for k, v in want.items():
        assert split[k] == pytest.approx(v, abs=1e-12)
    # the readers: only the phases' spans wholly inside the slice, on the
    # thread with most; the parent's own time counts as outside the phases
    import devit_tpu_torch.tracing as mod

    orig = mod.spans
    mod.spans = lambda: spans
    try:
        got = _program_spans.idle_split(ctx, _program_spans.TRAIN)
        assert got == pytest.approx({None: 3.5, "step.mix": 0.5, "step.forward": 1.0,
                                     "step.backward": 3.0})
        read = lambda name: core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read
        assert read("idle_in_backward.train")(ctx) == pytest.approx(30.0)
        assert read("idle_in_forward.train")(ctx) == pytest.approx(10.0)
        assert read("idle_in_mix.train")(ctx) == pytest.approx(5.0)
        assert read("idle_in_optimizer.train")(ctx) == 0.0
        # every thread's spans inside the slice: 1 s and 3 s
        assert _program_spans.mean_ms(ctx, "step.mix") == pytest.approx(2000.0)
        assert _program_spans.mean_device_ms(ctx, "step.mix") is None
    finally:
        mod.spans = orig


def test_the_serving_idle_split_adds_up_to_the_idle_share():
    ops = [("k", 0.2, 0.3), ("k", 0.5, 0.9)]
    spans = [_span("batcher.batch", 0.0, 0.95), _span("batcher.form", 0.0, 0.1),
             _span("engine.copy_in", 0.12, 0.25), _span("engine.forward", 0.25, 0.6),
             _span("engine.copy_out", 0.6, 0.9), _span("batcher.deliver", 0.9, 0.95),
             _span("batcher.queue", 0.0, 0.1)]
    ctx = {"trace": Trace(lo=0.0, hi=1.0, ops=ops, spans=[])}
    import devit_tpu_torch.tracing as mod

    orig = mod.spans
    mod.spans = lambda: spans
    try:
        read = lambda name: core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read
        data, launch = read("idle_in_data.batch")(ctx), read("idle_in_launch.batch")(ctx)
        idle = read("idle_share.batch")(ctx)
        queued = read("queue_wait_ms.batch")(ctx)
        split = _program_spans.idle_split(ctx, _program_spans.SERVE)
    finally:
        mod.spans = orig
    # idle: [0, 0.2] form, the batch's own time, copy_in; [0.3, 0.5] forward;
    # [0.9, 1.0] deliver, then no span
    assert queued == pytest.approx(100.0)  # the one request's wait, 0.1 s
    assert data == pytest.approx(100 * (0.1 + 0.08 + 0.05))
    assert launch == pytest.approx(100 * 0.2)
    assert split[None] == pytest.approx(0.02 + 0.05)
    assert data + launch + 100 * split[None] == pytest.approx(idle)


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_reader_reports_nothing_without_the_tracing_module(name, monkeypatch):
    ctx = {"trace": Trace(lo=0.0, hi=1.0, ops=[("k", 0.2, 0.3)], spans=[])}
    monkeypatch.setitem(sys.modules, "devit_tpu_torch.tracing", None)  # import fails
    assert core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read(ctx) is None


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_reader_reports_nothing_where_no_span_was_recorded(name):
    ctx = {"trace": Trace(lo=0.0, hi=1.0, ops=[("k", 0.2, 0.3)], spans=[])}
    assert core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py").read(ctx) is None
