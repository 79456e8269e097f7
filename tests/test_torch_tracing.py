"""The port's span recorder (devit_tpu_torch/tracing.py), the spans the
batcher, the engine and the training steps record, and MicroBatcher's
latency and queue-wait percentiles. The benchmark's readers of the spans
are tested in benchmark/tests/test_portbench_program_spans.py."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import profile

from devit_tpu_torch import tracing
from devit_tpu_torch.data.mixup import MixupConfig
from devit_tpu_torch.io.bridge import vit_to_jax_params
from devit_tpu_torch.models.compact_vit import compact_vit_ragged
from devit_tpu_torch.models.ensemble import EnsMLP
from devit_tpu_torch.models.vit import Gates, create_vit
from devit_tpu_torch.serving.daemon import (InferenceEngine, MicroBatcher, ServeConfig,
                                            nearest_rank)
from devit_tpu_torch.train.optim import OptimConfig, make_optimizer
from devit_tpu_torch.train.state import TrainState
from devit_tpu_torch.train.steps import make_stage2_step

IMG = 32
TOY = dict(img_size=IMG, patch_size=8, embed_dim=32, depth=2, num_heads=2, num_classes=5)


@pytest.fixture(autouse=True)
def _fresh():
    tracing.clear()
    yield
    tracing.clear()


class _FakeEvent:
    """torch.cuda.Event's surface, on the host clock, counting creations."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


# ------------------------------------------------------------- the recorder


def test_no_profiler_records_no_span_and_makes_no_event(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    assert tracing.span("a") is tracing.span("b", key=1, device=True)
    with tracing.span("outer", key=3, device=True):
        with tracing.span("inner", device=True):
            pass
    tracing.record("batcher.queue", 0.0, 1.0, key=1)
    assert tracing.spans() == [] and _FakeEvent.made == 0


def test_the_gate_reads_the_flag_torch_sets_while_a_profiler_runs():
    from torch.autograd import profiler

    null = tracing.span("off")
    assert profiler._is_profiler_enabled is False
    with profile():
        assert profiler._is_profiler_enabled is True and tracing.span("on") is not null
    assert profiler._is_profiler_enabled is False and tracing.span("off") is null
    prof = profile()  # started and stopped by hand, as a benchmark's traced slice is
    prof.start()
    try:
        assert tracing.span("on") is not null
    finally:
        prof.stop()
    assert tracing.span("off") is null


def test_spans_nest_on_the_perf_counter_clock_and_name_profiler_events():
    with profile() as prof:
        t0 = time.perf_counter()
        with tracing.span("outer", key=7):
            with tracing.span("inner.a"):
                time.sleep(0.002)
            with tracing.span("inner.b", key=9):
                pass
        t1 = time.perf_counter()
    got = {s.name: s for s in tracing.spans()}
    assert [s.name for s in tracing.spans()] == ["inner.a", "inner.b", "outer"]
    outer, a, b = got["outer"], got["inner.a"], got["inner.b"]
    assert outer.parent is None and a.parent == outer.id and b.parent == outer.id
    assert len({outer.id, a.id, b.id}) == 3
    assert (outer.key, a.key, b.key) == (7, 7, 9)  # a key is inherited where not given
    assert {s.thread for s in got.values()} == {threading.get_ident()}
    assert t0 <= outer.start <= a.start <= a.end <= b.start <= b.end <= outer.end <= t1
    assert a.end - a.start >= 0.002
    assert all(s.device_ms is None for s in got.values())  # no events asked for
    names = {e.name for e in prof.events()}
    assert {"outer", "inner.a", "inner.b"} <= names


def test_spans_of_other_threads_keep_their_own_stack():
    def worker():
        with tracing.span("worker"):
            pass

    with profile():
        with tracing.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    got = {s.name: s for s in tracing.spans()}
    assert got["worker"].parent is None and got["worker"].thread != got["main"].thread


def test_spans_from_many_threads_at_once_are_all_recorded_with_their_parents():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for j in range(50):
                with tracing.span("outer", key=i):
                    with tracing.span("inner"):
                        pass

        with profile():
            threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = tracing.spans()
    assert len(spans) == 16 * 50 * 2 and len({s.id for s in spans}) == len(spans)
    outer = {s.id: s for s in spans if s.name == "outer"}
    for s in spans:
        if s.name == "inner":
            p = outer[s.parent]
            assert (p.thread, p.key) == (s.thread, s.key) and p.start <= s.start <= s.end <= p.end


def test_device_spans_time_an_event_pair(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    with profile():
        with tracing.span("dev", device=True):
            time.sleep(0.003)
        with tracing.span("host"):
            pass
        tracing.record("late", 1.0, 2.0, key=4)
    got = {s.name: s for s in tracing.spans()}
    assert _FakeEvent.made == 2
    assert got["dev"].device_ms >= 3.0 and got["host"].device_ms is None
    assert (got["late"].start, got["late"].end, got["late"].key, got["late"].parent) == (
        1.0, 2.0, 4, None)


# ------------------------------------------------------- spans in the program


@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    cms = []
    for d in range(2):
        model = create_vit("dedeit", generator=torch.Generator().manual_seed(d), device="cpu",
                           **TOY)
        params = vit_to_jax_params(model)
        gates = Gates(head=np.ones((2, 2), np.float32), neuron=np.ones((2, 128), np.float32))
        cms.append(compact_vit_ragged(params, gates, model.cfg, neuron_multiple=8,
                                      device="cpu"))
    ens = EnsMLP(num_classes=5, sub_size=32, num_divisions=2, teacher_size=24, family="deit",
                 dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(9))
    cfg = ServeConfig(input_size=IMG, patch_size=8, buckets=(2, 4), max_wait_ms=5.0,
                      dtype=torch.float32, fast_math=False)
    return InferenceEngine(cms, ens, cfg, device="cpu")


def _imgs(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


def test_a_batch_records_its_phases_in_order_under_one_key(engine):
    b = MicroBatcher(engine)  # not started: the three requests form one batch
    with profile():
        futs = [b.submit(_imgs(1, s)) for s in range(3)]
        b.start()
        for f in futs:
            f.result(timeout=60)
        b.submit(_imgs(2, 5)).result(timeout=60)  # a second batch
        b.stop()
    spans = tracing.spans()
    phases = ("batcher.form", "engine.copy_in", "engine.forward", "engine.copy_out",
              "batcher.deliver")
    batches = [s for s in spans if s.name == "batcher.batch"]
    assert [s.key for s in batches] == [1, 2]
    for batch in batches:
        mine = sorted((s for s in spans if s.key == batch.key and s.name != "batcher.queue"
                       and s is not batch), key=lambda s: s.start)
        # 3 images: one bucket of 4 rows; batch 2: one bucket of 2
        assert tuple(s.name for s in mine) == phases
        assert all(batch.start <= s.start <= s.end <= batch.end for s in mine)
        assert all(s.thread == batch.thread for s in mine)
        assert all(a.end <= b_.start for a, b_ in zip(mine, mine[1:]))
        assert {s.parent for s in mine} == {batch.id}
    queued = [s for s in spans if s.name == "batcher.queue"]
    assert sorted(s.key for s in queued) == [1, 1, 1, 2]
    form = {s.key: s for s in spans if s.name == "batcher.form"}
    # a request waits from its arrival until the batch took it
    assert all(s.start <= s.end <= form[s.key].end for s in queued)


def test_a_chunked_predict_records_a_copy_in_forward_and_copy_out_a_bucket(engine):
    with profile():
        engine.predict(_imgs(6, 1))  # buckets (2, 4): chunks of 4 and 2
    names = [s.name for s in sorted(tracing.spans(), key=lambda s: s.start)]
    assert names == ["engine.copy_in", "engine.forward", "engine.copy_out"] * 2


def test_a_stage2_step_records_mix_forward_backward_optimizer_inside_step():
    model = create_vit("dedeit", device="cpu", drop_path_rate=0.1, **TOY)
    tx = make_optimizer(OptimConfig(lr=1e-3, warmup_epochs=0, epochs=1), 4)
    state = TrainState.create(model, tx, use_ema=True)
    mix = MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, num_classes=5)
    step = make_stage2_step(model, None, mixup=mix)
    gen = torch.Generator().manual_seed(1)
    images = torch.rand(4, IMG, IMG, 3)
    labels = torch.tensor([0, 1, 2, 3])
    step(state, None, images, labels, gen)  # untraced: records nothing
    assert tracing.spans() == []
    with profile():
        step(state, None, images, labels, gen)
    spans = tracing.spans()
    (parent,) = [s for s in spans if s.name == "step"]
    kids = sorted((s for s in spans if s is not parent), key=lambda s: s.start)
    assert [s.name for s in kids] == ["step.mix", "step.forward", "step.backward",
                                      "step.optimizer"]
    assert parent.key == 1 and state.step == 2  # the step count when the step began
    assert all(s.parent == parent.id and s.key == 1 for s in kids)
    assert all(parent.start <= s.start <= s.end <= parent.end for s in kids)
    assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))


def test_the_mean_over_the_data_group_runs_inside_step_backward(monkeypatch):
    from devit_tpu_torch.train import steps

    open_at_mean = []
    mean = steps._mean_over_data

    def spy(layout, grads, metrics):
        open_at_mean.append([s.name for s in tracing._stack()])
        return mean(layout, grads, metrics)

    monkeypatch.setattr(steps, "_mean_over_data", spy)
    model = create_vit("dedeit", device="cpu", **TOY)
    state = TrainState.create(model, make_optimizer(OptimConfig(lr=1e-3, warmup_epochs=0,
                                                                epochs=1), 4))
    step = make_stage2_step(model, None)
    with profile():
        step(state, None, torch.rand(4, IMG, IMG, 3), torch.tensor([0, 1, 2, 3]),
             torch.Generator().manual_seed(1))
    assert open_at_mean == [["step", "step.backward"]]


def _phases_inside_step():
    spans = tracing.spans()
    (parent,) = [s for s in spans if s.name == "step"]
    kids = sorted((s for s in spans if s is not parent), key=lambda s: s.start)
    assert all(s.parent == parent.id and parent.start <= s.start <= s.end <= parent.end
               for s in kids)
    return parent, [s.name for s in kids]


def test_the_dekd_and_ensemble_steps_record_the_same_phases():
    from devit_tpu_torch.models.ensemble import init_multivit, stack_division_gates
    from devit_tpu_torch.train.steps import make_dekd_step, make_ensemble_train_step

    tx = lambda: make_optimizer(OptimConfig(lr=1e-3, warmup_epochs=0, epochs=1), 4)
    images, labels = torch.rand(4, IMG, IMG, 3), torch.tensor([0, 1, 2, 3])
    student = create_vit("dedeit", device="cpu", **TOY)
    teacher = create_vit("dedeit", generator=torch.Generator().manual_seed(3), device="cpu",
                         **TOY)
    state = TrainState.create(student, tx())
    gates = Gates(head=torch.ones(2, 2), neuron=torch.ones(2, 128))
    with profile():
        make_dekd_step(student, teacher)(state, None, gates, images, labels,
                                         torch.Generator().manual_seed(1))
    parent, names = _phases_inside_step()
    # no mixup configured: step.mix records the pass-through all the same
    assert parent.key == 0 and names == ["step.mix", "step.forward", "step.backward",
                                         "step.optimizer"]

    tracing.clear()
    stacked = init_multivit(student, [torch.Generator().manual_seed(s) for s in (1, 2)])
    ens = EnsMLP(num_classes=5, sub_size=32, num_divisions=2, teacher_size=24,
                 dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(0))
    bb, en = TrainState.create(stacked, tx()), TrainState.create(ens, tx())
    step = make_ensemble_train_step(student, ens, None, distillation_type="none",
                                    mixup=MixupConfig(num_classes=5))
    with profile():
        step(bb, en, None, stack_division_gates([gates] * 2), images, labels,
             torch.Generator().manual_seed(1))
    parent, names = _phases_inside_step()
    # one optimizer update a state: the divisions', then the fusion head's
    assert parent.key == 0 and names == ["step.mix", "step.forward", "step.backward",
                                         "step.optimizer", "step.optimizer"]


# ------------------------------------------------ the batcher's own figures


def test_nearest_rank_percentiles():
    vals = [float(v) for v in range(1, 101)]  # 1..100
    assert nearest_rank(vals, 50) == 50.0 and nearest_rank(vals, 99) == 99.0
    assert nearest_rank([3.0], 50) == 3.0 and nearest_rank([3.0], 99) == 3.0
    assert nearest_rank([1.0, 2.0], 50) == 1.0 and nearest_rank([1.0, 2.0], 99) == 2.0
    ten = [float(v) for v in range(10)]  # ceil(0.99 * 10) - 1 = 9, ceil(0.5 * 10) - 1 = 4
    assert nearest_rank(ten, 99) == 9.0 and nearest_rank(ten, 50) == 4.0
    assert nearest_rank([], 50) is None


def test_snapshot_reports_known_latencies_and_queue_waits_by_nearest_rank(engine):
    b = MicroBatcher(engine)
    empty = b.snapshot()
    assert (empty["latency_ms_p50"], empty["queue_wait_ms_p99"], empty["latency_samples"]) == (
        None, None, 0)
    b._latencies.extend(v / 1e3 for v in range(200, 0, -1))  # 1..200 ms, out of order
    b._waits.extend(v / 1e4 for v in range(1, 201))  # 0.1..20 ms
    s = b.snapshot()
    assert s["latency_ms_p50"] == 100.0 and s["latency_ms_p99"] == 198.0
    assert s["queue_wait_ms_p50"] == 10.0 and s["queue_wait_ms_p99"] == 19.8
    assert s["latency_samples"] == 200
    assert {"requests", "images", "batches", "coalesced", "queue_depth"} <= set(s)


def test_the_batcher_stamps_on_perf_counter(engine):
    b = MicroBatcher(engine)
    t0 = time.perf_counter()
    fut = b.submit(_imgs(1, 3))
    time.sleep(0.02)
    b.start()
    fut.result(timeout=60)
    t1 = time.perf_counter()
    b.stop()
    s = b.snapshot()
    assert s["latency_samples"] == 1
    assert 20.0 <= s["queue_wait_ms_p50"] <= s["latency_ms_p50"] <= (t1 - t0) * 1e3
