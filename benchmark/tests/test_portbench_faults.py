"""A run's `correct` against known faults: the harness's look for a card is
skipped and the rest of a run driven, at a tiny size on the CPU, with the
timed path broken underneath, and `correct` must come out false under the
cells' own limits; unbroken, it comes out true. The control (the reference
in float8 in the program's place) reads well above the program."""

import time

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.drivers import _serving, train_steps
from portbench_tiny import tiny_cell


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, **kw):
    cell = tiny_cell(workload, dtype="bfloat16", seconds=kw.pop("seconds", 1.0), **kw)
    return core.run(cell, time.perf_counter())


def frozen_state(monkeypatch):
    from devit_tpu_torch.train import state

    monkeypatch.setattr(state.TrainState, "apply_gradients", lambda self, grads: self)


def half_batch(monkeypatch):
    from devit_tpu_torch.train import steps

    make = steps.make_stage2_step

    def broken(*a, **k):
        step = make(*a, **k)
        return lambda st, tv, x, y, g: step(st, tv, x[: len(x) // 2], y[: len(y) // 2], g)
    monkeypatch.setattr(steps, "make_stage2_step", broken)


def answers_off_by_one_row(monkeypatch):
    from devit_tpu_torch.serving import daemon

    bucket = daemon.InferenceEngine._run_bucket
    monkeypatch.setattr(daemon.InferenceEngine, "_run_bucket",
                        lambda self, x: np.roll(bucket(self, x), 1, axis=0))


def half_of_the_batch_answered(monkeypatch):
    from devit_tpu_torch.serving import daemon

    bucket = daemon.InferenceEngine._run_bucket

    def broken(self, x):
        half = bucket(self, x[: max(1, len(x) // 2)])
        return np.concatenate([half, half, half])[: len(x)]
    monkeypatch.setattr(daemon.InferenceEngine, "_run_bucket", broken)


@pytest.mark.parametrize("workload", ["serve_ens4_batch", "serve_ens4_online",
                                      "train_stage2_224", "train_stage2_384"])
def test_a_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared"


@pytest.mark.parametrize("workload, fault", [
    ("train_stage2_224", frozen_state), ("train_stage2_224", half_batch),
    ("train_stage2_384", frozen_state), ("train_stage2_384", half_batch),
    ("serve_ens4_batch", answers_off_by_one_row), ("serve_ens4_batch", half_of_the_batch_answered),
    ("serve_ens4_online", answers_off_by_one_row),
    ("serve_ens4_online", half_of_the_batch_answered),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(workload)
    assert not result["correct"], result["compared"]


def test_a_missing_answer_is_not_correct(monkeypatch):
    from devit_tpu_torch.serving import daemon

    predict = daemon.InferenceEngine.predict
    calls = []

    def dropping(self, x):
        calls.append(len(x))
        if len(calls) == 6:  # the warm-up makes three calls
            raise RuntimeError("a batch lost")
        return predict(self, x)
    monkeypatch.setattr(daemon.InferenceEngine, "predict", dropping)
    result = run("serve_ens4_online")
    assert result["failed"] > 0 and not result["correct"]


def test_the_control_reads_far_above_the_program():
    cell = tiny_cell("train_stage2_224", dtype="bfloat16", seconds=0.3)
    got = {}
    original = train_steps.check
    try:
        train_steps.check = lambda cell, g: got.update(g) or {}
        train_steps.run(cell)
    finally:
        train_steps.check = original
    want = train_steps.reference_steps(cell)
    program = train_steps.numbers(got, want)
    control = train_steps.numbers(train_steps.reference_steps(cell, "fp8"), want)
    assert control["grad_gap"] >= 3 * program["grad_gap"]

    cell = tiny_cell("serve_ens4_batch", dtype="bfloat16")
    served = _serving.build(cell, core.Spans())
    try:
        chosen = [(0, 8, 0.0, 0.0, served.engine.predict(served.pool[:8]))]
    finally:
        _serving.release(served)
    program = _serving.check(cell, chosen, served.pool)["logit_err"]
    assert _serving.check(cell, chosen, served.pool, prec="fp8")["logit_err"] >= 3 * program


@pytest.mark.parametrize("workload, readable", [
    ("serve_ens4_batch", {"mfu.batch"}),
    ("serve_ens4_online", {"images_per_batch.online", "bucket_fill.online"}),
    ("train_stage2_224", {"mfu.train"}),
])
def test_a_traced_run_reports_its_layer_metrics(workload, readable):
    cell = tiny_cell(workload, dtype="bfloat16", seconds=2.0, trace_s=1.0)
    cell.trace = True
    result = core.run(cell, time.perf_counter())
    names = {m["name"] for m in cell.per_layer}
    # on the CPU no device operation is traced: the trace's readers find nothing
    assert readable <= set(result["metrics"]) <= names
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops",
                                                                             "idle_gaps"}
    assert result["correct"]
