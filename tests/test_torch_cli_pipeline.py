"""The port's one-shot `pipeline` (devit_tpu_torch/cli/stages.py
pipeline_main) at the JAX package's toy geometry on the CPU, with the
behaviours tests/test_pipeline_e2e.py:305-534 holds the JAX CLI to: every
artifact under one root, a second run skipping every stage, the stage-5
recipe and the deploy fallback, the self-distill teacher, intra-stage
resume, --force. Then `serve` over the pipeline's deploy/ answering
/predict as the engine computes, the compact eval's correct count equal to
the served one, fit(profile_dir=...) writing a trace and --tensorboard
writing an event file."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from devit_tpu_torch.cli import stages as St
from devit_tpu_torch.cli.__main__ import build_parser, main

TINY_MODEL = ["--model", "dedeit", "--input-size", "32", "--patch-size", "4", "--embed-dim",
              "32", "--depth", "2", "--num-heads", "4", "--drop-path", "0.0"]
DATA = ["--dataset", "synthetic:8:256:32", "--num_division", "2"]
NO_MIX = ["--mixup", "0", "--cutmix", "0", "--reprob", "0", "--color-jitter", "0",
          "--no-repeated-aug", "--aa", ""]
TINY_OPT = ["--batch-size", "32", "--eval-batch-size", "64", "--epochs", "2",
            "--warmup-epochs", "0", "--cooldown-epochs", "0", "--lr", "2e-3", "--no-scale-lr"]
PIPELINE = ["pipeline", *TINY_MODEL, *DATA, *NO_MIX, *TINY_OPT, "--no-aug",
            "--shrink-ratio", "0.45", "--ub", "0.9", "--population", "2",
            "--candidate-chunk", "2", "--teacher-size", "48", "--deploy-num-classes", "8",
            "--neuron-multiple", "8", "--device", "cpu"]


def run(argv):
    args = build_parser().parse_args(argv)
    return args.fn(args)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Toy-size ops: two intra-op threads keep the test workers (and JAX's
    threads beside them) from oversubscribing the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipeline_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("oneshot"))
    results = run(PIPELINE + ["--output_dir", root])
    return root, results


def test_pipeline_one_shot_writes_every_artifact(pipeline_root):
    root, results = pipeline_root
    for art in ["division2/manifest.json", "sub-model0/checkpoint.msgpack",
                "sub-model1/checkpoint.msgpack", "shrink0/shrinked_policy.npy",
                "shrink1/shrinked_policy.npy", "sub-dataset0/checkpoint.msgpack",
                "sub-dataset1/checkpoint.msgpack", "ensemble/checkpoint.msgpack",
                "deploy/deploy_report.json", "deploy/sub-dataset0/compact.msgpack",
                "deploy/sub-dataset1/compact.msgpack"]:
        assert os.path.exists(os.path.join(root, art)), art
    assert sorted(results) == ["distill0", "distill1", "ensemble", "train_sub0", "train_sub1"]
    assert results["ensemble"] > 100.0 / 8, results  # the fused head learned
    from devit_tpu_torch.io.checkpoint import restore_pytree

    ck = restore_pytree(os.path.join(root, "ensemble", "checkpoint.msgpack"))
    assert ck["gates"]["head"].shape == (2, 2, 4)  # deploy took the distill gates
    for d in range(2):
        with open(os.path.join(root, f"sub-model{d}", "log_stats.txt")) as f:
            assert all(np.isfinite(json.loads(line)["train_loss"]) for line in f)


def test_second_pipeline_run_skips_every_stage(pipeline_root):
    root, _ = pipeline_root
    assert run(PIPELINE + ["--output_dir", root]) == {}
    with open(os.path.join(root, "log.txt")) as f:
        assert f.read().count("skipping") >= 8


def test_pipeline_stage5_recipe_and_deploy_fallback(tmp_path, monkeypatch):
    captured = {}
    monkeypatch.setattr(St, "ensemble_main", lambda a: captured.update(ens=a) or 61.0)
    monkeypatch.setattr(St, "deploy_main", lambda a: captured.update(dep=a))
    argv = ["pipeline", "--output_dir", str(tmp_path), "--stages", "ensemble,deploy", *DATA,
            "--device", "cpu"]
    St.pipeline_main(build_parser().parse_args(argv))
    assert captured["ens"].lr == 1e-5 and captured["ens"].weight_decay == 0.05
    assert captured["dep"].ensemble_path is None  # no ensemble checkpoint: distill fallback
    captured.clear()
    St.pipeline_main(build_parser().parse_args(
        argv + ["--ens-backbone-lr", "3e-5", "--weight-decay", "0.1"]))
    assert captured["ens"].lr == 3e-5 and captured["ens"].weight_decay == 0.1
    captured.clear()
    St.pipeline_main(build_parser().parse_args(argv + ["--lr", "5e-4", "--weight-decay", "0.0"]))
    assert captured["ens"].lr == 5e-4 and captured["ens"].weight_decay == 0.0


def _fake_stages(monkeypatch, captured):
    def fake_train_sub(args):
        captured.setdefault("train_resume", []).append(args.resume)
        os.makedirs(args.output_dir, exist_ok=True)
        open(os.path.join(args.output_dir, "checkpoint.msgpack"), "wb").close()
        return 50.0

    def fake_shrink(args):
        os.makedirs(args.output_dir, exist_ok=True)
        np.save(os.path.join(args.output_dir, "shrinked_policy.npy"), np.zeros((1, 4)))

    def fake_distill(args):
        captured.setdefault("teachers", []).append((args.teacher_model, args.teacher_path))
        os.makedirs(args.output_dir, exist_ok=True)
        open(os.path.join(args.output_dir, "checkpoint.msgpack"), "wb").close()
        return 50.0

    monkeypatch.setattr(St, "train_sub_main", fake_train_sub)
    monkeypatch.setattr(St, "shrink_main", fake_shrink)
    monkeypatch.setattr(St, "distill_main", fake_distill)


def test_pipeline_self_distill_teacher_and_stage_resume(tmp_path, monkeypatch):
    root = str(tmp_path / "pipe")
    captured = {}
    _fake_stages(monkeypatch, captured)
    os.makedirs(os.path.join(root, "sub-model0"))
    open(os.path.join(root, "sub-model0", "checkpoint_temp.msgpack"), "wb").close()
    run(["pipeline", *TINY_MODEL, *DATA, "--stages", "split,train_sub,shrink,distill",
         "--output_dir", root, "--device", "cpu"])
    assert captured["train_resume"][0].endswith(
        os.path.join("sub-model0", "checkpoint_temp.msgpack"))
    assert captured["train_resume"][1] == ""
    for d, (t_model, t_path) in enumerate(captured["teachers"]):
        assert t_model == "dedeit"
        assert t_path == os.path.join(root, f"sub-model{d}", "checkpoint.msgpack")


def test_pipeline_force_retrains_from_scratch(tmp_path, monkeypatch):
    root = str(tmp_path / "pipe")
    captured = {}
    _fake_stages(monkeypatch, captured)
    for d in range(2):
        sub = os.path.join(root, f"sub-model{d}")
        os.makedirs(sub)
        for name in ("checkpoint.msgpack", "checkpoint_temp.msgpack"):
            open(os.path.join(sub, name), "wb").close()
    run(["pipeline", *TINY_MODEL, *DATA, "--stages", "split,train_sub", "--force",
         "--output_dir", root, "--device", "cpu"])
    assert captured["train_resume"] == ["", ""]


def test_resumed_stage_equals_the_uninterrupted_one(tmp_path):
    """fit's per-epoch generator: a train_sub resumed from its epoch-0
    checkpoint_temp ends where the uninterrupted two epochs end, with the
    draws on (device RandAugment at 32 px, mixup, drop-path). A constant
    schedule, so the one-epoch run's first epoch is the two-epoch run's."""
    base = ["train_sub", *TINY_MODEL[:-2], "--drop-path", "0.1", *DATA, "--batch-size", "32",
            "--eval-batch-size", "64", "--sched", "constant", "--warmup-epochs", "0",
            "--cooldown-epochs", "0", "--no-repeated-aug", "--aug-backend", "device",
            "--device", "cpu"]
    full, first, rest = (str(tmp_path / n) for n in ("full", "first", "rest"))
    main(base + ["--epochs", "2", "--output_dir", full])
    main(base + ["--epochs", "1", "--output_dir", first])
    main(base + ["--epochs", "2", "--resume", os.path.join(first, "checkpoint_temp.msgpack"),
                 "--output_dir", rest])
    from devit_tpu_torch.io.checkpoint import restore_pytree

    a = restore_pytree(os.path.join(full, "checkpoint_temp.msgpack"))
    b = restore_pytree(os.path.join(rest, "checkpoint_temp.msgpack"))

    def leaves(t, p=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from leaves(v, f"{p}{k}/")
        elif t is not None:
            yield p, np.asarray(t)

    lb = dict(leaves(b))
    for k, v in leaves(a):
        np.testing.assert_array_equal(v, lb[k], err_msg=k)


def _post(url, imgs):
    req = urllib.request.Request(url + "/predict", data=imgs.tobytes(), method="POST",
                                 headers={"X-Image-Shape": ",".join(map(str, imgs.shape))})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_serve_main_answers_predict_as_the_engine_and_the_compact_eval(pipeline_root):
    """`serve` over the pipeline's deploy/ with its fusion checkpoint, in a
    thread: /predict's top-1 equals the engine's argmax, and its correct
    count over the val set equals `ensemble --compact-path`'s."""
    from devit_tpu_torch.data.datasets import build_dataset
    from devit_tpu_torch.serving import daemon

    root, _ = pipeline_root
    deploy, ens = os.path.join(root, "deploy"), os.path.join(root, "ensemble",
                                                             "checkpoint.msgpack")
    args = build_parser().parse_args(
        ["serve", "--compact-path", deploy, "--ens-path", ens, "--input-size", "32",
         "--patch-size", "4", "--port", "0", "--buckets", "64", "--device", "cpu"])
    ready = threading.Event()
    box = {}
    thread = threading.Thread(target=daemon.serve_main, args=(args,),
                              kwargs=dict(ready=lambda h: (box.update(httpd=h), ready.set())),
                              daemon=True)
    thread.start()
    assert ready.wait(300)
    httpd = box["httpd"]
    url = "http://%s:%d" % httpd.server_address[:2]
    try:
        val = build_dataset("synthetic:8:256:32", "", train=False, img_size=32)
        engine = daemon.build_engine_from_artifacts(
            deploy, ens, cfg=daemon.ServeConfig(input_size=32, patch_size=4, buckets=(64,)),
            device="cpu", log=None)
        correct = 0
        for i in range(0, len(val), 64):
            imgs, labels = val.images[i:i + 64], val.labels[i:i + 64]
            top1 = [p["topk"][0] for p in _post(url, imgs)["predictions"]]
            assert top1 == np.argmax(engine.predict(imgs), -1).tolist()
            correct += int((np.asarray(top1) == labels).sum())
    finally:
        httpd.shutdown()
        thread.join(60)
    acc1 = run(["ensemble", *TINY_MODEL, *DATA, "--eval-batch-size", "64", "--compact-path",
                 deploy, "--ens-path", ens, "--output_dir", os.path.join(root, "ceval"),
                 "--device", "cpu"])
    assert acc1 == pytest.approx(100 * correct / len(val))


def test_profile_dir_writes_a_trace(tmp_path):
    out, trace = str(tmp_path / "o"), str(tmp_path / "trace")
    main(["train_sub", *TINY_MODEL, *DATA, *NO_MIX, "--batch-size", "32", "--epochs", "1",
          "--no-aug", "--profile-dir", trace, "--output_dir", out, "--device", "cpu"])
    found = [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
    assert found, os.listdir(trace)
    with open(os.path.join(trace, found[0])) as f:
        assert json.load(f)["traceEvents"]
    with open(os.path.join(out, "log.txt")) as f:
        assert "profiler trace ->" in f.read()


def test_tensorboard_flag_writes_event_file(tmp_path):
    out = str(tmp_path / "tb")
    main(["train_sub", *TINY_MODEL, *DATA, *NO_MIX, "--batch-size", "32", "--epochs", "1",
          "--no-aug", "--tensorboard", "--output_dir", out, "--device", "cpu"])
    events = [f for f in os.listdir(out) if f.startswith("events.out.tfevents")]
    assert events, os.listdir(out)
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(out)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"Train/loss", "Test/Top1", "Test/Top5", "Test/loss"} <= tags, tags
