"""The port's CLI stages 4-5, deploy, inspect and convert
(devit_tpu_torch/cli) against the JAX CLI's on the same inputs, at the toy
geometry of tests/test_torch_cli_stages.py, --dtype float32, --device cpu:
`distill`'s losses, checkpoint and gates; the JAX stage 4 on the port's
stage-2 checkpoint; `ensemble` resumed from a JAX-written epoch-0 stage-5
checkpoint (the fusion head each CLI draws fresh comes from it); `deploy`'s
compact.msgpack leaf for leaf and deploy_report.json; `inspect --json`;
`convert`'s output bytes.

Every random draw is off, as in tests/test_torch_cli_stages.py. Tolerances:
losses 1e-5 relative; the JAX stage 4 on the port's stage-2 checkpoint
1e-4 (its starting parameters differ by two epochs' f32 rounding); the
stage-5 losses 2e-3 relative, because the fusion head computes in bfloat16
in both packages (EnsMLP's dtype) and one bf16 rounding of its logits is
2^-8 relative; parameters within steps * lr."""

import json
import os

import numpy as np
import pytest

from torch_cli_helpers import (DATA, MODEL, NO_DRAWS, OPT, assert_losses_close,
                               assert_params_close, few_threads, jax_inputs, jax_run, leaves,
                               restore, stats, torch_run)

_few_threads = few_threads


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """jax_inputs (stage 2 at one epoch: these tests do not compare it), and
    the JAX CLI's stage 4 of both divisions and an epoch-0 stage-5
    checkpoint with the run resumed from it. The teacher is the init
    checkpoint, not the student's own stage-2 checkpoint: self-distillation
    starts at a zero relation loss, whose gradient is rounding noise that
    Adam scales up to whole steps."""
    w = jax_inputs(str(tmp_path_factory.mktemp("cli")), epochs=1)
    j, manifest, init = w["jax"], w["manifest"], w["init"]
    distill = []
    for d in range(2):
        stage2 = os.path.join(j, f"sub-model{d}", "checkpoint.msgpack")
        distill.append([*MODEL, *OPT, *DATA, *NO_DRAWS, "--manifest", manifest,
                        "--model-path", stage2, "--teacher-model", "dedeit",
                        "--teacher-path", init, "--policy-path",
                        os.path.join(j, f"shrink{d}"), "--start-division", str(d)])
        jax_run(["distill", *distill[d], "--output_dir", os.path.join(j, f"sub-dataset{d}")])
    ens = [*MODEL, *OPT, *DATA, *NO_DRAWS, "--sub-model-path", j, "--teacher-size", "48",
           "--lr", "1e-3"]
    jax_run(["ensemble", *ens, "--epochs", "1", "--output_dir", os.path.join(j, "ens0")])
    ens0 = os.path.join(j, "ens0", "checkpoint_temp.msgpack")
    jax_run(["ensemble", *ens, "--resume", ens0, "--output_dir", os.path.join(j, "ensemble")])
    return dict(w, distill=distill, ens=ens, ens0=ens0)


def test_distill_matches_jax(work, tmp_path):
    out = str(tmp_path / "distill")
    torch_run(["distill", *work["distill"][0], "--output_dir", out])
    want = os.path.join(work["jax"], "sub-dataset0")
    assert_losses_close(out, want)
    assert_params_close(os.path.join(out, "checkpoint_temp.msgpack"),
                         os.path.join(want, "checkpoint_temp.msgpack"), 8)
    got, ref = (restore(os.path.join(p, "checkpoint_temp.msgpack")) for p in (out, want))
    assert list(got) == list(ref)  # params, ema_params, opt_state, gates, epoch
    for k in ("head", "neuron"):
        np.testing.assert_array_equal(np.asarray(got["gates"][k]), np.asarray(ref["gates"][k]))


def test_jax_distill_continues_from_the_ports_stage2(work, tmp_path):
    """Across the packages: the JAX stage 4 on the port's stage-2 checkpoint
    gives what it gives on the JAX package's own."""
    sub = str(tmp_path / "sub")
    opt = OPT[:OPT.index("--epochs")] + ["--epochs", "1"] + OPT[OPT.index("--epochs") + 2:]
    torch_run(["train_sub", *MODEL, *opt, *DATA, *NO_DRAWS, "--manifest", work["manifest"],
               "--model-path", work["init"], "--start-division", "0", "--output_dir", sub])
    argv = list(work["distill"][0])
    argv[argv.index("--model-path") + 1] = os.path.join(sub, "checkpoint.msgpack")
    out = str(tmp_path / "distill")
    jax_run(["distill", *argv, "--output_dir", out])
    # one epoch of stage 2 apart by f32 rounding: the stage-4 losses agree
    # to the rounding carried through the starting parameters
    assert_losses_close(out, os.path.join(work["jax"], "sub-dataset0"), rtol=1e-4)


def test_ensemble_resumes_the_jax_checkpoint_and_matches(work, tmp_path):
    out = str(tmp_path / "ensemble")
    torch_run(["ensemble", *work["ens"], "--resume", work["ens0"], "--output_dir", out])
    want = os.path.join(work["jax"], "ensemble")
    assert_losses_close(out, want, rtol=2e-3, epochs=(1,))
    got, ref = (restore(os.path.join(p, "checkpoint_temp.msgpack")) for p in (out, want))
    assert list(got) == list(ref)
    assert int(got["epoch"]) == 1 and got["gates"]["head"].shape == (2, 2, 4)
    for key in ("backbone_params", "ens_params"):
        g, w = leaves(got[key]), leaves(ref[key])
        assert g.keys() == w.keys()
        for k in w:
            assert np.abs(g[k] - w[k]).max() <= 4 * 1e-3, (key, k)


def test_deploy_equals_jax_leaf_for_leaf(work, tmp_path):
    from devit_tpu.io.checkpoint import restore_pytree as jrestore

    ens_ckpt = os.path.join(work["jax"], "ensemble", "checkpoint.msgpack")
    argv = ["deploy", *MODEL, *DATA, "--deploy-num-classes", "8", "--neuron-multiple", "8"]
    for tag, src in (("ens", ["--ensemble-path", ens_ckpt]),
                     ("sub", ["--sub-model-path", work["jax"]])):
        t_out, j_out = str(tmp_path / f"t_{tag}"), str(tmp_path / f"j_{tag}")
        torch_run(argv + src + ["--output_dir", t_out])
        jax_run(argv + src + ["--output_dir", j_out])
        with open(os.path.join(t_out, "deploy_report.json")) as f, \
                open(os.path.join(j_out, "deploy_report.json")) as g:
            assert json.load(f) == json.load(g)
        for d in range(2):
            rel = os.path.join(f"sub-dataset{d}", "compact.msgpack")
            got = leaves(restore(os.path.join(t_out, rel)))
            want = leaves(jrestore(os.path.join(j_out, rel), None))
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_inspect_json_equals_jax(work, tmp_path, capsys):
    j = work["jax"]
    paths = [work["manifest"], os.path.join(j, "sub-model0", "checkpoint.msgpack"),
             os.path.join(j, "sub-dataset0", "checkpoint.msgpack"),
             os.path.join(j, "ensemble", "checkpoint_temp.msgpack"),
             os.path.join(j, "shrink0", "shrinked_policy.npy")]
    torch_run(["inspect", "--json", *paths])
    got = json.loads(capsys.readouterr().out)
    jax_run(["inspect", "--json", *paths])
    want = json.loads(capsys.readouterr().out)
    assert got == want and len(got) == len(paths)


def test_convert_output_bytes_equal_jax(work, tmp_path):
    src = os.path.join(work["jax"], "sub-model0", "checkpoint.msgpack")
    for tag, argv in (("copy", []), ("ema", ["--ema"])):
        t, j = str(tmp_path / f"t_{tag}.msgpack"), str(tmp_path / f"j_{tag}.msgpack")
        torch_run(["convert", src, t, *argv])
        jax_run(["convert", src, j, *argv])
        with open(t, "rb") as f, open(j, "rb") as g:
            assert f.read() == g.read(), tag
    # msgpack -> torch .pth -> msgpack: the reference layout both ways
    import torch

    tp, jp = str(tmp_path / "t.pth"), str(tmp_path / "j.pth")
    torch_run(["convert", src, tp])
    jax_run(["convert", src, jp])
    a, b = torch.load(tp), torch.load(jp)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    t2, j2 = str(tmp_path / "t2.msgpack"), str(tmp_path / "j2.msgpack")
    torch_run(["convert", tp, t2])
    jax_run(["convert", jp, j2])
    with open(t2, "rb") as f, open(j2, "rb") as g:
        assert f.read() == g.read()


def test_ensemble_resume_across_optimizer_families_falls_back_to_params(work, tmp_path):
    """An adamw stage-5 checkpoint (the JAX CLI's epoch-0 file) resumed under
    --opt sgd: its optimizer states do not fit the run's, so both CLIs
    resume the params only and log the params-only WARNING; the first
    epoch's losses then agree (2e-3 relative: the bf16 fusion head, as
    above). A checkpoint that is not an ensemble checkpoint still raises."""
    argv = [*work["ens"], "--opt", "sgd", "--resume", work["ens0"]]
    out, ref = str(tmp_path / "t_sgd"), str(tmp_path / "j_sgd")
    torch_run(["ensemble", *argv, "--output_dir", out])
    jax_run(["ensemble", *argv, "--output_dir", ref])
    for d in (out, ref):
        with open(os.path.join(d, "log.txt")) as f:
            text = f.read()
        assert "WARNING: resumed PARAMS ONLY" in text and "restart from zero" in text, d
    assert_losses_close(out, ref, rtol=2e-3, epochs=(1,))
    assert all(np.isfinite(r["train_loss"]) for r in stats(out))
    stage2 = os.path.join(work["jax"], "sub-model0", "checkpoint.msgpack")
    with pytest.raises(RuntimeError, match="not an ensemble checkpoint"):
        torch_run(["ensemble", *work["ens"], "--resume", stage2,
                   "--output_dir", str(tmp_path / "bad")])
