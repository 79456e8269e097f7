"""The port's `pipeline --model cct_2_3x1_32` (devit_tpu_torch/cli) against
the JAX CLI's stages on the same inputs, at a toy width (64 wide, 2 layers,
4 heads, 32-px synthetic data, 2 divisions), --dtype float32, --device cpu,
every random draw off: one JAX-written init checkpoint starts both packages'
stage 2 and serves as the DEKD teacher (self-distillation starts at a zero
relation loss whose gradient is rounding noise; see
tests/test_torch_cli_stages_late.py).

Held: stage 2's losses (1e-5 relative), and stage 4's against the JAX
CLI's stage 4 on the port's stage-2 checkpoint and stage-3 files; stage 3's
.npy files equal the JAX CLI's (neuron ranks up to swapped near-tied
neighbours); every checkpoint the port writes restores in the JAX package
with the JAX CLI's own keys and shapes; the JAX CLI resumes the port's
CCT-ensemble checkpoint with its optimizer states and evaluates it to the
port's own last accuracy; the ViT-only deploy is skipped with the
JAX CLI's log line."""

import os

import numpy as np
import pytest

from torch_cli_helpers import (NO_DRAWS, assert_losses_close, few_threads, jax_parser, jax_run,
                               leaves, stats, torch_run)

_few_threads = few_threads

CCT = ["--model", "cct_2_3x1_32", "--input-size", "32", "--embed-dim", "64", "--depth", "2",
       "--num-heads", "4", "--drop-path", "0.0", "--drop", "0.0", "--dtype", "float32"]
OPT = ["--batch-size", "32", "--eval-batch-size", "64", "--epochs", "1", "--warmup-epochs",
       "0", "--cooldown-epochs", "0", "--lr", "2e-3", "--no-scale-lr"]
DATA = ["--dataset", "synthetic:8:256:32", "--num_division", "2"]
# the JAX CCT pipeline test's search (tests/test_cct_pipeline.py): a CCT's
# tokenizer leaves less of the budget to prune than the ViT toy's
SHRINK = ["--population", "4", "--shrink-ratio", "0.3", "--ub", "0.8", "--candidate-chunk", "2"]
JAX_DIVISIONS = (0,)  # the JAX CLI's stages 2-4 run for division 0 (time)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's whole pipeline (both divisions) from a JAX-written init
    checkpoint, and the JAX CLI's split, stage 2, stage 3 and stage 4 of
    JAX_DIVISIONS from the same checkpoint."""
    import jax
    import jax.numpy as jnp

    from devit_tpu.cli import common as JC
    from devit_tpu.io.checkpoint import save_pytree

    root = str(tmp_path_factory.mktemp("cct_cli"))
    args = jax_parser().parse_args(["train_sub", *CCT, *DATA])
    model = JC.build_backbone("cct_2_3x1_32", 4, args)
    params = model.init(jax.random.key(3), jnp.zeros((2, 32, 32, 3)))["params"]
    init = os.path.join(root, "init.msgpack")
    save_pytree(init, {"params": params})
    j, t = os.path.join(root, "jax"), os.path.join(root, "port")
    manifest = jax_run(["split", *DATA, "--output_dir", j])
    torch_run(["pipeline", *CCT, *OPT, *DATA, *NO_DRAWS, *SHRINK, "--model-path", init,
               "--teacher-model", "cct_2_3x1_32", "--teacher-path", init,
               "--teacher-size", "48", "--output_dir", t])
    for d in JAX_DIVISIONS:
        jax_run(["train_sub", *CCT, *OPT, *DATA, *NO_DRAWS, "--manifest", manifest,
                 "--model-path", init, "--start-division", str(d),
                 "--output_dir", os.path.join(j, f"sub-model{d}")])
        jax_run(["shrink", *CCT, *OPT, *DATA, *SHRINK, "--manifest", manifest, "--model-path",
                 os.path.join(j, f"sub-model{d}", "checkpoint.msgpack"), "--start-division",
                 str(d), "--output_dir", os.path.join(j, f"shrink{d}")])
        # stage 4 from the port's stage-2 checkpoint and stage-3 files: the
        # same start and gates on both sides (one epoch of f32 rounding
        # apart, the relation losses drift by ~1% in four steps)
        jax_run(["distill", *CCT, *OPT, *DATA, *NO_DRAWS, "--manifest", manifest,
                 "--model-path", os.path.join(t, f"sub-model{d}", "checkpoint.msgpack"),
                 "--teacher-model", "cct_2_3x1_32", "--teacher-path", init,
                 "--policy-path", os.path.join(t, f"shrink{d}"), "--distillation-type", "hard",
                 "--clip-grad", "1.0", "--start-division", str(d),
                 "--output_dir", os.path.join(j, f"sub-dataset{d}")])
    return dict(jax=j, port=t)


def test_cct_stage2_and_stage4_losses_match_jax(runs):
    for d in JAX_DIVISIONS:
        for stage in ("sub-model", "sub-dataset"):
            assert_losses_close(os.path.join(runs["port"], f"{stage}{d}"),
                                os.path.join(runs["jax"], f"{stage}{d}"))


@pytest.mark.parametrize("name", ["shrinked_policy", "shrinked_accuracy", "neuron_rank",
                                  "head_rank"])
def test_cct_stage3_files_equal_jax(runs, name):
    """The policies, their accuracies and the head ranks equal the JAX
    CLI's. The neuron ranks too, but for adjacent neurons whose HSIC scores
    tie to f32 rounding: the port centres the features before its f32
    products (core/hsic.py), the JAX package does not, so such a pair may
    come out in the other order (one pair, or 2% of the positions, a
    layer at most)."""
    for d in JAX_DIVISIONS:
        got, want = (np.load(os.path.join(runs[k], f"shrink{d}", f"{name}.npy"))
                     for k in ("port", "jax"))
        assert got.dtype == want.dtype and got.shape == want.shape
        if name != "neuron_rank":
            np.testing.assert_array_equal(got, want)
            continue
        for g, w in zip(got, want):  # per layer
            bad = np.flatnonzero(g != w)
            assert len(bad) <= max(2, 0.02 * len(w)), (d, bad)
            for i in bad:  # each a swap with a neighbour
                assert any(0 <= i + o < len(w) and g[i] == w[i + o] and g[i + o] == w[i]
                           for o in (-1, 1)), (d, i)


def test_cct_checkpoints_restore_in_jax_with_its_layout(runs):
    from devit_tpu.io.checkpoint import restore_pytree as jrestore

    for rel in ("sub-model0/checkpoint.msgpack", "sub-dataset0/checkpoint.msgpack"):
        got, want = (leaves(jrestore(os.path.join(runs[k], rel), None))
                     for k in ("port", "jax"))
        assert got.keys() == want.keys(), rel
        for k in want:
            assert (got[k] is None) == (want[k] is None) and (
                got[k] is None or got[k].shape == want[k].shape), (rel, k)
    ens = leaves(jrestore(os.path.join(runs["port"], "ensemble", "checkpoint.msgpack"), None))
    assert {k.split("/")[0] for k in ens} == {
        "backbone_params", "ens_params", "bb_opt_state", "ens_opt_state", "bb_ema", "ens_ema",
        "epoch", "gates"}
    assert ens["backbone_params/tokenizer/conv0/kernel/"].shape == (2, 3, 3, 3, 64)
    assert ens["gates/head/"].shape == (2, 2, 4)


def test_jax_cli_resumes_and_scores_the_ports_cct_ensemble(runs, tmp_path):
    port = runs["port"]
    out = str(tmp_path / "jax_eval")
    acc1 = jax_run(["ensemble", *CCT, *OPT, *DATA, *NO_DRAWS, "--teacher-size", "48",
                    "--sub-model-path", port, "--eval", "--resume",
                    os.path.join(port, "ensemble", "checkpoint_temp.msgpack"),
                    "--output_dir", out])
    with open(os.path.join(out, "log.txt")) as f:
        assert "resumed ensemble (params, optimizer states, EMA)" in f.read()
    assert acc1 == stats(os.path.join(port, "ensemble"))[-1]["test_acc1"]
    assert not os.path.exists(os.path.join(port, "deploy"))
    logs = ""
    for dirpath, _, names in os.walk(port):
        if "log.txt" in names:
            with open(os.path.join(dirpath, "log.txt")) as f:
                logs += f.read()
    assert "deploy (ragged compaction) is ViT-only" in logs
