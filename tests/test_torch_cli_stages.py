"""The port's CLI stages 1-3 (devit_tpu_torch/cli) against the JAX CLI's
(devit_tpu/cli) on the same inputs, at the JAX package's toy geometry
(tests/test_pipeline_e2e.py: 32 px, patch 4, embed 32, depth 2, 4 heads,
synthetic:8:256:32, 2 divisions), --dtype float32 and --device cpu:
`split`'s manifest byte for byte, `train_sub`'s losses and checkpoints,
`shrink`'s policies, accuracies and ranks. Stages 4-5, deploy, inspect and
convert are in tests/test_torch_cli_stages_late.py.

Every random draw is off (--no-aug, no mixup/cutmix/erasing, drop-path 0,
no repeated augmentation): the two CLIs draw from different generators.
Both start from one JAX-written checkpoint (--model-path), never from
their own random init.

Tolerances: log_stats losses 1e-5 relative (the stage-2 step's bound,
tests/test_torch_stage2.py); the written parameters within the stage-2
test's bound for a few Adam steps (|diff| <= steps * lr)."""

import os

import numpy as np
import pytest

from torch_cli_helpers import (DATA, MODEL, NO_DRAWS, OPT, SHRINK, assert_losses_close,
                               assert_params_close, few_threads, jax_inputs, restore,
                               torch_run)

_few_threads = few_threads


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return jax_inputs(str(tmp_path_factory.mktemp("cli")))


def test_split_manifest_byte_for_byte(work, tmp_path):
    path = torch_run(["split", *DATA, "--output_dir", str(tmp_path)]) or os.path.join(
        tmp_path, "division2", "manifest.json")
    with open(os.path.join(tmp_path, "division2", "manifest.json"), "rb") as f:
        got = f.read()
    with open(work["manifest"], "rb") as f:
        assert got == f.read()


@pytest.mark.parametrize("division", [0, 1])
def test_train_sub_matches_jax(work, tmp_path, division):
    out = str(tmp_path / "sub")
    torch_run(["train_sub", *MODEL, *OPT, *DATA, *NO_DRAWS, "--manifest", work["manifest"],
               "--model-path", work["init"], "--start-division", str(division),
               "--output_dir", out])
    want = os.path.join(work["jax"], f"sub-model{division}")
    assert_losses_close(out, want)
    steps = 2 * (128 // 32)  # two epochs over a division's 128 images
    for name in ("checkpoint_temp.msgpack", "checkpoint.msgpack"):
        assert_params_close(os.path.join(out, name), os.path.join(want, name), steps)
    tree = restore(os.path.join(out, "checkpoint_temp.msgpack"))
    assert sorted(tree) == ["ema_params", "epoch", "opt_state", "params"]
    assert int(tree["epoch"]) == 1


@pytest.mark.parametrize("division", [0, 1])
def test_shrink_policies_equal_jax(work, tmp_path, division):
    out = str(tmp_path / "shrink")
    torch_run(["shrink", *MODEL, *OPT, *DATA, *SHRINK, "--manifest", work["manifest"],
               "--model-path", os.path.join(work["jax"], f"sub-model{division}",
                                            "checkpoint.msgpack"),
               "--start-division", str(division), "--output_dir", out])
    for name in ("shrinked_policy.npy", "shrinked_accuracy.npy", "neuron_rank.npy",
                 "head_rank.npy"):
        got = np.load(os.path.join(out, name))
        want = np.load(os.path.join(work["jax"], f"shrink{division}", name))
        np.testing.assert_array_equal(got, want, err_msg=name)
