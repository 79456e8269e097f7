"""The port's CLI under two gloo ranks on the CPU (cli/common.py's
parallel_context, wired into the stages as the JAX CLI wires its meshes;
tests/test_cli_parallel.py holds the JAX CLI's): `train_sub` (batch over both ranks, drop-path, augmentation and
mixup draws on), `shrink` (the policy evaluation over both ranks),
`distill` and `ensemble` (the two divisions over both ranks) write what
one process writes, rank 0 alone writes files, and a stage-5 resume across
an epoch under two ranks reproduces the uninterrupted run.

Tolerances: per-epoch train and test losses 1e-5 relative, top-1 equal;
checkpoint leaves (parameters, optimizer moments) within 1e-5, with at most
one in 10^4 entries beyond it and none beyond steps * lr (Adam turns the
sign of a gradient that is zero but for rounding into a full lr step)."""

import os

import numpy as np
import pytest

from devit_tpu_torch.parallel.launch import run_ranks
from torch_cli_helpers import (
    DATA, LR, MODEL, SHRINK, assert_losses_close, leaves, restore, torch_run,
)

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
DRAWS_MODEL = [a if a != "0.0" else "0.1" for a in MODEL]  # --drop-path 0.1
OPT = ["--batch-size", "32", "--eval-batch-size", "64", "--epochs", "2", "--warmup-epochs",
       "0", "--cooldown-epochs", "0", "--lr", "2e-3", "--no-scale-lr", "--mixup", "0.8",
       "--cutmix", "1.0"]
STEPS = 16  # two epochs of the largest stage below


def _assert_trees_close(got, want):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        d = np.abs(got[k] - want[k])
        assert d.max() <= STEPS * LR, (k, d.max())
        assert np.mean(d > 1e-5) <= 1e-4 or d.size < 100 and d.max() <= 1e-5, (k, d.max())


def _rank_files(out):
    return sorted(f for _, _, fs in os.walk(out) for f in fs if f.startswith("log_rank"))


def _both(argv, root, name):
    """argv under two ranks and in one process; their output dirs."""
    par, one = os.path.join(root, name + "_par"), os.path.join(root, name + "_one")
    run_ranks(f"{WORKER}:cli", 2, args=(argv + ["--output_dir", par],), timeout=300)
    torch_run(argv + ["--output_dir", one])
    return par, one


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_par"))
    argv = ["train_sub", *DRAWS_MODEL, *OPT, *DATA, "--start-division", "0"]
    return root, _both(argv, root, "stage2")


def test_train_sub_under_two_ranks_writes_the_one_process_checkpoint(stage2):
    _, (par, one) = stage2
    assert_losses_close(par, one)
    for name in ("checkpoint_temp.msgpack", "checkpoint.msgpack"):
        a, b = restore(os.path.join(par, name)), restore(os.path.join(one, name))
        assert int(np.asarray(a["epoch"])) == int(np.asarray(b["epoch"]))
        _assert_trees_close(a, b)
    # rank 0 wrote the files, rank 1 its own log only
    assert _rank_files(par) == ["log_rank1.txt"]
    assert sorted(os.listdir(par)) == sorted(os.listdir(one) + ["log_rank1.txt"])


def test_shrink_and_distill_under_two_ranks(stage2):
    """Stage 3 (ranking whole on every rank, the policy evaluation's rows
    split) and stage 4 from the one-process stage-2 checkpoint: the same
    .npy files and the same DEKD run as one process."""
    root, (_, one) = stage2
    ckpt = os.path.join(one, "checkpoint.msgpack")
    par_s, one_s = _both(["shrink", *MODEL, *OPT, *DATA, *SHRINK, "--model-path", ckpt,
                          "--start-division", "0"], root, "shrink")
    for name in ("shrinked_policy.npy", "shrinked_accuracy.npy", "neuron_rank.npy",
                 "head_rank.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(par_s, name)),
                                      np.load(os.path.join(one_s, name)), err_msg=name)
    assert _rank_files(par_s) == ["log_rank1.txt"]
    argv = ["distill", *DRAWS_MODEL, *OPT, *DATA, "--model-path", ckpt, "--teacher-path", ckpt,
            "--teacher-model", "dedeit", "--policy-path", one_s, "--start-division", "0",
            "--epochs", "1"]
    par_d, one_d = _both(argv, root, "distill")
    assert_losses_close(par_d, one_d)
    _assert_trees_close(restore(os.path.join(par_d, "checkpoint_temp.msgpack")),
                        restore(os.path.join(one_d, "checkpoint_temp.msgpack")))


ENS = ["ensemble", *MODEL, *DATA, "--teacher-size", "48", "--distillation-type", "none",
       "--batch-size", "32", "--eval-batch-size", "64", "--warmup-epochs", "0",
       "--cooldown-epochs", "0", "--lr", "1e-3", "--epochs", "2", "--clip-grad", "0.05"]


def test_ensemble_under_two_ranks_and_its_resume(tmp_path):
    """The two divisions sharded over the two ranks ({div 2, data 1}); the
    gathered checkpoint equals one process's; a resume from the first
    epoch's checkpoint, under two ranks, reproduces the uninterrupted run."""
    full, part, one = (str(tmp_path / n) for n in ("full", "part", "one"))
    run_ranks(f"{WORKER}:cli", 2, args=(ENS + ["--output_dir", full],), timeout=300)
    torch_run(ENS + ["--output_dir", one])
    assert_losses_close(full, one)
    a = restore(os.path.join(full, "checkpoint_temp.msgpack"))
    b = restore(os.path.join(one, "checkpoint_temp.msgpack"))
    assert np.asarray(a["backbone_params"]["pos_embed"]).shape[0] == 2  # gathered
    _assert_trees_close(a, b)
    assert _rank_files(full) == ["log_rank1.txt"]

    run_ranks(f"{WORKER}:cli", 2, args=(ENS + ["--output_dir", part], 1), timeout=300)
    run_ranks(f"{WORKER}:cli", 2, args=(ENS + ["--output_dir", part, "--resume",
                                               os.path.join(part, "checkpoint_temp.msgpack")],),
              timeout=300)
    c = restore(os.path.join(part, "checkpoint_temp.msgpack"))
    assert int(np.asarray(a["epoch"])) == int(np.asarray(c["epoch"])) == 1
    for key in ("backbone_params", "ens_params", "bb_opt_state", "ens_opt_state"):
        got, want = leaves(c[key]), leaves(a[key])
        for k in want:
            if want[k] is not None:
                assert np.abs(got[k] - want[k]).max() <= 1e-5, (key, k)
