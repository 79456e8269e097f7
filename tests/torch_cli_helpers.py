"""Shared pieces of tests/test_torch_cli_stages.py and
tests/test_torch_cli_stages_late.py: the toy geometry's flags, both CLIs'
runners, and the JAX CLI's runs the port's stages are held to."""

import json
import os

import numpy as np
import pytest

from devit_tpu.cli.__main__ import build_parser as jax_parser
from devit_tpu_torch.cli.__main__ import main as torch_main

MODEL = ["--model", "dedeit", "--input-size", "32", "--patch-size", "4", "--embed-dim", "32",
         "--depth", "2", "--num-heads", "4", "--drop-path", "0.0", "--dtype", "float32"]
OPT = ["--batch-size", "32", "--eval-batch-size", "64", "--epochs", "2", "--warmup-epochs",
       "0", "--cooldown-epochs", "0", "--lr", "2e-3", "--no-scale-lr"]
DATA = ["--dataset", "synthetic:8:256:32", "--num_division", "2"]
NO_DRAWS = ["--no-aug", "--mixup", "0", "--cutmix", "0", "--reprob", "0", "--color-jitter", "0",
            "--no-repeated-aug", "--aa", ""]
LR = 2e-3
LOSS_RTOL = 1e-5
SHRINK = ["--population", "4", "--shrink-ratio", "0.45", "--candidate-chunk", "2"]


def jax_run(argv):
    args = jax_parser().parse_args(argv)
    return args.fn(args)


def torch_run(argv):
    return torch_main(argv + ["--device", "cpu"])


def stats(path):
    with open(os.path.join(path, "log_stats.txt")) as f:
        return [json.loads(line) for line in f]


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    if tree is None:
        return {prefix: None}
    return {prefix: np.asarray(tree.float() if hasattr(tree, "float") and not isinstance(
        tree, np.ndarray) else tree, np.float64)}


def restore(path):
    from devit_tpu_torch.io.checkpoint import restore_pytree

    return restore_pytree(path)


def assert_losses_close(got_dir, want_dir, keys=("train_loss", "test_loss"), rtol=LOSS_RTOL,
                         epochs=None):
    got, want = stats(got_dir), stats(want_dir)
    if epochs is not None:
        got = [r for r in got if r["epoch"] in epochs]
        want = [r for r in want if r["epoch"] in epochs]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] and got
    for g, w in zip(got, want):
        for k in keys:
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (k, g, w)
        assert g["test_acc1"] == w["test_acc1"], (g, w)


def assert_params_close(got_path, want_path, steps, key="params"):
    got, want = leaves(restore(got_path)[key]), leaves(restore(want_path)[key])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert np.abs(got[k] - want[k]).max() <= steps * LR, k


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Toy-size ops: two intra-op threads keep the test workers (and JAX's
    threads beside them) from oversubscribing the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)



def jax_inputs(root: str, epochs: int = 2) -> dict:
    """A JAX-written init checkpoint at the toy geometry (4 classes, a
    division's), the JAX CLI's split, and its stage 2 (`epochs` epochs) and
    stage 3 of both divisions under root/jax."""
    import jax
    import jax.numpy as jnp

    from devit_tpu.cli import common as JC
    from devit_tpu.io.checkpoint import save_pytree

    args = jax_parser().parse_args(["train_sub", *MODEL, *DATA])
    model = JC.build_model("dedeit", 4, args)
    params = model.init(jax.random.key(3), jnp.zeros((2, 32, 32, 3)))["params"]
    init = os.path.join(root, "init.msgpack")
    save_pytree(init, {"params": params})
    j = os.path.join(root, "jax")
    manifest = jax_run(["split", *DATA, "--output_dir", j])
    opt = OPT[:OPT.index("--epochs") + 1] + [str(epochs)] + OPT[OPT.index("--epochs") + 2:]
    for d in range(2):
        jax_run(["train_sub", *MODEL, *opt, *DATA, *NO_DRAWS, "--manifest", manifest,
                 "--model-path", init, "--start-division", str(d),
                 "--output_dir", os.path.join(j, f"sub-model{d}")])
    for d in range(2):
        jax_run(["shrink", *MODEL, *OPT, *DATA, *SHRINK, "--manifest", manifest,
                 "--model-path", os.path.join(j, f"sub-model{d}", "checkpoint.msgpack"),
                 "--start-division", str(d), "--output_dir", os.path.join(j, f"shrink{d}")])
    return dict(root=root, jax=j, init=init, manifest=manifest)
