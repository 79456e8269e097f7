"""The port's command line (devit_tpu_torch/cli/__main__.py build_parser)
against the JAX CLI's (devit_tpu/cli/__main__.py): the same subcommands,
and for each, parametrised, the same option strings, destinations,
defaults, choices and arities, and the same parsed defaults. The only
expected difference is the port's --device {cuda,cpu}. Also the
subcommands that raise name their ROADMAP items, and the CCT family, which
raised until it was ported, runs."""

import argparse
import os

import numpy as np
import pytest

from devit_tpu.cli.__main__ import build_parser as jax_parser
from devit_tpu_torch.cli.__main__ import build_parser as torch_parser
from devit_tpu_torch.cli.__main__ import main

SUBCOMMANDS = ["split", "train_sub", "shrink", "distill", "ensemble", "bench", "pipeline",
               "deploy", "ingest", "serve", "convert", "inspect"]
# the positionals and required options a bare parse needs
MINIMAL = {"serve": ["--compact-path", "x"], "convert": ["a.msgpack", "b.msgpack"],
           "inspect": ["a.msgpack"]}


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(sp):
    return {tuple(a.option_strings) or (a.dest,):
            (a.dest, a.default, a.choices, a.nargs, a.required, type(a).__name__)
            for a in sp._actions if not isinstance(a, argparse._HelpAction)}


def test_the_same_subcommands():
    assert list(_subparsers(torch_parser())) == SUBCOMMANDS
    assert list(_subparsers(jax_parser())) == SUBCOMMANDS


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_options_and_defaults_equal_the_jax_cli(name):
    tsp, jsp = _subparsers(torch_parser())[name], _subparsers(jax_parser())[name]
    got, want = _options(tsp), _options(jsp)
    device = got.pop(("--device",))
    assert device == ("device", "cuda", ["cuda", "cpu"], None, False, "_StoreAction")
    assert got == want
    argv = [name] + MINIMAL.get(name, [])
    parsed = {k: v for k, v in vars(torch_parser().parse_args(argv)).items() if k != "fn"}
    expected = {k: v for k, v in vars(jax_parser().parse_args(argv)).items() if k != "fn"}
    assert parsed.pop("device") == "cuda"
    assert parsed == expected


def test_bench_and_cct_raise_naming_their_items(tmp_path):
    """`bench` still raises naming its item (Queue 1 item 1). The CCT family,
    which raised naming item 7 until it was ported, now runs: a CCT
    train_sub at a toy size writes its checkpoint, the 'decct' names give
    the headless backbone, and create_model builds the registry's CCTs."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        main(["bench", "--device", "cpu"])
    out = tmp_path / "sub"
    best = main(["train_sub", "--device", "cpu", "--model", "cct_2_3x2_32", "--input-size", "32",
                 "--embed-dim", "32", "--depth", "1", "--num-heads", "2", "--drop-path", "0",
                 "--dataset", "synthetic:4:64:32", "--num_division", "1", "--batch-size", "16",
                 "--epochs", "1", "--aa", "", "--no-repeated-aug", "--output_dir", str(out)])
    assert (out / "checkpoint.msgpack").exists() and best >= 0
    from devit_tpu_torch.cli import common as C
    from devit_tpu_torch.models import create_model
    from devit_tpu_torch.models.cct import CCT

    args = torch_parser().parse_args(["pipeline", "--model", "decct_7_3x1_32",
                                      "--input-size", "32"])
    cfg = C.model_config(args.model, 10, args)
    assert cfg.backbone and cfg.num_layers == 7 and C.model_seq_length(cfg) == 256
    model = create_model("cct_7_3x1_32", device="cpu")
    assert isinstance(model, CCT) and model.cfg.embed_dim == 256
    assert create_model("dedeit", device="cpu", depth=1).cfg.depth == 1


def test_cuda_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["train_sub", "--dataset", "synthetic:4:64:32", "--output_dir", str(tmp_path)])


def test_unported_options_raise(tmp_path, monkeypatch):
    from devit_tpu_torch import runtime
    from devit_tpu_torch.serving.daemon import ServeConfig

    # --ckpt-format orbax is ported: it parses, and its saver writes the
    # '.orbax' directory for the '.msgpack' name
    args = torch_parser().parse_args(["train_sub", "--device", "cpu", "--ckpt-format", "orbax",
                                      "--output_dir", str(tmp_path)])
    assert args.ckpt_format == "orbax"
    from devit_tpu_torch.cli.common import make_saver
    from devit_tpu_torch.io.checkpoint import restore_pytree, wait_for_checkpoints

    make_saver(args)(str(tmp_path / "checkpoint_temp.msgpack"), {"epoch": np.int32(0)})
    wait_for_checkpoints()
    assert os.path.isdir(tmp_path / "checkpoint_temp.orbax")
    assert int(restore_pytree(str(tmp_path / "checkpoint_temp.msgpack"))["epoch"]) == 0
    with pytest.raises(ValueError, match="AOT"):
        ServeConfig(aot_cache=True)
    # multi-process runs are ported (runtime.py); a coordinator without the
    # process count and id still raises, and no process group is left behind
    monkeypatch.setattr(runtime, "_DONE", False)
    monkeypatch.setenv("DEVIT_COORDINATOR", "localhost:1234")
    with pytest.raises(RuntimeError, match="DEVIT_NUM_PROCESSES"):
        runtime.setup_runtime()
    assert runtime.is_main_process() and not runtime.distributed()
