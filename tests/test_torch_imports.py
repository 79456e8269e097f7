"""The port stands alone: importing every module of devit_tpu_torch, and
chip_smoke.py's import graph, loads neither JAX (jax, flax, optax), nor the
msgpack package (the machine with the card has none; the port carries its
own codec), nor orbax, tensorstore, zstandard or ml_dtypes (the port reads
and writes orbax checkpoints itself, over the system's libzstd), nor
anything of the JAX package; and chip_smoke.py's import
graph loads no PIL (the card's machine is not known to have it: the port
imports it inside the functions that decode or augment on the host).
Checked in a fresh interpreter, since this test process has imported all of
them."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import devit_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "devit_tpu", "orbax", "tensorstore",
             "zstandard", "ml_dtypes")

_PROBE = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(devit_tpu_torch.__path__,
                                                        "devit_tpu_torch."))


def _top_level_modules_after_import(*modules):
    out = subprocess.run([sys.executable, "-c", _PROBE, *modules], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_port_module_is_listed():
    assert _port_modules() == [f"devit_tpu_torch.{m}" for m in (
        "cli", "cli.__main__", "cli.common", "cli.inspect_ckpt", "cli.stages",
        "configs", "core", "core.compact", "core.hsic", "core.metrics", "core.rank",
        "core.shrink", "data", "data.autoaugment", "data.datasets", "data.fine_grained",
        "data.host_augment", "data.mixup", "data.pipeline", "data.randaugment",
        "data.splitter", "deploy", "device", "entry", "io",
        "io.bridge", "io.checkpoint", "io.msgpack", "io.native", "io.ocdbt", "io.orbax",
        "io.zstd", "kernels", "kernels._build",
        "kernels.attention", "kernels.quant", "models", "models.cct",
        "models.compact_vit", "models.ensemble", "models.text", "models.vit", "parallel",
        "parallel.launch",
        "parallel.mesh", "parallel.serve", "runtime", "serving",
        "serving.daemon", "tracing", "train", "train.loop", "train.losses", "train.meters", "train.optim",
        "train.state", "train.steps", "utils_profile")]


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_no_jax_and_no_jax_package(target):
    modules = ["devit_tpu_torch", *_port_modules()] if target == "package" else ["chip_smoke"]
    loaded = _top_level_modules_after_import(*modules)
    assert "torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))
    if target == "chip_smoke":
        assert "PIL" not in loaded
