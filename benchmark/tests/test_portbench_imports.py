"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's), and
the plain reference loads nothing of the program under test."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import core

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imported_roots(path) & core.FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    roots = imported_roots(path)
    assert "devit_tpu_torch" not in roots and not roots & core.FORBIDDEN
    text = path.read_text()
    assert "benchmark.drivers" not in text and "benchmark.weights" not in text


def test_the_name_check_compares_whole_top_level_names():
    names = ["devit_tpu_torch", "devit_tpu_torch.models.vit", "jaxtyping", "flaxen",
             "devit_tpu", "devit_tpu.models", "jax.numpy", "jaxlib", "optax", "flax.linen"]
    assert core.forbidden_modules(names) == sorted(
        ["devit_tpu", "devit_tpu.models", "jax.numpy", "jaxlib", "optax", "flax.linen"])


def test_loading_every_driver_and_reader_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import core\n"
        "for p in sorted((core.HERE / 'drivers').glob('*.py')) + "
        "sorted((core.HERE / 'metrics').glob('*.py')): core.load_module(p)\n"
        "import devit_tpu_torch.serving.daemon, devit_tpu_torch.train.steps\n"
        "print(core.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
