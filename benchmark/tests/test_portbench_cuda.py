"""The control on the card at each cell's own size: the reference computed
with float8 products in the program's place must fail the cell's limits,
on three seeds. Marked `cuda`; skips where there is no card."""

import pytest
import torch

from benchmark import core
from benchmark.drivers import _serving, train_steps

CELLS = [w["name"] for w in core.load_json(core.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_cells_limits(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    manifest = core.load_json(core.ROOT / "BENCHMARK.json")
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        cell = core.Cell.from_manifest(manifest, workload, seed=seed, seconds=1.0)
        tr = cell.traffic
        if tr["driver"] == "train_steps":
            want = train_steps.reference_steps(cell)
            numbers = train_steps.numbers(train_steps.reference_steps(cell, "fp8"), want)
        else:
            from benchmark import weights

            pool = weights.image_pool(tr["pool_images"], cell.config["img_size"], seed, "cuda")
            n = tr.get("images_per_request", tr.get("max_images"))
            chosen = [(16 * i, n, 0.0, 0.0, None) for i in range(tr["sample_requests"])]
            numbers = _serving.check(cell, chosen, pool, prec="fp8")
        ok, rows = core.judge(numbers, cell.limits)
        assert not ok, (seed, rows)
