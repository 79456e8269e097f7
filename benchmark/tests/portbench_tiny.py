"""Tiny cells for the benchmark's CPU tests: the cells' own traffic mixes
and settings at a geometry the CPU runs in seconds (32 px images, width 32,
two layers)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark import core

BENCH = Path(__file__).resolve().parents[1]
TINY = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, num_classes=10)
# the open-loop cell whose files are ready but which BENCHMARK.json does not
# list (PERF.md, Open questions): the entries a later change would add
ONLINE = "serve_ens4_online"
ONLINE_ENTRIES = {
    "workloads": [{"name": ONLINE, "config": "dedeit_ens4", "traffic": "poisson_online",
                   "chips": 1, "why": "open-loop Poisson arrivals at 0.8 of the knee"}],
    "end_to_end": [{"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": [ONLINE]}],
    "per_layer": [{"name": name, "unit": unit, "better": better, "source": source,
                   "layer": layer, "moves": "serve_p95_ms", "workloads": [ONLINE]}
                  for name, unit, better, source, layer in (
                      ("images_per_batch.online", "img", "higher", "program_counter", "batcher"),
                      ("bucket_fill.online", "%", "higher", "program_counter", "engine"),
                      ("idle_share.online", "%", "lower", "device_trace", "device"))],
}


def manifest(with_online: bool = False) -> dict:
    m = core.load_json(BENCH.parent / "BENCHMARK.json")
    if with_online:
        for key, entries in ONLINE_ENTRIES.items():
            m[key] = m[key] + entries
    return m


def tiny_cell(workload: str, *, seed: int = 1234567891011, seconds: float = 1.5,
              dtype: str = "float32", **traffic) -> core.Cell:
    """The workload's cell from BENCHMARK.json, shrunk: the configuration's
    geometry to TINY, the traffic's sizes to the CPU's pace."""
    cell = core.Cell.from_manifest(manifest(workload == ONLINE), workload, seed=seed,
                                   seconds=seconds, device="cpu")
    cfg = copy.deepcopy(cell.config)
    cfg.update(TINY)
    if "serving" in cfg:
        cfg.update(divisions=2, neuron_multiple=32,
                   policy={"heads": [[1, 0], [2, 1]], "neurons": [[40, 0], [128, 70]]},
                   ensemble={**cfg["ensemble"], "teacher_size": 24, "num_classes": 12})
        cfg["serving"] = {**cfg["serving"], "dtype": dtype, "buckets": [1, 4, 8]}
        tr = {**cell.traffic, "pool_images": 64, "sample_requests": 6}
        if tr["driver"] == "serve_closed":
            tr.update(clients=3, images_per_request=4)
        else:
            tr.update(rate_img_s=60.0, max_images=6)
    else:
        cfg["dtype"] = dtype
        cfg["optimizer"] = {**cfg["optimizer"], "steps_per_epoch": 4}
        tr = {**cell.traffic, "batch": 8, "img_size": 32}
    tr.update(traffic)
    cell.config, cell.traffic = cfg, tr
    return cell


def as_json(obj) -> str:
    return json.dumps(obj, indent=1, default=str)
