"""The harness: finds a cell's configuration, traffic mix, driver, limits
and per-layer readers by their names in BENCHMARK.json, and turns what a
driver measured into the result line.

A cell is one entry of BENCHMARK.json's `workloads`. Everything that
belongs to one configuration, mix, metric or cell lives in a file of its
own, found by name:

    benchmark/configs/<config>.json    sizes, dtype, deployment
    benchmark/traffic/<traffic>.json   "driver" plus its parameters
    benchmark/drivers/<driver>.py      run(cell) -> Outcome
    benchmark/limits/<workload>.json   the limit of each number compared
    benchmark/metrics/<metric>.py      read(ctx) -> value or None

so a later change adds a cell, a mix or a metric with new files and new
entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
# top-level module names no run may load: JAX and the JAX package (compared
# whole, since the port's name begins with the JAX package's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "devit_tpu"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a Python file by its path (a driver or a metric's reader)."""
    name = "benchmark._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules (or `modules`) whose top-level name is forbidden."""
    names = list(sys.modules) if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"

    @classmethod
    def from_manifest(cls, manifest: dict, workload: str, root: Path = ROOT, **kw) -> "Cell":
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(cells)}")
        w = cells[workload]
        here = root / "benchmark"
        e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
        reported = {m["name"] for m in e2e}
        layer = [m for m in manifest["per_layer"]
                 if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
        limits_path = here / "limits" / f"{workload}.json"
        return cls(name=workload, config=load_json(here / "configs" / f"{w['config']}.json"),
                   traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                   chips=int(w["chips"]), end_to_end=e2e, per_layer=layer,
                   limits=load_json(limits_path) if limits_path.is_file() else {}, **kw)

    def log(self, msg: str) -> None:
        print(f"[{self.name}] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end values, the set-up's end
    (perf_counter), the requests or steps attempted and failed, the device's
    peak, the numbers compared with the reference, and what the per-layer
    readers read (`ctx`)."""

    e2e: Dict[str, float]
    window_start: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: Dict[str, float]
    ctx: Dict[str, Any] = dataclasses.field(default_factory=dict)


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Every number that has a limit must be there, finite and within it.
    The rows show each number compared beside its limit; one that is not
    finite shows as null. A number without a limit is a reading the cell
    does not compare (PERF.md says why)."""
    rows, ok = {}, bool(limits)
    for name in sorted(limits):
        value, limit = numbers.get(name), limits[name]
        finite = value is not None and math.isfinite(value)
        ok = ok and finite and value <= limit
        rows[name] = {"value": value if finite else None, "limit": limit}
    return ok, rows


def trace_plan(total: float, trace: bool, trace_s: float) -> Tuple[float, float]:
    """(seconds of the window before its traced slice starts, the slice's
    length): the last `trace_s` seconds, at most half the window, are traced
    in a --trace 1 run, counted from the moment the profiler has started."""
    slice_s = min(trace_s, total / 2) if trace else 0.0
    return total - slice_s, slice_s


def settle() -> None:
    """End a set-up: collect, then move every object the set-up made into
    the interpreter's permanent generation. A long-running server keeps
    such objects in its oldest generation, which it rarely scans; a fresh
    process would scan all of them about once in ten seconds, a 110-140 ms
    stop of every thread (measured on the card's host), inside the window."""
    gc.collect()
    gc.freeze()


class Spans:
    """Host spans the benchmark records around its calls into the program:
    (label, start, end) in perf_counter seconds, from any thread."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    def span(self, label: str, fn: Callable, *args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            self.items.append((label, t0, time.perf_counter()))


def run(cell: Cell, t_start: float) -> Optional[dict]:
    """Run the cell's driver and build the result line's object; None where
    a forbidden module was loaded (named on standard error). The numbers
    compared, each beside its limit, are the last lines on standard error and
    the result's last key."""
    import torch

    out = load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py").run(cell)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules were loaded: {bad}: no result", file=sys.stderr, flush=True)
        return None
    # a request that failed or never came is a wrong answer
    numbers = {**out.numbers, "failed": float(out.failed)}
    correct, rows = judge(numbers, {**cell.limits, "failed": 0.0})
    on_card = cell.device.startswith("cuda")
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed)}
    if cell.trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        trace = out.ctx.get("trace")
        if trace is not None:
            device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result.update(metrics=metrics, device=device)
        if trace is not None:
            result["breakdown"] = trace.breakdown()
    else:
        values = {**out.e2e, "setup_s": out.window_start - t_start}
        result.update(metrics={m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                               for m in cell.end_to_end}, device=device)
    for name in sorted(set(numbers) - set(rows)):
        print(f"reading {name}: {numbers[name]} (not compared)", file=sys.stderr)
    for name, row in rows.items():
        print(f"compared {name}: {row['value']} limit {row['limit']}", file=sys.stderr)
    result["compared"] = rows
    return result
