"""A configuration, a traffic mix, a cell and a per-layer metric are added as
new files and new entries only, in a copy of the benchmark, and a run of the
new cell (on the CPU, its look for a card skipped) finds each by name and
reports the new metric. No file that was there changes."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

READER = '''"""served_images.tiny: the images answered in the window."""


def read(ctx):
    return float(ctx["images"]) if ctx.get("images") else None
'''


def digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_mix_and_metric_added_by_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = digest(bench)

    cfg = json.loads((bench / "configs" / "dedeit_ens4.json").read_text())
    cfg.update(name="dedeit_tiny2", img_size=32, patch_size=8, embed_dim=32, depth=1,
               num_heads=2, divisions=2, neuron_multiple=32,
               policy={"heads": [[1], [2]], "neurons": [[40], [128]]},
               ensemble={"family": "deit", "teacher_size": 16, "num_classes": 5})
    cfg["serving"] = {**cfg["serving"], "buckets": [1, 4], "dtype": "float32"}
    (bench / "configs" / "dedeit_tiny2.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "closed_3x2.json").write_text(json.dumps(
        {"driver": "serve_closed", "clients": 3, "images_per_request": 2, "pool_images": 16,
         "sample_requests": 4, "trace_s": 0.5}))
    (bench / "limits" / "tiny2_batch.json").write_text(json.dumps({"logit_err": 1e-4}))
    (bench / "metrics" / "served_images.tiny.py").write_text(READER)

    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "dedeit_tiny2", "source": "https://example.org/tiny",
                                "file": "benchmark/configs/dedeit_tiny2.json", "reduced": [],
                                "why": "a test's"})
    manifest["workloads"].append({"name": "tiny2_batch", "config": "dedeit_tiny2",
                                  "traffic": "closed_3x2", "chips": 1, "why": "a test's"})
    for m in manifest["end_to_end"]:
        if m["name"] == "serve_img_per_s":
            m["workloads"].append("tiny2_batch")
    manifest["per_layer"].append({"name": "served_images.tiny", "unit": "img",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "batcher", "moves": "serve_img_per_s",
                                  "workloads": ["tiny2_batch"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    code = (
        "import json, sys, time\n"
        "sys.path.insert(0, %r)\n"
        "sys.path.append(%r)  # the program under test, from the checkout\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import core\n"
        "assert core.HERE == core.ROOT / 'benchmark' and str(core.ROOT) == %r\n"
        "manifest = core.load_json(core.ROOT / 'BENCHMARK.json')\n"
        "out = {}\n"
        "for trace in (False, True):\n"
        "    cell = core.Cell.from_manifest(manifest, 'tiny2_batch', seed=7, seconds=1.0,\n"
        "                                   trace=trace, device='cpu')\n"
        "    out[str(trace)] = core.run(cell, time.perf_counter())\n"
        "print(json.dumps(out))\n" % (str(tmp_path), str(ROOT), str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    plain, traced = out["False"], out["True"]
    assert plain["correct"] and set(plain["metrics"]) == {"serve_img_per_s", "setup_s"}
    assert traced["correct"] and set(traced["metrics"]) == {"served_images.tiny"}
    assert traced["metrics"]["served_images.tiny"]["value"] > 0
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
