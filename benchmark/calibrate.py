"""The readings the limits of `correct` are set from, on the card at the
cell's own size: for each seed, the program's numbers (a short window of
the cell's own load, then the benchmark's comparison), the control's (the
reference in float8 in the program's place) and, in a training cell, those
of the step with half of the batch left out, the mean taken over the rest.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3

Prints one JSON line a seed. The benchmark's runs do not run it; PERF.md
keeps the readings and the limits set from them.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def leaf_detail(got: dict, want: dict, top: int = 6) -> list:
    """The leaves with the widest change gaps, with the qkv bias's query,
    key and value thirds apart."""
    rows = []
    for k, w in want["after"].items():
        dw = w - want["before"][k]
        dg = got["after"][k] - want["before"][k]
        g = float(want["first_grads"][k].norm())
        rows.append((k, float(dg.norm()), float(dw.norm()), g))
        if k.endswith("qkv.bias"):
            for i, part in enumerate("qkv"):
                n = dw.shape[0] // 3
                s = slice(i * n, (i + 1) * n)
                rows.append((f"{k}[{part}]", float(dg[s].norm()), float(dw[s].norm()),
                             float(want["first_grads"][k][s].norm())))
    rows.sort(key=lambda r: -abs(r[1] - r[2]) / max(r[2], 1e-30))
    return [list(r) for r in rows[:top]]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark import core
    from benchmark.drivers import _serving, train_steps

    manifest = core.load_json(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = core.Cell.from_manifest(manifest, args.workload, seed=seed, seconds=args.seconds)
        rec = {"workload": args.workload, "seed": seed}
        if cell.traffic["driver"] == "train_steps":
            def check(cell, got, rec=rec):
                want = train_steps.reference_steps(cell)
                rec["program"] = train_steps.numbers(got, want)
                rec["control"] = train_steps.numbers(train_steps.reference_steps(cell, "fp8"), want)
                rec["half"] = train_steps.numbers(
                    train_steps.reference_steps(cell, fault="half"), want)
                rec["leaves"] = leaf_detail(got, want)
                return rec["program"]
            train_steps.check = check
            out = train_steps.run(cell)
        else:
            original = _serving.check

            def check(cell, chosen, pool, original=original, rec=rec):
                rec["program"] = original(cell, chosen, pool)
                rec["control"] = original(cell, chosen, pool, prec="fp8")
                return rec["program"]
            _serving.check = check
            out = core.load_module(ROOT / "benchmark" / "drivers"
                                   / f"{cell.traffic['driver']}.py").run(cell)
            _serving.check = original
        rec.update(e2e=out.e2e, failed=out.failed, attempted=out.attempted)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
