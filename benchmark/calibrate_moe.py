"""The readings the limits of a sparse-expert training cell's `correct` are
set from, on the card at the cell's own size: for each seed, the program's
numbers (a short window of the cell's own load, then the benchmark's
comparison), the control's (the reference in float8, routing by its own
top-K, in the program's place, against the f32 reference routed by the
control's choices) and, on the first `--faults` seeds, the planted faults'
against the reference: half of the batch left out, a frozen step (no
update), and the program routing by the top-K of its noiseless logits.

    python3 benchmark/calibrate_moe.py --workload train_vmoe_l16_224 \\
        --seeds 1,2,3 --seconds 3 --faults 1

Prints one JSON line a seed. The benchmark's runs do not run it; PERF.md
keeps the readings and the limits set from them.
"""

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def noiseless_routing(moe):
    """Patch the port's router to choose by its noiseless logits (the gates
    keep the noise); returns the undo."""
    original = moe.route

    def route(x, router_kernel, k, seed, sigma, train):
        logits, noisy, gates, _ = original(x, router_kernel, k, seed, sigma, train)
        return logits, noisy, gates, moe.top_k(logits.detach(), k)

    moe.route = route
    return lambda: setattr(moe, "route", original)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", type=int, default=1, help="seeds (the first ones) with faults")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark import core
    from benchmark.drivers import train_moe_steps as d
    from devit_tpu_torch.models import moe

    manifest = core.load_json(ROOT / "BENCHMARK.json")

    def gaps(got, want, cell):
        before = d.before_leaves(cell)
        out = d.numbers(got, want, before)
        del before
        gc.collect()
        return out

    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        cell = core.Cell.from_manifest(manifest, args.workload, seed=seed, seconds=args.seconds)
        rec = {"workload": args.workload, "seed": seed}
        out, got = d.drive(cell)
        rec.update(e2e=out.e2e, memory_peak_bytes=out.memory_peak_bytes,
                   dropped=out.ctx["route_counts"])
        want = d.reference_steps(cell, routing=got["routing"], host=True)
        rec["program"] = gaps(got, want, cell)
        rec["losses"] = {"program": got["losses"], "reference": want["losses"]}
        if n < args.faults:
            for fault in ("half", "frozen"):
                bad = d.reference_steps(cell, fault=fault, routing=got["routing"], host=True)
                rec[fault] = gaps(bad, want, cell)
                del bad
        del got, want
        gc.collect()
        ctl = d.reference_steps(cell, "fp8", record=True, host=True)
        want = d.reference_steps(cell, routing=ctl["routing"], host=True)
        rec["control"] = gaps(ctl, want, cell)
        del ctl, want
        gc.collect()
        if n < args.faults:
            undo = noiseless_routing(moe)
            try:
                fast = core.Cell.from_manifest(manifest, args.workload, seed=seed, seconds=0.5)
                _, got = d.drive(fast)
            finally:
                undo()
            want = d.reference_steps(cell, routing=got["routing"], host=True)
            rec["noiseless"] = gaps(got, want, cell)
            del got, want
            gc.collect()
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
