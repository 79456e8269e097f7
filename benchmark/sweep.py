"""Find the highest rate the server sustains under the open-loop mix: one
server built once, then one window at each offered rate.

    python3 benchmark/sweep.py --workload serve_ens4_online --seed <n> \\
        --seconds 8 --rates 1200,1500,1800

Prints one JSON line a rate: images offered and answered a second, the
latency percentiles, the sender's lateness, the batcher's queue at the
window's close, and the median latency of the window's last quarter of
requests against its first (a backlog that grows shows there). The
benchmark's runs do not run it; its table is in PERF.md.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark import core
    from benchmark.drivers import _serving, serve_open

    cell = core.Cell.from_manifest(core.load_json(ROOT / "BENCHMARK.json"), args.workload,
                                   seed=args.seed, seconds=args.seconds)
    spans = core.Spans()
    served = _serving.build(cell, spans)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic = {**cell.traffic, "rate_img_s": rate}
        w = serve_open.drive(cell, served, spans)
        reqs, t0, t1 = w["requests"], w["t0"], w["t1"]
        lat = serve_open.latencies_ms(reqs)
        q = max(1, len(lat) // 4)
        print(json.dumps({
            "rate_img_s": rate, "seconds": t1 - t0,
            "offered_img_s": sum(r[1] for r in reqs) / (t1 - t0),
            "answered_img_s": sum(r[1] for r in reqs if r[3] <= t1) / (t1 - t0),
            "requests": len(reqs), "failed": sum(r[4] is None for r in reqs),
            "p50_ms": serve_open.percentile(lat, 50), "p95_ms": serve_open.percentile(lat, 95),
            "p99_ms": serve_open.percentile(lat, 99),
            "p50_first_quarter_ms": serve_open.percentile(lat[:q], 50),
            "p50_last_quarter_ms": serve_open.percentile(lat[-q:], 50),
            "queue_at_close": w["snaps"][1]["queue_depth"],
            "sender_late_max_ms": max(w["late"]) * 1e3,
            "images_per_batch": ((w["snaps"][1]["images"] - w["snaps"][0]["images"])
                                 / max(1, w["snaps"][1]["batches"] - w["snaps"][0]["batches"]))}),
            flush=True)
    _serving.release(served)
    return 0


if __name__ == "__main__":
    sys.exit(main())
