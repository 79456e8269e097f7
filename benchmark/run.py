"""Run one cell of the benchmark of devit_tpu_torch once, on the card, and
print its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration and a traffic
mix; benchmark/core.py finds their files, the mix's driver, the cell's
limits and the per-layer readers by name. --trace 0 reports the cell's
end-to-end metrics, --trace 1 its per-layer metrics from a profiled slice
at the end of the window. The run exits non-zero and prints no result
where there is no card, where it fails, or where JAX or the JAX package
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a run may fill stays at a fixed place inside the checkout, so
# only a checkout's first run builds (the port's CUDA library builds into
# build/devit_tpu_torch_kernels there by itself)
_CACHE = ROOT / "build" / "benchmark_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(_CACHE / "inductor")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"  # a library that could load JAX by itself does not


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import core

    manifest = core.load_json(ROOT / "BENCHMARK.json")
    cell = core.Cell.from_manifest(manifest, args.workload, seed=args.seed,
                                   seconds=args.seconds, trace=bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    result = core.run(cell, T_START)
    if result is None:
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
