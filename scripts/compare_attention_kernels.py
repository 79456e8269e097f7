#!/usr/bin/env python3
"""Time the port's bf16 attention kernels of two checkouts on one GPU, in turns.

    python3 scripts/compare_attention_kernels.py OLD_ROOT NEW_ROOT [--out FILE]

Each root is the top of a checkout holding devit_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a git-ignored directory).
The turns run old, new, new, old, each in its own process (both packages
share one name), and each builds its own kernel library first. Per turn:
fused_attention at B 256 with kh 1-6 and at B 64 with kh 6 and 12,
attention_bwd at B 256 with kh 6 and at B 64 with kh 6 and 12, all at N 198,
bf16, by CUDA events over 30 launches after 3 warm-up launches, beside SDPA's
forward on the same inputs. Prints the card's name and power limit, one JSON
line per turn and the mean of each side's two turns.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

N, DH = 198, 64
FWD = [(256, kh) for kh in range(1, 7)] + [(64, 6), (64, 12)]
BWD = [(256, 6), (64, 6), (64, 12)]


def _time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def child(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    from devit_tpu_torch.kernels import _build
    from devit_tpu_torch.kernels.attention import attention_bwd, fused_attention

    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    for B, kh in FWD:
        x = torch.randn((B, N, 3 * kh * DH), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.contiguous() for t in x.view(B, N, 3, kh, DH).permute(2, 0, 3, 1, 4))
        res[f"fwd B{B} kh{kh}"] = _time_ms(torch, lambda: fused_attention(x, num_heads=kh))
        res[f"sdpa B{B} kh{kh}"] = _time_ms(torch, lambda: sdpa(q, k, v))
    for B, kh in BWD:
        x = torch.randn((B, N, 3 * kh * DH), generator=gen, device="cuda").bfloat16()
        g = torch.randn((B, N, kh * DH), generator=gen, device="cuda").bfloat16()
        res[f"bwd B{B} kh{kh}"] = _time_ms(torch, lambda: attention_bwd(x, g, kh))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve())))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    turns = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        out = subprocess.run([sys.executable, __file__, args.old, args.new, "--child",
                              getattr(args, side)], capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"{side} turn failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        turns[side].append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(side, json.dumps({k: round(v, 4) for k, v in turns[side][-1].items()}))
    mean = {side: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]} for side, ts in turns.items()}
    for k in mean["new"]:
        print(f"{k:16s} old {mean['old'][k]:8.4f} ms  new {mean['new'][k]:8.4f} ms  "
              f"x{mean['old'][k] / mean['new'][k]:.2f}  [{card}]")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, turns=turns, mean=mean), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
