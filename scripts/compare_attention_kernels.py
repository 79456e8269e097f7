#!/usr/bin/env python3
"""Time the port's hand-written kernels of two checkouts on one GPU, in turns.

    python3 scripts/compare_attention_kernels.py OLD_ROOT NEW_ROOT [--out FILE]

Each root is the top of a checkout holding devit_tpu_torch/ (for example the
parent commit unpacked with `git archive` into a git-ignored directory).
The turns run old, new, new, old, each in its own process (both packages
share one name), and each builds its own kernel library first. Per turn:
fused_attention at B 256 with kh 1-6 and at B 64 with kh 6 and 12,
attention_bwd at B 256 with kh 6 and at B 64 with kh 6 and 12, and the split
pair (attention_bwd_dv, attention_bwd_dqdk) at B 64 with kh 6 (the stage-5
step's shape) and B 256 with kh 6, all at N 198, bf16, by CUDA events over 30
launches after 3 warm-up launches queued behind a spin kernel (device time,
without the host's launch overhead), beside SDPA's forward on the same
inputs;
fused_int8_matmul (bf16 in and out) at M 50688 (bs256 x 198 tokens) at every
distinct (K, N) of the deployed divisions' weight products, with each
layer's own quantized weights, summed over one int8 forward's 192 calls; and
the bf16 fused_block_attention at B 256, N 198, C 384 with kh 1-6, summed
over one forward's 48 layers at the deployed kh mix. Each turn also hashes
the outputs on fixed inputs (the forward, the backwards, the int8 matmul),
so the script says whether the two checkouts' kernels give the same bits.
Last, the SASS of each side's bf16 attention kernels (cuobjdump beside
nvcc): instructions, HMMA instructions and a hash of the opcode sequence,
so a kernel whose source should compile unchanged can be checked. Prints
the card's name and power limit, one JSON line per turn and the mean of each
side's two turns.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

N, DH = 198, 64
FWD = [(256, kh) for kh in range(1, 7)] + [(64, 6), (64, 12)]
BWD = [(256, 6), (64, 6), (64, 12)]
SPLIT = [(64, 6), (256, 6)]


def _time_ms(torch, fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around `iters` calls queued
    behind a ~3 ms spin kernel, so the host's launch overhead (a few tens of
    microseconds a wrapper call, more than the smallest int8 calls' device
    time) stays out of the kernels' times on both sides."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def child(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch
    from devit_tpu_torch import deploy
    from devit_tpu_torch.kernels import _build
    from devit_tpu_torch.kernels.attention import (attention_bwd, attention_bwd_dqdk,
                                                   attention_bwd_dv, fused_attention,
                                                   fused_block_attention)
    from devit_tpu_torch.kernels.quant import fused_int8_matmul, quantize_weight

    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res, digest = {}, {}
    for B, kh in FWD:
        x = torch.randn((B, N, 3 * kh * DH), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.contiguous() for t in x.view(B, N, 3, kh, DH).permute(2, 0, 3, 1, 4))
        res[f"fwd B{B} kh{kh}"] = _time_ms(torch, lambda: fused_attention(x, num_heads=kh))
        res[f"sdpa B{B} kh{kh}"] = _time_ms(torch, lambda: sdpa(q, k, v))
        digest[f"fwd B{B} kh{kh}"] = _digest(fused_attention(x, num_heads=kh))
    for B, kh in BWD:
        x = torch.randn((B, N, 3 * kh * DH), generator=gen, device="cuda").bfloat16()
        g = torch.randn((B, N, kh * DH), generator=gen, device="cuda").bfloat16()
        res[f"bwd B{B} kh{kh}"] = _time_ms(torch, lambda: attention_bwd(x, g, kh))
        digest[f"bwd B{B} kh{kh}"] = _digest(attention_bwd(x, g, kh))
    for B, kh in SPLIT:
        x = torch.randn((B, N, 3 * kh * DH), generator=gen, device="cuda").bfloat16()
        g = torch.randn((B, N, kh * DH), generator=gen, device="cuda").bfloat16()
        for name, fn in (("dv", attention_bwd_dv), ("dqdk", attention_bwd_dqdk)):
            res[f"{name} B{B} kh{kh}"] = _time_ms(torch, lambda: fn(x, g, kh))
            digest[f"{name} B{B} kh{kh}"] = _digest(fn(x, g, kh))

    _, cms, _ = deploy.build_artifacts(device="cuda")
    weights, calls, mix = {}, {}, {}
    for cm in cms:
        for lp in cm.layers:
            mix[lp.num_heads] = mix.get(lp.num_heads, 0) + 1
            for name in ("qkv", "proj", "fc1", "fc2"):
                kern = getattr(lp, f"{name}_kernel")
                shape = tuple(kern.shape)
                weights.setdefault(shape, (kern, getattr(lp, f"{name}_bias")))
                calls[shape] = calls.get(shape, 0) + 1
    M = 256 * N
    res["int8 forward"] = 0.0
    for (K, Nn), (kern, bias) in sorted(weights.items()):
        qw = quantize_weight(kern, bias)
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        ms = _time_ms(torch, lambda: fused_int8_matmul(x, qw), iters=10, warmup=2)
        res[f"int8 M{M} K{K} N{Nn}"] = ms
        res["int8 forward"] += calls[(K, Nn)] * ms
        digest[f"int8 K{K} N{Nn}"] = _digest(fused_int8_matmul(x, qw))
    res["block forward"] = 0.0
    for kh in range(1, 7):
        C, Kh = 384, kh * DH
        r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        args = (r(256, N, C).bfloat16(), 1 + 0.1 * r(C), 0.1 * r(C),
                (0.05 * r(C, 3 * Kh)).bfloat16(), 0.1 * r(3 * Kh), (0.05 * r(Kh, C)).bfloat16(),
                0.1 * r(C))
        ms = _time_ms(torch, lambda: fused_block_attention(*args, num_heads=kh), iters=10,
                      warmup=2)
        res[f"block B256 kh{kh}"] = ms
        res["block forward"] += mix.get(kh, 0) * ms
    return {"ms": res, "digest": digest}


def _digest(t) -> str:
    """sha256 of a tensor's values (bf16 widened to f32, which is exact)."""
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()


def sass_summary(root: Path) -> dict:
    """Per bf16 attention kernel of root's built library (attn_kernel_mma
    and attn_bwd_kernel_mma, named by their instantiations): SASS
    instructions, HMMA instructions and the sha256 of its opcode sequence
    (operands, addresses and the parameter layout left out)."""
    sys.path.insert(0, str(root))
    from devit_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build._lib_path())], capture_output=True,
                          text=True, check=True).stdout
    kinds = {"ILb1ELb1E": "monolithic", "ILb0ELb1E": "dv", "ILb1ELb0E": "dqdk"}
    ops, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1]
            name = None
            # head width: a last int template argument (a checkout that
            # instantiates dh 64 alone has none); dh 64 keeps the bare name
            dh = (re.search(r"attn_bwd_kernel_mmaILb\dELb\dELi(\d+)EE", fn)
                  or re.search(r"attn_kernel_mmaILi\d+ELi(\d+)EE", fn))
            tag = f" dh {dh.group(1)}" if dh and dh.group(1) != "64" else ""
            if "attn_bwd_kernel_mma" in fn:  # a template instantiation, or a plain kernel
                name = next((k for mark, k in kinds.items() if mark in fn), "monolithic") + tag
                ops[name] = []
            elif "attn_kernel_mma" in fn:  # the forward, one instantiation per KC (and dh)
                kc = re.search(r"attn_kernel_mmaILi(\d+)E", fn)
                name = f"forward KC {kc.group(1) if kc else '?'}" + tag
                ops[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[name].append(m.group(2))
    return {k: dict(instructions=len(v), hmma=sum(o.startswith("HMMA") for o in v),
                    opcodes=hashlib.sha256(" ".join(v).encode()).hexdigest()[:16])
            for k, v in ops.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--sass", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve())))
        return 0
    if args.sass:
        print(json.dumps(sass_summary(Path(args.sass).resolve())))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    turns = {"old": [], "new": []}
    digests = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        out = subprocess.run([sys.executable, __file__, args.old, args.new, "--child",
                              getattr(args, side)], capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"{side} turn failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        turns[side].append(turn["ms"])
        digests[side].append(turn["digest"])
        print(side, json.dumps({k: round(v, 4) for k, v in turn["ms"].items()}))
    mean = {side: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]} for side, ts in turns.items()}
    for k in mean["new"]:
        print(f"{k:24s} old {mean['old'][k]:9.4f} ms  new {mean['new'][k]:9.4f} ms  "
              f"x{mean['old'][k] / mean['new'][k]:.2f}  [{card}]")
    # the same fixed inputs in every turn: each side's repeat gives its own
    # bits again, and the two sides compare output by output
    same = {k: digests["old"][0][k] == digests["new"][0][k] for k in digests["new"][0]}
    repeat = all(d == ds[0] for ds in digests.values() for d in ds)
    print(f"outputs bit-identical old vs new: {same}; each side's two turns identical: {repeat}")
    sass = {}
    for side in ("old", "new"):
        out = subprocess.run([sys.executable, __file__, args.old, args.new, "--sass",
                              getattr(args, side)], capture_output=True, text=True)
        sass[side] = json.loads(out.stdout) if out.returncode == 0 else out.stderr[-500:]
        print(f"SASS of the {side} bf16 attention kernels: {sass[side]}")
    if all(isinstance(v, dict) for v in sass.values()):
        unchanged = {k: v["opcodes"] == sass["old"].get(k, {}).get("opcodes")
                     for k, v in sass["new"].items()}
        print(f"SASS opcode sequence unchanged old vs new: {unchanged}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, turns=turns, mean=mean,
                                                  same_bits=same, repeat=repeat, sass=sass),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
