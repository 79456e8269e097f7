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
inputs; the kernels past 256 keys at B 64, N 578, kh 6 (dedeit at 384
px): fused_attention, attention_bwd, attention_bwd_split and the dv and
dq/dk kernels, in bf16 and in f32 (beside SDPA's f32 forward and backward);
the same five calls past head width 128 at B 64, N 578, dh 192 (kh 4) and
dh 256 (kh 3), in both dtypes (at dh 192 also the device time of each kernel
one attention_bwd and one attention_bwd_split call launch, by
torch.profiler); the f32 kernels at N 198 and head widths 32,
64 and 128 (the forward at B 256, the backwards at B 64); the dedeit
stage-2 step at 384 px with the
kernels, bf16 at B 64 and f32 at B 16 (host clock over 3 steps after one);
fused_int8_matmul (bf16 in and out) at M 50688 (bs256 x 198 tokens) at every
distinct (K, N) of the deployed divisions' weight products, with each
layer's own quantized weights, summed over one int8 forward's 192 calls; and
the bf16 fused_block_attention at B 256, N 198, C 384 with kh 1-6, summed
over one forward's 48 layers at the deployed kh mix. Each turn also hashes
the outputs on fixed inputs (every timed call, and the forward and the
three backwards of every other path: f32 at N 198 and 578, head width 192
in both dtypes, bf16 dh 32 and 128; the block half in bf16 and f32, the
int8 matmul), so the script says which outputs the two checkouts' kernels
give the same bits. The block half is also timed at f32 at B 256, N 198,
kh 1-6 (summed at the deployed mix, as the bf16 one) and on its chunked
route in both dtypes at B 16, N 578: kh 6 at C 384, and kh 4 of head width
192 at C 768 (timed and hashed). Last, the SASS of every kernel of each side's library
(cuobjdump beside nvcc): instructions, HMMA instructions and a hash of the
opcode sequence, so a kernel whose source should compile unchanged can be
checked, and the kernels only one side has. Prints the card's name and
power limit, one JSON line per turn and the mean of each side's two turns.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

N, DH = 198, 64
FWD = [(256, kh) for kh in range(1, 7)] + [(64, 6), (64, 12)]
BWD = [(256, 6), (64, 6), (64, 12)]
SPLIT = [(64, 6), (256, 6)]
LONG = (64, 578, 6)  # B, N, kh of the kernels past 256 keys (dedeit at 384 px)
WIDE = ((64, 578, 4, 192), (64, 578, 3, 256))  # B, N, kh, dh past head width 128
# f32 (3xTF32 on the tensor cores): (head width, heads) at N 198, the
# forward at B 256, the backwards at B 64, as chip_smoke.py's [heads]
F32_HEADS = ((32, 12), (64, 6), (128, 6))
# outputs hashed, not timed: (dtype, B, N, heads, head width) of every other
# path: f32 at N 198 and 578 (dh 64; dh 32 and 128 past 256 keys), bf16 and
# f32 past head width 128, bf16 at dh 32 and 128
HASHED = ([("f32", 64, N, 6, 64), ("f32", 4, 578, 6, 64), ("f32", 2, 578, 12, 32),
           ("f32", 2, 578, 6, 128), ("bf16", 2, 578, 4, 192), ("f32", 2, 578, 4, 192),
           ("bf16", 16, N, 12, 32), ("bf16", 16, N, 6, 128)])
S384 = (("bfloat16", 64, 3), ("float32", 16, 3))  # dtype, B, timed steps: the 384-px steps
# B, N, kh, dh, C of the block half's chunked route (both dtypes): dedeit at
# 384 px, and heads of 192 at C 768
BLOCK_CHUNKED = ((16, 578, 6, 64, 384), (16, 578, 4, 192, 768))


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
                                                   attention_bwd_dv, attention_bwd_split,
                                                   fused_attention, fused_block_attention)
    from devit_tpu_torch.kernels.quant import fused_int8_matmul, quantize_weight

    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res, digest, by_kernel = {}, {}, {}
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

    B, n, kh = LONG
    for dt, tag in ((torch.bfloat16, ""), (torch.float32, " f32")):
        x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dt)
        g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").to(dt)
        for name, fn in (("fwd", lambda: fused_attention(x, num_heads=kh)),
                         ("bwd", lambda: attention_bwd(x, g, kh)),
                         ("split", lambda: attention_bwd_split(x, g, kh)),
                         ("dv", lambda: attention_bwd_dv(x, g, kh)),
                         ("dqdk", lambda: attention_bwd_dqdk(x, g, kh))):
            key = f"{name}{tag} B{B} N{n} kh{kh}"
            res[key] = _time_ms(torch, fn, iters=10 if name == "fwd" else 5, warmup=2)
            digest[key] = _digest(fn())
        if dt == torch.float32:  # SDPA's f32 forward and backward on the same inputs
            q, k, v = (t.contiguous().requires_grad_()
                       for t in x.view(B, n, 3, kh, DH).permute(2, 0, 3, 1, 4))
            out = sdpa(q, k, v)
            gh = g.view(B, n, kh, DH).transpose(1, 2)
            res[f"sdpa f32 B{B} N{n} kh{kh}"] = _time_ms(
                torch, lambda: sdpa(q.detach(), k.detach(), v.detach()), iters=10, warmup=2)
            res[f"sdpa bwd f32 B{B} N{n} kh{kh}"] = _time_ms(
                torch, lambda: torch.autograd.grad(out, (q, k, v), gh, retain_graph=True),
                iters=5, warmup=2)
            del q, k, v, out
    for (B, n, kh, dh), dt in ((w, d) for w in WIDE for d in (torch.bfloat16, torch.float32)):
        x = torch.randn((B, n, 3 * kh * dh), generator=gen, device="cuda").to(dt)
        g = torch.randn((B, n, kh * dh), generator=gen, device="cuda").to(dt)
        tag = "" if dt == torch.bfloat16 else " f32"
        for name, fn in (("fwd", lambda: fused_attention(x, num_heads=kh)),
                         ("bwd", lambda: attention_bwd(x, g, kh)),
                         ("split", lambda: attention_bwd_split(x, g, kh)),
                         ("dv", lambda: attention_bwd_dv(x, g, kh)),
                         ("dqdk", lambda: attention_bwd_dqdk(x, g, kh))):
            key = f"{name}{tag} B{B} N{n} kh{kh} dh{dh}"
            res[key] = _time_ms(torch, fn, iters=3, warmup=1)
            digest[key] = _digest(fn())
            if name in ("bwd", "split") and dh == WIDE[0][3]:
                by_kernel[key] = _device_ms_by_kernel(torch, fn)
        del x, g
    for dh, kh in F32_HEADS:  # f32 at N 198, every head width
        xf = torch.randn((256, N, 3 * kh * dh), generator=gen, device="cuda")
        x = torch.randn((64, N, 3 * kh * dh), generator=gen, device="cuda")
        g = torch.randn((64, N, kh * dh), generator=gen, device="cuda")
        for name, fn in (("fwd B256", lambda: fused_attention(xf, num_heads=kh)),
                         ("bwd B64", lambda: attention_bwd(x, g, kh)),
                         ("split B64", lambda: attention_bwd_split(x, g, kh)),
                         ("dv B64", lambda: attention_bwd_dv(x, g, kh)),
                         ("dqdk B64", lambda: attention_bwd_dqdk(x, g, kh))):
            key = f"{name} f32 N{N} kh{kh} dh{dh}"
            res[key] = _time_ms(torch, fn, iters=10, warmup=2)
            digest[key] = _digest(fn())
        del xf, x, g
    for dtype, B, n, kh, dh in HASHED:
        dt = torch.float32 if dtype == "f32" else torch.bfloat16
        x = torch.randn((B, n, 3 * kh * dh), generator=gen, device="cuda").to(dt)
        g = torch.randn((B, n, kh * dh), generator=gen, device="cuda").to(dt)
        for name, fn in (("fwd", lambda: fused_attention(x, num_heads=kh)),
                         ("bwd", lambda: attention_bwd(x, g, kh)),
                         ("dv", lambda: attention_bwd_dv(x, g, kh)),
                         ("dqdk", lambda: attention_bwd_dqdk(x, g, kh))):
            digest[f"{name} {dtype} B{B} N{n} kh{kh} dh{dh}"] = _digest(fn())
    for dt, n in ((torch.bfloat16, N), (torch.float32, N), (torch.float32, 578)):
        C, Kh, kh = 384, 6 * DH, 6
        r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        args = (r(4, n, C).to(dt), 1 + 0.1 * r(C), 0.1 * r(C), (0.05 * r(C, 3 * Kh)).to(dt),
                0.1 * r(3 * Kh), (0.05 * r(Kh, C)).to(dt), 0.1 * r(C))
        digest[f"block {str(dt)[6:]} N{n}"] = _digest(fused_block_attention(*args, num_heads=kh))
    for dtype, B, steps in S384:
        res[f"stage2 384px step {dtype} B{B}"] = _step_384(torch, getattr(torch, dtype), B, steps)

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
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731

    def block_args(dt, B, n, C, Kh):
        return (r(B, n, C).to(dt), 1 + 0.1 * r(C), 0.1 * r(C), (0.05 * r(C, 3 * Kh)).to(dt),
                0.1 * r(3 * Kh), (0.05 * r(Kh, C)).to(dt), 0.1 * r(C))

    for dt, tag in ((torch.bfloat16, ""), (torch.float32, " f32")):
        res[f"block forward{tag}"] = 0.0
        for kh in range(1, 7):
            args = block_args(dt, 256, N, 384, kh * DH)
            ms = _time_ms(torch, lambda: fused_block_attention(*args, num_heads=kh), iters=10,
                          warmup=2)
            res[f"block{tag} B256 kh{kh}"] = ms
            res[f"block forward{tag}"] += mix.get(kh, 0) * ms
    for (B, n, kh, dh, C), dt in ((c, d) for c in BLOCK_CHUNKED
                                  for d in (torch.bfloat16, torch.float32)):
        args = block_args(dt, B, n, C, kh * dh)
        key = f"block {str(dt)[6:]} B{B} N{n} kh{kh} dh{dh}"
        res[key] = _time_ms(torch, lambda: fused_block_attention(*args, num_heads=kh), iters=10,
                            warmup=2)
        digest[key] = _digest(fused_block_attention(*args, num_heads=kh))
    return {"ms": res, "digest": digest, "by_kernel": by_kernel}


def _device_ms_by_kernel(torch, fn) -> dict:
    """Device ms of each kernel that one call of fn launches (torch.profiler,
    after a warm-up call), by its name and template arguments; empty where
    the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"attn_\w+(?:<[^>]*>)?", e.key)
            key = m.group(0) if m else e.key[:60]
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3
    return out


def _step_384(torch, dtype, B: int, steps: int) -> float:
    """ms of the dedeit stage-2 step of `dtype` at 384 px (N 578), batch B,
    with the kernels: `steps` steps through train_epoch after one warm-up
    step, host clock ending in synchronize."""
    from devit_tpu_torch.data.mixup import MixupConfig
    from devit_tpu_torch.models.vit import create_vit
    from devit_tpu_torch.train.loop import train_epoch
    from devit_tpu_torch.train.optim import OptimConfig, make_optimizer
    from devit_tpu_torch.train.state import TrainState
    from devit_tpu_torch.train.steps import make_stage2_step

    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = (torch.randn((B, 384, 384, 3), generator=gen, device="cuda").to(dtype),
             torch.randint(0, 25, (B,), generator=gen, device="cuda"))
    model = create_vit("dedeit", img_size=384, num_classes=25, drop_path_rate=0.1,
                       dtype=dtype, use_kernel=True, use_remat=True, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_optimizer(OptimConfig(lr=5e-4, epochs=100), 100),
                              use_ema=True)
    mix = MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5,
                      label_smoothing=0.1, num_classes=25)
    step = make_stage2_step(model, None, mixup=mix, smoothing=0.1, distillation_type="none")
    ms = []
    for k in (1, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, _ = train_epoch(lambda st, im, lb, gn: step(st, None, im, lb, gn), state,
                                  [batch] * k, torch.Generator().manual_seed(k), epoch=0,
                                  log_fn=lambda *_: None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / k)
    return ms[-1]


def _digest(t) -> str:
    """sha256 of a tensor's values (bf16 widened to f32, which is exact)."""
    return hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()


def _kernel_name(fn: str) -> str:
    """A kernel's mangled name without its anonymous namespace (whose tag
    follows the source file, so it would differ between checkouts), with a
    readable alias for the kernels earlier PRs compared by name."""
    fn = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN", fn.strip())
    kinds = {"ILb1ELb1E": "monolithic", "ILb0ELb1E": "dv", "ILb1ELb0E": "dqdk"}
    dh = (re.search(r"attn_bwd_kernel_mmaILb\dELb\dELi(\d+)EE", fn)
          or re.search(r"attn_kernel_mmaILi\d+ELi(\d+)EE", fn))
    tag = f" dh {dh.group(1)}" if dh and dh.group(1) != "64" else ""
    if "attn_bwd_kernel_mma" in fn:  # head width: dh 64 keeps the bare name
        return next((k for mark, k in kinds.items() if mark in fn), "monolithic") + tag
    if "attn_kernel_mma" in fn:
        kc = re.search(r"attn_kernel_mmaILi(\d+)E", fn)
        return f"forward KC {kc.group(1) if kc else '?'}" + tag
    return fn


def sass_summary(root: Path) -> dict:
    """Per kernel of root's built library (every __global__ function, named
    by _kernel_name): SASS instructions, HMMA instructions and the sha256 of
    its opcode sequence (operands, addresses and the parameter layout left
    out)."""
    sys.path.insert(0, str(root))
    from devit_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build._lib_path())], capture_output=True,
                          text=True, check=True).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :", 1)[1])
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
    by_kernel = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        out = subprocess.run([sys.executable, __file__, args.old, args.new, "--child",
                              getattr(args, side)], capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"{side} turn failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
        turn = json.loads(out.stdout.strip().splitlines()[-1])
        turns[side].append(turn["ms"])
        digests[side].append(turn["digest"])
        by_kernel[side].append(turn["by_kernel"])
        print(side, json.dumps({k: round(v, 4) for k, v in turn["ms"].items()}))
        for call, ms in turn["by_kernel"].items():
            print(f"{side} {call}: device ms by kernel "
                  f"{', '.join(f'{k} {v:.4f}' for k, v in ms.items()) or 'not recorded'}")
    mean = {side: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]} for side, ts in turns.items()}
    for k in mean["new"]:
        print(f"{k:24s} old {mean['old'][k]:9.4f} ms  new {mean['new'][k]:9.4f} ms  "
              f"x{mean['old'][k] / mean['new'][k]:.2f}  [{card}]")
    # the same fixed inputs in every turn: each side's repeat gives its own
    # bits again, and the two sides compare output by output
    same = {k: digests["old"][0][k] == digests["new"][0][k] for k in digests["new"][0]}
    repeat = all(d == ds[0] for ds in digests.values() for d in ds)
    print(f"outputs bit-identical old vs new: {same}; differing: "
          f"{[k for k, v in same.items() if not v]}; each side's two turns identical: {repeat}")
    sass = {}
    for side in ("old", "new"):
        out = subprocess.run([sys.executable, __file__, args.old, args.new, "--sass",
                              getattr(args, side)], capture_output=True, text=True)
        sass[side] = json.loads(out.stdout) if out.returncode == 0 else out.stderr[-500:]
        if not isinstance(sass[side], dict):
            print(f"SASS of the {side} library failed: {sass[side]}")
    if all(isinstance(v, dict) for v in sass.values()):
        both = sorted(set(sass["old"]) & set(sass["new"]))
        changed = [k for k in both if sass["old"][k]["opcodes"] != sass["new"][k]["opcodes"]]
        print(f"SASS: {len(both)} kernels in both libraries, opcode sequence changed in "
              f"{len(changed)}: {changed}; only in old: {sorted(set(sass['old']) - set(both))}; "
              f"only in new: {sorted(set(sass['new']) - set(both))}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, turns=turns, mean=mean,
                                                  by_kernel=by_kernel, same_bits=same,
                                                  repeat=repeat, sass=sass), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
