#!/usr/bin/env python3
"""Drive the PyTorch port (devit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout. It builds the CUDA kernels from the
sources in the checkout, holds each kernel against its plain PyTorch version
on the card, runs the deployed 4-division dedeit ensemble at full width,
serves it over HTTP to concurrent clients, times the kernels and the
forward, and runs the stage-2 training step of full-width dedeit at bs256
(remat, mixup/cutmix, AdamW, EMA) through train_epoch, with the attention
forward and backward kernels, against the same step with the plain
attention. Any failure raises and exits non-zero; so does a machine without
CUDA, or a directory that holds this script without the package.

The last lines of standard output are the card's name and power limit (as
nvidia-smi gives them), one JSON line with the kernels' record, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from devit_tpu_torch import deploy
from devit_tpu_torch.data.mixup import MixupConfig
from devit_tpu_torch.data.pipeline import normalize
from devit_tpu_torch.kernels import _build
from devit_tpu_torch.kernels.attention import (
    attention_bwd, fused_attention, make_trainable_attention, reference_attention,
    reference_attention_bwd,
)
from devit_tpu_torch.models.compact_vit import stack_division_features
from devit_tpu_torch.models.vit import create_vit
from devit_tpu_torch.serving.daemon import InferenceEngine, ServeConfig, build_server
from devit_tpu_torch.train.loop import train_epoch
from devit_tpu_torch.train.optim import OptimConfig, make_optimizer
from devit_tpu_torch.train.state import TrainState
from devit_tpu_torch.train.steps import make_stage2_step

ROOT = Path(__file__).resolve().parent
N, DH = 198, 64  # tokens (196 patches + cls + dist) and head width of dedeit
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # max|got-want| / max|want|


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite values in the result")
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls."""
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


def _qkv(B: int, kh: int, dtype, gen, zero_head: bool = False) -> torch.Tensor:
    x = torch.randn((B, N, 3 * kh * DH), generator=gen, device="cuda")
    if zero_head:  # the all-zero dummy head of a layer that kept none
        C = kh * DH
        for third in range(3):
            lo = third * C + (kh - 1) * DH
            x[:, :, lo:lo + DH] = 0.0
    return x.to(dtype)


def phase_build() -> float:
    secs, log = _build.build()
    print(f"[build] nvcc {[f.name for f in _build.SOURCES]}:\n{log.strip()}")
    print(f"[build] kernel built in {secs:.2f} s")
    return secs


def phase_kernel_checks() -> float:
    """fused_attention (the kernel) vs reference_attention on the card, at
    the main path's N and dh, every kh it meets and one more, every serving
    bucket (1, 8, 32, 128, 256), remainder batches (7, 64), with and without
    a head gate, and with an all-zero head.
    Returns the largest max-abs error of the bf16 cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    max_abs_bf16 = 0.0
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for kh in range(1, 7):
            for B in (1, 7, 8, 32, 64, 128, 256):
                for case in ("plain", "gate", "zero_head"):
                    x = _qkv(B, kh, dtype, gen, zero_head=case == "zero_head")
                    gate = (torch.rand((kh,), generator=gen, device="cuda")
                            if case == "gate" else None)
                    got = fused_attention(x, gate, num_heads=kh)
                    torch.cuda.synchronize()
                    want = reference_attention(x, gate, num_heads=kh)
                    rel = _rel(got, want)
                    if rel > TOL[dtype]:
                        raise AssertionError(f"fused_attention {dtype} kh={kh} B={B} {case}: "
                                             f"rel err {rel:.3e} > {TOL[dtype]:.0e}")
                    if dtype == torch.bfloat16:
                        max_abs_bf16 = max(max_abs_bf16,
                                           float((got.float() - want.float()).abs().max()))
                    worst[dtype] = max(worst[dtype], rel)
                    n += 1
    print(f"[kernel] fused_attention vs plain: {n} cases pass; worst rel err "
          f"bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 {worst[torch.float32]:.3e} "
          f"(tol 1e-4); max abs err bf16 {max_abs_bf16:.3e}")
    return max_abs_bf16


def _forward(cms, ens, x, *, dtype, use_kernel, fast_math):
    cls_s, dist_s = stack_division_features(cms, x, patch_size=16, dtype=dtype,
                                            use_kernel=use_kernel, fast_math=fast_math)
    return ens(cls_s, dist_s).logits


@torch.inference_mode()
def phase_full_width(cms, ens) -> None:
    """The deployed ensemble at bs16: the forward through the kernel vs the
    same forward through the plain attention, with the divisions in bf16 and
    fast_math (the serving numerics) and in f32 with strict numerics (the
    fusion head keeps its own bf16 in both)."""
    imgs = np.random.default_rng(1).integers(0, 256, (16, 224, 224, 3), dtype=np.uint8)
    x = normalize(torch.from_numpy(imgs).cuda(), torch.float32)
    for dtype, fast, tol in ((torch.bfloat16, True, 2e-2), (torch.float32, False, 1e-3)):
        before = fused_attention.launches
        got = _forward(cms, ens, x, dtype=dtype, use_kernel=True, fast_math=fast)
        torch.cuda.synchronize()
        launches = fused_attention.launches - before
        if launches != 48:
            raise AssertionError(f"{launches} kernel launches in one forward, expected 48")
        want = _forward(cms, ens, x, dtype=dtype, use_kernel=False, fast_math=fast)
        if fused_attention.launches - before != 48:
            raise AssertionError("the plain forward launched the kernel")
        if got.shape != (16, 100) or got.dtype != torch.float32:
            raise AssertionError(f"logits {tuple(got.shape)} {got.dtype}, expected (16, 100) f32")
        rel = _rel(got, want)
        if rel > tol:
            raise AssertionError(f"full-width {dtype} forward: kernel vs plain rel {rel:.3e} > {tol}")
        print(f"[forward] full width bs16 {str(dtype)[6:]} fast_math={fast}: 48 launches, "
              f"kernel vs plain rel err {rel:.3e} (tol {tol})")


def _post(url: str, imgs: np.ndarray) -> dict:
    req = urllib.request.Request(url + "/predict", data=imgs.tobytes(),
                                 headers={"X-Image-Shape": ",".join(map(str, imgs.shape))})
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"/predict answered {r.status}")
        return json.loads(r.read())


def phase_serving(cms, ens) -> int:
    """The main path: InferenceEngine + MicroBatcher + HTTP on the card, six
    concurrent clients of mixed sizes (small ones coalesce; the largest is
    chunked above the 256 bucket). Returns the kernel launches it made."""
    engine = InferenceEngine(cms, ens, ServeConfig(), device="cuda")
    print(f"[serve] warm-up of buckets {engine.cfg.buckets}: {engine.warm_up():.2f} s")
    httpd, batcher = build_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % httpd.server_address[:2]
    sizes = (1, 3, 8, 20, 64, 300)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8) for n in sizes]
    try:
        fused_attention.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(sizes)) as pool:
            replies = list(pool.map(lambda b: _post(url, b), batches))
        wall = time.perf_counter() - t0
        launches = fused_attention.launches
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
        thread.join(timeout=30)
    if health.get("status") != "ok" or health.get("device") != "cuda":
        raise AssertionError(f"/healthz: {health}")
    min_forwards = -(-sum(sizes) // max(engine.cfg.buckets))
    if launches % 48 or launches < 48 * min_forwards:
        raise AssertionError(f"{launches} kernel launches while serving, expected a "
                             f"multiple of 48 and at least {48 * min_forwards}")
    for imgs, reply in zip(batches, replies):
        preds = reply["predictions"]
        if len(preds) != imgs.shape[0]:
            raise AssertionError(f"{len(preds)} predictions for {imgs.shape[0]} images")
        logits = torch.from_numpy(engine.predict(imgs))
        p = torch.softmax(logits, dim=-1)
        for i, pred in enumerate(preds):
            top = torch.tensor(pred["topk"])
            err = float((torch.tensor(pred["probs"]) - p[i, top]).abs().max() / p[i].max())
            if err > 2e-2 or p[i, top[0]] < p[i].max() * (1 - 2e-2):
                raise AssertionError(f"reply for image {i} of {imgs.shape[0]} disagrees with "
                                     f"engine.predict (rel {err:.3e})")
    print(f"[serve] {len(sizes)} concurrent POST /predict of {list(sizes)} images answered in "
          f"{wall:.2f} s and match engine.predict (bf16 tol 2e-2); stats {stats}; "
          f"{launches} kernel launches ({launches // 48} bucket forwards)")
    return launches


def _bound(B: int, kh: int, elem: int, flops_peak: float):
    """Least time of one launch: each qkv byte read once, each output byte
    written once, against the two products' operations."""
    C = kh * DH
    nbytes = (B * N * 3 * C + B * N * C) * elem
    flops = 4 * B * N * N * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, t_bytes >= t_ops


def _forward_flops(cms, ens) -> float:
    """Operations of one image's forward, counted from the artifacts' shapes:
    every weight product and both attention products (2 per multiply-add)."""
    flops = 0
    for cm in cms:
        k_in, c = cm.patch_kernel.shape
        flops += 2 * (N - 2) * k_in * c
        for lp in cm.layers:
            width = lp.num_heads * DH
            flops += 2 * N * c * 3 * width + 4 * N * N * width + 2 * N * width * c
            flops += 4 * N * c * lp.fc1_kernel.shape[1]
    for _, m in ens.named_children():
        flops += 2 * m.kernel.numel()
    return float(flops)


@torch.inference_mode()
def phase_times(cms, ens, card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(3)
    per_kh = {}
    B = 256
    for kh in range(1, 7):
        x = _qkv(B, kh, torch.bfloat16, gen)
        q, k, v = x.view(B, N, 3, kh, DH).permute(2, 0, 3, 1, 4)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        before = fused_attention.launches
        ms = _time_ms(lambda: fused_attention(x, num_heads=kh))
        fused_attention.launches = before  # timing launches are not the main path's
        bound, by_bytes = _bound(B, kh, 2, BF16_FLOPS)
        per_kh[kh] = dict(ms=ms, plain_ms=_time_ms(lambda: reference_attention(x, num_heads=kh)),
                          library_ms=_time_ms(lambda: sdpa(q, k, v)), bound_ms=bound,
                          bound_by="bytes" if by_bytes else "operations")
        r = per_kh[kh]
        print(f"[time] attention bf16 B={B} N={N} kh={kh}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound {bound:.4f} ms "
              f"({r['bound_by']}) [{card}]")
    # one bs256 forward: 48 launches at the deployed kh mix
    mix = {}
    for cm in cms:
        for kh in cm.num_heads:
            mix[kh] = mix.get(kh, 0) + 1
    total = {key: sum(n * per_kh[kh][key] for kh, n in mix.items())
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bytes_ms = sum(n * _bound(B, kh, 2, float("inf"))[0] for kh, n in mix.items())
    total["bound_by"] = "bytes" if bytes_ms >= total["bound_ms"] * (1 - 1e-9) else "operations"
    print(f"[time] attention over one bs256 forward (kh mix {dict(sorted(mix.items()))}, "
          f"48 launches): kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
          f"sdpa {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms [{card}]")

    flops_img = _forward_flops(cms, ens)
    print(f"[time] one image's forward: {flops_img / 1e9:.3f} GFLOP (counted from the shapes)")
    rng = np.random.default_rng(4)
    e2e = {}
    for bs in (64, 128, 256):
        x = normalize(torch.from_numpy(
            rng.integers(0, 256, (bs, 224, 224, 3), dtype=np.uint8)).cuda(), torch.float32)
        torch.cuda.reset_peak_memory_stats()
        before = fused_attention.launches
        # the timed batch sizes' logits, kernel vs plain, at the bf16 limit
        rel = _rel(*(_forward(cms, ens, x, dtype=torch.bfloat16, use_kernel=k, fast_math=True)
                     for k in (True, False)))
        if rel > 2e-2:
            raise AssertionError(f"forward bf16 bs{bs}: kernel vs plain rel {rel:.3e} > 2e-2")
        # in turns (kernel, plain, plain, kernel): the host clock of a shared
        # machine drifts, and at bs64 the host's launches are near the device time
        runs = {True: [], False: []}
        for use_kernel in (True, False, False, True):
            runs[use_kernel].append(_time_ms(lambda: _forward(
                cms, ens, x, dtype=torch.bfloat16, use_kernel=use_kernel, fast_math=True),
                iters=10))
        fwd_ms, plain_ms = (sum(runs[k]) / 2 for k in (True, False))
        fused_attention.launches = before
        peak = torch.cuda.max_memory_allocated() / 2**30
        tflops = bs * flops_img / fwd_ms / 1e9
        e2e[bs] = dict(ms=fwd_ms, img_s=bs / fwd_ms * 1e3, plain_ms=plain_ms, rel_err=rel,
                       plain_img_s=bs / plain_ms * 1e3, peak_gib=peak, tflop_s=tflops,
                       runs_ms=runs[True], plain_runs_ms=runs[False])
        print(f"[time] forward bf16 fast_math bs{bs}: {fwd_ms:.3f} ms = {bs / fwd_ms * 1e3:.1f} "
              f"img/s with the kernel ({tflops:.1f} TFLOP/s, {tflops * 1e12 / BF16_FLOPS:.1%} "
              f"of bf16 peak); {plain_ms:.3f} ms = {bs / plain_ms * 1e3:.1f} img/s with the "
              f"plain attention; runs {runs}; logits kernel vs plain rel err {rel:.3e} "
              f"(tol 2e-2); peak memory {peak:.2f} GiB [{card}]")
    return dict(per_kh=per_kh, forward_attention=total, forward=e2e, mix=mix,
                gflop_per_img=flops_img / 1e9)


def _kind(kernel_name: str) -> str:
    if "attn_kernel" in kernel_name:
        return "attention (fused_attention)"
    if any(s in kernel_name for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
        return "matmul (cuBLAS)"
    return "elementwise, reductions, copies"


@torch.inference_mode()
def phase_profile(cms, ens, card: str) -> dict:
    """Device time by kernel over one bs256 forward (torch.profiler), and
    the device's busy share of the forward's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = normalize(torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (256, 224, 224, 3), dtype=np.uint8)).cuda(), torch.float32)
    fwd = lambda: _forward(cms, ens, x, dtype=torch.bfloat16, use_kernel=True, fast_math=True)
    before = fused_attention.launches
    fwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fused_attention.launches = before
    # device-side activities only: a CPU op also reports its kernels' time
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in kernels)
    by_kind = {}  # kind -> [device ms, launches]
    for name, count, ms in kernels:
        acc = by_kind.setdefault(_kind(name), [0.0, 0])
        acc[0] += ms
        acc[1] += count
    print(f"[profile] bs256 forward: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{sum(c for _, c, _ in kernels)} kernel launches [{card}]")
    for kind, (ms, count) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {kind}: {ms:.3f} ms ({ms / max(busy_ms, 1e-9):.1%} of device "
              f"time), {count} launches")
    for name, count, ms in sorted(kernels, key=lambda k: -k[2])[:12]:
        print(f"[profile]   {ms:8.3f} ms  x{count:<4d} {name[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, by_kind=by_kind,
                top=sorted(kernels, key=lambda k: -k[2])[:25])


def _bwd_errs(got: torch.Tensor, want: torch.Tensor, C: int):
    """max-abs over max-ref of dq, dk and dv, each on its own."""
    return [_rel(got[..., i * C:(i + 1) * C], want[..., i * C:(i + 1) * C]) for i in range(3)]


def phase_bwd_checks() -> float:
    """attention_bwd (the kernel) vs reference_attention_bwd on the card,
    dq, dk and dv separately, at kh 1/3/6/12 (deit_tiny, dedeit, deit_base),
    N 197/198, B 1/7/64/256, bf16 and f32; then the trainable Function's
    gradient (both kernels) vs autograd through reference_attention.
    Returns the largest max-abs error of the bf16 cases."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    max_abs_bf16 = 0.0
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for kh in (1, 3, 6, 12):
            for n in (197, 198):
                for B in (1, 7, 64, 256):
                    x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
                    g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").to(dtype)
                    got = attention_bwd(x, g, kh)
                    torch.cuda.synchronize()
                    want = reference_attention_bwd(x, g, kh)
                    errs = _bwd_errs(got, want, kh * DH)
                    if max(errs) > TOL[dtype]:
                        raise AssertionError(f"attention_bwd {dtype} kh={kh} N={n} B={B}: "
                                             f"rel err dq/dk/dv {errs} > {TOL[dtype]:.0e}")
                    if dtype == torch.bfloat16:
                        max_abs_bf16 = max(max_abs_bf16,
                                           float((got.float() - want.float()).abs().max()))
                    worst[dtype] = max(worst[dtype], max(errs))
                    n_cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((7, N, 3 * 6 * DH), generator=gen, device="cuda").to(dtype)
        cot = torch.randn((7, N, 6 * DH), generator=gen, device="cuda")
        x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
        (g1,) = torch.autograd.grad((make_trainable_attention(6)(x1).float() * cot).sum(), x1)
        (g2,) = torch.autograd.grad((reference_attention(x2, num_heads=6).float() * cot).sum(), x2)
        errs = _bwd_errs(g1, g2, 6 * DH)
        if max(errs) > TOL[dtype]:
            raise AssertionError(f"trainable attention {dtype}: grad vs autograd through the "
                                 f"plain forward, rel err dq/dk/dv {errs}")
        print(f"[kernel] trainable attention {str(dtype)[6:]} B=7 kh=6: gradient vs autograd "
              f"through reference_attention, rel err dq/dk/dv "
              f"{', '.join(f'{e:.3e}' for e in errs)}")
    print(f"[kernel] attention_bwd vs plain: {n_cases} cases pass (dq, dk, dv each); worst "
          f"rel err bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 "
          f"{worst[torch.float32]:.3e} (tol 1e-4); max abs err bf16 {max_abs_bf16:.3e}")
    return max_abs_bf16


TRAIN_B, TRAIN_KH, TRAIN_CLASSES = 256, 6, 25


def _train_model(use_kernel: bool):
    """bench.py train_main's configuration: dedeit, 25 classes, drop_path
    0.1, bf16 compute with f32 parameters, remat; seed-0 parameters."""
    return create_vit("dedeit", num_classes=TRAIN_CLASSES, drop_path_rate=0.1,
                      dtype=torch.bfloat16, use_kernel=use_kernel, use_remat=True,
                      device="cuda", generator=torch.Generator().manual_seed(0))


def _train_state(model):
    return TrainState.create(model, make_optimizer(OptimConfig(lr=5e-4, epochs=100), 100),
                             use_ema=True)


def _train_step(model):
    mix = MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5,
                      label_smoothing=0.1, num_classes=TRAIN_CLASSES)
    return make_stage2_step(model, None, mixup=mix, smoothing=0.1, distillation_type="none")


def _step_grads(model, batch, seed: int):
    """Loss and gradients of one stage-2 step from a fresh state: the
    gradients the optimizer receives."""
    state = _train_state(model)
    seen = {}
    update = state.tx.update
    state.tx.update = lambda g, st, p: (seen.update(g), update(g, st, p))[1]
    _, metrics = _train_step(model)(state, None, *batch, torch.Generator().manual_seed(seed))
    return float(metrics["loss"]), seen


def _step_kind(kernel_name: str) -> str:
    if "attn_bwd_kernel" in kernel_name:
        return "attention backward (attention_bwd)"
    return _kind(kernel_name)


def phase_train(card: str) -> dict:
    """The stage-2 training step at full width, bs256, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    images = torch.randn((TRAIN_B, 224, 224, 3), generator=gen, device="cuda").bfloat16()
    labels = torch.randint(0, TRAIN_CLASSES, (TRAIN_B,), generator=gen, device="cuda")
    batch = (images, labels)
    models = {True: _train_model(True), False: _train_model(False)}

    # the step with the kernels vs with the plain attention, from one state and one batch
    loss_k, grads_k = _step_grads(models[True], batch, seed=1)
    loss_p, grads_p = _step_grads(models[False], batch, seed=1)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = {k: float((grads_k[k].float() - grads_p[k].float()).norm()
                         / grads_p[k].float().norm().clamp_min(1e-30)) for k in grads_p}
    worst_leaf = max(grad_rel, key=grad_rel.get)
    if not (np.isfinite(loss_k) and loss_rel <= 2e-2 and grad_rel[worst_leaf] <= 2e-2):
        raise AssertionError(f"train step kernel vs plain: loss {loss_k} vs {loss_p} (rel "
                             f"{loss_rel:.3e}), worst gradient {worst_leaf} rel "
                             f"{grad_rel[worst_leaf]:.3e} (tol 2e-2)")
    print(f"[train] one step, kernels vs plain attention (same state, batch and draws): loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}); gradients: worst leaf "
          f"{worst_leaf} ||diff||/||plain|| {grad_rel[worst_leaf]:.3e} (tol 2e-2, "
          f"{len(grad_rel)} leaves)")

    states = {k: _train_state(m) for k, m in models.items()}
    steps = {k: _train_step(m) for k, m in models.items()}
    per_step, losses = [], []

    def step_fn(use_kernel):
        def fn(state, images, labels, generator):
            f0, b0 = fused_attention.launches, attention_bwd.launches
            state, metrics = steps[use_kernel](state, None, images, labels, generator)
            if use_kernel:
                per_step.append((fused_attention.launches - f0, attention_bwd.launches - b0))
            losses.append(metrics["loss"])
            return state, metrics
        return fn

    def run(use_kernel, n_steps, seed):
        t0 = time.perf_counter()
        states[use_kernel], _, _ = train_epoch(
            step_fn(use_kernel), states[use_kernel], [batch] * n_steps,
            torch.Generator().manual_seed(seed), epoch=0, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    # the main path: counts at 0, warm-up, then the timed turns (kernel, plain,
    # plain, kernel); the plain model's steps launch no kernel
    fused_attention.launches = attention_bwd.launches = 0
    for use_kernel in (True, False):
        run(use_kernel, 2, seed=100)
    torch.cuda.reset_peak_memory_stats()
    runs = {True: [], False: []}
    turn_steps = 6
    for i, use_kernel in enumerate((True, False, False, True)):
        runs[use_kernel].append(run(use_kernel, turn_steps, seed=200 + i))
    launches = {"fused_attention": fused_attention.launches, "attention_bwd": attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    bad = [c for c in per_step if c != (24, 12)]
    if bad or len(per_step) != 2 + 2 * turn_steps:
        raise AssertionError(f"per-step kernel launches {per_step}, expected (24, 12) each")
    if launches != {"fused_attention": 24 * len(per_step), "attention_bwd": 12 * len(per_step)}:
        raise AssertionError(f"train launches {launches}: the plain steps launched a kernel")
    host_losses = [float(l) for l in losses]
    if not all(np.isfinite(host_losses)):
        raise AssertionError(f"non-finite training loss: {host_losses}")
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"[train] stage-2 step, dedeit bs{TRAIN_B}, bf16, remat, mixup/cutmix, AdamW + EMA: "
          f"{ms[True]:.3f} ms/step = {TRAIN_B / ms[True] * 1e3:.1f} img/s with the kernels; "
          f"{ms[False]:.3f} ms/step = {TRAIN_B / ms[False] * 1e3:.1f} img/s with the plain "
          f"attention; turns (ms/step) {runs}; {len(per_step)} kernel steps, each 24 forward "
          f"+ 12 backward launches; {len(host_losses)} losses all finite "
          f"(first {host_losses[0]:.4f}, last {host_losses[-1]:.4f}); peak memory "
          f"{peak:.2f} GiB [{card}]")
    return dict(ms=ms[True], plain_ms=ms[False], img_s=TRAIN_B / ms[True] * 1e3,
                plain_img_s=TRAIN_B / ms[False] * 1e3, runs_ms=runs[True],
                plain_runs_ms=runs[False], launches=launches, peak_gib=peak,
                loss_rel=loss_rel, grad_rel_worst=grad_rel[worst_leaf],
                worst_leaf=worst_leaf, losses=host_losses,
                step=lambda: steps[True](states[True], None, images, labels,
                                         torch.Generator().manual_seed(7)))


def phase_train_profile(step, card: str) -> dict:
    """Device time by kernel class over one training step (torch.profiler)
    and the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = (fused_attention.launches, attention_bwd.launches)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fused_attention.launches, attention_bwd.launches = before
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in kernels)
    by_kind = {}
    for name, count, ms in kernels:
        acc = by_kind.setdefault(_step_kind(name), [0.0, 0])
        acc[0] += ms
        acc[1] += count
    print(f"[train-profile] one bs{TRAIN_B} step: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{sum(c for _, c, _ in kernels)} kernel launches [{card}]")
    for kind, (ms, count) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"[train-profile]   {kind}: {ms:.3f} ms ({ms / max(busy_ms, 1e-9):.1%} of device "
              f"time), {count} launches")
    for name, count, ms in sorted(kernels, key=lambda k: -k[2])[:12]:
        print(f"[train-profile]   {ms:8.3f} ms  x{count:<4d} {name[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, by_kind=by_kind,
                top=sorted(kernels, key=lambda k: -k[2])[:25])


def _bwd_bound(B: int, kh: int, elem: int, flops_peak: float):
    """Least time of one backward launch: qkv and g read once, dqkv written
    once (7 B N C elements), against recomputing s, then dv, dp, dq and dk
    (10 B N^2 C operations)."""
    C = kh * DH
    nbytes = 7 * B * N * C * elem
    flops = 10 * B * N * N * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, t_bytes >= t_ops


def phase_train_kernel_times(card: str) -> dict:
    """The step's attention at its shape (B 256, N 198, kh 6, bf16): the
    forward kernel's 24 launches and the backward kernel's 12, beside their
    bounds, their plain versions and the library yardsticks (SDPA forward;
    SDPA's backward through autograd). Timed here, never on the path."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    B, kh = TRAIN_B, TRAIN_KH
    x = _qkv(B, kh, torch.bfloat16, gen)
    g = torch.randn((B, N, kh * DH), generator=gen, device="cuda").bfloat16()
    q, k, v = (t.contiguous().requires_grad_() for t in
               x.view(B, N, 3, kh, DH).permute(2, 0, 3, 1, 4))
    gh = g.view(B, N, kh, DH).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(q, k, v)
    before = (fused_attention.launches, attention_bwd.launches)
    per = dict(
        fwd=_time_ms(lambda: fused_attention(x, num_heads=kh)),
        fwd_plain=_time_ms(lambda: reference_attention(x, num_heads=kh)),
        fwd_library=_time_ms(lambda: sdpa(q.detach(), k.detach(), v.detach())),
        bwd=_time_ms(lambda: attention_bwd(x, g, kh)),
        bwd_plain=_time_ms(lambda: reference_attention_bwd(x, g, kh)),
        bwd_library=_time_ms(lambda: torch.autograd.grad(out, (q, k, v), gh,
                                                         retain_graph=True)))
    fused_attention.launches, attention_bwd.launches = before
    fb, fb_by_bytes = _bound(B, kh, 2, BF16_FLOPS)
    bb, bb_by_bytes = _bwd_bound(B, kh, 2, BF16_FLOPS)
    res = dict(per_launch=per, fwd_bound=fb, bwd_bound=bb,
               fwd_bound_by="bytes" if fb_by_bytes else "operations",
               bwd_bound_by="bytes" if bb_by_bytes else "operations")
    for name, n in (("fwd", 24), ("bwd", 12)):
        bound = res[f"{name}_bound"]
        res[f"{name}_step"] = dict(ms=n * per[name], plain_ms=n * per[f"{name}_plain"],
                                   library_ms=n * per[f"{name}_library"], bound_ms=n * bound,
                                   bound_by=res[f"{name}_bound_by"])
        print(f"[train-time] attention {name} bf16 B={B} N={N} kh={kh}: kernel "
              f"{per[name]:.4f} ms/launch, plain {per[name + '_plain']:.4f}, library "
              f"{per[name + '_library']:.4f}, bound {bound:.4f} ({res[name + '_bound_by']}); "
              f"x{n} per step: kernel {n * per[name]:.3f} ms, plain "
              f"{n * per[name + '_plain']:.3f}, library {n * per[name + '_library']:.3f}, "
              f"bound {n * bound:.3f} [{card}]")
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    args = parser.parse_args()
    if not (ROOT / "devit_tpu_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py runs from a checkout: devit_tpu_torch/ is missing")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    card = _card()
    print(card)
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = phase_build()
    max_abs_err = phase_kernel_checks()
    t0 = time.perf_counter()
    _, cms, ens = deploy.build_artifacts(device="cuda")
    print(f"[forward] deployed artifacts built in {time.perf_counter() - t0:.1f} s: kept heads "
          f"per division {[cm.num_heads for cm in cms]}")
    phase_full_width(cms, ens)
    launches = phase_serving(cms, ens)
    times = phase_times(cms, ens, card)
    times["profile"] = phase_profile(cms, ens, card)
    del cms, ens

    bwd_max_abs_err = phase_bwd_checks()
    train = phase_train(card)
    step = train.pop("step")
    train["profile"] = phase_train_profile(step, card)
    train["kernel_times"] = phase_train_kernel_times(card)
    times["train"] = train

    fa = times["forward_attention"]
    bw = train["kernel_times"]["bwd_step"]
    record = {"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/attention.cu",
        "replaces": "devit_tpu/kernels/attention.py:30",
        # the serving run's launches plus the training run's
        "launches": launches + train["launches"]["fused_attention"],
        "max_abs_err": max_abs_err,
        "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"], "library_ms": fa["library_ms"]}, {
        "name": "attention_bwd", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/attention_bwd.cu",
        "replaces": "devit_tpu/kernels/attention.py:238",
        "launches": train["launches"]["attention_bwd"], "max_abs_err": bwd_max_abs_err,
        "ms": bw["ms"], "plain_ms": bw["plain_ms"], "bound_ms": bw["bound_ms"],
        "bound_by": bw["bound_by"], "library_ms": bw["library_ms"]}]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, build_s=build_s, kernels=record["kernels"], **times,
            seconds=time.perf_counter() - t_start), indent=1, default=str))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
