#!/usr/bin/env python3
"""Drive the PyTorch port (devit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout. It builds the CUDA kernels from the
sources in the checkout, counts the tensor-core instructions in the built
library (HMMA in the bf16 attention kernels at each head width: the
forward, the monolithic backward and the split pair, three instantiations
of one template, and the two block-attention kernels; IMMA in the int8
GEMM), holds
each kernel against its plain PyTorch version on the card (the split pair
also against the monolithic kernel, bit for bit; every backward past 256
keys, [bwd-long]), runs the deployed 4-division dedeit
ensemble at full width, serves it over HTTP to concurrent clients, times
the kernels and the forward. Then the deployment artifacts: the int8 matmul
kernel against its
plain version at every deployed weight shape, the block-attention kernel at
every deployed layer, the divisions and the fusion head written to disk in
the JAX package's format, loaded back into a server whose replies equal the
in-memory engine's, a fusion head hot-swapped over POST /reload, and the
int8 forward of the loaded divisions (192 int8 kernel launches), timed
against the bf16 forward. Then the stage-2 training step of full-width
dedeit at bs256 (remat, mixup/cutmix, AdamW, EMA) through train_epoch, with
the attention forward and backward kernels, against the same step with the
plain attention. Then the stage-5 ensemble step (four gated dedeit
divisions, a deit-base teacher, EnsMLP, two optimizers) at bs64 with the
monolithic backward kernel, with the split pair (DEVIT_ATTN_BWD=split) and
with the plain attention, and the stage-4 DEKD step in both
distillation_inter modes. Their one-step checks hold the students' kernel
attention to the plain attention with the teacher on the kernel in both
steps, and the teacher's logits to its plain attention's. Then stage 3 of
full-width dedeit on division 0 of the synthetic data at the CLI's
defaults: the HSIC rank functions (their scores on the card held to the
CPU's), one candidate chunk folded into 8 x 512 = 4096 rows through the
attention kernel against the plain attention, the whole model_shrink
search with its four .npy files, and the best policy's compacted model
against the gated one. Then every attention kernel at head widths 32, 64
and 128 against its plain version, timed ([heads]); stage 2 from a
CIFAR-100 pickle tree written from a seed: build_dataset, division 0, the
C++ gather, train_transform on the card held to the CPU on the same host
draws, fit for 2 epochs writing its checkpoints, eval through
eval_transform ([data-train]); a run resumed from its
checkpoint_temp.msgpack equal to the uninterrupted one bit for bit
([ckpt]); an epoch under the profiler ([data-profile]); and, where PIL
imports, an epoch with the host augment ([pil]). Then every attention
kernel at head widths 8, 16, 48, 80 and 96, which the wrappers zero-pad to
an instantiation ([heads-pad]), and the devit-torch command line
([cli]): `pipeline` at full width (4 divisions, 1 epoch) timed per stage
with each kernel's launches, a second `pipeline` that skips every stage,
`inspect --json`, `serve` on its deploy/ answering concurrent /predict
requests as engine.predict does, and the served correct count over the
val set equal to `ensemble --compact-path`'s. Any failure
raises and exits non-zero; so does a machine without CUDA, or a directory
that holds this script without the package.

The last lines of standard output are the card's name and power limit (as
nvidia-smi gives them), one JSON line with the kernels' record, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from devit_tpu_torch import deploy
from devit_tpu_torch.core.compact import compact_vit_params
from devit_tpu_torch.core.metrics import cal_shrink_macs, cal_shrink_paras, count_params_brute
from devit_tpu_torch.core.rank import (
    _head_scores, _neuron_scores, attn_head_rank, build_gates, mlp_neuron_rank,
    neuron_rank_scores,
)
from devit_tpu_torch.core.shrink import (
    fold_candidates, make_batched_policy_eval, model_shrink, policies_to_gates, screen,
)
from devit_tpu_torch.data.datasets import BatchIterator, build_dataset, synthetic_dataset
from devit_tpu_torch.data.mixup import MixupConfig
from devit_tpu_torch.data.pipeline import (
    AugmentConfig, apply_train, draw_train, eval_transform, finish_transform, normalize,
    random_resized_crop, train_transform,
)
from devit_tpu_torch.data.randaugment import OP_NAMES as RA_OP_NAMES
from devit_tpu_torch.data.randaugment import STEPPED_OPS as RA_STEPPED
from devit_tpu_torch.data.randaugment import RandAugmentDraws, apply_rand_augment
from devit_tpu_torch.kernels import _build
from devit_tpu_torch.io.bridge import ensmlp_to_jax_params
from devit_tpu_torch.io.checkpoint import restore_pytree, save_pytree
from devit_tpu_torch.io.native import gather_rows
from devit_tpu_torch.kernels.attention import (
    attention_bwd, attention_bwd_dqdk, attention_bwd_dv, attention_bwd_split, fused_attention,
    fused_block_attention, make_trainable_attention, reference_attention,
    reference_attention_bwd, reference_attention_bwd_dqdk, reference_attention_bwd_dv,
    reference_block_attention,
)
from devit_tpu_torch.kernels.quant import dynamic_int8_matmul, fused_int8_matmul, quantize_weight
from devit_tpu_torch.models.compact_vit import (
    attention_half, embed_patches, mlp_half, quantize_compact, save_compact,
    stack_division_features,
)
from devit_tpu_torch.models.ensemble import EnsMLP, init_multivit, stack_division_gates
from devit_tpu_torch.data.splitter import DivisionManifest
from devit_tpu_torch.models.vit import Gates, VisionTransformer, create_vit
from devit_tpu_torch.serving.daemon import (
    InferenceEngine, ServeConfig, build_engine_from_artifacts, build_server,
)
from devit_tpu_torch.train.loop import fit, run_eval, train_epoch
from devit_tpu_torch.train.optim import OptimConfig, make_optimizer
from devit_tpu_torch.train.state import TrainState, restore_stage2_tree, stage2_tree
from devit_tpu_torch.train.steps import (
    make_dekd_step, make_ensemble_train_step, make_eval_step, make_stage2_step,
)

ROOT = Path(__file__).resolve().parent
N, DH = 198, 64  # tokens (196 patches + cls + dist) and head width of dedeit
PX = 224  # image side of the deployed divisions
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # f32 outside the tensor cores
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


# the tensor-core kernels: name -> (a regular expression for its function's
# mangled name in the SASS, the mma opcode): every instantiation of the
# forward attn_kernel_mma<KC, DH>, of the backward template
# attn_bwd_kernel_mma<DQDK, DV, DH> and of the bf16 block-attention kernels
# block_qkv_attn_kernel<KC, DH> and block_proj_kernel<Ragged>; the int8 GEMM
# (m16n8k32 s8 is IMMA)
HEAD_DIMS = (32, 64, 128)
KEY_CHUNKS = (4, 8, 13, 16)  # KC: the score registers' key steps (launch_bf16)
MMA_KERNELS = {
    **{f"attn_kernel_mma<{kc},{dh}>": (rf"attn_kernel_mmaILi{kc}ELi{dh}EE", "HMMA")
       for dh in HEAD_DIMS for kc in KEY_CHUNKS},
    **{f"attn_bwd_kernel_mma<{a},{b},{dh}> ({w})": (rf"attn_bwd_kernel_mmaILb{ia}ELb{ib}ELi{dh}EE",
                                                     "HMMA")
       for dh in HEAD_DIMS
       for a, b, ia, ib, w in (("true", "true", 1, 1, "attention_bwd"),
                               ("false", "true", 0, 1, "attention_bwd_dv"),
                               ("true", "false", 1, 0, "attention_bwd_dqdk"))},
    **{f"block_qkv_attn_kernel<{kc},{dh}> (fused_block_attention)":
       (rf"block_qkv_attn_kernelILi{kc}ELi{dh}EE", "HMMA")
       for dh in HEAD_DIMS for kc in KEY_CHUNKS},
    **{f"block_proj_kernel<{r}> (fused_block_attention)": (rf"block_proj_kernelILb{i}EE", "HMMA")
       for r, i in (("false", 0), ("true", 1))},
    "quant_mma_kernel (fused_int8_matmul)": ("quant_mma_kernel", "IMMA"),
}


def _mma_counts() -> dict:
    """Tensor-core mma instructions (HMMA for bf16, IMMA for int8) in the
    SASS of each kernel of MMA_KERNELS, from cuobjdump -sass of the built
    library. Raises if cuobjdump is missing or a kernel has none."""
    import re

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    sass = subprocess.run([str(tool), "-sass", str(_build._lib_path())], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = dict.fromkeys(MMA_KERNELS, 0)
    marks = {k: re.compile(mark) for k, (mark, _) in MMA_KERNELS.items()}
    owners = []
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            owners = [k for k, m in marks.items() if m.search(fn)]
            continue
        for k in owners:
            counts[k] += MMA_KERNELS[k][1] in line
    if not all(counts.values()):
        raise AssertionError(f"a tensor-core kernel has no mma instruction: {counts}")
    return counts


def phase_build() -> tuple:
    secs, log = _build.build()
    print(f"[build] nvcc {[f.name for f in _build.SOURCES]}:\n{log.strip()}")
    print(f"[build] kernel built in {secs:.2f} s")
    counts = _mma_counts()
    print(f"[build] tensor-core instructions (cuobjdump -sass; HMMA bf16, IMMA int8): "
          f"{', '.join(f'{k} {MMA_KERNELS[k][1]} {n}' for k, n in counts.items())}")
    return secs, counts


def phase_kernel_checks() -> float:
    """fused_attention (the kernel) vs reference_attention on the card, at
    the main path's N and dh, every kh the divisions meet and one more, every
    serving bucket (1, 8, 32, 128, 256), remainder batches (7, 64), with and
    without a head gate, and with an all-zero head; and at the stage-5
    teacher's shape (deit-base: kh 12, C 768) at B 1, 7 and 64.
    Returns the largest max-abs error of the bf16 cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    max_abs_bf16 = 0.0
    n = 0
    shapes = ([(kh, B) for kh in range(1, 7) for B in (1, 7, 8, 32, 64, 128, 256)]
              + [(12, B) for B in (1, 7, 64)])
    for dtype in (torch.bfloat16, torch.float32):
        for kh, B in shapes:
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
    print(f"[kernel] fused_attention vs plain: {n} cases pass (kh 1-6 at every bucket, kh 12 "
          f"at B 1/7/64); worst rel err bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 "
          f"{worst[torch.float32]:.3e} (tol 1e-4); max abs err bf16 {max_abs_bf16:.3e}")
    return max_abs_bf16


def phase_split_checks() -> dict:
    """The split backward on the card: attention_bwd_dqdk and
    attention_bwd_dv (the kernels) vs their plain versions, dq, dk and dv
    each on its own, at N 198, kh 1-6, B 1/7/64/256, bf16 and f32; the pair
    (attention_bwd_split) equal to the monolithic kernel bit for bit on the
    same inputs (it runs the same steps: bwd_mma.cuh at bf16, bwd_common.cuh
    at f32); a repeat launch bit for bit; and
    make_trainable_attention(6, "split")'s gradient vs autograd through
    reference_attention. Returns the largest bf16 max-abs error of each
    kernel."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    max_abs = {"dv": 0.0, "dqdk": 0.0}
    equal_to_mono = {torch.bfloat16: 0, torch.float32: 0}
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for kh in range(1, 7):
            for B in (1, 7, 64, 256):
                C = kh * DH
                x = _qkv(B, kh, dtype, gen)
                g = torch.randn((B, N, C), generator=gen, device="cuda").to(dtype)
                dqdk, dv = attention_bwd_dqdk(x, g, kh), attention_bwd_dv(x, g, kh)
                split = attention_bwd_split(x, g, kh)
                again = attention_bwd_split(x, g, kh)
                mono = attention_bwd(x, g, kh)
                torch.cuda.synchronize()
                want_qk = reference_attention_bwd_dqdk(x, g, kh)
                want_v = reference_attention_bwd_dv(x, g, kh)
                errs = [_rel(dqdk[..., :C], want_qk[..., :C]),
                        _rel(dqdk[..., C:], want_qk[..., C:]), _rel(dv, want_v)]
                if max(errs) > TOL[dtype]:
                    raise AssertionError(f"split kernels {dtype} kh={kh} B={B}: rel err "
                                         f"dq/dk/dv {errs} > {TOL[dtype]:.0e}")
                if not (torch.equal(split, again) and torch.equal(split[..., :2 * C], dqdk)
                        and torch.equal(split[..., 2 * C:], dv)):
                    raise AssertionError(f"split kernels {dtype} kh={kh} B={B}: a repeat "
                                         "launch, or a slice of the dqkv buffer, differs")
                if not torch.equal(split, mono):
                    raise AssertionError(f"split vs monolithic {dtype} kh={kh} B={B}: not bit "
                                         f"for bit, rel err {max(_bwd_errs(split, mono, C)):.3e}")
                equal_to_mono[dtype] += 1
                if dtype == torch.bfloat16:
                    max_abs["dqdk"] = max(max_abs["dqdk"],
                                          float((dqdk.float() - want_qk.float()).abs().max()))
                    max_abs["dv"] = max(max_abs["dv"],
                                        float((dv.float() - want_v.float()).abs().max()))
                worst[dtype] = max(worst[dtype], max(errs))
                n_cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((7, N, 3 * 6 * DH), generator=gen, device="cuda").to(dtype)
        cot = torch.randn((7, N, 6 * DH), generator=gen, device="cuda")
        x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
        b0 = attention_bwd.launches
        (g1,) = torch.autograd.grad((make_trainable_attention(6, "split")(x1).float() * cot)
                                    .sum(), x1)
        (g2,) = torch.autograd.grad((reference_attention(x2, num_heads=6).float() * cot).sum(), x2)
        errs = _bwd_errs(g1, g2, 6 * DH)
        if max(errs) > TOL[dtype] or attention_bwd.launches != b0:
            raise AssertionError(f"trainable attention (split) {dtype}: grad vs autograd "
                                 f"through the plain forward, rel err dq/dk/dv {errs}")
        print(f"[kernel] trainable attention (split) {str(dtype)[6:]} B=7 kh=6: gradient vs "
              f"autograd through reference_attention, rel err dq/dk/dv "
              f"{', '.join(f'{e:.3e}' for e in errs)}")
    print(f"[kernel] attention_bwd_dqdk + attention_bwd_dv vs plain: {n_cases} cases pass (dq, "
          f"dk, dv each); worst rel err bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 "
          f"{worst[torch.float32]:.3e} (tol 1e-4); max abs err bf16 dqdk "
          f"{max_abs['dqdk']:.3e}, dv {max_abs['dv']:.3e}; repeat launches bit-identical; equal "
          f"to the monolithic kernel bit for bit in {equal_to_mono[torch.bfloat16]} of "
          f"{n_cases // 2} bf16 and {equal_to_mono[torch.float32]} of {n_cases // 2} f32 cases")
    return max_abs


def _forward(cms, ens, x, *, dtype, use_kernel, fast_math, int8=False):
    cls_s, dist_s = stack_division_features(cms, x, patch_size=16, dtype=dtype,
                                            use_kernel=use_kernel, fast_math=fast_math,
                                            int8=int8)
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
        _set_counts((0, 0, 0, 0))
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


INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)


def _int8_bound(M: int, K: int, Nn: int, elem: int = 2):
    """Least time of one fused_int8_matmul call: read x (M, K) and the (K, N)
    int8 weight with its f32 scales and bias, write (M, N), against 2 M K N
    int8 operations (the row quantization's few operations an element left
    out). Returns (ms, bytes ms)."""
    nbytes = elem * M * K + K * Nn + 8 * Nn + elem * M * Nn
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, 2 * M * K * Nn / INT8_OPS) * 1e3, t_bytes * 1e3


def _block_bound(B: int, C: int, K: int, elem: int = 2):
    """Least time of one fused_block_attention call: read t (B, N, C) and the
    layer's LN, qkv (C, 3K) and proj (K, C) weights and biases, write (B, N,
    C), against 2 B N C 3K + 4 B N^2 K + 2 B N K C operations at the bf16
    peak. Returns (ms, bytes ms)."""
    M = B * N
    nbytes = elem * (2 * M * C + 4 * C + C * 3 * K + 3 * K + K * C + C)
    flops = 2 * M * C * 3 * K + 4 * B * N * N * K + 2 * M * K * C
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, flops / BF16_FLOPS) * 1e3, t_bytes * 1e3


def _int8_shapes(cm):
    """The (K, N) of a compact division's four weight products a layer, in
    the order the int8 forward runs them: qkv, proj, fc1, fc2."""
    C = cm.patch_kernel.shape[1]
    for lp in cm.layers:
        K, hidden = lp.num_heads * DH, lp.fc1_kernel.shape[1]
        yield from ((C, 3 * K), (K, C), (C, hidden), (hidden, C))


def layer_bounds(cms, B: int = 256) -> dict:
    """Least time of fused_block_attention (one call a layer) and
    fused_int8_matmul (in place of each of the int8 branch's four
    dynamic_int8_matmul calls a layer) at the deployed ensemble's layer
    shapes (each division's ragged layers, batch B, N 198, bf16), summed over
    one forward: each call's larger of bytes over 3.35 TB/s and operations
    over the dtype's peak (_block_bound, _int8_bound)."""
    block = {"ms": 0.0, "bytes_ms": 0.0, "calls": 0}
    int8 = {"ms": 0.0, "bytes_ms": 0.0, "calls": 0}
    for cm in cms:
        C = cm.patch_kernel.shape[1]
        for lp in cm.layers:
            ms, bytes_ms = _block_bound(B, C, lp.num_heads * DH)
            block["ms"] += ms
            block["bytes_ms"] += bytes_ms
            block["calls"] += 1
        for k_in, n_out in _int8_shapes(cm):
            ms, bytes_ms = _int8_bound(B * N, k_in, n_out)
            int8["ms"] += ms
            int8["bytes_ms"] += bytes_ms
            int8["calls"] += 1
    for r in (block, int8):
        r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ms"] * (1 - 1e-9) else "operations"
    return {"fused_block_attention": block, "fused_int8_matmul": int8}


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
    bounds = layer_bounds(cms)
    for name, r in bounds.items():
        print(f"[time] {name}, bound over one bs256 deployed forward ({r['calls']} calls): "
              f"{r['ms']:.4f} ms ({r['bound_by']}; the bytes alone {r['bytes_ms']:.4f} ms), "
              f"counted from the shapes")
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
                gflop_per_img=flops_img / 1e9, layer_bounds=bounds)


def _kind(kernel_name: str) -> str:
    if "quant_rows_kernel" in kernel_name or "quant_mma_kernel" in kernel_name:
        return "int8 matmul (fused_int8_matmul)"
    if "attn_kernel" in kernel_name:
        return "attention (fused_attention)"
    if any(s in kernel_name for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90")):
        return "matmul (cuBLAS)"
    return "elementwise, reductions, copies"


@torch.inference_mode()
def phase_profile(cms, ens, card: str, int8: bool = False) -> dict:
    """Device time by kernel over one bs256 forward (torch.profiler; the int8
    forward of quantize_compact divisions with int8), and the device's busy
    share of the forward's wall time."""
    x = _images(256, seed=5)
    return _profile(lambda: _forward(cms, ens, x, dtype=torch.bfloat16, use_kernel=True,
                                     fast_math=True, int8=int8),
                    "[int8-profile]" if int8 else "[profile]", "bs256 forward", card)


def _profile(fwd, tag: str, what: str, card: str, kind=_kind) -> dict:
    """Device time by kernel class (`kind` of its name) over one call of fwd
    (after a warm one), and the device's busy share of its wall time. Launch
    counts restored."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = (fused_attention.launches, fused_int8_matmul.launches)
    fwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fused_attention.launches, fused_int8_matmul.launches = before
    # device-side activities only: a CPU op also reports its kernels' time
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, _, ms in kernels)
    by_kind = {}  # kind -> [device ms, launches]
    for name, count, ms in kernels:
        acc = by_kind.setdefault(kind(name), [0.0, 0])
        acc[0] += ms
        acc[1] += count
    print(f"{tag} {what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}), "
          f"{sum(c for _, c, _ in kernels)} kernel launches [{card}]")
    for kind, (ms, count) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"{tag}   {kind}: {ms:.3f} ms ({ms / max(busy_ms, 1e-9):.1%} of device "
              f"time), {count} launches")
    for name, count, ms in sorted(kernels, key=lambda k: -k[2])[:12]:
        print(f"{tag}   {ms:8.3f} ms  x{count:<4d} {name[:100]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, by_kind=by_kind,
                top=sorted(kernels, key=lambda k: -k[2])[:25])


# ---- the deployment artifacts, the int8 path and the block-attention kernel


def _images(B: int, seed: int) -> torch.Tensor:
    return normalize(torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (B, PX, PX, 3), dtype=np.uint8)).cuda(), torch.float32)


def _deployed_weights(cms) -> dict:
    """(K, N) -> (kernel, bias) of the first deployed weight product of each
    distinct shape (qkv, proj, fc1, fc2 of every layer)."""
    out = {}
    for cm in cms:
        for lp in cm.layers:
            for name in ("qkv", "proj", "fc1", "fc2"):
                kern = getattr(lp, f"{name}_kernel")
                out.setdefault(tuple(kern.shape), (kern, getattr(lp, f"{name}_bias")))
    return dict(sorted(out.items()))


@torch.inference_mode()
def phase_int8_checks(cms) -> float:
    """fused_int8_matmul (the kernel) vs dynamic_int8_matmul on the card at
    every distinct (K, N) of the deployed divisions' weight products (the
    layer's own weights, quantized, with its bias and without), M 1, 7, 198
    and 50688 (bs256 x 198 tokens), bf16 and f32 input and output. Both
    compute exact int32 sums and round every f32 step alike, so every case
    must agree bit for bit. Returns the max-abs error, 0."""
    gen = torch.Generator(device="cuda").manual_seed(60)
    before = fused_int8_matmul.launches
    n = 0
    weights = _deployed_weights(cms)
    for (K, Nn), (kern, bias) in weights.items():
        for b in (bias, None):
            q = quantize_weight(kern, b)
            for M in (1, 7, N, 256 * N):
                x32 = torch.randn((M, K), generator=gen, device="cuda")
                for dtype in (torch.bfloat16, torch.float32):
                    x = x32.to(dtype)
                    got = fused_int8_matmul(x, q, out_dtype=dtype)
                    torch.cuda.synchronize()
                    want = dynamic_int8_matmul(x, q, dtype)
                    if not torch.equal(got, want):
                        raise AssertionError(f"fused_int8_matmul {dtype} M={M} K={K} N={Nn} "
                                             f"bias={b is not None}: not bit-identical to the "
                                             f"plain version (rel err {_rel(got, want):.3e})")
                    n += 1
    fused_int8_matmul.launches = before
    print(f"[int8-kernel] fused_int8_matmul vs dynamic_int8_matmul: {n} cases bit-identical "
          f"({len(weights)} distinct (K, N) of the deployed divisions {list(weights)}, M "
          f"1/7/198/50688, bf16 and f32, with and without bias)")
    return 0.0


def _block_args(lp, t: torch.Tensor):
    """fused_block_attention's arguments for compact layer lp on tokens t:
    the two kernels in t's dtype, the vectors as they are (f32)."""
    return (t, lp.norm1_scale, lp.norm1_bias, lp.qkv_kernel.to(t.dtype).contiguous(),
            lp.qkv_bias, lp.proj_kernel.to(t.dtype).contiguous(), lp.proj_bias)


def _block_forward(cms, ens, x):
    """The deployed forward (bf16, fast_math) with each layer's attention
    half through fused_block_attention and its MLP half as compact_forward
    runs it."""
    from devit_tpu_torch.models.vit import layer_norm

    cls_t, dist_t = [], []
    for cm in cms:
        t = embed_patches(cm, x, patch_size=16, dtype=torch.bfloat16)
        for lp in cm.layers:
            t = fused_block_attention(*_block_args(lp, t), num_heads=lp.num_heads, eps=cm.eps)
            t = mlp_half(lp, t, eps=cm.eps, dtype=torch.bfloat16)
        t = layer_norm(t, cm.norm_scale, cm.norm_bias, cm.eps, torch.bfloat16)
        cls_t.append(t[:, 0])
        dist_t.append(t[:, 1])
    return ens(torch.stack(cls_t), torch.stack(dist_t)).logits


@torch.inference_mode()
def phase_block_attention(cms, ens, card: str) -> dict:
    """fused_block_attention (the kernel) vs reference_block_attention on the
    card at each of the 48 deployed layers, on the t that compact_forward
    (with the attention kernel) feeds the layer, for images at B 1, 7 and
    256: bf16 with fast_math (the serving numerics, tol 2e-2) and f32 with
    strict numerics (tol 1e-4, and within the JAX test's 2e-4 of the split
    sequence, attention_half); every case launched twice, bit for bit. Then
    the deployed bs256 forward with every attention half through the kernel
    (its 48 launches, counted from 0), logits against compact_forward's."""
    fa_before, before = fused_attention.launches, fused_block_attention.launches
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    vs_split = max_abs = 0.0
    n = 0
    for dtype, fast in ((torch.bfloat16, True), (torch.float32, False)):
        for B in (1, 7, 256):
            x = _images(B, seed=61 + B)
            for cm in cms:
                t = embed_patches(cm, x, patch_size=16, dtype=dtype)
                for lp in cm.layers:
                    args = _block_args(lp, t)
                    got = fused_block_attention(*args, num_heads=lp.num_heads, eps=cm.eps)
                    again = fused_block_attention(*args, num_heads=lp.num_heads, eps=cm.eps)
                    torch.cuda.synchronize()
                    want = reference_block_attention(*args, num_heads=lp.num_heads, eps=cm.eps)
                    rel = _rel(got, want)
                    split = attention_half(lp, t, eps=cm.eps, dtype=dtype, fast_math=fast)
                    rel_split = _rel(got, split) if dtype == torch.float32 else 0.0
                    if rel > TOL[dtype] or rel_split > 2e-4 or not torch.equal(got, again):
                        raise AssertionError(
                            f"fused_block_attention {dtype} B={B} kh={lp.num_heads}: rel err "
                            f"{rel:.3e} (tol {TOL[dtype]:.0e}), vs the split sequence "
                            f"{rel_split:.3e} (tol 2e-4), repeat identical "
                            f"{torch.equal(got, again)}")
                    worst[dtype] = max(worst[dtype], rel)
                    vs_split = max(vs_split, rel_split)
                    if dtype == torch.bfloat16:
                        max_abs = max(max_abs, float((got.float() - want.float()).abs().max()))
                    n += 1
                    t = mlp_half(lp, split, eps=cm.eps, dtype=dtype, fast_math=fast)
    print(f"[block-attn] fused_block_attention vs plain: {n} cases pass (each of the "
          f"{n // 6} deployed layers at B 1/7/256, bf16 and f32, on the layer's own input); "
          f"worst max-abs/max-ref bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 "
          f"{worst[torch.float32]:.3e} (tol 1e-4); f32 vs the split sequence "
          f"{vs_split:.3e} (tol 2e-4); max abs err bf16 {max_abs:.3e}; repeat launches "
          f"bit-identical")

    x = _images(256, seed=69)
    layers = sum(len(cm.layers) for cm in cms)
    fused_block_attention.launches = 0
    got = _block_forward(cms, ens, x)
    torch.cuda.synchronize()
    launches = fused_block_attention.launches
    want = _forward(cms, ens, x, dtype=torch.bfloat16, use_kernel=True, fast_math=True)
    rel = _rel(got, want)
    if launches != layers or rel > 2e-2:
        raise AssertionError(f"bs256 forward through fused_block_attention: {launches} "
                             f"launches (expected {layers}), logits vs compact_forward rel "
                             f"{rel:.3e}")
    print(f"[block-attn] deployed bs256 forward with every attention half through the kernel: "
          f"{launches} launches, logits vs compact_forward's rel err {rel:.3e} (tol 2e-2) [{card}]")
    fused_attention.launches = fa_before
    fused_block_attention.launches = before + launches
    return dict(max_abs_err=max_abs, worst={str(k)[6:]: v for k, v in worst.items()},
                vs_split=vs_split, cases=n,
                launches=launches, forward_rel=rel)


def _reload(url: str, path: str) -> int:
    req = urllib.request.Request(url + "/reload", data=json.dumps({"ens_path": path}).encode())
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@torch.inference_mode()
def phase_artifacts(cms, ens, card: str) -> dict:
    """The deployed divisions written with save_compact and the fusion head
    with save_pytree ({"ens_params": ...}, the stage-5 layout), in the JAX
    package's format; build_engine_from_artifacts from that directory, whose
    predictions at bs 1/8/256 equal the in-memory engine's bit for bit;
    served over HTTP, a second head hot-swapped by POST /reload changes the
    replies, a wrong-geometry head gets a 400, and the first head restores
    them. Returns the loaded divisions and the kernel launches of the HTTP
    requests."""
    scfg = ServeConfig()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as root:
        t0 = time.perf_counter()
        for i, cm in enumerate(cms):
            save_compact(os.path.join(root, f"sub-dataset{i}", "compact.msgpack"), cm)
        ens_path = os.path.join(root, "ens.msgpack")
        save_pytree(ens_path, {"ens_params": ensmlp_to_jax_params(ens)})
        save_s = time.perf_counter() - t0
        sizes = [os.path.getsize(os.path.join(root, f"sub-dataset{i}", "compact.msgpack"))
                 for i in range(len(cms))]
        t0 = time.perf_counter()
        loaded = build_engine_from_artifacts(root, ens_path, cfg=scfg,
                                             log=lambda m: print(f"[artifacts] {m}"))
        load_s = time.perf_counter() - t0
        memory = InferenceEngine(cms, ens, scfg, device="cuda")
        rng = np.random.default_rng(90)
        for bs in (1, 8, 256):
            imgs = rng.integers(0, 256, (bs, PX, PX, 3), dtype=np.uint8)
            a, b = loaded.predict(imgs), memory.predict(imgs)
            if not np.array_equal(a, b):
                raise AssertionError(f"engine from artifacts vs in-memory engine at bs{bs}: max "
                                     f"abs diff {np.abs(a - b).max():.3e}, expected equal bits")
        geometry = dict(sub_size=ens.sub_size, num_divisions=len(cms),
                        teacher_size=ens.teacher_size, family=ens.family)
        alt = deploy.init_ensmlp(EnsMLP(num_classes=ens.num_classes, **geometry),
                                 deploy.ENS_SEED + 1)
        bad = deploy.init_ensmlp(EnsMLP(num_classes=ens.num_classes + 1, **geometry),
                                 deploy.ENS_SEED + 2)
        alt_path, bad_path = os.path.join(root, "alt.msgpack"), os.path.join(root, "bad.msgpack")
        save_pytree(alt_path, {"ens_params": ensmlp_to_jax_params(alt)})
        save_pytree(bad_path, {"ens_params": ensmlp_to_jax_params(bad)})

        httpd, batcher = build_server(loaded, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = "http://%s:%d" % httpd.server_address[:2]
        imgs = rng.integers(0, 256, (3, PX, PX, 3), dtype=np.uint8)
        try:
            before = fused_attention.launches
            first = _post(url, imgs)["predictions"]
            codes = [_reload(url, alt_path)]
            swapped = _post(url, imgs)["predictions"]
            swapped_logits = loaded.predict(imgs)
            codes += [_reload(url, bad_path), _reload(url, os.path.join(root, "none.msgpack"))]
            after_bad = _post(url, imgs)["predictions"]
            codes.append(_reload(url, ens_path))
            restored = _post(url, imgs)["predictions"]
            launches = fused_attention.launches - before
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.stop()
            thread.join(timeout=30)
    want_alt = InferenceEngine(cms, alt, scfg, device="cuda").predict(imgs)
    if codes != [200, 400, 400, 200]:
        raise AssertionError(f"POST /reload answered {codes}, expected [200, 400, 400, 200]")
    if swapped == first or after_bad != swapped or restored != first:
        raise AssertionError("POST /reload: the replies did not follow the fusion head")
    if not np.array_equal(swapped_logits, want_alt):
        raise AssertionError("after /reload the engine's logits differ from an engine built "
                             "with the second head")
    layers = sum(len(cm.layers) for cm in cms)
    if launches % layers or launches == 0:
        raise AssertionError(f"{launches} attention launches while serving the loaded artifacts")
    print(f"[artifacts] {len(cms)} divisions ({[round(b / 2**20, 2) for b in sizes]} MiB) + "
          f"fusion head written in {save_s:.2f} s, engine built from them in {load_s:.2f} s; "
          f"predict at bs 1/8/256 equals the in-memory engine's bit for bit; POST /reload: "
          f"second head 200 (replies changed, logits equal a fresh engine's), wrong geometry "
          f"400, missing file 400, first head 200 (replies restored); {launches} attention "
          f"launches over HTTP [{card}]")
    return dict(cms=loaded.cms, save_s=save_s, load_s=load_s, sizes=sizes, launches=launches)


@torch.inference_mode()
def phase_int8(cms, ens, card: str) -> dict:
    """The int8 serving path: quantize_compact of the loaded divisions, the
    int8 forward + EnsMLP at bs256 in bf16 (fast_math). Its main-path run
    (counts from 0) must launch the int8 kernel 192 times; its logits against
    the same forward through dynamic_int8_matmul (tol 2e-2) and against the
    bf16 forward (mean relative deviation within the JAX test's 0.1)."""
    qcms = [quantize_compact(cm) for cm in cms]
    x = _images(256, seed=70)
    fused_int8_matmul.launches = 0
    got = _forward(qcms, ens, x, dtype=torch.bfloat16, use_kernel=True, fast_math=True, int8=True)
    torch.cuda.synchronize()
    launches = fused_int8_matmul.launches
    plain = _forward(qcms, ens, x, dtype=torch.bfloat16, use_kernel=False, fast_math=True,
                     int8=True)
    expect = 4 * sum(len(cm.layers) for cm in cms)  # qkv, proj, fc1, fc2 a layer
    if launches != expect or fused_int8_matmul.launches != expect:
        raise AssertionError(f"int8 forward: {launches} kernel launches (expected {expect}); the "
                             f"plain int8 forward launched {fused_int8_matmul.launches - launches}")
    rel = _rel(got, plain)
    bf16 = _forward(cms, ens, x, dtype=torch.bfloat16, use_kernel=True, fast_math=True)
    dev = float((got - bf16).abs().mean() / bf16.abs().mean())
    if got.shape != (256, ens.num_classes) or rel > 2e-2 or dev > 0.1:
        raise AssertionError(f"int8 forward {tuple(got.shape)}: kernel vs plain rel {rel:.3e} "
                             f"(tol 2e-2), vs bf16 mean rel deviation {dev:.3e} (tol 0.1)")
    print(f"[int8] int8 forward of the {len(qcms)} loaded divisions + EnsMLP, bs256, bf16: "
          f"{launches} fused_int8_matmul launches; logits kernel vs plain int8 rel err {rel:.3e} "
          f"(tol 2e-2, bit-identical {torch.equal(got, plain)}); vs the bf16 forward mean "
          f"relative deviation {dev:.3e} (tol 0.1) [{card}]")
    return dict(qcms=qcms, launches=launches, rel=rel, dev_bf16=dev,
                identical=bool(torch.equal(got, plain)))


@torch.inference_mode()
def phase_int8_times(cms, qcms, ens, card: str) -> dict:
    """CUDA events: the int8 and the bf16 forward at bs 64/128/256 in turns
    (int8, bf16, bf16, int8); fused_int8_matmul at each distinct deployed
    (K, N) at M = 256 x 198 beside its plain version, its bound, the dot
    alone through torch._int_mm (cuBLASLt int8) and the bf16 product
    (torch.matmul), summed over one forward's 192 calls; and
    fused_block_attention at each of the 48 deployed layers at B 256 (bf16,
    on the layer's own input) beside its plain version, its bound and the
    split sequence it replaces (attention_half with the attention kernel).
    Timing launches are not the main path's: the counts are restored."""
    counts = (fused_attention.launches, fused_int8_matmul.launches,
              fused_block_attention.launches)
    e2e = {}
    for bs in (64, 128, 256):
        x = _images(bs, seed=80 + bs)
        runs = {"int8": [], "bf16": []}
        for mode in ("int8", "bf16", "bf16", "int8"):
            m = qcms if mode == "int8" else cms
            runs[mode].append(_time_ms(lambda: _forward(
                m, ens, x, dtype=torch.bfloat16, use_kernel=True, fast_math=True,
                int8=mode == "int8"), iters=5, warmup=1))
        ms = {k: sum(v) / len(v) for k, v in runs.items()}
        e2e[bs] = dict(int8_ms=ms["int8"], bf16_ms=ms["bf16"], int8_img_s=bs / ms["int8"] * 1e3,
                       bf16_img_s=bs / ms["bf16"] * 1e3, runs_ms=runs)
        print(f"[int8-time] forward bs{bs}, bf16 fast_math: int8 {ms['int8']:.3f} ms = "
              f"{bs / ms['int8'] * 1e3:.1f} img/s, bf16 {ms['bf16']:.3f} ms = "
              f"{bs / ms['bf16'] * 1e3:.1f} img/s; turns {runs} [{card}]")

    gen = torch.Generator(device="cuda").manual_seed(81)
    M = 256 * N
    calls = {}
    for cm in cms:
        for shape in _int8_shapes(cm):
            calls[shape] = calls.get(shape, 0) + 1
    per_shape = {}
    for (K, Nn), (kern, bias) in _deployed_weights(cms).items():
        q = quantize_weight(kern, bias)
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
        wq_cm = q.w_q.t().contiguous().t()  # cuBLASLt's int8 layout: the weight column-major
        wb = kern.bfloat16()
        bound, _ = _int8_bound(M, K, Nn)
        per_shape[(K, Nn)] = dict(
            ms=_time_ms(lambda: fused_int8_matmul(x, q), iters=10, warmup=2),
            plain_ms=_time_ms(lambda: dynamic_int8_matmul(x, q), iters=3, warmup=1),
            library_ms=_time_ms(lambda: torch._int_mm(xq, wq_cm), iters=10, warmup=2),
            bf16_ms=_time_ms(lambda: torch.matmul(x, wb), iters=10, warmup=2),
            bound_ms=bound, calls=calls[(K, Nn)])
        r = per_shape[(K, Nn)]
        print(f"[int8-time] fused_int8_matmul M={M} K={K} N={Nn} (x{r['calls']} a forward): "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, torch._int_mm (dot alone) "
              f"{r['library_ms']:.4f}, bf16 matmul {r['bf16_ms']:.4f}, bound {bound:.4f} [{card}]")
    int8_fwd = {k: sum(r["calls"] * r[k] for r in per_shape.values())
                for k in ("ms", "plain_ms", "library_ms", "bf16_ms", "bound_ms")}
    int8_fwd["calls"] = sum(r["calls"] for r in per_shape.values())
    bytes_ms = sum(r["calls"] * _int8_bound(M, K, Nn)[1] for (K, Nn), r in per_shape.items())
    int8_fwd["bound_by"] = ("bytes" if bytes_ms >= int8_fwd["bound_ms"] * (1 - 1e-9)
                            else "operations")
    print(f"[int8-time] fused_int8_matmul over one bs256 forward ({int8_fwd['calls']} calls): "
          f"kernel {int8_fwd['ms']:.3f} ms, plain {int8_fwd['plain_ms']:.3f}, torch._int_mm "
          f"{int8_fwd['library_ms']:.3f}, bf16 matmul {int8_fwd['bf16_ms']:.3f}, bound "
          f"{int8_fwd['bound_ms']:.3f} ({int8_fwd['bound_by']}) [{card}]")

    x = _images(256, seed=82)
    block = {"ms": 0.0, "plain_ms": 0.0, "split_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0}
    for cm in cms:
        t = embed_patches(cm, x, patch_size=16, dtype=torch.bfloat16)
        for lp in cm.layers:
            args, kw = _block_args(lp, t), dict(num_heads=lp.num_heads, eps=cm.eps)
            block["ms"] += _time_ms(lambda: fused_block_attention(*args, **kw), iters=3, warmup=1)
            block["plain_ms"] += _time_ms(lambda: reference_block_attention(*args, **kw),
                                          iters=3, warmup=1)
            block["split_ms"] += _time_ms(lambda: attention_half(lp, t, eps=cm.eps), iters=3,
                                          warmup=1)
            bound, bytes_ms = _block_bound(256, t.shape[-1], lp.num_heads * DH)
            block["bound_ms"] += bound
            block["bytes_ms"] += bytes_ms
            t = mlp_half(lp, attention_half(lp, t, eps=cm.eps), eps=cm.eps)
    block["bound_by"] = "bytes" if block["bytes_ms"] >= block["bound_ms"] * (1 - 1e-9) else \
        "operations"
    print(f"[int8-time] fused_block_attention over one bs256 forward's {sum(len(cm.layers) for cm in cms)} layers (bf16): kernel "
          f"{block['ms']:.3f} ms, plain {block['plain_ms']:.3f}, the split sequence it replaces "
          f"{block['split_ms']:.3f}, bound {block['bound_ms']:.3f} ({block['bound_by']}) [{card}]")
    fused_attention.launches, fused_int8_matmul.launches, fused_block_attention.launches = counts
    return dict(forward=e2e, int8_per_shape={f"{k}x{n}": r for (k, n), r in per_shape.items()},
                int8_forward=int8_fwd, block_forward=block)


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


LONG_N = (258, 578, 1026)  # 256 px and 384 px (deit-base 384) at patch 16; 512 px
LONG_TIME_N = 578


def _split_plain(x, g, kh):
    return torch.cat([reference_attention_bwd_dqdk(x, g, kh),
                      reference_attention_bwd_dv(x, g, kh)], dim=-1)


BWD_WRAPPERS = {  # name -> (the kernel's wrapper, its plain version)
    "attention_bwd": (attention_bwd, reference_attention_bwd),
    "attention_bwd_split": (attention_bwd_split, _split_plain),
    "attention_bwd_dqdk": (attention_bwd_dqdk, reference_attention_bwd_dqdk),
    "attention_bwd_dv": (attention_bwd_dv, reference_attention_bwd_dv),
}


def phase_bwd_long(card: str) -> dict:
    """The four backward wrappers past 256 keys, where they walk 256-key
    chunks (csrc/attention_bwd_long.cu): each vs its plain version, dq, dk
    and dv each on its own, at N 258, 578 and 1026, kh 1/6/12, bf16 and f32,
    every call repeated bit for bit; then one launch of each timed at B 64,
    kh 6, N 578 in both dtypes beside its plain version, its bound and SDPA's
    backward on the same inputs. These launches are not the main path's:
    the counts are restored. Returns the largest bf16 max-abs error of each
    wrapper and the times."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    before = _counts()
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    max_abs = dict.fromkeys(BWD_WRAPPERS, 0.0)
    n_cases = 0
    for dtype in (torch.bfloat16, torch.float32):
        for n in LONG_N:
            for kh, B in ((1, 3), (6, 2), (12, 1)):
                C = kh * DH
                x = torch.randn((B, n, 3 * C), generator=gen, device="cuda").to(dtype)
                g = torch.randn((B, n, C), generator=gen, device="cuda").to(dtype)
                for name, (fn, plain) in BWD_WRAPPERS.items():
                    got, again = fn(x, g, kh), fn(x, g, kh)
                    torch.cuda.synchronize()
                    want = plain(x, g, kh)
                    errs = [_rel(got[..., i * C:(i + 1) * C], want[..., i * C:(i + 1) * C])
                            for i in range(got.shape[-1] // C)]
                    if max(errs) > TOL[dtype] or not torch.equal(got, again):
                        raise AssertionError(f"{name} {dtype} N={n} kh={kh} B={B}: rel err "
                                             f"{errs} (tol {TOL[dtype]:.0e}), repeat identical "
                                             f"{torch.equal(got, again)}")
                    if dtype == torch.bfloat16:
                        max_abs[name] = max(max_abs[name],
                                            float((got.float() - want.float()).abs().max()))
                    worst[dtype] = max(worst[dtype], max(errs))
                    n_cases += 1
    print(f"[bwd-long] attention_bwd, attention_bwd_split, attention_bwd_dqdk, attention_bwd_dv "
          f"past 256 keys vs plain: {n_cases} cases pass (N {list(LONG_N)}, kh 1/6/12, bf16 and "
          f"f32; dq, dk, dv each); worst rel err bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), "
          f"f32 {worst[torch.float32]:.3e} (tol 1e-4); max abs err bf16 "
          f"{', '.join(f'{k} {v:.3e}' for k, v in max_abs.items())}; repeat launches "
          f"bit-identical")

    B, kh, n = ENS_B, 6, LONG_TIME_N
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for dtype, peak in ((torch.bfloat16, BF16_FLOPS), (torch.float32, F32_FLOPS)):
        x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").to(dtype)
        q, k, v = (t.contiguous().requires_grad_() for t in
                   x.view(B, n, 3, kh, DH).permute(2, 0, 3, 1, 4))
        out = sdpa(q, k, v)
        gh = g.view(B, n, kh, DH).transpose(1, 2)
        library = _time_ms(lambda: torch.autograd.grad(out, (q, k, v), gh, retain_graph=True),
                           iters=5, warmup=1)
        elem = x.element_size()
        bwd_bound = _bwd_bound(B, kh, elem, peak, n)
        split = _split_bounds(B, kh, elem, peak, n)
        bounds = {"attention_bwd": bwd_bound, "attention_bwd_split": bwd_bound,
                  "attention_bwd_dqdk": (split["dqdk"][0], split["dqdk"][1] == "bytes"),
                  "attention_bwd_dv": (split["dv"][0], split["dv"][1] == "bytes")}
        for name, (fn, plain) in BWD_WRAPPERS.items():
            r = dict(ms=_time_ms(lambda: fn(x, g, kh), iters=5, warmup=1),
                     plain_ms=_time_ms(lambda: plain(x, g, kh), iters=3, warmup=1),
                     library_ms=library, bound_ms=bounds[name][0],
                     bound_by="bytes" if bounds[name][1] else "operations")
            times[f"{name} {str(dtype)[6:]}"] = r
            print(f"[bwd-long] {name} {str(dtype)[6:]} B={B} N={n} kh={kh}: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA backward "
                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}) [{card}]")
        del x, g, q, k, v, out
    _set_counts(before)
    torch.cuda.empty_cache()
    return dict(max_abs=max_abs, worst={str(k)[6:]: v for k, v in worst.items()},
                cases=n_cases, times=times)


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
    # bf16: attn_bwd_kernel_mma<DQDK, DV>; f32: attn_bwd_kernel and the
    # split pair's attn_bwd_dv_kernel / attn_bwd_dqdk_kernel
    if "attn_bwd_dv_kernel" in kernel_name or "attn_bwd_kernel_mma<false, true>" in kernel_name:
        return "attention backward, dv (attention_bwd_dv)"
    if ("attn_bwd_dqdk_kernel" in kernel_name
            or "attn_bwd_kernel_mma<true, false>" in kernel_name):
        return "attention backward, dq/dk (attention_bwd_dqdk)"
    if "attn_bwd_kernel" in kernel_name:
        return "attention backward (attention_bwd)"
    if "attn_bwd_long" in kernel_name:
        return "attention backward past 256 keys"
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
    _set_counts((0, 0, 0, 0))
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


def _bwd_bound(B: int, kh: int, elem: int, flops_peak: float, n: int = N):
    """Least time of one backward launch: qkv and g read once, dqkv written
    once (7 B N C elements), against recomputing s, then dv, dp, dq and dk
    (10 B N^2 C operations)."""
    C = kh * DH
    nbytes = 7 * B * n * C * elem
    flops = 10 * B * n * n * C
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


ENS_B, ENS_D, ENS_CLASSES, DEKD_CLASSES = 64, 4, 100, 25
ENS_MODES = ("monolithic", "split", "plain")
_KERNELS = (fused_attention, attention_bwd, attention_bwd_dv, attention_bwd_dqdk)


def _counts() -> tuple:
    return tuple(k.launches for k in _KERNELS)


def _set_counts(counts) -> None:
    for k, c in zip(_KERNELS, counts):
        k.launches = c


def _delta(before) -> tuple:
    return tuple(a - b for a, b in zip(_counts(), before))


def _set_mode(models, mode: str) -> None:
    """Attention of `models` through the kernels with the backward `mode`
    picks from DEVIT_ATTN_BWD (as a user selects it), or the plain path."""
    for m in models:
        m.use_kernel = mode != "plain"
    os.environ["DEVIT_ATTN_BWD"] = "split" if mode == "split" else "monolithic"


def _mixup(num_classes: int) -> MixupConfig:
    return MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5,
                       label_smoothing=0.1, num_classes=num_classes)


def _teacher(num_classes: int):
    """deit_base_distilled_patch16_224 (768 wide, 12 heads) with random
    weights from a seed, bf16 compute."""
    return create_vit("deit_base_distilled_patch16_224", num_classes=num_classes,
                      dtype=torch.bfloat16, use_kernel=True, device="cuda",
                      generator=torch.Generator().manual_seed(5))


def _teacher_logits_check(teacher, images: torch.Tensor, tag: str, card: str) -> dict:
    """The teacher's logits with the attention kernel against the plain
    attention on the same images, at the bf16 limit, and the images whose
    argmax the two give differently. Hard distillation trains against that
    argmax, and its bf16 logits tie within an ulp for some images, so the
    one-step checks hold the teacher on the kernel in both steps and this
    check holds the teacher itself."""
    with torch.no_grad():
        teacher.use_kernel = False
        plain = teacher(images, distill_token=True).logits.float()
        teacher.use_kernel = True
        before = _counts()
        kern = teacher(images, distill_token=True).logits.float()
        torch.cuda.synchronize()
        _set_counts(before)  # the check's launches are not the main path's
    rel = _rel(kern, plain)
    top2 = plain.topk(2, dim=-1).values
    flips = (kern.argmax(-1) != plain.argmax(-1)).nonzero().flatten().tolist()
    if rel > 2e-2:
        raise AssertionError(f"{tag} teacher logits kernel vs plain: rel err {rel:.3e} > 2e-2")
    print(f"{tag} teacher logits, attention kernel vs plain (bs{images.shape[0]}): rel err "
          f"{rel:.3e} (tol 2e-2), max abs {float((kern - plain).abs().max()):.3e}; argmax differs "
          f"for images {flips} (plain top-2 gaps "
          f"{[float(top2[i, 0] - top2[i, 1]) for i in flips]}), so the one-step check keeps the "
          f"teacher on the kernel in both steps [{card}]")
    return dict(rel=rel, argmax_flips=flips)


def _division_gates() -> Gates:
    """The canonical shrink policies of the deployed divisions
    (deploy.build_inputs: screen(0.3 x 9.19 GMACs, seed 42+i) -> build_gates)."""
    _, _, gates_list = deploy.build_inputs(ENS_D)
    g = stack_division_gates(gates_list)
    return Gates(g.head.float().to("cuda"), g.neuron.float().to("cuda"))


def _ens_setup(card: str) -> dict:
    """The stage-5 configuration: four full-width dedeit divisions (drop_path
    0.1, bf16 compute, f32 parameters, full remat), gated by the deployed
    shrink policies; the deit-base teacher; EnsMLP(teacher 768, 100 classes,
    deit); hard distillation (alpha 0.5, mse tokens), mixup 0.8 / cutmix 1.0,
    smoothing 0.1; AdamW lr 3e-4, weight decay 0.05, EMA on both states."""
    backbone = create_vit("dedeit", num_classes=ENS_CLASSES, drop_path_rate=0.1,
                          dtype=torch.bfloat16, use_kernel=True, use_remat=True, device="cuda",
                          generator=torch.Generator().manual_seed(0))
    stacked = init_multivit(backbone, [torch.Generator().manual_seed(42 + i)
                                       for i in range(ENS_D)])
    teacher = _teacher(ENS_CLASSES)
    ens = EnsMLP(num_classes=ENS_CLASSES, sub_size=backbone.cfg.embed_dim, num_divisions=ENS_D,
                 teacher_size=teacher.cfg.embed_dim, family="deit")
    ens = ens.reset_parameters(torch.Generator().manual_seed(9)).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(40)
    px = backbone.cfg.img_size
    images = torch.randn((ENS_B, px, px, 3), generator=gen, device="cuda").bfloat16()
    labels = torch.randint(0, ENS_CLASSES, (ENS_B,), generator=gen, device="cuda")
    L, Lt = backbone.cfg.depth, teacher.cfg.depth
    # the teacher alone: one forward launch a layer, at its kh (12 for deit-base)
    before = _counts()
    with torch.no_grad():
        teacher(images, distill_token=True)
    torch.cuda.synchronize()
    if _delta(before) != (Lt, 0, 0, 0):
        raise AssertionError(f"teacher forward launches {_delta(before)}, expected {Lt}")
    _set_counts(before)
    teacher_check = _teacher_logits_check(teacher, images, "[ens-train]", card)
    gates = _division_gates()
    # per step: each division's layers forward and again in the remat
    # re-forward, the teacher's once; one backward (or dv + dqdk) a layer
    fwd, bwd = 2 * ENS_D * L + Lt, ENS_D * L
    expect = {"monolithic": (fwd, bwd, 0, 0), "split": (fwd, 0, bwd, bwd), "plain": (0, 0, 0, 0)}
    print(f"[ens-train] stage-5 configuration: {ENS_D} dedeit divisions (kept heads per layer "
          f"{[[int(h) for h in g.sum(-1).tolist()] for g in gates.head]}), deit-base teacher "
          f"({Lt} launches at kh {teacher.cfg.num_heads} per forward), EnsMLP "
          f"{ENS_D}x{backbone.cfg.embed_dim} -> {teacher.cfg.embed_dim} -> {ENS_CLASSES}, "
          f"bs{ENS_B}; launches per step (fused, bwd, dv, dqdk) {expect} [{card}]")
    return dict(backbone=backbone, stacked=stacked, teacher=teacher, ens=ens, gates=gates,
                batch=(images, labels), expect=expect, teacher_check=teacher_check)


def _ens_states(setup: dict):
    """Fresh backbone and head states (and the step over them) from the
    setup's initial parameters."""
    cfg = OptimConfig(lr=3e-4, weight_decay=0.05, epochs=100)
    stacked = {k: torch.nn.Parameter(v.detach().clone()) for k, v in setup["stacked"].items()}
    ens = copy.deepcopy(setup["ens"])
    bb = TrainState.create(stacked, make_optimizer(cfg, 100), use_ema=True)
    en = TrainState.create(ens, make_optimizer(cfg, 100), use_ema=True)
    step = make_ensemble_train_step(setup["backbone"], ens, setup["teacher"],
                                    mixup=_mixup(ENS_CLASSES), smoothing=0.1,
                                    distillation_type="hard", distillation_alpha=0.5,
                                    token_loss_type="mse")
    return bb, en, step


def _grad_rel(got: dict, want: dict) -> dict:
    return {k: float((got[k].float() - want[k].float()).norm()
                     / want[k].float().norm().clamp_min(1e-30)) for k in want}


def phase_ens_train(card: str) -> dict:
    """The stage-5 ensemble step at full width, bs64, on the card: one step
    in each mode from one state, batch and draws (loss and every gradient
    leaf of both states within 2e-2 of the plain step), then steps through
    train_epoch in each mode, timed in turns."""
    setup = _ens_setup(card)
    models = (setup["backbone"], setup["teacher"])
    batch, gates, expect = setup["batch"], setup["gates"], setup["expect"]

    # the one-step check: the divisions' attention in each mode, the
    # teacher's on the kernel in all three (_teacher_logits_check)
    teacher = setup["teacher"]
    check_expect = {**expect, "plain": (teacher.cfg.depth, 0, 0, 0)}
    one = {}
    for mode in ENS_MODES:
        bb, en, step = _ens_states(setup)
        seen = {"bb": {}, "ens": {}}
        for key, st in (("bb", bb), ("ens", en)):
            update = st.tx.update
            st.tx.update = (lambda sink, upd: lambda g, s_, p_: (sink.update(g), upd(g, s_, p_))[1]
                            )(seen[key], update)
        _set_mode(models, mode)
        teacher.use_kernel = True
        before = _counts()
        _, _, metrics = step(bb, en, None, gates, *batch, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        launches = _delta(before)
        _set_counts(before)  # the comparison's launches are not the main path's
        if launches != check_expect[mode]:
            raise AssertionError(f"stage-5 {mode} step launches {launches}, expected "
                                 f"{check_expect[mode]}")
        one[mode] = (float(metrics["loss"]), seen)
        del bb, en, step
    loss_p, seen_p = one["plain"]
    checks = {"teacher_logits": setup["teacher_check"]}
    for mode in ("monolithic", "split"):
        loss_k, seen_k = one[mode]
        rel = {**{f"bb/{k}": v for k, v in _grad_rel(seen_k["bb"], seen_p["bb"]).items()},
               **{f"ens/{k}": v for k, v in _grad_rel(seen_k["ens"], seen_p["ens"]).items()}}
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        if not (np.isfinite(loss_k) and loss_rel <= 2e-2 and rel[worst] <= 2e-2):
            raise AssertionError(f"stage-5 step {mode} vs plain: loss {loss_k} vs {loss_p} (rel "
                                 f"{loss_rel:.3e}), worst gradient {worst} rel {rel[worst]:.3e}")
        checks[mode] = dict(loss=loss_k, loss_rel=loss_rel, worst_leaf=worst,
                            grad_rel_worst=rel[worst], leaves=len(rel))
        print(f"[ens-train] one step, {mode} kernels vs plain attention in the divisions (same "
              f"state, batch, draws and teacher): loss {loss_k:.6f} vs {loss_p:.6f} (rel "
              f"{loss_rel:.3e}); gradients of "
              f"both states: worst leaf {worst} ||diff||/||plain|| {rel[worst]:.3e} (tol 2e-2, "
              f"{len(rel)} leaves); launches per step {expect[mode]} (fused, bwd, dv, dqdk)")

    runs = {m: [] for m in ENS_MODES}
    per_step = {m: [] for m in ENS_MODES}
    peak = {m: 0.0 for m in ENS_MODES}
    losses = []
    carries = {m: _ens_states(setup) for m in ENS_MODES}

    def run(mode, n_steps, seed):
        bb, en, step = carries[mode]

        def fn(carry, images, labels, generator):
            before = _counts()
            b, e, metrics = step(*carry, None, gates, images, labels, generator)
            per_step[mode].append(_delta(before))
            losses.append(metrics["loss"])
            return (b, e), metrics

        _set_mode(models, mode)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (bb, en), _, _ = train_epoch(fn, (bb, en), [batch] * n_steps,
                                     torch.Generator().manual_seed(seed), epoch=0,
                                     log_fn=lambda *_: None)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated() / 2**30)
        carries[mode] = (bb, en, step)
        return ms

    # the main path: counts at 0, a warm-up step per mode, then the timed turns
    _set_counts((0, 0, 0, 0))
    for mode in ENS_MODES:
        run(mode, 1, seed=300)
    turn_steps = 6  # the step is host-bound at bs64, so its times spread: average more
    order = ("monolithic", "split", "plain", "plain", "split", "monolithic")
    for i, mode in enumerate(order):
        runs[mode].append(run(mode, turn_steps, seed=400 + i))
    launches = dict(zip(("fused_attention", "attention_bwd", "attention_bwd_dv",
                         "attention_bwd_dqdk"), _counts()))
    os.environ.pop("DEVIT_ATTN_BWD")
    for mode in ENS_MODES:
        bad = [c for c in per_step[mode] if c != expect[mode]]
        if bad or len(per_step[mode]) != 1 + 2 * turn_steps:
            raise AssertionError(f"stage-5 {mode} per-step launches {per_step[mode]}, expected "
                                 f"{expect[mode]} each")
    if min(launches.values()) == 0:
        raise AssertionError(f"stage-5 run launched a kernel of its path no time: {launches}")
    host_losses = [float(l) for l in losses]
    if not all(np.isfinite(host_losses)):
        raise AssertionError(f"non-finite stage-5 loss: {host_losses}")
    ms = {m: sum(v) / len(v) for m, v in runs.items()}
    for mode in ENS_MODES:
        print(f"[ens-train] stage-5 step ({mode}), {ENS_D} dedeit divisions + deit-base teacher "
              f"+ EnsMLP, bs{ENS_B}, bf16, remat, mixup/cutmix, 2 x AdamW + EMA: "
              f"{ms[mode]:.3f} ms/step = {ENS_B / ms[mode] * 1e3:.1f} img/s; turns (ms/step) "
              f"{runs[mode]}; {len(per_step[mode])} steps of {expect[mode]} launches (fused, "
              f"bwd, dv, dqdk); peak memory {peak[mode]:.2f} GiB [{card}]")
    print(f"[ens-train] {len(host_losses)} losses all finite (first {host_losses[0]:.4f}, last "
          f"{host_losses[-1]:.4f}); launches in the run {launches}")
    bb, en, step = carries["monolithic"]
    return dict(ms=ms, img_s={m: ENS_B / ms[m] * 1e3 for m in ms}, runs_ms=runs, peak_gib=peak,
                launches=launches, checks=checks, losses=host_losses, setup=setup,
                steps={m: carries[m] for m in ("monolithic", "split")})


def phase_ens_profile(ens: dict, card: str) -> dict:
    """Device time by kernel class over one stage-5 step in each kernel mode
    (torch.profiler) and the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    setup = ens["setup"]
    models = (setup["backbone"], setup["teacher"])
    out = {}
    for mode, (bb, en, step) in ens["steps"].items():
        _set_mode(models, mode)
        call = lambda: step(bb, en, None, setup["gates"], *setup["batch"],
                            torch.Generator().manual_seed(7))
        before = _counts()
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _set_counts(before)
        kernels = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_ms = sum(ms for _, _, ms in kernels)
        by_kind = {}
        for name, count, ms in kernels:
            acc = by_kind.setdefault(_step_kind(name), [0.0, 0])
            acc[0] += ms
            acc[1] += count
        print(f"[ens-train-profile] one bs{ENS_B} stage-5 step ({mode}): wall {wall_ms:.3f} ms, "
              f"device busy {busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}), "
              f"{sum(c for _, c, _ in kernels)} kernel launches [{card}]")
        for kind, (ms, count) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
            print(f"[ens-train-profile]   {kind}: {ms:.3f} ms ({ms / max(busy_ms, 1e-9):.1%} of "
                  f"device time), {count} launches")
        for name, count, ms in sorted(kernels, key=lambda k: -k[2])[:10]:
            print(f"[ens-train-profile]   {ms:8.3f} ms  x{count:<4d} {name[:100]}")
        out[mode] = dict(wall_ms=wall_ms, busy_ms=busy_ms, by_kind=by_kind,
                         top=sorted(kernels, key=lambda k: -k[2])[:25])
    os.environ.pop("DEVIT_ATTN_BWD")
    return out


def _split_bounds(B: int, kh: int, elem: int, flops_peak: float = BF16_FLOPS,
                  n: int = N) -> dict:
    """Least time of one launch of each split kernel: the dv kernel reads q,
    k and g and writes dv (4 B N C elements) against s and dv (4 B N^2 C
    operations); the dqdk kernel reads qkv and g and writes dq and dk (6 B N
    C elements) against s, dp, dq and dk (8 B N^2 C operations)."""
    C = kh * DH
    out = {}
    for name, elems, flops in (("dv", 4, 4), ("dqdk", 6, 8)):
        t_bytes = elems * B * n * C * elem / HBM_BYTES_PER_S
        t_ops = flops * B * n * n * C / flops_peak
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def phase_ens_kernel_times(card: str) -> dict:
    """The stage-5 step's attention kernels at their shapes, timed on their
    own beside their bounds, plain versions and library yardsticks: the split
    pair and the monolithic backward at B 64, kh 6 (48 launches per step
    each), the forward at kh 6 (96 per step) and at the teacher's kh 12 (12
    per step). SDPA's forward, and its backward through autograd, are timed
    here and never on the path."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    before = _counts()
    per = {}
    for kh in (6, 12):
        x = _qkv(ENS_B, kh, torch.bfloat16, gen)
        q, k, v = (t.contiguous() for t in x.view(ENS_B, N, 3, kh, DH).permute(2, 0, 3, 1, 4))
        per[f"fwd_kh{kh}"] = dict(ms=_time_ms(lambda: fused_attention(x, num_heads=kh)),
                                  plain_ms=_time_ms(lambda: reference_attention(x, num_heads=kh)),
                                  library_ms=_time_ms(lambda: sdpa(q, k, v)))
        bound, by_bytes = _bound(ENS_B, kh, 2, BF16_FLOPS)
        per[f"fwd_kh{kh}"].update(bound_ms=bound, bound_by="bytes" if by_bytes else "operations")
    kh = 6
    x = _qkv(ENS_B, kh, torch.bfloat16, gen)
    g = torch.randn((ENS_B, N, kh * DH), generator=gen, device="cuda").bfloat16()
    q, k, v = (t.contiguous().requires_grad_() for t in
               x.view(ENS_B, N, 3, kh, DH).permute(2, 0, 3, 1, 4))
    out = sdpa(q, k, v)
    gh = g.view(ENS_B, N, kh, DH).transpose(1, 2)
    library = _time_ms(lambda: torch.autograd.grad(out, (q, k, v), gh, retain_graph=True))
    bounds = _split_bounds(ENS_B, kh, 2)
    for name, fn, plain in (("dv", attention_bwd_dv, reference_attention_bwd_dv),
                            ("dqdk", attention_bwd_dqdk, reference_attention_bwd_dqdk)):
        per[name] = dict(ms=_time_ms(lambda: fn(x, g, kh)),
                         plain_ms=_time_ms(lambda: plain(x, g, kh)), library_ms=library,
                         bound_ms=bounds[name][0], bound_by=bounds[name][1])
    bb, bb_by = _bwd_bound(ENS_B, kh, 2, BF16_FLOPS)
    per["bwd"] = dict(ms=_time_ms(lambda: attention_bwd(x, g, kh)),
                      plain_ms=_time_ms(lambda: reference_attention_bwd(x, g, kh)),
                      library_ms=library, bound_ms=bb, bound_by="bytes" if bb_by else "operations")
    _set_counts(before)
    step = {}
    for name, n in (("fwd_kh6", 96), ("fwd_kh12", 12), ("dv", 48), ("dqdk", 48), ("bwd", 48)):
        r = per[name]
        step[name] = {key: n * r[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        step[name]["bound_by"] = r["bound_by"]
        print(f"[ens-time] {name} bf16 B={ENS_B} N={N}: kernel {r['ms']:.4f} ms/launch, plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}); x{n} per stage-5 step: kernel {n * r['ms']:.3f} ms, plain "
              f"{n * r['plain_ms']:.3f}, library {n * r['library_ms']:.3f}, bound "
              f"{n * r['bound_ms']:.3f} [{card}]")
    print(f"[ens-time] backward per stage-5 step: split pair {step['dv']['ms'] + step['dqdk']['ms']:.3f} "
          f"ms vs monolithic {step['bwd']['ms']:.3f} ms; SDPA backward (the pair's library "
          f"yardstick) {step['bwd']['library_ms']:.3f} ms [{card}]")
    return dict(per_launch=per, per_step=step)


def phase_dekd(card: str) -> dict:
    """The stage-4 DEKD step on the card: a gated full-width dedeit student
    (division 0's shrink policy, 25 classes), the deit-base teacher, bs64,
    gamma (0.2, 0.1, 0.3), hard distillation, clip_grad 1.0, mixup/cutmix,
    AdamW + EMA, in both distillation_inter modes; the False mode (kernels)
    against the same step with the plain attention."""
    student0 = create_vit("dedeit", num_classes=DEKD_CLASSES, drop_path_rate=0.1,
                          dtype=torch.bfloat16, use_kernel=True, use_remat=True, device="cuda",
                          generator=torch.Generator().manual_seed(1))
    teacher = _teacher(DEKD_CLASSES)
    g = _division_gates()
    gates = Gates(g.head[0], g.neuron[0])
    gen = torch.Generator(device="cuda").manual_seed(50)
    px = student0.cfg.img_size
    batch = (torch.randn((ENS_B, px, px, 3), generator=gen, device="cuda").bfloat16(),
             torch.randint(0, DEKD_CLASSES, (ENS_B,), generator=gen, device="cuda"))
    cfg = OptimConfig(epochs=100, weight_decay=0.05, clip_grad=1.0)

    def fresh(inter):
        student = copy.deepcopy(student0)
        state = TrainState.create(student, make_optimizer(cfg, 100), use_ema=True)
        step = make_dekd_step(student, teacher, gamma=(0.2, 0.1, 0.3), mixup=_mixup(DEKD_CLASSES),
                              smoothing=0.1, distillation_type="hard", distillation_alpha=0.5,
                              distillation_inter=inter)
        return student, state, step

    # distillation_inter=False: the student's attention kernels vs plain, one
    # step from one state, the teacher's on the kernel in both
    # (_teacher_logits_check)
    teacher_check = _teacher_logits_check(teacher, batch[0], "[dekd]", card)
    one = {}
    for mode in ("monolithic", "plain"):
        student, state, step = fresh(False)
        seen = {}
        update = state.tx.update
        state.tx.update = lambda g_, s_, p_: (seen.update(g_), update(g_, s_, p_))[1]
        _set_mode((student, teacher), mode)
        teacher.use_kernel = True
        before = _counts()
        _, metrics = step(state, None, gates, *batch, torch.Generator().manual_seed(2))
        torch.cuda.synchronize()
        _set_counts(before)
        one[mode] = (float(metrics["loss"]), seen)
    (loss_k, seen_k), (loss_p, seen_p) = one["monolithic"], one["plain"]
    rel = _grad_rel(seen_k, seen_p)
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if not (np.isfinite(loss_k) and loss_rel <= 2e-2 and rel[worst] <= 2e-2):
        raise AssertionError(f"DEKD (inter=False) kernels vs plain: loss {loss_k} vs {loss_p} "
                             f"(rel {loss_rel:.3e}), worst gradient {worst} rel {rel[worst]:.3e}")
    print(f"[dekd] one step, distillation_inter=False, the student's kernels vs plain attention "
          f"(same teacher): loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}); worst gradient leaf {worst} "
          f"||diff||/||plain|| {rel[worst]:.3e} (tol 2e-2, {len(rel)} leaves)")

    # student forward + re-forward, teacher, backward; inter=True captures the
    # middle layer of each, which runs the plain attention
    L, Lt = student0.cfg.depth, teacher.cfg.depth
    expect = {True: (2 * (L - 1) + Lt - 1, L - 1, 0, 0), False: (2 * L + Lt, L, 0, 0)}
    res = dict(loss_rel=loss_rel, grad_rel_worst=rel[worst], worst_leaf=worst,
               teacher_check=teacher_check)
    _set_counts((0, 0, 0, 0))  # the main path: both modes, the kernels on
    for inter in (True, False):
        student, state, step = fresh(inter)
        _set_mode((student, teacher), "monolithic")
        per_step, losses = [], []

        def fn(st, images, labels, generator):
            before = _counts()
            st, metrics = step(st, None, gates, images, labels, generator)
            per_step.append(_delta(before))
            losses.append(metrics["loss"])
            return st, metrics

        torch.cuda.reset_peak_memory_stats()
        state, _, _ = train_epoch(fn, state, [batch], torch.Generator().manual_seed(60),
                                  epoch=0, log_fn=lambda *_: None)
        n_steps = 4
        t0 = time.perf_counter()
        state, _, _ = train_epoch(fn, state, [batch] * n_steps,
                                  torch.Generator().manual_seed(61), epoch=0,
                                  log_fn=lambda *_: None)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        host = [float(l) for l in losses]
        if any(c != expect[inter] for c in per_step) or not all(np.isfinite(host)):
            raise AssertionError(f"DEKD inter={inter}: per-step launches {per_step} (expected "
                                 f"{expect[inter]}), losses {host}")
        print(f"[dekd] stage-4 step, distillation_inter={inter}, dedeit student + deit-base "
              f"teacher, bs{ENS_B}, bf16, remat, clip 1.0: {ms:.3f} ms/step = "
              f"{ENS_B / ms * 1e3:.1f} img/s; {len(per_step)} steps of {expect[inter]} launches "
              f"(fused, bwd, dv, dqdk); losses finite (first {host[0]:.4f}, last {host[-1]:.4f});"
              f" peak memory {peak:.2f} GiB [{card}]")
        res[f"inter_{inter}"] = dict(ms=ms, img_s=ENS_B / ms * 1e3, peak_gib=peak, losses=host)
    launches = dict(zip(("fused_attention", "attention_bwd", "attention_bwd_dv",
                         "attention_bwd_dqdk"), _counts()))
    os.environ.pop("DEVIT_ATTN_BWD")
    if launches["fused_attention"] == 0 or launches["attention_bwd"] == 0:
        raise AssertionError(f"DEKD run launched a kernel of its path no time: {launches}")
    res["launches"] = launches
    return res


# ---- stage 3: HSIC ranking, the policy search, padded compaction

# the CLI's defaults (devit_tpu/cli/__main__.py shrink, cli/common.py): rank
# batch 64, eval batch 512, candidate chunk 8, population 50, shrink ratio
# 0.3, lb 0, ub 0.9, seed 0; the canonical dedeit budget (9.19 GMACs anchor,
# seq 197)
S3 = dict(rank_batch=64, eval_batch=512, candidate_chunk=8, population=50, shrink_ratio=0.3,
          lb=0.0, ub=0.9, seed=0)
S3_SHRINK_KW = dict(layer=12, shrink_ratio=S3["shrink_ratio"], population=S3["population"],
                    lb=S3["lb"], ub=S3["ub"], full_gmacs=9.19, emb=384, head=6, seq_length=197,
                    mlp_ratio=4, candidate_chunk=S3["candidate_chunk"], seed=S3["seed"])


def _stage3_setup() -> dict:
    """Division 0 of a seed-42 4-way split of 100 synthetic classes (25
    classes): the val set (4000 images, ~1000 in the division, a ragged last
    batch at 512) and the train set (1024 images) at the model's input size,
    and full-width dedeit with random weights from a seed, bf16, fast_math."""
    t0 = time.perf_counter()
    manifest = DivisionManifest.create(100, 4, seed=42)
    train_ds = synthetic_dataset(100, 1024, PX, seed=0).division_view(manifest, 0)
    val_ds = synthetic_dataset(100, 4000, PX, seed=1).division_view(manifest, 0)
    data_s = time.perf_counter() - t0
    model = create_vit("dedeit", num_classes=val_ds.num_classes, dtype=torch.bfloat16,
                       fast_math=True, use_kernel=True, device="cuda",
                       generator=torch.Generator().manual_seed(8))
    cfg = model.cfg
    n_batches = -(-len(val_ds) // S3["eval_batch"])
    c_pad = -(-S3["population"] // S3["candidate_chunk"]) * S3["candidate_chunk"]
    print(f"[shrink-cfg] dedeit {cfg.embed_dim} wide, {cfg.depth} layers, {cfg.num_heads} "
          f"heads, dh {cfg.head_dim}, {cfg.img_size} px, N {cfg.seq_len}, {cfg.num_classes} "
          f"classes (division 0 of 4), random weights (seed 8), bf16, fast_math; train "
          f"{len(train_ds)} and val {len(val_ds)} images of synthetic_dataset(100, 1024/4000, "
          f"{PX}) (made in {data_s:.1f} s); val {n_batches} batches of {S3['eval_batch']} (the "
          f"last {len(val_ds) - (n_batches - 1) * S3['eval_batch']}); rank batch "
          f"{S3['rank_batch']}; population {S3['population']} padded to {c_pad}, chunks of "
          f"{S3['candidate_chunk']} ({S3['candidate_chunk'] * S3['eval_batch']} rows a "
          f"forward); shrink_ratio {S3['shrink_ratio']}, lb {S3['lb']}, ub {S3['ub']}; "
          f"cuts: none")
    return dict(model=model, train_ds=train_ds, val_ds=val_ds, n_batches=n_batches,
                c_pad=c_pad)


# ranks are held exactly wherever neighbouring sorted scores differ by more
# than this (relative to max|score|): the card's and the CPU's scores agree
# to ~1e-6 (an H100 80GB HBM3 at 700 W read 2.980e-7 on the combined neuron
# scores, 1.180e-6 on the heads'), and a swap needs a gap under twice their
# difference
TIE_TOL = 1e-5


def _ranks_agree(got_rank: np.ndarray, scores: np.ndarray, tol: float = TIE_TOL) -> tuple:
    """Raise unless got_rank equals argsort(scores) at every sorted position
    whose neighbouring scores differ by more than tol * max|score|. Returns
    (positions inside a tie, positions where the ranks differ)."""
    want = np.argsort(scores, axis=-1)
    s = np.take_along_axis(scores, want, axis=-1)
    gap = np.diff(s, axis=-1) > tol * np.abs(scores).max()
    clear = np.ones(s.shape, bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    differ = got_rank != want
    if (differ & clear).any():
        raise AssertionError(f"ranks differ outside the tie tolerance at "
                             f"{int((differ & clear).sum())} positions")
    return int((~clear).sum()), int(differ.sum())


def phase_shrink_rank(s3: dict, card: str) -> dict:
    """mlp_neuron_rank and attn_head_rank on one train batch (the capture
    forward takes the plain attention, as in JAX), timed; the HSIC scores on
    the card held to the CPU's on the same captured activations, and the
    ranks to the CPU scores' argsort outside TIE_TOL."""
    model = s3["model"]
    images, _ = next(iter(BatchIterator(s3["train_ds"], S3["rank_batch"], shuffle=True,
                                        seed=S3["seed"], prefetch=0)))
    x = normalize(torch.from_numpy(images).cuda())
    secs = {}
    for name, fn in (("mlp_neuron_rank", mlp_neuron_rank), ("attn_head_rank", attn_head_rank)):
        fn(model, x)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        secs[name] = (fn(model, x), time.perf_counter() - t0)
    (neuron_rank, neuron_s), (head_rank, head_s) = secs.values()
    with torch.no_grad():
        out = model(x, capture_rank_stats=True)
        probs = torch.softmax(out.logits.float(), dim=-1)
        card_scores = [*_neuron_scores(out.neuron_act, probs), _head_scores(out.head_out, probs)]
        cpu_scores = [*_neuron_scores(out.neuron_act.cpu(), probs.cpu()),
                      _head_scores(out.head_out.cpu(), probs.cpu())]
    card_np = [t.cpu().numpy() for t in card_scores]
    cpu_np = [t.numpy() for t in cpu_scores]
    rels = {k: float(np.abs(g - w).max() / np.abs(w).max())
            for k, g, w in zip(("hsic", "act_sum", "head"), card_np, cpu_np)}
    tol = TOL[torch.float32]
    neuron_card = neuron_rank_scores(*card_np[:2])
    neuron_cpu = neuron_rank_scores(*cpu_np[:2])
    rels["neuron_combined"] = float(np.abs(neuron_card - neuron_cpu).max()
                                    / np.abs(neuron_cpu).max())
    if not (np.array_equal(neuron_rank, np.argsort(neuron_card, axis=-1))
            and np.array_equal(head_rank, np.argsort(card_np[2], axis=-1))):
        raise AssertionError("a rank function differs from the argsort of its own scores")
    print(f"[shrink-rank] mlp_neuron_rank {neuron_s:.3f} s, attn_head_rank {head_s:.3f} s on "
          f"one batch of {S3['rank_batch']} (capture forward + HSIC on the card, argsort on the "
          f"host); scores card vs CPU (f32, same activations): max-abs / max-ref "
          f"{', '.join(f'{k} {v:.3e}' for k, v in rels.items())} (tol {tol:.0e}) [{card}]")
    if max(rels.values()) > tol:
        raise AssertionError(f"HSIC scores on the card vs the CPU: {rels} > {tol}")
    n_tied, n_diff = _ranks_agree(neuron_rank, neuron_cpu)
    h_tied, h_diff = _ranks_agree(head_rank, cpu_np[2])
    print(f"[shrink-rank] ranks card vs CPU scores, equal outside ties (neighbours within "
          f"{TIE_TOL:.0e} x max|score|): neurons {neuron_rank.shape} {n_tied} positions tied "
          f"({n_tied / neuron_rank.size:.2%} excused), {n_diff} differ; heads {head_rank.shape} "
          f"{h_tied} tied ({h_tied / head_rank.size:.2%}), {h_diff} differ")
    return dict(neuron_rank=neuron_rank, head_rank=head_rank, mlp_neuron_rank_s=neuron_s,
                attn_head_rank_s=head_s, score_rel=rels, tie_tol=TIE_TOL, neuron_tied=n_tied,
                neuron_differ=n_diff, head_tied=h_tied, head_differ=h_diff)


def _chunk_inputs(s3: dict, ranks: dict):
    """Candidates 0-7 of model_shrink's population (the same screen call)
    on the division's first val batch: the gates on the card, the prepared
    images and the labels."""
    policies = screen(S3["shrink_ratio"] * 9.19, S3["population"], S3["lb"], S3["ub"], 12,
                      emb=384, head=6, seq_length=197, seed=S3["seed"])
    g = policies_to_gates(policies[:S3["candidate_chunk"]], ranks["neuron_rank"],
                          ranks["head_rank"], 12)
    images, labels = next(iter(BatchIterator(s3["val_ds"], S3["eval_batch"], shuffle=False,
                                             drop_last=False, prefetch=0)))
    return (Gates(torch.from_numpy(g.head).cuda(), torch.from_numpy(g.neuron).cuda()),
            normalize(torch.from_numpy(images).cuda()), torch.from_numpy(labels).cuda())


def phase_shrink_eval(s3: dict, ranks: dict, card: str) -> dict:
    """One candidate chunk at the full C*B rows: the kernel against the plain
    attention (logits, and counts that may differ only on near-tied rows),
    and the folded forward against one forward per candidate."""
    model = s3["model"]
    gates, x, labels = _chunk_inputs(s3, ranks)
    C, B = gates.head.shape[0], x.shape[0]
    tol = TOL[torch.bfloat16]
    before = _counts()
    with torch.no_grad():
        folded, xf = fold_candidates(gates, x)
        got = model(xf, folded).logits.view(C, B, -1)
        model.use_kernel = False
        plain = model(xf, folded).logits.view(C, B, -1)
        model.use_kernel = True
        counts = make_batched_policy_eval(model)(gates, x, labels)
        per = torch.stack([model(x, Gates(gates.head[c], gates.neuron[c])).logits
                           for c in range(C)])
    torch.cuda.synchronize()
    _set_counts(before)  # comparison launches are not the main path's
    del xf, folded
    rel = max(_rel(got[c], plain[c]) for c in range(C))
    rel_per = _rel(got, per)
    pred_k, pred_p = got.argmax(-1), plain.argmax(-1)
    top2 = plain.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < tol * plain.abs().amax(dim=(1, 2), keepdim=True)[..., 0]
    flips = pred_k != pred_p
    counts_k = (pred_k == labels[None]).sum(1)
    counts_p = (pred_p == labels[None]).sum(1)
    print(f"[shrink-eval] one chunk, {C} candidates x {B} images = {C * B} rows, bf16: logits "
          f"kernel vs plain worst candidate rel {rel:.3e} (tol {tol:.0e}); folded vs {C} "
          f"per-candidate forwards at B {B} through the kernel rel {rel_per:.3e}; correct counts "
          f"kernel {counts_k.tolist()}, plain {counts_p.tolist()}; {int(flips.sum())} argmax "
          f"flips, all among the {int(near.sum())} rows whose plain top-2 gap is under "
          f"{tol:.0e} x max|logit| [{card}]")
    if rel > tol or rel_per > tol:
        raise AssertionError(f"[shrink-eval] rel {rel:.3e} / {rel_per:.3e} > {tol}")
    if (flips & ~near).any():
        raise AssertionError(f"[shrink-eval] {int((flips & ~near).sum())} argmax flips on rows "
                             "that are not near-tied")
    if not torch.equal(counts.cpu(), counts_k.cpu()):
        raise AssertionError(f"make_batched_policy_eval counts {counts.tolist()} != the folded "
                             f"forward's {counts_k.tolist()}")
    del got, plain, per
    torch.cuda.empty_cache()
    return dict(rel=rel, rel_per_candidate=rel_per, near_tied=int(near.sum()),
                flips=int(flips.sum()), counts=counts_k.tolist(), plain_counts=counts_p.tolist())


def _val_batches(ds):
    def batches():
        # raw host batches: evaluate_policies pads the ragged tail, then
        # prepares it on the card
        for imgs, labels in BatchIterator(ds, S3["eval_batch"], shuffle=False, drop_last=False):
            yield imgs, np.asarray(labels)
    return batches


def phase_shrink(s3: dict, ranks: dict, card: str) -> dict:
    """model_shrink over the division's val set, as the shrink stage calls it;
    the four .npy files; then the times of one chunk forward and of one
    fused_attention launch at its shape."""
    model = s3["model"]
    torch.cuda.reset_peak_memory_stats()
    before = fused_attention.launches
    t0 = time.perf_counter()
    result = model_shrink(model, ranks["neuron_rank"], ranks["head_rank"],
                          _val_batches(s3["val_ds"]), prepare=normalize, **S3_SHRINK_KW)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fused_attention.launches - before
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunks = s3["c_pad"] // S3["candidate_chunk"]
    expect = chunks * s3["n_batches"] * 12
    n_val, P = len(s3["val_ds"]), len(result.policies)
    acc = result.accuracies
    if launches != expect or acc.shape != (P,) or not np.isfinite(acc).all():
        raise AssertionError(f"model_shrink: {launches} launches (expected {expect}), "
                             f"accuracies {acc}")
    if not np.allclose(acc * n_val / 100, np.round(acc * n_val / 100)) or acc.max() > 100:
        raise AssertionError(f"model_shrink accuracies are not counts of {n_val}: {acc}")
    best = result.best
    kw = dict(emb=384, head=6, seq_length=197, layer=12)
    macs = cal_shrink_macs(best[:12], best[12:], **kw)
    paras = cal_shrink_paras(best[:12], best[12:], num_class=model.cfg.num_classes, **kw)
    if abs(macs - 0.3 * 9.19) > 0.02 * 0.3 * 9.19:
        raise AssertionError(f"the best policy's MACs {macs} miss the budget")
    with tempfile.TemporaryDirectory() as d:
        files = dict(shrinked_policy=result.policies, shrinked_accuracy=acc,
                     neuron_rank=ranks["neuron_rank"], head_rank=ranks["head_rank"])
        for k, v in files.items():
            np.save(os.path.join(d, f"{k}.npy"), v)
        for k, v in files.items():
            back = np.load(os.path.join(d, f"{k}.npy"))
            if back.dtype != v.dtype or not np.array_equal(back, v):
                raise AssertionError(f"{k}.npy did not read back")
    print(f"[shrink] model_shrink: {P} candidates (padded to {s3['c_pad']}) x {n_val} val "
          f"images in {secs:.3f} s = {P * n_val / secs:.1f} candidate-images/s; {launches} "
          f"fused_attention launches ({chunks} chunks x {s3['n_batches']} batches x 12 layers, "
          f"B {S3['candidate_chunk'] * S3['eval_batch']}); peak memory {peak:.2f} GiB; best "
          f"policy acc {acc.max():.2f}% (mean {acc.mean():.2f}%), {macs:.4f} GMACs, {paras:.4f} "
          f"M params; the four .npy files written and read back [{card}]")

    # one chunk forward, kernel and plain attention in turns
    gates, x, _ = _chunk_inputs(s3, ranks)
    with torch.no_grad():
        folded, xf = fold_candidates(gates, x)
        runs = {True: [], False: []}
        before = fused_attention.launches
        for use_kernel in (True, False, False, True):
            model.use_kernel = use_kernel
            runs[use_kernel].append(_time_ms(lambda: model(xf, folded), iters=2, warmup=1))
        model.use_kernel = True
        fused_attention.launches = before
        rows = S3["candidate_chunk"] * S3["eval_batch"]
        prof = _profile(lambda: model(xf, folded), "[shrink-profile]",
                        f"one chunk forward ({rows} rows)", card)
    del xf, folded
    torch.cuda.empty_cache()
    fwd_ms, plain_ms = (sum(runs[k]) / 2 for k in (True, False))
    n_fwd = chunks * s3["n_batches"]
    print(f"[shrink] one chunk forward ({rows} rows, bf16, fast_math, gated): {fwd_ms:.3f} ms "
          f"with the kernel, {plain_ms:.3f} ms with the plain attention; runs {runs}; the "
          f"search's {n_fwd} chunk forwards at that time are {n_fwd * fwd_ms / 1e3 / secs:.1%} "
          f"of its wall time [{card}]")

    # fused_attention at the chunk's shape: held to its plain version (an
    # all-zero head, a head gate, neither; each launch repeated bit for bit),
    # then timed on the last case's input
    gen = torch.Generator(device="cuda").manual_seed(9)
    before = fused_attention.launches
    checks = {}
    for case in ("zero_head", "gate", "plain"):
        q = _qkv(rows, 6, torch.bfloat16, gen, zero_head=case == "zero_head")
        gate = torch.rand((6,), generator=gen, device="cuda") if case == "gate" else None
        got = fused_attention(q, gate, num_heads=6)
        same = torch.equal(got, fused_attention(q, gate, num_heads=6))
        want = reference_attention(q, gate, num_heads=6)
        checks[case] = (_rel(got, want), float((got.float() - want.float()).abs().max()), same)
        del got, want
    torch.cuda.empty_cache()
    print(f"[shrink] fused_attention bf16 B={rows} N={N} kh=6 vs plain: "
          f"{', '.join(f'{k} rel {r:.3e} max-abs {a:.3e}' for k, (r, a, _) in checks.items())} "
          f"(tol {TOL[torch.bfloat16]:.0e}); repeat launches bit for bit: "
          f"{all(c[2] for c in checks.values())} [{card}]")
    if any(r > TOL[torch.bfloat16] or not same for r, _, same in checks.values()):
        raise AssertionError(f"fused_attention at B {rows}: {checks}")
    qh, kh_, vh = q.view(rows, N, 3, 6, DH).permute(2, 0, 3, 1, 4)
    att = dict(checks={k: dict(rel=r, max_abs=a) for k, (r, a, _) in checks.items()},
               max_abs_err=max(a for _, a, _ in checks.values()),
               ms=_time_ms(lambda: fused_attention(q, num_heads=6), iters=10),
               plain_ms=_time_ms(lambda: reference_attention(q, num_heads=6), iters=3),
               library_ms=_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                   qh, kh_, vh), iters=10))
    fused_attention.launches = before
    bound, by_bytes = _bound(rows, 6, 2, BF16_FLOPS)
    att.update(bound_ms=bound, bound_by="bytes" if by_bytes else "operations")
    del q, qh, kh_, vh
    torch.cuda.empty_cache()
    print(f"[shrink] fused_attention bf16 B={rows} N={N} kh=6: kernel {att['ms']:.4f} ms a "
          f"launch, plain {att['plain_ms']:.4f} ms, sdpa {att['library_ms']:.4f} ms, bound "
          f"{bound:.4f} ms ({att['bound_by']}) [{card}]")
    return dict(result=result, seconds=secs, cand_img_s=P * n_val / secs, launches=launches,
                peak_gib=peak, best_acc=float(acc.max()), best_gmacs=macs, best_mparams=paras,
                chunk_ms=fwd_ms, chunk_plain_ms=plain_ms, chunk_runs=runs, attention=att,
                profile=prof)


def phase_compact(s3: dict, ranks: dict, result, card: str) -> dict:
    """The best policy's gates compacted (padded to the widest layer), the
    compacted VisionTransformer at bs64 through the kernel against the gated
    model."""
    model = s3["model"]
    best = result.best
    g = build_gates(ranks["neuron_rank"], ranks["head_rank"], best[:12], best[12:])
    params, ccfg = compact_vit_params(model, g, model.cfg)
    cm = VisionTransformer(ccfg, dtype=torch.bfloat16, fast_math=True, use_kernel=True)
    cm.load_state_dict({k: v.cpu() for k, v in params.items()})
    cm = cm.cuda()
    images, _ = next(iter(BatchIterator(s3["val_ds"], 64, shuffle=False, prefetch=0)))
    x = normalize(torch.from_numpy(images).cuda())
    with torch.no_grad():
        before = fused_attention.launches
        got = cm(x).logits
        torch.cuda.synchronize()
        launches = fused_attention.launches - before
        before = fused_attention.launches
        want = model(x, Gates(torch.from_numpy(g.head).cuda(),
                              torch.from_numpy(g.neuron).cuda())).logits
        fused_attention.launches = before
    rel = _rel(got, want)
    n_params = count_params_brute(cm)
    print(f"[compact] best policy compacted to {ccfg.num_heads} heads (kept per layer "
          f"{g.head.sum(-1).astype(int).tolist()}) and MLP width {ccfg.hidden_dim} (kept "
          f"{g.neuron.sum(-1).astype(int).tolist()}), {n_params / 1e6:.3f} M params; bs64 "
          f"logits through the kernel (kh {ccfg.num_heads}, {launches} launches) vs the gated "
          f"model rel {rel:.3e} (tol 2e-2) [{card}]")
    if rel > TOL[torch.bfloat16] or launches != 12:
        raise AssertionError(f"[compact] rel {rel:.3e}, {launches} launches")
    return dict(num_heads=ccfg.num_heads, hidden=ccfg.hidden_dim, rel=rel, launches=launches,
                mparams=n_params / 1e6)


def phase_stage3(card: str) -> dict:
    s3 = _stage3_setup()
    _set_counts((0, 0, 0, 0))  # the main path: ranking, then the search
    ranks = phase_shrink_rank(s3, card)
    rank_counts = _counts()
    if rank_counts != (0, 0, 0, 0):  # the capture forwards take the plain attention
        raise AssertionError(f"the ranking launched kernels: {rank_counts}")
    ev = phase_shrink_eval(s3, ranks, card)
    shrink = phase_shrink(s3, ranks, card)
    result = shrink.pop("result")
    _set_counts((0, 0, 0, 0))
    comp = phase_compact(s3, ranks, result, card)
    # the main path is the ranking and model_shrink; [compact] is a check's
    # own forward, its launches stand in its own line
    res = dict(rank={k: v for k, v in ranks.items() if not k.endswith("_rank")}, eval=ev,
               shrink=shrink, compact=comp, launches=shrink["launches"])
    del s3
    torch.cuda.empty_cache()
    return res


# ---- head widths 32, 64 and 128 in every attention kernel

HEAD_KH = {32: 12, 64: 6, 128: 6}  # heads at the timed shapes: C 384, 384 and 768
BLOCK_KH = {32: 5, 64: 3, 128: 3}  # the block half: K 160 (not a multiple of 64), 192, 384


def _sdpa_qkv(x: torch.Tensor, kh: int):
    B, n, C3 = x.shape
    dh = C3 // (3 * kh)
    return (t.contiguous() for t in x.view(B, n, 3, kh, dh).permute(2, 0, 3, 1, 4))


def phase_heads(card: str) -> dict:
    """Each attention kernel at head widths 32, 64 and 128, bf16 and f32,
    against its plain version (max-abs over max-ref: 2e-2 bf16, 1e-4 f32; dq,
    dk and dv each on its own), every repeat launch bit for bit, the split
    pair equal to the monolithic kernel bit for bit; then each timed at the
    stage shapes (bf16): the forward at B 256, the backwards at B 64, the
    block half at B 256, beside the plain version, SDPA (where it computes
    the same function) and the bound. Launches here are checks, not counted."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    before, before_block = _counts(), fused_block_attention.launches
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {"max_abs": {"fwd": 0.0, "bwd": 0.0, "dv": 0.0, "dqdk": 0.0, "block": 0.0}}
    for dh in HEAD_DIMS:
        kh, kb = HEAD_KH[dh], BLOCK_KH[dh]
        C = kh * dh
        worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
        n_cases = 0
        for dtype in (torch.bfloat16, torch.float32):
            for B in (1, 7, 64):
                x = torch.randn((B, N, 3 * C), generator=gen, device="cuda").to(dtype)
                g = torch.randn((B, N, C), generator=gen, device="cuda").to(dtype)
                fwd, fwd2 = fused_attention(x, num_heads=kh), fused_attention(x, num_heads=kh)
                mono, mono2 = attention_bwd(x, g, kh), attention_bwd(x, g, kh)
                dqdk, dv = attention_bwd_dqdk(x, g, kh), attention_bwd_dv(x, g, kh)
                split = attention_bwd_split(x, g, kh)
                # f32 at dh 128 holds the block's head in shared memory to N 108
                nb = 98 if dtype == torch.float32 and dh == 128 else N
                t = torch.randn((B, nb, 384), generator=gen, device="cuda").to(dtype)
                w = _block_weights(gen, 384, kb * dh, dtype)
                blk = fused_block_attention(t, **w, num_heads=kb)
                blk2 = fused_block_attention(t, **w, num_heads=kb)
                torch.cuda.synchronize()
                want_f = reference_attention(x, num_heads=kh)
                want_b = reference_attention_bwd(x, g, kh)
                want_qk = reference_attention_bwd_dqdk(x, g, kh)
                want_v = reference_attention_bwd_dv(x, g, kh)
                want_blk = reference_block_attention(t, **w, num_heads=kb)
                errs = {"fwd": [_rel(fwd, want_f)], "bwd": _bwd_errs(mono, want_b, C),
                        "dqdk": [_rel(dqdk[..., :C], want_qk[..., :C]),
                                 _rel(dqdk[..., C:], want_qk[..., C:])],
                        "dv": [_rel(dv, want_v)], "block": [_rel(blk, want_blk)]}
                bad = {k: v for k, v in errs.items() if max(v) > TOL[dtype]}
                if bad:
                    raise AssertionError(f"[heads] dh {dh} {dtype} B {B}: rel err {bad} > "
                                         f"{TOL[dtype]:.0e}")
                same = (torch.equal(fwd, fwd2) and torch.equal(mono, mono2)
                        and torch.equal(blk, blk2) and torch.equal(split, mono)
                        and torch.equal(split[..., :2 * C], dqdk)
                        and torch.equal(split[..., 2 * C:], dv))
                if not same:
                    raise AssertionError(f"[heads] dh {dh} {dtype} B {B}: a repeat launch, or "
                                         "the split pair against the monolithic kernel, "
                                         "differs in its bits")
                if dtype == torch.bfloat16:
                    for k, got, want in (("fwd", fwd, want_f), ("bwd", mono, want_b),
                                         ("dqdk", dqdk, want_qk), ("dv", dv, want_v),
                                         ("block", blk, want_blk)):
                        res["max_abs"][k] = max(res["max_abs"][k], float(
                            (got.float() - want.float()).abs().max()))
                worst[dtype] = max(worst[dtype], max(max(v) for v in errs.values()))
                n_cases += 1
        # times (bf16): the forward and the block half at B 256, the backwards at B 64
        x = torch.randn((256, N, 3 * C), generator=gen, device="cuda").bfloat16()
        q, k, v = _sdpa_qkv(x, kh)
        fwd_t = dict(ms=_time_ms(lambda: fused_attention(x, num_heads=kh)),
                     plain_ms=_time_ms(lambda: reference_attention(x, num_heads=kh)),
                     library_ms=_time_ms(lambda: sdpa(q, k, v)))
        fb, by = _bound(256, C // DH, 2, BF16_FLOPS)
        fwd_t.update(bound_ms=fb, bound_by="bytes" if by else "operations")
        x = torch.randn((64, N, 3 * C), generator=gen, device="cuda").bfloat16()
        g = torch.randn((64, N, C), generator=gen, device="cuda").bfloat16()
        q, k, v = (t.requires_grad_() for t in _sdpa_qkv(x, kh))
        out = sdpa(q, k, v)
        gh = g.view(64, N, kh, dh).transpose(1, 2)
        bb, by = _bwd_bound(64, C // DH, 2, BF16_FLOPS)
        sb = _split_bounds(64, C // DH, 2)
        bwd_t = dict(ms=_time_ms(lambda: attention_bwd(x, g, kh)),
                     plain_ms=_time_ms(lambda: reference_attention_bwd(x, g, kh)),
                     library_ms=_time_ms(lambda: torch.autograd.grad(out, (q, k, v), gh,
                                                                     retain_graph=True)),
                     bound_ms=bb, bound_by="bytes" if by else "operations",
                     dv_ms=_time_ms(lambda: attention_bwd_dv(x, g, kh)),
                     dqdk_ms=_time_ms(lambda: attention_bwd_dqdk(x, g, kh)),
                     dv_plain_ms=_time_ms(lambda: reference_attention_bwd_dv(x, g, kh)),
                     dqdk_plain_ms=_time_ms(lambda: reference_attention_bwd_dqdk(x, g, kh)),
                     dv_bound_ms=sb["dv"][0], dqdk_bound_ms=sb["dqdk"][0])
        t = torch.randn((256, N, 384), generator=gen, device="cuda").bfloat16()
        w = _block_weights(gen, 384, kb * dh, torch.bfloat16)
        blb, blb_bytes = _block_bound(256, 384, kb * dh)
        blk_t = dict(ms=_time_ms(lambda: fused_block_attention(t, **w, num_heads=kb)),
                     plain_ms=_time_ms(lambda: reference_block_attention(t, **w, num_heads=kb)),
                     library_ms=None, bound_ms=blb,
                     bound_by="bytes" if blb_bytes >= blb else "operations")
        res[dh] = dict(kh=kh, block_kh=kb, cases=n_cases, fwd=fwd_t, bwd=bwd_t, block=blk_t,
                       worst_rel={"bf16": worst[torch.bfloat16], "f32": worst[torch.float32]})
        print(f"[heads] dh {dh}: {n_cases} cases (B 1/7/64, bf16 and f32) of the forward, the "
              f"monolithic backward, the split pair and the block half vs their plain versions "
              f"pass; worst rel err bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 "
              f"{worst[torch.float32]:.3e} (tol 1e-4); repeats bit for bit; split == "
              f"monolithic bit for bit")
        print(f"[heads] dh {dh} times (bf16): forward B256 kh{kh} {fwd_t['ms']:.4f} ms (plain "
              f"{fwd_t['plain_ms']:.4f}, SDPA {fwd_t['library_ms']:.4f}, bound "
              f"{fwd_t['bound_ms']:.4f} {fwd_t['bound_by']}); backward B64 kh{kh} "
              f"{bwd_t['ms']:.4f} ms (plain {bwd_t['plain_ms']:.4f}, SDPA backward "
              f"{bwd_t['library_ms']:.4f}, bound {bwd_t['bound_ms']:.4f} {bwd_t['bound_by']}); "
              f"split dv {bwd_t['dv_ms']:.4f} + dq/dk {bwd_t['dqdk_ms']:.4f} ms (plain "
              f"{bwd_t['dv_plain_ms']:.4f}, {bwd_t['dqdk_plain_ms']:.4f}; bounds "
              f"{bwd_t['dv_bound_ms']:.4f}, {bwd_t['dqdk_bound_ms']:.4f}); block B256 kh{kb} "
              f"{blk_t['ms']:.4f} ms (plain {blk_t['plain_ms']:.4f}, bound "
              f"{blk_t['bound_ms']:.4f} {blk_t['bound_by']}) [{card}]")
    _set_counts(before)
    fused_block_attention.launches = before_block
    return res


def _block_weights(gen, C: int, K: int, dtype) -> dict:
    r = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    return dict(norm_scale=1 + 0.1 * r(C), norm_bias=0.1 * r(C),
                qkv_kernel=(0.05 * r(C, 3 * K)).to(dtype), qkv_bias=0.1 * r(3 * K),
                proj_kernel=(0.05 * r(K, C)).to(dtype), proj_bias=0.1 * r(C))


# ---- stage 2 from a dataset on disk: loaders, device transforms, checkpoints

DATA_B, DATA_EVAL_B, DATA_N, DATA_TEST_N, DATA_EPOCHS = 64, 512, 5000, 1000, 2
DATA_AUG = AugmentConfig(img_size=224)  # the CLI's defaults: RRC bicubic, hflip,
# rand-m9-mstd0.5-inc1, reprob 0.25 pixel


def _write_cifar100(root: Path) -> None:
    """A CIFAR-100 pickle tree (cifar-100-python/{train,test}) made from a
    seed: the class-patterned images of synthetic_dataset, 100 classes."""
    d = root / "cifar-100-python"
    d.mkdir(parents=True)
    for name, n, seed in (("train", DATA_N, 0), ("test", DATA_TEST_N, 1)):
        ds = synthetic_dataset(100, n, img_size=32, seed=seed)
        rows = ds.images.transpose(0, 3, 1, 2).reshape(n, 3 * 32 * 32)
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rows, b"fine_labels": ds.labels.tolist()}, f)


def _data_setup(root: Path) -> dict:
    _write_cifar100(root)
    manifest = DivisionManifest.create(100, 4, seed=42)
    train = build_dataset("cifar100", str(root), True).division_view(manifest, 0)
    val = build_dataset("cifar100", str(root), False).division_view(manifest, 0)
    return dict(train=train, val=val, classes=train.num_classes)


def _data_run(data: dict, host_tf=None):
    """One stage-2 run as train_sub composes it: a fresh seed-0 dedeit with
    the kernels, AdamW (lr 5e-4 scaled by batch / 512, 5 warm-up epochs,
    cosine), EMA, mixup/cutmix, smoothing 0.1, repeated augmentation 3; the
    train transform on the card, or with host_tf the host augment in the
    prefetch thread and finish_transform on the card. Returns (state,
    step_fn, train_batches_fn, eval_fn, trace)."""
    classes = data["classes"]
    model = create_vit("dedeit", num_classes=classes, drop_path_rate=0.1, dtype=torch.bfloat16,
                       use_kernel=True, device="cuda", generator=torch.Generator().manual_seed(0))

    def batches(epoch):
        it = BatchIterator(data["train"], DATA_B, shuffle=True, seed=0, repeated_aug=3,
                           host_transform=host_tf)
        it.set_epoch(epoch)
        return it

    cfg = OptimConfig(lr=5e-4 * DATA_B / 512, warmup_lr=1e-6, min_lr=1e-5, warmup_epochs=5,
                      cooldown_epochs=10, epochs=DATA_EPOCHS, weight_decay=0.0)
    state = TrainState.create(model, make_optimizer(cfg, len(batches(0))), use_ema=True,
                              ema_decay=0.99996)
    step = make_stage2_step(model, None, mixup=_mixup(classes), smoothing=0.1,
                            distillation_type="none")
    trace = {"losses": [], "epoch_start": {}, "epoch_end": {}, "steps": {}}

    def step_fn(state, images, labels, generator):
        x = torch.from_numpy(images).cuda()
        x = (train_transform(generator, x, DATA_AUG) if host_tf is None
             else finish_transform(generator, x, DATA_AUG))
        state, metrics = step(state, None, x, torch.from_numpy(labels).cuda(), generator)
        trace["losses"].append(metrics["loss"])
        return state, metrics

    def train_batches(epoch):
        trace["epoch_start"][epoch] = time.perf_counter()
        trace["steps"][epoch] = len(batches(epoch))
        return batches(epoch)

    eval_step = make_eval_step(model)

    def eval_fn(state):
        it = BatchIterator(data["val"], DATA_EVAL_B, shuffle=False, drop_last=False)
        return run_eval(eval_step, None, None, it,
                        prepare=lambda im: eval_transform(torch.from_numpy(im).cuda(),
                                                         DATA_AUG.img_size))

    return state, step_fn, train_batches, eval_fn, trace


def _fit(data: dict, out_dir: Path, epochs: int, *, resume: Optional[Path] = None,
         start_epoch: int = 0):
    state, step_fn, train_batches, eval_fn, trace = _data_run(data)
    if resume is not None:
        state, start = restore_stage2_tree(state, restore_pytree(str(resume)))
        assert start == start_epoch, (start, start_epoch)
    saved = {}

    def save(path, state, epoch):
        torch.cuda.synchronize()
        trace["epoch_end"].setdefault(epoch, time.perf_counter())
        tree = stage2_tree(state, epoch)
        save_pytree(path, tree)
        saved[Path(path).name] = (epoch, tree)

    evals = []
    state, best = fit(carry=state, step_fn=step_fn, train_batches_fn=train_batches,
                      eval_fn=lambda s: evals.append(eval_fn(s)) or evals[-1], epochs=epochs,
                      generator=torch.Generator().manual_seed(1), output_dir=str(out_dir),
                      log_fn=lambda m: print(f"[data-train]   {m}"), save_state_fn=save,
                      start_epoch=start_epoch)
    return dict(state=state, best=best, evals=evals, saved=saved, trace=trace,
                step_fn=step_fn, train_batches=train_batches)


def _tree_diff(a, b, prefix="") -> dict:
    """{leaf path: max |a - b|} over two nested trees of arrays (and ints)."""
    if isinstance(a, dict):
        out = {}
        for k in a:
            out.update(_tree_diff(a[k], b[k], f"{prefix}{k}/"))
        return out
    if a is None:
        return {prefix: 0.0 if b is None else float("inf")}
    x = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float64)
    y = np.asarray(b.float() if isinstance(b, torch.Tensor) else b, np.float64)
    return {prefix: float(np.abs(x - y).max()) if x.size else 0.0}


def _near_step(x: torch.Tensor) -> torch.Tensor:
    """Pixels with a channel within 1e-3 of a step of the stepped RandAugment
    ops (an integer or a half)."""
    d = (x * 2 - torch.round(x * 2)).abs() / 2
    return (d < 1e-3).any(dim=-1)


def _transform_excuse(images: torch.Tensor, draws) -> torch.Tensor:
    """The (B, H, W) pixels a stepped RandAugment op may flip between two
    devices: its input (here on the CPU) within 1e-3 of a step; for the ops
    on whole-image statistics (contrast, equalize, autocontrast) the whole
    image once any pixel is."""
    x = random_resized_crop(images, draws.crop, draws.cubic, DATA_AUG.img_size)
    x = torch.where(draws.flip[:, None, None, None], x.flip(2), x)
    ra = draws.ra
    near = torch.zeros(x.shape[:3], dtype=torch.bool)
    for s in range(ra.op.shape[1]):
        for b in range(x.shape[0]):
            name = RA_OP_NAMES[int(ra.op[b, s])]
            if bool(ra.apply[b, s]) and name in RA_STEPPED:
                m = _near_step(x[b])
                near[b] |= m.any() if name in ("contrast", "equalize", "autocontrast") else m
        one = RandAugmentDraws(ra.op[:, s:s + 1], ra.apply[:, s:s + 1], ra.mag[:, s:s + 1],
                               ra.inc)
        x = apply_rand_augment(x, one)
    return near


def phase_data_train(card: str) -> dict:
    """Stage 2 from a CIFAR-100 pickle tree on disk: the transform on the
    card against the CPU on the same host draws; the gather, transform and
    step times; `fit` for 2 epochs (checkpoint_temp every epoch,
    checkpoint at a new best, eval through eval_transform and the kernel);
    its img/s and, over one more epoch under the profiler, the device's
    idle share. Returns the measurements and the run ([ckpt] resumes it)."""
    root = Path(tempfile.mkdtemp(prefix="devit_data_"))
    t0 = time.perf_counter()
    data = _data_setup(root)
    print(f"[data-train] CIFAR-100 pickles ({DATA_N} train, {DATA_TEST_N} test, 32x32, seed 0/1) "
          f"written and loaded by build_dataset in {time.perf_counter() - t0:.2f} s; division 0 "
          f"of the 4-way seed-42 split: {len(data['train'])} train, {len(data['val'])} val, "
          f"{data['classes']} classes")

    # the gather: the C++ gather, counted
    idx = np.random.default_rng(0).permutation(len(data["train"]))[:DATA_B]
    rows = data["train"].rows(idx)
    g0 = gather_rows.launches
    t0 = time.perf_counter()
    for _ in range(50):
        gather_rows(data["train"].images, rows)
    gather_ms = (time.perf_counter() - t0) * 1e3 / 50
    if gather_rows.launches != g0 + 50:
        raise AssertionError("the native gather did not run")

    # the transform on the card vs the CPU, on the same host draws
    images = torch.from_numpy(gather_rows(data["train"].images, rows))
    draws = draw_train(torch.Generator().manual_seed(3), tuple(images.shape), DATA_AUG)
    on_card = apply_train(images.cuda(), draws, DATA_AUG, torch.float32).cpu()
    on_cpu = apply_train(images, draws, DATA_AUG, torch.float32)
    std = torch.tensor((0.229, 0.224, 0.225)) * 255
    diff = ((on_card - on_cpu).abs() * std).amax(dim=-1)  # pixel units
    near = _transform_excuse(images.float(), draws)
    tol = 1e-3 * 255
    bad = (diff > tol) & ~near
    excused = int(((diff > tol) & near).sum())
    if bool(bad.any()) or not bool(torch.isfinite(on_card).all()):
        raise AssertionError(f"[data-train] train_transform card vs CPU: {int(bad.sum())} pixels "
                             f"off by more than {tol:.3f} (max {float(diff[bad].max()):.4f}) "
                             f"outside the excused steps")
    erased = {bx.b for bx in draws.erase}
    print(f"[data-train] train_transform (RRC 32->224 bicubic, hflip, RandAugment m9/0.5/inc, "
          f"random erasing {len(erased)} of {DATA_B}) on the card vs the CPU on the same host "
          f"draws: max diff {float(diff[~near].max()):.3e} of 255 outside the steps (tol "
          f"{tol:.3f}); {excused} of {diff.numel()} pixels excused (a stepped op's input "
          f"within 1e-3 of a step), {int(near.sum())} near a step in all")

    # transform and step times on a fixed batch (draws on the host included)
    xg = images.cuda()
    t0 = time.perf_counter()
    for _ in range(20):
        draw_train(torch.Generator().manual_seed(4), tuple(images.shape), DATA_AUG)
    draw_ms = (time.perf_counter() - t0) * 1e3 / 20
    apply_ms = _time_ms(lambda: apply_train(xg, draws, DATA_AUG))
    transform_ms = _time_ms(lambda: train_transform(torch.Generator().manual_seed(4), xg,
                                                    DATA_AUG))

    # the main path: fit for 2 epochs from the files, counts at 0
    before = _counts()
    _set_counts((0, 0, 0, 0))
    run_a = _fit(data, root / "run_a", DATA_EPOCHS)
    launches = {"fused_attention": fused_attention.launches,
                "attention_bwd": attention_bwd.launches}
    _set_counts(before)
    trace = run_a["trace"]
    losses = [float(l) for l in trace["losses"]]
    n_steps = sum(trace["steps"].values())
    if not (all(np.isfinite(losses)) and len(losses) == n_steps):
        raise AssertionError(f"[data-train] losses {losses} ({n_steps} steps)")
    if launches["fused_attention"] == 0 or launches["attention_bwd"] == 0:
        raise AssertionError(f"[data-train] the kernels did not run: {launches}")
    epoch_img_s = [trace["steps"][e] * DATA_B / (trace["epoch_end"][e] - trace["epoch_start"][e])
                   for e in range(DATA_EPOCHS)]
    files = sorted(run_a["saved"])
    if "checkpoint_temp.msgpack" not in files or not (root / "run_a" / files[0]).exists():
        raise AssertionError(f"[data-train] checkpoints written: {files}")
    print(f"[data-train] fit {DATA_EPOCHS} epochs (bs{DATA_B}, {n_steps} steps, the C++ gather in "
          f"BatchIterator's prefetch thread, the transform on the card, mixup/cutmix, AdamW + "
          f"EMA, the kernels): losses all finite (first {losses[0]:.4f}, last {losses[-1]:.4f}); "
          f"eval through eval_transform (Resize 256 + CenterCrop 224) and the kernel: acc1 "
          f"{[round(e['acc1'], 2) for e in run_a['evals']]}; files {files}; launches "
          f"{launches}")
    print(f"[data-train] times: gather {gather_ms:.4f} ms/batch (host); transform "
          f"{transform_ms:.3f} ms/batch ({draw_ms:.3f} ms of host draws, {apply_ms:.3f} ms on "
          f"the card alone); epoch img/s {[round(v, 1) for v in epoch_img_s]} (epoch 0 holds "
          f"the first calls' warm-up) [{card}]")
    return dict(data=data, root=root, run_a=run_a, launches=launches, gather_ms=gather_ms,
                transform_ms=transform_ms, draw_ms=draw_ms, apply_ms=apply_ms,
                epoch_img_s=epoch_img_s, excused=excused, losses=losses,
                acc1=[e["acc1"] for e in run_a["evals"]], images=images)


def phase_ckpt(dt: dict, card: str) -> dict:
    """Run B: fit for 1 epoch, then a fresh state restored from its
    checkpoint_temp.msgpack fits epoch 1 (start_epoch 1). After epoch 1 its
    params, EMA and optimizer state must equal run A's (2 uninterrupted
    epochs) bit for bit; the file read back equals the state leaf for leaf."""
    data, root, run_a = dt["data"], dt["root"], dt["run_a"]
    before = _counts()
    run_b = _fit(data, root / "run_b", 1)
    path = root / "run_b" / "checkpoint_temp.msgpack"
    back = restore_pytree(str(path))
    readback = _tree_diff(back, run_b["saved"]["checkpoint_temp.msgpack"][1])
    if max(readback.values()) != 0.0:
        raise AssertionError(f"[ckpt] the file read back differs from the state: "
                             f"{max(readback, key=readback.get)}")
    run_c = _fit(data, root / "run_c", DATA_EPOCHS, resume=path, start_epoch=1)
    _set_counts(before)
    diff = _tree_diff(stage2_tree(run_c["state"], 1), stage2_tree(run_a["state"], 1))
    worst = max(diff, key=diff.get)
    print(f"[ckpt] resume: run A (2 epochs) vs run B (1 epoch, checkpoint_temp.msgpack restored "
          f"into a fresh state, epoch 1): {len(diff)} leaves (params, EMA, Adam moments, "
          f"counts), largest difference {diff[worst]:.3e} ({worst}); the file read back equals "
          f"the state leaf for leaf ({len(readback)} leaves) [{card}]")
    if diff[worst] != 0.0:
        raise AssertionError(f"[ckpt] the resumed run is not bit for bit the uninterrupted one: "
                             f"{sum(v > 0 for v in diff.values())} leaves differ, largest "
                             f"{diff[worst]:.3e} at {worst}")
    # the step's time on a fixed batch (transform included), from run C's state
    st, step_fn = run_c["state"], run_c["step_fn"]
    images, labels = dt["images"].numpy(), np.zeros(DATA_B, np.int64)
    step_ms = _time_ms(lambda: step_fn(st, images, labels, torch.Generator().manual_seed(5)),
                       iters=10)
    _set_counts(before)
    print(f"[ckpt] stage-2 step bs{DATA_B} with the transform on the card: {step_ms:.3f} ms "
          f"(the transform alone {dt['transform_ms']:.3f} ms) [{card}]")
    return dict(leaves=len(diff), max_diff=diff[worst], readback_leaves=len(readback),
                step_ms=step_ms, state=st, step_fn=step_fn,
                train_batches=run_c["train_batches"])


def phase_data_profile(ck: dict, card: str) -> dict:
    """One more epoch of the resumed run under torch.profiler (after a warm
    one): the device's busy and idle share of the epoch's wall time."""
    before = _counts()
    out = _profile(lambda: train_epoch(ck["step_fn"], ck["state"], ck["train_batches"](2),
                                       torch.Generator().manual_seed(9), epoch=2,
                                       log_fn=lambda *_: None),
                   "[data-profile]", f"one bs{DATA_B} real-data epoch", card, kind=_step_kind)
    _set_counts(before)
    return out


def phase_pil(dt: dict, card: str) -> dict:
    """Where PIL imports: an epoch with the host backend (host_augment in
    BatchIterator's prefetch thread, then finish_transform on the card),
    the JAX CLI's `auto` choice for this configuration."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        print("[pil] PIL does not import here: the host-augment backend is not run "
              "(the device transform above is the path)")
        return {"pil": False}
    from devit_tpu_torch.data.host_augment import make_host_train_augment

    data = dt["data"]
    state, step_fn, train_batches, _, trace = _data_run(
        data, host_tf=make_host_train_augment(DATA_AUG, seed=0))
    it = train_batches(0)
    before = _counts()
    t0 = time.perf_counter()
    train_epoch(step_fn, state, it, torch.Generator().manual_seed(1), epoch=0,
                log_fn=lambda *_: None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    _set_counts(before)
    losses = [float(l) for l in trace["losses"]]
    if not (losses and all(np.isfinite(losses))):
        raise AssertionError(f"[pil] losses {losses}")
    img_s = len(it) * DATA_B / secs
    print(f"[pil] PIL {PIL.__version__} imports: one epoch with the host backend (PIL RRC + "
          f"hflip + RandAugment in the prefetch thread, finish_transform on the card): "
          f"{len(it)} steps, {img_s:.1f} img/s, losses finite [{card}]")
    return {"pil": True, "img_s": img_s}


# ---- head widths between the instantiations (zero-padded heads)

PAD_DH_KH = {8: 6, 16: 6, 48: 4, 80: 3, 96: 4}  # head width -> heads


def phase_heads_pad(card: str) -> dict:
    """Each attention kernel at head widths 8, 16, 48, 80 and 96, which the
    wrappers zero-pad to the 32-, 64- or 128-wide instantiation and launch
    with the true width's scale: bf16 and f32, B 1/7/64, against its plain
    version at the true width (2e-2 bf16, 1e-4 f32; dq, dk and dv each),
    repeats and the split pair against the monolithic kernel bit for bit.
    Launches here are checks, not counted. Returns the bf16 max-abs errors."""
    from devit_tpu_torch.kernels.attention import kernel_head_dim

    gen = torch.Generator(device="cuda").manual_seed(41)
    before, before_block = _counts(), fused_block_attention.launches
    max_abs = {"fwd": 0.0, "bwd": 0.0, "dv": 0.0, "dqdk": 0.0, "block": 0.0}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    n_cases = 0
    for dh, kh in PAD_DH_KH.items():
        C = kh * dh
        for dtype in (torch.bfloat16, torch.float32):
            for B in (1, 7, 64):
                x = torch.randn((B, N, 3 * C), generator=gen, device="cuda").to(dtype)
                g = torch.randn((B, N, C), generator=gen, device="cuda").to(dtype)
                fwd, fwd2 = fused_attention(x, num_heads=kh), fused_attention(x, num_heads=kh)
                mono, mono2 = attention_bwd(x, g, kh), attention_bwd(x, g, kh)
                dqdk, dv = attention_bwd_dqdk(x, g, kh), attention_bwd_dv(x, g, kh)
                split = attention_bwd_split(x, g, kh)
                # f32 holds the block's head in shared memory to N 108 at width 128
                nb = 98 if dtype == torch.float32 and kernel_head_dim(dh) == 128 else N
                t = torch.randn((B, nb, 384), generator=gen, device="cuda").to(dtype)
                w = _block_weights(gen, 384, kh * dh, dtype)
                blk = fused_block_attention(t, **w, num_heads=kh)
                blk2 = fused_block_attention(t, **w, num_heads=kh)
                torch.cuda.synchronize()
                want = dict(fwd=reference_attention(x, num_heads=kh),
                            bwd=reference_attention_bwd(x, g, kh),
                            dqdk=reference_attention_bwd_dqdk(x, g, kh),
                            dv=reference_attention_bwd_dv(x, g, kh),
                            block=reference_block_attention(t, **w, num_heads=kh))
                errs = {"fwd": [_rel(fwd, want["fwd"])], "bwd": _bwd_errs(mono, want["bwd"], C),
                        "dqdk": [_rel(dqdk[..., :C], want["dqdk"][..., :C]),
                                 _rel(dqdk[..., C:], want["dqdk"][..., C:])],
                        "dv": [_rel(dv, want["dv"])], "block": [_rel(blk, want["block"])]}
                bad = {k: v for k, v in errs.items() if max(v) > TOL[dtype]}
                if bad:
                    raise AssertionError(f"[heads-pad] dh {dh} {dtype} B {B}: rel err {bad} > "
                                         f"{TOL[dtype]:.0e}")
                same = (torch.equal(fwd, fwd2) and torch.equal(mono, mono2)
                        and torch.equal(blk, blk2) and torch.equal(split, mono)
                        and torch.equal(split[..., :2 * C], dqdk)
                        and torch.equal(split[..., 2 * C:], dv))
                if not same:
                    raise AssertionError(f"[heads-pad] dh {dh} {dtype} B {B}: a repeat launch, "
                                         "or the split pair against the monolithic kernel, "
                                         "differs in its bits")
                if dtype == torch.bfloat16:
                    for k, got in (("fwd", fwd), ("bwd", mono), ("dqdk", dqdk), ("dv", dv),
                                   ("block", blk)):
                        max_abs[k] = max(max_abs[k], float(
                            (got.float() - want[k].float()).abs().max()))
                worst[dtype] = max(worst[dtype], max(max(v) for v in errs.values()))
                n_cases += 1
    try:
        fused_attention(torch.zeros((1, N, 3 * 256), device="cuda"), num_heads=1)
        raise AssertionError("[heads-pad] head_dim 256 did not raise")
    except ValueError:
        pass
    _set_counts(before)
    fused_block_attention.launches = before_block
    print(f"[heads-pad] head widths {list(PAD_DH_KH)} (zero-padded to 32/64/128, the true "
          f"width's scale): {n_cases} cases (B 1/7/64, bf16 and f32) of the forward, the "
          f"monolithic backward, the split pair and the block half vs their plain versions "
          f"pass; worst rel err bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 "
          f"{worst[torch.float32]:.3e} (tol 1e-4); repeats bit for bit; split == monolithic "
          f"bit for bit; head_dim 256 raises ValueError [{card}]")
    return dict(cases=n_cases, max_abs=max_abs,
                worst_rel={"bf16": worst[torch.bfloat16], "f32": worst[torch.float32]})


# ---- the devit-torch CLI: the pipeline, inspect, serve and the compact eval

# the pipeline at full width: dedeit (384 wide, 12 layers, 6 heads, dh 64,
# 224 px, N 198), 4 divisions of 25 classes, bs64, the CLI's defaults
# otherwise (bf16, RandAugment on the host, mixup/cutmix, EMA, repeated
# augmentation, the self-distill teacher). Cuts: 1 epoch (default 5), 2048
# synthetic images a split in place of CIFAR-100's 50,000
CLI_MODEL = ["--model", "dedeit", "--dataset", "synthetic:100:2048:224", "--num_division", "4",
             "--batch-size", "64", "--epochs", "1", "--device", "cuda"]
CLI_ARGS = CLI_MODEL + ["--deploy-num-classes", "25"]
CLI_STAGES = ("split", "train_sub", "shrink", "distill", "ensemble", "deploy")
CLI_FORWARD = ("train_sub", "shrink", "distill", "ensemble")  # stages that run a model
CLI_BACKWARD = ("train_sub", "distill", "ensemble")
KERNEL_NAMES = ("fused_attention", "attention_bwd", "attention_bwd_dv", "attention_bwd_dqdk")


def _cli_instrument(record: dict):
    """Wrap each stage main of cli/stages.py (pipeline_main looks them up at
    call time) and fit's train_epoch: per stage, the wall seconds of its
    calls ending in synchronize, the kernels' launches and the train steps.
    Returns the function that undoes it."""
    from devit_tpu_torch.cli import stages as St
    from devit_tpu_torch.train import loop as TL

    steps = [0]
    originals = {name: getattr(St, f"{name}_main") for name in CLI_STAGES}
    train_epoch = TL.train_epoch

    def wrap(name, fn):
        def run(args):
            before, steps0 = _counts(), steps[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(args)
            torch.cuda.synchronize()
            rec = record.setdefault(name, dict(seconds=0.0, calls=0, steps=0, dirs=[],
                                               launches=[0, 0, 0, 0]))
            rec["seconds"] += time.perf_counter() - t0
            rec["calls"] += 1
            rec["steps"] += steps[0] - steps0
            rec["dirs"].append(args.output_dir)
            rec["launches"] = [a + b for a, b in zip(rec["launches"], _delta(before))]
            return out
        return run

    def counted(step_fn, carry, batches, generator, **kw):
        def each():
            for batch in batches:
                steps[0] += 1
                yield batch
        return train_epoch(step_fn, carry, each(), generator, **kw)

    for name, fn in originals.items():
        setattr(St, f"{name}_main", wrap(name, fn))
    TL.train_epoch = counted

    def undo():
        for name, fn in originals.items():
            setattr(St, f"{name}_main", fn)
        TL.train_epoch = train_epoch
    return undo


def _cli(argv):
    """One devit-torch command in this process, through its parser; returns
    what the subcommand returns (main() returns 0)."""
    from devit_tpu_torch.cli.__main__ import build_parser

    args = build_parser().parse_args(argv)
    return args.fn(args)


def _serve_thread(argv):
    """`serve` (serve_main) in a thread; returns (url, stop)."""
    from devit_tpu_torch.cli.__main__ import build_parser
    from devit_tpu_torch.serving.daemon import serve_main

    ready, box = threading.Event(), {}
    thread = threading.Thread(target=serve_main, args=(build_parser().parse_args(argv),),
                              kwargs=dict(ready=lambda h: (box.update(httpd=h), ready.set())),
                              daemon=True)
    thread.start()
    if not ready.wait(600):
        raise AssertionError("[cli] serve did not come up")

    def stop():
        box["httpd"].shutdown()
        thread.join(timeout=60)
    return "http://%s:%d" % box["httpd"].server_address[:2], stop


def phase_cli(card: str) -> dict:
    """The main path through the CLI: `pipeline` at full width (split, then
    per division train_sub, shrink and self-distill, then the stage-5
    ensemble and deploy), timed per stage with its steps and the kernels'
    launches; a second `pipeline` that skips every stage; `inspect --json`
    on the artifacts; `serve` on deploy/ with six concurrent /predict
    requests held to engine.predict and the val set's correct count held to
    `ensemble --compact-path`'s."""
    import contextlib
    import io

    from devit_tpu_torch.cli import common as CC
    from devit_tpu_torch.cli.__main__ import build_parser
    from devit_tpu_torch.core.metrics import DEDEIT_FULL_GMACS

    a = build_parser().parse_args(["pipeline", *CLI_ARGS])
    root = Path(tempfile.mkdtemp(prefix="devit_cli_"))
    out = str(root / "pipeline")
    record = {}
    undo = _cli_instrument(record)
    before = _counts()
    try:
        _set_counts((0, 0, 0, 0))  # the main path
        t0 = time.perf_counter()
        results = _cli(["pipeline", *CLI_ARGS, "--output_dir", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(zip(KERNEL_NAMES, _counts()))
        calls = {k: v["calls"] for k, v in record.items()}
        again = _cli(["pipeline", *CLI_ARGS, "--output_dir", out])
        if again != {} or {k: v["calls"] for k, v in record.items()} != calls:
            raise AssertionError(f"[cli] the second pipeline ran stages: {again}")
    finally:
        undo()
    print(f"[cli] devit-torch pipeline {' '.join(CLI_ARGS)} (the CLI's defaults otherwise; "
          f"cuts: 1 epoch, synthetic images in place of CIFAR-100): {wall:.1f} s, results "
          f"{ {k: round(v, 2) for k, v in results.items()} } [{card}]")
    for name in CLI_STAGES:
        rec = record[name]
        counts = dict(zip(KERNEL_NAMES, rec["launches"]))
        img_s = rec["steps"] * a.batch_size / rec["seconds"] if rec["steps"] else 0.0
        print(f"[cli]   {name}: {rec['calls']} call(s), {rec['seconds']:.2f} s, {rec['steps']} "
              f"train steps ({img_s:.1f} img/s over the stage's wall time), launches {counts}")
        if name in CLI_FORWARD and counts["fused_attention"] == 0:
            raise AssertionError(f"[cli] {name} launched no fused_attention")
        if name in CLI_BACKWARD and counts["attention_bwd"] + counts["attention_bwd_dv"] == 0:
            raise AssertionError(f"[cli] {name} launched no backward kernel")
        for d in rec["dirs"] if name in CLI_BACKWARD else ():
            with open(os.path.join(d, "log_stats.txt")) as f:
                logged = [json.loads(line) for line in f]
            if not logged or not all(np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"])
                                     for r in logged):
                raise AssertionError(f"[cli] {name} logged a non-finite loss in {d}: {logged}")
    print("[cli] a second pipeline on the same root skipped every stage (no stage main "
          "called)")
    # stage 3: each division's chosen policy within 2% of the MACs budget
    # (shrink_main's: the reference's 9.19 anchor at seq 197 for dedeit)
    cfg = CC.model_config(a.model, 0, a)
    canonical = (cfg.depth, cfg.embed_dim, cfg.num_heads) == (12, 384, 6)
    geo = dict(emb=cfg.embed_dim, mlp_ratio=cfg.mlp_ratio, head=cfg.num_heads, layer=cfg.depth,
               seq_length=197 if canonical else cfg.seq_len)
    zeros = [0.0] * cfg.depth
    full = DEDEIT_FULL_GMACS if canonical else 2 * cal_shrink_macs(zeros, zeros, **geo)
    target = a.shrink_ratio * full
    for d in range(a.num_division):
        pol = np.load(os.path.join(out, f"shrink{d}", "shrinked_policy.npy"))
        acc = np.load(os.path.join(out, f"shrink{d}", "shrinked_accuracy.npy"))
        best = pol[int(np.argmax(acc))]
        macs = cal_shrink_macs(list(best[:cfg.depth]), list(best[cfg.depth:]), **geo)
        if abs(macs - target) > 0.02 * target:
            raise AssertionError(f"[cli] division {d}'s policy: {macs:.3f} GMACs, budget "
                                 f"{target:.3f}")
    print(f"[cli] stage 3: every division's chosen policy within 2% of the "
          f"{target:.3f}-GMACs budget (shrink ratio {a.shrink_ratio})")
    paths = [os.path.join(out, p) for p in (
        f"division{a.num_division}/manifest.json", "sub-model0/checkpoint.msgpack",
        "shrink0/shrinked_policy.npy", "sub-dataset0/checkpoint.msgpack",
        "ensemble/checkpoint.msgpack", "deploy/sub-dataset0/compact.msgpack")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _cli(["inspect", "--json", *paths, "--device", a.device])
    inspected = json.loads(buf.getvalue())
    kinds = [i.get("kind") for i in inspected]
    if len(inspected) != len(paths) or not all(kinds):
        raise AssertionError(f"[cli] inspect: {inspected}")
    print(f"[cli] inspect --json: {kinds}")

    # serve on deploy/ with the stage-5 fusion head; the compact eval
    deploy_dir = os.path.join(out, "deploy")
    ens_ckpt = os.path.join(out, "ensemble", "checkpoint.msgpack")
    buckets = "1,8,32,128,256,512"  # 512: the eval's batch, so both run one shape
    val = build_dataset(a.dataset, a.data_path, train=False, img_size=a.input_size)
    _set_counts((0, 0, 0, 0))
    t0 = time.perf_counter()
    url, stop = _serve_thread(["serve", "--compact-path", deploy_dir, "--ens-path", ens_ckpt,
                               "--port", "0", "--buckets", buckets, "--input-size",
                               str(a.input_size), "--patch-size", str(a.patch_size),
                               "--device", a.device])
    up_s = time.perf_counter() - t0
    try:
        sizes = (1, 3, 8, 20, 64, 300)
        rng = np.random.default_rng(3)
        batches = [val.images[rng.integers(0, len(val), n)] for n in sizes]
        with ThreadPoolExecutor(len(sizes)) as pool:
            replies = list(pool.map(lambda b: _post(url, b), batches))
        t1 = time.perf_counter()
        correct = 0
        for i in range(0, len(val), 512):
            top1 = [p["topk"][0] for p in _post(url, val.images[i:i + 512])["predictions"]]
            correct += int((np.asarray(top1) == val.labels[i:i + 512]).sum())
        serve_s = time.perf_counter() - t1
    finally:
        stop()
    serve_launches = fused_attention.launches
    engine = build_engine_from_artifacts(
        deploy_dir, ens_ckpt, cfg=ServeConfig(input_size=a.input_size, patch_size=a.patch_size,
                                              buckets=tuple(int(b) for b in buckets.split(","))),
        device=a.device, log=None)
    worst = 0.0
    for imgs, reply in zip(batches, replies):
        p = torch.softmax(torch.from_numpy(engine.predict(imgs)), dim=-1)
        for i, pred in enumerate(reply["predictions"]):
            top = torch.tensor(pred["topk"])
            err = float((torch.tensor(pred["probs"]) - p[i, top]).abs().max() / p[i].max())
            worst = max(worst, err)
            if err > 2e-2 or p[i, top[0]] < p[i].max() * (1 - 2e-2):
                raise AssertionError(f"[cli] a reply disagrees with engine.predict ({err:.3e})")
    _set_counts((0, 0, 0, 0))
    t1 = time.perf_counter()
    acc1 = _cli(["ensemble", *CLI_MODEL, "--compact-path", deploy_dir, "--ens-path", ens_ckpt,
                 "--output_dir", str(root / "compact_eval")])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    eval_launches = fused_attention.launches
    eval_correct = round(acc1 * len(val) / 100)
    _set_counts(before)
    if eval_correct != correct or serve_launches == 0 or eval_launches == 0:
        raise AssertionError(f"[cli] served correct {correct} vs compact eval {eval_correct}; "
                             f"launches serve {serve_launches}, eval {eval_launches}")
    print(f"[cli] serve on deploy/ (buckets {buckets}): up with warm-up in {up_s:.2f} s; six "
          f"concurrent /predict of {list(sizes)} images match engine.predict (worst rel "
          f"{worst:.3e}, tol 2e-2); the {len(val)} val images in 512-image requests in "
          f"{serve_s:.2f} s ({len(val) / serve_s:.1f} img/s over HTTP), {correct} correct; "
          f"{serve_launches} fused_attention launches [{card}]")
    print(f"[cli] ensemble --compact-path eval: {eval_correct} correct of {len(val)} (acc1 "
          f"{acc1:.2f}), equal to the served count; {eval_s:.2f} s, {eval_launches} "
          f"fused_attention launches [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return dict(seconds=wall, stages={k: {kk: vv for kk, vv in v.items() if kk != "dirs"}
                                      for k, v in record.items()},
                launches=launches, results=results, serve=dict(
                    seconds=serve_s, up_s=up_s, launches=serve_launches, correct=correct,
                    worst_rel=worst),
                compact_eval=dict(seconds=eval_s, launches=eval_launches, correct=eval_correct))


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

    build_s, mma_counts = phase_build()
    max_abs_err = phase_kernel_checks()
    t0 = time.perf_counter()
    _, cms, ens = deploy.build_artifacts(device="cuda")
    print(f"[forward] deployed artifacts built in {time.perf_counter() - t0:.1f} s: kept heads "
          f"per division {[cm.num_heads for cm in cms]}")
    phase_full_width(cms, ens)
    launches = phase_serving(cms, ens)
    times = phase_times(cms, ens, card)
    times["profile"] = phase_profile(cms, ens, card)
    int8_max_abs_err = phase_int8_checks(cms)
    block = phase_block_attention(cms, ens, card)
    art = phase_artifacts(cms, ens, card)
    int8 = phase_int8(art.pop("cms"), ens, card)
    qcms = int8.pop("qcms")
    times["int8"] = phase_int8_times(cms, qcms, ens, card)
    times["int8"]["profile"] = phase_profile(qcms, ens, card, int8=True)
    times.update(block_attention=block, artifacts=art, int8_path=int8)
    del cms, ens, qcms
    torch.cuda.empty_cache()

    bwd_max_abs_err = phase_bwd_checks()
    split_max_abs_err = phase_split_checks()
    times["bwd_long"] = phase_bwd_long(card)
    train = phase_train(card)
    step = train.pop("step")
    train["profile"] = phase_train_profile(step, card)
    train["kernel_times"] = phase_train_kernel_times(card)
    times["train"] = train
    del step

    ens = phase_ens_train(card)
    ens["profile"] = phase_ens_profile(ens, card)
    del ens["setup"], ens["steps"]
    torch.cuda.empty_cache()
    ens["kernel_times"] = phase_ens_kernel_times(card)
    times["ens_train"] = ens
    times["dekd"] = dekd = phase_dekd(card)
    times["stage3"] = stage3 = phase_stage3(card)
    times["heads"] = heads = phase_heads(card)
    dt = phase_data_train(card)
    ck = phase_ckpt(dt, card)
    dt["profile"] = phase_data_profile(ck, card)
    dt["ckpt"] = {k: ck[k] for k in ("leaves", "max_diff", "readback_leaves", "step_ms")}
    dt["pil"] = phase_pil(dt, card)
    times["data_train"] = {k: v for k, v in dt.items()
                           if k not in ("data", "root", "run_a", "images")}
    shutil.rmtree(dt["root"], ignore_errors=True)
    del dt, ck
    times["heads_pad"] = heads_pad = phase_heads_pad(card)
    torch.cuda.empty_cache()
    times["cli"] = cli = phase_cli(card)
    hm = {k: max(v, heads_pad["max_abs"][k]) for k, v in heads["max_abs"].items()}

    fa = times["forward_attention"]
    bw = train["kernel_times"]["bwd_step"]
    es = ens["kernel_times"]["per_step"]
    record = {"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/attention.cu",
        "replaces": "devit_tpu/kernels/attention.py:30",
        # the launches of every main-path run: serving, stage 2, stage 5, DEKD,
        # stage 3 (the policy search's chunks), stage 2 from the files, the CLI
        # pipeline
        "launches": (launches + train["launches"]["fused_attention"]
                     + ens["launches"]["fused_attention"] + dekd["launches"]["fused_attention"]
                     + stage3["launches"] + times["data_train"]["launches"]["fused_attention"]
                     + cli["launches"]["fused_attention"]),
        # every shape checked: [kernel]'s up to B 256, stage 3's B 4096, [heads]
        "max_abs_err": max(max_abs_err, stage3["shrink"]["attention"]["max_abs_err"],
                           hm["fwd"]),
        "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"], "library_ms": fa["library_ms"]}, {
        "name": "attention_bwd", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/attention_bwd.cu",
        "replaces": "devit_tpu/kernels/attention.py:238",
        "launches": (train["launches"]["attention_bwd"] + ens["launches"]["attention_bwd"]
                     + dekd["launches"]["attention_bwd"]
                     + times["data_train"]["launches"]["attention_bwd"]
                     + cli["launches"]["attention_bwd"]),
        "max_abs_err": max(bwd_max_abs_err, hm["bwd"]),
        "ms": bw["ms"], "plain_ms": bw["plain_ms"], "bound_ms": bw["bound_ms"],
        "bound_by": bw["bound_by"], "library_ms": bw["library_ms"]}] + [{
        # per stage-5 step (48 launches at B 64, kh 6); the library yardstick
        # is SDPA's whole backward, for the pair
        "name": f"attention_bwd_{k}", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/attention_bwd_split.cu",
        "replaces": f"devit_tpu/kernels/attention.py:{line}",
        "launches": ens["launches"][f"attention_bwd_{k}"],
        "max_abs_err": max(split_max_abs_err[k], hm[k]),
        "ms": es[k]["ms"], "plain_ms": es[k]["plain_ms"], "bound_ms": es[k]["bound_ms"],
        "bound_by": es[k]["bound_by"], "library_ms": es[k]["library_ms"]}
        for k, line in (("dv", 306), ("dqdk", 324))]}
    i8, bl = times["int8"]["int8_forward"], times["int8"]["block_forward"]
    record["kernels"] += [{
        # per bs256 deployed int8 forward (192 calls); the library yardstick
        # is torch._int_mm, the int8 dot alone (cuBLASLt)
        "name": "fused_int8_matmul", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "devit_tpu/kernels/quant.py:64",
        "launches": int8["launches"], "max_abs_err": int8_max_abs_err,
        "ms": i8["ms"], "plain_ms": i8["plain_ms"], "bound_ms": i8["bound_ms"],
        "bound_by": i8["bound_by"], "library_ms": i8["library_ms"]}, {
        # per bs256 deployed forward (48 calls); no one PyTorch call computes
        # LayerNorm + qkv + attention + proj + residual
        "name": "fused_block_attention", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/block_attention.cu",
        "replaces": "devit_tpu/kernels/attention.py:133",
        "launches": block["launches"], "max_abs_err": max(block["max_abs_err"], hm["block"]),
        "ms": bl["ms"], "plain_ms": bl["plain_ms"], "bound_ms": bl["bound_ms"],
        "bound_by": bl["bound_by"], "library_ms": None}]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, build_s=build_s, mma_counts=mma_counts, kernels=record["kernels"], **times,
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
