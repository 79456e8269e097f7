#!/usr/bin/env python3
"""Drive the PyTorch port (devit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout. It builds the CUDA kernels from the
sources in the checkout, counts the tensor-core instructions in the built
library (HMMA in the bf16 attention kernels at each head width: the
forward, the monolithic backward and the split pair, three instantiations
of one template, the forward and the backward pair past 256 keys, and the
block-attention kernels: the whole-row pair and the chunked route's
LayerNorm + qkv GEMM; 3xTF32 HMMA in the f32 forward, backward pair and
block-half GEMMs; IMMA in the int8 GEMM), holds each kernel
against its plain PyTorch version on the card (the split pair also against
the monolithic kernel, bit for bit; every backward past 256 keys at head
widths 32, 64 and 128, [bwd-long]; the f32 kernels at N 198 to 4098,
[f32-long]), runs the deployed 4-division dedeit
ensemble at full width, serves it over HTTP to concurrent clients, times
the kernels and the forward. Right after the attention checks, [gelu]
holds the A&S-erf GELU kernels (csrc/gelu.cu) against the plain chain (the
forward bit for bit in bf16, f16 and f32, special values included; the
backward's error against f64 no larger than autograd of the chain's) and
times both at the stage-2 hidden tensors, (256, 198, 1536) and
(64, 578, 1536), against the chain, F.gelu and the bytes bound. Then
[moe] holds the sparse-expert dispatch and combine kernels (csrc/moe.cu)
against their eager paths at the V-MoE cell's group (T 25,216, C 1,024,
E 32, cap 1,655, bf16: four calls bit for bit, the weights' gradient
within 1e-5), times each against its eager path and its bytes bound, and
runs two remat'd stage-2 steps of V-MoE-L/16 (3.43 B parameters, built on
the card) through train_epoch, counting each step's kernel launches. Then the deployment artifacts: the int8 matmul
kernel against its
plain version at every deployed weight shape, the block-attention kernel at
every deployed layer and through its routes' main paths (the deployed
forward in bf16 and f32, and at 384 px), the divisions and the fusion head written to disk in
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
and 128 against its plain version, timed in bf16 and f32 ([heads]); stage 2 from a
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
val set equal to `ensemble --compact-path`'s. Then the attention kernels at
every sequence length and head width the JAX kernel takes ([attn-long]:
N 291 to 1026, head widths 32 to 320, the forward, the trainable attention
in both backward modes and the block half against their plain versions,
the key-chunked designs and those past head width 128 timed), one dedeit
stage-2 step at 384 px in f32
and bf16 against the plain attention, the steady bf16 step at B 64 and f32
step at B 16 with the kernels and with the plain attention in turns
([stage2-384]), the stage-2 step of a dedeit with --embed-dim 768
--num-heads 4 (dh 192, depth 4) in f32 and bf16 against the plain attention,
the main path of the routes past head width 128 ([stage2-wide]), the CCT family
([cct]: cct_14_7x2_224 on the card against the CPU, a bf16 stage-2 step,
and `pipeline --model cct_7_3x1_32` through every stage) and the stage-5
resume across optimizer families ([resume]). Then orbax checkpoints through
the command line ([orbax]): `train_sub` of full-width dedeit for an epoch
and a resumed epoch with --ckpt-format msgpack and orbax, their checkpoints
equal bit for bit, `convert` and `inspect` on the orbax directory, the
JAX-written checkpoint of tests/torch_data/jax_orbax_tiny run by the f32
forward against the JAX package's logits, and each format's save and
restore times. Then the masked-attention text
CCT at its defaults against the CPU and in 10 AdamW steps ([text]), and the
stage-2 step under five remat policies, each held to full remat, with its
attention launches a step, ms a step and peak memory ([remat]). Then
several ranks: two ranks sharing the card over gloo run the full-width
stage-2 step ([dist-stage2]), four run the stage-5 step with one division
each ([dist-ens]), each held to the one-process step; the collaborative server
over the deployed divisions against the engine, its lag-2 stream against
per-batch serving ([collab]); `devit-torch train_sub` under two ranks
against one process ([cli-dist]); and dryrun_multichip(8) on eight ranks
sharing the card ([dryrun]). Any failure
raises and exits non-zero; so does a machine without CUDA, or a directory
that holds this script without the package (the import of devit_tpu_torch
fails: exit 1).

The last lines of standard output are the card's name and power limit (as
nvidia-smi gives them), one JSON line with the kernels' record, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import itertools
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
from types import SimpleNamespace
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
from devit_tpu_torch.kernels import _build, gelu
from devit_tpu_torch.kernels import moe as kmoe
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.io.bridge import ensmlp_to_jax_params, vit_from_jax_params
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
from devit_tpu_torch.models import moe
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
TF32X3_FLOPS = 495e12 / 3  # f32 products as three TF32 passes on the tensor cores (3xTF32)
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


def _time_ms(fn, iters: int = 20, warmup: int = 3, spin: bool = False) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls;
    with `spin`, queued behind a ~3 ms spin kernel, so the calls' host time
    stays out of a short call's reading."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(5_000_000)
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
# forward attn_kernel_mma<KC, DH> and, past 256 keys, attn_long_mma<DH>; of
# the backward template attn_bwd_kernel_mma<DQDK, DV, DH> and, past 256 keys,
# of attn_bwd_long_rows_mma<DH, DQ> and attn_bwd_long_keys_mma<DH, DK, DV>;
# the f32 forward attn_long_tf32<DH> and backward pair
# attn_bwd_long_rows_tf32<DH, DQ> and attn_bwd_long_keys_tf32<DH, DK, DV>
# (3xTF32: HMMA.1688.F32.TF32); past head width 128, in both dtypes,
# attn_wide_mma<T, SW>, attn_bwd_wide_rows_mma<T, DQ> and
# attn_bwd_wide_keys_mma<T, DK, DV>; of the block-attention kernels, bf16
# block_qkv_attn_kernel<KC, DH> and block_proj_kernel<Ragged> (the whole-row
# route) and block_ln_qkv_mma (the chunked route's LayerNorm + qkv), f32
# block_gemm_tf32<LN> (the chunked route's two GEMMs, 3xTF32); the int8 GEMM
# (m16n8k32 s8 is IMMA).
# tests/test_torch_kernel_build.py checks that every __global__ of csrc/ is
# either here or in its list of CUDA-core kernels.
HEAD_DIMS = (32, 64, 128)
KEY_CHUNKS = (4, 8, 13, 16)  # KC: the score registers' key steps (launch_bf16)
WIDE_TYPES = (("bf16", "13__nv_bfloat16"), ("f32", "f"))  # T of the wide kernels, mangled
MMA_KERNELS = {
    **{f"attn_kernel_mma<{kc},{dh}>": (rf"attn_kernel_mmaILi{kc}ELi{dh}EE", "HMMA")
       for dh in HEAD_DIMS for kc in KEY_CHUNKS},
    **{f"attn_bwd_kernel_mma<{a},{b},{dh}> ({w})": (rf"attn_bwd_kernel_mmaILb{ia}ELb{ib}ELi{dh}EE",
                                                     "HMMA")
       for dh in HEAD_DIMS
       for a, b, ia, ib, w in (("true", "true", 1, 1, "attention_bwd"),
                               ("false", "true", 0, 1, "attention_bwd_dv"),
                               ("true", "false", 1, 0, "attention_bwd_dqdk"))},
    **{f"attn_long_mma<{dh}> (fused_attention past 256 keys)":
       (rf"attn_long_mmaILi{dh}EE", "HMMA") for dh in HEAD_DIMS},
    **{f"attn_bwd_long_rows_mma<{dh},{q}> ({w})": (rf"attn_bwd_long_rows_mmaILi{dh}ELb{iq}EE",
                                                   "HMMA")
       for dh in HEAD_DIMS
       for q, iq, w in (("true", 1, "attention_bwd, attention_bwd_dqdk past 256 keys"),
                        ("false", 0, "attention_bwd_dv past 256 keys"))},
    **{f"attn_bwd_long_keys_mma<{dh},{a},{b}> ({w})":
       (rf"attn_bwd_long_keys_mmaILi{dh}ELb{ia}ELb{ib}EE", "HMMA")
       for dh in HEAD_DIMS
       for a, b, ia, ib, w in (("true", "true", 1, 1, "attention_bwd past 256 keys"),
                               ("false", "true", 0, 1, "attention_bwd_dv past 256 keys"),
                               ("true", "false", 1, 0, "attention_bwd_dqdk past 256 keys"))},
    **{f"attn_long_tf32<{dh}> (fused_attention f32)": (rf"attn_long_tf32ILi{dh}EE", "HMMA")
       for dh in HEAD_DIMS},
    **{f"attn_bwd_long_rows_tf32<{dh},{q}> ({w} f32)":
       (rf"attn_bwd_long_rows_tf32ILi{dh}ELb{iq}EE", "HMMA")
       for dh in HEAD_DIMS
       for q, iq, w in (("true", 1, "attention_bwd, attention_bwd_dqdk"),
                        ("false", 0, "attention_bwd_dv"))},
    **{f"attn_bwd_long_keys_tf32<{dh},{a},{b}> ({w} f32)":
       (rf"attn_bwd_long_keys_tf32ILi{dh}ELb{ia}ELb{ib}EE", "HMMA")
       for dh in HEAD_DIMS
       for a, b, ia, ib, w in (("true", "true", 1, 1, "attention_bwd"),
                               ("false", "true", 0, 1, "attention_bwd_dv"),
                               ("true", "false", 1, 0, "attention_bwd_dqdk"))},
    # past head width 128, both dtypes: the forward and the backward pair over
    # head pieces and output slabs (csrc/wide.cuh), any slab width
    **{f"attn_wide_mma<{t}> (fused_attention past dh 128)":
       (rf"attn_wide_mmaI{m}Li\d+EE", "HMMA") for t, m in WIDE_TYPES},
    **{f"attn_bwd_wide_rows_mma<{t},{q}> ({w} past dh 128)":
       (rf"attn_bwd_wide_rows_mmaI{m}Lb{iq}EE", "HMMA")
       for t, m in WIDE_TYPES
       for q, iq, w in (("true", 1, "attention_bwd, attention_bwd_dqdk"),
                        ("false", 0, "attention_bwd_dv"))},
    **{f"attn_bwd_wide_keys_mma<{t},{a},{b}> ({w} past dh 128)":
       (rf"attn_bwd_wide_keys_mmaI{m}Lb{ia}ELb{ib}EE", "HMMA")
       for t, m in WIDE_TYPES
       for a, b, ia, ib, w in (("true", "true", 1, 1, "attention_bwd"),
                               ("false", "true", 0, 1, "attention_bwd_dv"),
                               ("true", "false", 1, 0, "attention_bwd_dqdk"))},
    **{f"block_qkv_attn_kernel<{kc},{dh}> (fused_block_attention)":
       (rf"block_qkv_attn_kernelILi{kc}ELi{dh}EE", "HMMA")
       for dh in HEAD_DIMS for kc in KEY_CHUNKS},
    **{f"block_proj_kernel<{r}> (fused_block_attention)": (rf"block_proj_kernelILb{i}EE", "HMMA")
       for r, i in (("false", 0), ("true", 1))},
    "block_ln_qkv_mma (fused_block_attention chunked)": ("block_ln_qkv_mma", "HMMA"),
    **{f"block_gemm_tf32<{ln}> (fused_block_attention f32 {w})":
       (rf"block_gemm_tf32ILb{i}EE", "HMMA")
       for ln, i, w in (("true", 1, "LayerNorm + qkv"), ("false", 0, "proj"))},
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
    print(f"[build] tensor-core instructions (cuobjdump -sass; HMMA bf16 and TF32, IMMA int8): "
          f"{', '.join(f'{k} {MMA_KERNELS[k][1]} {n}' for k, n in counts.items())}")
    return secs, counts


# the stage-2 MLP hidden tensors: bs256 at 224 px (N 198) and bs64 at 384 px (N 578)
GELU_SHAPES = ((256, 198, 1536), (64, 578, 1536))


def _gelu_mismatches(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(elements whose bits differ, the largest |got - want| over them), NaN
    against NaN counting as equal; a NaN or infinity against anything else
    reads as an infinite gap."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}
    both_nan = got.isnan() & want.isnan()
    differ = (got.view(ints[got.dtype]) != want.view(ints[want.dtype])) & ~both_nan
    gap = (got.double() - want.double()).abs()[differ].nan_to_num(nan=float("inf"))
    return int(differ.sum()), gap.max().item() if gap.numel() else 0.0


def _chain_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    xr = x.detach().requires_grad_(True)
    (dx,) = torch.autograd.grad(gelu.reference_gelu(xr), xr, dy)
    return dx


def phase_gelu(card: str) -> dict:
    """[gelu] The A&S-erf GELU kernels (csrc/gelu.cu) against the plain chain
    (reference_gelu and autograd through it), then timed at the stage-2
    hidden tensors: kernel, chain, F.gelu (the exact erf) and the bytes
    bound, each operand read and written once at 3.35 TB/s. These launches
    are not the main path's: the counts are restored."""
    counts = (gelu.fused_gelu.launches, gelu.fused_gelu_bwd.launches)
    gen = torch.Generator(device="cuda").manual_seed(22)
    specials = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-45, -1e-45,
                             3e-39, -1e-38, 1e30, -1e30, 65504.0, -65504.0, 10.0, -10.0],
                            device="cuda")
    checks, fwd_err = {}, 0.0
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        tiny = torch.finfo(dtype).tiny
        odd = torch.randn((3, 5, 7), generator=gen, device="cuda").to(dtype)
        big = (3 * torch.randn(GELU_SHAPES[0], generator=gen, device="cuda")).to(dtype)
        extra = torch.cat([specials.to(dtype), (tiny * torch.tensor([0.5, -0.25, 0.01],
                                                                    device="cuda")).to(dtype)])
        for x in (odd, big, extra, big.flatten()[1:1001], big[:, :7].transpose(0, 1)):
            bad, gap = _gelu_mismatches(gelu.fused_gelu(x), gelu.reference_gelu(x))
            fwd_err = max(fwd_err, gap)
            if bad:
                raise AssertionError(f"[gelu] forward {dtype} {tuple(x.shape)}: {bad} elements "
                                     f"differ from the chain (largest gap {gap:.3e})")
        del big
        # the backward against the chain's autograd (and at f32 both against
        # f64): a 1-D mix near 0 and up to |x| 10, then the stage-2 shapes
        line = torch.cat([torch.linspace(-0.05, 0.05, 200_001, device="cuda"),
                          torch.linspace(-10, 10, 20_001, device="cuda"),
                          3 * torch.randn(1_000_000, generator=gen, device="cuda")])
        checks[str(dtype)] = r = {}
        for x in [line] + [3 * torch.randn(shape, generator=gen, device="cuda")
                           for shape in GELU_SHAPES]:
            x = x.to(dtype)
            dy = (torch.rand(x.shape, generator=gen, device="cuda") + 0.5).to(dtype)
            got, want = gelu.fused_gelu_bwd(x, dy), _chain_grad(x, dy)
            where = "x".join(map(str, x.shape))
            if dtype == torch.float32:
                exact = gelu.gelu_as_slope(x.double()) * dy.double()
                err, chain_err = ((t.double() - exact).abs().max().item() for t in (got, want))
                del exact
                r[where] = dict(bwd_err=err, chain_bwd_err=chain_err)
                if not err <= chain_err:
                    raise AssertionError(f"[gelu] backward f32 {where}: error {err:.3e} against "
                                         f"f64, the chain's {chain_err:.3e}")
            else:
                ulp = torch.finfo(dtype).eps * want.float().abs().clamp_min(tiny)
                gap = (got.float() - want.float()).abs()
                over = int((gap > ulp + 8 * 2.0 ** -23 * dy.float().abs()).sum())
                r[where] = dict(bwd_over_one_ulp=over, bwd_max_gap=gap.max().item())
                if over:
                    raise AssertionError(f"[gelu] backward {dtype} {where}: {over} elements "
                                         f"past one ulp of the chain's")
            del x, dy, got, want
        torch.cuda.empty_cache()
    bwd_err = max(v["bwd_err"] for v in checks["torch.float32"].values())
    print(f"[gelu] forward bit for bit the chain in bf16, f16, f32 (odd sizes, a misaligned "
          f"and a strided input, +-0, subnormals, +-inf, NaN; largest gap {fwd_err:.3e}); "
          f"backward at a 1-D mix and {GELU_SHAPES}: {checks} [{card}]")

    times = {}
    for shape in GELU_SHAPES:
        x = (3 * torch.randn(shape, generator=gen, device="cuda")).bfloat16()
        dy = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        xr = x.detach().requires_grad_(True)
        y_chain, y_lib = gelu.reference_gelu(xr), torch.nn.functional.gelu(xr)
        n = x.numel()
        r = {"fwd": dict(ms=_time_ms(lambda: gelu.fused_gelu(x), iters=30, spin=True),
                         plain_ms=_time_ms(lambda: gelu.reference_gelu(x), iters=5, spin=True),
                         library_ms=_time_ms(lambda: torch.nn.functional.gelu(x), iters=30,
                                             spin=True),
                         bound_ms=2 * n * 2 / HBM_BYTES_PER_S * 1e3),
             "bwd": dict(ms=_time_ms(lambda: gelu.fused_gelu_bwd(x, dy), iters=30, spin=True),
                         plain_ms=_time_ms(lambda: torch.autograd.grad(
                             y_chain, xr, dy, retain_graph=True), iters=5, spin=True),
                         library_ms=_time_ms(lambda: torch.autograd.grad(
                             y_lib, xr, dy, retain_graph=True), iters=30, spin=True),
                         bound_ms=3 * n * 2 / HBM_BYTES_PER_S * 1e3)}
        for k, t in r.items():
            t.update(bound_by="bytes", share=t["bound_ms"] / t["ms"])
            print(f"[gelu] {k} bf16 {shape}: kernel {t['ms']:.4f} ms ({t['share']:.1%} of the "
                  f"bytes bound {t['bound_ms']:.4f}); chain {t['plain_ms']:.4f}; F.gelu "
                  f"{t['library_ms']:.4f} [{card}]")
        times["x".join(map(str, shape))] = r
        del x, dy, xr, y_chain, y_lib
    torch.cuda.empty_cache()
    gelu.fused_gelu.launches, gelu.fused_gelu_bwd.launches = counts
    return dict(checks=checks, fwd_err=fwd_err, bwd_err=bwd_err, times=times)


# V-MoE-L/16's routing group at the cell's batch: T = 128 x 197 tokens, C,
# experts, capacity round(2 T 1.05 / 32); the main-path steps' batch
MOE_SHAPE, MOE_K, MOE_STEP_B = (128 * 197, 1024, 32, 1655), 2, 16


def _moe_bytes(T: int, K: int, S: int, C: int, kept: int, elem: int = 2) -> dict:
    """Least bytes of each MoE kernel call, every value read or written
    once (benchmark/metrics/_moe_counts.py counts a step the same way):
    kept rows read, every slot or token row written, the maps and the f32
    weights."""
    rows = kept * C * elem
    return {"gather": rows + S * C * elem + S * 4,
            "gather_weighted": rows + S * C * elem + S * 4 + 2 * T * K * 4,
            "combine": rows + 2 * T * K * 4 + T * C * elem,
            "combine_w1": rows + T * K * 4 + T * C * elem,
            "combine_dw": T * C * elem + rows + 2 * T * K * 4}


def phase_moe(card: str) -> dict:
    """[moe] The dispatch and combine kernels (csrc/moe.cu) against their
    eager paths at the V-MoE cell's group in bf16: the gather (plain and
    weighted) and the combine (weighted and of weight 1) bit for bit, the
    weights' gradient within 1e-5 of the largest; each timed against the
    eager path and its bytes bound. Then the main path: two remat'd stage-2
    steps of V-MoE-L/16 at B 16, the counters zeroed just before them, each
    step launching 3 gathers and 4 combines a MoE layer."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    T, C, E, cap = MOE_SHAPE
    choice = moe.top_k(torch.randn((T, E), generator=gen, device="cuda"), MOE_K)
    tok_slot, slot_tok, _ = moe.slot_maps(choice, E, cap)
    kept = int((tok_slot >= 0).sum())
    x = torch.randn((T, C), generator=gen, device="cuda").bfloat16()
    buf = torch.randn((E * cap, C), generator=gen, device="cuda").bfloat16()
    w = torch.rand((T, MOE_K), generator=gen, device="cuda")
    calls = {
        "gather": (lambda: kmoe.moe_gather(x, slot_tok),
                   lambda: kmoe.reference_gather(x, slot_tok)),
        "gather_weighted": (lambda: kmoe.moe_gather(x, slot_tok, tok_slot, w),
                            lambda: kmoe.reference_gather(x, slot_tok, tok_slot, w)),
        "combine": (lambda: kmoe.moe_combine(buf, tok_slot, w),
                    lambda: kmoe.reference_combine(buf, tok_slot, w)),
        "combine_w1": (lambda: kmoe.moe_combine(buf, tok_slot),
                       lambda: kmoe.reference_combine(buf, tok_slot)),
        "combine_dw": (lambda: kmoe.moe_combine_dw(x, buf, tok_slot),
                       lambda: kmoe.reference_combine_dw(x, buf, tok_slot))}
    gaps = {}
    for name, (kernel, eager) in calls.items():
        got, want = kernel(), eager()
        if name == "combine_dw":
            rel = _rel(got, want)
            gaps[name] = (got - want).abs().max().item()
            if not rel < 1e-5:
                raise AssertionError(f"[moe] combine_dw: {rel:.3e} of the largest from the "
                                     f"eager path (tol 1e-5)")
            continue
        bad, gaps[name] = _gelu_mismatches(got, want)
        if bad:
            raise AssertionError(f"[moe] {name}: {bad} values differ from the eager path "
                                 f"(largest gap {gaps[name]:.3e})")
    nbytes = _moe_bytes(T, MOE_K, E * cap, C, kept)
    times = {}
    for name, (kernel, eager) in calls.items():
        t = dict(ms=_time_ms(kernel, iters=30, spin=True),
                 plain_ms=_time_ms(eager, iters=5, spin=True),
                 bound_ms=nbytes[name] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                 library_ms=None)
        t["share"] = t["bound_ms"] / t["ms"]
        times[name] = t
    print(f"[moe] T {T}, C {C}, E {E}, cap {cap}, bf16, {kept / (T * MOE_K):.2%} of the "
          f"choices kept: gather, weighted gather, combine and combine of weight 1 bit for bit "
          f"the eager path; combine_dw's largest gap {gaps['combine_dw']:.3e} (under 1e-5 of "
          f"the largest) [{card}]")
    for name, t in times.items():
        print(f"[moe] {name}: kernel {t['ms']:.4f} ms ({t['share']:.1%} of the bytes bound "
              f"{t['bound_ms']:.4f}); eager {t['plain_ms']:.4f} [{card}]")
    del x, buf, w, choice, tok_slot, slot_tok, calls
    torch.cuda.empty_cache()

    # the main path: V-MoE-L/16 built on the card, N(0, 0.02) kernels
    cfg = get_vit_config("vmoe_l16_e32", num_classes=100, drop_path_rate=0.1)
    with torch.device("cuda"):
        model = VisionTransformer(cfg, dtype=torch.bfloat16, use_kernel=True, use_remat=True)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    params = sum(p.numel() for p in model.parameters())
    state = TrainState.create(model, make_optimizer(OptimConfig(lr=5e-4, epochs=100), 391),
                              use_ema=False)
    mix = MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5,
                      label_smoothing=0.1, num_classes=100)
    step = make_stage2_step(model, None, mixup=mix, smoothing=0.1, distillation_type="none")
    images = torch.randn((MOE_STEP_B, 224, 224, 3), generator=gen, device="cuda").bfloat16()
    labels = torch.randint(0, 100, (MOE_STEP_B,), generator=gen, device="cuda")
    per_step, losses = [], []

    def step_fn(state, images, labels, generator):
        g0, c0 = kmoe.moe_gather.launches, kmoe.moe_combine.launches
        state, metrics = step(state, None, images, labels, generator)
        per_step.append((kmoe.moe_gather.launches - g0, kmoe.moe_combine.launches - c0))
        losses.append((metrics["loss"], metrics["aux_loss"]))
        return state, metrics

    moe.reset_route_counts(model)
    torch.cuda.reset_peak_memory_stats()
    kmoe.moe_gather.launches = kmoe.moe_combine.launches = 0
    t0 = time.perf_counter()
    state, _, _ = train_epoch(step_fn, state, [(images, labels)] * 2,
                              torch.Generator().manual_seed(24), epoch=0, log_fn=lambda *_: None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    layers = len(cfg.moe_layers)
    launches = (kmoe.moe_gather.launches, kmoe.moe_combine.launches)
    if per_step != [(3 * layers, 4 * layers)] * 2 or launches != (6 * layers, 8 * layers):
        raise AssertionError(f"[moe] per-step launches {per_step} (in all {launches}), expected "
                             f"({3 * layers}, {4 * layers}) in each of 2 steps")
    host = [(float(l), float(a)) for l, a in losses]
    if not np.isfinite(host).all():
        raise AssertionError(f"[moe] non-finite loss or auxiliary loss: {host}")
    counts = moe.route_counts(model)
    routed = sum(c["routed"] for c in counts.values())
    dropped = sum(c["dropped"] for c in counts.values())
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[moe] V-MoE-L/16 ({params / 1e6:.2f} M parameters) at B {MOE_STEP_B}, bf16, remat, "
          f"mixup/cutmix, AdamW: 2 steps through train_epoch in {secs:.2f} s (the first builds "
          f"cuBLAS's plans), each {per_step[0][0]} gather + {per_step[0][1]} combine launches "
          f"over {layers} MoE layers; (loss, aux) {host}; {dropped / routed:.1%} of {routed} "
          f"token-choices dropped (seeded routers); peak {peak:.2f} GiB [{card}]")
    del model, state, step, images, labels
    torch.cuda.empty_cache()
    return dict(checks=gaps, kept_share=kept / (T * MOE_K), times=times,
                gather_err=max(gaps["gather"], gaps["gather_weighted"]),
                combine_err=max(gaps["combine"], gaps["combine_w1"], gaps["combine_dw"]),
                launches=launches, per_step=per_step, losses=host, steps_s=secs,
                dropped_share=dropped / routed, peak_gib=peak, params=params)


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


def _features(cms, x, *, dtype, use_kernel, fast_math, int8=False):
    """The divisions' stacked (cls, dist) tokens, the fusion head's input."""
    return stack_division_features(cms, x, patch_size=16, dtype=dtype, use_kernel=use_kernel,
                                   fast_math=fast_math, int8=int8)


def _forward(cms, ens, x, *, dtype, use_kernel, fast_math, int8=False):
    return ens(*_features(cms, x, dtype=dtype, use_kernel=use_kernel, fast_math=fast_math,
                          int8=int8)).logits


F32_FEATURE_TOL = 1e-5  # the f32 divisions' tokens, kernel vs plain attention


@torch.inference_mode()
def phase_full_width(cms, ens) -> None:
    """The deployed ensemble at bs16: the forward through the kernel vs the
    same forward through the plain attention, with the divisions in bf16 and
    fast_math (the serving numerics; the logits within 2e-2) and in f32 with
    strict numerics. The deployed fusion head computes in bf16, whose
    rounding moves a logit by one bf16 ulp (2.5e-3 of the largest here) for
    a 3e-7 change in the head's input; so at f32 the divisions' tokens are
    held within F32_FEATURE_TOL and the logits of the same head computed in
    f32 within 1e-3, and the bf16 head's logits are printed beside them."""
    imgs = np.random.default_rng(1).integers(0, 256, (16, 224, 224, 3), dtype=np.uint8)
    x = normalize(torch.from_numpy(imgs).cuda(), torch.float32)
    head32 = copy.deepcopy(ens)
    head32.dtype = torch.float32
    for dtype, fast, tol in ((torch.bfloat16, True, 2e-2), (torch.float32, False, 1e-3)):
        before = fused_attention.launches
        feats = _features(cms, x, dtype=dtype, use_kernel=True, fast_math=fast)
        got = ens(*feats).logits
        torch.cuda.synchronize()
        launches = fused_attention.launches - before
        if launches != 48:
            raise AssertionError(f"{launches} kernel launches in one forward, expected 48")
        plain = _features(cms, x, dtype=dtype, use_kernel=False, fast_math=fast)
        want = ens(*plain).logits
        if fused_attention.launches - before != 48:
            raise AssertionError("the plain forward launched the kernel")
        if got.shape != (16, 100) or got.dtype != torch.float32:
            raise AssertionError(f"logits {tuple(got.shape)} {got.dtype}, expected (16, 100) f32")
        rel = _rel(got, want)
        note = ""
        if dtype == torch.float32:
            rel_feat = max(_rel(a, b) for a, b in zip(feats, plain) if a is not None)
            if rel_feat > F32_FEATURE_TOL:
                raise AssertionError(f"full-width f32 forward: the divisions' tokens, kernel vs "
                                     f"plain rel {rel_feat:.3e} > {F32_FEATURE_TOL}")
            note = (f"; tokens {rel_feat:.3e} (tol {F32_FEATURE_TOL}); the bf16 head's logits "
                    f"{rel:.3e}")
            rel = _rel(head32(*feats).logits, head32(*plain).logits)
        if rel > tol:
            raise AssertionError(f"full-width {dtype} forward: kernel vs plain rel {rel:.3e} > {tol}")
        print(f"[forward] full width bs16 {str(dtype)[6:]} fast_math={fast}: 48 launches, "
              f"kernel vs plain rel err {rel:.3e} (tol {tol}; at f32 the head in f32){note}")


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


def _block_bound(B: int, C: int, K: int, dtype=torch.bfloat16, n: int = N):
    """Least time of one fused_block_attention call: read t (B, n, C) and the
    layer's LN, qkv (C, 3K) and proj (K, C) weights and biases, write (B, n,
    C), against 2 B n C 3K + 4 B n^2 K + 2 B n K C operations at the dtype's
    peak (bf16; f32 as 3xTF32). Returns (ms, bytes ms)."""
    M = B * n
    elem = 4 if dtype == torch.float32 else 2
    nbytes = elem * (2 * M * C + 4 * C + C * 3 * K + 3 * K + K * C + C)
    flops = 2 * M * C * 3 * K + 4 * B * n * n * K + 2 * M * K * C
    t_bytes = nbytes / HBM_BYTES_PER_S
    peak = TF32X3_FLOPS if dtype == torch.float32 else BF16_FLOPS
    return max(t_bytes, flops / peak) * 1e3, t_bytes * 1e3


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
    if "attn_kernel" in kernel_name or "attn_long_mma" in kernel_name:
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


def _images(B: int, seed: int, px: int = PX) -> torch.Tensor:
    return normalize(torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (B, px, px, 3), dtype=np.uint8)).cuda(), torch.float32)


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


def _block_features(cms, x, dtype=torch.bfloat16, fast_math: bool = True):
    """The divisions' stacked (cls, dist) tokens of the deployed forward with
    each layer's attention half through fused_block_attention and its MLP
    half and final LayerNorm as compact_forward runs them."""
    from devit_tpu_torch.models.vit import layer_norm

    cls_t, dist_t = [], []
    for cm in cms:
        t = embed_patches(cm, x, patch_size=16, dtype=dtype)
        for lp in cm.layers:
            t = fused_block_attention(*_block_args(lp, t), num_heads=lp.num_heads, eps=cm.eps)
            t = mlp_half(lp, t, eps=cm.eps, dtype=dtype, fast_math=fast_math)
        t = layer_norm(t, cm.norm_scale, cm.norm_bias, cm.eps,
                       dtype if fast_math else torch.float32)
        cls_t.append(t[:, 0])
        dist_t.append(t[:, 1])
    return torch.stack(cls_t), torch.stack(dist_t)


BLOCK_384 = (64, 384)  # batch and image side of the 384-px forward through the chunked route


def _at_px(cms, px: int) -> list:
    """Copies of the compact divisions for px-wide images: the position
    embeddings resized to the new grid (bicubic, as the checkpoint
    converters resize them), every other weight shared."""
    from devit_tpu_torch.io.checkpoint import resize_pos_embed

    out = []
    for cm in cms:
        c = copy.copy(cm)  # a shallow copy: the layers are the same modules
        c._parameters = dict(cm._parameters)
        n = (px // 16) ** 2 + 1 + int(cm.distilled)
        pe = resize_pos_embed(cm.pos_embed.detach().cpu().numpy(), n, 1 + int(cm.distilled))
        c.pos_embed = torch.nn.Parameter(torch.from_numpy(pe).to(cm.pos_embed.device),
                                         requires_grad=False)
        out.append(c)
    return out


@torch.inference_mode()
def phase_block_attention(cms, ens, card: str) -> dict:
    """fused_block_attention (the kernel) vs reference_block_attention on the
    card at each of the 48 deployed layers, on the t that compact_forward
    (with the attention kernel) feeds the layer, for images at B 1, 7 and
    256: bf16 with fast_math (the serving numerics, tol 2e-2) and f32 with
    strict numerics (tol 1e-4, and within the JAX test's 2e-4 of the split
    sequence, attention_half); every case launched twice, bit for bit. Then
    the deployed bs256 forward with every attention half through the kernel
    (its 48 launches on the whole-row route, counted from 0), logits against
    compact_forward's; the main paths of the chunked route, each counted
    from 0: the same forward at f32 (strict numerics; the divisions' tokens
    within 2e-4 of compact_forward's) and the forward of 384-px images (N 578;
    the position embeddings resized) in bf16 (logits within 2e-2), 48
    chunked launches each; the 384-px route timed layer by layer."""
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
    before_chunked = fused_block_attention.chunked_launches
    fused_block_attention.launches = fused_block_attention.chunked_launches = 0
    got = ens(*_block_features(cms, x)).logits
    torch.cuda.synchronize()
    launches = fused_block_attention.launches
    want = _forward(cms, ens, x, dtype=torch.bfloat16, use_kernel=True, fast_math=True)
    rel = _rel(got, want)
    if launches != layers or fused_block_attention.chunked_launches or rel > 2e-2:
        raise AssertionError(f"bs256 forward through fused_block_attention: {launches} "
                             f"launches (expected {layers}), "
                             f"{fused_block_attention.chunked_launches} on the chunked route "
                             f"(expected 0), logits vs compact_forward rel {rel:.3e}")
    print(f"[block-attn] deployed bs256 forward with every attention half through the kernel: "
          f"{launches} launches (the whole-row route), logits vs compact_forward's rel err "
          f"{rel:.3e} (tol 2e-2) [{card}]")

    # the chunked route's main paths, each counted from 0: the f32 forward
    # (every f32 call: 3xTF32 GEMMs, attn_long_tf32) and the 384-px bf16
    # forward (N 578, past the whole-row block: block_ln_qkv_mma,
    # attn_long_mma, block_proj_kernel)
    chunked = {}
    B384, px = BLOCK_384
    cms384 = _at_px(cms, px)
    for tag, mods, xs, dtype, fast in (
            ("f32", cms, x, torch.float32, False),
            ("bf16 384px", cms384, _images(B384, seed=70, px=px), torch.bfloat16, True)):
        fused_block_attention.launches = fused_block_attention.chunked_launches = 0
        feats = _block_features(mods, xs, dtype, fast)
        torch.cuda.synchronize()
        counts = (fused_block_attention.launches, fused_block_attention.chunked_launches)
        plain = _features(mods, xs, dtype=dtype, use_kernel=True, fast_math=fast)
        # f32: the divisions' tokens, within the JAX test's 2e-4 of the split
        # sequence; bf16: the fusion head's logits, within 2e-2
        errs = ([_rel(a, b) for a, b in zip(feats, plain)] if dtype == torch.float32
                else [_rel(ens(*feats).logits, ens(*plain).logits)])
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        if counts != (layers, layers) or max(errs) > tol:
            raise AssertionError(f"[block-attn] {tag} forward through the chunked route: "
                                 f"launches {counts} (expected {layers} and {layers} chunked), "
                                 f"rel err {errs} (tol {tol:.0e})")
        chunked[tag] = dict(launches=counts[1], rel=max(errs))
        what = "cls and dist tokens" if dtype == torch.float32 else "logits"
        print(f"[block-attn] deployed forward at {xs.shape[0]} x {xs.shape[1]} px, "
              f"{str(dtype)[6:]}, every attention half through the chunked route: "
              f"{counts[0]} launches, {counts[1]} chunked; {what} vs compact_forward's rel err "
              f"{max(errs):.3e} (tol {tol:.0e}) [{card}]")
    fused_attention.launches = fa_before
    fused_block_attention.launches = before + launches + 2 * layers
    fused_block_attention.chunked_launches = before_chunked + 2 * layers

    # the 384-px route timed at each of its 48 layers (timing launches, not
    # counted), beside its plain version and its bound
    t384 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0}
    counts = fused_block_attention.launches, fused_block_attention.chunked_launches
    x384 = _images(B384, seed=71, px=px)
    for cm in cms384:
        t = embed_patches(cm, x384, patch_size=16, dtype=torch.bfloat16)
        for lp in cm.layers:
            args, kw = _block_args(lp, t), dict(num_heads=lp.num_heads, eps=cm.eps)
            t384["ms"] += _time_ms(lambda: fused_block_attention(*args, **kw), iters=5, warmup=1)
            t384["plain_ms"] += _time_ms(lambda: reference_block_attention(*args, **kw), iters=3,
                                         warmup=1)
            bound, bytes_ms = _block_bound(B384, t.shape[-1], lp.num_heads * DH, n=t.shape[1])
            t384["bound_ms"] += bound
            t384["bytes_ms"] += bytes_ms
            t = mlp_half(lp, attention_half(lp, t, eps=cm.eps), eps=cm.eps)
    t384["bound_by"] = ("bytes" if t384["bytes_ms"] >= t384["bound_ms"] * (1 - 1e-9)
                        else "operations")
    fused_block_attention.launches, fused_block_attention.chunked_launches = counts
    print(f"[block-attn] fused_block_attention over the {px}-px bs{B384} forward's {layers} "
          f"layers (bf16, N {t.shape[1]}, the chunked route): kernels {t384['ms']:.3f} ms, plain "
          f"{t384['plain_ms']:.3f}, bound {t384['bound_ms']:.3f} ({t384['bound_by']}) [{card}]")
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_abs, worst={str(k)[6:]: v for k, v in worst.items()},
                vs_split=vs_split, cases=n, launches=launches, forward_rel=rel,
                chunked=chunked, time_384=t384)


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
    fused_block_attention at each of the 48 deployed layers at B 256 (bf16
    with fast_math, and f32 with strict numerics, on the layer's own input)
    beside its plain version, its bound at the dtype's peak and the split
    sequence it replaces (attention_half with the attention kernel). Timing
    launches are not the main path's: the counts are restored."""
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
    blocks = {}
    for dtype, fast in ((torch.bfloat16, True), (torch.float32, False)):
        block = {"ms": 0.0, "plain_ms": 0.0, "split_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0}
        half = dict(dtype=dtype, fast_math=fast)
        for cm in cms:
            t = embed_patches(cm, x, patch_size=16, dtype=dtype)
            for lp in cm.layers:
                args, kw = _block_args(lp, t), dict(num_heads=lp.num_heads, eps=cm.eps)
                block["ms"] += _time_ms(lambda: fused_block_attention(*args, **kw), iters=3,
                                        warmup=1)
                block["plain_ms"] += _time_ms(lambda: reference_block_attention(*args, **kw),
                                              iters=3, warmup=1)
                block["split_ms"] += _time_ms(lambda: attention_half(lp, t, eps=cm.eps, **half),
                                              iters=3, warmup=1)
                bound, bytes_ms = _block_bound(256, t.shape[-1], lp.num_heads * DH, dtype)
                block["bound_ms"] += bound
                block["bytes_ms"] += bytes_ms
                t = mlp_half(lp, attention_half(lp, t, eps=cm.eps, **half), eps=cm.eps, **half)
        block["bound_by"] = ("bytes" if block["bytes_ms"] >= block["bound_ms"] * (1 - 1e-9)
                             else "operations")
        blocks[dtype] = block
        peak = " at 165 TFLOP/s (3xTF32)" if dtype == torch.float32 else ""
        print(f"[int8-time] fused_block_attention over one bs256 forward's "
              f"{sum(len(cm.layers) for cm in cms)} layers ({str(dtype)[6:]}): kernel "
              f"{block['ms']:.3f} ms, plain {block['plain_ms']:.3f}, the split sequence it "
              f"replaces {block['split_ms']:.3f}, bound {block['bound_ms']:.3f} "
              f"({block['bound_by']}{peak}) [{card}]")
    fused_attention.launches, fused_int8_matmul.launches, fused_block_attention.launches = counts
    return dict(forward=e2e, int8_per_shape={f"{k}x{n}": r for (k, n), r in per_shape.items()},
                int8_forward=int8_fwd, block_forward=blocks[torch.bfloat16],
                block_forward_f32=blocks[torch.float32])


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
# (N, head width, heads, B) past the short kernels: dh 64 at kh 1, 6 and 12;
# dh 32 and 128 past 256 keys, and dh 128 at N 209-256, where its bf16
# monolithic block does not fit and every backward takes the long path
# (use_long_path); both dtypes (f32 takes the long path at every N)
LONG_CASES = [(n, DH, kh, B) for n in LONG_N for kh, B in ((1, 3), (6, 2), (12, 1))]
LONG_CASES_BF16 = ([(n, dh, kh, 2) for n in LONG_N for dh, kh in ((32, 12), (128, 6))]
                   + [(n, 128, 6, 2) for n in (209, 240, 256)])


def _split_plain(x, g, kh):
    return torch.cat([reference_attention_bwd_dqdk(x, g, kh),
                      reference_attention_bwd_dv(x, g, kh)], dim=-1)


BWD_WRAPPERS = {  # name -> (the kernel's wrapper, its plain version)
    "attention_bwd": (attention_bwd, reference_attention_bwd),
    "attention_bwd_split": (attention_bwd_split, _split_plain),
    "attention_bwd_dqdk": (attention_bwd_dqdk, reference_attention_bwd_dqdk),
    "attention_bwd_dv": (attention_bwd_dv, reference_attention_bwd_dv),
}


def _hold_bwd(x: torch.Tensor, g: torch.Tensor, kh: int, where: str, max_abs: dict) -> float:
    """Each of BWD_WRAPPERS on (x, g) against its plain version: dq, dk and
    dv each within TOL, a repeat bit for bit, and the split pair, dq/dk and
    dv equal to the monolithic backward bit for bit. The max-abs error of
    each wrapper goes into max_abs (f32 under "<name> f32"). Returns the
    worst rel err."""
    C, dtype = g.shape[-1], x.dtype
    got, worst = {}, 0.0
    for name, (fn, plain) in BWD_WRAPPERS.items():
        got[name], again = fn(x, g, kh), fn(x, g, kh)
        torch.cuda.synchronize()
        want = plain(x, g, kh)
        errs = [_rel(got[name][..., i * C:(i + 1) * C], want[..., i * C:(i + 1) * C])
                for i in range(got[name].shape[-1] // C)]
        if max(errs) > TOL[dtype] or not torch.equal(got[name], again):
            raise AssertionError(f"[bwd-long] {name} {where}: rel err {errs} (tol "
                                 f"{TOL[dtype]:.0e}), repeat identical "
                                 f"{torch.equal(got[name], again)}")
        key = name if dtype == torch.bfloat16 else f"{name} f32"
        max_abs[key] = max(max_abs.get(key, 0.0),
                           float((got[name].float() - want.float()).abs().max()))
        worst = max(worst, max(errs))
        del want, again
    mono = got["attention_bwd"]
    if not (torch.equal(got["attention_bwd_split"], mono)
            and torch.equal(got["attention_bwd_dqdk"], mono[..., :2 * C])
            and torch.equal(got["attention_bwd_dv"], mono[..., 2 * C:])):
        raise AssertionError(f"[bwd-long] {where}: the split pair differs from the monolithic "
                             "backward in its bits")
    return worst


def phase_bwd_long(card: str) -> dict:
    """The four backward wrappers past 256 keys, where they walk key chunks
    (csrc/attention_bwd_long.cu): each vs its plain version, dq, dk and dv
    each on its own, at LONG_CASES in both dtypes and LONG_CASES_BF16 at
    bf16 (with the forward past 256 keys there), every call repeated bit for
    bit and the split pair, dq/dk and dv equal to the monolithic backward
    bit for bit; then, at B 64, kh 6, N 578 in both dtypes, the same checks
    and one launch of each timed beside its plain version, its bound and
    SDPA's backward on the same inputs. These launches are not the main path's: the counts are
    restored. Returns the largest bf16 max-abs error of each wrapper and the
    times."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    before = _counts()
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    max_abs = dict.fromkeys(list(BWD_WRAPPERS) + ["fwd"], 0.0)
    n_cases = 0
    cases = [(dtype, c) for dtype in (torch.bfloat16, torch.float32)
             for c in LONG_CASES + LONG_CASES_BF16]
    for dtype, (n, dh, kh, B) in cases:
        C = kh * dh
        x = torch.randn((B, n, 3 * C), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, n, C), generator=gen, device="cuda").to(dtype)
        worst[dtype] = max(worst[dtype], _hold_bwd(x, g, kh, f"{dtype} N={n} dh={dh} kh={kh} "
                                                         f"B={B}", max_abs))
        n_cases += len(BWD_WRAPPERS)
        if n > 256 or dtype == torch.float32:
            fwd, fwd2 = fused_attention(x, num_heads=kh), fused_attention(x, num_heads=kh)
            torch.cuda.synchronize()
            want = reference_attention(x, num_heads=kh)
            err = _rel(fwd, want)
            if err > TOL[dtype] or not torch.equal(fwd, fwd2):
                raise AssertionError(f"[bwd-long] fused_attention {dtype} N={n} dh={dh} kh={kh}: "
                                     f"rel err {err:.3e}, repeat identical "
                                     f"{torch.equal(fwd, fwd2)}")
            key = "fwd" if dtype == torch.bfloat16 else "fwd f32"
            max_abs[key] = max(max_abs.get(key, 0.0),
                               float((fwd.float() - want.float()).abs().max()))
            worst[dtype] = max(worst[dtype], err)
        del x, g
    print(f"[bwd-long] attention_bwd, attention_bwd_split, attention_bwd_dqdk, attention_bwd_dv "
          f"past 256 keys vs plain: {n_cases} cases pass (N {list(LONG_N)} at dh 64, kh "
          f"1/6/12, dh 32 (kh 12) and 128 (kh 6) at those N and dh 128 at N 209/240/256, bf16 "
          f"and f32, with fused_attention; dq, dk, dv each); worst rel err bf16 "
          f"{worst[torch.bfloat16]:.3e} (tol 2e-2), f32 {worst[torch.float32]:.3e} (tol 1e-4, "
          f"3xTF32 expected within ~1e-6); max abs err "
          f"{', '.join(f'{k} {v:.3e}' for k, v in max_abs.items())} (bf16 unless f32); "
          f"repeat launches "
          f"bit-identical; the split pair, dq/dk and dv equal to the monolithic backward bit "
          f"for bit at every case")

    B, kh, n = ENS_B, 6, LONG_TIME_N
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for dtype, peak in ((torch.bfloat16, BF16_FLOPS), (torch.float32, TF32X3_FLOPS)):
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
        worst[dtype] = max(worst[dtype], _hold_bwd(x, g, kh, f"{dtype} N={n} dh={DH} kh={kh} "
                                                         f"B={B}", max_abs))
        for name, (fn, plain) in BWD_WRAPPERS.items():
            r = dict(ms=_time_ms(lambda: fn(x, g, kh), iters=5, warmup=1),
                     plain_ms=_time_ms(lambda: plain(x, g, kh), iters=3, warmup=1),
                     library_ms=library, bound_ms=bounds[name][0],
                     bound_by="bytes" if bounds[name][1] else "operations")
            times[f"{name} {str(dtype)[6:]}"] = r
            peak_note = " at 165 TFLOP/s (3xTF32)" if dtype == torch.float32 else ""
            print(f"[bwd-long] {name} {str(dtype)[6:]} B={B} N={n} kh={kh}: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA backward "
                  f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}"
                  f"{peak_note}) [{card}]")
        del x, g, q, k, v, out
    print(f"[bwd-long] the timed shape B={B} N={n} kh={kh} dh {DH}: each wrapper within tol of "
          f"its plain version (dq, dk, dv each), repeats and split == monolithic bit for bit; "
          f"worst rel err bf16 {worst[torch.bfloat16]:.3e}, f32 {worst[torch.float32]:.3e} "
          f"(with the cases above)")
    _set_counts(before)
    torch.cuda.empty_cache()
    return dict(max_abs=max_abs, worst={str(k)[6:]: v for k, v in worst.items()},
                cases=n_cases, times=times)


# the f32 kernels far past the lengths the main paths use: the error of
# their long sums against N (3xTF32, each k8 step of p . v, dq, dk and dv
# added to its accumulator in f32), dh 64 and 128 (attn_long_tf32 and the
# 3xTF32 pair) and 192 (the wide kernels), B 1, kh 2
F32_LONG_N = (198, 578, 1026, 2050, 4098)
F32_LONG_DH = (64, 128, 192)


def phase_f32_long(card: str) -> dict:
    """The f32 forward, the monolithic backward and the split pair at
    F32_LONG_N and F32_LONG_DH (B 1, kh 2), each against its plain version
    within 1e-4 (max-abs over max-ref; dq, dk and dv each on its own),
    repeats bit for bit and the split pair equal to the monolithic backward
    bit for bit. Prints the worst rel err of each N. Launches here are
    checks, not counted. Returns {N: worst rel err}."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    before = _counts()
    kh, B, dtype = 2, 1, torch.float32
    by_n, cells = {}, {}
    for n in F32_LONG_N:
        for dh in F32_LONG_DH:
            C = kh * dh
            x = torch.randn((B, n, 3 * C), generator=gen, device="cuda")
            g = torch.randn((B, n, C), generator=gen, device="cuda")
            fwd, fwd2 = fused_attention(x, num_heads=kh), fused_attention(x, num_heads=kh)
            mono, mono2 = attention_bwd(x, g, kh), attention_bwd(x, g, kh)
            split = attention_bwd_split(x, g, kh)
            torch.cuda.synchronize()
            errs = [_rel(fwd, reference_attention(x, num_heads=kh))]
            errs += _bwd_errs(mono, reference_attention_bwd(x, g, kh), C)
            where = f"[f32-long] N {n} dh {dh} kh {kh} B {B}"
            if max(errs) > TOL[dtype]:
                raise AssertionError(f"{where}: rel err o, dq, dk, dv {errs} > 1e-4")
            if not (torch.equal(fwd, fwd2) and torch.equal(mono, mono2)
                    and torch.equal(split, mono)):
                raise AssertionError(f"{where}: a repeat, or the split pair against the "
                                     "monolithic backward, differs in its bits")
            cells[f"N {n} dh {dh}"] = errs
            by_n[n] = max(by_n.get(n, 0.0), max(errs))
            del x, g, fwd, fwd2, mono, mono2, split
            torch.cuda.empty_cache()
    _set_counts(before)
    print(f"[f32-long] f32 forward, monolithic backward and split pair at N {list(F32_LONG_N)}, "
          f"dh {list(F32_LONG_DH)}, kh {kh}, B {B} vs their plain versions: every case within "
          f"1e-4 (o, dq, dk, dv each), repeats and split == monolithic bit for bit; worst rel "
          f"err by N: {', '.join(f'N {n} {e:.3e}' for n, e in by_n.items())} [{card}]")
    print(f"[f32-long] rel err o, dq, dk, dv by case: "
          f"{', '.join(f'{k} ' + '/'.join(f'{e:.2e}' for e in v) for k, v in cells.items())}")
    return dict(worst_by_n=by_n, cells=cells)


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


def _train_step(model, layout=None):
    mix = MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, prob=1.0, switch_prob=0.5,
                      label_smoothing=0.1, num_classes=TRAIN_CLASSES)
    return make_stage2_step(model, None, mixup=mix, smoothing=0.1, distillation_type="none",
                            layout=layout)


def _step_grads(model, batch, seed: int, layout=None):
    """Loss and gradients of one stage-2 step from a fresh state: the
    gradients the optimizer receives (averaged over the data ranks under a
    layout)."""
    state = _train_state(model)
    seen = {}
    update = state.tx.update
    state.tx.update = lambda g, st, p: (seen.update(g), update(g, st, p))[1]
    _, metrics = _train_step(model, layout)(state, None, *batch,
                                            torch.Generator().manual_seed(seed))
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
    per_step, gelu_per_step, losses = [], [], []

    def step_fn(use_kernel):
        def fn(state, images, labels, generator):
            f0, b0 = fused_attention.launches, attention_bwd.launches
            g0, gb0 = gelu.fused_gelu.launches, gelu.fused_gelu_bwd.launches
            state, metrics = steps[use_kernel](state, None, images, labels, generator)
            if use_kernel:
                per_step.append((fused_attention.launches - f0, attention_bwd.launches - b0))
            # both models' steps run the GELU kernels (forward, recompute, backward)
            gelu_per_step.append((gelu.fused_gelu.launches - g0,
                                  gelu.fused_gelu_bwd.launches - gb0))
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
    if len(gelu_per_step) != 2 * len(per_step) or any(c != (24, 12) for c in gelu_per_step):
        raise AssertionError(f"per-step GELU kernel launches {gelu_per_step}, expected (24, 12) "
                             f"each")
    launches.update(fused_gelu=24 * len(gelu_per_step), fused_gelu_bwd=12 * len(gelu_per_step))
    host_losses = [float(l) for l in losses]
    if not all(np.isfinite(host_losses)):
        raise AssertionError(f"non-finite training loss: {host_losses}")
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"[train] stage-2 step, dedeit bs{TRAIN_B}, bf16, remat, mixup/cutmix, AdamW + EMA: "
          f"{ms[True]:.3f} ms/step = {TRAIN_B / ms[True] * 1e3:.1f} img/s with the kernels; "
          f"{ms[False]:.3f} ms/step = {TRAIN_B / ms[False] * 1e3:.1f} img/s with the plain "
          f"attention; turns (ms/step) {runs}; {len(per_step)} kernel steps, each 24 forward "
          f"+ 12 backward launches; {len(gelu_per_step)} steps, each 24 + 12 GELU launches; "
          f"{len(host_losses)} losses all finite "
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


def _wide_counts() -> tuple:
    """Each wrapper's launches past head width 128 (`wide_launches`)."""
    return tuple(k.wide_launches for k in _KERNELS)


def _set_wide_counts(counts) -> None:
    for k, c in zip(_KERNELS, counts):
        k.wide_launches = c


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


def _ens_parts(B: int) -> dict:
    """The stage-5 configuration: four full-width dedeit divisions (drop_path
    0.1, bf16 compute, f32 parameters, full remat), gated by the deployed
    shrink policies; the deit-base teacher; EnsMLP(teacher 768, 100 classes,
    deit); hard distillation (alpha 0.5, mse tokens), mixup 0.8 / cutmix 1.0,
    smoothing 0.1; AdamW lr 3e-4, weight decay 0.05, EMA on both states; a
    batch of B images from a seed."""
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
    images = torch.randn((B, px, px, 3), generator=gen, device="cuda").bfloat16()
    labels = torch.randint(0, ENS_CLASSES, (B,), generator=gen, device="cuda")
    return dict(backbone=backbone, stacked=stacked, teacher=teacher, ens=ens,
                gates=_division_gates(), batch=(images, labels))


def _ens_setup(card: str) -> dict:
    """_ens_parts at bs 64, with the teacher's launches and logits checked
    and the expected launches per step."""
    parts = _ens_parts(ENS_B)
    backbone, teacher, ens = parts["backbone"], parts["teacher"], parts["ens"]
    images, labels = parts["batch"]
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
    gates = parts["gates"]
    # per step: each division's layers forward and again in the remat
    # re-forward, the teacher's once; one backward (or dv + dqdk) a layer
    fwd, bwd = 2 * ENS_D * L + Lt, ENS_D * L
    expect = {"monolithic": (fwd, bwd, 0, 0), "split": (fwd, 0, bwd, bwd), "plain": (0, 0, 0, 0)}
    print(f"[ens-train] stage-5 configuration: {ENS_D} dedeit divisions (kept heads per layer "
          f"{[[int(h) for h in g.sum(-1).tolist()] for g in gates.head]}), deit-base teacher "
          f"({Lt} launches at kh {teacher.cfg.num_heads} per forward), EnsMLP "
          f"{ENS_D}x{backbone.cfg.embed_dim} -> {teacher.cfg.embed_dim} -> {ENS_CLASSES}, "
          f"bs{ENS_B}; launches per step (fused, bwd, dv, dqdk) {expect} [{card}]")
    return dict(parts, expect=expect, teacher_check=teacher_check)


def _ens_states(setup: dict, layout=None):
    """Fresh backbone and head states (and the step over them, under
    `layout`) from the setup's initial parameters."""
    cfg = OptimConfig(lr=3e-4, weight_decay=0.05, epochs=100)
    stacked = {k: torch.nn.Parameter(v.detach().clone()) for k, v in setup["stacked"].items()}
    ens = copy.deepcopy(setup["ens"])
    bb = TrainState.create(stacked, make_optimizer(cfg, 100), use_ema=True)
    en = TrainState.create(ens, make_optimizer(cfg, 100), use_ema=True)
    step = make_ensemble_train_step(setup["backbone"], ens, setup["teacher"],
                                    mixup=_mixup(ENS_CLASSES), smoothing=0.1,
                                    distillation_type="hard", distillation_alpha=0.5,
                                    token_loss_type="mse", layout=layout)
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
    the same function) and the bound; and in f32 (_heads_f32_times). Launches
    here are checks, not counted."""
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
                t = torch.randn((B, N, 384), generator=gen, device="cuda").to(dtype)
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
        f32_t = _heads_f32_times(gen, dh, kh, C)
        res[dh] = dict(kh=kh, block_kh=kb, cases=n_cases, fwd=fwd_t, bwd=bwd_t, block=blk_t,
                       f32=f32_t,
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
        fw, bw = f32_t["fwd"], f32_t["bwd"]
        print(f"[heads] dh {dh} times (f32, 3xTF32): forward B256 kh{kh} {fw['ms']:.4f} ms "
              f"(plain {fw['plain_ms']:.4f}, SDPA {fw['library_ms']:.4f}, bound "
              f"{fw['bound_ms']:.4f} {fw['bound_by']} at 165 TFLOP/s, "
              f"{fw['bound_ms_67']:.4f} at 67); backward B64 kh{kh} {bw['ms']:.4f} ms (plain "
              f"{bw['plain_ms']:.4f}, SDPA backward {bw['library_ms']:.4f}, bound "
              f"{bw['bound_ms']:.4f} {bw['bound_by']}, {bw['bound_ms_67']:.4f} at 67); split "
              f"pair {bw['split_ms']:.4f} ms = dv {bw['dv_ms']:.4f} + dq/dk {bw['dqdk_ms']:.4f} "
              f"(plain {bw['dv_plain_ms']:.4f}, {bw['dqdk_plain_ms']:.4f}; bounds "
              f"{bw['dv_bound_ms']:.4f}, {bw['dqdk_bound_ms']:.4f}) [{card}]")
    _set_counts(before)
    fused_block_attention.launches = before_block
    return res


def _heads_f32_times(gen, dh: int, kh: int, C: int) -> dict:
    """[heads]' f32 times at N 198: the forward at B 256, the monolithic
    backward and the split pair (and each half) at B 64, beside the plain
    versions, SDPA's f32 forward and its backward through autograd, and the
    bounds at 3xTF32's 165 TFLOP/s (and the CUDA cores' 67). Each timed call
    is first held against its plain version (_hold_timed)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32 = torch.float32
    x = torch.randn((256, N, 3 * C), generator=gen, device="cuda")
    q, k, v = _sdpa_qkv(x, kh)
    _hold_timed(f"[heads] f32 forward dh {dh} B 256", lambda: fused_attention(x, num_heads=kh),
                lambda: reference_attention(x, num_heads=kh), C, f32)
    fb, fby = _attn_bound(256, N, kh, dh, 4, TF32X3_FLOPS)
    fwd = dict(ms=_time_ms(lambda: fused_attention(x, num_heads=kh)),
               plain_ms=_time_ms(lambda: reference_attention(x, num_heads=kh), iters=5),
               library_ms=_time_ms(lambda: sdpa(q, k, v)), bound_ms=fb, bound_by=fby,
               bound_ms_67=_attn_bound(256, N, kh, dh, 4, F32_FLOPS)[0])
    del x, q, k, v
    x = torch.randn((64, N, 3 * C), generator=gen, device="cuda")
    g = torch.randn((64, N, C), generator=gen, device="cuda")
    q, k, v = (t.requires_grad_() for t in _sdpa_qkv(x, kh))
    out = sdpa(q, k, v)
    gh = g.view(64, N, kh, dh).transpose(1, 2)
    for name, fn, plain in (("bwd", attention_bwd, reference_attention_bwd),
                            ("split", attention_bwd_split, _split_plain)):
        _hold_timed(f"[heads] f32 {name} dh {dh} B 64", lambda: fn(x, g, kh),
                    lambda: plain(x, g, kh), C, f32)
    bb, bby = _attn_bound(64, N, kh, dh, 4, TF32X3_FLOPS, bwd=True)
    sb = _split_bounds(64, C // DH, 4, TF32X3_FLOPS)
    bwd = dict(ms=_time_ms(lambda: attention_bwd(x, g, kh)),
               plain_ms=_time_ms(lambda: reference_attention_bwd(x, g, kh), iters=5),
               library_ms=_time_ms(lambda: torch.autograd.grad(out, (q, k, v), gh,
                                                               retain_graph=True)),
               bound_ms=bb, bound_by=bby,
               bound_ms_67=_attn_bound(64, N, kh, dh, 4, F32_FLOPS, bwd=True)[0],
               split_ms=_time_ms(lambda: attention_bwd_split(x, g, kh)),
               dv_ms=_time_ms(lambda: attention_bwd_dv(x, g, kh)),
               dqdk_ms=_time_ms(lambda: attention_bwd_dqdk(x, g, kh)),
               dv_plain_ms=_time_ms(lambda: reference_attention_bwd_dv(x, g, kh), iters=5),
               dqdk_plain_ms=_time_ms(lambda: reference_attention_bwd_dqdk(x, g, kh), iters=5),
               dv_bound_ms=sb["dv"][0], dqdk_bound_ms=sb["dqdk"][0])
    del x, g, q, k, v, out
    return dict(fwd=fwd, bwd=bwd)


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
                t = torch.randn((B, N, 384), generator=gen, device="cuda").to(dtype)
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
    _set_counts(before)
    fused_block_attention.launches = before_block
    print(f"[heads-pad] head widths {list(PAD_DH_KH)} (zero-padded to 32/64/128, the true "
          f"width's scale): {n_cases} cases (B 1/7/64, bf16 and f32) of the forward, the "
          f"monolithic backward, the split pair and the block half vs their plain versions "
          f"pass; worst rel err bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 "
          f"{worst[torch.float32]:.3e} (tol 1e-4); repeats bit for bit; split == monolithic "
          f"bit for bit [{card}]")
    return dict(cases=n_cases, max_abs=max_abs,
                worst_rel={"bf16": worst[torch.bfloat16], "f32": worst[torch.float32]})


# ---- every sequence length and head width: the key-chunked paths

# (N, head width, heads): dedeit's dh 64 at 272, 384, 464 and 512 px (N 291,
# 578, 843, 1026), dh 32 and 128 at 384 px, and heads past 128 (dh 192: embed
# 768 at 4 heads; dh 256: 768 at 3; dh 160 and 320, 640 at 4 and 2, which the
# wrappers zero-pad to 192 and run in three slabs) at 224 and 384 px
ATTN_LONG_CASES = ([(n, 64, 6) for n in (291, 578, 843, 1026)] + [(578, 32, 12), (578, 128, 6)]
                   + [(n, dh, kh) for n in (198, 578)
                      for dh, kh in ((192, 4), (256, 3), (160, 4), (320, 2))])
BLOCK_LONG_CASES = [(291, 64, 6), (578, 64, 6), (198, 192, 2), (578, 192, 2)]  # C 384
ATTN_LONG_B = 2
ATTN_LONG_TIME = (64, 578, 6)  # B, N, kh of the timed forward (dh 64)
# B, N, kh, dh of the timed paths past head width 128
ATTN_WIDE_TIME = ((64, 578, 4, 192), (64, 578, 3, 256))
# B, N, kh, head width, C of the block half's timed chunked route: dedeit at
# 384 px, and heads of 192 at C 768
ATTN_BLOCK_TIME = ((16, 578, 6, 64, 384), (16, 578, 4, 192, 768))


def _attn_bound(B: int, n: int, kh: int, dh: int, elem: int, flops_peak: float,
                bwd: bool = False):
    """Least time of one forward (qkv read, out written; 4 B N^2 C
    operations) or backward (qkv and g read, dqkv written; 10 B N^2 C)."""
    C = kh * dh
    nbytes = (7 if bwd else 4) * B * n * C * elem
    flops = (10 if bwd else 4) * B * n * n * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _note(worst: dict, max_abs: dict, key: str, dtype, err: float, mabs: float) -> None:
    worst[dtype] = max(worst[dtype], err)
    key = key if dtype == torch.bfloat16 else f"{key} f32"
    max_abs[key] = max(max_abs.get(key, 0.0), mabs)


def _hold_timed(where: str, fn, plain, C: int, dtype) -> tuple:
    """A timed call held against its plain version on the same inputs: each
    C-wide slice of the output (o; or dq, dk and dv) within TOL, and a repeat
    bit for bit. Returns (the worst rel err, the max-abs err, the output)."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    want = plain()
    errs = [_rel(got[..., i * C:(i + 1) * C], want[..., i * C:(i + 1) * C])
            for i in range(got.shape[-1] // C)]
    if max(errs) > TOL[dtype] or not torch.equal(got, again):
        tag = "" if where.startswith("[") else "[attn-long] "
        raise AssertionError(f"{tag}{where}: rel err {errs} (tol {TOL[dtype]:.0e}), "
                             f"repeat identical {torch.equal(got, again)}")
    return max(errs), float((got.float() - want.float()).abs().max()), got


def phase_attn_long(card: str) -> dict:
    """The attention kernels at every sequence length and head width the JAX
    kernel takes: fused_attention and make_trainable_attention (forward and
    backward, monolithic and split) at ATTN_LONG_CASES, the block half at
    BLOCK_LONG_CASES, bf16 and f32, each against its plain version (2e-2
    bf16, 1e-4 f32, max-abs over max-ref; dq, dk and dv each on its own),
    every repeat bit for bit and the split backward equal to the monolithic
    one bit for bit; the design each forward took (attention_path). Then the
    chunked forwards timed at B 64, N 578, kh 6 beside the plain version and
    SDPA, the paths past head width 128 at B 64, N 578, dh 192, and the block
    half's chunked route at B 16, N 578 (C 384, kh 6; C 768, four heads of
    192); each timed call is first held
    against its plain version on the same inputs (_hold_timed). Launches here
    are checks, not counted."""
    from devit_tpu_torch.kernels.attention import attention_path

    gen = torch.Generator(device="cuda").manual_seed(43)
    before, before_block = _counts(), fused_block_attention.launches
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    max_abs = {"fwd": 0.0, "bwd": 0.0, "dv": 0.0, "dqdk": 0.0, "block": 0.0}
    paths, n_cases = {}, 0
    B = ATTN_LONG_B
    for dtype in (torch.bfloat16, torch.float32):
        for n, dh, kh in ATTN_LONG_CASES:
            C = kh * dh
            x = torch.randn((B, n, 3 * C), generator=gen, device="cuda").to(dtype)
            g = torch.randn((B, n, C), generator=gen, device="cuda").to(dtype)
            fwd, fwd2 = fused_attention(x, num_heads=kh), fused_attention(x, num_heads=kh)
            grads = {}
            for mode in ("monolithic", "split"):
                fn = make_trainable_attention(kh, mode)
                xs = x.detach().requires_grad_()
                out = fn(xs)
                grads[mode] = torch.autograd.grad(out, xs, g)[0]
                if not torch.equal(out, fwd):
                    raise AssertionError(f"[attn-long] N {n} dh {dh} {dtype}: the trainable "
                                         f"forward ({mode}) differs from fused_attention")
            again = attention_bwd(x, g, kh)
            torch.cuda.synchronize()
            want_f = reference_attention(x, num_heads=kh)
            want_b = reference_attention_bwd(x, g, kh)
            errs = {"fwd": [_rel(fwd, want_f)],
                    "bwd": _bwd_errs(grads["monolithic"], want_b, C),
                    "split": _bwd_errs(grads["split"], want_b, C)}
            bad = {k: v for k, v in errs.items() if max(v) > TOL[dtype]}
            if bad:
                raise AssertionError(f"[attn-long] N {n} dh {dh} kh {kh} {dtype}: rel err {bad} "
                                     f"> {TOL[dtype]:.0e}")
            if not (torch.equal(fwd, fwd2) and torch.equal(grads["monolithic"], again)
                    and torch.equal(grads["split"], grads["monolithic"])):
                raise AssertionError(f"[attn-long] N {n} dh {dh} {dtype}: a repeat, or the "
                                     "split backward against the monolithic one, differs in "
                                     "its bits")
            d = (grads["monolithic"].float() - want_b.float()).abs()
            f = (fwd.float() - want_f.float()).abs().max()
            for key, v in (("fwd", f), ("bwd", d.max()), ("dqdk", d[..., :2 * C].max()),
                           ("dv", d[..., 2 * C:].max())):
                _note(worst, max_abs, key, dtype, 0.0, float(v))
            if dh > 128:  # the wide kernels' own entries in the kernels line
                _note(worst, max_abs, "wide fwd", dtype, 0.0, float(f))
                _note(worst, max_abs, "wide bwd", dtype, 0.0, float(d.max()))
            worst[dtype] = max(worst[dtype], max(max(v) for v in errs.values()))
            paths[f"N {n} dh {dh} {str(dtype)[6:]}"] = attention_path(n, dh, dtype)
            n_cases += 1
            del x, g, grads, want_b
        for n, dh, kh in BLOCK_LONG_CASES:
            t = torch.randn((B, n, 384), generator=gen, device="cuda").to(dtype)
            w = _block_weights(gen, 384, kh * dh, dtype)
            blk, blk2 = (fused_block_attention(t, **w, num_heads=kh),
                         fused_block_attention(t, **w, num_heads=kh))
            torch.cuda.synchronize()
            want = reference_block_attention(t, **w, num_heads=kh)
            err = _rel(blk, want)
            if err > TOL[dtype] or not torch.equal(blk, blk2):
                raise AssertionError(f"[attn-long] block half N {n} dh {dh} {dtype}: rel err "
                                     f"{err:.3e} (tol {TOL[dtype]:.0e}), repeat identical "
                                     f"{torch.equal(blk, blk2)}")
            _note(worst, max_abs, "block", dtype, err,
                  float((blk.float() - want.float()).abs().max()))
            n_cases += 1
    print(f"[attn-long] {n_cases} cases pass: fused_attention and make_trainable_attention "
          f"(monolithic and split) at (N, dh, kh) {ATTN_LONG_CASES}, the block half at "
          f"{BLOCK_LONG_CASES}, B {B}, bf16 and f32, vs their plain versions; worst rel err "
          f"bf16 {worst[torch.bfloat16]:.3e} (tol 2e-2), f32 {worst[torch.float32]:.3e} (tol "
          f"1e-4); dq, dk, dv each; repeats and split == monolithic bit for bit; max abs err "
          f"{', '.join(f'{k} {v:.3e}' for k, v in max_abs.items())} (bf16 unless f32) [{card}]")
    print(f"[attn-long] forward designs: {paths}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    Bt, n, kh = ATTN_LONG_TIME
    for dtype, peak in ((torch.bfloat16, BF16_FLOPS), (torch.float32, TF32X3_FLOPS)):
        x = torch.randn((Bt, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
        q, k, v = _sdpa_qkv(x, kh)
        bound, by = _attn_bound(Bt, n, kh, DH, x.element_size(), peak)
        err, mabs, _ = _hold_timed(f"fused_attention {dtype} B={Bt} N={n} kh={kh}",
                                   lambda: fused_attention(x, num_heads=kh),
                                   lambda: reference_attention(x, num_heads=kh), kh * DH, dtype)
        _note(worst, max_abs, "fwd", dtype, err, mabs)
        r = dict(ms=_time_ms(lambda: fused_attention(x, num_heads=kh), iters=10),
                 plain_ms=_time_ms(lambda: reference_attention(x, num_heads=kh), iters=5),
                 library_ms=_time_ms(lambda: sdpa(q, k, v), iters=10), bound_ms=bound,
                 bound_by=by, path=attention_path(n, DH, dtype))
        times[f"fwd {str(dtype)[6:]}"] = r
        print(f"[attn-long] fused_attention {str(dtype)[6:]} B={Bt} N={n} kh={kh} dh {DH} "
              f"({r['path']}): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA "
              f"{r['library_ms']:.4f}, bound {bound:.4f} ({by}) [{card}]")
        del x, q, k, v
    for (Bt, n, kh, dh), dtype in itertools.product(ATTN_WIDE_TIME,
                                                    (torch.bfloat16, torch.float32)):
        C = kh * dh
        peak = BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS
        x = torch.randn((Bt, n, 3 * C), generator=gen, device="cuda").to(dtype)
        g = torch.randn((Bt, n, C), generator=gen, device="cuda").to(dtype)
        q, k, v = (t.requires_grad_() for t in _sdpa_qkv(x, kh))
        out = sdpa(q, k, v)
        gh = g.view(Bt, n, kh, dh).transpose(1, 2)
        tag, path = str(dtype)[6:], attention_path(n, dh, dtype)
        fb, fby = _attn_bound(Bt, n, kh, dh, x.element_size(), peak)
        bb, bby = _attn_bound(Bt, n, kh, dh, x.element_size(), peak, bwd=True)
        bwd_lib = _time_ms(lambda: torch.autograd.grad(out, (q, k, v), gh, retain_graph=True),
                           iters=3, warmup=1)
        got = {}
        for name, fn, plain, lib, bound, by in (
                ("fwd", lambda: fused_attention(x, num_heads=kh),
                 lambda: reference_attention(x, num_heads=kh),
                 lambda: sdpa(q.detach(), k.detach(), v.detach()), fb, fby),
                ("bwd", lambda: attention_bwd(x, g, kh),
                 lambda: reference_attention_bwd(x, g, kh), None, bb, bby),
                ("split", lambda: attention_bwd_split(x, g, kh),
                 lambda: _split_plain(x, g, kh), None, bb, bby)):
            err, mabs, got[name] = _hold_timed(f"dh{dh} {name} {tag} B={Bt} N={n} kh={kh}", fn,
                                               plain, C, dtype)
            _note(worst, max_abs, "wide fwd" if name == "fwd" else "wide bwd", dtype, err, mabs)
            r = dict(ms=_time_ms(fn, iters=5, warmup=1),
                     plain_ms=_time_ms(plain, iters=2, warmup=1),
                     library_ms=_time_ms(lib, iters=3, warmup=1) if lib else bwd_lib,
                     bound_ms=bound, bound_by=by, path=path)
            if dtype == torch.float32:  # the bound at f32 outside the tensor cores, beside
                r["bound_f32_cores_ms"] = _attn_bound(Bt, n, kh, dh, 4, F32_FLOPS,
                                                      bwd=name != "fwd")[0]
            times[f"dh{dh} {name} {tag}"] = r
            at = (f" at 165 TFLOP/s (3xTF32); {r['bound_f32_cores_ms']:.4f} at 67 (f32 "
                  f"CUDA cores)" if dtype == torch.float32 else "")
            print(f"[attn-long] {name} {tag} B={Bt} N={n} kh={kh} dh {dh} ({path}: head pieces, "
                  f"output slabs): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA "
                  f"{'backward ' if name != 'fwd' else ''}{r['library_ms']:.4f}, bound "
                  f"{bound:.4f} ({by}{at}) [{card}]")
        if not torch.equal(got["split"], got["bwd"]):
            raise AssertionError(f"[attn-long] dh{dh} {tag} B={Bt} N={n}: the split backward "
                                 "differs from the monolithic one in its bits")
        del x, g, q, k, v, out, got
    for (Bt, n, kh, dh, C), (dtype, peak) in itertools.product(
            ATTN_BLOCK_TIME, ((torch.bfloat16, BF16_FLOPS), (torch.float32, TF32X3_FLOPS))):
        K = kh * dh
        t = torch.randn((Bt, n, C), generator=gen, device="cuda").to(dtype)
        w = _block_weights(gen, C, K, dtype)
        err, mabs, _ = _hold_timed(f"fused_block_attention {dtype} B={Bt} N={n} C={C}",
                                   lambda: fused_block_attention(t, **w, num_heads=kh),
                                   lambda: reference_block_attention(t, **w, num_heads=kh), C,
                                   dtype)
        _note(worst, max_abs, "block", dtype, err, mabs)
        M, elem = Bt * n, t.element_size()
        t_bytes = elem * (2 * M * C + C * 4 * K) / HBM_BYTES_PER_S
        t_ops = (2 * M * C * 3 * K + 4 * Bt * n * n * K + 2 * M * K * C) / peak
        r = dict(ms=_time_ms(lambda: fused_block_attention(t, **w, num_heads=kh), iters=5),
                 plain_ms=_time_ms(lambda: reference_block_attention(t, **w, num_heads=kh),
                                   iters=3, warmup=1),
                 library_ms=None, bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
        tag = str(dtype)[6:]
        times[f"block {tag}" + (f" dh{dh}" if dh != DH else "")] = r
        at = " at 165 TFLOP/s (3xTF32)" if dtype == torch.float32 else ""
        print(f"[attn-long] fused_block_attention {tag} B={Bt} N={n} C={C} kh={kh} dh {dh} (the "
              f"chunked route: LayerNorm + qkv, the forward, proj): kernels {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} ({r['bound_by']}{at}) "
              f"[{card}]")
        del t, w
    print(f"[attn-long] every timed call within tol of its plain version on its inputs, "
          f"repeats (and the dh {[t[3] for t in ATTN_WIDE_TIME]} split == monolithic) bit for "
          f"bit; worst rel "
          f"err bf16 {worst[torch.bfloat16]:.3e}, f32 {worst[torch.float32]:.3e}; max abs err "
          f"{', '.join(f'{k} {v:.3e}' for k, v in max_abs.items())} (bf16 unless f32; with the "
          f"cases above)")
    _set_counts(before)
    fused_block_attention.launches = before_block
    torch.cuda.empty_cache()
    return dict(cases=n_cases, max_abs=max_abs, paths=paths, times=times,
                worst_rel={"bf16": worst[torch.bfloat16], "f32": worst[torch.float32]})


# ---- the devit-torch CLI: the pipeline, inspect, serve and the compact eval

# the pipeline at full width: dedeit (384 wide, 12 layers, 6 heads, dh 64,
# 224 px, N 198), 4 divisions of 25 classes, bs64, the CLI's defaults
# otherwise (bf16, RandAugment on the host, mixup/cutmix, EMA, repeated
# augmentation, the self-distill teacher). Cuts: 1 epoch (default 5), 1024
# synthetic images a split in place of CIFAR-100's 50,000 (2048 until the
# multi-rank phases joined the script)
CLI_MODEL = ["--model", "dedeit", "--dataset", "synthetic:100:1024:224", "--num_division", "4",
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


# ---- a stage-2 step at 384 px, the CCT family, the stage-5 resume fallback

S384_B = 16  # images of the 384-px step (N 578: 576 patches, cls and dist)
# the steady steps: bf16 at the kernels' timed B 64, f32 at B 16; steps a turn
S384_STEADY, S384_TURN_STEPS = ((torch.bfloat16, 64), (torch.float32, 16)), 3


def _model_384(dtype, use_kernel: bool):
    return create_vit("dedeit", img_size=384, num_classes=TRAIN_CLASSES, drop_path_rate=0.1,
                      dtype=dtype, use_kernel=use_kernel, use_remat=True, device="cuda",
                      generator=torch.Generator().manual_seed(0))


def _steady_384(gen, card: str, dtype, B: int) -> dict:
    """The 384-px stage-2 step of `dtype` at batch B through train_epoch
    (AdamW + EMA, mixup/cutmix), with the kernels and with the plain
    attention: one warm-up step each, then S384_TURN_STEPS steps a turn in
    turns (kernel, plain, plain, kernel), host clock ending in synchronize.
    The kernel steps are main-path launches (24 + 12 a step, asserted)."""
    images = torch.randn((B, 384, 384, 3), generator=gen, device="cuda").to(dtype)
    labels = torch.randint(0, TRAIN_CLASSES, (B,), generator=gen, device="cuda")
    batch = (images, labels)
    models = {k: _model_384(dtype, k) for k in (True, False)}
    states = {k: _train_state(m) for k, m in models.items()}
    steps = {k: _train_step(m) for k, m in models.items()}
    losses = []

    def step_fn(use_kernel):
        def fn(state, images, labels, generator):
            state, metrics = steps[use_kernel](state, None, images, labels, generator)
            losses.append(metrics["loss"])
            return state, metrics
        return fn

    def run(use_kernel, n_steps, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states[use_kernel], _, _ = train_epoch(
            step_fn(use_kernel), states[use_kernel], [batch] * n_steps,
            torch.Generator().manual_seed(seed), epoch=0, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    before = _counts()
    for use_kernel in (True, False):
        run(use_kernel, 1, seed=300)
    runs = {True: [], False: []}
    for i, use_kernel in enumerate((True, False, False, True)):
        runs[use_kernel].append(run(use_kernel, S384_TURN_STEPS, seed=310 + i))
    d = _delta(before)
    n_kernel_steps = 1 + 2 * S384_TURN_STEPS
    if d[:2] != (24 * n_kernel_steps, 12 * n_kernel_steps) or any(d[2:]):
        raise AssertionError(f"[stage2-384] steady steps: launches {d}, expected "
                             f"{(24 * n_kernel_steps, 12 * n_kernel_steps)} and no split launch")
    host_losses = [float(x) for x in losses]
    if not all(np.isfinite(host_losses)):
        raise AssertionError(f"[stage2-384] non-finite loss in the steady steps: {host_losses}")
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    print(f"[stage2-384] steady {str(dtype)[6:]} stage-2 step at 384 px (N 578), B {B}, AdamW "
          f"+ EMA, mixup/cutmix: {ms[True]:.3f} ms/step = {B / ms[True] * 1e3:.1f} "
          f"img/s with the kernels, {ms[False]:.3f} ms/step with the plain attention; turns "
          f"(ms/step) {runs}; {n_kernel_steps} kernel steps of 24 forward + 12 backward "
          f"launches; losses finite [{card}]")
    del models, states, steps, images
    torch.cuda.empty_cache()
    return dict(ms=ms[True], plain_ms=ms[False], runs_ms=runs[True], plain_runs_ms=runs[False],
                B=B, launches=d[:2])


def phase_stage2_384(card: str) -> dict:
    """One full-width dedeit stage-2 step at --input-size 384 (N 578), f32
    and bf16: past 256 keys the forward takes its key-chunked designs
    (attn_long_mma at bf16, attn_long_tf32 at f32) and the backward its
    long path. The kernel step against the same step with the plain
    attention (same state, batch and draws): loss and every gradient leaf
    within 2e-2 (||diff||/||plain||). Then the steady bf16 step at B 64 and
    f32 step at B 16 (_steady_384). The kernel steps are a main-path run:
    their launches are returned (24 forward, 12 backward a step), also by
    dtype."""
    gen = torch.Generator(device="cuda").manual_seed(44)
    res, launches = {}, {"fused_attention": 0, "attention_bwd": 0}
    for dtype in (torch.float32, torch.bfloat16):
        images = torch.randn((S384_B, 384, 384, 3), generator=gen, device="cuda").to(dtype)
        labels = torch.randint(0, TRAIN_CLASSES, (S384_B,), generator=gen, device="cuda")
        out = {}
        for use_kernel in (True, False):
            model = _model_384(dtype, use_kernel)
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = _step_grads(model, (images, labels), seed=3)
            torch.cuda.synchronize()
            out[use_kernel] = (loss, grads, (time.perf_counter() - t0) * 1e3, _delta(before))
            del model
        (loss_k, g_k, ms_k, d_k), (loss_p, g_p, ms_p, d_p) = out[True], out[False]
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        rel = {k: float((g_k[k].float() - g_p[k].float()).norm()
                        / g_p[k].float().norm().clamp_min(1e-30)) for k in g_p}
        worst = max(rel, key=rel.get)
        tag = str(dtype)[6:]
        if not (np.isfinite(loss_k) and loss_rel <= 2e-2 and rel[worst] <= 2e-2):
            raise AssertionError(f"[stage2-384] {tag}: loss {loss_k} vs plain {loss_p} (rel "
                                 f"{loss_rel:.3e}), worst gradient {worst} {rel[worst]:.3e}")
        if d_k[:2] != (24, 12) or any(d_p):
            raise AssertionError(f"[stage2-384] {tag}: launches kernel step {d_k}, plain step "
                                 f"{d_p}; expected (24, 12) and none")
        launches["fused_attention"] += d_k[0]
        launches["attention_bwd"] += d_k[1]
        res[tag] = dict(loss=loss_k, plain_loss=loss_p, loss_rel=loss_rel, worst_leaf=worst,
                        grad_rel=rel[worst], ms=ms_k, plain_ms=ms_p, launches=d_k[:2])
        print(f"[stage2-384] dedeit stage-2 step at 384 px (N 578), {tag}, B {S384_B}: loss "
              f"{loss_k:.6f} vs {loss_p:.6f} plain (rel {loss_rel:.3e}); worst gradient leaf "
              f"{worst} ||diff||/||plain|| {rel[worst]:.3e} (tol 2e-2, {len(rel)} leaves); "
              f"launches {d_k[0]} forward + {d_k[1]} backward (plain step none); step (first, "
              f"with the build of its state) {ms_k:.1f} ms, plain {ms_p:.1f} ms [{card}]")
        del g_k, g_p, images
        torch.cuda.empty_cache()
    steady, by_dtype = {}, {tag: tuple(r["launches"]) for tag, r in res.items()}
    for dtype, B in S384_STEADY:
        tag = str(dtype)[6:]
        steady[tag] = _steady_384(gen, card, dtype, B)
        launches["fused_attention"] += steady[tag]["launches"][0]
        launches["attention_bwd"] += steady[tag]["launches"][1]
        by_dtype[tag] = tuple(a + b for a, b in zip(by_dtype[tag], steady[tag]["launches"]))
    return dict(runs=res, launches=launches, steady=steady, launches_by_dtype=by_dtype)


# The main path of the routes past head width 128: the stage-2 step of dedeit
# with the CLI's --embed-dim 768 --num-heads 4 (dh 192), 224 px (N 198),
# depth cut to 4, B 32, in f32 and bf16
WIDE_MODEL, WIDE_B = dict(embed_dim=768, num_heads=4, depth=4), 32


def phase_stage2_wide(card: str) -> dict:
    """[stage2-wide]: one stage-2 step (AdamW + EMA, mixup/cutmix, remat) of
    WIDE_MODEL, f32 and bf16, with the kernels against the same step with
    the plain attention (same state, batch and draws): loss and every
    gradient leaf within 2e-2 (||diff||/||plain||). The kernel step is this
    route's main-path run: every count and wide count is 0 just before it
    and read just after; each of its 2 x depth forward and depth backward
    launches (remat) must be past head width 128, and the plain step
    launches none."""
    depth, dh = WIDE_MODEL["depth"], WIDE_MODEL["embed_dim"] // WIDE_MODEL["num_heads"]
    gen = torch.Generator(device="cuda").manual_seed(45)
    before, wide_before = _counts(), _wide_counts()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        images = torch.randn((WIDE_B, 224, 224, 3), generator=gen, device="cuda").to(dtype)
        labels = torch.randint(0, TRAIN_CLASSES, (WIDE_B,), generator=gen, device="cuda")
        out = {}
        for use_kernel in (True, False):
            model = create_vit("dedeit", **WIDE_MODEL, num_classes=TRAIN_CLASSES,
                               drop_path_rate=0.1, dtype=dtype, use_kernel=use_kernel,
                               use_remat=True, device="cuda",
                               generator=torch.Generator().manual_seed(0))
            _set_counts((0, 0, 0, 0))  # the main path
            _set_wide_counts((0, 0, 0, 0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = _step_grads(model, (images, labels), seed=3)
            torch.cuda.synchronize()
            out[use_kernel] = (loss, grads, (time.perf_counter() - t0) * 1e3, _counts(),
                               _wide_counts())
            del model
        (loss_k, g_k, ms_k, c_k, w_k), (loss_p, g_p, ms_p, c_p, _) = out[True], out[False]
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        rel = {k: float((g_k[k].float() - g_p[k].float()).norm()
                        / g_p[k].float().norm().clamp_min(1e-30)) for k in g_p}
        worst = max(rel, key=rel.get)
        tag = str(dtype)[6:]
        if not (np.isfinite(loss_k) and loss_rel <= 2e-2 and rel[worst] <= 2e-2):
            raise AssertionError(f"[stage2-wide] {tag}: loss {loss_k} vs plain {loss_p} (rel "
                                 f"{loss_rel:.3e}), worst gradient {worst} {rel[worst]:.3e}")
        want = (2 * depth, depth, 0, 0)
        if c_k != want or w_k != want or any(c_p):
            raise AssertionError(f"[stage2-wide] {tag}: launches kernel step {c_k} (past head "
                                 f"width 128 {w_k}), plain step {c_p}; expected {want} and none")
        res[tag] = dict(loss=loss_k, plain_loss=loss_p, loss_rel=loss_rel, worst_leaf=worst,
                        grad_rel=rel[worst], ms=ms_k, plain_ms=ms_p, launches=w_k)
        print(f"[stage2-wide] dedeit {WIDE_MODEL} (dh {dh}) stage-2 step, {tag}, B {WIDE_B}: "
              f"loss {loss_k:.6f} vs {loss_p:.6f} plain (rel {loss_rel:.3e}); worst gradient "
              f"leaf {worst} ||diff||/||plain|| {rel[worst]:.3e} (tol 2e-2, {len(rel)} "
              f"leaves); launches past head width 128 {w_k[0]} forward + {w_k[1]} backward "
              f"(plain step none); step (first, with the build of its state) {ms_k:.1f} ms, "
              f"plain {ms_p:.1f} ms [{card}]")
        del g_k, g_p, images
        torch.cuda.empty_cache()
    _set_counts(before)
    _set_wide_counts(wide_before)
    return res


CCT_WIDE = "cct_14_7x2_224"  # the widest registered CCT: 384 wide, 14 layers, 6 heads, N 196
CCT_B = 64
# the README's CCT through every stage: cct_7_3x1_32 (256 wide, 7 layers, 4
# heads, N 256), 4 divisions of decct_7_3x1, the CLI's defaults otherwise.
# Cuts: 1 epoch (default 5), 2048 synthetic 32-px images a split in place of
# CIFAR-100's 50,000
CCT_CLI = ["--model", "cct_7_3x1_32", "--input-size", "32", "--dataset",
           "synthetic:100:2048:32", "--num_division", "4", "--batch-size", "64", "--epochs", "1",
           "--device", "cuda"]


def phase_cct(card: str) -> dict:
    """The CCT family on the card. cct_14_7x2_224's f32 forward on the card
    against the same module on the CPU (logits within 1e-3 of max|logit|);
    one bf16 stage-2 step at bs 64 timed (loss finite, peak memory); then
    `pipeline --model cct_7_3x1_32 --num_division 4`: every stage timed,
    every logged loss finite, deploy skipped as the JAX CLI skips it, and
    no attention kernel launched (the JAX package's CCT computes its
    attention as plain einsums)."""
    from devit_tpu_torch.configs import get_cct_config
    from devit_tpu_torch.models.cct import create_cct

    side = get_cct_config(CCT_WIDE).img_size
    x = torch.randn((8, side, side, 3), generator=torch.Generator().manual_seed(45))
    model = create_cct(CCT_WIDE, num_classes=100, dtype=torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x).logits
        got = model.to("cuda")(x.cuda()).logits.cpu()
    rel = float((got - want).abs().max() / want.abs().max())
    if not (torch.isfinite(got).all() and rel <= 1e-3):
        raise AssertionError(f"[cct] {CCT_WIDE} f32 logits card vs CPU: rel {rel:.3e} (tol 1e-3)")
    cfg = model.cfg
    print(f"[cct] {CCT_WIDE} ({cfg.embed_dim} wide, {cfg.num_layers} layers, {cfg.num_heads} "
          f"heads, N {cfg.sequence_length()}) f32 forward of 8 images, card vs CPU: "
          f"max|diff|/max|logit| {rel:.3e} (tol 1e-3)")
    del model

    gen = torch.Generator(device="cuda").manual_seed(46)
    model = create_cct(CCT_WIDE, num_classes=100, dtype=torch.bfloat16, device="cuda",
                       generator=torch.Generator().manual_seed(2))
    state = TrainState.create(model, make_optimizer(OptimConfig(lr=5e-4, epochs=100), 100),
                              use_ema=True)
    step = make_stage2_step(model, None, mixup=_mixup(100), smoothing=0.1)
    images = torch.randn((CCT_B, side, side, 3), generator=gen, device="cuda").bfloat16()
    labels = torch.randint(0, 100, (CCT_B,), generator=gen, device="cuda")
    before = _counts()
    state, m = step(state, None, images, labels, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = []
    for i in range(3):
        state, m = step(state, None, images, labels, torch.Generator().manual_seed(1 + i))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 3
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or any(_delta(before)):
        raise AssertionError(f"[cct] stage-2 step: losses {losses}, attention kernel launches "
                             f"{_delta(before)} (expected none)")
    print(f"[cct] {CCT_WIDE} bf16 stage-2 step (mixup/cutmix, AdamW + EMA) at bs {CCT_B}: "
          f"{step_ms:.3f} ms/step = {CCT_B / step_ms * 1e3:.1f} img/s, losses {losses}, peak "
          f"memory {peak:.2f} GiB, 0 attention kernel launches [{card}]")
    del model, state, step, images
    torch.cuda.empty_cache()

    root = Path(tempfile.mkdtemp(prefix="devit_cct_"))
    out = str(root / "pipeline")
    record = {}
    undo = _cli_instrument(record)
    before = _counts()
    try:
        _set_counts((0, 0, 0, 0))
        t0 = time.perf_counter()
        results = _cli(["pipeline", *CCT_CLI, "--output_dir", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        undo()
        _set_counts(before)
    if any(launches):
        raise AssertionError(f"[cct] the CCT pipeline launched attention kernels {launches}")
    if "deploy" in record or os.path.exists(os.path.join(out, "deploy")):
        raise AssertionError("[cct] deploy ran for the CCT family")
    for name, rec in record.items():
        for d in rec["dirs"] if name in CLI_BACKWARD else ():
            with open(os.path.join(d, "log_stats.txt")) as f:
                logged = [json.loads(line) for line in f]
            if not logged or not all(np.isfinite(r["train_loss"]) and np.isfinite(r["test_loss"])
                                     for r in logged):
                raise AssertionError(f"[cct] {name} logged a non-finite loss in {d}: {logged}")
    stages = {k: dict(seconds=v["seconds"], calls=v["calls"], steps=v["steps"])
              for k, v in record.items()}
    print(f"[cct] devit-torch pipeline {' '.join(CCT_CLI)}: {wall:.1f} s; per stage "
          f"{ {k: (round(v['seconds'], 2), v['calls'], v['steps']) for k, v in stages.items()} } "
          f"(seconds, calls, train steps); every logged loss finite; deploy skipped (ViT-only, "
          f"as the JAX CLI); 0 attention kernel launches; the CCT ensemble's eval acc1 "
          f"{results['ensemble']:.2f} [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return dict(card_vs_cpu_rel=rel, step_ms=step_ms, img_s=CCT_B / step_ms * 1e3,
                peak_gib=peak, losses=losses, pipeline_s=wall, stages=stages,
                ensemble_acc1=results["ensemble"])


RESUME_ARGS = ["--model", "dedeit", "--input-size", "32", "--patch-size", "4", "--embed-dim",
               "32", "--depth", "2", "--num-heads", "4", "--dataset", "synthetic:8:256:32",
               "--num_division", "2", "--batch-size", "32", "--device", "cuda"]


def phase_resume(card: str) -> dict:
    """The stage-5 resume fallback: `ensemble` writes an adamw checkpoint
    (one epoch), then `ensemble --opt sgd --resume` it: its optimizer states
    do not fit an SGD run, so the params resume alone with the JAX CLI's
    WARNING, and the resumed epoch's loss is finite. Launches here are
    checks', not counted."""
    root = Path(tempfile.mkdtemp(prefix="devit_resume_"))
    before = _counts()
    try:
        _cli(["ensemble", *RESUME_ARGS, "--epochs", "1", "--output_dir", str(root / "a")])
        _cli(["ensemble", *RESUME_ARGS, "--epochs", "2", "--opt", "sgd", "--resume",
              str(root / "a" / "checkpoint_temp.msgpack"), "--output_dir", str(root / "b")])
    finally:
        _set_counts(before)
    text = (root / "b" / "log.txt").read_text()
    warning = next((line for line in text.splitlines() if "WARNING: resumed PARAMS ONLY" in line),
                   None)
    with open(root / "b" / "log_stats.txt") as f:
        logged = [json.loads(line) for line in f]
    if warning is None or not logged or not np.isfinite(logged[0]["train_loss"]):
        raise AssertionError(f"[resume] warning {warning!r}, logged {logged}")
    print(f"[resume] an adamw stage-5 checkpoint resumed under --opt sgd: {warning.strip()}; "
          f"epoch {logged[0]['epoch']} train loss {logged[0]['train_loss']:.4f} (finite) [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return dict(warning=warning.strip(), first=logged[0])


# [orbax]: `train_sub` of full-width dedeit (384 wide, 12 layers, 6 heads,
# 224 px, the CLI's defaults otherwise: bf16, EMA, AdamW) on 10 synthetic
# classes of 256 images (4 steps an epoch at bs64), in each format
ORBAX_ARGS = ["--model", "dedeit", "--dataset", "synthetic:10:256:224", "--num_division", "1",
              "--batch-size", "64", "--device", "cuda"]
ORBAX_FIXTURE = ROOT / "tests" / "torch_data" / "jax_orbax_tiny"
ORBAX_FIXTURE_GEOMETRY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
                              num_classes=10)
F32_FORWARD_TOL = TOL[torch.float32]  # max |got - want| / max |want|


def _bits(tree, prefix="") -> dict:
    """{leaf path: (dtype, shape, bytes)}; None and an empty dict alike (the
    msgpack tree holds optax's empty states as {}, orbax records None)."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(_bits(v, f"{prefix}{k}/"))
        return out
    if tree is None or isinstance(tree, dict):
        return {prefix: None}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return {prefix: (str(tree.dtype), tuple(t.shape), t.numpy().tobytes())}
    a = np.asarray(tree)
    return {prefix: (a.dtype.str, a.shape, a.tobytes())}


def _same_bits(a, b, what: str) -> int:
    ba, bb = _bits(a), _bits(b)
    if ba.keys() != bb.keys():
        raise AssertionError(f"[orbax] {what}: leaves differ: {sorted(set(ba) ^ set(bb))[:6]}")
    bad = [k for k in ba if ba[k] != bb[k]]
    if bad:
        raise AssertionError(f"[orbax] {what}: {len(bad)} leaves differ, first {bad[:4]}")
    return len(ba)


def _orbax_times(tree: dict, root: Path, reps: int = 3) -> dict:
    """What training and a resume wait for a checkpoint, in each format, of
    the live stage-2 state of `tree` (the full-width TrainState of
    `train_sub`, rebuilt as `train_sub` builds it and loaded from `tree`,
    its parameters, EMA and moments on the card). Medians of `reps` in
    turns, ms:
    - tree: `stage2_tree(state, epoch)` alone (every leaf copied to the
      host, the layers stacked), the first part of either save;
    - msgpack_save, orbax_save: `make_saver(args)(path, stage2_tree(state,
      epoch))`, the call `train_sub` makes at the end of each epoch (msgpack:
      the tree, encode, write, rename, no fsync; orbax: the tree, each leaf
      copied again, the write handed to the background);
    - orbax_durable: orbax_save and then `wait_for_checkpoints` (every file
      fsynced, the directory renamed and promoted);
    - msgpack_resume, orbax_resume: `restore_stage2_tree(state,
      restore_pytree(path))`, what `--resume` does, warm page cache."""
    from devit_tpu_torch.cli import common as C
    from devit_tpu_torch.cli.__main__ import build_parser
    from devit_tpu_torch.io.checkpoint import wait_for_checkpoints

    args = build_parser().parse_args(["train_sub", *ORBAX_ARGS])
    model = C.build_model(args.model, 10, args, seed=args.seed)
    tx = make_optimizer(C.optim_config_from_args(args, args.batch_size), 4)
    state = TrainState.create(model, tx, use_ema=args.model_ema, ema_decay=args.model_ema_decay)
    state, start = restore_stage2_tree(state, tree)
    epoch = start - 1
    _same_bits(stage2_tree(state, epoch), tree, "the rebuilt live state's stage2_tree")
    savers = {fmt: C.make_saver(SimpleNamespace(ckpt_format=fmt)) for fmt in ("msgpack", "orbax")}
    out = {k: [] for k in ("tree", "msgpack_save", "orbax_save", "orbax_durable",
                           "msgpack_resume", "orbax_resume")}
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage2_tree(state, epoch)
        out["tree"].append(time.perf_counter() - t0)
        for fmt in ("msgpack", "orbax"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            savers[fmt](str(root / f"{fmt}{i}.msgpack"), stage2_tree(state, epoch))
            out[f"{fmt}_save"].append(time.perf_counter() - t0)
            if fmt == "orbax":
                wait_for_checkpoints()
                out["orbax_durable"].append(time.perf_counter() - t0)
        for fmt in ("msgpack", "orbax"):
            t0 = time.perf_counter()
            restore_stage2_tree(state, restore_pytree(str(root / f"{fmt}{i}.{fmt}")))
            torch.cuda.synchronize()
            out[f"{fmt}_resume"].append(time.perf_counter() - t0)
    del state, model
    return {k: float(np.median(v)) * 1e3 for k, v in out.items()}


def phase_orbax(card: str) -> dict:
    """Orbax checkpoints through the CLI at full width: (a) `train_sub` of
    full-width dedeit for one epoch from one seed, once with --ckpt-format
    msgpack and once with orbax: the two checkpoint_temp trees equal bit
    for bit; (b) each resumed for a second epoch: the final trees equal bit
    for bit, and the attention forward and backward kernels launched (the
    counts of (a) and (b) are this main path's); (c) `convert` orbax ->
    msgpack -> orbax gives the same tree, and `inspect --json` of the orbax
    directory reports the msgpack file's geometry; (d) the JAX-written
    fixture (tests/torch_data/jax_orbax_tiny, a gated dedeit at 32 px) read
    and run by the port's f32 forward through the kernel: its logits within
    F32_FORWARD_TOL of the JAX package's; (e) the save and restore times of
    (a)'s tree in each format."""
    root = Path(tempfile.mkdtemp(prefix="devit_orbax_"))
    trees = {}
    _set_counts((0, 0, 0, 0))
    t0 = time.perf_counter()
    for fmt in ("msgpack", "orbax"):
        out = root / fmt
        _cli(["train_sub", *ORBAX_ARGS, "--ckpt-format", fmt, "--epochs", "1",
              "--output_dir", str(out)])
        first = restore_pytree(str(out / "checkpoint_temp.msgpack"))
        _cli(["train_sub", *ORBAX_ARGS, "--ckpt-format", fmt, "--epochs", "2",
              "--resume", str(out / f"checkpoint_temp.{fmt}"), "--output_dir", str(out)])
        trees[fmt] = (first, restore_pytree(str(out / "checkpoint_temp.msgpack")))
    torch.cuda.synchronize()
    runs_s = time.perf_counter() - t0
    launches = _counts()
    if not (os.path.isdir(root / "orbax" / "checkpoint_temp.orbax")
            and (root / "msgpack" / "checkpoint_temp.msgpack").is_file()):
        raise AssertionError(f"[orbax] checkpoint artifacts missing: "
                             f"{sorted(os.listdir(root / 'orbax'))}")
    if launches[0] == 0 or launches[1] == 0:
        raise AssertionError(f"[orbax] the stage-2 runs launched fused_attention "
                             f"{launches[0]} and attention_bwd {launches[1]} times")
    epochs = [int(np.asarray(trees[f][i]["epoch"])) for f in trees for i in (0, 1)]
    if epochs != [0, 1, 0, 1]:
        raise AssertionError(f"[orbax] checkpoint epochs {epochs}, expected [0, 1, 0, 1]")
    n = _same_bits(trees["msgpack"][0], trees["orbax"][0], "epoch 0's checkpoint_temp")
    _same_bits(trees["msgpack"][1], trees["orbax"][1], "the resumed epoch 1's checkpoint_temp")
    nbytes = sum(len(v[2]) for v in _bits(trees["orbax"][1]).values() if v is not None)
    print(f"[orbax] train_sub dedeit 224 px bf16 bs64, 1 epoch + a resumed epoch, msgpack vs "
          f"orbax: checkpoint_temp equal bit for bit after each ({n} leaves, "
          f"{nbytes / 1e6:.1f} MB); fused_attention {launches[0]}, attention_bwd "
          f"{launches[1]} launches ({runs_s:.1f} s for the 4 runs) [{card}]")

    ck = str(root / "orbax" / "checkpoint_temp.orbax")
    mp, ob = str(root / "conv.msgpack"), str(root / "conv.orbax")
    _cli(["convert", ck, mp, "--device", "cuda"])
    _cli(["convert", mp, ob, "--device", "cuda"])
    _same_bits(restore_pytree(mp), trees["orbax"][1], "convert orbax -> msgpack")
    _same_bits(restore_pytree(ob), trees["orbax"][1], "convert msgpack -> orbax")
    from devit_tpu_torch.cli.inspect_ckpt import summarize_artifact

    got, want = summarize_artifact(ck), summarize_artifact(mp)
    if got["format"] != "orbax" or any(got.get(k) != want.get(k) for k in (
            "kind", "geometry", "epoch", "param_count", "has_ema", "has_opt_state")):
        raise AssertionError(f"[orbax] inspect: {got} vs the msgpack's {want}")
    print(f"[orbax] convert orbax -> msgpack -> orbax: the same tree; inspect: format orbax, "
          f"{got['kind']}, {got['geometry']}, epoch {got['epoch']}, "
          f"{got['param_count']:,} params as the msgpack's [{card}]")

    fx = restore_pytree(str(ORBAX_FIXTURE / "checkpoint.orbax"))
    expected = np.load(ORBAX_FIXTURE / "expected.npz")
    model = vit_from_jax_params(fx["params"], get_vit_config("dedeit", **ORBAX_FIXTURE_GEOMETRY),
                                device="cuda", dtype=torch.float32).eval()
    gates = Gates(*(torch.as_tensor(np.asarray(fx["gates"][k]), device="cuda")
                    for k in ("head", "neuron")))
    before = _counts()
    with torch.no_grad():
        logits = model(torch.from_numpy(expected["images"]).cuda(), gates).logits
    torch.cuda.synchronize()
    fx_launches = _delta(before)[0]
    want = expected["logits"]
    err = float(np.abs(logits.cpu().numpy() - want).max() / np.abs(want).max())
    if fx_launches != ORBAX_FIXTURE_GEOMETRY["depth"] or not err <= F32_FORWARD_TOL:
        raise AssertionError(f"[orbax] the JAX-written fixture: {fx_launches} launches, "
                             f"logits rel err {err:.3e} (tol {F32_FORWARD_TOL})")
    print(f"[orbax] the JAX-written fixture (gated dedeit 32 px, depth 2, dh 32) on the card, "
          f"f32 through the kernel ({fx_launches} launches): logits rel err {err:.3e} vs the "
          f"JAX package's (tol {F32_FORWARD_TOL}) [{card}]")

    times = _orbax_times(trees["orbax"][1], root)
    print("[orbax] what a step and a resume wait: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in times.items())
          + f" (the live {nbytes / 1e6:.1f}-MB stage-2 state, medians of 3) [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(leaves=n, mbytes=nbytes / 1e6, launches=list(launches),
                fixture=dict(launches=fx_launches, rel_err=err), runs_s=runs_s, times_ms=times)


TEXT_B, TEXT_VOCAB, TEXT_CLASSES, TEXT_L = 256, 30000, 4, 64  # a word vocabulary; AG News' 4


def _text_batch(seed: int):
    """TEXT_B rows of TEXT_L word ids: padded tails of random length
    (padding id 1, mask 0) and one row masked everywhere."""
    gen = torch.Generator().manual_seed(seed)
    lengths = torch.randint(1, TEXT_L + 1, (TEXT_B,), generator=gen)
    lengths[-1] = 0
    mask = (torch.arange(TEXT_L)[None] < lengths[:, None]).float()
    ids = torch.randint(2, TEXT_VOCAB, (TEXT_B, TEXT_L), generator=gen)
    ids[mask == 0] = 1
    labels = torch.randint(0, TEXT_CLASSES, (TEXT_B,), generator=gen)
    return ids, mask, labels


def phase_text(card: str) -> dict:
    """The masked-attention text CCT (models/text.py) at TextCCT's defaults
    (64 words, 300-wide embeddings, 256 wide, 4 layers, 4 heads, kernel 4:
    N 16 tokens) with a 30,000-word table: the f32 eval logits on the card
    against the same module on the CPU (1e-3 of max|logit|), the bf16 logits
    against the f32 ones (2e-2), then 10 bf16 AdamW steps (train/optim.py)
    with dropout and drop-path on, every loss finite. The JAX package runs
    this attention as plain einsums: no attention kernel may launch."""
    from devit_tpu_torch.models.text import TextCCT

    ids, mask, labels = _text_batch(60)

    def build(dtype, device):
        return TextCCT(TEXT_VOCAB, TEXT_CLASSES, dtype=dtype, device=device,
                       generator=torch.Generator().manual_seed(61))

    before = _counts()
    _set_counts((0, 0, 0, 0))
    try:
        model = build(torch.float32, "cpu")
        with torch.no_grad():
            want = model(ids, mask)
            got = model.to("cuda")(ids.cuda(), mask.cuda()).cpu()
            bf16 = build(torch.bfloat16, "cuda")(ids.cuda(), mask.cuda()).cpu()
        rel = float((got - want).abs().max() / want.abs().max())
        rel_bf16 = float((bf16 - got).abs().max() / got.abs().max())
        if not (torch.isfinite(got).all() and rel <= 1e-3 and rel_bf16 <= 2e-2):
            raise AssertionError(f"[text] logits: f32 card vs CPU rel {rel:.3e} (tol 1e-3), bf16 "
                                 f"vs f32 rel {rel_bf16:.3e} (tol 2e-2)")
        print(f"[text] TextCCT defaults, vocab {TEXT_VOCAB}, {TEXT_CLASSES} classes, bs{TEXT_B} "
              f"({int((mask.sum(1) < TEXT_L).sum())} rows padded, 1 masked everywhere): f32 "
              f"logits card vs CPU max|diff|/max|logit| {rel:.3e} (tol 1e-3); bf16 vs f32 "
              f"{rel_bf16:.3e} (tol 2e-2) [{card}]")
        del model

        model = build(torch.bfloat16, "cuda")
        state = TrainState.create(model, make_optimizer(OptimConfig(lr=5e-4, epochs=10), 1))
        names = list(state.params)
        ids_c, mask_c, labels_c = ids.cuda(), mask.cuda(), labels.cuda()

        def step(seed: int):
            logits = model(ids_c, mask_c, train=True,
                           generator=torch.Generator().manual_seed(seed))
            loss = torch.nn.functional.cross_entropy(logits, labels_c)
            grads = torch.autograd.grad(loss, [state.params[k] for k in names])
            state.apply_gradients(dict(zip(names, grads)))
            return loss.detach()

        step(0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [step(1 + i) for i in range(10)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / 10
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = _counts()
    finally:
        _set_counts(before)
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)) or any(launches):
        raise AssertionError(f"[text] losses {losses}, attention kernel launches {launches} "
                             "(expected none)")
    print(f"[text] 10 bf16 AdamW steps, dropout and drop-path 0.1: {step_ms:.3f} ms/step = "
          f"{TEXT_B / step_ms * 1e3:.1f} sequences/s, losses {[round(v, 4) for v in losses]} "
          f"(all finite), peak memory {peak:.3f} GiB, 0 attention kernel launches [{card}]")
    del model, state
    torch.cuda.empty_cache()
    return dict(card_vs_cpu_rel=rel, bf16_vs_f32_rel=rel_bf16, step_ms=step_ms,
                seq_s=TEXT_B / step_ms * 1e3, peak_gib=peak, losses=losses)


# remat_policy -> (attention forward, backward) launches a stage-2 step: the
# policies that save the attention's output run no forward in the backward
REMAT_RUN = {None: (24, 12), "dots_with_no_batch_dims_saveable": (24, 12),
             "dots_saveable": (24, 12), "dots_and_attn": (12, 12),
             "everything_saveable": (12, 12)}
REMAT_TURN_STEPS = 3


def phase_remat(card: str) -> dict:
    """[train]'s stage-2 step (full-width dedeit, bs256, bf16, the kernels)
    under each remat_policy of REMAT_RUN: one step from one state, batch and
    draws, whose loss and every gradient leaf must equal full remat's
    (||diff||/||ref|| <= 1e-6); then REMAT_TURN_STEPS timed steps a turn,
    the policies in turns (forward order, then reverse), the attention
    launches of every step held to REMAT_RUN, the peak memory of each
    turn."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    images = torch.randn((TRAIN_B, 224, 224, 3), generator=gen, device="cuda").bfloat16()
    labels = torch.randint(0, TRAIN_CLASSES, (TRAIN_B,), generator=gen, device="cuda")
    model = _train_model(True)
    before = _counts()
    _set_counts((0, 0, 0, 0))
    per_step = {p: [] for p in REMAT_RUN}
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    try:
        ref = None
        rels, exact = {}, {}
        for policy in REMAT_RUN:
            model.remat_policy = policy
            with torch.no_grad():  # the step updates the parameters in place
                for k, p in model.named_parameters():
                    p.copy_(init[k])
            c0 = _counts()
            loss, grads = _step_grads(model, (images, labels), seed=1)
            per_step[policy].append(_delta(c0)[:2])
            if ref is None:
                ref = (loss, grads)
            diff = {k: float((g.float() - ref[1][k].float()).norm()
                             / ref[1][k].float().norm().clamp_min(1e-30)) for k, g in grads.items()}
            rels[policy] = max(max(diff.values()), abs(loss - ref[0]) / abs(ref[0]))
            exact[policy] = loss == ref[0] and all(torch.equal(g, ref[1][k])
                                                   for k, g in grads.items())
            del grads
        state = _train_state(model)
        step = _train_step(model)
        ms, peaks, losses = {p: [] for p in REMAT_RUN}, {p: [] for p in REMAT_RUN}, []
        order = list(REMAT_RUN) + list(reversed(REMAT_RUN))
        for turn, policy in enumerate(order):
            model.remat_policy = policy
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i in range(REMAT_TURN_STEPS):
                c0 = _counts()
                state, metrics = step(state, None, images, labels,
                                      torch.Generator().manual_seed(300 + turn * 10 + i))
                per_step[policy].append(_delta(c0)[:2])
                losses.append(metrics["loss"])
            torch.cuda.synchronize()
            ms[policy].append((time.perf_counter() - t0) * 1e3 / REMAT_TURN_STEPS)
            peaks[policy].append(torch.cuda.max_memory_allocated() / 2**30)
        launches = {"fused_attention": fused_attention.launches,
                    "attention_bwd": attention_bwd.launches}
    finally:
        model.remat_policy = None
        _set_counts(before)
    bad = {p: c for p, c in per_step.items() if any(x != REMAT_RUN[p] for x in c)}
    host_losses = [float(v) for v in losses]
    worst = max(rels, key=rels.get)
    if bad or rels[worst] > 1e-6 or not all(np.isfinite(host_losses)):
        raise AssertionError(f"[remat] launches a step off {REMAT_RUN}: {bad}; worst policy "
                             f"{worst} rel {rels[worst]:.3e} (tol 1e-6); losses {host_losses}")
    for p in REMAT_RUN:
        print(f"[remat] remat_policy={p!r}: loss and gradients vs full remat "
              f"{'bit for bit' if exact[p] else f'max rel {rels[p]:.3e}'}; "
              f"{REMAT_RUN[p][0]} + {REMAT_RUN[p][1]} attention launches a step; "
              f"{sum(ms[p]) / len(ms[p]):.3f} ms/step (turns {[round(t, 3) for t in ms[p]]}), "
              f"peak memory {max(peaks[p]):.3f} GiB [{card}]")
    del model, state, step, init
    torch.cuda.empty_cache()
    return dict(rel=rels, bit_for_bit=exact, ms={str(p): v for p, v in ms.items()},
                peak_gib={str(p): max(v) for p, v in peaks.items()}, launches=launches)


# ---- several ranks: ranks that share the card over gloo, the
# collaborative server, the CLI under two ranks, the multi-rank dry run

SELF = str(Path(__file__).resolve())
DIST_ENV = {"DEVIT_DIST_BACKEND": "gloo"}  # NCCL refuses two ranks on one card
DIST_S2_B = 64  # global batch of [dist-stage2]
DIST_ENS_B = 32  # global batch of [dist-ens]
COLLAB_B, COLLAB_STREAM = 256, 8


def _free_card(tag: str) -> None:
    """Hand this process's cached device memory back before ranks that
    share the card start (the earlier phases leave tens of GiB cached)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved) while the ranks run")


def _probe_collectives() -> dict:
    """Which gloo collectives take CUDA tensors under this PyTorch (the
    package needs all_reduce and broadcast; all_gather is recorded)."""
    import torch.distributed as dist

    x = torch.ones(4, device="cuda")
    out = {}
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), src=0)),
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(dist.get_world_size())], x))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:  # an op gloo does not take on CUDA tensors
            out[name] = str(e).splitlines()[0][:160]
    if out["all_reduce"] != "ok" or out["broadcast"] != "ok":
        raise RuntimeError(f"gloo on CUDA tensors: {out}; the multi-rank phases need "
                           "all_reduce and broadcast")
    return out


def _timed_reduce(layout) -> list:
    """Wrap the layout's gradient all-reduce with a synchronized timer;
    returns the list the milliseconds land in."""
    spent, real = [], layout.mean_over_data

    def timed(tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(tensors)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    layout.mean_over_data = timed
    return spent


def _rank_dist_stage2(B: int) -> dict:
    """[dist-stage2] on one rank: the full-width stage-2 step with the
    kernels over the data layout (a warm-up step on a second model first);
    rank 0 then runs the one-process step on the same batch and draws and
    returns the comparison."""
    from devit_tpu_torch import runtime
    from devit_tpu_torch.parallel import mesh as M

    probe = _probe_collectives()
    layout = M.data_layout()
    gen = torch.Generator(device="cuda").manual_seed(60)
    batch = (torch.randn((B, PX, PX, 3), generator=gen, device="cuda").bfloat16(),
             torch.randint(0, TRAIN_CLASSES, (B,), generator=gen, device="cuda"))
    _step_grads(_train_model(True), batch, seed=1, layout=layout)  # warm-up
    spent = _timed_reduce(layout)
    model = _train_model(True)
    _set_counts((0, 0, 0, 0))  # the main path
    torch.cuda.synchronize()
    torch.distributed.barrier()  # the ranks start the timed step together
    t0 = time.perf_counter()
    loss, grads = _step_grads(model, batch, seed=3, layout=layout)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = dict(rank=runtime.rank(), shape=layout.shape, probe=probe, loss=loss, ms=ms,
               reduce_ms=sum(spent), launches=_counts())
    if runtime.rank() == 0:
        before = _counts()
        ref_loss, ref = _step_grads(_train_model(True), batch, seed=3)
        model = _train_model(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _step_grads(model, batch, seed=3)
        torch.cuda.synchronize()
        out["one_ms"] = (time.perf_counter() - t0) * 1e3
        _set_counts(before)
        rel = _grad_rel(grads, ref)
        worst = max(rel, key=rel.get)
        out.update(ref_loss=ref_loss, worst_leaf=worst, grad_rel=rel[worst], leaves=len(rel),
                   max_abs=max(float((grads[k].float() - ref[k].float()).abs().max())
                               for k in ref))
    return out


def phase_dist_stage2(card: str) -> dict:
    """[dist-stage2]: two ranks share the card over gloo; one full-width
    dedeit stage-2 step at global bs 64 (32 rows a rank, mixup/cutmix and
    drop-path drawn at the global batch) with the kernels, held to the
    one-process step (loss and every gradient leaf within 2e-2)."""
    from devit_tpu_torch.parallel.launch import run_ranks

    _free_card("[dist-stage2]")
    t0 = time.perf_counter()
    ranks = run_ranks(f"{SELF}:_rank_dist_stage2", 2, args=(DIST_S2_B,), device="cuda",
                      env=DIST_ENV, timeout=400)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    per_rank = [r["launches"] for r in ranks]
    if not (np.isfinite(r0["loss"]) and loss_rel <= 2e-2 and r0["grad_rel"] <= 2e-2):
        raise AssertionError(f"[dist-stage2] 2 ranks vs one process: loss {r0['loss']} vs "
                             f"{r0['ref_loss']} (rel {loss_rel:.3e}), worst gradient "
                             f"{r0['worst_leaf']} {r0['grad_rel']:.3e}")
    if any(c != (24, 12, 0, 0) for c in per_rank) or ranks[1]["loss"] != r0["loss"]:
        raise AssertionError(f"[dist-stage2] launches per rank {per_rank} (expected 24 forward "
                             f"+ 12 backward), losses {[r['loss'] for r in ranks]}")
    print(f"[dist-stage2] gloo on CUDA tensors: {r0['probe']}")
    print(f"[dist-stage2] dedeit stage-2 step, 2 ranks sharing the card (gloo, layout "
          f"{r0['shape']}), global bs {DIST_S2_B}: loss {r0['loss']:.6f} vs {r0['ref_loss']:.6f} "
          f"one process (rel {loss_rel:.3e}); worst gradient leaf {r0['worst_leaf']} "
          f"||diff||/||one|| {r0['grad_rel']:.3e} (tol 2e-2, {r0['leaves']} leaves, max abs "
          f"{r0['max_abs']:.3e}); launches per rank {per_rank} (fused, bwd, dv, dqdk); step "
          f"{[round(r['ms'], 1) for r in ranks]} ms per rank, of it the gradient all-reduce "
          f"{[round(r['reduce_ms'], 1) for r in ranks]} ms "
          f"({100 * r0['reduce_ms'] / r0['ms']:.1f}% on rank 0); the one-process step "
          f"{r0['one_ms']:.1f} ms; the phase {wall:.1f} s with the ranks' start-up [{card}]")
    return dict(ranks=[{k: v for k, v in r.items()} for r in ranks], loss_rel=loss_rel,
                wall_s=wall, launches=[sum(c[i] for c in per_rank) for i in range(4)])


def _rank_dist_ens(B: int) -> dict:
    """[dist-ens] on one rank: the stage-5 step of the four full-width
    divisions over the ensemble layout (this rank's division), with the
    monolithic backward and with the split pair; rank 0 then runs the
    one-process steps and returns the comparisons."""
    from devit_tpu_torch import runtime
    from devit_tpu_torch.parallel import mesh as M

    layout = M.ensemble_layout(ENS_D)
    setup = _ens_parts(B)
    models = (setup["backbone"], setup["teacher"])
    out = dict(rank=runtime.rank(), shape=layout.shape, divisions=list(layout.divisions))

    def one_step(mode, lay, count):
        bb, en, step = _ens_states(setup, layout=lay)
        gates = setup["gates"]
        if lay is not None:
            M.shard_state(bb, lay)
            gates = Gates(**M.shard_division_tree(gates._asdict(), lay))
        seen = {"bb": {}, "ens": {}}
        for key, st in (("bb", bb), ("ens", en)):
            upd = st.tx.update
            st.tx.update = (lambda sink, u: lambda g, s_, p_: (sink.update(g),
                                                               u(g, s_, p_))[1]
                            )(seen[key], upd)
        _set_mode(models, mode)
        setup["teacher"].use_kernel = True
        if count:
            _set_counts((0, 0, 0, 0))  # the main path
        torch.cuda.synchronize()
        if lay is not None:
            torch.distributed.barrier()  # the ranks start the timed step together
        t0 = time.perf_counter()
        _, _, metrics = step(bb, en, None, gates, *setup["batch"],
                             torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if lay is not None:
            seen["bb"] = M.gather_division_tree(seen["bb"], lay)
        return float(metrics["loss"]), seen, ms, _counts()

    one_step("monolithic", layout, False)  # warm-up
    for mode in ("monolithic", "split"):
        loss, seen, ms, launches = one_step(mode, layout, True)
        out[mode] = dict(loss=loss, ms=ms, launches=launches)
        if runtime.rank() == 0:
            ref_loss, ref, one_ms, _ = one_step(mode, None, False)
            rel = {**{f"bb/{k}": v for k, v in _grad_rel(seen["bb"], ref["bb"]).items()},
                   **{f"ens/{k}": v for k, v in _grad_rel(seen["ens"], ref["ens"]).items()}}
            worst = max(rel, key=rel.get)
            same = all(torch.equal(seen[s][k], ref[s][k]) for s in ref for k in ref[s])
            out[mode].update(ref_loss=ref_loss, one_ms=one_ms, worst_leaf=worst,
                             grad_rel=rel[worst], leaves=len(rel), bit_equal=same)
    os.environ.pop("DEVIT_ATTN_BWD", None)
    return out


def phase_dist_ens(card: str) -> dict:
    """[dist-ens]: four ranks share the card over gloo, layout {div 4, data
    1}: each rank holds one of the four full-width dedeit divisions (the
    deployed gates), the deit-base teacher and EnsMLP; one stage-5 step at
    global bs 32 with the monolithic backward and one with the split pair,
    each held to the one-process step (loss and every gradient leaf of both
    states within 2e-2; whether they are equal bit for bit is printed)."""
    from devit_tpu_torch.parallel.launch import run_ranks

    _free_card("[dist-ens]")
    t0 = time.perf_counter()
    ranks = run_ranks(f"{SELF}:_rank_dist_ens", ENS_D, args=(DIST_ENS_B,), device="cuda",
                      env=DIST_ENV, timeout=500)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    Lt = 12  # the deit-base teacher's layers, each rank's on its rows
    expect = {"monolithic": (2 * 12 + Lt, 12, 0, 0), "split": (2 * 12 + Lt, 0, 12, 12)}
    totals = [0, 0, 0, 0]
    for mode in ("monolithic", "split"):
        m = r0[mode]
        loss_rel = abs(m["loss"] - m["ref_loss"]) / abs(m["ref_loss"])
        per_rank = [r[mode]["launches"] for r in ranks]
        if not (np.isfinite(m["loss"]) and loss_rel <= 2e-2 and m["grad_rel"] <= 2e-2):
            raise AssertionError(f"[dist-ens] {mode}: 4 ranks vs one process: loss {m['loss']} "
                                 f"vs {m['ref_loss']}, worst gradient {m['worst_leaf']} "
                                 f"{m['grad_rel']:.3e}")
        if any(c != expect[mode] for c in per_rank):
            raise AssertionError(f"[dist-ens] {mode} launches per rank {per_rank}, expected "
                                 f"{expect[mode]}")
        totals = [t + sum(c[i] for c in per_rank) for i, t in enumerate(totals)]
        print(f"[dist-ens] stage-5 step, {mode} backward, 4 ranks sharing the card (gloo, "
              f"layout {r0['shape']}, divisions per rank {[r['divisions'] for r in ranks]}), "
              f"global bs {DIST_ENS_B}: loss {m['loss']:.6f} vs {m['ref_loss']:.6f} one process "
              f"(rel {loss_rel:.3e}); worst gradient leaf {m['worst_leaf']} ||diff||/||one|| "
              f"{m['grad_rel']:.3e} (tol 2e-2, {m['leaves']} leaves of both states), bit for "
              f"bit: {m['bit_equal']}; launches per rank {per_rank}; step "
              f"{[round(r[mode]['ms'], 1) for r in ranks]} ms per rank, one process "
              f"{m['one_ms']:.1f} ms [{card}]")
    print(f"[dist-ens] the phase {wall:.1f} s with the ranks' start-up")
    return dict(ranks=ranks, wall_s=wall, launches=totals)


def phase_collab(card: str) -> dict:
    """[collab]: make_collaborative_server on [cuda:0] over the four
    deployed divisions at bs 256 against InferenceEngine's logits (bit for
    bit), then stream(depth=2) over 8 batches against per-batch serve (bit
    for bit); 48 fused_attention launches a batch. The stream is the main
    path; its launches are counted."""
    from torch.func import functional_call

    from devit_tpu_torch.parallel.serve import make_collaborative_server

    cfg, cms, ens = deploy.build_artifacts(device="cuda")
    engine = InferenceEngine(cms, ens, ServeConfig(input_size=cfg.img_size,
                                                   patch_size=cfg.patch_size,
                                                   buckets=(COLLAB_B,)), device="cuda")
    ev = {k: v.detach() for k, v in ens.named_parameters()}
    serve = make_collaborative_server(cms, lambda e, c, t: functional_call(ens, e, (c, t)), ev,
                                      patch_size=cfg.patch_size,
                                      devices=[torch.device("cuda", 0)])
    rng = np.random.default_rng(70)
    u8 = [rng.integers(0, 256, (COLLAB_B, PX, PX, 3), dtype=np.uint8)
          for _ in range(COLLAB_STREAM)]
    xs = [normalize(torch.from_numpy(b).cuda(), torch.float32) for b in u8]
    before = _counts()
    want = engine.predict(u8[0])
    got = serve(ev, xs[0]).float().cpu().numpy()
    per_batch = [serve(ev, x).float().cpu().numpy() for x in xs]
    torch.cuda.synchronize()
    _set_counts((0, 0, 0, 0))  # the main path: the lag-2 stream
    t0 = time.perf_counter()
    streamed = list(serve.stream(ev, xs, depth=2))
    stream_s = time.perf_counter() - t0
    launches = _counts()
    t0 = time.perf_counter()
    for x in xs:
        serve(ev, x).float().cpu()
    serial_s = time.perf_counter() - t0
    _set_counts(tuple(a + b for a, b in zip(before, launches)))
    engine_err = float(np.abs(got - want).max())
    stream_err = max(float(np.abs(a - b).max()) for a, b in zip(streamed, per_batch))
    if engine_err != 0.0 and engine_err > 2e-2 * float(np.abs(want).max()):
        raise AssertionError(f"[collab] served vs engine.predict: max|diff| {engine_err}")
    if stream_err != 0.0 or launches != (48 * COLLAB_STREAM, 0, 0, 0):
        raise AssertionError(f"[collab] stream vs per-batch serve max|diff| {stream_err}, "
                             f"launches {launches} (expected {48 * COLLAB_STREAM} forward)")
    print(f"[collab] collaborative server on [cuda:0] (divisions on "
          f"{[str(d) for d in serve.division_devices]}, fusion on {serve.fusion_device}), 4 "
          f"deployed divisions, bs {COLLAB_B}: logits vs InferenceEngine.predict max|diff| "
          f"{engine_err:.3e} ({'bit for bit' if engine_err == 0 else 'within 2e-2'}); "
          f"stream(depth=2) over {COLLAB_STREAM} batches equal to per-batch serve bit for bit, "
          f"{launches[0]} fused_attention launches (48 a batch); {COLLAB_STREAM * COLLAB_B / stream_s:.1f} "
          f"img/s streamed, {COLLAB_STREAM * COLLAB_B / serial_s:.1f} img/s with a host copy "
          f"after each batch [{card}]")
    del engine, serve, cms, ens
    torch.cuda.empty_cache()
    return dict(engine_max_abs=engine_err, stream_max_abs=stream_err, launches=launches,
                stream_img_s=COLLAB_STREAM * COLLAB_B / stream_s,
                serial_img_s=COLLAB_STREAM * COLLAB_B / serial_s)


# `train_sub` at full width on division 0 of 1024 synthetic 224-px images
# (about 256 a division), 1 epoch at bs 64 from lr 5e-4 without warm-up,
# augmentation on the card (the machine may lack PIL)
CLI_DIST = ["train_sub", "--model", "dedeit", "--dataset", "synthetic:100:1024:224",
            "--num_division", "4", "--start-division", "0", "--batch-size", "64",
            "--eval-batch-size", "64", "--epochs", "1", "--warmup-epochs", "0", "--lr", "5e-4",
            "--aug-backend", "device", "--device", "cuda"]


def _rank_cli(argv: list) -> tuple:
    """One devit-torch command on this rank; its kernel launches."""
    _set_counts((0, 0, 0, 0))
    _cli(argv)
    torch.cuda.synchronize()
    return _counts()


def phase_cli_dist(card: str) -> dict:
    """[cli-dist]: `devit-torch train_sub` under two ranks sharing the card
    (gloo) against the same command in one process: the per-epoch losses
    within 2e-2, every checkpoint leaf within the Adam bound (steps x lr);
    rank 0 alone writes files (rank 1 its log_rank1.txt)."""
    from devit_tpu_torch.parallel.launch import run_ranks

    root = Path(tempfile.mkdtemp(prefix="devit_cli_dist_"))
    par, one = str(root / "par"), str(root / "one")
    _free_card("[cli-dist]")
    t0 = time.perf_counter()
    per_rank = run_ranks(f"{SELF}:_rank_cli", 2, args=(CLI_DIST + ["--output_dir", par],),
                         device="cuda", env=DIST_ENV, timeout=400)
    par_s = time.perf_counter() - t0
    before = _counts()
    t0 = time.perf_counter()
    _cli(CLI_DIST + ["--output_dir", one])
    one_s = time.perf_counter() - t0
    _set_counts(before)
    with open(os.path.join(par, "log_stats.txt")) as f:
        got = [json.loads(line) for line in f]
    with open(os.path.join(one, "log_stats.txt")) as f:
        want = [json.loads(line) for line in f]
    a = restore_pytree(os.path.join(par, "checkpoint_temp.msgpack"))
    b = restore_pytree(os.path.join(one, "checkpoint_temp.msgpack"))
    diffs = _tree_diff(a["params"], b["params"])
    steps = 256 // 64
    worst = max(diffs.values())
    rel = {k: abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want)
           for k in ("train_loss", "test_loss")}
    files = sorted(os.listdir(par))
    extra = sorted(set(files) - set(os.listdir(one)))
    if (not got or max(rel.values()) > 2e-2 or worst > steps * 5e-4 * 1.001
            or extra != ["log_rank1.txt"] or min(min(c[:2]) for c in per_rank) == 0):
        raise AssertionError(f"[cli-dist] losses rel {rel}, worst param diff {worst}, files "
                             f"beyond one process's {extra}, launches per rank {per_rank}")
    print(f"[cli-dist] devit-torch {' '.join(CLI_DIST)} under 2 ranks (gloo on the card) vs "
          f"one process: losses rel {max(rel.values()):.3e} (tol 2e-2); checkpoint params "
          f"worst max|diff| {worst:.3e} over {len(diffs)} leaves (bound {steps} steps x lr "
          f"{steps * 5e-4:.1e}); rank 0 alone wrote files (rank 1: {extra}); launches per rank "
          f"{per_rank}; {par_s:.1f} s under 2 ranks with their start-up, {one_s:.1f} s in one "
          f"process [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    return dict(loss_rel=rel, worst_param=worst, par_s=par_s, one_s=one_s,
                launches=[sum(c[i] for c in per_rank) for i in range(4)])


def phase_dryrun(card: str) -> dict:
    """[dryrun]: devit_tpu_torch.entry.dryrun_multichip(8): eight ranks
    sharing the card over gloo, the stage-5, stage-2 and DEKD steps (with
    the kernels) held to one process on the card, and the serving topology;
    then entry()'s forward on the card (finite (8, 100) logits, 48
    fused_attention launches; a check's, not counted)."""
    from devit_tpu_torch.entry import dryrun_multichip, entry

    _free_card("[dryrun]")
    t0 = time.perf_counter()
    dryrun_multichip(8)
    s = time.perf_counter() - t0
    fn, example = entry()
    before = _counts()
    logits = fn(*example)
    torch.cuda.synchronize()
    launches = _delta(before)
    _set_counts(before)
    if logits.shape != (8, 100) or not torch.isfinite(logits).all() or launches[0] != 48:
        raise AssertionError(f"[dryrun] entry(): logits {tuple(logits.shape)}, launches "
                             f"{launches}")
    print(f"[dryrun] dryrun_multichip(8) in {s:.1f} s (eight processes on the card); entry()'s "
          f"forward on {logits.device}: logits {tuple(logits.shape)} finite, "
          f"{launches[0]} fused_attention launches [{card}]")
    return dict(seconds=s, entry_launches=launches[0])


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
    gelu_times = phase_gelu(card)
    moe_times = phase_moe(card)
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
    times["f32_long"] = phase_f32_long(card)
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
    times["attn_long"] = attn_long = phase_attn_long(card)
    times["stage2_384"] = s384 = phase_stage2_384(card)
    times["stage2_wide"] = swide = phase_stage2_wide(card)
    times["cct"] = phase_cct(card)
    times["resume"] = phase_resume(card)
    times["orbax"] = orbax = phase_orbax(card)
    torch.cuda.empty_cache()
    times["text"] = phase_text(card)
    times["remat"] = remat = phase_remat(card)
    times["dist_stage2"] = d2 = phase_dist_stage2(card)
    times["dist_ens"] = de = phase_dist_ens(card)
    times["collab"] = collab = phase_collab(card)
    times["cli_dist"] = cd = phase_cli_dist(card)
    times["dryrun"] = phase_dryrun(card)
    dist = [sum(p["launches"][i] for p in (d2, de, cd)) for i in range(4)]
    hm = {k: max(v, heads_pad["max_abs"][k], attn_long["max_abs"][k])
          for k, v in heads["max_abs"].items()}

    bl = times["bwd_long"]["max_abs"]
    fa = times["forward_attention"]
    bw = train["kernel_times"]["bwd_step"]
    es = ens["kernel_times"]["per_step"]
    record = {"kernels": [{
        "name": "fused_attention", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/attention.cu",
        "replaces": "devit_tpu/kernels/attention.py:30",
        # the launches of every main-path run: serving, stage 2, stage 5, DEKD,
        # stage 3 (the policy search's chunks), stage 2 from the files, the CLI
        # pipeline, stage 2 at 384 px, every rank of the multi-rank phases,
        # the collaborative server's stream, the orbax train_sub runs
        "launches": (launches + train["launches"]["fused_attention"]
                     + ens["launches"]["fused_attention"] + dekd["launches"]["fused_attention"]
                     + stage3["launches"] + times["data_train"]["launches"]["fused_attention"]
                     + cli["launches"]["fused_attention"]
                     + s384["launches"]["fused_attention"] + dist[0]
                     + collab["launches"][0] + remat["launches"]["fused_attention"]
                     + orbax["launches"][0]),
        # every shape checked: [kernel]'s up to B 256, stage 3's B 4096, [heads],
        # past 256 keys
        "max_abs_err": max(max_abs_err, stage3["shrink"]["attention"]["max_abs_err"],
                           hm["fwd"], bl["fwd"]),
        "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"], "library_ms": fa["library_ms"]}, {
        "name": "attention_bwd", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/attention_bwd.cu",
        "replaces": "devit_tpu/kernels/attention.py:238",
        "launches": (train["launches"]["attention_bwd"] + ens["launches"]["attention_bwd"]
                     + dekd["launches"]["attention_bwd"]
                     + times["data_train"]["launches"]["attention_bwd"]
                     + cli["launches"]["attention_bwd"] + s384["launches"]["attention_bwd"]
                     + dist[1] + remat["launches"]["attention_bwd"] + orbax["launches"][1]),
        "max_abs_err": max(bwd_max_abs_err, hm["bwd"], bl["attention_bwd"],
                           bl["attention_bwd_split"]),
        "ms": bw["ms"], "plain_ms": bw["plain_ms"], "bound_ms": bw["bound_ms"],
        "bound_by": bw["bound_by"], "library_ms": bw["library_ms"]}] + [{
        # per stage-5 step (48 launches at B 64, kh 6); the library yardstick
        # is SDPA's whole backward, for the pair
        "name": f"attention_bwd_{k}", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/attention_bwd_split.cu",
        "replaces": f"devit_tpu/kernels/attention.py:{line}",
        "launches": ens["launches"][f"attention_bwd_{k}"] + dist[i],
        "max_abs_err": max(split_max_abs_err[k], hm[k], bl[f"attention_bwd_{k}"]),
        "ms": es[k]["ms"], "plain_ms": es[k]["plain_ms"], "bound_ms": es[k]["bound_ms"],
        "bound_by": es[k]["bound_by"], "library_ms": es[k]["library_ms"]}
        for i, k, line in ((2, "dv", 306), (3, "dqdk", 324))]}
    # the f32 routes on the tensor cores (3xTF32), timed at B 64, N 578, kh 6;
    # their main-path launches are [stage2-384]'s f32 steps and the forward
    # of [orbax]'s JAX-written checkpoint
    f32_launches = list(s384["launches_by_dtype"]["float32"])
    f32_launches[0] += orbax["fixture"]["launches"]
    al, blt = times["attn_long"], times["bwd_long"]
    record["kernels"] += [{
        "name": name, "route": "cuda", "source": f"devit_tpu_torch/kernels/csrc/{src}",
        "replaces": f"devit_tpu/kernels/attention.py:{line}", "launches": f32_launches[i],
        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        for i, name, src, line, err, t in (
            (0, "fused_attention f32 (attn_long_tf32)", "attention.cu", 30,
             max(al["max_abs"]["fwd f32"], blt["max_abs"]["fwd f32"]), al["times"]["fwd float32"]),
            (1, "attention_bwd f32 (attn_bwd_long_rows_tf32 + attn_bwd_long_keys_tf32)",
             "attention_bwd_long.cu", 238,
             max(al["max_abs"]["bwd f32"], blt["max_abs"]["attention_bwd f32"],
                 blt["max_abs"]["attention_bwd_split f32"]),
             blt["times"]["attention_bwd float32"]))]
    # past head width 128 in both dtypes (attn_wide_mma; the pair
    # attn_bwd_wide_rows_mma + attn_bwd_wide_keys_mma), timed at B 64, N 578,
    # kh 4, dh 192; their main-path launches are [stage2-wide]'s
    dhw = ATTN_WIDE_TIME[0][3]
    record["kernels"] += [{
        "name": f"{name} {tag} past head width 128 ({kern})", "route": "cuda",
        "source": f"devit_tpu_torch/kernels/csrc/{src}",
        "replaces": f"devit_tpu/kernels/attention.py:{line}",
        "launches": swide[dt]["launches"][i],
        "max_abs_err": al["max_abs"][f"wide {step}" + ("" if tag == "bf16" else " f32")],
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for tag, dt in (("bf16", "bfloat16"), ("f32", "float32"))
        for i, name, step, kern, src, line in (
            (0, "fused_attention", "fwd", "attn_wide_mma", "attention.cu", 30),
            (1, "attention_bwd", "bwd", "attn_bwd_wide_rows_mma + attn_bwd_wide_keys_mma",
             "attention_bwd_long.cu", 238))
        for t in (al["times"][f"dh{dhw} {step} {dt}"],)]
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
    # the block half's chunked route, every product on the tensor cores: at
    # f32 (3xTF32) per bs256 forward's 48 calls; at bf16 per 384-px bs64
    # forward's 48 calls (N 578); their main paths are [block-attn]'s
    # forwards through that route
    bl32, b384 = times["int8"]["block_forward_f32"], block["time_384"]
    record["kernels"] += [{
        "name": f"fused_block_attention {tag} chunked route ({kern})", "route": "cuda",
        "source": "devit_tpu_torch/kernels/csrc/block_attention.cu",
        "replaces": "devit_tpu/kernels/attention.py:133",
        "launches": block["chunked"][key]["launches"],
        "max_abs_err": al["max_abs"][f"block{suffix}"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}
        for tag, key, suffix, t, kern in (
            ("f32", "f32", " f32", bl32,
             "block_gemm_tf32<LN> + attn_long_tf32 + block_gemm_tf32<proj>"),
            ("bf16", "bf16 384px", "", b384,
             "block_ln_qkv_mma + attn_long_mma + block_proj_kernel"))]
    # the GELU pair at the 224-px stage-2 hidden tensor; its launches are
    # [train]'s main path, counted and checked step by step (24 + 12 a step);
    # max_abs_err: the forward's largest gap to the chain, the backward's f32
    # error against f64, each over [gelu]'s checks
    gt = gelu_times["times"]["x".join(map(str, GELU_SHAPES[0]))]
    record["kernels"] += [{
        "name": name, "route": "cuda", "source": "devit_tpu_torch/kernels/csrc/gelu.cu",
        "replaces": None, "launches": train["launches"][key], "max_abs_err": gelu_times[err],
        **{k: gt[step][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, key, step, err in (
            ("fused_gelu (gelu_as_fwd)", "fused_gelu", "fwd", "fwd_err"),
            ("fused_gelu_bwd (gelu_as_bwd)", "fused_gelu_bwd", "bwd", "bwd_err"))]
    times["gelu"] = gelu_times
    # the dispatch and combine at the V-MoE cell's group (the gather's time
    # is the dispatch's, the combine's the weighted forward's; the other
    # calls are in times["moe"]); launches: [moe]'s two main-path steps;
    # max_abs_err: the largest gap to the eager path over [moe]'s checks
    record["kernels"] += [{
        "name": name, "route": "cuda", "source": "devit_tpu_torch/kernels/csrc/moe.cu",
        "replaces": None, "launches": moe_times["launches"][i], "max_abs_err": moe_times[err],
        **{k: moe_times["times"][call][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for i, name, call, err in (
            (0, "moe_gather (moe_gather_rows)", "gather", "gather_err"),
            (1, "moe_combine (moe_combine_rows)", "combine", "combine_err"))]
    times["moe"] = moe_times
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
