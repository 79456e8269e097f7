"""The yardstick's operation and byte counts against hand counts, the
kernel classes against the port's kernel names, and the busy-time union."""

import json
from pathlib import Path

import pytest

from benchmark.drivers._serving import padded_rows
from benchmark.metrics import _counts, _kernels

BENCH = Path(__file__).resolve().parents[1]
ENS4 = json.loads((BENCH / "configs" / "dedeit_ens4.json").read_text())
STAGE2 = json.loads((BENCH / "configs" / "dedeit_stage2.json").read_text())


def test_deployed_ensemble_flops_per_image():
    # the compact shapes' count, as the port's chip_smoke.py prints it
    assert _counts.ensemble_flops_per_image(ENS4) / 1e9 == pytest.approx(23.214, abs=5e-4)


def test_compact_widths_follow_the_compaction():
    widths = _counts.compact_widths(ENS4)
    heads = [kh for layers in widths for kh, _ in layers]
    # a layer without heads keeps one zero head: the kept-head mix of the deployed divisions
    assert {k: heads.count(k) for k in set(heads)} == {1: 9, 2: 4, 3: 6, 4: 12, 5: 17}
    assert widths[0][0] == (4, 896) and widths[0][1] == (1, 896)


@pytest.mark.parametrize("img, gflop", [(224, 9.246), (384, 31.04)])
def test_full_dedeit_forward_flops(img, gflop):
    cfg = {**STAGE2, "img_size": img}
    assert _counts.vit_flops_per_image(cfg) / 1e9 == pytest.approx(gflop, abs=5e-3)


def test_attention_bounds_by_hand():
    # one bs256 deployed forward: bytes-bound, 4 B N kh dh x 2 bytes over 3.35 TB/s, 168 heads
    per_head = 4 * 256 * 198 * 64 * 2 / 3.35e12
    assert _counts.ensemble_attention_bound_s(ENS4, 256) == pytest.approx(168 * per_head)
    assert _counts.ensemble_attention_bound_s(ENS4, 256) * 1e3 == pytest.approx(1.301, abs=1e-3)
    # a 224-px stage-2 step: 12 x (46.5 us forward + 81.3 us backward), both bytes-bound
    assert _counts.train_attention_bound_s(STAGE2, 256) * 1e3 == pytest.approx(1.534, abs=1e-3)
    # 384 px, B 64: the forward bytes-bound, the backward operations-bound
    cfg = {**STAGE2, "img_size": 384}
    fwd = 4 * 64 * 578 * 384 * 2 / 3.35e12
    bwd = 10 * 64 * 578 ** 2 * 384 / 989e12
    assert _counts.train_attention_bound_s(cfg, 64) == pytest.approx(12 * (fwd + bwd))
    assert (fwd * 1e3, bwd * 1e3) == pytest.approx((0.0339, 0.0830), abs=1e-4)


@pytest.mark.parametrize("name, kind", [
    ("void (anonymous namespace)::attn_kernel_mma<13, 64>(__nv_bfloat16 const*, ...)",
     "attention"),
    ("void attn_long_tf32<32>(float const*, float*, int, int, int, float)", "attention"),
    ("void attn_wide_mma<__nv_bfloat16, 256>(...)", "attention"),
    ("void attn_bwd_kernel_mma<true, true>(...)", "attention"),
    ("attn_bwd_long_rows_tf32", "attention"), ("attn_bwd_long_keys_mma", "attention"),
    ("attn_bwd_wide_keys_mma", "attention"), ("block_qkv_attn_kernel", "attention"),
    ("pytorch_flash::flash_fwd_kernel<...>", "attention"), ("fmha_cutlassF_bf16", "attention"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>", "gemm"),
    ("quant_mma_kernel", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl>",
     "other"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::BFloat16>>", "other"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"), ("Memset (Device)", "copy"),
])
def test_kernel_classes(name, kind):
    assert _kernels.kind(name) == kind


def test_busy_time_is_the_union_of_intervals():
    spans = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert _kernels.busy(spans, 0.0, 10.0) == pytest.approx(4.0 + 1.0)
    assert _kernels.gaps(spans, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert _kernels.busy([], 0.0, 1.0) == 0.0


@pytest.mark.parametrize("rows, padded", [(1, 1), (2, 8), (9, 32), (100, 128), (129, 256),
                                          (256, 256), (300, 256 + 128), (513, 512 + 1)])
def test_bucket_padding(rows, padded):
    assert padded_rows(rows, (1, 8, 32, 128, 256)) == padded
