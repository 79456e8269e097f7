"""The port's CUDA kernels on the card: fused_attention, attention_bwd, the
split pair attention_bwd_dv / attention_bwd_dqdk, fused_int8_matmul and
fused_block_attention (the hand-written kernels in
devit_tpu_torch/kernels/csrc/attention.cu, attention_bwd.cu,
attention_bwd_split.cu, quant_matmul.cu and block_attention.cu) vs their
plain PyTorch versions, their launch counters and what their wrappers
reject; the backwards past 256 keys (their chunked path), the split pair
equal to the monolithic kernel bit for bit, every kernel at sequence
lengths and head widths past one block's shared memory (the key-chunked
paths), and normalize on the card.

Needs an NVIDIA GPU with nvcc (sm_90a); elsewhere every test skips. The
machine with the card has no JAX, so run without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from devit_tpu_torch.data.pipeline import normalize
from devit_tpu_torch.kernels.attention import (
    attention_bwd, attention_bwd_dqdk, attention_bwd_dv, attention_bwd_split,
    fused_attention, fused_block_attention, kernel_head_dim, make_trainable_attention,
    reference_attention,
    reference_attention_bwd, reference_attention_bwd_dqdk, reference_attention_bwd_dv,
    reference_block_attention,
)
from devit_tpu_torch.kernels.quant import (QuantizedLinear, dynamic_int8_matmul,
                                           fused_int8_matmul, quantize_weight)

pytestmark = pytest.mark.cuda

N, DH = 198, 64
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # max|got-want| / max|want|
# (head_dim, heads) past the widest instantiation (128), which the wrappers
# once rejected: they run on the wide tensor-core kernels (csrc/wide.cuh)
BAD_DH = ((256, 1),)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests hold the plain version")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, want):
    # floored: at N = 1 the softmax is constant, so dq and dk are exactly 0
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-12))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kh", [1, 2, 3, 4, 5, 6])
def test_kernel_matches_plain(gen, kh, dtype):
    for B in (1, 7):
        x = torch.randn((B, N, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
        gate = torch.rand((kh,), generator=gen, device="cuda")
        for g in (None, gate):
            got = fused_attention(x, g, num_heads=kh)
            torch.cuda.synchronize()
            assert _rel(got, reference_attention(x, g, num_heads=kh)) <= TOL[dtype]


def test_randomized_shape_sweep(gen):
    """Sequence lengths around the 64-row query tile and up to the f32
    shared-memory limit, odd batches and head counts, gated and not: the
    kernel's own index arithmetic, which no fixed shape covers."""
    rng = torch.Generator().manual_seed(99)
    lengths = [1, 63, 64, 65, 257] + torch.randint(2, 280, (7,), generator=rng).tolist()
    for trial, n in enumerate(lengths):
        B = int(torch.randint(1, 10, (1,), generator=rng))
        kh = int(torch.randint(1, 7, (1,), generator=rng))
        dtype = (torch.float32, torch.bfloat16)[trial % 2]
        x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
        gate = (torch.rand((kh,), generator=gen, device="cuda") if trial % 3 else None)
        got = fused_attention(x, gate, num_heads=kh)
        torch.cuda.synchronize()
        rel = _rel(got, reference_attention(x, gate, num_heads=kh))
        assert rel <= TOL[dtype], f"trial {trial}: B{B} N{n} kh{kh} {dtype}: {rel:.3e}"


def test_launch_counter_counts_kernel_launches_only(gen):
    x = torch.randn((1, N, 3 * DH), generator=gen, device="cuda").bfloat16()
    before = fused_attention.launches
    fused_attention(x, num_heads=1)
    reference_attention(x, num_heads=1)
    assert fused_attention.launches == before + 1


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    """What the wrapper rejects (a dtype, a non-contiguous qkv), and what it
    once rejected and now computes: head_dim 256 and an f32 N 4096, past
    one block's shared memory, on the key-chunked kernel."""
    for dh, kh in BAD_DH:
        x = torch.randn((1, N, 3 * kh * dh), generator=gen, device="cuda")
        assert _rel(fused_attention(x, num_heads=kh),
                    reference_attention(x, num_heads=kh)) <= TOL[torch.float32]
    x = torch.randn((1, N, 3 * 4 * 32), generator=gen, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        fused_attention(x.half(), num_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(torch.zeros((2, N, 3 * DH), device="cuda").transpose(0, 1),
                        num_heads=1)
    x = torch.randn((1, 4096, 3 * DH), generator=gen, device="cuda")
    assert _rel(fused_attention(x, num_heads=1),
                reference_attention(x, num_heads=1)) <= TOL[torch.float32]


# ---- the backward kernel: attention_bwd (csrc/attention_bwd.cu)


def _bwd_errs(got, want, C):
    """max-abs over max-ref of dq, dk and dv, each on its own."""
    return [_rel(got[..., i * C:(i + 1) * C], want[..., i * C:(i + 1) * C]) for i in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kh", [1, 3, 6, 12])
def test_bwd_kernel_matches_plain(gen, kh, dtype):
    for n in (197, 198):
        for B in (1, 7):
            x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
            g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").to(dtype)
            got = attention_bwd(x, g, kh)
            torch.cuda.synchronize()
            errs = _bwd_errs(got, reference_attention_bwd(x, g, kh), kh * DH)
            assert max(errs) <= TOL[dtype], (n, B, errs)


def test_bwd_randomized_shape_sweep(gen):
    """Sequence lengths around the 32-row query tile and the 16-row key
    stripes of a warp, up to the 256 the kernel takes, odd batches and head
    counts: the kernel's own index arithmetic, which no fixed shape covers."""
    rng = torch.Generator().manual_seed(7)
    lengths = [1, 15, 17, 31, 32, 33, 256] + torch.randint(2, 257, (6,), generator=rng).tolist()
    for trial, n in enumerate(lengths):
        B = int(torch.randint(1, 6, (1,), generator=rng))
        kh = int(torch.randint(1, 7, (1,), generator=rng))
        dtype = (torch.float32, torch.bfloat16)[trial % 2]
        x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").to(dtype)
        got = attention_bwd(x, g, kh)
        torch.cuda.synchronize()
        errs = _bwd_errs(got, reference_attention_bwd(x, g, kh), kh * DH)
        assert max(errs) <= TOL[dtype], f"trial {trial}: B{B} N{n} kh{kh} {dtype}: {errs}"


def test_bwd_is_deterministic_and_counted(gen):
    x = torch.randn((3, N, 3 * 2 * DH), generator=gen, device="cuda").bfloat16()
    g = torch.randn((3, N, 2 * DH), generator=gen, device="cuda").bfloat16()
    before = attention_bwd.launches
    a, b = attention_bwd(x, g, 2), attention_bwd(x, g, 2)
    reference_attention_bwd(x, g, 2)
    assert attention_bwd.launches == before + 2
    assert torch.equal(a, b)  # no atomics: the same bits on every run


def test_function_gradient_matches_autograd_through_plain(gen):
    """tests/test_kernels.py:100-117 on the card: the Function's gradient
    (both kernels) vs autograd through reference_attention."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, N, 3 * 6 * DH), generator=gen, device="cuda").to(dtype)
        cot = torch.randn((2, N, 6 * DH), generator=gen, device="cuda")
        x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
        (g1,) = torch.autograd.grad((make_trainable_attention(6)(x1).float() * cot).sum(), x1)
        (g2,) = torch.autograd.grad(
            (reference_attention(x2, num_heads=6).float() * cot).sum(), x2)
        assert max(_bwd_errs(g1, g2, 6 * DH)) <= TOL[dtype]


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(gen):
    for dh, kh in BAD_DH:  # once rejected: now the long path's wide kernels
        x = torch.randn((1, N, 3 * kh * dh), generator=gen, device="cuda")
        g = torch.randn((1, N, kh * dh), generator=gen, device="cuda")
        errs = _bwd_errs(attention_bwd(x, g, kh), reference_attention_bwd(x, g, kh), kh * dh)
        assert max(errs) <= TOL[torch.float32], errs
    x = torch.randn((1, N, 3 * 4 * 32), generator=gen, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        attention_bwd(x.half(), torch.zeros((1, N, 2 * 64), device="cuda").half(), 2)
    with pytest.raises(ValueError, match="must divide"):
        attention_bwd(x, torch.zeros((1, N, 4 * 32), device="cuda"), 5)


# ---- the bf16 tensor-core paths of fused_attention and attention_bwd: the
# m16/n8/k16 fragment edges, the zero-fill past N, the 64-query tile of the
# forward, the 32-query tile and the 16-key warp stripes of the backward

EDGE_N = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 197, 198, 255, 256]


@pytest.mark.parametrize("n", EDGE_N)
def test_bf16_forward_tile_edges(gen, n):
    for kh in (1, 6, 12):
        for B in (1, 7, 64):
            x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").bfloat16()
            got = fused_attention(x, num_heads=kh)
            torch.cuda.synchronize()
            rel = _rel(got, reference_attention(x, num_heads=kh))
            assert rel <= TOL[torch.bfloat16], (n, kh, B, rel)


@pytest.mark.parametrize("n", EDGE_N)
def test_bf16_bwd_tile_edges(gen, n):
    for kh in (1, 6, 12):
        for B in (1, 7, 64):
            x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").bfloat16()
            g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").bfloat16()
            got = attention_bwd(x, g, kh)
            torch.cuda.synchronize()
            errs = _bwd_errs(got, reference_attention_bwd(x, g, kh), kh * DH)
            assert max(errs) <= TOL[torch.bfloat16], (n, kh, B, errs)


@pytest.mark.parametrize("n", [257, 271, 279, 300, 384, 512, 700])
def test_bf16_forward_past_256(gen, n):
    """Past 256 keys the forward walks key chunks twice (the online max and
    sum, then p . v), the path the deployed N never takes."""
    for kh, B in ((1, 3), (6, 2), (12, 1)):
        x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").bfloat16()
        gate = torch.rand((kh,), generator=gen, device="cuda")
        got = fused_attention(x, gate, num_heads=kh)
        torch.cuda.synchronize()
        rel = _rel(got, reference_attention(x, gate, num_heads=kh))
        assert rel <= TOL[torch.bfloat16], (n, kh, B, rel)


def test_bf16_kernels_repeat_bit_for_bit(gen):
    for n in (198, 256, 300):
        x = torch.randn((5, n, 3 * 6 * DH), generator=gen, device="cuda").bfloat16()
        g = torch.randn((5, n, 6 * DH), generator=gen, device="cuda").bfloat16()
        assert torch.equal(fused_attention(x, num_heads=6), fused_attention(x, num_heads=6))
        assert torch.equal(attention_bwd(x, g, 6), attention_bwd(x, g, 6))
        assert torch.equal(attention_bwd_split(x, g, 6), attention_bwd_split(x, g, 6))


def test_bf16_forward_at_the_candidate_chunk_rows(gen):
    """B 4096 (stage 3's chunk of 8 candidates x 512 images folded into the
    batch), kh 6, N 198: the row-tile walk past B*H 24576, gated and not,
    each launch repeated bit for bit."""
    x = torch.randn((4096, N, 3 * 6 * DH), generator=gen, device="cuda").bfloat16()
    gate = torch.rand((6,), generator=gen, device="cuda")
    for g in (None, gate):
        got = fused_attention(x, g, num_heads=6)
        assert torch.equal(got, fused_attention(x, g, num_heads=6))
        rel = _rel(got, reference_attention(x, g, num_heads=6))
        assert rel <= TOL[torch.bfloat16], (g is None, rel)


def test_bf16_wrappers_reject_unaligned_operands(gen):
    buf = torch.zeros(1 + 2 * N * 3 * DH, device="cuda").bfloat16()
    x = buf[1:].view(2, N, 3 * DH)  # contiguous, 2 bytes past an aligned start
    with pytest.raises(ValueError, match="aligned"):
        fused_attention(x, num_heads=1)
    for fn in (attention_bwd, attention_bwd_dv, attention_bwd_dqdk, attention_bwd_split):
        with pytest.raises(ValueError, match="aligned"):
            fn(x, torch.zeros((2, N, DH), device="cuda").bfloat16(), 1)


def test_f32_wrappers_reject_unaligned_operands(gen):
    """The f32 kernels stage head rows with 16-byte cp.async too (3xTF32)."""
    buf = torch.zeros(1 + 2 * N * 3 * DH, device="cuda")
    x = buf[1:].view(2, N, 3 * DH)  # contiguous, 4 bytes past an aligned start
    with pytest.raises(ValueError, match="aligned"):
        fused_attention(x, num_heads=1)
    for fn in (attention_bwd, attention_bwd_dv, attention_bwd_dqdk, attention_bwd_split):
        with pytest.raises(ValueError, match="aligned"):
            fn(x, torch.zeros((2, N, DH), device="cuda"), 1)


# ---- the split backward: attention_bwd_dv, attention_bwd_dqdk (csrc/attention_bwd_split.cu)


def _split_errs(x, g, kh):
    """max-abs over max-ref of dq, dk (the dqdk kernel) and dv (the dv
    kernel), each against its plain version."""
    C = g.shape[-1]
    dqdk, dv = attention_bwd_dqdk(x, g, kh), attention_bwd_dv(x, g, kh)
    torch.cuda.synchronize()
    want_qk, want_v = reference_attention_bwd_dqdk(x, g, kh), reference_attention_bwd_dv(x, g, kh)
    return [_rel(dqdk[..., :C], want_qk[..., :C]), _rel(dqdk[..., C:], want_qk[..., C:]),
            _rel(dv, want_v)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kh", [1, 3, 6, 12])
def test_split_kernels_match_plain(gen, kh, dtype):
    for n in (197, 198):
        for B in (1, 7):
            x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
            g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").to(dtype)
            assert max(_split_errs(x, g, kh)) <= TOL[dtype], (n, B)


def test_split_randomized_shape_sweep(gen):
    """Sequence lengths around the 32-row query tile and the 64-row key tile
    of the f32 dv block and the 16-key warp stripes of the bf16 kernels, up
    to the 256 where the chunked path takes over: the kernels' own index
    arithmetic, which no fixed shape covers."""
    rng = torch.Generator().manual_seed(8)
    lengths = [1, 31, 33, 63, 64, 65, 129, 256] + torch.randint(2, 257, (5,), generator=rng).tolist()
    for trial, n in enumerate(lengths):
        B = int(torch.randint(1, 6, (1,), generator=rng))
        kh = int(torch.randint(1, 7, (1,), generator=rng))
        dtype = (torch.float32, torch.bfloat16)[trial % 2]
        x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").to(dtype)
        errs = _split_errs(x, g, kh)
        assert max(errs) <= TOL[dtype], f"trial {trial}: B{B} N{n} kh{kh} {dtype}: {errs}"


def test_split_matches_monolithic_is_deterministic_and_counted(gen):
    x = torch.randn((5, N, 3 * 6 * DH), generator=gen, device="cuda").bfloat16()
    g = torch.randn((5, N, 6 * DH), generator=gen, device="cuda").bfloat16()
    before = (attention_bwd.launches, attention_bwd_dv.launches, attention_bwd_dqdk.launches)
    a, b = attention_bwd_split(x, g, 6), attention_bwd_split(x, g, 6)
    assert (attention_bwd.launches, attention_bwd_dv.launches,
            attention_bwd_dqdk.launches) == (before[0], before[1] + 2, before[2] + 2)
    assert torch.equal(a, b)  # no atomics: the same bits on every run
    mono = attention_bwd(x, g, 6)
    torch.cuda.synchronize()
    assert max(_bwd_errs(a, mono, 6 * DH)) <= TOL[torch.bfloat16]
    # the slices of one buffer equal the kernels' standalone outputs
    C = 6 * DH
    assert torch.equal(a[..., :2 * C], attention_bwd_dqdk(x, g, 6))
    assert torch.equal(a[..., 2 * C:], attention_bwd_dv(x, g, 6))


def test_split_function_gradient_matches_autograd_through_plain(gen, monkeypatch):
    monkeypatch.setenv("DEVIT_ATTN_BWD", "split")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, N, 3 * 6 * DH), generator=gen, device="cuda").to(dtype)
        cot = torch.randn((2, N, 6 * DH), generator=gen, device="cuda")
        x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
        before = (attention_bwd.launches, attention_bwd_dv.launches)
        (g1,) = torch.autograd.grad((make_trainable_attention(6)(x1).float() * cot).sum(), x1)
        assert attention_bwd.launches == before[0]  # the environment chose the split pair
        assert attention_bwd_dv.launches == before[1] + 1
        (g2,) = torch.autograd.grad(
            (reference_attention(x2, num_heads=6).float() * cot).sum(), x2)
        assert max(_bwd_errs(g1, g2, 6 * DH)) <= TOL[dtype]


def test_split_wrappers_reject_what_the_kernels_do_not_take(gen):
    x = torch.randn((1, N, 3 * 4 * 32), generator=gen, device="cuda")
    for fn in (attention_bwd_dv, attention_bwd_dqdk, attention_bwd_split):
        for dh, kh in BAD_DH:  # once rejected: the split pair equals the monolithic kernel
            xw = torch.randn((1, N, 3 * kh * dh), generator=gen, device="cuda")
            gw = torch.randn((1, N, kh * dh), generator=gen, device="cuda")
            mono = attention_bwd(xw, gw, kh)
            C = kh * dh
            part = {attention_bwd_dv: mono[..., 2 * C:], attention_bwd_dqdk: mono[..., :2 * C],
                    attention_bwd_split: mono}[fn]
            assert torch.equal(fn(xw, gw, kh), part), fn.__name__
        with pytest.raises(TypeError, match="bfloat16"):
            fn(x.half(), torch.zeros((1, N, 2 * 64), device="cuda").half(), 2)
        with pytest.raises(ValueError, match="g must be"):
            fn(x, torch.zeros((1, N, 2 * 64), device="cuda").bfloat16(), 2)
    for fn in (attention_bwd_dv, attention_bwd_dqdk, attention_bwd_split):
        with pytest.raises(ValueError, match="must divide"):
            fn(x, torch.zeros((1, N, 4 * 32), device="cuda"), 5)


@pytest.mark.parametrize("n", EDGE_N)
def test_split_equals_monolithic_bit_for_bit(gen, n):
    """The split pair runs the monolithic kernel's steps on the same
    operands in the same order (bwd_mma.cuh at bf16, the 3xTF32 long path of
    long_tf32.cuh at f32): the same bits at every N up to 256."""
    for dtype in (torch.bfloat16, torch.float32):
        for kh in (1, 6, 12):
            for B in (1, 7):
                x = torch.randn((B, n, 3 * kh * DH), generator=gen, device="cuda").to(dtype)
                g = torch.randn((B, n, kh * DH), generator=gen, device="cuda").to(dtype)
                split, mono = attention_bwd_split(x, g, kh), attention_bwd(x, g, kh)
                torch.cuda.synchronize()
                assert torch.equal(split, mono), (dtype, kh, B, max(_bwd_errs(split, mono,
                                                                              kh * DH)))


# ---- past 256 keys: the chunked path of all four backward wrappers
# (csrc/attention_bwd_long.cu)

LONG_N = [257, 258, 300, 578, 700, 1026]  # 1026: 512 px at patch 16, two tokens


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", LONG_N)
def test_bwd_past_256(gen, n, dtype):
    """attention_bwd, attention_bwd_split, attention_bwd_dqdk and
    attention_bwd_dv vs their plain versions, dq, dk and dv each on its own,
    and a repeat launch of each bit for bit."""
    for kh, B in ((1, 3), (6, 2), (12, 1)):
        C = kh * DH
        x = torch.randn((B, n, 3 * C), generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, n, C), generator=gen, device="cuda").to(dtype)
        want = reference_attention_bwd(x, g, kh)
        want_split = torch.cat([reference_attention_bwd_dqdk(x, g, kh),
                                reference_attention_bwd_dv(x, g, kh)], dim=-1)
        for fn, ref in ((attention_bwd, want), (attention_bwd_split, want_split)):
            got = fn(x, g, kh)
            torch.cuda.synchronize()
            errs = _bwd_errs(got, ref, C)
            assert max(errs) <= TOL[dtype], (fn.__name__, kh, B, errs)
            assert torch.equal(got, fn(x, g, kh)), fn.__name__
        errs = _split_errs(x, g, kh)
        assert max(errs) <= TOL[dtype], ("dqdk/dv", kh, B, errs)
        dv, dqdk = attention_bwd_dv(x, g, kh), attention_bwd_dqdk(x, g, kh)
        assert torch.equal(dv, attention_bwd_dv(x, g, kh))
        assert torch.equal(dqdk, attention_bwd_dqdk(x, g, kh))
        mono = attention_bwd(x, g, kh)
        assert torch.equal(attention_bwd_split(x, g, kh), mono), (kh, B)
        assert torch.equal(dqdk, mono[..., :2 * C]) and torch.equal(dv, mono[..., 2 * C:])


# bf16 head widths 32 and 128 past 256 keys, and dh 128 from N 209, where its
# monolithic block does not fit and every backward takes the long path
LONG_DH_CASES = ([(n, dh) for n in LONG_N for dh in (32, 128)]
                 + [(n, 128) for n in (209, 240, 256)])


@pytest.mark.parametrize("n, dh", LONG_DH_CASES)
def test_bf16_long_path_head_widths(gen, n, dh):
    """The bf16 tensor-core long path (attn_bwd_long_rows_mma,
    attn_bwd_long_keys_mma; attn_long_mma past 256 keys) at dh 32 and 128:
    each backward wrapper within 2e-2 of its plain version (dq, dk, dv each),
    a repeat bit for bit, the split pair, dq/dk and dv equal to the
    monolithic backward bit for bit; the forward within 2e-2, repeats bit
    for bit."""
    for kh, B in ((1, 3), (6, 2)):
        C = kh * dh
        x = torch.randn((B, n, 3 * C), generator=gen, device="cuda").bfloat16()
        g = torch.randn((B, n, C), generator=gen, device="cuda").bfloat16()
        mono = attention_bwd(x, g, kh)
        torch.cuda.synchronize()
        errs = _bwd_errs(mono, reference_attention_bwd(x, g, kh), C)
        assert max(errs) <= TOL[torch.bfloat16], (kh, B, errs)
        assert torch.equal(mono, attention_bwd(x, g, kh))
        split = attention_bwd_split(x, g, kh)
        dqdk, dv = attention_bwd_dqdk(x, g, kh), attention_bwd_dv(x, g, kh)
        assert torch.equal(split, mono), (kh, B)
        assert torch.equal(dqdk, mono[..., :2 * C]) and torch.equal(dv, mono[..., 2 * C:])
        assert torch.equal(dv, attention_bwd_dv(x, g, kh))
        assert torch.equal(dqdk, attention_bwd_dqdk(x, g, kh))
        if n > 256:
            fwd = fused_attention(x, num_heads=kh)
            torch.cuda.synchronize()
            assert _rel(fwd, reference_attention(x, num_heads=kh)) <= TOL[torch.bfloat16]
            assert torch.equal(fwd, fused_attention(x, num_heads=kh))


# f32 on the tensor cores (3xTF32: attn_long_tf32, attn_bwd_long_rows_tf32,
# attn_bwd_long_keys_tf32) at every N: the stage shapes' N 198 and past 256
# keys, every instantiated head width
F32_CASES = [(n, dh) for n in (198, 258, 578, 1026) for dh in (32, 64, 128)]
F32_KH = {32: 12, 64: 6, 128: 6}  # C 384, 384 and 768, as chip_smoke.py's [heads]


@pytest.mark.parametrize("n, dh", F32_CASES)
def test_f32_tensor_core_paths(gen, n, dh):
    """The f32 forward and each backward wrapper within 1e-4 of their plain
    versions (dq, dk and dv each), every repeat bit for bit, and the split
    pair, dq/dk and dv equal to the monolithic backward bit for bit."""
    kh, B = F32_KH[dh], 2
    C = kh * dh
    x = torch.randn((B, n, 3 * C), generator=gen, device="cuda")
    g = torch.randn((B, n, C), generator=gen, device="cuda")
    fwd, mono = fused_attention(x, num_heads=kh), attention_bwd(x, g, kh)
    torch.cuda.synchronize()
    assert _rel(fwd, reference_attention(x, num_heads=kh)) <= TOL[torch.float32]
    errs = _bwd_errs(mono, reference_attention_bwd(x, g, kh), C)
    assert max(errs) <= TOL[torch.float32], errs
    assert max(_split_errs(x, g, kh)) <= TOL[torch.float32]
    assert torch.equal(fwd, fused_attention(x, num_heads=kh))
    assert torch.equal(mono, attention_bwd(x, g, kh))
    dqdk, dv = attention_bwd_dqdk(x, g, kh), attention_bwd_dv(x, g, kh)
    assert torch.equal(attention_bwd_split(x, g, kh), mono)
    assert torch.equal(dqdk, mono[..., :2 * C]) and torch.equal(dv, mono[..., 2 * C:])
    assert torch.equal(dqdk, attention_bwd_dqdk(x, g, kh))
    assert torch.equal(dv, attention_bwd_dv(x, g, kh))


@pytest.mark.parametrize("mode", ["monolithic", "split"])
def test_trainable_attention_past_256(gen, mode):
    """make_trainable_attention at N 258 (256 px at patch 16, two tokens):
    its gradient vs autograd through reference_attention."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, 258, 3 * 6 * DH), generator=gen, device="cuda").to(dtype)
        cot = torch.randn((2, 258, 6 * DH), generator=gen, device="cuda")
        x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
        (g1,) = torch.autograd.grad((make_trainable_attention(6, mode)(x1).float() * cot).sum(),
                                    x1)
        (g2,) = torch.autograd.grad(
            (reference_attention(x2, num_heads=6).float() * cot).sum(), x2)
        errs = _bwd_errs(g1, g2, 6 * DH)
        assert max(errs) <= TOL[dtype], (dtype, errs)


def test_normalize_on_the_card_equals_the_cpu(gen):
    """Every uint8 value in every channel: the division by 255 on the card is
    the IEEE quotient the CPU (and JAX) compute, not a product with the
    reciprocal."""
    imgs = torch.arange(256, dtype=torch.uint8).reshape(1, 16, 16, 1).repeat(2, 1, 1, 3)
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(normalize(imgs.cuda(), dtype).cpu(), normalize(imgs, dtype))


# ---- the int8 matmul: fused_int8_matmul (csrc/quant_matmul.cu)


def _int8_case(gen, M, K, N, x_dtype, with_bias):
    w = torch.randn((K, N), generator=gen, device="cuda")
    b = torch.randn((N,), generator=gen, device="cuda") if with_bias else None
    x = torch.randn((M, K), generator=gen, device="cuda")
    x = (x * torch.rand((M, 1), generator=gen, device="cuda") * 10).to(x_dtype)
    return x, quantize_weight(w, b)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_kernel_bit_equal_to_plain(gen, x_dtype, out_dtype, with_bias):
    """The int32 sums are exact and every f32 step is rounded as the plain
    version rounds it: the same bits. Around the GEMM's 16-row mma tiles and
    128-row blocks (M 1-129), K tails of the 32-byte mma step and the
    128-byte stage (36, 388), N tails of the 8-column tiles and 128-column
    blocks (8, 40, 200), the deployed depths and widths, and a bs256 serving
    call (M 50688)."""
    edges = [(M, K, N) for M in (1, 15, 16, 17, 127, 128, 129)
             for K, N in ((36, 8), (388, 40), (384, 200))]
    for M, K, N in edges + [(1, 384, 1152), (7, 320, 384), (198, 384, 1536),
                            (1000, 1536, 384), (67, 64, 40), (130, 388, 200),
                            (50688, 384, 1536), (50688, 1536, 384), (50688, 384, 1152)]:
        x, q = _int8_case(gen, M, K, N, x_dtype, with_bias)
        got = fused_int8_matmul(x, q, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = dynamic_int8_matmul(x, q, out_dtype)
        assert got.dtype == out_dtype and got.shape == (M, N)
        assert torch.equal(got, want), (M, K, N, float((got.float() - want.float()).abs().max()))


def test_int8_quantization_on_the_card_equals_the_cpu(gen):
    """quantize_weight and the row codes divide as IEEE on every device, so
    the card's scales and codes are the CPU's (and so the JAX package's)."""
    x, q = _int8_case(gen, 300, 384, 1152, torch.float32, True)
    w = torch.randn((384, 1152), generator=gen, device="cuda")
    a, b = quantize_weight(w), quantize_weight(w.cpu())
    assert torch.equal(a.w_q.cpu(), b.w_q) and torch.equal(a.w_scale.cpu(), b.w_scale)
    from devit_tpu_torch.kernels.quant import _quantize_rows

    (qa, sa), (qb, sb) = _quantize_rows(x), _quantize_rows(x.cpu())
    assert torch.equal(qa.cpu(), qb) and torch.equal(sa.cpu(), sb)
    cpu_q = QuantizedLinear(q.w_q.cpu(), q.w_scale.cpu(), q.bias.cpu())
    assert torch.equal(fused_int8_matmul(x, q).cpu(), dynamic_int8_matmul(x.cpu(), cpu_q))


def test_int8_kernel_is_deterministic_counted_and_reshapes(gen):
    x, q = _int8_case(gen, 2 * 7 * 198, 384, 576, torch.bfloat16, True)
    x = x.view(2, 7, 198, 384)
    before = fused_int8_matmul.launches
    a, b = fused_int8_matmul(x, q), fused_int8_matmul(x, q)
    dynamic_int8_matmul(x, q)
    assert fused_int8_matmul.launches == before + 2
    assert a.shape == (2, 7, 198, 576) and torch.equal(a, b)


def test_int8_wrapper_rejects_what_the_kernel_does_not_take(gen):
    x, q = _int8_case(gen, 4, 64, 32, torch.float32, True)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_int8_matmul(x.half(), q)
    with pytest.raises(ValueError, match="depth"):
        fused_int8_matmul(x[:, :32], q)
    x6, q6 = _int8_case(gen, 4, 6, 8, torch.float32, True)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_int8_matmul(x6, q6)
    with pytest.raises(ValueError, match="contiguous"):
        fused_int8_matmul(x, quantize_weight(torch.randn(64, 32), None))  # weights on the CPU
    # no depth limit: shared memory does not grow with K, and the int32 sums
    # stay exact (|acc| <= 64000 * 127^2 < 2^31)
    big = quantize_weight(torch.randn((64000, 8), generator=gen, device="cuda"), None)
    xb = torch.randn((3, 64000), generator=gen, device="cuda")
    assert torch.equal(fused_int8_matmul(xb, big), dynamic_int8_matmul(xb, big))


# ---- the attention half of a layer: fused_block_attention (csrc/block_attention.cu)


def _block_case(gen, B, n, kh, dtype, C=384, with_bias=True, dh=DH):
    K = kh * dh
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")
    t = r(B, n, C).to(dtype)
    w = dict(norm_scale=1 + 0.1 * r(C), norm_bias=0.1 * r(C), qkv_kernel=(0.05 * r(C, 3 * K)).to(dtype),
             qkv_bias=0.1 * r(3 * K) if with_bias else None, proj_kernel=(0.05 * r(K, C)).to(dtype),
             proj_bias=0.1 * r(C))
    return t, w


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kh", [1, 3, 5, 6])
def test_block_kernel_matches_plain(gen, kh, dtype):
    """N 198 at head widths 64 and 128 (at f32 past the N 108 that a
    whole-row block once held at width 128), and N 578 (the chunked route in
    both dtypes)."""
    for n, dh, batches in ((N, DH, (1, 7)), (N, 128, (1, 7)), (578, DH, (2,))):
        for B in batches:
            for with_bias in (True, False):
                t, w = _block_case(gen, B, n, kh, dtype, with_bias=with_bias, dh=dh)
                got = fused_block_attention(t, **w, num_heads=kh)
                torch.cuda.synchronize()
                want = reference_block_attention(t, **w, num_heads=kh)
                assert _rel(got, want) <= TOL[dtype], (n, dh, B, with_bias)


def test_block_randomized_shape_sweep(gen):
    """Sequence lengths around the 64-row tiles, widths that are not a
    multiple of the 128-column proj chunk, odd batches and head counts."""
    rng = torch.Generator().manual_seed(12)
    cases = [(1, 1, 32), (3, 63, 96), (2, 65, 160), (1, 129, 64)] + [
        (int(torch.randint(1, 5, (1,), generator=rng)), int(torch.randint(2, 227, (1,), generator=rng)),
         32 * int(torch.randint(1, 14, (1,), generator=rng))) for _ in range(5)]
    for trial, (B, n, C) in enumerate(cases):
        kh = int(torch.randint(1, 7, (1,), generator=rng))
        dtype = (torch.float32, torch.bfloat16)[trial % 2]
        t, w = _block_case(gen, B, n, kh, dtype, C=C, with_bias=trial % 3 != 0)
        got = fused_block_attention(t, **w, num_heads=kh)
        torch.cuda.synchronize()
        rel = _rel(got, reference_block_attention(t, **w, num_heads=kh))
        assert rel <= TOL[dtype], f"trial {trial}: B{B} N{n} C{C} kh{kh} {dtype}: {rel:.3e}"
    # the chunked route's GEMM tails in both dtypes: C 96 and 160 (a last
    # 64-column chunk half past C at bf16), K 160 (dh 32, five heads), dh 192
    for B, n, C, kh, dh in ((2, 578, 96, 1, 64), (1, 1100, 160, 5, 32), (2, 198, 160, 1, 192),
                            (3, 450, 384, 3, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            t, w = _block_case(gen, B, n, kh, dtype, C=C, with_bias=n % 2 == 0, dh=dh)
            got = fused_block_attention(t, **w, num_heads=kh)
            torch.cuda.synchronize()
            rel = _rel(got, reference_block_attention(t, **w, num_heads=kh))
            assert rel <= TOL[dtype], f"B{B} N{n} C{C} kh{kh} dh{dh} {dtype}: {rel:.3e}"


@pytest.mark.parametrize("dtype,n,chunked", [(torch.bfloat16, N, 0), (torch.float32, N, 1),
                                              (torch.bfloat16, 578, 1)])
def test_block_kernel_is_deterministic_and_counted(gen, dtype, n, chunked):
    """Each call counts once in `launches`, and in `chunked_launches` too on
    the three-launch route (every f32 call, bf16 past the whole-row block)."""
    t, w = _block_case(gen, 3, n, 4, dtype)
    before = fused_block_attention.launches, fused_block_attention.chunked_launches
    a, b = fused_block_attention(t, **w, num_heads=4), fused_block_attention(t, **w, num_heads=4)
    reference_block_attention(t, **w, num_heads=4)
    assert fused_block_attention.launches == before[0] + 2
    assert fused_block_attention.chunked_launches == before[1] + 2 * chunked
    assert torch.equal(a, b)  # one writer per output: the same bits on every run


@pytest.mark.parametrize("kh", [1, 2, 3, 4, 5, 6])
def test_block_kernel_bf16_tile_edges(gen, kh):
    """The bf16 tensor-core pair at sequence lengths around its 16-row mma
    tiles and 64-token qkv passes (and the attention steps' 64/128/208/256
    score widths), B 1, 7 and 64: within 2e-2 of the plain version, and a
    repeat launch gives the same bits."""
    for n in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 198, 208, 209, 255, 256):
        for B in ((1, 7, 64) if n in (17, 198, 256) else (1, 7)):
            t, w = _block_case(gen, B, n, kh, torch.bfloat16, with_bias=n % 2 == 0)
            got = fused_block_attention(t, **w, num_heads=kh)
            again = fused_block_attention(t, **w, num_heads=kh)
            torch.cuda.synchronize()
            rel = _rel(got, reference_block_attention(t, **w, num_heads=kh))
            assert rel <= TOL[torch.bfloat16] and torch.equal(got, again), (n, B, rel)


def test_block_wrapper_rejects_what_the_kernel_does_not_take(gen):
    t, w = _block_case(gen, 1, N, 2, torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_block_attention(t.half(), **w, num_heads=2)
    with pytest.raises(TypeError, match="dtype"):
        fused_block_attention(t, **{**w, "qkv_kernel": w["qkv_kernel"].bfloat16()}, num_heads=2)
    for dh, kh in BAD_DH:  # once rejected: the chunked route
        tb, wb = _block_case(gen, 1, N, kh, torch.float32, dh=dh)
        assert _rel(fused_block_attention(tb, **wb, num_heads=kh),
                    reference_block_attention(tb, **wb, num_heads=kh)) <= TOL[torch.float32]
    with pytest.raises(ValueError, match="contiguous"):
        fused_block_attention(t, **{**w, "proj_kernel": w["proj_kernel"].t().contiguous().t()},
                              num_heads=2)
    with pytest.raises(ValueError, match="multiple of 32"):
        t2, w2 = _block_case(gen, 1, 8, 1, torch.float32, C=48)
        fused_block_attention(t2, **w2, num_heads=1)
    t3, w3 = _block_case(gen, 1, 2048, 1, torch.float32, C=64)  # once past shared memory
    assert _rel(fused_block_attention(t3, **w3, num_heads=1),
                reference_block_attention(t3, **w3, num_heads=1)) <= TOL[torch.float32]


# ---- stage 3: the folded candidate forward and the HSIC scores


U32 = 2.0 ** -24  # f32's unit roundoff


def ill_conditioned_heads(seed: int = 0):
    """Head outputs (2 layers, B 16, N 198, 6 heads, dh 64, bf16, on the
    CPU) whose channel means spread ~0.0025 about 0.5: every squared distance
    is ~2.5e-3, so each Gaussian gram entry lies within ~1.3e-3 of 1 and the
    centring cancels that 1. Made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    head_out = torch.from_numpy(0.5 + 0.02 * rng.standard_normal((2, 16, N, 6, DH))).bfloat16()
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((16, 25))).float(), dim=-1)
    return head_out, probs


def head_score_bound(head_out, probs):
    """The head scores in f64, and the bound on an f32 computation's error
    relative to their max|score|. One rounding of a gram entry is u max|K|;
    the centring leaves a gram kappa = max|K| / max|centred K| times smaller,
    so a centred entry carries u kappa of relative error, and the
    redundancy's product of two such grams 2 u kappa. A score, relevance -
    0.1 redundancy, carries that on both terms:
    bound = 2 u kappa max(|relevance| + 0.1 |redundancy|) / max|score|."""
    from devit_tpu_torch.core.hsic import (_center, hsic_redundancy_matrix,
                                           hsic_relevance_many, multi_gaussian_gram)
    from devit_tpu_torch.core.rank import _head_scores

    head_out, probs = head_out.double(), probs.double()
    kappa = terms = 0.0
    for ho_l in head_out:
        xs = ho_l.mean(dim=-1).permute(2, 0, 1)  # (H, B, N), as _head_scores takes it
        K = multi_gaussian_gram(xs)  # mean_sub's shift leaves the distances as they are
        kappa = max(kappa, float(K.abs().amax() / _center(K).abs().amax()))
        red = hsic_redundancy_matrix(xs)
        off = (red.sum(dim=1) - torch.diagonal(red)) / (xs.shape[0] - 1)
        terms = max(terms, float((hsic_relevance_many(xs, probs).abs() + 0.1 * off.abs()).max()))
    want = _head_scores(head_out, probs)
    return want, 2 * U32 * kappa * terms / float(want.abs().max())


def test_folded_candidate_forward_kernel_matches_plain(gen):
    """Candidate gates folded into the batch (core/shrink.py), through the
    attention kernel against the plain attention, and against one forward
    per candidate through the kernel, bf16, dh 64."""
    import numpy as np

    from devit_tpu_torch.core.shrink import fold_candidates
    from devit_tpu_torch.models.vit import Gates, create_vit

    model = create_vit("dedeit", img_size=32, patch_size=8, embed_dim=256, depth=2,
                       num_heads=4, num_classes=7, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    C, B = 3, 5
    gates = Gates(torch.tensor((rng.random((C, 2, 4)) > 0.3).astype(np.float32)),
                  torch.tensor((rng.random((C, 2, 1024)) > 0.3).astype(np.float32)))
    x = torch.randn((B, 32, 32, 3), generator=gen, device="cuda")
    folded, xf = fold_candidates(gates, x)
    with torch.no_grad():
        before = fused_attention.launches
        got = model(xf, folded).logits
        assert fused_attention.launches == before + 2
        per = torch.cat([model(x, Gates(gates.head[c].cuda(), gates.neuron[c].cuda())).logits
                         for c in range(C)])
        model.use_kernel = False
        plain = model(xf, folded).logits
    assert _rel(got, plain) <= TOL[torch.bfloat16]
    assert _rel(got, per) <= TOL[torch.bfloat16]


def test_hsic_scores_on_the_card_equal_the_cpu(gen):
    """_neuron_scores and _head_scores on the card against the CPU at f32,
    on the captured activations of a two-layer full-width dedeit (random
    weights), with TF32 switched on around them (the scores keep it off)."""
    from devit_tpu_torch.core.rank import _head_scores, _neuron_scores
    from devit_tpu_torch.models.vit import create_vit

    model = create_vit("dedeit", depth=2, num_classes=25, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        out = model(torch.randn((32, 224, 224, 3), generator=gen, device="cuda"),
                    capture_rank_stats=True)
    act, head_out = out.neuron_act, out.head_out
    probs = torch.softmax(out.logits.float(), dim=-1)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = [*_neuron_scores(act, probs), _head_scores(head_out, probs)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    want = [*_neuron_scores(act.cpu(), probs.cpu()), _head_scores(head_out.cpu(), probs.cpu())]
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w) <= TOL[torch.float32]


def test_ill_conditioned_head_scores_on_the_card_within_their_rounding_bound(gen):
    """Head features spread tinily against every kernel width (exp near 1):
    f32 loses digits there, on the card as on the CPU and in the reference's
    formula; the card's scores stay within the bound that the grams'
    conditioning gives against f64 (~3e-4 here; an H100 and the CPU differed
    by 1.29e-4)."""
    from devit_tpu_torch.core.rank import _head_scores

    head_out, probs = ill_conditioned_heads()
    want, bound = head_score_bound(head_out, probs)
    got = _head_scores(head_out.cuda(), probs.cuda())
    rel = _rel(got.cpu(), want)
    print(f"ill-conditioned head scores, card vs f64: {rel:.3e} (bound {bound:.3e})")
    assert got.dtype == torch.float32 and rel <= bound


# ---- head widths 32 and 128 (64 is every test above): each kernel against
# its plain version, dq, dk and dv each on its own, repeats bit for bit


HEAD_DIM_CASES = [(32, 12), (128, 6)]  # (head_dim, heads): C 384 and 768
# head widths between the instantiations: each head zero-padded to the next
# one (32, 64 or 128), the logits scaled by the true width's dh^-0.5
PADDED_CASES = [(8, 4), (16, 6), (48, 4), (80, 3), (96, 4)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,kh", HEAD_DIM_CASES + PADDED_CASES)
def test_head_widths_forward_matches_plain(gen, dh, kh, dtype):
    # N 300: past the f32 whole-row block's shared memory at widths 64 and
    # 128 (the key-chunked kernel), past 256 keys at bf16
    lengths = (1, 17, 65, 197, 198, 256, 300)
    for n in lengths:
        for B in (1, 7):
            x = torch.randn((B, n, 3 * kh * dh), generator=gen, device="cuda").to(dtype)
            gate = torch.rand((kh,), generator=gen, device="cuda") if n % 2 else None
            got = fused_attention(x, gate, num_heads=kh)
            again = fused_attention(x, gate, num_heads=kh)
            torch.cuda.synchronize()
            rel = _rel(got, reference_attention(x, gate, num_heads=kh))
            assert rel <= TOL[dtype] and torch.equal(got, again), (n, B, rel)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh,kh", HEAD_DIM_CASES + PADDED_CASES)
def test_head_widths_backwards_match_plain(gen, dh, kh, dtype):
    """The monolithic kernel and the split pair (each against its plain
    version, the pair against the monolithic kernel bit for bit) on both
    sides of the chunked path's switch (N 256, and at dh 128 the shared
    memory of the monolithic block)."""
    C = kh * dh
    for n in (1, 33, 197, 198, 209, 256, 300):
        for B in (1, 5):
            x = torch.randn((B, n, 3 * C), generator=gen, device="cuda").to(dtype)
            g = torch.randn((B, n, C), generator=gen, device="cuda").to(dtype)
            got = attention_bwd(x, g, kh)
            again = attention_bwd(x, g, kh)
            torch.cuda.synchronize()
            errs = _bwd_errs(got, reference_attention_bwd(x, g, kh), C)
            assert max(errs) <= TOL[dtype] and torch.equal(got, again), (n, B, errs)
            split = attention_bwd_split(x, g, kh)
            assert torch.equal(split, got), (n, B)
            want_qk = reference_attention_bwd_dqdk(x, g, kh)
            want_v = reference_attention_bwd_dv(x, g, kh)
            errs = [_rel(split[..., :C], want_qk[..., :C]), _rel(split[..., C:2 * C], want_qk[..., C:]),
                    _rel(split[..., 2 * C:], want_v)]
            assert max(errs) <= TOL[dtype], (n, B, errs)


@pytest.mark.parametrize("dh,kh", HEAD_DIM_CASES + PADDED_CASES)
def test_head_widths_trainable_attention_matches_autograd(gen, dh, kh):
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2, N, 3 * kh * dh), generator=gen, device="cuda").to(dtype)
        cot = torch.randn((2, N, kh * dh), generator=gen, device="cuda")
        x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
        (g1,) = torch.autograd.grad((make_trainable_attention(kh)(x1).float() * cot).sum(), x1)
        (g2,) = torch.autograd.grad(
            (reference_attention(x2, num_heads=kh).float() * cot).sum(), x2)
        assert max(_bwd_errs(g1, g2, kh * dh)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [8, 16, 32, 48, 80, 96, 128])
def test_head_widths_block_kernel_matches_plain(gen, dh, dtype):
    """Odd head counts at dh 32 make K = H dh not a multiple of the proj
    kernel's 64-row chunks; f32 runs the chunked route at every N, bf16 the
    whole-row pair here. Widths between the instantiations run padded (zero
    qkv columns and proj rows per head)."""
    width = kernel_head_dim(dh)
    lengths = (1, 17, 65, 198, 256)
    for n in lengths:
        for kh in ((1, 3, 6) if width == 128 else (1, 5, 12)):
            t, w = _block_case(gen, 3, n, kh, dtype, with_bias=kh % 2 == 1, dh=dh)
            got = fused_block_attention(t, **w, num_heads=kh)
            again = fused_block_attention(t, **w, num_heads=kh)
            torch.cuda.synchronize()
            rel = _rel(got, reference_block_attention(t, **w, num_heads=kh))
            assert rel <= TOL[dtype] and torch.equal(got, again), (n, kh, rel)


# ---- every sequence length and head width: the key-chunked paths
# (csrc/attention.cu attn_long_mma and attn_wide_mma,
# csrc/attention_bwd_long.cu's pairs, block_attention.cu's chunked route)

LONG_CASES = ([(n, 64, 6) for n in (291, 578, 843, 1026)] + [(578, 32, 12), (578, 128, 6)]
              + [(n, dh, kh) for n in (198, 578) for dh, kh in ((192, 4), (256, 3))])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,dh,kh", LONG_CASES)
def test_forward_and_trainable_attention_at_every_length_and_width(gen, n, dh, kh, dtype):
    """fused_attention (gated) and make_trainable_attention in both backward
    modes against their plain versions (dq, dk, dv each), repeats and the
    split backward against the monolithic one bit for bit."""
    C = kh * dh
    x = torch.randn((2, n, 3 * C), generator=gen, device="cuda").to(dtype)
    g = torch.randn((2, n, C), generator=gen, device="cuda").to(dtype)
    gate = torch.rand((kh,), generator=gen, device="cuda")
    got, again = fused_attention(x, gate, num_heads=kh), fused_attention(x, gate, num_heads=kh)
    torch.cuda.synchronize()
    assert _rel(got, reference_attention(x, gate, num_heads=kh)) <= TOL[dtype]
    assert torch.equal(got, again)
    grads = []
    for mode in ("monolithic", "split"):
        xs = x.clone().requires_grad_()
        (dx,) = torch.autograd.grad(make_trainable_attention(kh, mode)(xs), xs, g)
        grads.append(dx)
    torch.cuda.synchronize()
    errs = _bwd_errs(grads[0], reference_attention_bwd(x, g, kh), C)
    assert max(errs) <= TOL[dtype], errs
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], attention_bwd(x, g, kh))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,dh,kh", [(291, 64, 6), (578, 64, 6), (198, 192, 2), (578, 192, 2),
                                     (300, 128, 3)])
def test_block_kernel_at_every_length_and_width(gen, n, dh, kh, dtype):
    t, w = _block_case(gen, 2, n, kh, dtype, with_bias=n % 2 == 0, dh=dh)
    got = fused_block_attention(t, **w, num_heads=kh)
    again = fused_block_attention(t, **w, num_heads=kh)
    torch.cuda.synchronize()
    rel = _rel(got, reference_block_attention(t, **w, num_heads=kh))
    assert rel <= TOL[dtype] and torch.equal(got, again), rel


def test_forward_paths_are_the_designs_the_sizes_call_for(gen):
    from devit_tpu_torch.kernels.attention import attention_path

    assert attention_path(256, 64, torch.bfloat16) == "whole-row"
    assert attention_path(257, 64, torch.bfloat16) == "key-chunked mma"
    # f32 at every N up to head width 128: the 3xTF32 kernel over key chunks
    for n in (1, 198, 578):
        for dh in (32, 64, 128):
            assert attention_path(n, dh, torch.float32) == "key-chunked mma", (n, dh)
    # past head width 128 in both dtypes, padded or not: head pieces and slabs
    for dh in (129, 160, 192, 256, 320, 768):
        for dtype in (torch.float32, torch.bfloat16):
            assert attention_path(198, dh, dtype) == "wide-head mma", (dh, dtype)


# past head width 128 (csrc/wide.cuh): widths that pad (160 -> 192, 320 is a
# multiple of 64 past two slabs) and that do not (192, 256), at N 1 (a
# constant softmax), 17 (one partial tile), 198 and 578 (several chunks)
WIDE_CASES = [(n, dh, kh) for n in (1, 17, 198, 578)
              for dh, kh in ((160, 2), (192, 2), (256, 1), (320, 1))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,dh,kh", WIDE_CASES)
def test_wide_heads_match_plain(gen, n, dh, kh, dtype):
    """fused_attention and the four backward wrappers past head width 128
    against their plain versions (dq, dk and dv each), every call repeated
    bit for bit, and the split pair, dq/dk and dv equal to the monolithic
    backward bit for bit."""
    C = kh * dh
    x = torch.randn((2, n, 3 * C), generator=gen, device="cuda").to(dtype)
    g = torch.randn((2, n, C), generator=gen, device="cuda").to(dtype)
    fwd, fwd2 = fused_attention(x, num_heads=kh), fused_attention(x, num_heads=kh)
    mono, mono2 = attention_bwd(x, g, kh), attention_bwd(x, g, kh)
    split = attention_bwd_split(x, g, kh)
    dqdk, dv = attention_bwd_dqdk(x, g, kh), attention_bwd_dv(x, g, kh)
    torch.cuda.synchronize()
    assert _rel(fwd, reference_attention(x, num_heads=kh)) <= TOL[dtype]
    errs = _bwd_errs(mono, reference_attention_bwd(x, g, kh), C)
    assert max(errs) <= TOL[dtype], errs
    assert torch.equal(fwd, fwd2) and torch.equal(mono, mono2) and torch.equal(split, mono)
    assert torch.equal(dqdk, mono[..., :2 * C]) and torch.equal(dv, mono[..., 2 * C:])


@pytest.mark.parametrize("dh,wide", [(64, 0), (128, 0), (129, 1), (192, 1)])
def test_wide_launches_are_counted(gen, dh, wide):
    """Every wrapper counts a launch in `launches`, and past head width 128
    also in `wide_launches`; the split pair counts one launch on each half."""
    x = torch.randn((1, 17, 6 * dh), generator=gen, device="cuda").bfloat16()
    g = torch.randn((1, 17, 2 * dh), generator=gen, device="cuda").bfloat16()
    wrappers = (fused_attention, attention_bwd, attention_bwd_dv, attention_bwd_dqdk)
    before = [(w.launches, w.wide_launches) for w in wrappers]
    fused_attention(x, num_heads=2)
    attention_bwd(x, g, 2)
    attention_bwd_split(x, g, 2)
    got = [(w.launches - a, w.wide_launches - b) for w, (a, b) in zip(wrappers, before)]
    assert got == [(1, wide)] * 4
