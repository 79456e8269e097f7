"""Port attention (devit_tpu_torch/kernels/attention.py) vs the JAX package's
reference_attention and its Pallas fused_attention in interpret mode.

On the CPU the port's fused_attention takes its plain version; the CUDA
kernel itself is held against that plain version on the card by
chip_smoke.py. f32 tolerances are those of tests/test_kernels.py:13-29."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.kernels import attention as jattn
from devit_tpu_torch import deploy
from devit_tpu_torch.device import resolve_device
from devit_tpu_torch.kernels import attention as tattn

N, DH = 198, 64
RTOL, ATOL = 2e-4, 2e-5


def _qkv(B, kh, seed, zero_head=None):
    x = np.random.default_rng(seed).standard_normal((B, N, 3 * kh * DH)).astype(np.float32)
    if zero_head is not None:  # the all-zero dummy head of a layer that kept none
        C = kh * DH
        for third in range(3):
            lo = third * C + zero_head * DH
            x[:, :, lo:lo + DH] = 0.0
    return x


def _gate(kh, seed):
    g = np.ones(kh, np.float32)
    g[np.random.default_rng(seed).integers(kh)] = 0.0
    return g


@pytest.mark.parametrize("kh", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("gated", [False, True])
def test_attention_matches_jax(kh, gated):
    B = 3  # remainder batch against the Pallas kernel's block_b=2
    x = _qkv(B, kh, seed=kh)
    g = _gate(kh, seed=kh) if gated else None
    jg = None if g is None else jnp.asarray(g)
    want_ref = np.asarray(jattn.reference_attention(jnp.asarray(x), jg, num_heads=kh))
    want_pallas = np.asarray(jattn.fused_attention(jnp.asarray(x), jg, num_heads=kh,
                                                   block_b=2, interpret=True))
    tg = None if g is None else torch.from_numpy(g)
    got_ref = tattn.reference_attention(torch.from_numpy(x), tg, num_heads=kh).numpy()
    got_fused = tattn.fused_attention(torch.from_numpy(x), tg, num_heads=kh).numpy()
    for got in (got_ref, got_fused):
        np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


def test_all_zero_head_gives_mean_of_zero_v():
    kh = 2
    x = _qkv(2, kh, seed=11, zero_head=1)
    got = tattn.fused_attention(torch.from_numpy(x), num_heads=kh).numpy()
    want = np.asarray(jattn.fused_attention(jnp.asarray(x), None, num_heads=kh,
                                            interpret=True))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[:, :, DH:].any()  # uniform p over an all-zero v


def test_bf16_plain_version_matches_jax_reference():
    kh = 5
    x = _qkv(2, kh, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tattn.reference_attention(xb, num_heads=kh).float().numpy()
    want = np.asarray(jattn.reference_attention(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), None,
        num_heads=kh).astype(jnp.float32))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 2e-2, rel


def test_launch_counter_stays_zero_on_cpu():
    before = tattn.fused_attention.launches
    tattn.fused_attention(torch.from_numpy(_qkv(1, 2, seed=0)), num_heads=2)
    assert tattn.fused_attention.launches == before == 0


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)  # the default is cuda, never a silent cpu
    with pytest.raises(RuntimeError, match="CUDA"):
        deploy.build_artifacts()  # entry points default to cuda too


def test_wrapper_rejects_other_devices_and_bad_heads():
    with pytest.raises(ValueError, match="cuda"):
        tattn.fused_attention(torch.empty((1, N, 3 * DH), device="meta"), num_heads=1)
    with pytest.raises(ValueError, match="must divide"):
        tattn.fused_attention(torch.zeros((1, N, 3 * DH)), num_heads=5)


def test_kernel_library_is_named_by_source_and_flags(monkeypatch):
    from devit_tpu_torch.kernels import _build

    path = _build._lib_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("kernels-")
    assert path == _build._lib_path()  # stable for unchanged source and flags
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._lib_path() != path  # other flags never load a stale build


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from devit_tpu_torch.kernels import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# head widths 32 and 128 (the CUDA kernels' other instantiations): the plain
# versions, which the card holds the kernels to, against the Pallas kernels
@pytest.mark.parametrize("dh,kh", [(32, 12), (128, 3)])
def test_head_widths_match_pallas(dh, kh):
    B, n = 2, 37
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((B, n, 3 * kh * dh)).astype(np.float32)
    g = rng.standard_normal((B, n, kh * dh)).astype(np.float32)
    gate = _gate(kh, seed=dh)
    want = np.asarray(jattn.fused_attention(jnp.asarray(x), jnp.asarray(gate), num_heads=kh,
                                            interpret=True))
    got = tattn.fused_attention(torch.from_numpy(x), torch.from_numpy(gate), num_heads=kh)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want = np.asarray(jattn._attention_bwd_impl(jnp.asarray(x), jnp.asarray(g), kh, 2, True))
    got = tattn.attention_bwd(torch.from_numpy(x), torch.from_numpy(g), kh)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# head widths between the instantiations (8 and 48): on the card each head is
# zero-padded to 32 or 64 and scaled by the true width's dh^-0.5; on the CPU
# the wrappers take their plain versions, held here to the Pallas kernels
@pytest.mark.parametrize("dh,kh", [(8, 4), (48, 3)])
def test_padded_head_widths_match_pallas(dh, kh):
    B, n = 3, 37
    rng = np.random.default_rng(dh + 1)
    x = rng.standard_normal((B, n, 3 * kh * dh)).astype(np.float32)
    g = rng.standard_normal((B, n, kh * dh)).astype(np.float32)
    gate = _gate(kh, seed=dh)
    want = np.asarray(jattn.fused_attention(jnp.asarray(x), jnp.asarray(gate), num_heads=kh,
                                            block_b=2, interpret=True))
    got = tattn.fused_attention(torch.from_numpy(x), torch.from_numpy(gate), num_heads=kh)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want = np.asarray(jattn._attention_bwd_impl(jnp.asarray(x), jnp.asarray(g), kh, 2, True))
    for fn in (tattn.attention_bwd, tattn.attention_bwd_split):
        got = fn(torch.from_numpy(x), torch.from_numpy(g), kh)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want = np.asarray(jattn._attention_bwd_split_impl(jnp.asarray(x), jnp.asarray(g), kh, 2,
                                                      True))
    got = torch.cat([tattn.attention_bwd_dqdk(torch.from_numpy(x), torch.from_numpy(g), kh),
                     tattn.attention_bwd_dv(torch.from_numpy(x), torch.from_numpy(g), kh)], -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dh,width", [(8, 32), (16, 32), (32, 32), (48, 64), (80, 128),
                                      (96, 128), (128, 128), (129, 192), (160, 192), (192, 192),
                                      (200, 256), (320, 320)])
def test_padded_staging_is_the_unpadded_computation(dh, width):
    """What the wrappers stage for the card: each head's q, k, v zero-padded
    to the instantiation's width (past 128, the next multiple of 64; the
    padding all zeros, the slice back the input), and the plain attention
    over the padded heads at the true width's scale, sliced back, is the
    unpadded attention."""
    assert tattn.kernel_head_dim(dh) == width
    assert tattn.logit_scale(dh) == float(np.float32(1) / np.sqrt(np.float32(dh)))
    kh, B, n = 3, 2, 19
    x = torch.from_numpy(np.random.default_rng(dh).standard_normal(
        (B, n, 3 * kh * dh)).astype(np.float32))
    xp = tattn.pad_heads(x, 3, kh, dh, width)
    assert xp.shape == (B, n, 3 * kh * width) and xp.is_contiguous()
    heads = xp.reshape(B, n, 3, kh, width)
    assert not heads[..., dh:].any()
    assert torch.equal(tattn.unpad_heads(xp, 3, kh, dh, width), x)
    q, k, v = heads.permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)) * tattn.logit_scale(dh)
    o = torch.matmul(torch.softmax(s, dim=-1), v).permute(0, 2, 1, 3).reshape(B, n, -1)
    got = tattn.unpad_heads(o, 1, kh, dh, width)
    want = tattn.reference_attention(x, num_heads=kh)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dh", [129, 160, 192, 200, 256, 384, 768])
def test_head_widths_past_128_raise(dh):
    """Widths past 128 once raised here; they now run on the wide tensor-core
    kernels, which walk the head in 64-dim pieces: the wrappers zero-pad the
    head to the next multiple of 64 (a multiple of 64 stays as it is), and
    only a non-positive width raises."""
    width = tattn.kernel_head_dim(dh)
    assert width % 64 == 0 and dh <= width < dh + 64
    assert width == dh if dh % 64 == 0 else width > dh
    with pytest.raises(ValueError, match="head_dim must be positive"):
        tattn.kernel_head_dim(0)


# past the kernels' one-block designs: heads wider than 128 (the wide
# tensor-core kernels on the card; 160 zero-padded to 192) and N 291 (dedeit
# at 272 px: key chunks at bf16, and at f32 past the whole-row block's shared
# memory); on the CPU the wrappers take their plain versions, held here to the
# Pallas kernels
@pytest.mark.parametrize("n,dh,kh", [(37, 192, 2), (291, 64, 2), (37, 256, 2), (19, 160, 2)])
def test_long_and_wide_heads_match_pallas(n, dh, kh):
    rng = np.random.default_rng(n + dh)
    x = rng.standard_normal((2, n, 3 * kh * dh)).astype(np.float32)
    g = rng.standard_normal((2, n, kh * dh)).astype(np.float32)
    gate = _gate(kh, seed=n)
    want = np.asarray(jattn.fused_attention(jnp.asarray(x), jnp.asarray(gate), num_heads=kh,
                                            block_b=2, interpret=True))
    got = tattn.fused_attention(torch.from_numpy(x), torch.from_numpy(gate), num_heads=kh)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want = np.asarray(jattn._attention_bwd_impl(jnp.asarray(x), jnp.asarray(g), kh, 2, True))
    for fn in (tattn.attention_bwd, tattn.attention_bwd_split):
        got = fn(torch.from_numpy(x), torch.from_numpy(g), kh)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
