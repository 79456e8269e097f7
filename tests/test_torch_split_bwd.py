"""Port split attention backward (devit_tpu_torch/kernels/attention.py:
reference_attention_bwd_dv, reference_attention_bwd_dqdk,
attention_bwd_split, and the DEVIT_ATTN_BWD resolution of
make_trainable_attention) vs the JAX package's _attention_bwd_split_impl in
interpret mode and its make_trainable_attention, as
tests/test_kernels.py:120-156 holds the JAX pair.

Tolerances: the plain versions vs the Pallas split backward at f32 rtol
2e-4, atol 2e-5 (tests/test_kernels.py); in bf16 max-abs over max-ref
2e-2 for dq, dk and dv each. The port's split gradient vs its monolithic
one: the same arithmetic in the same order, rtol 2e-5 (the JAX test's).
On the CPU the wrappers take the plain versions; the CUDA kernels are held
to them on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.kernels import attention as jattn
from devit_tpu_torch.kernels import attention as tattn

RTOL, ATOL = 2e-4, 2e-5


def _inputs(B, N, H, dh, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * dh)).astype(np.float32)
    g = rng.standard_normal((B, N, H * dh)).astype(np.float32)
    return qkv, g


# N 258 and 578: past the 256 keys where the CUDA backwards switch to their
# chunked path; the plain versions are what the card holds that path to
@pytest.mark.parametrize("B,N,H,dh", [(3, 10, 2, 8), (2, 18, 4, 16), (1, 198, 6, 64),
                                      (1, 258, 2, 64), (1, 578, 1, 64), (2, 45, 6, 32),
                                      (1, 70, 2, 128)])
def test_plain_split_matches_pallas_split(B, N, H, dh):
    qkv, g = _inputs(B, N, H, dh, seed=N + 1)
    want = np.asarray(jattn._attention_bwd_split_impl(jnp.asarray(qkv), jnp.asarray(g), H, 2,
                                                      True))
    tq, tg = torch.from_numpy(qkv), torch.from_numpy(g)
    C = H * dh
    dqdk = tattn.reference_attention_bwd_dqdk(tq, tg, H)
    dv = tattn.reference_attention_bwd_dv(tq, tg, H)
    assert dqdk.shape == (B, N, 2 * C) and dv.shape == (B, N, C)
    np.testing.assert_allclose(dqdk.numpy(), want[..., :2 * C], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dv.numpy(), want[..., 2 * C:], rtol=RTOL, atol=ATOL)
    got = tattn.attention_bwd_split(tq, tg, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_bf16_plain_split_matches_pallas_split():
    B, N, H, dh = 2, 18, 3, 64
    qkv, g = _inputs(B, N, H, dh, seed=11)
    qb, gb = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(g).bfloat16()
    got = tattn.attention_bwd_split(qb, gb, H)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jattn._attention_bwd_split_impl(
        jnp.asarray(qb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16), H, 2, True).astype(jnp.float32))
    C = H * dh
    for i in range(3):  # dq, dk, dv each to the bf16 limit
        a, b = got.float().numpy()[..., i * C:(i + 1) * C], want[..., i * C:(i + 1) * C]
        assert np.abs(a - b).max() / np.abs(b).max() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_matches_monolithic(dtype):
    """The dv half rounds p to qkv's dtype, the monolithic kernel to v's:
    the same dtype, so the two backwards are one function."""
    qkv, g = _inputs(4, 30, 3, 16, seed=5)
    tq, tg = torch.from_numpy(qkv).to(dtype), torch.from_numpy(g).to(dtype)
    split = tattn.attention_bwd_split(tq, tg, 3).float().numpy()
    mono = tattn.reference_attention_bwd(tq, tg, 3).float().numpy()
    np.testing.assert_allclose(split, mono, rtol=2e-5, atol=2e-6)


def test_split_gradient_matches_monolithic_and_jax(monkeypatch):
    B, N, H, dh = 5, 12, 3, 8
    qkv, cot = _inputs(B, N, H, dh, seed=4)

    def port_grad(mode):
        x = torch.from_numpy(qkv).requires_grad_()
        loss = torch.sum(tattn.make_trainable_attention(H, mode)(x) * torch.from_numpy(cot))
        return torch.autograd.grad(loss, x)[0].numpy()

    g_split, g_mono = port_grad("split"), port_grad("monolithic")
    np.testing.assert_allclose(g_split, g_mono, rtol=2e-5, atol=2e-6)
    jgrad = np.asarray(jax.grad(lambda x: jnp.sum(jattn.make_trainable_attention(
        H, block_b=2, interpret=True, bwd_mode="split")(x) * jnp.asarray(cot)))(
            jnp.asarray(qkv)))
    np.testing.assert_allclose(g_split, jgrad, rtol=RTOL, atol=ATOL)
    # the CPU path launches no kernel
    assert tattn.attention_bwd_dv.launches == tattn.attention_bwd_dqdk.launches == 0

    # bwd_mode=None resolves from DEVIT_ATTN_BWD, as the JAX package's does
    monkeypatch.setenv("DEVIT_ATTN_BWD", "split")
    calls = []
    real = tattn._BWD["split"]
    monkeypatch.setitem(tattn._BWD, "split", lambda *a: (calls.append(1), real(*a))[1])
    np.testing.assert_allclose(port_grad(None), g_split, rtol=1e-6)
    assert calls == [1]
    monkeypatch.delenv("DEVIT_ATTN_BWD")
    np.testing.assert_allclose(port_grad(None), g_mono, rtol=1e-6)
    assert calls == [1]  # the default is the monolithic backward


def test_unknown_modes_and_devices_raise(monkeypatch):
    with pytest.raises(ValueError, match="bwd_mode"):
        tattn.make_trainable_attention(2, bwd_mode="bogus")
    monkeypatch.setenv("DEVIT_ATTN_BWD", "fast")
    with pytest.raises(ValueError, match="bwd_mode"):
        tattn.make_trainable_attention(2)
    # the JAX package refuses the same mode the same way
    with pytest.raises(ValueError, match="bwd_mode"):
        jattn.make_trainable_attention(2)
    meta = torch.empty((1, 4, 3 * 8), device="meta")
    g = torch.empty((1, 4, 8), device="meta")
    for fn in (tattn.attention_bwd_split, tattn.attention_bwd_dv, tattn.attention_bwd_dqdk):
        with pytest.raises(ValueError, match="cuda"):
            fn(meta, g, 1)
    with pytest.raises(ValueError, match="must divide"):
        tattn.reference_attention_bwd_dv(torch.zeros((1, 4, 3 * 8)), torch.zeros((1, 4, 8)), 3)


def test_long_path_scratch():
    """Past 256 keys the CUDA backwards take a (B, H, N, 3) f32 scratch of
    row statistics from the wrapper; at bf16 and 256 keys or fewer none. The
    f32 backwards walk key chunks (the 3xTF32 pair) and take it at every N."""
    assert tattn._bwd_stats(torch.zeros((2, 256, 3 * 64), dtype=torch.bfloat16), 1) is None
    stats = tattn._bwd_stats(torch.zeros((2, 257, 3 * 3 * 64), dtype=torch.bfloat16), 3)
    assert stats.shape == (2, 3, 257, 3) and stats.dtype == torch.float32
    for n in (1, 198, 256, 257):
        stats = tattn._bwd_stats(torch.zeros((2, n, 3 * 3 * 64)), 3)
        assert stats.shape == (2, 3, n, 3) and stats.dtype == torch.float32
