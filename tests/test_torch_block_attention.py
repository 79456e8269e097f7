"""The port's fused_block_attention (devit_tpu_torch/kernels/attention.py;
on a CPU tensor its plain version reference_block_attention) vs the JAX
package's Pallas kernel in interpret mode, on the same numpy inputs,
mirroring tests/test_kernels.py:211-258: at f32 within 2e-4 (rtol and atol,
the JAX test's), with and without the qkv bias, with a remainder batch; in
bf16 within 2e-2 of max |ref|; at one deployed layer's width (C 384, five
heads of 64, N 198) at B 2; and against the port's split sequence
(compact_vit.attention_half, strict numerics) at f32 within 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.kernels.attention import fused_block_attention as jax_fba
from devit_tpu_torch.kernels.attention import fused_block_attention, reference_block_attention
from devit_tpu_torch.models.compact_vit import CompactLayer, attention_half

TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(B, N, C, H, dh, seed, bias=True):
    rng = np.random.default_rng(seed)
    K = H * dh
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(t=f(B, N, C), ns=1.0 + 0.1 * f(C), nb=0.1 * f(C), qw=0.1 * f(C, 3 * K),
                qb=0.1 * f(3 * K) if bias else None, pw=0.1 * f(K, C), pb=0.1 * f(C))


def _both(a, H, dtype=jnp.float32, block_b=2):
    order = ("t", "ns", "nb", "qw", "qb", "pw", "pb")
    jargs = [None if a[k] is None else jnp.asarray(a[k], dtype) for k in order]
    want = np.asarray(jax_fba(*jargs, num_heads=H, eps=1e-6, block_b=block_b, interpret=True),
                      np.float32)
    targs = [None if a[k] is None else torch.tensor(a[k]).to(TORCH[dtype]) for k in order]
    got = fused_block_attention(*targs, num_heads=H, eps=1e-6)
    assert got.dtype == TORCH[dtype] and got.shape == a["t"].shape
    return got.float().numpy(), want


def test_matches_jax_kernel_f32():
    got, want = _both(_inputs(4, 18, 32, 3, 8, seed=0), 3)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_no_bias_and_remainder_batch():
    a = _inputs(5, 10, 16, 2, 8, seed=1, bias=False)  # B 5 over blocks of 2
    a["ns"], a["nb"], a["pb"] = np.ones(16, np.float32), np.zeros(16, np.float32), np.zeros(
        16, np.float32)
    got, want = _both(a, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_matches_jax_kernel_bf16():
    got, want = _both(_inputs(3, 18, 32, 2, 16, seed=2), 2, jnp.bfloat16)
    assert np.abs(got - want).max() / np.abs(want).max() <= 2e-2


def test_deployed_layer_width_f32():
    """C 384, five heads of 64 (the deployed divisions' widest layers), N 198."""
    a = _inputs(2, 198, 384, 5, 64, seed=3)
    a["qw"] *= 0.5
    got, want = _both(a, 5, block_b=2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bias", [True, False])
def test_matches_the_split_sequence_f32(bias):
    """fused_block_attention replaces compact_forward's LN1 -> qkv ->
    attention -> proj -> residual; at f32 (strict numerics) both agree."""
    a = _inputs(2, 20, 64, 2, 32, seed=4, bias=bias)
    lp = {"norm1": {"scale": a["ns"], "bias": a["nb"]}, "norm2": {"scale": a["ns"],
                                                                  "bias": a["nb"]},
          "qkv_kernel": a["qw"], "proj_kernel": a["pw"], "proj_bias": a["pb"],
          "fc1_kernel": np.zeros((64, 8)), "fc1_bias": np.zeros(8),
          "fc2_kernel": np.zeros((8, 64)), "fc2_bias": np.zeros(64)}
    if bias:
        lp["qkv_bias"] = a["qb"]
    t = torch.tensor(a["t"])
    split = attention_half(CompactLayer(lp, 2), t, eps=1e-6, dtype=torch.float32,
                           use_kernel=False, fast_math=False)
    fused = fused_block_attention(t, *(None if a[k] is None else torch.tensor(a[k])
                                       for k in ("ns", "nb", "qw", "qb", "pw", "pb")),
                                  num_heads=2)
    np.testing.assert_allclose(fused.numpy(), split.numpy(), rtol=2e-4, atol=2e-4)


def test_cpu_takes_the_plain_version_and_counts_nothing():
    a = {k: None if v is None else torch.tensor(v) for k, v in
         _inputs(1, 6, 32, 1, 8, seed=5).items()}
    before = fused_block_attention.launches
    got = fused_block_attention(*a.values(), num_heads=1)
    assert torch.equal(got, reference_block_attention(*a.values(), num_heads=1))
    assert fused_block_attention.launches == before
    with pytest.raises(ValueError, match="cuda"):
        fused_block_attention(*(None if v is None else v.to("meta") for v in a.values()),
                              num_heads=1)


def test_padded_head_width_matches_jax_kernel_f32():
    """dh 48: on the card the kernel runs at width 64 with zero qkv columns
    and proj rows per head; here the plain version against the Pallas kernel."""
    got, want = _both(_inputs(3, 21, 64, 2, 48, seed=4), 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
