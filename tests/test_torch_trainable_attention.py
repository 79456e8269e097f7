"""Port trainable attention (devit_tpu_torch/kernels/attention.py:
reference_attention_bwd, attention_bwd, make_trainable_attention) vs the JAX
package's Pallas backward (_attention_bwd_impl, interpret mode) and jax.grad
through make_trainable_attention, at f32 with the tolerances of
tests/test_kernels.py:100-117. On the CPU the port's Function takes the
plain forward and backward; the CUDA kernel is held against the plain
backward on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.kernels import attention as jattn
from devit_tpu_torch.kernels import _build
from devit_tpu_torch.kernels import attention as tattn

RTOL, ATOL = 2e-4, 2e-5


def _inputs(B, N, H, dh, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * dh)).astype(np.float32)
    g = rng.standard_normal((B, N, H * dh)).astype(np.float32)
    return qkv, g


# N 258 and 578: past the 256 keys where the CUDA backward switches to its
# chunked path; the plain version is what the card holds that path to
@pytest.mark.parametrize("B,N,H,dh", [(3, 10, 2, 8), (2, 18, 4, 16), (1, 198, 6, 64),
                                      (1, 258, 2, 64), (1, 578, 1, 64)])
def test_reference_bwd_matches_pallas_bwd(B, N, H, dh):
    qkv, g = _inputs(B, N, H, dh, seed=N)
    want = np.asarray(jattn._attention_bwd_impl(jnp.asarray(qkv), jnp.asarray(g), H, 2,
                                                True))
    got = tattn.reference_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(g), H)
    assert got.dtype == torch.float32 and got.shape == qkv.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,N,H,dh", [(3, 10, 2, 8), (5, 12, 3, 8)])
def test_function_gradient_matches_jax_grad(B, N, H, dh):
    qkv, cot = _inputs(B, N, H, dh, seed=B)
    attn = jattn.make_trainable_attention(H, block_b=2, interpret=True,
                                          bwd_mode="monolithic")
    want_loss, want_grad = jax.value_and_grad(
        lambda x: jnp.sum(jnp.sin(attn(x)) * jnp.asarray(cot)))(jnp.asarray(qkv))

    x = torch.from_numpy(qkv).requires_grad_()
    loss = torch.sum(torch.sin(tattn.make_trainable_attention(H)(x)) * torch.from_numpy(cot))
    (grad,) = torch.autograd.grad(loss, x)
    # a sum of signed O(1) terms: an absolute floor for its cancellation
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)
    # and autograd through the plain forward (tests/test_kernels.py:100-117)
    x2 = torch.from_numpy(qkv).requires_grad_()
    loss2 = torch.sum(torch.sin(tattn.reference_attention(x2, num_heads=H))
                      * torch.from_numpy(cot))
    (grad2,) = torch.autograd.grad(loss2, x2)
    np.testing.assert_allclose(grad.numpy(), grad2.numpy(), rtol=RTOL, atol=ATOL)


def test_bf16_reference_bwd_matches_jax_pallas_bwd():
    B, N, H, dh = 2, 18, 3, 64
    qkv, g = _inputs(B, N, H, dh, seed=7)
    qb, gb = torch.from_numpy(qkv).bfloat16(), torch.from_numpy(g).bfloat16()
    got = tattn.reference_attention_bwd(qb, gb, H)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jattn._attention_bwd_impl(
        jnp.asarray(qb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16), H, 2, True).astype(jnp.float32))
    C = H * dh
    for i in range(3):  # dq, dk, dv each to the bf16 limit
        a, b = got.float().numpy()[..., i * C:(i + 1) * C], want[..., i * C:(i + 1) * C]
        assert np.abs(a - b).max() / np.abs(b).max() <= 2e-2


def test_function_takes_a_non_contiguous_gradient_and_saves_only_qkv():
    B, N, H, dh = 2, 10, 2, 8
    qkv, _ = _inputs(B, N, H, dh, seed=3)
    x = torch.from_numpy(qkv).requires_grad_()
    out = tattn.make_trainable_attention(H)(x)
    assert [t.shape for t in out.grad_fn.saved_tensors] == [x.shape]
    # sum() hands backward an expanded (stride-0) gradient
    (grad,) = torch.autograd.grad(out.sum(), x)
    want = tattn.reference_attention_bwd(x.detach(), torch.ones_like(out), H)
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    assert tattn.attention_bwd.launches == 0 and tattn.fused_attention.launches == 0


def test_bwd_modes_and_devices():
    for mode in ("monolithic", "split"):  # both backwards are ported
        assert callable(tattn.make_trainable_attention(2, bwd_mode=mode))
    with pytest.raises(ValueError, match="unknown"):
        tattn.make_trainable_attention(2, bwd_mode="fast")
    meta = torch.empty((1, 4, 3 * 8), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        tattn.attention_bwd(meta, torch.empty((1, 4, 8), device="meta"), 1)
    with pytest.raises(ValueError, match="must divide"):
        tattn.reference_attention_bwd(torch.zeros((1, 4, 3 * 8)), torch.zeros((1, 4, 8)), 3)


def test_library_hash_covers_every_source_and_header(monkeypatch, tmp_path):
    assert {f.name for f in _build.SOURCES} >= {"attention.cu", "attention_bwd.cu",
                                                "attention_bwd_split.cu"}
    assert {"common.cuh", "bwd_common.cuh"} <= {f.name for f in _build.HEADERS}
    path = _build._lib_path()
    header = tmp_path / "common.cuh"
    header.write_bytes(_build.HEADERS[0].read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(_build, "HEADERS", (header,))
    assert _build._lib_path() != path  # an edited header never loads a stale build
