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
