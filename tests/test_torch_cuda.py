"""The port's CUDA kernel on the card: fused_attention (the hand-written
kernel in devit_tpu_torch/kernels/csrc/attention.cu) vs its plain PyTorch
version, its launch counter and what its wrapper rejects.

Needs an NVIDIA GPU with nvcc (sm_90a); elsewhere every test skips. The
machine with the card has no JAX, so run without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from devit_tpu_torch.kernels.attention import fused_attention, reference_attention

pytestmark = pytest.mark.cuda

N, DH = 198, 64
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # max|got-want| / max|want|


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU tests hold the plain version")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


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
    x = torch.randn((1, N, 3 * 4 * 32), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fused_attention(x, num_heads=4)  # dh 32
    with pytest.raises(TypeError, match="bfloat16"):
        fused_attention(x.half(), num_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(torch.zeros((2, N, 3 * DH), device="cuda").transpose(0, 1),
                        num_heads=1)
    with pytest.raises(ValueError, match="shared"):
        fused_attention(torch.zeros((1, 4096, 3 * DH), device="cuda"), num_heads=1)
