"""The A&S-erf GELU op of the port (devit_tpu_torch/kernels/gelu.py) on the
CPU: the plain backward `gelu_as_grad` against autograd of the chain and
against jax.grad of the JAX package's fast_gelu, the op `devit_torch::fused_gelu`
(its CPU impls: the chain forward, gelu_as_grad backward) under
torch.utils.checkpoint at full remat and under dots_saveable, and
`fast_gelu`'s route: a CPU tensor takes the chain and launches nothing. The
kernels themselves run in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from devit_tpu.models import vit as jvit
from devit_tpu_torch.kernels import gelu
from devit_tpu_torch.models import vit as tvit

F32_ULP = 2.0 ** -23  # f32's ulp of 1; g' lies in [-0.17, 1.13]


def _inputs(dtype) -> torch.Tensor:
    """x = 0, +-1e-30, a grid over [-10, 10], and a 1e5-element normal sample."""
    rng = np.random.default_rng(0)
    x = np.concatenate([[0.0, -0.0, 1e-30, -1e-30], np.linspace(-10, 10, 4001),
                        3 * rng.standard_normal(100_000)]).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _chain_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    xr = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(gelu.reference_gelu(xr), xr, dy)
    return dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_as_grad_matches_autograd_of_the_chain(dtype):
    x = _inputs(dtype)
    dy = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 2.0, x.shape)
                          .astype(np.float32)).to(dtype)
    got, want = gelu.gelu_as_grad(x, dy), _chain_grad(x, dy)
    assert got.dtype == dtype
    if dtype == torch.float32:
        # both are f32 evaluations of one derivative, ~2 ulp from its exact value
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=8 * F32_ULP)
    else:
        # f32 values that agree as above, rounded to bf16: one bf16 ulp apart,
        # or the f32 rounding itself where g' is near 0 (the tails, where the
        # chain's 1 + E cancels to 0, and g'(-0.75) = 0)
        ulp = torch.finfo(torch.bfloat16).eps * want.float().abs().clamp_min(2.0 ** -126)
        gap = (got.float() - want.float()).abs()
        assert bool((gap <= ulp + 8 * F32_ULP * dy.float().abs()).all())
    for v in (0.0, -0.0):  # abs's derivative is 0 at 0: g'(0) = 1/2
        assert gelu.gelu_as_grad(torch.tensor([v], dtype=dtype),
                                 torch.ones(1, dtype=dtype)).item() == 0.5


def test_gelu_as_slope_is_within_f32_rounding_of_the_exact_derivative():
    """Against the same derivative in f64, the plain backward and autograd of
    the chain both err by ~2 f32 ulps of 1 (2.25e-7 and 2.15e-7 here; the
    worst near x = 0, where E = 1 - P(t) e cancels)."""
    x = _inputs(torch.float32)
    exact = gelu.gelu_as_slope(x.double())
    ours = (gelu.gelu_as_slope(x).double() - exact).abs().max().item()
    chain = (_chain_grad(x, torch.ones_like(x)).double() - exact).abs().max().item()
    assert max(ours, chain) <= 2.5 * F32_ULP, (ours, chain)


def test_gelu_as_grad_matches_jax_grad():
    """jax.grad of the JAX package's fast_gelu, at test_torch_base_ops.py's
    tolerances for fast_gelu."""
    x = (3 * np.random.default_rng(3).standard_normal(4096)).astype(np.float32)
    x[:3] = (0.0, 1e-30, -1e-30)
    want = np.asarray(jax.vmap(jax.grad(jvit.fast_gelu))(jnp.asarray(x)))
    got = gelu.gelu_as_grad(torch.from_numpy(x), torch.ones(x.shape)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func == gelu.fused_gelu_op
        return func(*args, **(kwargs or {}))


def _mlp(act, x, w1, w2):
    return act(x @ w1) @ w2


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
def test_op_recomputed_under_checkpoint_with_the_chains_gradients(policy):
    """A remat'd MLP through the op: its forward runs again in the backward
    (full remat and dots_saveable save no GELU output), and its gradients
    equal the same MLP's through the chain within f32 rounding."""
    rng = np.random.default_rng(4)
    x, w1, w2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((2, 7, 16), (16, 48), (48, 16)))
    saved = tvit.remat_saved_ops(policy)
    ctx = dict(context_fn=lambda: create_selective_checkpoint_contexts(saved)) if saved else {}
    assert gelu.fused_gelu_op not in (saved or [])

    grads = {}
    for name, act in (("op", gelu.fused_gelu), ("chain", gelu.reference_gelu)):
        params = [t.clone().requires_grad_(True) for t in (x, w1, w2)]
        count = _OpCount()
        with count:
            out = checkpoint(_mlp, act, *params, use_reentrant=False, **ctx)
            grads[name] = torch.autograd.grad((out * out).sum(), params)
        assert count.calls == (2 if name == "op" else 0), (name, count.calls)
    for g_op, g_chain in zip(grads["op"], grads["chain"]):
        np.testing.assert_allclose(g_op.numpy(), g_chain.numpy(), rtol=1e-5, atol=1e-5)


def test_op_forward_on_cpu_is_the_chain_and_its_registrations_hold():
    x = _inputs(torch.float32)[:4096].reshape(4, 1024)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xd = x.to(dtype)
        assert torch.equal(gelu.fused_gelu(xd), gelu.reference_gelu(xd))
        assert torch.equal(gelu.fused_gelu_bwd(xd, torch.ones_like(xd)),
                           gelu.gelu_as_grad(xd, torch.ones_like(xd)))
    # a non-contiguous input is made contiguous first
    xt = x.t()
    assert torch.equal(gelu.fused_gelu(xt), gelu.reference_gelu(xt))
    torch.library.opcheck(gelu.fused_gelu_op, (x.clone().requires_grad_(True),))


def test_fast_gelu_on_cpu_takes_the_chain_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(gelu.fused_gelu, "launches", 0)
    monkeypatch.setattr(gelu.fused_gelu_bwd, "launches", 0)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        x = _inputs(dtype)[:5000].clone().requires_grad_(True)
        count = _OpCount()
        with count:
            y = tvit.fast_gelu(x)
            (dx,) = torch.autograd.grad(y, x, torch.ones_like(y))
        assert count.calls == 0
        assert torch.equal(y, gelu.reference_gelu(x))
        assert torch.equal(dx, _chain_grad(x.detach(), torch.ones_like(y)))
    assert gelu.fused_gelu.launches == 0 and gelu.fused_gelu_bwd.launches == 0
