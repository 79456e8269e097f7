"""The port's int8 serving path (devit_tpu_torch/kernels/quant.py and the
int8 branch of models/compact_vit.py) vs the JAX package on the CPU.

The same numpy inputs go through both. Tolerances: quantize_weight's codes
and scales equal; dynamic_int8_matmul bit-equal to JAX's (the int8 sums are
exact in both, every f32 step is rounded in the same order); the port's
fused_int8_matmul on the CPU (its plain version) against JAX's Pallas kernel
in interpret mode within tests/test_kernels.py:159-181's bounds, on that
test's own inputs, and bit-equal to JAX's plain version; the int8 compact forward
against JAX's at f32 with strict numerics, max-abs/max-ref <= 1e-3 (toy and
one full-width deployed division at B 2), and int8 vs float within the JAX
test's 0.1 (tests/test_kernels.py:76-97)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.kernels import quant as jq
from devit_tpu.models import compact_vit as jcv
from devit_tpu.models.vit import Gates as JGates
from devit_tpu.models.vit import VisionTransformer
from devit_tpu_torch import deploy
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.io.bridge import compact_from_jax_params
from devit_tpu_torch.kernels import quant as tq
from devit_tpu_torch.models.compact_vit import (compact_forward, compact_vit_ragged,
                                                quantize_compact)
from devit_tpu_torch.models.vit import Gates

TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=9)
TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _weights(K=96, N=48, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(K, N)).astype(np.float32),
            rng.normal(size=(N,)).astype(np.float32))


def _pair(w, b):
    return (jq.quantize_weight(jnp.asarray(w), None if b is None else jnp.asarray(b)),
            tq.quantize_weight(torch.tensor(w), None if b is None else torch.tensor(b)))


def _x(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    # rows of unequal scale, an all-zero row (amax floor) and exact .5 ties
    x = rng.normal(size=shape) * rng.uniform(0.05, 20.0, size=shape[:-1] + (1,))
    x = x.reshape(-1, shape[-1])
    x[0] = 0.0
    x[1, :4] = [127.0, -63.5, 0.5, -0.5]
    return x.reshape(shape).astype(dtype)


def test_quantize_weight_matches_jax():
    w, b = _weights()
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    qj, qt = _pair(w, b)
    assert qt.w_q.dtype == torch.int8 and qt.w_scale.dtype == torch.float32
    np.testing.assert_array_equal(qt.w_q.numpy(), np.asarray(qj.w_q))
    np.testing.assert_array_equal(qt.w_scale.numpy(), np.asarray(qj.w_scale))
    np.testing.assert_array_equal(qt.bias.numpy(), np.asarray(qj.bias))
    assert _pair(w, None)[1].bias is None
    # the kernel's layout contract: contiguous (K, N) buffers whatever w's strides
    q_t = tq.quantize_weight(torch.tensor(np.asfortranarray(w)), torch.tensor(b))
    assert q_t.w_q.is_contiguous() and torch.equal(q_t.w_q, qt.w_q)


@pytest.mark.parametrize("K", [32, 36, 96])
def test_kernel_layout_of_the_weight(K):
    """w_nk, the copy the CUDA kernel's tensor cores read, made once per
    QuantizedLinear: row n is column n of JAX's w_q, zero-padded to a
    multiple of 32 bytes; a derived buffer that .to() carries and the state
    dict leaves out."""
    w, b = _weights(K=K, N=40, seed=9)
    qj, qt = _pair(w, b)
    Kp = -(-K // 32) * 32
    assert qt.w_nk.shape == (40, Kp) and qt.w_nk.dtype == torch.int8
    assert qt.w_nk.is_contiguous()
    np.testing.assert_array_equal(qt.w_nk[:, :K].numpy(), np.asarray(qj.w_q).T)
    assert not qt.w_nk[:, K:].any()
    assert set(qt.state_dict()) == {"w_q", "w_scale", "bias"}
    moved = qt.to("meta")
    assert moved.w_nk.device.type == "meta" and moved.w_q.device.type == "meta"


def test_row_codes_match_jax():
    """The activations' int8 codes and scales, as jq.dynamic_int8_matmul
    forms them (quant.py:41-44)."""
    x = _x((30, 96), seed=1)
    amax = jnp.max(jnp.abs(jnp.asarray(x)), axis=1, keepdims=True)
    xs_j = jnp.maximum(amax, 1e-8) / 127.0
    xq_j = jnp.clip(jnp.round(jnp.asarray(x) / xs_j), -127, 127).astype(jnp.int8)
    xq_t, xs_t = tq._quantize_rows(torch.tensor(x))
    np.testing.assert_array_equal(xq_t.numpy().astype(np.int8), np.asarray(xq_j))
    np.testing.assert_array_equal(xs_t.numpy(), np.asarray(xs_j))


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("out_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_dynamic_int8_matmul_bit_equal_to_jax(x_dtype, out_dtype, with_bias):
    w, b = _weights(seed=2)
    qj, qt = _pair(w, b if with_bias else None)
    for shape in ((10, 96), (2, 7, 96)):
        xj = jnp.asarray(_x(shape, seed=3), x_dtype)
        xt = torch.tensor(np.asarray(xj, np.float32)).to(TORCH[x_dtype])
        want = np.asarray(jq.dynamic_int8_matmul(xj, qj, out_dtype), np.float32)
        got = tq.dynamic_int8_matmul(xt, qt, TORCH[out_dtype])
        assert got.shape == want.shape == (*shape[:-1], 48) and got.dtype == TORCH[out_dtype]
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_fused_int8_matmul_on_cpu_matches_jax_kernel():
    """tests/test_kernels.py:159-181 on its own inputs (jax.random keys 6-8,
    handed to the port as numpy): the Pallas kernel in interpret mode vs the
    port's fused_int8_matmul on a CPU tensor (its plain version; no launch
    is counted), and the port bit for bit against JAX's plain version. (On
    other inputs the interpret-mode kernel can put one int8 code one step
    from JAX's own dynamic_int8_matmul, as XLA lowers its division there.)"""
    K, N = 32, 24
    w = np.asarray(jax.random.normal(jax.random.key(6), (K, N), jnp.float32))
    b = np.asarray(jax.random.normal(jax.random.key(7), (N,), jnp.float32))
    before = tq.fused_int8_matmul.launches
    for bias in (b, None):
        qj, qt = _pair(w, bias)
        for shape in ((10, K), (2, 7, K)):
            xj = jax.random.normal(jax.random.key(8), shape, jnp.bfloat16)
            want = np.asarray(jq.fused_int8_matmul(xj, qj, block_m=4, interpret=True), np.float32)
            got = tq.fused_int8_matmul(torch.tensor(np.asarray(xj, np.float32)).bfloat16(), qt)
            got = got.float().numpy()
            assert got.shape == want.shape == (*shape[:-1], N)
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
            assert np.mean(np.abs(got - want)) < 1e-2
            np.testing.assert_array_equal(got, np.asarray(jq.dynamic_int8_matmul(xj, qj),
                                                          np.float32))
    assert tq.fused_int8_matmul.launches == before


def test_int8_matmul_accuracy_against_float():
    """tests/test_kernels.py:60-73: within ~1% of the float product."""
    w, b = _weights(seed=4)
    x = np.random.default_rng(5).normal(size=(64, 96)).astype(np.float32)
    got = tq.dynamic_int8_matmul(torch.tensor(x), tq.quantize_weight(torch.tensor(w),
                                                                      torch.tensor(b)),
                                 torch.float32).numpy()
    ref = x @ w + b
    assert np.abs(got - ref).mean() / np.abs(ref).mean() < 0.02


def test_fused_int8_matmul_rejects_other_devices():
    _, qt = _pair(*_weights())
    with pytest.raises(ValueError, match="cuda"):
        tq.fused_int8_matmul(torch.zeros((2, 96), device="meta"), qt)


# ------------------------------------------------------------- int8 forward


def _toy_pair(head_multiple=1):
    cfg = jax_cfg("dedeit", **TOY)
    model = VisionTransformer(cfg, dtype=jnp.float32)
    params = model.init(jax.random.key(1), jnp.zeros((2, 32, 32, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    head = np.array([[1, 0, 1, 1], [0, 1, 0, 0]], np.float32)
    neuron = np.zeros((2, 256), np.float32)
    neuron[0, :100] = 1
    neuron[1, 50:60] = 1
    jcm = jcv.compact_vit_ragged(params, JGates(jnp.asarray(head), jnp.asarray(neuron)), cfg,
                                 head_multiple=head_multiple, neuron_multiple=8)
    tcm = compact_from_jax_params(params, (head, neuron), get_vit_config("dedeit", **TOY),
                                  head_multiple=head_multiple, neuron_multiple=8, device="cpu")
    return jcm, tcm


@pytest.mark.parametrize("head_multiple", [1, 2, 4])
def test_head_multiple_rounds_as_jax(head_multiple):
    jcm, tcm = _toy_pair(head_multiple)
    assert tcm.num_heads == [lp["num_heads"] for lp in jcm.layers]
    for jl, tl in zip(jcm.layers, tcm.layers):
        np.testing.assert_array_equal(tl.qkv_kernel.numpy(), np.asarray(jl["qkv_kernel"]))
        np.testing.assert_array_equal(tl.proj_kernel.numpy(), np.asarray(jl["proj_kernel"]))


def _int8_forward_pair(jcm, tcm, imgs, patch):
    """(port int8 logits, JAX int8 logits, port float logits), f32, strict
    numerics. The port's float forward matches JAX's (test_torch_compact.py)."""
    want = np.asarray(jcv.compact_forward(jcv.quantize_compact(jcm), jnp.asarray(imgs),
                                          patch_size=patch, dtype=jnp.float32,
                                          use_pallas=False, fast_math=False, int8=True))
    kw = dict(patch_size=patch, dtype=torch.float32, fast_math=False)
    with torch.inference_mode():
        got = compact_forward(quantize_compact(tcm), torch.tensor(imgs), int8=True, **kw)
        flt = compact_forward(tcm, torch.tensor(imgs), **kw)
    return got.numpy(), want, flt.numpy()


def test_int8_compact_forward_matches_jax_toy():
    jcm, tcm = _toy_pair()
    imgs = np.random.default_rng(7).normal(size=(3, 32, 32, 3)).astype(np.float32)
    got, want, flt = _int8_forward_pair(jcm, tcm, imgs, 8)
    assert got.shape == (3, 9)
    assert _rel(got, want) <= 1e-3
    assert np.abs(got - flt).mean() / (np.abs(flt).mean() + 1e-9) < 0.1


def test_int8_compact_forward_matches_jax_full_width_division():
    """Division 0 of the deployed ensemble (dedeit, 12 ragged layers), B 2."""
    cfg, params_list, gates_list = deploy.build_inputs(1)
    params, gates = params_list[0], gates_list[0]
    jcm = jcv.compact_vit_ragged(params, JGates(jnp.asarray(gates.head),
                                                jnp.asarray(gates.neuron)),
                                 jax_cfg("dedeit", num_classes=25))
    tcm = compact_vit_ragged(params, Gates(np.asarray(gates.head), np.asarray(gates.neuron)),
                             cfg, device="cpu")
    imgs = np.random.default_rng(8).normal(size=(2, 224, 224, 3)).astype(np.float32)
    got, want, flt = _int8_forward_pair(jcm, tcm, imgs, 16)
    assert got.shape == (2, 25)
    assert _rel(got, want) <= 1e-3
    assert np.abs(got - flt).mean() / (np.abs(flt).mean() + 1e-9) < 0.1


def test_quantize_compact_layout_and_guards():
    _, tcm = _toy_pair()
    q = quantize_compact(tcm)
    assert q.quantized and not tcm.quantized  # a copy: the float model is untouched
    lp = q.layers[0]
    for name in ("qkv", "proj", "fc1", "fc2"):
        ql = getattr(lp, f"{name}_q")
        assert ql.w_q.dtype == torch.int8 and not hasattr(lp, f"{name}_kernel")
        assert set(dict(ql.named_buffers())) <= {"w_q", "w_scale", "bias", "w_nk"}
    x = torch.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="quantize_compact"):
        compact_forward(tcm, x, patch_size=8, int8=True)
    with pytest.raises(ValueError, match="quantize_compact"):
        compact_forward(q, x, patch_size=8)
