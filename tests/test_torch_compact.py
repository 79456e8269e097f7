"""Port ragged-compact forward (devit_tpu_torch/models/compact_vit.py) vs the
JAX package's compact_forward, on the same numpy weights and inputs.

The port's kernel path (use_kernel=True, which on the CPU takes the plain
attention) is held against the JAX forward through the Pallas kernel in
interpret mode (force_pallas=True); its plain path against use_pallas=False."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.models import compact_vit as jcv
from devit_tpu.models.vit import Gates as JGates
from devit_tpu.models.vit import VisionTransformer
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.io.bridge import compact_from_jax_params
from devit_tpu_torch.models import compact_vit as tcv
from devit_tpu_torch.models.vit import Gates

TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4, num_classes=9)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _toy(kept=((1, 50), (4, 200), (2, 120)), seed=3):
    cfg = jax_cfg("dedeit", **TOY)
    x = np.random.default_rng(seed).standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = VisionTransformer(cfg, dtype=jnp.float32).init(
        jax.random.key(1), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    head = np.zeros((3, 4), np.float32)
    neuron = np.zeros((3, 256), np.float32)
    for l, (hk, nk) in enumerate(kept):
        head[l, rng.choice(4, hk, replace=False)] = 1
        neuron[l, rng.choice(256, nk, replace=False)] = 1
    return cfg, params, (head, neuron), x


def _jax_forward(cm, x, *, dtype, fast_math, kernel, patch_size=8, **kw):
    return jcv.compact_forward(cm, jnp.asarray(x), patch_size=patch_size, dtype=dtype,
                               use_pallas=kernel, force_pallas=kernel,
                               fast_math=fast_math, **kw)


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("features_only", [False, True])
def test_toy_f32_matches_jax(kernel, features_only):
    cfg, params, gates, x = _toy()
    jcm = jcv.compact_vit_ragged(params, JGates(*map(jnp.asarray, gates)), cfg,
                                 neuron_multiple=8)
    tcm = compact_from_jax_params(params, gates, get_vit_config("dedeit", **TOY),
                                  neuron_multiple=8, device="cpu")
    assert tcm.num_heads == [1, 4, 2]
    assert [lp.fc1_kernel.shape[1] for lp in tcm.layers] == [56, 200, 120]
    want = _jax_forward(jcm, x, dtype=jnp.float32, fast_math=False, kernel=kernel,
                        features_only=features_only)
    got = tcv.compact_forward(tcm, torch.from_numpy(x), patch_size=8, dtype=torch.float32,
                              use_kernel=kernel, fast_math=False,
                              features_only=features_only)
    if not features_only:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", [True, False])
def test_toy_bf16_fast_math_matches_jax(kernel):
    cfg, params, gates, x = _toy()
    jcm = jcv.compact_vit_ragged(params, JGates(*map(jnp.asarray, gates)), cfg,
                                 neuron_multiple=8)
    tcm = compact_from_jax_params(params, gates, get_vit_config("dedeit", **TOY),
                                  neuron_multiple=8, device="cpu")
    want = _jax_forward(jcm, x, dtype=jnp.bfloat16, fast_math=True, kernel=kernel)
    got = tcv.compact_forward(tcm, torch.from_numpy(x), patch_size=8,
                              dtype=torch.bfloat16, use_kernel=kernel, fast_math=True)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 2e-2


def test_zero_kept_head_layer_becomes_one_dummy_head():
    cfg, params, gates, x = _toy(kept=((0, 64), (3, 128), (2, 8)))
    jcm = jcv.compact_vit_ragged(params, JGates(*map(jnp.asarray, gates)), cfg,
                                 neuron_multiple=8)
    tcm = compact_from_jax_params(params, gates, get_vit_config("dedeit", **TOY),
                                  neuron_multiple=8, device="cpu")
    assert tcm.num_heads == [lp["num_heads"] for lp in jcm.layers] == [1, 3, 2]
    dummy = tcm.layers[0]
    assert not dummy.qkv_kernel.any() and not dummy.qkv_bias.any()
    assert not dummy.proj_kernel.any()
    want = _jax_forward(jcm, x, dtype=jnp.float32, fast_math=False, kernel=False)
    got = tcv.compact_forward(tcm, torch.from_numpy(x), patch_size=8,
                              dtype=torch.float32, use_kernel=True, fast_math=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_rejects_fractional_gates_and_representation_head():
    cfg, params, (head, neuron), _ = _toy()
    tcfg = get_vit_config("dedeit", **TOY)
    with pytest.raises(ValueError, match="binary"):
        tcv.compact_vit_ragged(params, Gates(np.full((3, 4), 0.5, np.float32), neuron),
                               tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="representation_size"):
        tcv.compact_vit_ragged(params, Gates(head, neuron),
                               tcfg.replace(representation_size=32), device="cpu")


def test_full_dedeit_division_matches_jax():
    jcfg, jparams, jgates = bench.build_inputs(num_div=1)
    params = jparams[0]
    gates = tuple(np.asarray(g) for g in jgates[0])
    jcm = jcv.compact_vit_ragged(params, jgates[0], jcfg)
    tcm = compact_from_jax_params(params, gates, get_vit_config("dedeit", num_classes=25),
                                  device="cpu")
    assert tcm.num_heads == [lp["num_heads"] for lp in jcm.layers]
    x = np.random.default_rng(7).standard_normal((1, 224, 224, 3)).astype(np.float32)
    want = _jax_forward(jcm, x, dtype=jnp.float32, fast_math=False, kernel=False,
                        patch_size=16)
    with torch.inference_mode():
        got = tcv.compact_forward(tcm, torch.from_numpy(x), patch_size=16,
                                  dtype=torch.float32, use_kernel=True, fast_math=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
