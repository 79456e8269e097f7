"""Port base ops (devit_tpu_torch/models/vit.py) vs the JAX package's:
LayerNorm with f32 and bf16 statistics, the A&S erf and exact-erf GELU, the
tanh GELU of fast_math, and the flax parameter-tree shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.models import vit as jvit
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.models import vit as tvit


def _x(shape, seed, scale=3.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


@pytest.mark.parametrize("stat", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm(stat, dtype):
    x, s, b = _x((2, 7, 384), 0), _x((384,), 1, 0.5), _x((384,), 2, 0.5)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    td = {"f32": torch.float32, "bf16": torch.bfloat16}
    want = jvit._layer_norm(jnp.asarray(x).astype(jd[dtype]), jnp.asarray(s),
                            jnp.asarray(b), 1e-6, jd[stat])
    got = tvit.layer_norm(torch.from_numpy(x).to(td[dtype]), torch.from_numpy(s),
                          torch.from_numpy(b), 1e-6, td[stat])
    assert got.dtype == td[dtype]
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "f32" and stat == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:  # bf16 rounding of the statistics and the output
        assert _rel(got, want) <= 2e-2


@pytest.mark.parametrize("fn", ["fast_erf", "fast_gelu"])
def test_fast_erf_and_gelu(fn):
    x = _x((4096,), 3)
    want = np.asarray(getattr(jvit, fn)(jnp.asarray(x)))
    got = getattr(tvit, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # output cast back to the input dtype, as vit.py:125 does
    assert getattr(tvit, fn)(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_gelu_tanh_matches_jax_approximate_gelu():
    x = _x((4096,), 4)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(tvit.gelu_tanh(torch.from_numpy(x)).numpy(), want,
                               rtol=1e-5, atol=1e-6)


TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4, num_classes=9)


@pytest.mark.parametrize("overrides", [
    dict(num_classes=25),
    TOY,
    dict(TOY, representation_size=32),
    dict(TOY, resize_dim=96),
    dict(TOY, qkv_bias=False),
])
@pytest.mark.parametrize("name", ["dedeit", "devit"])
def test_param_shapes_and_leaf_order_match_flax(name, overrides):
    jc = jax_cfg(name, **overrides)
    sample = jnp.zeros((1, jc.img_size, jc.img_size, 3))
    want = jax.eval_shape(jvit.VisionTransformer(jc).init, jax.random.key(0), sample)["params"]
    want_leaves = [tuple(l.shape) for l in jax.tree_util.tree_leaves(want)]
    want_paths = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(want)[0]]

    got = tvit.vit_param_shapes(get_vit_config(name, **overrides))
    got_leaves = []
    tvit.map_leaves(got_leaves.append, got)

    def paths(t, pre=""):
        for k in t:
            if isinstance(t[k], dict):
                yield from paths(t[k], f"{pre}['{k}']")
            else:
                yield f"{pre}['{k}']"

    got_paths = list(paths(got))
    assert got_paths == want_paths
    assert got_leaves == want_leaves
