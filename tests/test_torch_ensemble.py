"""Port EnsMLP (devit_tpu_torch/models/ensemble.py) vs the flax EnsMLP, with
the weights carried across by io/bridge.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.models.ensemble import EnsMLP as JEnsMLP
from devit_tpu_torch.io.bridge import ensmlp_from_jax_params

D, B, C, K = 4, 3, 384, 100


def _tokens(seed):
    return np.random.default_rng(seed).standard_normal((D, B, C)).astype(np.float32)


@pytest.mark.parametrize("teacher_size", [768, None])
@pytest.mark.parametrize("family", ["deit", "vit"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ensmlp_matches_flax(family, teacher_size, dtype):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ens = JEnsMLP(num_classes=K, sub_size=C, num_divisions=D,
                  teacher_size=teacher_size, family=family, dtype=jd)
    cls_t, dist_t = _tokens(0), _tokens(1)
    variables = ens.init(jax.random.key(9), jnp.asarray(cls_t), jnp.asarray(dist_t))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    want = ens.apply(variables, jnp.asarray(cls_t),
                     jnp.asarray(dist_t) if family == "deit" else None)

    port = ensmlp_from_jax_params(params, num_divisions=D, dtype=td, device="cpu")
    assert (port.num_classes, port.teacher_size, port.family, port.sub_size) == (
        K, teacher_size, family, C)
    with torch.no_grad():  # the head's parameters are trainable
        got = port(torch.from_numpy(cls_t),
                   torch.from_numpy(dist_t) if family == "deit" else None)
    assert got.logits.dtype == torch.float32
    for name in ("logits", "cls_logits", "dist_logits"):
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None
            continue
        if dtype == "f32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
        else:  # both round input, weights, product and bias add to bf16
            w = np.asarray(w, np.float32)
            assert np.abs(g.numpy() - w).max() / np.abs(w).max() <= 2e-2


def test_bridge_rejects_mismatched_trees():
    ens = JEnsMLP(num_classes=K, sub_size=C, num_divisions=D, teacher_size=768,
                  family="deit", dtype=jnp.float32)
    t = jnp.zeros((D, 1, C))
    params = jax.tree_util.tree_map(np.asarray, ens.init(jax.random.key(0), t, t)["params"])
    with pytest.raises(ValueError, match="multiple"):
        ensmlp_from_jax_params(params, num_divisions=5, device="cpu")
    params.pop("dist_mlp")
    with pytest.raises(ValueError, match="submodules"):
        ensmlp_from_jax_params(params, num_divisions=D, device="cpu")
