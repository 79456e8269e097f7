"""Port VisionTransformer (devit_tpu_torch/models/vit.py) and its bridge
(devit_tpu_torch/io/bridge.py) vs the JAX package's flax model on the same
numpy parameters and inputs, at f32: logits and every capture, gradients
with the kernel path on and off, remat with drop-path, the weight-decay mask
leaf by leaf, and one full-width dedeit forward + backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.models import vit as jvit
from devit_tpu.train import optim as joptim
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.io.bridge import vit_from_jax_params, vit_to_jax_params
from devit_tpu_torch.models import vit as tvit
from devit_tpu_torch.train import optim as toptim

TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=7)
CAPTURES = ("logits", "cls_logits", "dist_logits", "cls_feat", "dist_feat", "qkv", "attn",
            "encoders", "embedding", "neuron_act", "head_out")


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _setup(name="dedeit", seed=0, B=2, **overrides):
    kw = dict(TOY, **overrides)
    jm = jvit.VisionTransformer(jax_cfg(name, **kw), dtype=jnp.float32)
    x = np.random.default_rng(seed).standard_normal((B, kw["img_size"], kw["img_size"], 3))
    x = x.astype(np.float32)
    params = jax.device_get(jm.init(jax.random.key(seed), jnp.asarray(x))["params"])
    return get_vit_config(name, **kw), params, x


def _gates(seed=1):
    rng = np.random.default_rng(seed)
    head = (rng.random((2, 4)) > 0.3).astype(np.float32)
    neuron = (rng.random((2, 256)) > 0.3).astype(np.float32)
    return head, neuron


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def test_bridge_round_trip_is_bit_exact():
    cfg, params, _ = _setup(resize_dim=96)
    back = vit_to_jax_params(vit_from_jax_params(params, cfg, device="cpu"))
    want, got = _flat(params), _flat(back)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name,overrides", [("dedeit", {}), ("devit", dict(resize_dim=96)),
                                            ("devit", dict(representation_size=32))])
@pytest.mark.parametrize("capture_qkv", ["all", "middle"])
def test_logits_and_captures_match_jax(name, overrides, capture_qkv):
    cfg, params, x = _setup(name, **overrides)
    head, neuron = _gates()
    kw = dict(capture_qkv=capture_qkv, capture_block_outputs=True, capture_embedding=True,
              capture_rank_stats=True, distill_token=True)
    jm = jvit.VisionTransformer(jax_cfg(name, **dict(TOY, **overrides)), dtype=jnp.float32)
    want = jm.apply({"params": params}, jnp.asarray(x),
                    gates=jvit.Gates(jnp.asarray(head), jnp.asarray(neuron)), **kw)
    model = vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32)
    got = model(torch.from_numpy(x), tvit.Gates(torch.from_numpy(head),
                                                torch.from_numpy(neuron)), **kw)
    for field in CAPTURES:
        w, g = getattr(want, field), getattr(got, field)
        if w is None:
            assert g is None, field
            continue
        assert tuple(g.shape) == w.shape, field
        assert _rel(g.detach(), w) <= 1e-5, field
    wt = jax.tree_util.tree_leaves(want.last_tokens)
    gt = [t.detach() for t in (got.last_tokens if isinstance(got.last_tokens, tuple)
                               else (got.last_tokens,))]
    assert len(wt) == len(gt) and all(_rel(g, w) <= 1e-5 for g, w in zip(gt, wt))


def test_middle_capture_layer_and_features_only():
    cfg, params, x = _setup(depth=1)
    jm = jvit.VisionTransformer(jax_cfg("dedeit", **dict(TOY, depth=1)), dtype=jnp.float32)
    want = jm.apply({"params": params}, jnp.asarray(x), capture_qkv="middle",
                    features_only=True)
    model = vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32)
    got = model(torch.from_numpy(x), capture_qkv="middle", features_only=True)
    assert got.cls_logits is None and _rel(got.logits.detach(), want.logits) <= 1e-5
    assert np.abs(np.asarray(want.qkv)).max() > 0  # depth 1 wraps to layer 0
    assert _rel(got.qkv.detach(), want.qkv) <= 1e-5


def _loss_weights(shape, seed=5):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_grads(model, x, gates, w, train=True):
    out = model(torch.from_numpy(x), gates, train=train)
    loss = (out.cls_logits * torch.from_numpy(w)).sum() + (out.dist_logits ** 2).sum()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.item(), vit_to_jax_params(dict(zip(names, grads)))


def test_gradients_match_jax_with_the_kernel_path_on_and_off():
    cfg, params, x = _setup()
    head, neuron = _gates()
    w = _loss_weights((2, 7))
    jm = jvit.VisionTransformer(jax_cfg("dedeit", **TOY), dtype=jnp.float32)
    jg = jvit.Gates(jnp.asarray(head), jnp.asarray(neuron))

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), gates=jg, train=True,
                       rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out.cls_logits * w) + jnp.sum(out.dist_logits ** 2)

    want_loss, want = jax.value_and_grad(jloss)(params)
    want = _flat(jax.device_get(want))
    tg = tvit.Gates(torch.from_numpy(head), torch.from_numpy(neuron))
    for use_kernel in (True, False):
        model = vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32,
                                    use_kernel=use_kernel)
        loss, got = _port_grads(model, x, tg, w)
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
        got = _flat(got)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-5, err_msg=str(k))


@pytest.mark.parametrize("rates", [dict(drop_path_rate=0.5),
                                   dict(drop_rate=0.3, attn_drop_rate=0.2)])
def test_remat_with_drop_path_gives_the_gradients_without_it(rates):
    """The drop-path masks are drawn before each checkpointed block, and
    dropout draws from a generator seeded per block, so the recompute in the
    backward sees the same masks."""
    cfg, params, x = _setup(**rates)
    w = _loss_weights((2, 7))
    grads = {}
    for remat, seed in ((True, 3), (False, 3), (False, 5)):
        model = vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32,
                                    use_remat=remat)
        gen = torch.Generator().manual_seed(seed)
        out = model(torch.from_numpy(x), train=True, generator=gen)
        loss = (out.cls_logits * torch.from_numpy(w)).sum() + (out.dist_logits ** 2).sum()
        grads[remat, seed] = _flat(vit_to_jax_params(dict(zip(
            [n for n, _ in model.named_parameters()],
            torch.autograd.grad(loss, list(model.parameters()))))))
    for k, g in grads[True, 3].items():
        np.testing.assert_allclose(g, grads[False, 3][k], rtol=1e-6, atol=1e-8, err_msg=str(k))
    # and the masks matter: another seed drops other branches
    k = ("blocks", "fc1", "kernel")
    assert not np.allclose(grads[False, 5][k], grads[False, 3][k])


def test_train_needs_a_generator_for_drop_path_and_rejects_remat_policy():
    cfg, params, x = _setup(drop_path_rate=0.1)
    model = vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="generator"):
        model(torch.from_numpy(x), train=True)
    # a policy factory's name, which JAX rejects at a training forward under remat
    model = vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32,
                                remat_policy="save_only_these_names")
    with pytest.raises(ValueError, match="remat_policy"):
        model(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0))


def test_decay_mask_matches_jax_leaf_by_leaf():
    cfg, params, _ = _setup(resize_dim=96)
    want = _flat(jax.device_get(joptim._decay_mask(params)))
    model = vit_from_jax_params(params, cfg, device="cpu")
    mask = toptim._decay_mask(dict(model.named_parameters()))
    got = _flat(vit_to_jax_params({k: torch.full((), float(v)) for k, v in mask.items()}))
    assert got.keys() == want.keys()
    for k in want:  # blocks: one value per layer, all equal to the stacked leaf's
        assert np.all(got[k] == float(want[k])), k
    assert want[("blocks", "qkv", "kernel")] and not want[("blocks", "qkv", "bias")]
    assert not want[("pos_embed",)] and want[("patch_embed", "kernel")]


def test_full_width_dedeit_forward_and_backward_match_jax_xla_path():
    """Full dedeit (384 wide, 12 layers, 6 heads, N = 198), 25 classes, B = 1,
    f32, train mode with remat (drop_path 0), seeded numpy parameters."""
    cfg = get_vit_config("dedeit", num_classes=25)
    rng = np.random.default_rng(0)
    params = tvit.map_leaves(lambda s: (0.02 * rng.standard_normal(s)).astype(np.float32),
                             tvit.vit_param_shapes(cfg))
    x = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    w = _loss_weights((1, 25))
    jm = jvit.VisionTransformer(jax_cfg("dedeit", num_classes=25), dtype=jnp.float32)

    @jax.jit
    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), train=True,
                       rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out.cls_logits * w) + jnp.sum(out.dist_logits ** 2)

    want_loss, want = jax.value_and_grad(jloss)(params)
    model = vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32)
    loss, got = _port_grads(model, x, None, w)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want, got = _flat(jax.device_get(want)), _flat(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-5, err_msg=str(k))
