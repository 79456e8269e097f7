"""The port's CCT family (devit_tpu_torch/models/cct.py, the CCT part of
models/ensemble.py and io/checkpoint.py) against the JAX package's, on the
same numpy-seeded weights and inputs, at f32 and the JAX CCT tests' toy
geometry (tests/test_cct.py: 32-px images, a 3x3 one- or two-stage
tokenizer, two layers). Every draw is off (no dropout, no drop-path).

Tolerances: activations and logits rtol 1e-4, atol 2e-5 (f32 products and
softmaxes summed in another order); the checkpoint converters and the
sinusoidal embedding exactly, resize_cct_pos_embed 1e-6 (both interpolate
in f64 and round once)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu import configs as jcfg
from devit_tpu.io import checkpoint as jckpt
from devit_tpu.models import cct as jcct
from devit_tpu.models import ensemble as jens
from devit_tpu.models.vit import Gates as JGates
from devit_tpu_torch import configs as tcfg
from devit_tpu_torch.io import checkpoint as tckpt
from devit_tpu_torch.io.bridge import (
    _load_module, cct_from_jax_params, stacked_vit_from_jax_params, vit_to_jax_params,
)
from devit_tpu_torch.models import cct as tcct
from devit_tpu_torch.models import create_model
from devit_tpu_torch.models.ensemble import EnsembleCCT, multicct_features
from devit_tpu_torch.models.vit import Gates

RTOL, ATOL = 1e-4, 2e-5
NO_DRAWS = dict(stochastic_depth=0.0, attention_dropout=0.0, dropout=0.0)
TOY = dict(img_size=32, embed_dim=64, num_heads=4, num_layers=2, num_classes=7, **NO_DRAWS)


def _images(B, seed, side=32):
    return np.random.default_rng(seed).standard_normal((B, side, side, 3)).astype(np.float32)


def _jax_model(name, seed, **kw):
    m = jcct.create_cct(name, dtype=jnp.float32, **kw)
    side = m.cfg.img_size
    params = m.init(jax.random.key(seed), jnp.zeros((1, side, side, 3)),
                    capture_outputs=True)["params"]
    return m, jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", ["cct_2_3x1_32", "cct_7_3x1_32", "cct_7_7x2_224",
                                  "cct_14_7x2_224", "decct_7_3x1"])
def test_configs_equal_jax_and_sequence_length_is_the_tokenizers(name):
    base = name.replace("decct", "cct", 1)
    got, want = tcfg.get_cct_config(base), jcfg.get_cct_config(base)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.sequence_length() == want.sequence_length()
    assert (got.conv_stride, got.conv_padding, got.depth, got.hidden_dim) == (
        want.conv_stride, want.conv_padding, want.depth, want.hidden_dim)
    tok = tcct.Tokenizer(got)
    side = got.img_size
    with torch.no_grad():
        out = tok(torch.zeros((1, side, side, 3)), torch.float32)
    assert out.shape == (1, got.sequence_length(), got.embed_dim)
    model = create_model(name, dtype=torch.float32, device="cpu")
    assert model.cfg.backbone == name.startswith("decct")


@pytest.mark.parametrize("kernel,stages", [(3, 1), (3, 2), (7, 2)])
def test_tokenizer_matches_jax(kernel, stages):
    cfg = jcfg.get_cct_config("cct_2", img_size=32, embed_dim=32, kernel_size=kernel,
                              n_conv_layers=stages)
    jt = jcct.Tokenizer(cfg, dtype=jnp.float32)
    x = _images(2, kernel + stages)
    params = jax.device_get(jt.init(jax.random.key(stages), jnp.asarray(x))["params"])
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(x)))
    tt = _load_module(tcct.Tokenizer(tcfg.get_cct_config(
        "cct_2", img_size=32, embed_dim=32, kernel_size=kernel, n_conv_layers=stages)),
        params, "cpu")
    with torch.no_grad():
        got = tt(torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == want.shape == (2, cfg.sequence_length(), 32)
    _close(got, want, "tokens")


def test_cct_layer_matches_jax_with_its_captures():
    cfg = jcfg.get_cct_config("cct_2", embed_dim=32, num_heads=4, mlp_ratio=2.0, **NO_DRAWS)
    layer = jcct.CCTLayer(cfg, capture_qkv="all", capture_outputs=True,
                          capture_rank_stats=True, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    hg = np.array([1, 0, 1, 1], np.float32)
    ng = (rng.random(64) > 0.3).astype(np.float32)
    slot = jnp.zeros((3, 2, 4, 9, 8))
    per = (jnp.asarray(hg), jnp.asarray(ng), jnp.float32(0.0), jnp.int32(0))
    params = jax.device_get(layer.init(jax.random.key(0), (jnp.asarray(x), slot), per)["params"])
    (want_x, _), outs = layer.apply({"params": params}, (jnp.asarray(x), slot), per)
    tl = _load_module(tcct.CCTLayer(tcfg.get_cct_config("cct_2", embed_dim=32, num_heads=4,
                                                         mlp_ratio=2.0, **NO_DRAWS)),
                      params, "cpu")
    with torch.no_grad():
        got_x, got = tl(torch.from_numpy(x), torch.from_numpy(hg), torch.from_numpy(ng), 0.0,
                        None, None, dtype=torch.float32, train=False, capture_qkv=True,
                        capture_rank_stats=True, capture_outputs=True)
    _close(got_x, want_x, "layer output")
    for k, g in (("qkv", got["qkv"]), ("attn", got["attn"]), ("hidden", got["hidden"]),
                 ("neuron_act", got["neuron_act"]), ("head_out", got["head_out"])):
        _close(g, outs[k], k)


@pytest.mark.parametrize("variant", [
    dict(capture_qkv="all"), dict(capture_qkv="middle", gated=True),
    dict(capture_qkv="middle", positional_embedding="sine", seq_pool=False),
    dict(capture_qkv="none", positional_embedding="none", resize_dim=48, gated=True)])
def test_cct_forward_with_every_capture_matches_jax(variant):
    variant = dict(variant)
    capture, gated = variant.pop("capture_qkv"), variant.pop("gated", False)
    jm, params = _jax_model("cct_2_3x1_32", 3, **TOY, **variant)
    model = cct_from_jax_params(params, tcfg.get_cct_config("cct_2_3x1_32", **TOY, **variant),
                                device="cpu", dtype=torch.float32)
    x = _images(3, 4)
    L, H, hid = 2, 4, model.cfg.hidden_dim
    gates = None
    if gated:
        rng = np.random.default_rng(6)
        gates = ((rng.random((L, H)) > 0.4).astype(np.float32),
                 (rng.random((L, hid)) > 0.3).astype(np.float32))
    kw = dict(capture_qkv=capture, capture_outputs=True, capture_rank_stats=True)
    want = jm.apply({"params": params}, jnp.asarray(x),
                    None if gates is None else JGates(*map(jnp.asarray, gates)), **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x), None if gates is None else Gates(
            *map(torch.from_numpy, gates)), **kw)
    for k in ("logits", "pooled", "attn", "hidden", "qkv", "neuron_act", "head_out"):
        w, g = getattr(want, k), getattr(got, k)
        assert (w is None) == (g is None), k
        if w is not None:
            _close(g, w, k)
    assert got.cls_logits is got.logits and got.dist_logits is None
    assert got.last_tokens is got.pooled


def test_gate_rows_equal_one_forward_a_candidate():
    """Candidate gates folded into the batch (core/shrink.py): one gate row a
    batch row gives each row what its own gated forward gives."""
    model = tcct.create_cct("cct_2_3x1_32", dtype=torch.float32, device="cpu", **TOY)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_images(1, 9)).expand(3, -1, -1, -1)
    heads = torch.from_numpy((rng.random((2, 3, 4)) > 0.4).astype(np.float32))
    neurons = torch.from_numpy((rng.random((2, 3, model.cfg.hidden_dim)) > 0.3).astype(
        np.float32))
    with torch.no_grad():
        folded = model(x, Gates(heads, neurons)).logits
        for c in range(3):
            one = model(x[c:c + 1], Gates(heads[:, c], neurons[:, c])).logits
            np.testing.assert_allclose(folded[c:c + 1].numpy(), one.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_decct_backbone_and_ensemble_match_jax():
    kw = dict(img_size=32, embed_dim=64, num_heads=4, num_layers=2, **NO_DRAWS)
    jm, p0 = _jax_model("decct_2_3x1", 0, **kw)
    _, p1 = _jax_model("decct_2_3x1", 1, **kw)
    assert jm.cfg.backbone and "fc" not in p0
    stacked = jax.tree_util.tree_map(lambda *a: np.stack(a), p0, p1)
    x = _images(2, 10)
    gates = JGates(jnp.asarray([[[1, 0, 1, 1], [1, 1, 1, 0]], [[1, 1, 1, 1], [0, 1, 1, 1]]],
                               jnp.float32), jnp.ones((2, 2, jm.cfg.hidden_dim)))
    want = np.asarray(jens.multicct_features(jm, {"params": stacked}, jnp.asarray(x), gates))
    model = tcct.create_cct("decct_2_3x1", dtype=torch.float32, device="cpu", **kw)
    tstacked = stacked_vit_from_jax_params(stacked, model, device="cpu")
    with torch.no_grad():
        got = multicct_features(model, tstacked, torch.from_numpy(x),
                                Gates(*(torch.from_numpy(np.asarray(g)) for g in gates)))
    _close(got, want, "division features")

    jens_m = jens.EnsembleCCT(num_classes=10, sub_size=64, num_divisions=2, teacher_size=48,
                              dtype=jnp.float32)
    ev = jax.device_get(jens_m.init(jax.random.key(2), jnp.asarray(want), distill=True,
                                    train=True)["params"])
    w = jens_m.apply({"params": ev}, jnp.asarray(want), distill=True, train=True)
    tens = EnsembleCCT(num_classes=10, sub_size=64, num_divisions=2, teacher_size=48,
                       dtype=torch.float32).load_params(ev)
    with torch.no_grad():
        g = tens(torch.from_numpy(want), distill=True, train=True)
        plain = tens(torch.from_numpy(want))
    _close(g.logits, w.logits, "ensemble logits")
    _close(g.ens_tokens, w.ens_tokens, "ensemble tokens")
    assert plain.ens_tokens is None and g.logits.shape == (2, 10)


def test_sinusoidal_embedding_equals_jax():
    for n, dim in ((5, 8), (64, 32), (197, 384)):
        np.testing.assert_array_equal(tcct.sinusoidal_embedding(n, dim),
                                      jcct.sinusoidal_embedding(n, dim))


def _reference_state_dict(rng, L, nconv, D=32, prefix="classifier.", fc=True):
    sd = {f"tokenizer.conv_layers.{i}.0.weight": rng.standard_normal(
        (64 if i < nconv - 1 else D, 3 if i == 0 else 64, 3, 3)).astype(np.float32)
        for i in range(nconv)}
    for i in range(L):
        b = f"{prefix}blocks.{i}."
        for ln in ("pre_norm", "norm1"):
            sd[b + ln + ".weight"] = rng.standard_normal(D).astype(np.float32)
            sd[b + ln + ".bias"] = rng.standard_normal(D).astype(np.float32)
        sd[b + "self_attn.qkv.weight"] = rng.standard_normal((3 * D, D)).astype(np.float32)
        for name, (o, i_) in (("self_attn.proj", (D, D)), ("linear1", (2 * D, D)),
                              ("linear2", (D, 2 * D))):
            sd[b + name + ".weight"] = rng.standard_normal((o, i_)).astype(np.float32)
            sd[b + name + ".bias"] = rng.standard_normal(o).astype(np.float32)
    sd[prefix + "norm.weight"] = rng.standard_normal(D).astype(np.float32)
    sd[prefix + "norm.bias"] = rng.standard_normal(D).astype(np.float32)
    sd[prefix + "attention_pool.weight"] = rng.standard_normal((1, D)).astype(np.float32)
    sd[prefix + "attention_pool.bias"] = rng.standard_normal(1).astype(np.float32)
    sd[prefix + "positional_emb"] = rng.standard_normal((1, 256, D)).astype(np.float32)
    if fc:
        sd[prefix + "fc.weight"] = rng.standard_normal((7, D)).astype(np.float32)
        sd[prefix + "fc.bias"] = rng.standard_normal(7).astype(np.float32)
    return sd


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("nconv,prefix,fc", [(1, "classifier.", True), (2, "classifier.", True),
                                             (1, "encoders.", False)])
def test_torch_cct_to_params_equals_jax(nconv, prefix, fc):
    sd = _reference_state_dict(np.random.default_rng(nconv), 2, nconv, prefix=prefix, fc=fc)
    got = tckpt.torch_cct_to_params(sd, num_layers=2, n_conv_layers=nconv)
    want = jckpt.torch_cct_to_params(sd, num_layers=2, n_conv_layers=nconv)
    _assert_trees_equal(got, want)
    if nconv == 1 and fc:  # the tree loads into the port's CCT as into the JAX one
        cfg = dict(img_size=32, embed_dim=32, num_heads=4, num_layers=2, num_classes=7,
                   mlp_ratio=2.0)
        model = cct_from_jax_params(got, tcfg.get_cct_config("cct_2_3x1_32", **cfg),
                                    device="cpu", dtype=torch.float32)
        _assert_trees_equal(vit_to_jax_params(model), jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), want))


@pytest.mark.parametrize("n_old,n_new,prefix", [(64, 256, 0), (196, 64, 0), (1 + 16, 1 + 4, 1),
                                                (256, 256, 0)])
def test_resize_cct_pos_embed_matches_jax(n_old, n_new, prefix):
    pe = np.random.default_rng(n_old).standard_normal((1, n_old, 8)).astype(np.float32)
    got = tckpt.resize_cct_pos_embed(pe, n_new, prefix)
    want = jckpt.resize_cct_pos_embed(pe, n_new, prefix)
    assert got.shape == want.shape == (1, n_new, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="CCT pos-embed grid not square"):
        tckpt.resize_cct_pos_embed(pe, n_new + 1, prefix)


def test_full_width_parameter_tree_equals_jax():
    """cct_7_3x1_32 and cct_14_7x2_224 at full width: the port's parameter
    tree has the JAX package's leaves and shapes."""
    for name in ("cct_7_3x1_32", "cct_14_7x2_224"):
        jm = jcct.create_cct(name, num_classes=100, dtype=jnp.float32)
        side = jm.cfg.img_size
        want = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, side, side, 3))))
        got = vit_to_jax_params(create_model(name, num_classes=100, device="cpu"))
        want_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), want["params"])
        got_shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), got)
        assert got_shapes == want_shapes, name
