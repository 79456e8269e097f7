"""Port stage-5 ensemble training (devit_tpu_torch/models/ensemble.py
multivit_features, EnsMLP's training outputs, init_multivit and the stacking
helpers; io/bridge.py's stacked and EnsMLP converters; train/losses.ens_loss;
train/steps.make_ensemble_train_step and make_ensemble_eval_step) vs the
JAX package's, from the same numpy parameters and batches, at f32 and toy
width (4 divisions of a 2-layer dedeit, a 2-layer distilled teacher).

Tolerances: features, logits and losses of one forward rtol 1e-5 (2e-5
where 4 divisions and 2 layers add up); step losses 1e-5 relative. After
three Adam steps a parameter whose step-1 gradient is near zero can move by
+-lr on the sign of a rounding difference, so parameters and EMA are
compared, as in tests/test_torch_stage2.py, where the step-1 gradient exceeds
1e-4 of its leaf's largest, to atol 2e-6, and everywhere within 3 lr."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.core.rank import build_gates
from devit_tpu.data import mixup as jmix
from devit_tpu.models import ensemble as jens
from devit_tpu.models import vit as jvit
from devit_tpu.train import losses as jlosses
from devit_tpu.train import optim as joptim
from devit_tpu.train import steps as jsteps
from devit_tpu.train.state import TrainState as JState
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.data import mixup as tmix
from devit_tpu_torch.io.bridge import (
    ensmlp_from_jax_params, ensmlp_to_jax_params, stacked_vit_from_jax_params,
    stacked_vit_to_jax_params, vit_from_jax_params,
)
from devit_tpu_torch.models import ensemble as tens
from devit_tpu_torch.models.vit import Gates, VisionTransformer
from devit_tpu_torch.train import losses as tlosses
from devit_tpu_torch.train import optim as toptim
from devit_tpu_torch.train import steps as tsteps
from devit_tpu_torch.train.state import TrainState

TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=7)
TEACHER = dict(TOY, embed_dim=96)
D, B, K, LR, EMA = 4, 4, 7, 1e-3, 0.9
OPT = dict(lr=LR, min_lr=1e-5, warmup_lr=1e-4, warmup_epochs=1, epochs=3)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _gates(seed):
    """Stacked (D, ...) gates from build_gates at random ranks and sparsities."""
    rng = np.random.default_rng(seed)
    cfg = jax_cfg("dedeit", **TOY)
    L, H, hidden = cfg.depth, cfg.num_heads, cfg.hidden_dim
    gs = [build_gates(np.stack([rng.permutation(hidden) for _ in range(L)]),
                      np.stack([rng.permutation(H) for _ in range(L)]),
                      rng.uniform(0, 0.6, L), rng.choice([0.0, 0.25, 0.5], L))
          for _ in range(D)]
    head = np.stack([np.asarray(g.head) for g in gs]).astype(np.float32)
    neuron = np.stack([np.asarray(g.neuron) for g in gs]).astype(np.float32)
    return head, neuron


@pytest.fixture(scope="module")
def toy():
    """The JAX backbone, its D stacked divisions, an EnsMLP head and a
    teacher; the port's counterparts from the same numpy parameters."""
    jm = jvit.VisionTransformer(jax_cfg("dedeit", **TOY), dtype=jnp.float32)
    x = jnp.zeros((2, 32, 32, 3))
    jstacked = jax.device_get(jens.init_multivit(jm, jax.random.key(0), x, D)["params"])
    jhead = jens.EnsMLP(num_classes=K, sub_size=64, num_divisions=D, teacher_size=96,
                        family="deit", dtype=jnp.float32)
    tok = jnp.zeros((D, 2, 64))
    ens_params = jax.device_get(jhead.init(jax.random.key(1), tok, tok, distill=True,
                                           train=True)["params"])
    jteacher = jvit.VisionTransformer(jax_cfg("deit_base_distilled_patch16_224", **TEACHER),
                                      dtype=jnp.float32)
    t_params = jax.device_get(jteacher.init(jax.random.key(2), x)["params"])

    model = VisionTransformer(get_vit_config("dedeit", **TOY), dtype=torch.float32)
    teacher = vit_from_jax_params(t_params, get_vit_config("deit_base_distilled_patch16_224",
                                                           **TEACHER),
                                  device="cpu", dtype=torch.float32)
    return dict(jm=jm, jstacked=jstacked, jhead=jhead, ens_params=ens_params,
                jteacher=jteacher, t_params=t_params, model=model, teacher=teacher)


def _port_stacked(toy):
    return stacked_vit_from_jax_params(toy["jstacked"], toy["model"], device="cpu")


def _port_head(toy):
    return ensmlp_from_jax_params(toy["ens_params"], num_divisions=D, dtype=torch.float32,
                                  device="cpu")


def _images(seed, n=B):
    return np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32)


def test_multivit_features_and_fused_tokens_match_jax(toy):
    head, neuron = _gates(0)
    x = _images(1)
    jg = jvit.Gates(head=jnp.asarray(head), neuron=jnp.asarray(neuron))
    jcls, jdist = jens.multivit_features(toy["jm"], {"params": toy["jstacked"]},
                                         jnp.asarray(x), jg)
    stacked = _port_stacked(toy)
    with torch.no_grad():
        cls_t, dist_t = tens.multivit_features(
            toy["model"], stacked, torch.from_numpy(x),
            tens.stack_division_gates([Gates(torch.from_numpy(h), torch.from_numpy(n))
                                       for h, n in zip(head, neuron)]))
    assert cls_t.shape == dist_t.shape == (D, B, 64)
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(jcls), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(jdist), rtol=2e-5, atol=2e-5)

    # EnsMLP's training outputs: fused tokens exactly when distill and train
    jout = toy["jhead"].apply({"params": toy["ens_params"]}, jcls, jdist, distill=True,
                              train=True)
    ens = _port_head(toy)
    with torch.no_grad():
        out = ens(cls_t, dist_t, distill=True, train=True)
        assert ens(cls_t, dist_t, distill=True).ens_tokens is None
        assert ens(cls_t, dist_t, train=True).ens_tokens is None
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits), rtol=2e-5,
                               atol=2e-5)
    for got, want in zip(out.ens_tokens, jout.ens_tokens):
        assert got.shape == (B, 96)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    no_teacher = tens.EnsMLP(num_classes=K, sub_size=64, num_divisions=D, family="vit",
                             dtype=torch.float32)
    assert no_teacher(cls_t, distill=True, train=True).ens_tokens is None


def test_multivit_features_needs_a_generator_to_train(toy):
    with pytest.raises(ValueError, match="generator"):
        tens.multivit_features(toy["model"], _port_stacked(toy), torch.zeros((1, 32, 32, 3)),
                               train=True)


def test_remat_recomputes_each_division_with_its_own_parameters(toy):
    """Blocks under torch.utils.checkpoint, run through functional_call on a
    division's slice, recompute with that slice: the gradients equal those
    of the same forward without remat."""
    x = torch.from_numpy(_images(2))
    grads = []
    for remat in (False, True):
        model = VisionTransformer(get_vit_config("dedeit", **TOY, drop_path_rate=0.1),
                                  dtype=torch.float32, use_remat=remat)
        stacked = stacked_vit_from_jax_params(toy["jstacked"], model, device="cpu")
        cls_t, dist_t = tens.multivit_features(model, stacked, x, train=True,
                                               generator=torch.Generator().manual_seed(3))
        loss = (cls_t.square().sum() + dist_t.sin().sum())
        grads.append(torch.autograd.grad(loss, list(stacked.values())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["deit", "vit"])
@pytest.mark.parametrize("token_loss_type", ["mse", "kldiv"])
@pytest.mark.parametrize("distillation_type", ["hard", "soft"])
def test_ens_loss_matches_jax(family, token_loss_type, distillation_type):
    rng = np.random.default_rng(4)

    def tok():
        return rng.standard_normal((5, 12)).astype(np.float32)

    if token_loss_type == "kldiv":  # log-probabilities, as the kldiv criterion takes them
        tok = (lambda f: lambda: np.array(jax.nn.log_softmax(f(), -1)))(tok)
    s_tok = (tok(), tok()) if family == "deit" else tok()
    t_tok = (tok(), tok()) if family == "deit" else tok()
    s_logits, t_logits = (rng.standard_normal((5, K)).astype(np.float32) for _ in range(2))
    labels = rng.integers(0, K, 5)
    kw = dict(model_family=family, distillation_type=distillation_type, alpha=0.3, tau=2.0,
              token_loss_type=token_loss_type)
    want = jlosses.ens_loss(
        jax.tree_util.tree_map(jnp.asarray, s_tok), jnp.asarray(s_logits),
        jax.tree_util.tree_map(jnp.asarray, t_tok), jnp.asarray(t_logits), jnp.asarray(labels),
        jlosses.make_base_criterion(False, 0.1), **kw)
    as_t = lambda t: tuple(map(torch.from_numpy, t)) if isinstance(t, tuple) else torch.from_numpy(t)
    got = tlosses.ens_loss(as_t(s_tok), torch.from_numpy(s_logits), as_t(t_tok),
                           torch.from_numpy(t_logits), torch.from_numpy(labels),
                           tlosses.make_base_criterion(False, 0.1), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tlosses.ens_loss(*(as_t(s_tok), torch.from_numpy(s_logits), as_t(t_tok),
                           torch.from_numpy(t_logits), torch.from_numpy(labels), None),
                         token_loss_type="l1")


def test_stacked_and_head_bridges_round_trip_bit_exact(toy):
    stacked = _port_stacked(toy)
    assert all(v.shape[0] == D and v.requires_grad for v in stacked.values())
    assert not any(k.startswith(("head.", "head_dist.")) for k in stacked)
    assert list(stacked) == tens.features_param_names(toy["model"])
    want, got = _flat(toy["jstacked"]), _flat(stacked_vit_to_jax_params(stacked))
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].shape == got[k].shape and np.array_equal(want[k], got[k]), k
    want, got = _flat(toy["ens_params"]), _flat(ensmlp_to_jax_params(_port_head(toy)))
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(want[k], got[k]), k
    # a division's slice is that division's tree, as the JAX vmap sees it
    one = {k: v[2] for k, v in stacked.items()}
    assert np.array_equal(one["blocks.1.qkv.kernel"].detach().numpy(),
                          toy["jstacked"]["blocks"]["qkv"]["kernel"][2, 1])
    with pytest.raises(ValueError, match="no port parameter"):
        stacked_vit_from_jax_params({"bogus": np.zeros((D, 3))}, toy["model"], device="cpu")


def test_init_and_stacking_helpers(toy):
    model = toy["model"]
    gens = [torch.Generator().manual_seed(s) for s in (5, 6, 5)]
    stacked = tens.init_multivit(model, gens)
    assert list(stacked) == tens.features_param_names(model)
    k = stacked["blocks.0.qkv.kernel"]
    assert k.shape == (3, 64, 192) and k.requires_grad
    assert torch.equal(k[0], k[2]) and not torch.equal(k[0], k[1])  # one draw per generator
    assert torch.count_nonzero(model.blocks[0].qkv.kernel) == 0  # the model is untouched
    g = tens.stack_division_gates([Gates(torch.ones(2, 4), torch.ones(2, 256))] * 3)
    assert g.head.shape == (3, 2, 4) and g.neuron.shape == (3, 2, 256)
    ens = tens.EnsMLP(num_classes=K, sub_size=64, num_divisions=D, teacher_size=96,
                      dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(0))
    assert ens.cls_mlp.kernel.requires_grad and float(ens.cls_mlp.kernel.detach().std()) > 0.01
    assert torch.count_nonzero(ens.cls_mlp.bias) == 0


def _record(tx, sink):
    """tx that also hands the gradients it receives to sink, from inside jit."""
    return optax.GradientTransformation(
        tx.init, lambda g, s, p=None: (jax.debug.callback(sink.append, g), tx.update(g, s, p))[1])


def _port_record(state, sink):
    update = state.tx.update
    state.tx.update = lambda g, s, p: (sink.append({k: v.clone() for k, v in g.items()}),
                                       update(g, s, p))[1]


def _close_after_steps(want_tree, got_tree, g_step1):
    want, got = _flat(want_tree), _flat(got_tree)
    assert want.keys() == got.keys()
    for k in want:
        g = np.abs(g_step1[k])
        big = g > 1e-4 * g.max()
        np.testing.assert_allclose(got[k][big], want[k][big], rtol=0, atol=2e-6, err_msg=str(k))
        assert np.abs(got[k] - want[k]).max() <= 3 * LR * 1.001, k


@pytest.mark.parametrize("distillation,mixup,clip", [
    ("none", False, None), ("hard", True, None), ("hard", False, 0.05)])
def test_three_ensemble_steps_match_jax(toy, distillation, mixup, clip, monkeypatch):
    head, neuron = _gates(7)
    mix = None
    if mixup:
        mix = dict(num_classes=K)
        lam, cut, box = np.float32(0.64), np.bool_(True), (2, 20, 5, 29)
        monkeypatch.setattr(jmix, "_params", lambda r, c, shape=(): (jnp.asarray(lam),
                                                                     jnp.asarray(cut)))
        monkeypatch.setattr(jmix, "_sample_box", lambda r, h, w, l, c: tuple(
            jnp.int32(v) for v in box))
        monkeypatch.setattr(tmix, "_params", lambda g, c, shape=(): (torch.tensor(lam),
                                                                     torch.tensor(cut)))
        monkeypatch.setattr(tmix, "_sample_box", lambda g, h, w, l, c: tuple(
            torch.tensor(v, dtype=torch.int32) for v in box))
    kw = dict(smoothing=0.1, distillation_type=distillation, distillation_alpha=0.5,
              distillation_tau=1.0, token_loss_type="mse")
    opt = dict(OPT, clip_grad=clip)
    teacher = toy["jteacher"] if distillation != "none" else None

    jgrads = {"bb": [], "ens": []}
    jbb = JState.create(toy["jstacked"], _record(joptim.make_optimizer(
        joptim.OptimConfig(**opt), 2), jgrads["bb"]), use_ema=True, ema_decay=EMA)
    jen = JState.create(toy["ens_params"], _record(joptim.make_optimizer(
        joptim.OptimConfig(**opt), 2), jgrads["ens"]), use_ema=True, ema_decay=EMA)
    jstep = jax.jit(jsteps.make_ensemble_train_step(  # as the JAX CLI runs it
        toy["jm"], toy["jhead"], teacher, mixup=mix and jmix.MixupConfig(**mix), **kw))
    jg = jvit.Gates(head=jnp.asarray(head), neuron=jnp.asarray(neuron))

    ens = _port_head(toy)
    bb = TrainState.create(_port_stacked(toy), toptim.make_optimizer(
        toptim.OptimConfig(**opt), 2), use_ema=True, ema_decay=EMA)
    en = TrainState.create(ens, toptim.make_optimizer(toptim.OptimConfig(**opt), 2),
                           use_ema=True, ema_decay=EMA)
    tgrads = {"bb": [], "ens": []}
    _port_record(bb, tgrads["bb"])
    _port_record(en, tgrads["ens"])
    tstep = tsteps.make_ensemble_train_step(
        toy["model"], ens, toy["teacher"] if distillation != "none" else None,
        mixup=mix and tmix.MixupConfig(**mix), **kw)
    tg = Gates(torch.from_numpy(head), torch.from_numpy(neuron))

    rng = np.random.default_rng(8)
    for i in range(3):
        x = _images(100 + i)
        y = rng.integers(0, K, B)
        jbb, jen, jm_ = jstep(jbb, jen, {"params": toy["t_params"]}, jg, jnp.asarray(x),
                              jnp.asarray(y), jax.random.key(i))
        bb, en, tm_ = tstep(bb, en, None, tg, torch.from_numpy(x), torch.from_numpy(y),
                            torch.Generator().manual_seed(i))
        assert tm_.keys() == jm_.keys()
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5, err_msg=k)
    assert bb.step == en.step == int(jbb.step) == 3

    g_bb = _flat(jgrads["bb"][0])
    g_ens = _flat(jgrads["ens"][0])
    for want, got in ((g_bb, _flat(stacked_vit_to_jax_params(tgrads["bb"][0]))),
                      (g_ens, _flat(ensmlp_to_jax_params(tgrads["ens"][0])))):
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-5, err_msg=str(k))
    if clip is not None:
        # the clip is active, and one division's share of the global norm
        # differs from another's: four states clipped apart would scale each
        # division by its own norm, and could not match the single global clip
        norms = np.sqrt([sum(np.sum(g[d] ** 2) for g in g_bb.values()) for d in range(D)])
        assert np.sqrt(np.sum(norms ** 2)) > clip and np.all(norms > clip)
        assert norms.max() / norms.min() > 1.01
    _close_after_steps(jbb.params, stacked_vit_to_jax_params(bb.params), g_bb)
    _close_after_steps(jbb.ema_params, stacked_vit_to_jax_params(bb.ema_params), g_bb)
    _close_after_steps(jen.params, ensmlp_to_jax_params(en.params), g_ens)
    _close_after_steps(jen.ema_params, ensmlp_to_jax_params(en.ema_params), g_ens)


def test_ensemble_step_build_errors(toy):
    ens = _port_head(toy)
    with pytest.raises(ValueError, match="teacher"):
        tsteps.make_ensemble_train_step(toy["model"], ens, None, distillation_type="hard")
    plain = tens.EnsMLP(num_classes=K, sub_size=64, num_divisions=D, dtype=torch.float32)
    with pytest.raises(ValueError, match="teacher_size"):
        tsteps.make_ensemble_train_step(toy["model"], plain, toy["teacher"],
                                        distillation_type="hard")


def test_ensemble_eval_step_counters_match_jax(toy):
    head, neuron = _gates(9)
    x = _images(10, n=6)
    y = np.array([0, 3, 6, -1, 2, -1])  # two padding rows count nowhere
    want = jsteps.make_ensemble_eval_step(toy["jm"], toy["jhead"])(
        {"params": toy["jstacked"]}, {"params": toy["ens_params"]},
        jvit.Gates(head=jnp.asarray(head), neuron=jnp.asarray(neuron)), jnp.asarray(x),
        jnp.asarray(y))
    ens = _port_head(toy)
    got = tsteps.make_ensemble_eval_step(toy["model"], ens)(
        _port_stacked(toy), None, Gates(head, neuron), torch.from_numpy(x), torch.from_numpy(y))
    assert int(got["count"]) == int(want["count"]) == 4
    for k in ("top1", "top5"):
        assert int(got[k]) == int(want[k])
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
    # the same counters through an explicit parameter dict (the EMA path)
    again = tsteps.make_ensemble_eval_step(toy["model"], ens)(
        _port_stacked(toy), dict(ens.named_parameters()), Gates(head, neuron),
        torch.from_numpy(x), torch.from_numpy(y))
    assert float(again["loss_sum"]) == float(got["loss_sum"])
