"""Port stage-4 DEKD (devit_tpu_torch/train/losses.py: the relation losses,
dekd_loss and the alternates; train/steps.make_dekd_step) vs the JAX
package's, from the same numpy parameters and batches, at f32 and toy width
(a gated 2-layer dedeit student, a 2-layer distilled teacher twice as wide
in heads).

Tolerances: each loss rtol 1e-5 (atol 1e-6 where it sums to near zero);
step losses 1e-5 relative, step-1 gradients rtol 2e-3 / atol 2e-5, and
parameters and EMA after three Adam steps as in tests/test_torch_stage2.py
(atol 2e-6 where the step-1 gradient exceeds 1e-4 of its leaf's largest,
everywhere within 3 lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.core.rank import build_gates
from devit_tpu.models import vit as jvit
from devit_tpu.train import losses as jl
from devit_tpu.train import optim as joptim
from devit_tpu.train import steps as jsteps
from devit_tpu.train.state import TrainState as JState
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.io.bridge import vit_from_jax_params, vit_to_jax_params
from devit_tpu_torch.models.vit import Gates
from devit_tpu_torch.train import losses as tl
from devit_tpu_torch.train import optim as toptim
from devit_tpu_torch.train import steps as tsteps
from devit_tpu_torch.train.state import TrainState

STUDENT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=7)
TEACHER = dict(STUDENT, embed_dim=128, num_heads=8)
B, K, LR, EMA = 4, 7, 1e-3, 0.9
OPT = dict(lr=LR, min_lr=1e-5, warmup_lr=1e-4, warmup_epochs=1, epochs=3)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _rng(seed):
    return np.random.default_rng(seed)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=atol)


def test_kldiv_and_feature_relation_losses_match_jax():
    r = _rng(0)
    s_log, t_log = (np.asarray(jax.nn.log_softmax(r.standard_normal((3, 5, 9)), -1),
                               np.float32) for _ in range(2))
    (js, jt), (ts, tt) = _both(s_log, t_log)
    _close(tl.kldiv_batchmean_log_target(ts, tt), jl.kldiv_batchmean_log_target(js, jt))
    # a student with 4 heads of 16 against a teacher with 8 heads of 16
    tea = r.standard_normal((2, 8, 11, 16)).astype(np.float32)
    stu = r.standard_normal((2, 4, 11, 16)).astype(np.float32)
    (jt, js), (tt, ts) = _both(tea, stu)
    _close(tl.feature_relation_loss(tt, ts), jl.feature_relation_loss(jt, js))


def test_dekd_losses_match_jax():
    r = _rng(1)
    s_qkv = r.standard_normal((3, 2, 4, 11, 16)).astype(np.float32)
    t_qkv = r.standard_normal((3, 2, 8, 11, 16)).astype(np.float32)
    cls_l, kd_l, t_l = (r.standard_normal((2, K)).astype(np.float32) for _ in range(3))
    labels = r.integers(0, K, 2)
    (js, jt, jc, jk, jtl, jy), (ts, tt, tc, tk, ttl, ty) = _both(s_qkv, t_qkv, cls_l, kd_l,
                                                                 t_l, labels)
    for w, g in zip(jl.dekd_qkv_losses(js, jt, 12), tl.dekd_qkv_losses(ts, tt, 12)):
        _close(g, w)
    for dtype in ("hard", "soft"):
        kw = dict(depth=12, gamma=(0.2, 0.1, 0.3), distillation_type=dtype, alpha=0.4, tau=2.0)
        wt, wa = jl.dekd_loss((jc, jk), js, jtl, jt, jy, jl.make_base_criterion(False, 0.1),
                              **kw)
        gt, ga = tl.dekd_loss((tc, tk), ts, ttl, tt, ty, tl.make_base_criterion(False, 0.1),
                              **kw)
        _close(gt, wt)
        assert ga.keys() == wa.keys()
        for k in wa:
            _close(ga[k], wa[k])


def test_alternate_relation_losses_and_accuracy_match_jax():
    r = _rng(2)
    layers = 2

    def qkv(H, d):
        return [tuple(r.standard_normal((2, H, 9, d)).astype(np.float32) for _ in range(3))
                for _ in range(layers)]

    s, t = qkv(4, 16), qkv(2, 32)
    js = [tuple(map(jnp.asarray, x)) for x in s]
    jt = [tuple(map(jnp.asarray, x)) for x in t]
    ts = [tuple(torch.from_numpy(a) for a in x) for x in s]
    tt = [tuple(torch.from_numpy(a) for a in x) for x in t]
    _close(tl.qkv_gram_loss(ts, tt), jl.qkv_gram_loss(js, jt))
    _close(tl.qkv_cross_gram_loss(ts, tt), jl.qkv_cross_gram_loss(js, jt))
    hs = [r.standard_normal((2, 9, 24)).astype(np.float32) for _ in range(layers)]
    ht = [r.standard_normal((2, 9, 40)).astype(np.float32) for _ in range(layers)]
    hs[0][0, 3] = 0.0  # a zero row: the 1e-12 norm clamp
    _close(tl.hidden_relation_loss([torch.from_numpy(h) for h in hs],
                                   [torch.from_numpy(h) for h in ht]),
           jl.hidden_relation_loss([jnp.asarray(h) for h in hs], [jnp.asarray(h) for h in ht]))
    logits = r.standard_normal((16, 10)).astype(np.float32)
    labels = r.integers(0, 10, 16)
    for topk in ((1, 5), (1, 2, 3)):
        got = tl.accuracy_topk(torch.from_numpy(logits), torch.from_numpy(labels), topk)
        want = jl.accuracy_topk(jnp.asarray(logits), jnp.asarray(labels), topk)
        for g, w in zip(got, want):
            _close(g, w)


def _init(name, overrides, seed):
    jm = jvit.VisionTransformer(jax_cfg(name, **overrides), dtype=jnp.float32)
    x = jnp.zeros((1, 32, 32, 3))
    return jm, jax.device_get(jm.init(jax.random.key(seed), x, capture_qkv="middle")["params"])


def _gates(seed):
    r = _rng(seed)
    cfg = jax_cfg("dedeit", **STUDENT)
    L = cfg.depth
    g = build_gates(np.stack([r.permutation(cfg.hidden_dim) for _ in range(L)]),
                    np.stack([r.permutation(cfg.num_heads) for _ in range(L)]),
                    r.uniform(0, 0.6, L), r.choice([0.0, 0.25, 0.5], L))
    return np.array(g.head, np.float32), np.array(g.neuron, np.float32)


@pytest.mark.parametrize("inter", [True, False])
@pytest.mark.parametrize("distillation", ["hard", "soft"])
def test_three_dekd_steps_match_jax(inter, distillation):
    jstudent, s_params = _init("dedeit", STUDENT, 0)
    jteacher, t_params = _init("deit_base_distilled_patch16_224", TEACHER, 1)
    head, neuron = _gates(3)
    kw = dict(gamma=(0.2, 0.1, 0.3), smoothing=0.1, distillation_type=distillation,
              distillation_alpha=0.5, distillation_tau=2.0, distillation_inter=inter)

    jgrads = []  # the gradients the optimizer receives, recorded from inside jit
    tx = joptim.make_optimizer(joptim.OptimConfig(**OPT), 2)
    rec = optax.GradientTransformation(
        tx.init, lambda g, s, p=None: (jax.debug.callback(jgrads.append, g), tx.update(g, s, p))[1])
    jstate = JState.create(s_params, rec, use_ema=True, ema_decay=EMA)
    jstep = jax.jit(jsteps.make_dekd_step(jstudent, jteacher, **kw))  # as the JAX CLI runs it

    student = vit_from_jax_params(s_params, get_vit_config("dedeit", **STUDENT), device="cpu",
                                  dtype=torch.float32)
    teacher = vit_from_jax_params(t_params, get_vit_config("deit_base_distilled_patch16_224",
                                                           **TEACHER),
                                  device="cpu", dtype=torch.float32)
    state = TrainState.create(student, toptim.make_optimizer(toptim.OptimConfig(**OPT), 2),
                              use_ema=True, ema_decay=EMA)
    tgrads = []
    update = state.tx.update
    state.tx.update = lambda g, s, p: (tgrads.append({k: v.clone() for k, v in g.items()}),
                                       update(g, s, p))[1]
    tstep = tsteps.make_dekd_step(student, teacher, **kw)

    r = _rng(4)
    for i in range(3):
        x = r.standard_normal((B, 32, 32, 3)).astype(np.float32)
        y = r.integers(0, K, B)
        jstate, jm_ = jstep(jstate, {"params": t_params},
                            jvit.Gates(head=jnp.asarray(head), neuron=jnp.asarray(neuron)),
                            jnp.asarray(x), jnp.asarray(y), jax.random.key(i))
        state, tm_ = tstep(state, None, Gates(head, neuron), torch.from_numpy(x),
                           torch.from_numpy(y), torch.Generator().manual_seed(i))
        assert tm_.keys() == jm_.keys() == ({"loss", "cls_loss", "q_loss", "k_loss", "v_loss"}
                                            if inter else {"loss", "cls_loss"})
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == 3

    g_want = _flat(jgrads[0])
    g_got = _flat(vit_to_jax_params(tgrads[0]))
    assert g_got.keys() == g_want.keys()
    for k in g_want:
        np.testing.assert_allclose(g_got[k], g_want[k], rtol=2e-3, atol=2e-5, err_msg=str(k))
    for want_tree, got_vals in ((jstate.params, state.params),
                                (jstate.ema_params, state.ema_params)):
        want, got = _flat(jax.device_get(want_tree)), _flat(vit_to_jax_params(got_vals))
        for k in want:
            g = np.abs(g_want[k])
            big = g > 1e-4 * g.max()
            np.testing.assert_allclose(got[k][big], want[k][big], rtol=0, atol=2e-6,
                                       err_msg=str(k))
            assert np.abs(got[k] - want[k]).max() <= 3 * LR * 1.001, k
