"""The port's training steps on the CCT family against the JAX package's,
from the same numpy parameters and batches, at f32 and the JAX CCT tests'
toy geometry (cct_2_3x2_32 at 64 wide, 2 layers, 4 heads: 64 tokens): the
stage-2 step (a CCT student, and a CCT teacher's soft distillation), the
DEKD step (CCT student and teacher, the middle layer's q/k/v relations), the
CCT ensemble train and eval steps (MultiCCT + EnsembleCCT), and the stage-5
checkpoint of a CCT ensemble written by either package and resumed by the
other. Every draw is off (no mixup, dropout or drop-path); the JAX steps run
jitted, as the JAX CLI runs them.

Tolerances: losses 1e-5 relative each step (the DEKD relation losses,
~0.02 sums of squared gram differences over 64 tokens, 1e-4: f32 summation
order); step-1 gradients rtol 2e-3, atol 2e-5 (as
tests/test_torch_stage2.py), the tokenizer's conv kernels 5e-3 in the norm
of the difference (max-pool's argmax near ties, see _assert_grads); after
the steps, parameters within steps * lr; checkpoint leaves bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.serialization import to_state_dict

from devit_tpu.cli.stages import _ensemble_ckpt_tree
from devit_tpu.io.checkpoint import restore_pytree as jrestore
from devit_tpu.io.checkpoint import save_pytree as jsave
from devit_tpu.models import cct as jcct
from devit_tpu.models import ensemble as jens
from devit_tpu.models import vit as jvit
from devit_tpu.train import optim as joptim
from devit_tpu.train import steps as jsteps
from devit_tpu.train.state import TrainState as JState
from devit_tpu_torch import configs as tcfg
from devit_tpu_torch.io.bridge import (
    cct_from_jax_params, ensmlp_to_jax_params, stacked_vit_from_jax_params,
    stacked_vit_to_jax_params, vit_to_jax_params,
)
from devit_tpu_torch.io.checkpoint import restore_pytree, save_pytree
from devit_tpu_torch.models import cct as tcct
from devit_tpu_torch.models.ensemble import EnsembleCCT
from devit_tpu_torch.models.vit import Gates
from devit_tpu_torch.train import optim as toptim
from devit_tpu_torch.train import steps as tsteps
from devit_tpu_torch.train.state import TrainState, restore_stage5_tree, stage5_tree

NAME = "cct_2_3x2_32"
NO_DRAWS = dict(stochastic_depth=0.0, attention_dropout=0.0, dropout=0.0)
STUDENT = dict(img_size=32, embed_dim=64, num_heads=4, num_layers=2, num_classes=7,
               mlp_ratio=2.0, **NO_DRAWS)
TEACHER = dict(STUDENT, embed_dim=96)
B, K, D, LR, STEPS = 4, 7, 2, 1e-3, 2
OPT = dict(lr=LR, min_lr=1e-5, warmup_lr=1e-4, warmup_epochs=1, epochs=3)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _init(geom, seed, name=NAME):
    m = jcct.create_cct(name, dtype=jnp.float32, **geom)
    params = m.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"]
    return m, jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _port(params, geom, name=NAME):
    base = name.replace("decct", "cct", 1)
    cfg = tcfg.get_cct_config(base, **geom, **({"backbone": True} if base != name else {}))
    return cct_from_jax_params(params, cfg, device="cpu", dtype=torch.float32)


def _recording(tx, out):
    return optax.GradientTransformation(
        tx.init, lambda g, s, p=None: (jax.debug.callback(out.append, g), tx.update(g, s, p))[1])


def _port_recording(state, out):
    update = state.tx.update
    state.tx.update = lambda g, s, p: (out.append({k: v.clone() for k, v in g.items()}),
                                       update(g, s, p))[1]


def _batches():
    rng = np.random.default_rng(11)
    return [(rng.standard_normal((B, 32, 32, 3)).astype(np.float32), rng.integers(0, K, B))
            for _ in range(STEPS)]


def _gates(seed, L=2, H=4, hidden=128, lead=()):
    rng = np.random.default_rng(seed)
    head = (rng.random(lead + (L, H)) > 0.3).astype(np.float32)
    head[..., 0] = 1.0  # every layer keeps a head
    return head, (rng.random(lead + (L, hidden)) > 0.3).astype(np.float32)


def _assert_grads(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k[0] == "tokenizer":
            # max-pool sends a window's gradient to its argmax: where two f32
            # values of a window lie within the packages' summation-order
            # rounding, the argmax (and so the gradient's position) can
            # differ, so the conv kernels are held by the norm of the
            # difference
            rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
            assert rel <= 5e-3, (k, rel)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-5, err_msg=str(k))


def _assert_after_steps(got, want):
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= STEPS * LR * 1.001, k


@pytest.mark.parametrize("distillation", ["soft"])
def test_cct_stage2_steps_match_jax(distillation):
    jm, params = _init(STUDENT, 0)
    jt = t_params = tteacher = None
    if distillation != "none":
        jt, t_params = _init(TEACHER, 1)
        tteacher = _port(t_params, TEACHER)
    kw = dict(smoothing=0.1, distillation_type=distillation, distillation_alpha=0.5,
              distillation_tau=2.0)
    jgrads, tgrads = [], []
    tx = joptim.make_optimizer(joptim.OptimConfig(**OPT), 2)
    jstate = JState.create(params, _recording(tx, jgrads), use_ema=True, ema_decay=0.9)
    jstep = jax.jit(jsteps.make_stage2_step(jm, jt, **kw))
    model = _port(params, STUDENT)
    state = TrainState.create(model, toptim.make_optimizer(toptim.OptimConfig(**OPT), 2),
                              use_ema=True, ema_decay=0.9)
    _port_recording(state, tgrads)
    tstep = tsteps.make_stage2_step(model, tteacher, **kw)
    for i, (x, y) in enumerate(_batches()):
        jstate, jm_ = jstep(jstate, t_params and {"params": t_params}, jnp.asarray(x),
                            jnp.asarray(y), jax.random.key(i))
        state, tm_ = tstep(state, None, torch.from_numpy(x), torch.from_numpy(y),
                           torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-5)
    _assert_grads(_flat(vit_to_jax_params(tgrads[0])), _flat(jgrads[0]))
    _assert_after_steps(_flat(vit_to_jax_params(state.params)),
                        _flat(jax.device_get(jstate.params)))


def test_cct_dekd_steps_match_jax():
    jm, params = _init(STUDENT, 2)
    jt, t_params = _init(TEACHER, 3)
    head, neuron = _gates(4)
    kw = dict(gamma=(0.2, 0.1, 0.3), smoothing=0.1, distillation_type="hard",
              distillation_alpha=0.5, distillation_tau=1.0, distillation_inter=True)
    jgrads, tgrads = [], []
    tx = joptim.make_optimizer(joptim.OptimConfig(**OPT), 2)
    jstate = JState.create(params, _recording(tx, jgrads))
    jstep = jax.jit(jsteps.make_dekd_step(jm, jt, **kw))
    student, teacher = _port(params, STUDENT), _port(t_params, TEACHER)
    state = TrainState.create(student, toptim.make_optimizer(toptim.OptimConfig(**OPT), 2))
    _port_recording(state, tgrads)
    tstep = tsteps.make_dekd_step(student, teacher, **kw)
    for i, (x, y) in enumerate(_batches()):
        jstate, jm_ = jstep(jstate, {"params": t_params}, jvit.Gates(jnp.asarray(head),
                                                                     jnp.asarray(neuron)),
                            jnp.asarray(x), jnp.asarray(y), jax.random.key(i))
        state, tm_ = tstep(state, None, Gates(head, neuron), torch.from_numpy(x),
                           torch.from_numpy(y), torch.Generator().manual_seed(i))
        assert tm_.keys() == jm_.keys() == {"loss", "cls_loss", "q_loss", "k_loss", "v_loss"}
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=1e-4 if k[0] in "qkv" else 1e-5, err_msg=k)
    _assert_grads(_flat(vit_to_jax_params(tgrads[0])), _flat(jgrads[0]))


@pytest.fixture(scope="module")
def ens():
    """D stacked decct divisions, an EnsembleCCT head (teacher size 96) and a
    CCT teacher, in both packages from the same numpy parameters."""
    geom = {k: v for k, v in STUDENT.items() if k != "num_classes"}
    jm = jcct.create_cct("decct_2_3x2", dtype=jnp.float32, **geom)
    x = jnp.zeros((2, 32, 32, 3))
    jstacked = jax.device_get(jax.vmap(lambda k: jm.init(k, x))(
        jax.random.split(jax.random.key(5), D))["params"])
    jhead = jens.EnsembleCCT(num_classes=K, sub_size=64, num_divisions=D, teacher_size=96,
                             dtype=jnp.float32)
    feats = jnp.zeros((D, 2, 64))
    head_params = jax.device_get(jhead.init(jax.random.key(6), feats, distill=True,
                                            train=True)["params"])
    jt, t_params = _init(TEACHER, 7)
    model = tcct.create_cct("decct_2_3x2", dtype=torch.float32, device="cpu", **geom)
    return dict(jm=jm, jstacked=jstacked, jhead=jhead, head_params=head_params, jt=jt,
                t_params=t_params, model=model, teacher=_port(t_params, TEACHER))


def _port_head(e):
    return EnsembleCCT(num_classes=K, sub_size=64, num_divisions=D, teacher_size=96,
                       dtype=torch.float32).load_params(e["head_params"])


@pytest.mark.parametrize("distillation", ["hard"])
def test_cct_ensemble_steps_match_jax(ens, distillation):
    head, neuron = _gates(8, lead=(D,))
    kw = dict(smoothing=0.1, distillation_type=distillation, distillation_alpha=0.5,
              distillation_tau=1.0)
    teacher = ens["jt"] if distillation != "none" else None
    jg = {"bb": [], "ens": []}
    mk = lambda rec: _recording(joptim.make_optimizer(joptim.OptimConfig(**OPT), 2), rec)
    jbb = JState.create(ens["jstacked"], mk(jg["bb"]), use_ema=True, ema_decay=0.9)
    jen = JState.create(ens["head_params"], mk(jg["ens"]), use_ema=True, ema_decay=0.9)
    jstep = jax.jit(jsteps.make_cct_ensemble_train_step(ens["jm"], ens["jhead"], teacher, **kw))
    head_t = _port_head(ens)
    bb = TrainState.create(stacked_vit_from_jax_params(ens["jstacked"], ens["model"],
                                                       device="cpu"),
                           toptim.make_optimizer(toptim.OptimConfig(**OPT), 2),
                           use_ema=True, ema_decay=0.9)
    en = TrainState.create(head_t, toptim.make_optimizer(toptim.OptimConfig(**OPT), 2),
                           use_ema=True, ema_decay=0.9)
    tg = {"bb": [], "ens": []}
    _port_recording(bb, tg["bb"])
    _port_recording(en, tg["ens"])
    tstep = tsteps.make_cct_ensemble_train_step(
        ens["model"], head_t, ens["teacher"] if distillation != "none" else None, **kw)
    for i, (x, y) in enumerate(_batches()):
        jbb, jen, jm_ = jstep(jbb, jen, {"params": ens["t_params"]},
                              jvit.Gates(jnp.asarray(head), jnp.asarray(neuron)),
                              jnp.asarray(x), jnp.asarray(y), jax.random.key(i))
        bb, en, tm_ = tstep(bb, en, None, Gates(head, neuron), torch.from_numpy(x),
                            torch.from_numpy(y), torch.Generator().manual_seed(i))
        assert tm_.keys() == jm_.keys()
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), rtol=1e-5, err_msg=k)
    _assert_grads(_flat(stacked_vit_to_jax_params(tg["bb"][0])), _flat(jg["bb"][0]))
    _assert_grads(_flat(ensmlp_to_jax_params(tg["ens"][0])), _flat(jg["ens"][0]))
    _assert_after_steps(_flat(stacked_vit_to_jax_params(bb.params)),
                        _flat(jax.device_get(jbb.params)))

    x, y = _batches()[0]
    y = y.copy()
    y[1] = -1  # a padding row counts nowhere
    want = jsteps.make_cct_ensemble_eval_step(ens["jm"], ens["jhead"])(
        {"params": jbb.params}, {"params": jen.params},
        jvit.Gates(jnp.asarray(head), jnp.asarray(neuron)), jnp.asarray(x), jnp.asarray(y))
    got = tsteps.make_cct_ensemble_eval_step(ens["model"], head_t)(
        bb.params, None, Gates(head, neuron), torch.from_numpy(x), torch.from_numpy(y))
    assert int(got["count"]) == int(want["count"]) == B - 1
    assert (int(got["top1"]), int(got["top5"])) == (int(want["top1"]), int(want["top5"]))
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-4)


def test_cct_ensemble_step_wants_a_cct_teacher(ens):
    from devit_tpu_torch.models.vit import create_vit

    vit = create_vit("dedeit", img_size=32, patch_size=8, embed_dim=32, depth=1, num_heads=2,
                     device="cpu")
    for teacher, match in ((None, "requires a teacher"), (vit, "requires a CCT teacher")):
        with pytest.raises(ValueError, match=match):
            tsteps.make_cct_ensemble_train_step(ens["model"], _port_head(ens), teacher,
                                                distillation_type="hard")
    plain = EnsembleCCT(num_classes=K, sub_size=64, num_divisions=D, dtype=torch.float32)
    with pytest.raises(ValueError, match="teacher_size"):
        tsteps.make_cct_ensemble_train_step(ens["model"], plain, ens["teacher"],
                                            distillation_type="hard")


def test_cct_stage5_checkpoint_resumes_in_either_package(ens, tmp_path):
    """A JAX CCT-ensemble checkpoint (adamw states, EMA, gates) restores into
    the port's states leaf for leaf, and the port's, written back, restores
    into the JAX CLI's own template (the exact tree structure)."""
    head, neuron = _gates(9, lead=(D,))
    jtx = joptim.make_optimizer(joptim.OptimConfig(**OPT), 2)
    jbb = JState.create(ens["jstacked"], jtx, use_ema=True, ema_decay=0.9)
    jen = JState.create(ens["head_params"], jtx, use_ema=True, ema_decay=0.9)
    # one update so the moments and counts are not the init's
    g_bb = jax.tree_util.tree_map(lambda a: jnp.full_like(a, 0.01), jbb.params)
    g_en = jax.tree_util.tree_map(lambda a: jnp.full_like(a, -0.02), jen.params)
    jbb, jen = jbb.apply_gradients(g_bb), jen.apply_gradients(g_en)
    jgates = jvit.Gates(jnp.asarray(head), jnp.asarray(neuron))
    path = str(tmp_path / "jax.msgpack")
    jsave(path, _ensemble_ckpt_tree(jbb, jen, 3, jgates))

    bb = TrainState.create(stacked_vit_from_jax_params(ens["jstacked"], ens["model"],
                                                       device="cpu"),
                           toptim.make_optimizer(toptim.OptimConfig(**OPT), 2),
                           use_ema=True, ema_decay=0.9)
    en = TrainState.create(_port_head(ens), toptim.make_optimizer(toptim.OptimConfig(**OPT), 2),
                           use_ema=True, ema_decay=0.9)
    bb, en, start = restore_stage5_tree(bb, en, restore_pytree(path))
    assert start == 4 and bb.opt_state["count"] == 1
    for got, want in ((stacked_vit_to_jax_params(bb.params), jbb.params),
                      (stacked_vit_to_jax_params(bb.ema_params), jbb.ema_params),
                      (stacked_vit_to_jax_params(bb.opt_state["mu"]), jbb.opt_state[0][0].mu),
                      (ensmlp_to_jax_params(en.params), jen.params),
                      (ensmlp_to_jax_params(en.opt_state["nu"]), jen.opt_state[0][0].nu)):
        g, w = _flat(got), _flat(jax.device_get(want))
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=str(k))

    back = str(tmp_path / "port.msgpack")
    save_pytree(back, stage5_tree(bb, en, 3, Gates(torch.from_numpy(head),
                                                   torch.from_numpy(neuron))))
    tpl = _ensemble_ckpt_tree(jbb, jen, 0, jgates)
    restored = jrestore(back, tpl)
    want, got = (_flat(to_state_dict(jax.device_get(t))) for t in (tpl, restored))
    for k in want:
        if k[0] != "epoch":
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert int(restored["epoch"]) == 3
