"""Port stage-2 train step (devit_tpu_torch/train/steps.make_stage2_step) vs
the JAX package's, from the same numpy parameters and batches, at f32 and
toy width: three steps of AdamW (cosine schedule with warmup) and EMA, in
distillation modes none, soft and hard, with and without mixup. drop_path is
0, and the mixup draws are pinned to the same lam and box in both packages
(their random streams differ; tests/test_torch_train_parts.py holds the
sampling by its statistics).

Tolerances: losses 1e-5 relative; step-1 gradients rtol 2e-3, atol 2e-5.
After three Adam steps a parameter whose step-1 gradient is near zero can
move by +-lr on the sign of a rounding difference, so parameters and EMA are
compared where the step-1 gradient exceeds 1e-4 of its leaf's largest, to
atol 2e-6 (0.2% of one step at lr 1e-3); the rest must stay within the 3
steps' +-3 lr."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.data import mixup as jmix
from devit_tpu.models import vit as jvit
from devit_tpu.train import optim as joptim
from devit_tpu.train import steps as jsteps
from devit_tpu.train.state import TrainState as JState
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.data import mixup as tmix
from devit_tpu_torch.io.bridge import vit_from_jax_params, vit_to_jax_params
from devit_tpu_torch.train import optim as toptim
from devit_tpu_torch.train import steps as tsteps
from devit_tpu_torch.train.state import TrainState

TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=7)
B, LR, EMA = 4, 1e-3, 0.9
OPT = dict(lr=LR, min_lr=1e-5, warmup_lr=1e-4, warmup_epochs=1, epochs=3)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _init(name, seed):
    jm = jvit.VisionTransformer(jax_cfg(name, **TOY), dtype=jnp.float32)
    x = jnp.zeros((1, 32, 32, 3))
    return jm, jax.device_get(jm.init(jax.random.key(seed), x)["params"])


@pytest.mark.parametrize("mixup", [False, True])
@pytest.mark.parametrize("distillation", ["none", "soft", "hard"])
def test_three_stage2_steps_match_jax(distillation, mixup, monkeypatch):
    jm, params = _init("dedeit", 0)
    teacher = tparams = None
    if distillation != "none":
        teacher, tparams = _init("devit", 1)
    mix = None
    if mixup:
        mix = dict(num_classes=7)
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
              distillation_tau=2.0)

    # JAX: record the gradients the optimizer receives
    jgrads = []
    tx = joptim.make_optimizer(joptim.OptimConfig(**OPT), 2)
    rec_tx = optax.GradientTransformation(
        tx.init, lambda g, s, p=None: (jgrads.append(jax.device_get(g)), tx.update(g, s, p))[1])
    jstate = JState.create(params, rec_tx, use_ema=True, ema_decay=EMA)
    jstep = jsteps.make_stage2_step(jm, teacher, mixup=mix and jmix.MixupConfig(**mix), **kw)

    model = vit_from_jax_params(params, get_vit_config("dedeit", **TOY), device="cpu",
                                dtype=torch.float32)
    tteacher = (None if teacher is None else vit_from_jax_params(
        tparams, get_vit_config("devit", **TOY), device="cpu", dtype=torch.float32))
    state = TrainState.create(model, toptim.make_optimizer(toptim.OptimConfig(**OPT), 2),
                              use_ema=True, ema_decay=EMA)
    tgrads = []
    update = state.tx.update
    state.tx.update = lambda g, s, p: (tgrads.append({k: v.clone() for k, v in g.items()}),
                                       update(g, s, p))[1]
    tstep = tsteps.make_stage2_step(model, tteacher, mixup=mix and tmix.MixupConfig(**mix), **kw)

    rng = np.random.default_rng(2)
    for i in range(3):
        x = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 7, B)
        jstate, jm_ = jstep(jstate, tparams and {"params": tparams}, jnp.asarray(x),
                            jnp.asarray(y), jax.random.key(i))
        state, tm_ = tstep(state, None, torch.from_numpy(x), torch.from_numpy(y),
                           torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-5)
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
