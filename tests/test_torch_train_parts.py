"""Port training parts vs the JAX package on the same numpy inputs:
schedules (devit_tpu_torch/train/optim.py), the optimizer chain and EMA,
losses (train/losses.py), mixup/cutmix (data/mixup.py: deterministic parts
exact, sampling by its statistics), eval counters, the tail-batch padder and
the epoch loop's NaN guard."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from devit_tpu.data import mixup as jmix
from devit_tpu.train import losses as jloss
from devit_tpu.train import optim as joptim
from devit_tpu.train import steps as jsteps
from devit_tpu_torch.data import mixup as tmix
from devit_tpu_torch.data.datasets import pad_batch_to_steady
from devit_tpu_torch.train import losses as tloss
from devit_tpu_torch.train import optim as toptim
from devit_tpu_torch.train import steps as tsteps
from devit_tpu_torch.train.loop import NonFiniteLossError, fit, train_epoch
from devit_tpu_torch.train.meters import MetricLogger, SmoothedValue

SPE, EPOCHS = 4, 3


def _cfgs():
    base = dict(lr=5e-4, min_lr=1e-5, warmup_lr=1e-6, warmup_epochs=1, epochs=EPOCHS)
    return {
        "cosine": dict(base),
        "cosine_per_epoch": dict(base, sched_per_epoch=True),
        "step": dict(base, sched="step", decay_epochs=1, decay_rate=0.5),
        "step_per_epoch": dict(base, sched="step", decay_epochs=1, sched_per_epoch=True),
        "constant": dict(base, sched="constant"),
        "noise_per_epoch": dict(base, sched_per_epoch=True, lr_noise=(0.3, 0.9)),
        "scaled": dict(base, scale_lr_by_batch=True, global_batch=1024),
        "no_warmup": dict(base, warmup_epochs=0),
    }


@pytest.mark.parametrize("mode", sorted(_cfgs()))
def test_schedule_matches_jax_per_step(mode):
    kw = _cfgs()[mode]
    want_fn = joptim.build_schedule(joptim.OptimConfig(**kw), SPE)
    got_fn = toptim.build_schedule(toptim.OptimConfig(**kw), SPE)
    steps = range(SPE * EPOCHS + 3)
    want = np.array([float(want_fn(s)) for s in steps])
    got = np.array([got_fn(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,args", [
    ("warmup_constant_schedule", (1e-3, 5)),
    ("warmup_linear_schedule", (1e-3, 5, 12)),
    ("warmup_cosine_schedule", (1e-3, 5, 12)),
])
def test_warmup_schedules_match_jax(name, args):
    want = np.array([float(getattr(joptim, name)(*args)(s)) for s in range(15)])
    got = np.array([getattr(toptim, name)(*args)(s) for s in range(15)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_schedule_rejects_what_jax_rejects():
    for cfg in (dict(sched="plateau"), dict(lr_noise=(0.5,))):
        with pytest.raises(ValueError):
            toptim.build_schedule(toptim.OptimConfig(**cfg), SPE)
    with pytest.raises(ValueError, match="not implemented"):
        toptim.make_optimizer(toptim.OptimConfig(opt="lamb"), SPE)


def _tree():
    """A small param tree with the names the decay mask reads: stacked
    blocks, tokens, a head."""
    rng = np.random.default_rng(0)
    shapes = {"blocks": {"fc1": {"kernel": (2, 5, 6), "bias": (2, 6)},
                         "norm1": {"scale": (2, 5), "bias": (2, 5)}},
              "pos_embed": (1, 3, 5), "head": {"kernel": (5, 4), "bias": (4,)}}

    def draw(s):
        return s if isinstance(s, dict) else (0.1 * rng.standard_normal(s)).astype(np.float32)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else draw(v) for k, v in t.items()}

    return walk(shapes)


def _named(tree):
    """flax tree -> port names (blocks split per layer)."""
    out = {}
    for k, v in tree.items():
        if k == "blocks":
            for mod, leaves in v.items():
                for leaf, a in leaves.items():
                    for i in range(a.shape[0]):
                        out[f"blocks.{i}.{mod}.{leaf}"] = torch.tensor(a[i])
        elif isinstance(v, dict):
            out.update({f"{k}.{leaf}": torch.tensor(a) for leaf, a in v.items()})
        else:
            out[k] = torch.tensor(v)
    return out


@pytest.mark.parametrize("opt,clip", [("adamw", None), ("adamw", 0.05), ("adam", None),
                                      ("sgd", None), ("momentum", 1.0)])
def test_optimizer_and_ema_match_optax_over_three_steps(opt, clip):
    cfg = dict(opt=opt, clip_grad=clip, sched="constant", lr=1e-2, weight_decay=0.05)
    params = _tree()
    tx = joptim.make_optimizer(joptim.OptimConfig(**cfg), SPE)
    jstate, jp, jema = tx.init(params), params, params
    tp = _named(params)
    ttx = toptim.make_optimizer(toptim.OptimConfig(**cfg), SPE)
    tstate = ttx.init(tp)
    tema = {k: v.clone() for k, v in tp.items()}
    rng = np.random.default_rng(1)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        upd, jstate = tx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        jema = joptim.ema_update(jema, jp, 0.99)
        ttx.update(_named(grads), tstate, tp)
        toptim.ema_update(tema, tp, 0.99)
    for name, want in _named(jax.device_get(jp)).items():
        np.testing.assert_allclose(tp[name].numpy(), want.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name, want in _named(jax.device_get(jema)).items():
        np.testing.assert_allclose(tema[name].numpy(), want.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def _logits(shape, seed):
    return (3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def test_losses_match_jax():
    s, t = _logits((6, 9), 0), _logits((6, 9), 1)
    labels = np.array([0, 3, 8, 1, 1, 5])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(_logits((6, 9), 2))))
    T = lambda a: torch.tensor(np.asarray(a))
    cases = [
        ("cross_entropy", (s, labels)),
        ("label_smoothing_cross_entropy", (s, labels, 0.1)),
        ("soft_target_cross_entropy", (s, probs)),
        ("soft_cross_entropy", (s, t)),
        ("soft_distill_loss", (s, t, 2.0)),
        ("hard_distill_loss", (s, t)),
        ("mse_loss", (s, t)),
    ]
    for name, args in cases:
        want = float(getattr(jloss, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                            for a in args]))
        got = getattr(tloss, name)(*[T(a) if isinstance(a, np.ndarray) else a for a in args])
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, err_msg=name)
    for kind in ("soft", "hard", "none"):
        for mix in (True, False):
            tgt = probs if mix else labels
            want = jloss.distill_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(s[::-1]),
                                      jnp.asarray(tgt), jloss.make_base_criterion(mix, 0.1),
                                      kind, 0.3, 2.0)
            got = tloss.distill_loss(T(s), T(t), T(s[::-1].copy()), T(tgt),
                                     tloss.make_base_criterion(mix, 0.1), kind, 0.3, 2.0)
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        tloss.cls_distill_loss(T(s), T(t), "feature", 1.0)


def _images(B, seed, H=8):
    return np.random.default_rng(seed).standard_normal((B, H, H, 3)).astype(np.float32)


@pytest.mark.parametrize("per_elem", [False, True])
def test_mix_with_flipped_and_soft_targets_are_exact(per_elem):
    B, H = 6, 8
    x = _images(B, 0, H)
    if per_elem:
        lam = np.array([0.3, 1.0, 0.7, 0.5, 0.9, 0.2], np.float32)
        cut = np.array([True, True, False, True, False, True])
        boxes = tuple(np.array(v, np.int32) for v in (
            [0, 1, 2, 0, 3, 1], [4, 8, 5, 2, 7, 6], [1, 0, 0, 2, 4, 3], [5, 3, 8, 6, 8, 7]))
    else:
        lam, cut = np.float32(0.62), np.bool_(True)
        boxes = tuple(np.int32(v) for v in (1, 6, 2, 7))
    want, want_lam = jmix._mix_with_flipped(jnp.asarray(x), jnp.asarray(lam), jnp.asarray(cut),
                                            tuple(jnp.asarray(b) for b in boxes), H, H)
    got, got_lam = tmix._mix_with_flipped(torch.from_numpy(x), torch.tensor(lam),
                                          torch.tensor(cut), tuple(torch.tensor(b) for b in boxes),
                                          H, H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_lam.numpy(), np.asarray(want_lam), rtol=1e-7)
    labels = np.array([0, 4, 2, 6, 1, 3])
    np.testing.assert_array_equal(
        tmix._one_hot_smooth(torch.from_numpy(labels), 7, 0.1).numpy(),
        np.asarray(jmix._one_hot_smooth(jnp.asarray(labels), 7, 0.1)))


@pytest.mark.parametrize("mode", ["batch", "pair", "elem"])
def test_mixup_cutmix_with_fixed_draws_matches_jax(mode, monkeypatch):
    """The whole mixup_cutmix with its draws pinned in both packages."""
    B, H = 6, 8
    n = {"batch": (), "pair": (B // 2,), "elem": (B,)}[mode]
    rng = np.random.default_rng(3)
    lam = rng.uniform(0.1, 0.9, n).astype(np.float32)
    cut = rng.random(n) < 0.5
    box = tuple(rng.integers(0, H + 1, n).astype(np.int32) for _ in range(4))
    box = (np.minimum(box[0], box[1]), np.maximum(box[0], box[1]),
           np.minimum(box[2], box[3]), np.maximum(box[2], box[3]))
    per_sample = iter(range(n[0]) if n else [()])  # the port draws one box per sample
    monkeypatch.setattr(jmix, "_params", lambda r, c, shape=(): (jnp.asarray(lam),
                                                                 jnp.asarray(cut)))
    monkeypatch.setattr(tmix, "_params", lambda g, c, shape=(): (torch.tensor(lam),
                                                                 torch.tensor(cut)))
    monkeypatch.setattr(jmix, "_sample_box", lambda r, h, w, l, c: tuple(
        jnp.asarray(b) for b in box))
    monkeypatch.setattr(tmix, "_sample_box", lambda g, h, w, l, c: (
        lambda i: tuple(torch.tensor(b[i]) for b in box))(next(per_sample)))
    if n:  # JAX vmaps _sample_box over the per-sample keys: give it the whole arrays
        monkeypatch.setattr(jax, "vmap", lambda f: lambda keys, lams: tuple(
            jnp.asarray(b) for b in box))
    x = _images(B, 1, H)
    labels = np.array([0, 4, 2, 6, 1, 3])
    cfg = dict(num_classes=7, mode=mode)
    want_x, want_t = jmix.mixup_cutmix(jax.random.key(0), jnp.asarray(x), jnp.asarray(labels),
                                       jmix.MixupConfig(**cfg))
    got_x, got_t = tmix.mixup_cutmix(torch.Generator(), torch.from_numpy(x),
                                     torch.from_numpy(labels), tmix.MixupConfig(**cfg))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6, atol=1e-7)


def test_mixup_sampling_statistics_match_jax():
    """elem mode over 4000 samples: the Beta(0.8, 0.8) lam of the mixup
    draws, the cutmix share and the area-corrected lam of the boxes agree
    with the JAX package's draws (and with Beta's moments)."""
    B, H = 4000, 16
    x = np.zeros((B, H, H, 1), np.float32)
    x[: B // 2] = 1.0  # flipped partner of the first half is 0: mixed mean = lam
    labels = np.zeros(B, np.int64)
    cfg = dict(num_classes=2, mode="elem", label_smoothing=0.0)

    def stats(lam_out, use_cut):
        return dict(share=float(np.mean(use_cut)), mix=lam_out[~use_cut], cut=lam_out[use_cut])

    jl, jc = jmix._params(jax.random.key(0), jmix.MixupConfig(**cfg), (B,))
    tl, tc = tmix._params(torch.Generator().manual_seed(0), tmix.MixupConfig(**cfg), (B,))
    tl, tc = tl.numpy(), tc.numpy()
    jl, jc = np.asarray(jl), np.asarray(jc)
    for lam, cut in ((jl, jc), (tl, tc)):
        assert abs(np.mean(cut) - 0.5) < 0.03
        mix = lam[~cut]  # Beta(0.8, 0.8): mean 1/2, var 0.64 / (2.56 * 2.6)
        assert abs(mix.mean() - 0.5) < 0.02 and abs(mix.var() - 0.64 / 6.656) < 0.01
        uni = lam[cut]  # Beta(1, 1) = uniform: var 1/12
        assert abs(uni.mean() - 0.5) < 0.02 and abs(uni.var() - 1 / 12) < 0.01
    # the boxes: area-corrected lam of cutmix samples, from the full call
    _, want_t = jmix.mixup_cutmix(jax.random.key(1), jnp.asarray(x), jnp.asarray(labels),
                                  jmix.MixupConfig(**dict(cfg, mixup_alpha=0.0)))
    _, got_t = tmix.mixup_cutmix(torch.Generator().manual_seed(1), torch.from_numpy(x),
                                 torch.from_numpy(labels),
                                 tmix.MixupConfig(**dict(cfg, mixup_alpha=0.0)))
    w, g = np.asarray(want_t)[:, 0], got_t.numpy()[:, 0]  # lam of each sample
    assert abs(w.mean() - g.mean()) < 0.02 and abs(w.std() - g.std()) < 0.02


def test_eval_counters_match_jax_and_ignore_padding():
    logits = _logits((7, 9), 4)
    labels = np.array([0, 3, 8, 1, -1, 5, -1])
    want = jax.device_get(jsteps.eval_counters(jnp.asarray(logits), jnp.asarray(labels)))
    got = tsteps.eval_counters(torch.from_numpy(logits), torch.from_numpy(labels))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    imgs, labs, bs, n = pad_batch_to_steady(np.ones((3, 2)), np.arange(3), 5)
    assert (bs, n) == (5, 3) and imgs.shape == (5, 2) and list(labs) == [0, 1, 2, -1, -1]
    with pytest.raises(ValueError, match="ragged"):
        pad_batch_to_steady(np.ones((6, 2)), np.arange(6), 5)


def test_train_epoch_lags_the_pull_and_stops_on_a_non_finite_loss():
    seen = []

    def step(carry, images, labels, gen):
        seen.append(carry)
        return carry + 1, {"loss": torch.tensor(float("nan") if carry == 1 else 1.0)}

    with pytest.raises(NonFiniteLossError):
        train_epoch(step, 0, [(None, None)] * 4, torch.Generator(), epoch=0,
                    log_fn=lambda *_: None)
    assert seen == [0, 1, 2]  # step 2 was queued before step 1's loss was read
    carry, avg, _ = train_epoch(lambda c, *a: (c, {"loss": torch.tensor(2.0)}), 0,
                                [(None, None)] * 3, torch.Generator(), epoch=0,
                                log_fn=lambda *_: None)
    assert avg == {"loss": 2.0}
    with pytest.raises(NotImplementedError, match="still to port"):
        fit(carry=0, step_fn=None, train_batches_fn=None, eval_fn=None, epochs=1,
            generator=torch.Generator(), tensorboard=True)


def test_fit_writes_stats_and_best_accuracy(tmp_path):
    accs = iter([10.0, 30.0, 20.0])
    carry, best = fit(carry=0, step_fn=lambda c, *a: (c + 1, {"loss": torch.tensor(1.0)}),
                      train_batches_fn=lambda e: [(None, None)] * 2,
                      eval_fn=lambda c: {"acc1": next(accs), "acc5": 99.0}, epochs=3,
                      generator=torch.Generator().manual_seed(0), output_dir=str(tmp_path),
                      log_fn=lambda *_: None)
    assert carry == 6 and best == 30.0
    assert len((tmp_path / "log_stats.txt").read_text().splitlines()) == 3
    assert len((tmp_path / "result.txt").read_text().splitlines()) == 2


def test_meters():
    m = SmoothedValue(window_size=2)
    for v in (1.0, 2.0, 6.0):
        m.update(v)
    assert (m.median, m.avg, m.global_avg, m.value) == (4.0, 4.0, 3.0, 6.0)
    log = MetricLogger(log_fn=lambda *_: None)
    log.update(loss=1.0)
    assert list(log.log_every(range(3), 1)) == [0, 1, 2] and "loss" in str(log)
