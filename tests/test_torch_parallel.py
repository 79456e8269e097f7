"""The port's data- and division-parallel steps (devit_tpu_torch/parallel/
mesh.py, the `layout` of train/steps.py) on several CPU ranks joined by a
gloo group, against the JAX package's single-device steps and against the
port's one-process steps, from the same numpy weights and batches, at f32
and toy width. The ranks run tests/torch_dist_worker.py through
parallel/launch.run_ranks, each with its own timeout.

Tolerances: losses and eval counters 1e-5 relative. Step-1 gradients
against JAX rtol 2e-3, atol 2e-5 (tests/test_torch_stage2.py's); against
the one-process port 1e-5 relative with an absolute floor of 1e-7 (the
W-rank mean differs from one mean over the batch in its summation order
only). Parameters and EMA after the steps as in tests/test_torch_stage2.py:
atol 2e-6 where the step-1 gradient exceeds 1e-4 of its leaf's largest,
everywhere within steps * lr."""

import os

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
from devit_tpu.train import optim as joptim
from devit_tpu.train import steps as jsteps
from devit_tpu.train.state import TrainState as JState
from devit_tpu_torch.io.bridge import stacked_vit_to_jax_params, vit_to_jax_params
from devit_tpu_torch.io.bridge import ensmlp_to_jax_params
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.models import ensemble as tens
from devit_tpu_torch.models.vit import VisionTransformer
from devit_tpu_torch.parallel import mesh as M
from devit_tpu_torch.parallel.launch import run_ranks

import torch_dist_worker as W

WORKER = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=7)
TEACHER = dict(TOY, embed_dim=128, num_heads=8)
K, LR, EMA, STEPS = 7, 1e-3, 0.9, 2
OPT = dict(lr=LR, min_lr=1e-5, warmup_lr=1e-4, warmup_epochs=1, epochs=3)
# momentum SGD at a constant lr of 1: the update is linear in the clipped
# gradient and large enough that a clip by another norm shows in the
# parameters (Adam's update hardly depends on the gradient's scale)
CLIP_OPT = dict(OPT, opt="momentum", lr=1.0, warmup_lr=1.0, warmup_epochs=0, sched="constant")
FIXED_MIX = (np.float32(0.64), np.bool_(True), (2, 20, 5, 29))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _t(values):
    return {k: torch.from_numpy(v) for k, v in values.items()}


def _init(name, geom, seed):
    """A model's weights drawn by the port's initializers, as the JAX
    package's numpy tree."""
    model = VisionTransformer(get_vit_config(name, **geom), dtype=torch.float32)
    return vit_to_jax_params(model.reset_parameters(torch.Generator().manual_seed(seed)))


def _gates(seed, D=None):
    rng = np.random.default_rng(seed)
    cfg = jax_cfg("dedeit", **TOY)
    L = cfg.depth

    def one():
        g = build_gates(np.stack([rng.permutation(cfg.hidden_dim) for _ in range(L)]),
                        np.stack([rng.permutation(cfg.num_heads) for _ in range(L)]),
                        rng.uniform(0, 0.6, L), rng.choice([0.0, 0.25, 0.5], L))
        return np.array(g.head, np.float32), np.array(g.neuron, np.float32)

    if D is None:
        return one()
    gs = [one() for _ in range(D)]
    return np.stack([g[0] for g in gs]), np.stack([g[1] for g in gs])


def _batches(seed, B, n=STEPS):
    rng = np.random.default_rng(seed)
    out = [(rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            rng.integers(0, K, B).astype(np.int64)) for _ in range(n + 1)]
    return out[:n], out[n]


def _jax_recording(sink, opt=OPT):
    """The JAX optimizer, handing the gradients it receives to `sink` (from
    inside jit too)."""
    tx = joptim.make_optimizer(joptim.OptimConfig(**opt), 2)
    return optax.GradientTransformation(
        tx.init, lambda g, s, p=None: (jax.debug.callback(sink.append, g), tx.update(g, s, p))[1])


def _fix_jax_mixup(monkeypatch):
    lam, cut, box = FIXED_MIX
    monkeypatch.setattr(jmix, "_params", lambda r, c, shape=(): (jnp.asarray(lam),
                                                                 jnp.asarray(cut)))
    monkeypatch.setattr(jmix, "_sample_box", lambda r, h, w, l, c: tuple(
        jnp.int32(v) for v in box))


def _assert_after_steps(got, want, g_step1, steps=STEPS, noise=()):
    """`noise`: leaves whose gradient is zero but for rounding (Adam turns
    its sign into a full lr step), held to the steps * lr bound alone."""
    assert got.keys() == want.keys()
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= steps * LR * 1.001, k
        if k in noise:
            continue
        g = np.abs(g_step1[k])
        big = g > 1e-4 * g.max()
        np.testing.assert_allclose(got[k][big], want[k][big], rtol=0, atol=2e-6, err_msg=str(k))


def _assert_grads(got, want, rtol, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=str(k))


def _assert_same_run(par, one, grads_key="grads"):
    """A W-rank run against the one-process run of the same spec."""
    for m_par, m_one in zip(par["metrics"], one["metrics"]):
        assert m_par.keys() == m_one.keys()
        for k in m_one:
            np.testing.assert_allclose(m_par[k], m_one[k], rtol=1e-5, err_msg=k)
    for k in one["eval"]:
        np.testing.assert_allclose(par["eval"][k], one["eval"][k], rtol=1e-5, err_msg=k)
    _assert_grads(par[grads_key], one[grads_key], 1e-5, 1e-7)


# ------------------------------------------------------------------ layouts


@pytest.mark.parametrize("world,D,want", [
    (8, 4, {"div": 4, "data": 2}), (8, 8, {"div": 8, "data": 1}),
    (8, 16, {"div": 1, "data": 8}), (2, 4, {"div": 1, "data": 2})])
def test_ensemble_layout_follows_the_jax_rule(world, D, want):
    """tests/test_data_parallel.py's (W, D) cases: the division axis spans D
    ranks where the world divides by D, else the batch alone is sharded;
    rank r holds division group r // data and data shard r % data."""
    assert M.layout_shape(world, D) == want
    layouts = [M.Layout(world, r, want["div"], want["data"], D) for r in range(world)]
    per = D // want["div"]
    for r, lay in enumerate(layouts):
        assert lay.div_index == r // want["data"] and lay.data_index == r % want["data"]
        assert list(lay.divisions) == list(range(lay.div_index * per,
                                                 (lay.div_index + 1) * per))
    # every division is held by one division group, every row by one shard
    assert sorted(d for lay in layouts[::want["data"]] for d in lay.divisions) == list(range(D))
    rows = sorted(lay.rows(16)[:2] for lay in layouts[:want["data"]]) if want["data"] > 1 \
        else [(0, 16)]
    assert rows[0][0] == 0 and rows[-1][1] == 16
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    if want["data"] > 1:
        assert layouts[0].rows(16 + 1) is None  # a batch the shards do not divide: replicated


def test_one_process_layout_is_a_no_op():
    lay = M.ensemble_layout(4)
    assert lay.shape == {"div": 1, "data": 1} and lay.rows(8) is None
    x = torch.arange(6.0).reshape(3, 2)
    assert lay.gather_divisions(x) is x and lay.sum_over_data(x) is x
    assert lay.mean_over_data([x])[0] is x
    assert M.shard_division_tree({"a": x}, lay)["a"] is x


# ------------------------------------------------------------------ stage 2 and DEKD


@pytest.fixture(scope="module")
def stage2_runs():
    """One 2-rank launch for the stage-2 and DEKD scenarios: against JAX
    (every draw off or fixed) and against one process (drop-path, dropout and
    timm's mixup draws on, all made at the global batch)."""
    s_params = _init("dedeit", TOY, 0)
    t_params = _init("devit", TOY, 1)
    ds_params = _init("dedeit", TOY, 2)
    dt_params = _init("deit_base_distilled_patch16_224", TEACHER, 3)
    batches, ev = _batches(3, 8)
    base = dict(opt=OPT, ema=EMA, batches=batches, seeds=list(range(STEPS)), eval_batch=ev)
    specs = {
        "stage2_jax": dict(base, kind="stage2", student=("dedeit", TOY, s_params),
                           teacher=("devit", TOY, t_params), mixup=dict(num_classes=K),
                           mixup_fixed=FIXED_MIX,
                           kw=dict(smoothing=0.1, distillation_type="soft",
                                   distillation_alpha=0.5, distillation_tau=2.0)),
        "dekd_jax": dict(base, kind="dekd", student=("dedeit", TOY, ds_params),
                         teacher=("deit_base_distilled_patch16_224", TEACHER, dt_params),
                         gates=_gates(4),
                         kw=dict(gamma=(0.2, 0.1, 0.3), smoothing=0.1, distillation_type="hard",
                                 distillation_alpha=0.5, distillation_tau=2.0)),
        "stage2_draws": dict(base, kind="stage2",
                             student=("dedeit", dict(TOY, drop_path_rate=0.2, drop_rate=0.1),
                                      s_params),
                             mixup=dict(num_classes=K, mode="elem", label_smoothing=0.1),
                             kw=dict(smoothing=0.1)),
        "dekd_draws": dict(base, kind="dekd",
                           student=("dedeit", dict(TOY, drop_path_rate=0.2), ds_params),
                           teacher=("deit_base_distilled_patch16_224", TEACHER, dt_params),
                           gates=_gates(5), mixup=dict(num_classes=K),
                           kw=dict(smoothing=0.1, distillation_type="hard")),
    }
    par = run_ranks(f"{WORKER}:run_all", 2, args=(specs,), timeout=240)
    return specs, par


def _jax_stage2(spec, monkeypatch):
    """The JAX package's steps over the spec (one device)."""
    name, geom, params = spec["student"]
    jm = jvit.VisionTransformer(jax_cfg(name, **geom), dtype=jnp.float32)
    tname, tgeom, tparams = spec["teacher"]
    jt = jvit.VisionTransformer(jax_cfg(tname, **tgeom), dtype=jnp.float32)
    grads = []
    state = JState.create(params, _jax_recording(grads), use_ema=True, ema_decay=EMA)
    kw = dict(spec["kw"])
    if spec["kind"] == "dekd":
        step = jax.jit(jsteps.make_dekd_step(jm, jt, **kw))
        g = jvit.Gates(*map(jnp.asarray, spec["gates"]))
        run = lambda st, x, y, i: step(st, {"params": tparams}, g, x, y, jax.random.key(i))
    else:
        _fix_jax_mixup(monkeypatch)
        step = jax.jit(jsteps.make_stage2_step(jm, jt, mixup=jmix.MixupConfig(**spec["mixup"]),
                                               **kw))
        run = lambda st, x, y, i: step(st, {"params": tparams}, x, y, jax.random.key(i))
    metrics = []
    for (x, y), i in zip(spec["batches"], spec["seeds"]):
        state, m = run(state, jnp.asarray(x), jnp.asarray(y), i)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads[0], state


@pytest.mark.parametrize("kind", ["stage2", "dekd"])
def test_two_rank_step_matches_jax(stage2_runs, kind, monkeypatch):
    specs, par = stage2_runs
    spec = specs[f"{kind}_jax"]
    got = par[0][f"{kind}_jax"]
    assert par[1][f"{kind}_jax"]["metrics"] == got["metrics"]  # replicated results
    assert got["shape"] == {"div": 1, "data": 2}
    metrics, g_want, jstate = _jax_stage2(spec, monkeypatch)
    for m_got, m_want in zip(got["metrics"], metrics):
        assert m_got.keys() == m_want.keys()
        for k in m_want:
            np.testing.assert_allclose(m_got[k], m_want[k], rtol=1e-5, err_msg=k)
    g_want = _flat(g_want)
    _assert_grads(_flat(vit_to_jax_params(_t(got["grads"]))), g_want, 2e-3, 2e-5)
    for want, have in ((jstate.params, got["params"]), (jstate.ema_params, got["ema"])):
        _assert_after_steps(_flat(vit_to_jax_params(_t(have))), _flat(jax.device_get(want)),
                            g_want)


@pytest.mark.parametrize("kind", ["stage2", "dekd"])
def test_two_rank_step_with_draws_equals_one_process(stage2_runs, kind):
    specs, par = stage2_runs
    one = W.run_all({kind: specs[f"{kind}_draws"]}, parallel=False)[kind]
    got = par[0][f"{kind}_draws"]
    _assert_same_run(got, one)
    for r in par:  # both ranks hold the same state
        for k, v in r[f"{kind}_draws"]["params"].items():
            np.testing.assert_array_equal(v, got["params"][k])
    _assert_after_steps(got["params"], one["params"], one["grads"])


# ------------------------------------------------------------------ stage 5


def _stage5_spec(D, clip, seed, B=8):
    """Weights drawn by the port's initializers (JAX's init is slower here),
    handed to both packages as the JAX package's numpy trees."""
    jm = jvit.VisionTransformer(jax_cfg("dedeit", **TOY), dtype=jnp.float32)
    model = VisionTransformer(get_vit_config("dedeit", **TOY), dtype=torch.float32)
    stacked = stacked_vit_to_jax_params(tens.init_multivit(
        model, [torch.Generator().manual_seed(seed + d) for d in range(D)]))
    head = jens.EnsMLP(num_classes=K, sub_size=64, num_divisions=D, teacher_size=128,
                       family="deit", dtype=jnp.float32)
    ens = ensmlp_to_jax_params(tens.EnsMLP(
        num_classes=K, sub_size=64, num_divisions=D, teacher_size=128, family="deit",
        dtype=torch.float32).reset_parameters(torch.Generator().manual_seed(seed + D)))
    batches, ev = _batches(seed + 3, B)
    return dict(family="vit", D=D, backbone=("dedeit", TOY), stacked=stacked, ens=ens,
                teacher=("deit_base_distilled_patch16_224", TEACHER,
                         _init("deit_base_distilled_patch16_224", TEACHER, seed + D + 1)),
                gates=_gates(seed + 4, D), opt=dict(CLIP_OPT, clip_grad=clip), ema=EMA,
                batches=batches, seeds=list(range(STEPS)), eval_batch=ev,
                mixup=dict(num_classes=K), mixup_fixed=FIXED_MIX,
                kw=dict(smoothing=0.1, distillation_type="hard", distillation_alpha=0.5,
                        distillation_tau=1.0, token_loss_type="mse")), jm, head


def _jax_stage5(spec, jm, head, monkeypatch):
    _fix_jax_mixup(monkeypatch)
    g_bb, g_ens = [], []
    jbb = JState.create(spec["stacked"], _jax_recording(g_bb, spec["opt"]), use_ema=True,
                        ema_decay=EMA)
    jen = JState.create(spec["ens"], _jax_recording(g_ens, spec["opt"]), use_ema=True,
                        ema_decay=EMA)
    tname, tgeom, tparams = spec["teacher"]
    jt = jvit.VisionTransformer(jax_cfg(tname, **tgeom), dtype=jnp.float32)
    step = jax.jit(jsteps.make_ensemble_train_step(
        jm, head, jt, mixup=jmix.MixupConfig(**spec["mixup"]), **spec["kw"]))
    g = jvit.Gates(*map(jnp.asarray, spec["gates"]))
    metrics = []
    for (x, y), i in zip(spec["batches"], spec["seeds"]):
        jbb, jen, m = step(jbb, jen, {"params": tparams}, g, jnp.asarray(x), jnp.asarray(y),
                           jax.random.key(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, g_bb[0], g_ens[0], jbb, jen


@pytest.mark.parametrize("world,D,clip,want", [
    (4, 2, 0.05, {"div": 2, "data": 2}),  # divisions and batch both sharded, clip active
    (2, 4, 0.05, {"div": 1, "data": 2}),  # D does not fit the world: the batch alone
])
def test_sharded_stage5_step_matches_jax(world, D, clip, want, monkeypatch):
    spec, jm, head = _stage5_spec(D, clip, 10 + world)
    par = run_ranks(f"{WORKER}:stage5", world, args=(spec,), timeout=240)
    got = par[0]
    assert got["shape"] == want
    assert sorted(d for r in par for d in r["divisions"]) == sorted(
        list(range(D)) * (world // want["div"]))
    metrics, g_bb, g_ens, jbb, jen = _jax_stage5(spec, jm, head, monkeypatch)
    for m_got, m_want in zip(got["metrics"], metrics):
        assert m_got.keys() == m_want.keys()
        for k in m_want:
            np.testing.assert_allclose(m_got[k], m_want[k], rtol=1e-5, err_msg=k)
    g_bb, g_ens = _flat(g_bb), _flat(g_ens)
    _assert_grads(_flat(stacked_vit_to_jax_params(_t(got["bb_grads"]))), g_bb, 2e-3, 2e-5)
    _assert_grads(_flat(ensmlp_to_jax_params(_t(got["ens_grads"]))), g_ens, 2e-3, 2e-5)
    # the clip is active: the global norm of the step-1 gradient exceeds it
    norm = np.sqrt(sum(np.sum(v ** 2) for v in g_bb.values()))
    assert norm > clip
    _assert_after_steps(_flat(stacked_vit_to_jax_params(_t(got["bb_params"]))),
                        _flat(jbb.params), g_bb)
    _assert_after_steps(_flat(stacked_vit_to_jax_params(_t(got["bb_ema"]))),
                        _flat(jbb.ema_params), g_bb)
    _assert_after_steps(_flat(ensmlp_to_jax_params(_t(got["ens_params"]))),
                        _flat(jen.params), g_ens)
    one = W.stage5(spec, parallel=False)
    _assert_same_run(got, one, "bb_grads")
    for k in one["eval"]:
        assert got["eval"][k] == pytest.approx(one["eval"][k], rel=1e-5)


def test_sharded_cct_stage5_with_draws_equals_one_process():
    """The CCT family's stage 5 over {div 2, data 2}, its dropout and
    drop-path on (one seed a division from the step's generator, every mask
    drawn at the global batch), against one process."""
    geom = dict(img_size=32, embed_dim=64, num_heads=4, num_layers=2, mlp_ratio=2.0,
                stochastic_depth=0.2, dropout=0.1, attention_dropout=0.1)
    batches, ev = _batches(20, 8)
    spec = dict(family="cct", D=2, backbone=("decct_2_3x2_32", geom), num_classes=K,
                opt=dict(OPT, clip_grad=0.05), ema=EMA, batches=batches,
                seeds=list(range(STEPS)), eval_batch=ev, kw=dict(smoothing=0.1))
    par = run_ranks(f"{WORKER}:stage5", 4, args=(spec,), timeout=240)
    one = W.stage5(spec, parallel=False)
    assert par[0]["shape"] == {"div": 2, "data": 2}
    _assert_same_run(par[0], one, "bb_grads")
    # the seq-pool's bias shifts every token's score alike: softmax is blind
    # to it, so its gradient is rounding noise
    _assert_after_steps(par[0]["bb_params"], one["bb_params"], one["bb_grads"],
                        noise=("attention_pool.bias",))
