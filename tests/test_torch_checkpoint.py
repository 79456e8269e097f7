"""The port's checkpoint ingestion and training-state checkpoints
(devit_tpu_torch/io/checkpoint.py, train/state.py stage2_tree /
restore_stage2_tree, train/loop.fit's save_state_fn) against the JAX
package's on the CPU.

- The torch and Flax .npz converters and resize_pos_embed against
  devit_tpu/io/checkpoint.py's on the same numpy inputs, within 1e-6 (they
  are the same numpy arithmetic), and resize_pos_embed against
  F.interpolate(bicubic, align_corners=False) on f32, which it emulates
  (within 1e-6 + 4e-6 relative: F.interpolate sums in f32).
- A JAX stage-2 state of a toy ViT, saved the JAX package's way (msgpack of
  {params, ema_params, opt_state, epoch}), resumed by the port, and the
  port's saved state resumed by the JAX package (its _try_resume template
  restore), for adamw (with clipping), adam (with coupled decay) and sgd
  with momentum: one optimizer + EMA step each after the restore, from the
  same gradients, within 1e-5 at f32.
- fit writes checkpoint_temp.msgpack after every epoch and
  checkpoint.msgpack at each new best.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.io import checkpoint as jck
from devit_tpu.models import vit as jvit
from devit_tpu.train import optim as joptim
from devit_tpu.train.state import TrainState as JState
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.io import checkpoint as tck
from devit_tpu_torch.io.bridge import vit_from_jax_params, vit_to_jax_params
from devit_tpu_torch.train import optim as toptim
from devit_tpu_torch.train.loop import fit
from devit_tpu_torch.train.state import TrainState, restore_stage2_tree, stage2_tree

TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=7)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _assert_trees_close(a, b, tol):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=0, atol=tol, err_msg=str(k))


def _torch_sd(depth=2, D=16, p=4, classes=5, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    sd = {"patch_embed.proj.weight": r(D, 3, p, p), "patch_embed.proj.bias": r(D),
          "cls_token": r(1, 1, D), "dist_token": r(1, 1, D), "pos_embed": r(1, 18, D),
          "norm.weight": r(D), "norm.bias": r(D), "head.weight": r(classes, D),
          "head.bias": r(classes), "head_dist.weight": r(classes, D),
          "head_dist.bias": r(classes)}
    for i in range(depth):
        for n, (o, k) in {"attn.qkv": (3 * D, D), "attn.proj": (D, D), "mlp.fc1": (4 * D, D),
                          "mlp.fc2": (D, 4 * D)}.items():
            sd[f"blocks.{i}.{n}.weight"], sd[f"blocks.{i}.{n}.bias"] = r(o, k), r(o)
        for n in ("norm1", "norm2"):
            sd[f"blocks.{i}.{n}.weight"], sd[f"blocks.{i}.{n}.bias"] = r(D), r(D)
    return sd


def test_torch_converters_match_jax(tmp_path):
    sd = _torch_sd()
    want = jck.torch_vit_to_params(sd, 2)
    got = tck.torch_vit_to_params(sd, 2)
    _assert_trees_close(got, jax.device_get(want), 1e-6)
    back_j = jck.params_to_torch_vit(want, 2)
    back_t = tck.params_to_torch_vit(got, 2)
    assert back_j.keys() == back_t.keys() == sd.keys()
    for k in sd:
        np.testing.assert_allclose(back_t[k], back_j[k], atol=1e-6)
        np.testing.assert_array_equal(back_t[k], sd[k])
    path = str(tmp_path / "ckpt.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3}, path)
    loaded = tck.load_torch_state_dict(path)
    assert loaded.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(loaded[k], sd[k])


def test_flax_npz_converter_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    D, p, heads, dh, depth = 16, 4, 2, 8, 2
    w = {"embedding/kernel": r(p, p, 3, D), "embedding/bias": r(D), "cls": r(1, 1, D),
         "Transformer/posembed_input/pos_embedding": r(1, 17, D),
         "Transformer/encoder_norm/scale": r(D), "Transformer/encoder_norm/bias": r(D),
         "head/kernel": r(D, 5), "head/bias": r(5)}
    for i in range(depth):
        bp = f"Transformer/encoderblock_{i}/"
        mha = bp + "MultiHeadDotProductAttention_1/"
        for n in ("query", "key", "value"):
            w[f"{mha}{n}/kernel"], w[f"{mha}{n}/bias"] = r(D, heads, dh), r(heads, dh)
        w[f"{mha}out/kernel"], w[f"{mha}out/bias"] = r(heads, dh, D), r(D)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            w[f"{bp}{ln}/scale"], w[f"{bp}{ln}/bias"] = r(D), r(D)
        w[f"{bp}MlpBlock_3/Dense_0/kernel"], w[f"{bp}MlpBlock_3/Dense_0/bias"] = r(D, 4 * D), r(4 * D)
        w[f"{bp}MlpBlock_3/Dense_1/kernel"], w[f"{bp}MlpBlock_3/Dense_1/bias"] = r(4 * D, D), r(D)
    for prefix in ("", "opt/target/"):
        path = str(tmp_path / f"vit{len(prefix)}.npz")
        np.savez(path, **{prefix + k: v for k, v in w.items()})
        _assert_trees_close(tck.load_flax_npz_vit(path, depth),
                            jax.device_get(jck.load_flax_npz_vit(path, depth)), 1e-6)


@pytest.mark.parametrize("old,new,prefix", [(17, 50, 1), (198, 66, 2), (65, 17, 1), (50, 50, 1)])
def test_resize_pos_embed_matches_jax_and_interpolate(old, new, prefix):
    pe = np.random.default_rng(old).standard_normal((1, old, 12)).astype(np.float32)
    got = tck.resize_pos_embed(pe, new, prefix)
    np.testing.assert_allclose(got, jck.resize_pos_embed(pe, new, prefix), atol=1e-6)
    assert got.shape == (1, new, 12)
    np.testing.assert_array_equal(got[:, :prefix], pe[:, :prefix])
    gs_old, gs_new = int(np.sqrt(old - prefix)), int(np.sqrt(new - prefix))
    grid = torch.from_numpy(pe[0, prefix:]).reshape(1, gs_old, gs_old, 12).permute(0, 3, 1, 2)
    ref = torch.nn.functional.interpolate(grid, size=(gs_new, gs_new), mode="bicubic",
                                          align_corners=False)
    # F.interpolate takes its 16 taps in f32, the emulation in f64 rounded
    # once: a few f32 ulps of values up to ~4
    np.testing.assert_allclose(got[0, prefix:], ref.permute(0, 2, 3, 1).reshape(-1, 12).numpy(),
                               rtol=4e-6, atol=1e-6)
    with pytest.raises(ValueError, match="not square"):
        tck.resize_pos_embed(pe, new + 1, prefix)


# ---- the stage-2 training state, across the two packages

FAMILIES = {
    "adamw": dict(opt="adamw", weight_decay=0.05, clip_grad=1.0),
    "adam": dict(opt="adam", weight_decay=0.05),
    "sgd": dict(opt="sgd", weight_decay=1e-4, momentum=0.9),
}


def _configs(family):
    kw = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, warmup_epochs=1, epochs=3, **FAMILIES[family])
    return joptim.OptimConfig(**kw), toptim.OptimConfig(**kw)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(np.shape(p)) * 0.1).astype(np.float32), params)


def _named(tree, model):
    from devit_tpu_torch.io.bridge import vit_values_from_jax_params

    return {k: torch.from_numpy(v)
            for k, v in vit_values_from_jax_params(tree, dict(model.named_parameters())).items()}


@functools.lru_cache(maxsize=None)
def _params():
    jm = jvit.VisionTransformer(jax_cfg("dedeit", **TOY), dtype=jnp.float32)
    return jax.device_get(jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])


@functools.lru_cache(maxsize=None)
def _jax_state(family):
    """(a JAX stage-2 state three steps in, the initial params, the port's
    OptimConfig); immutable, so shared by the tests."""
    params = _params()
    jc, tc = _configs(family)
    tx = joptim.make_optimizer(jc, 10)
    state = JState.create(params, tx, use_ema=True, ema_decay=0.9)
    for s in range(3):  # a state with non-trivial moments and counts
        state = state.apply_gradients(_grads(params, s))
    return state, params, tc


def _port_state(params, tc):
    model = vit_from_jax_params(params, get_vit_config("dedeit", **TOY), device="cpu")
    return TrainState.create(model, toptim.make_optimizer(tc, 10), use_ema=True,
                             ema_decay=0.9), model


LAYOUTS = {  # every optimizer family of make_optimizer, with and without its chain's options
    "adamw+clip": dict(opt="adamw", weight_decay=0.05, clip_grad=1.0),
    "adamw": dict(opt="adamw", weight_decay=0.0),
    "adam+decay": dict(opt="adam", weight_decay=0.05),
    "adam": dict(opt="adam", weight_decay=0.0),
    "sgd+decay": dict(opt="sgd", weight_decay=1e-4, momentum=0.9),
    "nesterov": dict(opt="nesterov", weight_decay=0.0, momentum=0.9),
    "momentum+clip": dict(opt="momentum", weight_decay=1e-4, momentum=0.9, clip_grad=5.0),
    "sgd, no momentum": dict(opt="sgd", weight_decay=0.0, momentum=0.0),
}


def _layout(tree):
    """Keys and leaf shapes of a nested state dict ({} stays {})."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return np.shape(tree)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_opt_state_layout_matches_flax(name):
    """opt_state_to_tree lays the port's optimizer state out exactly as
    flax.serialization.to_state_dict lays out the optax chain's state of the
    same configuration, and the counts and moments land where JAX keeps
    them."""
    import flax

    kw = dict(lr=1e-3, warmup_epochs=0, epochs=3, **LAYOUTS[name])
    params = _params()
    jstate = JState.create(params, joptim.make_optimizer(joptim.OptimConfig(**kw), 10))
    jstate = jstate.apply_gradients(_grads(params, 0))
    want = flax.serialization.to_state_dict(jstate.opt_state)
    tstate, model = _port_state(params, toptim.OptimConfig(**kw))
    tstate.apply_gradients(_named(_grads(params, 0), model))
    got = stage2_tree(tstate, 0)["opt_state"]
    assert _layout(got) == _layout(jax.device_get(want))
    _assert_trees_close(got, jax.device_get(want), 1e-6)


def _tree(state: JState, epoch):
    return {"params": state.params, "ema_params": state.ema_params,
            "opt_state": state.opt_state, "epoch": np.int32(epoch)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_resumes_a_jax_stage2_checkpoint(tmp_path, family):
    jstate, params, tc = _jax_state(family)
    path = str(tmp_path / "checkpoint_temp.msgpack")
    jck.save_pytree(path, _tree(jstate, 4))
    tstate, model = _port_state(params, tc)
    tstate, start = restore_stage2_tree(tstate, tck.restore_pytree(path))
    assert start == 5 and tstate.opt_state["count"] == 3
    g = _grads(params, 10)
    jnext = jstate.apply_gradients(g)
    tstate.apply_gradients(_named(g, model))
    _assert_trees_close(vit_to_jax_params(tstate.params), jax.device_get(jnext.params), 1e-5)
    _assert_trees_close(vit_to_jax_params(tstate.ema_params), jax.device_get(jnext.ema_params),
                        1e-5)
    moments = ("mu", "nu") if family != "sgd" else ("trace",)
    for m in moments:
        jm = jax.tree_util.tree_leaves(jnext.opt_state, is_leaf=lambda x: hasattr(x, m))
        jm = next(getattr(x, m) for x in jm if hasattr(x, m))
        _assert_trees_close(vit_to_jax_params(tstate.opt_state[m]), jax.device_get(jm), 1e-5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_resumes_the_ports_stage2_checkpoint(tmp_path, family):
    jstate, params, tc = _jax_state(family)
    # the port's state: the JAX state's three steps taken by the port
    tstate, model = _port_state(params, tc)
    for s in range(3):
        tstate.apply_gradients(_named(_grads(params, s), model))
    path = str(tmp_path / "checkpoint.msgpack")
    tck.save_pytree(path, stage2_tree(tstate, 1))
    # the JAX package's _try_resume: a template restore of a fresh state
    fresh = JState.create(params, jstate.tx, use_ema=True, ema_decay=0.9)
    ckpt = jck.restore_pytree(path, _tree(fresh, 0))
    restored = fresh.replace(params=ckpt["params"], ema_params=ckpt["ema_params"],
                             opt_state=ckpt["opt_state"])
    assert int(ckpt["epoch"]) + 1 == 2
    g = _grads(params, 10)
    jnext = restored.apply_gradients(g)
    tstate.apply_gradients(_named(g, model))
    _assert_trees_close(vit_to_jax_params(tstate.params), jax.device_get(jnext.params), 1e-5)
    _assert_trees_close(vit_to_jax_params(tstate.ema_params), jax.device_get(jnext.ema_params),
                        1e-5)


def test_stage2_file_reads_back_leaf_for_leaf(tmp_path):
    jstate, params, tc = _jax_state("adamw")
    tstate, model = _port_state(params, tc)
    tstate.apply_gradients(_named(_grads(params, 0), model))
    path = str(tmp_path / "c.msgpack")
    tree = stage2_tree(tstate, 7)
    tck.save_pytree(path, tree)
    back = tck.restore_pytree(path)
    fa, fb = _flat(back), _flat(tree)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))
    assert int(back["epoch"]) == 7 and back["opt_state"]["0"] == {}


def test_fit_writes_both_checkpoints_at_the_right_epochs(tmp_path):
    accs = iter([10.0, 30.0, 20.0, 40.0])
    calls = []

    def save(path, carry, epoch):
        calls.append((path.rsplit("/", 1)[-1], epoch, carry))

    fit(carry=0, step_fn=lambda c, *a: (c + 1, {"loss": torch.tensor(1.0)}),
        train_batches_fn=lambda e: [(None, None)] * 2,
        eval_fn=lambda c: {"acc1": next(accs), "acc5": 99.0}, epochs=4,
        generator=torch.Generator().manual_seed(0), output_dir=str(tmp_path),
        log_fn=lambda *_: None, save_state_fn=save)
    temp = [(e, c) for n, e, c in calls if n == "checkpoint_temp.msgpack"]
    best = [e for n, e, _ in calls if n == "checkpoint.msgpack"]
    assert temp == [(0, 2), (1, 4), (2, 6), (3, 8)] and best == [0, 1, 3]
    # the temp file of an epoch is written before its eval decides the best
    assert [n for n, e, _ in calls if e == 1] == ["checkpoint_temp.msgpack", "checkpoint.msgpack"]
    calls.clear()
    accs = iter([50.0])
    fit(carry=8, step_fn=lambda c, *a: (c + 1, {"loss": torch.tensor(1.0)}),
        train_batches_fn=lambda e: [(None, None)] * 2,
        eval_fn=lambda c: {"acc1": next(accs), "acc5": 99.0}, epochs=4, start_epoch=3,
        generator=torch.Generator().manual_seed(0), output_dir=str(tmp_path),
        log_fn=lambda *_: None, save_state_fn=save)
    assert [(n, e) for n, e, _ in calls] == [("checkpoint_temp.msgpack", 3),
                                             ("checkpoint.msgpack", 3)]
