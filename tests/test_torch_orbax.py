"""The port's orbax checkpoints (devit_tpu_torch/io/zstd.py, ocdbt.py,
orbax.py and checkpoint.py's orbax backend) against the JAX package's
(devit_tpu/io/checkpoint.py save_pytree_orbax / restore_pytree, orbax and
tensorstore) on the CPU, every leaf compared bit for bit:

- the JAX package writes, the port reads (stage-2, stage-4 with gates,
  stage-5 gated ensemble states; bfloat16, 0-d, empty and None leaves;
  an unpromoted '.new'; the '.msgpack' sibling name; a store of several
  b-tree nodes with values in data files), against the JAX package's own
  raw restore of the same directory;
- the port writes, the JAX package reads back raw and with the template
  its CLI's resume builds (`_try_resume`, `_ensemble_ckpt_tree`), and both
  packages' `_METADATA` tree metadata for the same state are equal;
- the async save: never torn by an in-place update after it returns, never
  without a restorable checkpoint, a background failure raised at the next
  wait;
- the CLI: `train_sub --ckpt-format orbax` and its `--resume`, `convert`
  and `inspect` on orbax directories, at a toy geometry; the pipeline's
  skip and resume checks on '.orbax' artifacts; two ranks, rank 0
  writing;
- the committed JAX-written fixture `tests/torch_data/jax_orbax_tiny/`
  (rebuilt here and decoded to the same tree and logits; the port's f32
  forward on it against the JAX logits).

`python tests/test_torch_orbax.py` rewrites the fixture.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # as a script: the fixture writer
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from devit_tpu.cli.stages import _ensemble_ckpt_tree  # noqa: E402
from devit_tpu.configs import get_vit_config as jax_cfg  # noqa: E402
from devit_tpu.io import checkpoint as jck  # noqa: E402
from devit_tpu.models import ensemble as jens  # noqa: E402
from devit_tpu.models import vit as jvit  # noqa: E402
from devit_tpu.train import optim as joptim  # noqa: E402
from devit_tpu.train.state import TrainState as JState  # noqa: E402
from devit_tpu_torch.configs import get_vit_config  # noqa: E402
from devit_tpu_torch.io import checkpoint as tck  # noqa: E402
from devit_tpu_torch.io import ocdbt, zstd  # noqa: E402
from devit_tpu_torch.io import orbax as torbax  # noqa: E402
from devit_tpu_torch.io.bridge import (  # noqa: E402
    ensmlp_from_jax_params, stacked_vit_from_jax_params, vit_from_jax_params,
)
from devit_tpu_torch.models.vit import Gates  # noqa: E402
from devit_tpu_torch.train import optim as toptim  # noqa: E402
from devit_tpu_torch.train.state import (  # noqa: E402
    TrainState, stage2_tree, stage4_tree, stage5_tree,
)

TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=7)
D = 2
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, warmup_epochs=1, epochs=3, opt="adamw",
           weight_decay=0.05, clip_grad=1.0)
FIXTURE = os.path.join(ROOT, "tests", "torch_data", "jax_orbax_tiny")
FIXTURE_GEOMETRY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
                        num_classes=10)


# ------------------------------------------------------------ helpers


def _bits(x):
    """(dtype, shape, bytes) of an array leaf of either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.shape, a.view(np.uint16).tobytes()
    return a.dtype.str, a.shape, a.tobytes()


def _leaves(tree, prefix=()):
    """{key path: bits}, sequences indexed by "0", "1", ...; an empty
    container or None is None (orbax records optax's empty states, which
    flax's state dicts hold as {}, as None)."""
    if isinstance(tree, (dict, list, tuple)) and not isinstance(tree, np.ndarray):
        items = (tree.items() if isinstance(tree, dict)
                 else ((str(i), v) for i, v in enumerate(tree)))
        out = {}
        for k, v in items:
            out.update(_leaves(v, prefix + (str(k),)))
        return out or {prefix: None}
    return {prefix: None if tree is None else _bits(tree)}


def _assert_same_leaves(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys(), sorted(set(g) ^ set(w))
    for k in w:
        assert g[k] == w[k], (k, None if g[k] is None else g[k][:2],
                              None if w[k] is None else w[k][:2])


def _tree_metadata(path):
    with open(os.path.join(path, "_METADATA")) as f:
        return json.load(f)["tree_metadata"]


def _port_grads(state, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(tuple(p.shape)) * 0.1).astype(np.float32))
            for k, p in state.params.items()}


def _gates(seed, lead=()):
    rng = np.random.default_rng(seed)
    L, H = TOY["depth"], TOY["num_heads"]
    head = (rng.uniform(size=lead + (L, H)) < 0.7).astype(np.float32)
    neuron = (rng.uniform(size=lead + (L, 4 * TOY["embed_dim"])) < 0.6).astype(np.float32)
    return head, neuron


def _random_like(abstract, seed):
    """Random f32 numpy arrays of the shapes of an abstract tree."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), abstract)


def _jax_state(params, tx):
    """JState.create, jitted once (op by op it compiles every zeros_like)."""
    return jax.jit(lambda p: JState.create(p, tx, use_ema=True, ema_decay=0.9))(params)


@functools.lru_cache(maxsize=None)
def _states():
    """The JAX package's stage-2/4/5 checkpoint trees as its CLI writes them
    (device arrays, numpy epoch and gates), their _try_resume templates, and
    the port's trees of the same geometry (one optimizer step each).
    Parameters are random at the shapes flax's init gives (eval_shape: no
    compile)."""
    jm = jvit.VisionTransformer(jax_cfg("dedeit", **TOY), dtype=jnp.float32)
    x = jnp.zeros((2, 32, 32, 3))
    key = jax.random.key(0)
    params = _random_like(jax.eval_shape(jm.init, key, x)["params"], 0)
    tx = joptim.make_optimizer(joptim.OptimConfig(**OPT), 10)
    jst = _jax_state(params, tx)
    head, neuron = _gates(1)
    jgates = {"head": head, "neuron": neuron}
    s2 = lambda st, e: {"params": st.params, "ema_params": st.ema_params,
                        "opt_state": st.opt_state, "epoch": np.int32(e)}

    stacked = _random_like(jax.eval_shape(
        lambda k: jens.init_multivit(jm, k, x, D), key)["params"], 1)
    jhead = jens.EnsMLP(num_classes=TOY["num_classes"], sub_size=TOY["embed_dim"],
                        num_divisions=D, family="deit", dtype=jnp.float32)
    tok = jnp.zeros((D, 2, TOY["embed_dim"]))
    ens_params = _random_like(jax.eval_shape(
        lambda k: jhead.init(k, tok, tok, distill=True, train=True), key)["params"], 2)
    jbb, jen = _jax_state(stacked, tx), _jax_state(ens_params, tx)
    sh, sn = _gates(3, (D,))
    sgates = jvit.Gates(head=jnp.asarray(sh), neuron=jnp.asarray(sn))

    cfg = get_vit_config("dedeit", **TOY)
    topt = toptim.make_optimizer(toptim.OptimConfig(**OPT), 10)
    ts = TrainState.create(vit_from_jax_params(params, cfg, device="cpu"), topt, use_ema=True,
                           ema_decay=0.9)
    ts.apply_gradients(_port_grads(ts, 4))
    model = vit_from_jax_params(params, cfg, device="cpu")
    bb = TrainState.create(stacked_vit_from_jax_params(stacked, model, device="cpu"), topt,
                           use_ema=True, ema_decay=0.9)
    en = TrainState.create(ensmlp_from_jax_params(ens_params, num_divisions=D,
                                                  dtype=torch.float32, device="cpu"),
                           topt, use_ema=True, ema_decay=0.9)
    bb.apply_gradients(_port_grads(bb, 5))
    en.apply_gradients(_port_grads(en, 6))
    return {
        "stage2": (s2(jst, 4), s2(jst, 0), stage2_tree(ts, 4)),
        "stage4": (dict(s2(jst, 4), gates=jgates), dict(s2(jst, 0), gates=jgates),
                   stage4_tree(ts, 4, Gates(torch.from_numpy(head), torch.from_numpy(neuron)))),
        "stage5": (_ensemble_ckpt_tree(jbb, jen, 2, sgates),
                   _ensemble_ckpt_tree(jbb, jen, 0, sgates),
                   stage5_tree(bb, en, 2, Gates(torch.from_numpy(sh), torch.from_numpy(sn)))),
    }


def _jax_save(path, tree):
    jck.save_pytree_orbax(path, tree)
    jck.wait_for_checkpoints()


def _port_save(path, tree):
    tck.save_pytree_orbax(path, tree)
    tck.wait_for_checkpoints()


def _cli_save(path, tree):
    """The port's stage saver under --ckpt-format orbax (the stage trees'
    device state recorded as jax.Arrays, as the JAX CLI's save does)."""
    from devit_tpu_torch.cli import common as C

    C.make_saver(SimpleNamespace(ckpt_format="orbax"))(path, tree)
    tck.wait_for_checkpoints()


# ------------------------------------------------------------ JAX writes, the port reads


@pytest.mark.parametrize("stage", ["stage2", "stage4", "stage5"])
def test_port_reads_and_writes_the_jax_packages_states(tmp_path, stage):
    jtree, template, ttree = _states()[stage]
    jpath, tpath = str(tmp_path / "jax.orbax"), str(tmp_path / "port.orbax")
    _jax_save(jpath, jtree)
    _assert_same_leaves(tck.restore_pytree(jpath), jck.restore_pytree(jpath, None))

    _cli_save(tpath, ttree)
    assert _tree_metadata(tpath) == _tree_metadata(jpath)
    _assert_same_leaves(jck.restore_pytree(tpath, None), ttree)
    restored = jck.restore_pytree(tpath, template)
    import flax

    _assert_same_leaves(flax.serialization.to_state_dict(jax.device_get(restored)), ttree)
    _assert_same_leaves(tck.restore_pytree(tpath), ttree)


def test_port_reads_every_leaf_kind(tmp_path):
    tree = {"bf16": jnp.asarray(np.arange(6).reshape(2, 3), jnp.bfloat16),
            "bf16_0d": jnp.asarray(1.5, jnp.bfloat16),
            "f64": np.linspace(0, 1, 5), "i64": np.arange(4), "i32_0d": np.int32(-7),
            "u8": np.arange(250, 256, dtype=np.uint8), "bool": np.array([True, False]),
            "f32_0d": jnp.float32(3.25), "empty": {}, "none": None,
            "seq": [np.arange(3), {"x": jnp.ones((2, 2))}],
            "deep": {"a": {"b": {"c": jnp.arange(3.0)}}}}
    p = str(tmp_path / "kinds.orbax")
    _jax_save(p, tree)
    got, want = tck.restore_pytree(p), jck.restore_pytree(p, None)
    _assert_same_leaves(got, want)
    assert isinstance(got["bf16"], torch.Tensor) and got["bf16"].dtype == torch.bfloat16
    assert got["empty"] == {} and got["none"] is None and sorted(got["seq"]) == ["0", "1"]
    # the port writes every kind back; the JAX package reads the same leaves
    back = str(tmp_path / "back.orbax")
    _port_save(back, got)
    _assert_same_leaves(jck.restore_pytree(back, None), want)


def test_port_reads_an_unpromoted_new_and_the_msgpack_name(tmp_path):
    p = str(tmp_path / "checkpoint_temp.orbax")
    _jax_save(p, {"a": np.arange(4), "epoch": np.int32(1)})
    # a crash between the write's commit and its promotion: a durable .new
    jck.save_pytree_orbax(p, {"a": np.arange(4) + 2, "epoch": np.int32(2)})
    jck._ORBAX_CKPTR.wait_until_finished()
    jck._PENDING_PROMOTE.clear()
    assert os.path.isdir(p + ".new")
    for path in (p, str(tmp_path / "checkpoint_temp.msgpack")):
        got = tck.restore_pytree(path)
        np.testing.assert_array_equal(got["a"], np.arange(4) + 2)
        assert int(got["epoch"]) == 2
    assert os.path.isdir(p + ".new"), "restore must not change the disk"


def test_port_reads_a_store_of_several_btree_nodes(tmp_path, monkeypatch):
    """Orbax's own node size (1e8 decoded bytes) keeps a checkpoint's keys
    in one leaf; the JAX package writes here through orbax with a 2 KiB node
    size so the tree has interior nodes, and values past 1 KiB sit in data
    files."""
    from orbax.checkpoint._src.serialization import tensorstore_utils as tsu

    add = tsu.add_ocdbt_write_options

    def small_nodes(spec, *a, **kw):
        add(spec, *a, **kw)
        spec["config"]["max_decoded_node_bytes"] = 2048

    monkeypatch.setattr(tsu, "add_ocdbt_write_options", small_nodes)
    rng = np.random.default_rng(0)
    tree = {f"layer{i:02d}": {"kernel": jnp.asarray(rng.standard_normal((16, 24)), jnp.float32),
                              "bias": rng.standard_normal(24).astype(np.float32)}
            for i in range(24)}
    p = str(tmp_path / "big.orbax")
    _jax_save(p, tree)
    store = ocdbt.Store(p)
    assert store.node_count >= 3 and max(store.heights) >= 1, store.heights
    assert sum(isinstance(store.ref(k), ocdbt.Ref) for k in store.keys()) >= 24
    _assert_same_leaves(tck.restore_pytree(p), jck.restore_pytree(p, None))


# ------------------------------------------------------------ the async save


def test_async_save_is_not_torn_by_in_place_updates(tmp_path, monkeypatch):
    """save_pytree_orbax copies every leaf before it returns: a step that
    updates the parameters in place right after cannot reach the file,
    however late the background write runs."""
    gate = __import__("threading").Event()
    write = torbax.write_checkpoint

    def late_write(*a):
        gate.wait(10)
        write(*a)

    monkeypatch.setattr(torbax, "write_checkpoint", late_write)
    w = torch.arange(6, dtype=torch.float32)
    m = np.arange(3, dtype=np.float32)
    p = str(tmp_path / "ck.orbax")
    tck.save_pytree_orbax(p, {"w": w, "view": torch.from_numpy(m), "m": m})
    w.add_(100.0)
    m += 100.0
    gate.set()
    tck.wait_for_checkpoints()
    got = tck.restore_pytree(p)
    np.testing.assert_array_equal(got["w"], np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(got["view"], np.arange(3, dtype=np.float32))
    np.testing.assert_array_equal(got["m"], np.arange(3, dtype=np.float32))


def test_two_phase_never_leaves_zero_checkpoints(tmp_path, monkeypatch):
    """The counterpart of tests/test_orbax_ckpt.py's two-phase test: the
    live directory survives the whole async write of its successor, and a
    durable unpromoted '.new' is read (read-only) and promoted by the next
    save."""
    p = str(tmp_path / "ck.orbax")
    _port_save(p, {"a": np.arange(4)})
    assert os.path.isdir(p)
    np.testing.assert_array_equal(tck.restore_pytree(p)["a"], np.arange(4))

    seen = []
    write = torbax.write_checkpoint

    def watched_write(*a):
        seen.append(os.path.isdir(p))
        write(*a)
        seen.append(os.path.isdir(p))

    monkeypatch.setattr(torbax, "write_checkpoint", watched_write)
    tck.save_pytree_orbax(p, {"a": np.arange(4) + 1})
    assert os.path.isdir(p), "live checkpoint deleted while the new one is written"
    tck.wait_for_checkpoints()
    assert seen == [True, True]
    np.testing.assert_array_equal(tck.restore_pytree(p)["a"], np.arange(4) + 1)
    assert not os.path.isdir(p + ".new")

    # a crash between the commit and the promotion: the pending set is lost
    tck.save_pytree_orbax(p, {"a": np.arange(4) + 2})
    tck._wait_inflight()
    tck._PENDING_PROMOTE.clear()
    assert os.path.isdir(p + ".new") and os.path.isdir(p)
    np.testing.assert_array_equal(tck.restore_pytree(p)["a"], np.arange(4) + 2)
    assert os.path.isdir(p + ".new"), "restore must not change the disk"
    tck.save_pytree_orbax(p, {"a": np.arange(4) + 3})
    tck.wait_for_checkpoints()
    np.testing.assert_array_equal(tck.restore_pytree(p)["a"], np.arange(4) + 3)
    np.testing.assert_array_equal(jck.restore_pytree(p, None)["a"], np.arange(4) + 3)
    assert not os.path.isdir(p + ".new")


def test_a_background_write_failure_surfaces_at_the_next_wait(tmp_path, monkeypatch):
    def failing_write(root, items):
        raise OSError("disk full")

    monkeypatch.setattr(ocdbt, "write_store", failing_write)
    p = str(tmp_path / "ck.orbax")
    tck.save_pytree_orbax(p, {"a": np.arange(3)})  # returns: the write is in the background
    with pytest.raises(OSError, match="disk full"):
        tck.wait_for_checkpoints()
    tck.save_pytree_orbax(p, {"a": np.arange(3)})
    with pytest.raises(OSError, match="disk full"):  # at the next save too
        tck.save_pytree_orbax(p, {"a": np.arange(3)})
    tck.wait_for_checkpoints()  # that save raised before it wrote: nothing pending
    assert os.listdir(tmp_path) == []  # no checkpoint, no temporary directory left


def test_zstd_codec_and_a_missing_library(monkeypatch):
    data = np.random.default_rng(0).standard_normal(4096).astype(np.float32).tobytes()
    frame = zstd.compress(data, 1)
    assert zstd.decompress(frame) == data
    out = np.empty(4096, np.float32)
    zstd.decompress_into(frame, out)
    assert out.tobytes() == data
    # tensorstore's streamed frames record no content size: the streaming decoder
    streamed = bytes.fromhex("28b52ffd0000110000") + b"\x01\x00"
    assert zstd.decompress(streamed) == b"\x01\x00"
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(b"not a zstd frame")
    assert ocdbt.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    monkeypatch.setattr(zstd, "_LIB", None)
    monkeypatch.setenv("DEVIT_LIBZSTD", "libzstd-missing.so.9")
    with pytest.raises(RuntimeError, match="libzstd-missing.so.9"):
        zstd.compress(b"x")


# ------------------------------------------------------------ the CLI


def test_cli_orbax_train_resume_convert_inspect(tmp_path, capsys):
    """`train_sub --ckpt-format orbax` writes checkpoint directories the JAX
    package reads, `--resume` continues from one, `convert` goes orbax ->
    msgpack -> orbax with the same leaves, and `inspect` reports the orbax
    directory as it reports the msgpack file."""
    from devit_tpu_torch.cli.__main__ import main

    torch.set_num_threads(2)
    base = ["train_sub", "--device", "cpu", "--input-size", "32", "--patch-size", "8",
            "--embed-dim", "32", "--depth", "2", "--num-heads", "2", "--drop-path", "0.0",
            "--batch-size", "32", "--eval-batch-size", "64", "--warmup-epochs", "0",
            "--cooldown-epochs", "0", "--lr", "1e-3", "--dataset", "synthetic:4:64:32",
            "--num_division", "1", "--no-repeated-aug", "--aa", "", "--start-division", "0",
            "--ckpt-format", "orbax"]
    out = str(tmp_path / "run")
    main([*base, "--epochs", "1", "--output_dir", out])
    ck = os.path.join(out, "checkpoint_temp.orbax")
    assert os.path.isdir(ck) and not os.path.exists(ck + ".new"), os.listdir(out)
    assert os.path.isdir(os.path.join(out, "checkpoint.orbax"))
    assert int(tck.restore_pytree(os.path.join(out, "checkpoint_temp.msgpack"))["epoch"]) == 0
    assert int(jck.restore_pytree(ck, None)["epoch"]) == 0

    main([*base, "--epochs", "2", "--output_dir", out, "--resume", ck])
    tree = tck.restore_pytree(ck)
    assert int(tree["epoch"]) == 1  # resumed, ran epoch 1
    _assert_same_leaves(jck.restore_pytree(ck, None), tree)

    mp, ob = str(tmp_path / "c.msgpack"), str(tmp_path / "c.orbax")
    main(["convert", ck, mp, "--device", "cpu"])
    main(["convert", mp, ob, "--device", "cpu"])
    assert not os.path.exists(ob + ".new")
    _assert_same_leaves(tck.restore_pytree(mp), tree)
    _assert_same_leaves(tck.restore_pytree(ob), tree)

    capsys.readouterr()
    main(["inspect", "--json", ck, mp, "--device", "cpu"])
    got_ob, got_mp = json.loads(capsys.readouterr().out)
    assert got_ob["format"] == "orbax" and got_mp["format"] == "msgpack"
    for k in ("kind", "geometry", "epoch", "param_count", "has_ema", "has_opt_state"):
        assert got_ob.get(k) == got_mp.get(k), k


def test_pipeline_skips_and_resumes_on_orbax_artifacts(tmp_path, monkeypatch):
    """The pipeline's done and resume checks take the '.orbax' sibling of
    each '.msgpack' artifact, and the ensemble stage's sub-model path
    resolves to an orbax checkpoint through its '.msgpack' name."""
    from devit_tpu_torch.cli import stages as St
    from devit_tpu_torch.cli.__main__ import main

    root = str(tmp_path / "pipe")
    resumes = []

    def fake_train_sub(args):
        resumes.append(args.resume)
        _port_save(os.path.join(args.output_dir, "checkpoint.orbax"), {"epoch": np.int32(0)})
        return 50.0

    monkeypatch.setattr(St, "train_sub_main", fake_train_sub)
    _port_save(os.path.join(root, "sub-model0", "checkpoint_temp.orbax"), {"epoch": np.int32(0)})
    argv = ["pipeline", "--model", "dedeit", "--dataset", "synthetic:8:256:32",
            "--num_division", "2", "--stages", "split,train_sub", "--output_dir", root,
            "--ckpt-format", "orbax", "--device", "cpu"]
    main(argv)
    assert resumes == [os.path.join(root, "sub-model0", "checkpoint_temp.orbax"), ""]
    main(argv)  # both divisions' checkpoint.orbax mark train_sub done
    assert len(resumes) == 2
    _port_save(os.path.join(root, "sub-dataset0", "checkpoint.orbax"), {"epoch": np.int32(3)})
    p = St._division_checkpoint(root, 0)
    assert p.endswith("checkpoint.msgpack") and int(tck.restore_pytree(p)["epoch"]) == 3


def test_cli_orbax_under_two_ranks(tmp_path):
    """Under two ranks (gloo) rank 0 writes each epoch's orbax checkpoint
    (the second over the first, promoted) and rank 1 none; both ranks
    pass the stage's closing barrier."""
    from devit_tpu_torch.parallel.launch import run_ranks

    worker = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    base = ["train_sub", "--input-size", "32", "--patch-size", "8", "--embed-dim", "32",
            "--depth", "1", "--num-heads", "2", "--batch-size", "16", "--eval-batch-size", "32",
            "--warmup-epochs", "0", "--cooldown-epochs", "0", "--dataset", "synthetic:4:64:32",
            "--num_division", "1", "--no-repeated-aug", "--aa", "", "--ckpt-format", "orbax",
            "--output_dir", str(tmp_path)]
    run_ranks(f"{worker}:cli", 2, args=(base + ["--epochs", "2"],), timeout=300)
    ck = str(tmp_path / "checkpoint_temp.orbax")
    assert int(tck.restore_pytree(ck)["epoch"]) == 1 and not os.path.exists(ck + ".new")
    assert int(jck.restore_pytree(ck, None)["epoch"]) == 1


# ------------------------------------------------------------ the JAX-written fixture


def build_jax_fixture(dst: str) -> None:
    """The fixture, written by the JAX package: a gated dedeit stage-2 tree
    at FIXTURE_GEOMETRY ({params, ema_params None, opt_state, gates, epoch},
    the stage-2 tree with shrink gates, as distill writes it): flax's init
    at key 0, a fresh AdamW state, gates from numpy seed 0; and
    expected.npz: 4 images from numpy seed 1 and the JAX package's f32
    logits of the gated forward on them."""
    cfg = jax_cfg("dedeit", **FIXTURE_GEOMETRY)
    jm = jvit.VisionTransformer(cfg, dtype=jnp.float32)
    s = cfg.img_size
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, s, s, 3)))["params"]
    opt_state = jax.jit(joptim.make_optimizer(joptim.OptimConfig(**OPT), 10).init)(params)
    rng = np.random.default_rng(0)
    head = np.ones((cfg.depth, cfg.num_heads), np.float32)
    head[0, 1] = 0.0
    neuron = (rng.uniform(size=(cfg.depth, cfg.hidden_dim)) < 0.6).astype(np.float32)
    images = np.random.default_rng(1).standard_normal((4, s, s, 3)).astype(np.float32)
    logits = jax.jit(lambda p, x: jm.apply({"params": p}, x, jvit.Gates(
        jnp.asarray(head), jnp.asarray(neuron))).logits)(params, images)
    os.makedirs(dst, exist_ok=True)
    ck = os.path.join(dst, "checkpoint.orbax")
    shutil.rmtree(ck, ignore_errors=True)
    _jax_save(ck, {"params": params, "ema_params": None, "opt_state": opt_state,
                   "gates": {"head": head, "neuron": neuron}, "epoch": np.int32(0)})
    np.savez(os.path.join(dst, "expected.npz"), images=images, logits=np.asarray(logits))


def port_fixture_logits(fixture: str, device: str = "cpu") -> torch.Tensor:
    """The port's f32 forward of the fixture's gated model on its images."""
    tree = tck.restore_pytree(os.path.join(fixture, "checkpoint.orbax"))
    model = vit_from_jax_params(tree["params"], get_vit_config("dedeit", **FIXTURE_GEOMETRY),
                                device=device, dtype=torch.float32).eval()
    images = np.load(os.path.join(fixture, "expected.npz"))["images"]
    gates = Gates(*(torch.as_tensor(np.asarray(tree["gates"][k]), device=device)
                    for k in ("head", "neuron")))
    with torch.no_grad():
        return model(torch.from_numpy(images).to(device), gates).logits


def test_the_committed_jax_fixture(tmp_path):
    """The committed fixture is what build_jax_fixture writes today (tree and
    logits; floats within 1e-6, f32 init and forward on this host's XLA),
    under 1 MB, and the port's f32 forward on it gives the JAX logits within
    the f32 forward tolerance (1e-4 of max |logit|)."""
    build_jax_fixture(str(tmp_path))
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size < 1 << 20, size
    got = _leaves(tck.restore_pytree(os.path.join(FIXTURE, "checkpoint.orbax")))
    want = _leaves(jck.restore_pytree(str(tmp_path / "checkpoint.orbax"), None))
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None or got[k] is None:
            assert got[k] is want[k], k
            continue
        assert got[k][:2] == want[k][:2], k
        a, b = (np.frombuffer(v[2], np.dtype(v[0])) for v in (got[k], want[k]))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=str(k))
    exp, new = np.load(os.path.join(FIXTURE, "expected.npz")), np.load(tmp_path / "expected.npz")
    np.testing.assert_array_equal(exp["images"], new["images"])
    np.testing.assert_allclose(exp["logits"], new["logits"], rtol=0, atol=1e-5)
    logits = port_fixture_logits(FIXTURE).numpy()
    err = np.abs(logits - exp["logits"]).max() / np.abs(exp["logits"]).max()
    assert err <= 1e-4, err


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "float32")
    build_jax_fixture(FIXTURE)
    print(f"wrote {FIXTURE}")
