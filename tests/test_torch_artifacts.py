"""The port's deployment artifacts vs the JAX package: the hand-written
msgpack codec (devit_tpu_torch/io/msgpack.py) against msgpack and flax,
save_pytree / restore_pytree, save_compact / load_compact in both
directions, build_engine_from_artifacts on a JAX-written deploy directory and
fusion checkpoint, and POST /reload (mirroring
tests/test_serving_daemon.py:60-150 and :300-360).

Tolerances: the codec and the artifacts are exact (equal bytes, equal
arrays). The port's forward of a JAX-written artifact against JAX's forward
of the same file, and the engine against JAX's offline fused forward (the
port scales images by 1/255 once; the JAX daemon twice, ROADMAP Queue 3), at
f32 with strict numerics: rtol and atol 2e-5 (toy), max-abs/max-ref <= 1e-3
(full width)."""

import json
import os
import threading
import urllib.error
import urllib.request

import flax
import jax
import jax.numpy as jnp
import msgpack as mp
import numpy as np
import optax
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.data.pipeline import normalize as jnormalize
from devit_tpu.io import checkpoint as jck
from devit_tpu.models import compact_vit as jcv
from devit_tpu.models.ensemble import EnsMLP as JEnsMLP
from devit_tpu.models.vit import Gates as JGates
from devit_tpu.models.vit import VisionTransformer
from devit_tpu_torch import deploy
from devit_tpu_torch.io import checkpoint as tck
from devit_tpu_torch.io import msgpack as tmp
from devit_tpu_torch.models.compact_vit import (compact_forward, load_compact, quantize_compact,
                                                save_compact)
from devit_tpu_torch.serving.daemon import ServeConfig, build_engine_from_artifacts, build_server

IMG, D, K = 32, 3, 9
CFG = jax_cfg("dedeit", img_size=IMG, patch_size=8, embed_dim=64, depth=2, num_heads=4,
              num_classes=K)
SCFG = ServeConfig(input_size=IMG, patch_size=8, buckets=(2, 4, 8), max_wait_ms=5.0,
                   dtype=torch.float32, fast_math=False)


def _flax_packb(obj):
    return mp.packb(obj, default=flax.serialization._msgpack_ext_pack, strict_types=True)


def _imgs(n, size=IMG, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


# ---------------------------------------------------------------- the codec

_SCALARS = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
            2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
            0.0, -2.5, 1e300, "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
            b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000]


@pytest.mark.parametrize("obj", _SCALARS, ids=range(len(_SCALARS)))
def test_codec_matches_msgpack_on_every_scalar_format(obj):
    packed = mp.packb(obj, use_bin_type=True)
    assert tmp.packb(obj) == packed
    assert tmp.unpackb(packed) == obj


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_codec_arrays_and_maps_of_every_length(n):
    arr, dct = list(range(n)), {str(i): i for i in range(n)}
    for obj in (arr, dct):
        packed = mp.packb(obj, use_bin_type=True)
        assert tmp.packb(obj) == packed and tmp.unpackb(packed) == obj


def test_codec_reads_float32_and_ext_formats():
    assert tmp.unpackb(mp.packb(1.5, use_single_float=True)) == 1.5  # 0xca
    for n in (1, 2, 4, 8, 16, 3, 255, 256, 70000):  # fixext and ext 8/16/32
        ext = mp.ExtType(42, bytes(range(256)) * (n // 256) + bytes(range(n % 256)))
        packed = mp.packb(ext)
        assert tmp.unpackb(packed) == tmp.ExtType(42, ext.data)
        assert tmp.packb(tmp.ExtType(42, ext.data)) == packed


def test_codec_writes_what_flax_writes():
    """flax.serialization.to_bytes vs the port's to_bytes, byte for byte:
    arrays of every dtype the repo writes, numpy scalars, nested dicts,
    tuples and lists (both become {"0": ..} maps), named tuples (maps of
    their fields, as an optax state), None and Python leaves."""
    tree = {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
            "f64": np.ones((2,)), "i32": np.array([-1, 2**30], np.int32),
            "i8": np.array([-127, 0, 127], np.int8), "u8": np.zeros((2, 2, 3), np.uint8),
            "bool": np.array([True, False]), "empty": np.zeros((0, 5), np.float32),
            "meta": {"n": np.int32(7), "eps": np.float32(1e-6), "flag": np.bool_(True)},
            "seq": [1, -70000, 2.5, "x", None, (3, b"raw")], "tup": (np.int64(-3),),
            "state": optax.ScaleByAdamState(count=np.int32(2), mu={"w": np.ones(2, np.float32)},
                                            nu=None)}
    want = flax.serialization.to_bytes(tree)
    assert tmp.to_bytes(tree) == want
    back = tmp.restore(want)
    assert back["seq"]["5"] == {"0": 3, "1": b"raw"} and back["tup"]["0"] == -3
    assert set(back["state"]) == {"count", "mu", "nu"} and back["state"]["nu"] is None
    np.testing.assert_array_equal(back["f32"], tree["f32"])
    assert back["meta"]["eps"] == np.float32(1e-6) and back["meta"]["eps"].dtype == np.float32
    assert back["f32"].flags.writeable and back["empty"].shape == (0, 5)


def test_bfloat16_round_trips_through_torch():
    vals = np.array([[1.0, -2.5, 3.140625], [0.0, 1e-3, -65504.0]], np.float32)
    jarr = jnp.asarray(vals, jnp.bfloat16)
    got = tmp.restore(flax.serialization.to_bytes({"w": jarr, "s": jarr[0, 1]}))
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (2, 3)
    np.testing.assert_array_equal(got["w"].float().numpy(), np.asarray(jarr, np.float32))
    assert got["s"].shape == () and float(got["s"]) == -2.5
    # the port writes a bf16 tensor as flax writes a bf16 array
    tensor = torch.tensor(vals).bfloat16()
    assert tmp.to_bytes({"w": tensor}) == flax.serialization.to_bytes({"w": jarr})
    back = flax.serialization.msgpack_restore(tmp.to_bytes({"w": tensor}))["w"]
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back, np.float32), tensor.float().numpy())


def test_chunked_arrays_both_ways(monkeypatch):
    """flax chunks arrays above MAX_CHUNK_SIZE bytes (2^30); shrunk here to
    64 bytes in both packages."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tmp, "MAX_CHUNK_SIZE", 64)
    big = np.arange(100, dtype=np.float32).reshape(4, 25)
    small = np.arange(3, dtype=np.float32)
    jbf = jnp.asarray(np.linspace(-3, 3, 40), jnp.bfloat16)
    tree = {"big": big, "nested": {"big": big + 1, "small": small}}
    raw = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in raw
    assert tmp.to_bytes(tree) == raw
    back = tmp.restore(raw)
    np.testing.assert_array_equal(back["big"], big)
    np.testing.assert_array_equal(back["nested"]["big"], big + 1)
    np.testing.assert_array_equal(back["nested"]["small"], small)
    got = tmp.restore(flax.serialization.to_bytes({"bf": jbf}))["bf"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jbf, np.float32))
    restored = flax.serialization.msgpack_restore(tmp.to_bytes(tree))
    np.testing.assert_array_equal(np.asarray(restored["nested"]["big"]), big + 1)


def test_codec_raises_value_error_on_bad_data():
    cplx = _flax_packb({"z": 1 + 2j})
    with pytest.raises(ValueError, match="complex"):
        tmp.restore(cplx)
    for bad in (b"not msgpack \x00\xff garbage", b"\xc1", mp.packb([1, 2, 3])[:-1],
                mp.packb("abc")[:-1], b"\x92\x01", b""):
        with pytest.raises(ValueError):
            tmp.unpackb(bad)
    with pytest.raises(TypeError):
        tmp.packb({"x": object()})


def test_save_restore_pytree_both_ways(tmp_path):
    tree = {"a": {"b": np.arange(6, dtype=np.float32)}, "epoch": np.int32(3)}
    p1, p2 = str(tmp_path / "jax.msgpack"), str(tmp_path / "sub" / "port.msgpack")
    jck.save_pytree(p1, tree)
    tck.save_pytree(p2, tree)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    got = tck.restore_pytree(p1)
    np.testing.assert_array_equal(got["a"]["b"], tree["a"]["b"])
    assert int(jck.restore_pytree(p2, None)["epoch"]) == 3
    assert not [f for f in os.listdir(tmp_path / "sub") if ".tmp." in f]


def test_restore_pytree_refuses_orbax_directories(tmp_path):
    """restore_pytree reads an orbax checkpoint directory (by its name and
    by its '.msgpack' sibling's) and refuses a directory that holds none;
    a missing file is still a FileNotFoundError."""
    tree = {"a": {"b": np.arange(6, dtype=np.float32)}, "epoch": np.int32(3)}
    tck.save_pytree_orbax(str(tmp_path / "real.orbax"), tree)
    tck.wait_for_checkpoints()
    for path in (tmp_path / "real.orbax", tmp_path / "real.msgpack"):
        got = tck.restore_pytree(str(path))
        np.testing.assert_array_equal(got["a"]["b"], tree["a"]["b"])
        assert int(got["epoch"]) == 3
    (tmp_path / "ckpt.orbax").mkdir()
    (tmp_path / "dir").mkdir()
    for path in (tmp_path / "ckpt.msgpack", tmp_path / "dir"):
        with pytest.raises(ValueError, match="orbax"):
            tck.restore_pytree(str(path))
    with pytest.raises(FileNotFoundError):
        tck.restore_pytree(str(tmp_path / "missing.msgpack"))


# ---------------------------------------------------------------- compact artifacts


def _toy_divisions():
    model = VisionTransformer(CFG, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    cms = []
    for d in range(D):
        params = model.init(jax.random.key(d), jnp.zeros((2, IMG, IMG, 3)))["params"]
        head = np.zeros((2, 4), np.float32)
        neuron = np.zeros((2, 256), np.float32)
        for l, (hk, nk) in enumerate([(2, 64), (3, 128)]):
            head[l, rng.choice(4, hk, replace=False)] = 1
            neuron[l, rng.choice(256, nk, replace=False)] = 1
        cms.append(jcv.compact_vit_ragged(params, JGates(jnp.asarray(head), jnp.asarray(neuron)),
                                          CFG, neuron_multiple=8))
    return cms


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A JAX deploy directory (sub-dataset{i}/compact.msgpack) and a stage-5
    fusion checkpoint with its optimizer state, as cli/stages.py writes."""
    root = tmp_path_factory.mktemp("deploy")
    cms = _toy_divisions()
    for i, cm in enumerate(cms):
        jcv.save_compact(os.path.join(root, f"sub-dataset{i}", "compact.msgpack"), cm)
    ens = JEnsMLP(num_classes=K, sub_size=CFG.embed_dim, num_divisions=D, teacher_size=48,
                  family="deit", dtype=jnp.float32)
    tok = jnp.zeros((D, 2, CFG.embed_dim))
    ens_vars = ens.init(jax.random.key(99), tok, tok)
    ens_path = os.path.join(root, "ens.msgpack")
    opt = optax.adamw(1e-3).init(ens_vars["params"])
    jck.save_pytree(ens_path, {"ens_params": ens_vars["params"], "ens_opt_state": opt,
                               "epoch": np.int32(4)})
    return str(root), ens_path, cms, ens, ens_vars


def _jax_forward(cm, imgs):
    return np.asarray(jcv.compact_forward(cm, jnp.asarray(imgs), patch_size=8,
                                          dtype=jnp.float32, use_pallas=False, fast_math=False))


def test_jax_written_compact_runs_in_the_port(artifacts):
    root, _, cms, _, _ = artifacts
    imgs = np.random.default_rng(1).normal(size=(2, IMG, IMG, 3)).astype(np.float32)
    path = os.path.join(root, "sub-dataset1", "compact.msgpack")
    jcm = jcv.load_compact(path)
    tcm = load_compact(path, device="cpu")
    assert tcm.num_heads == [lp["num_heads"] for lp in cms[1].layers]
    assert tcm.distilled and tcm.head_dim == 16
    with torch.inference_mode():
        got = compact_forward(tcm, torch.tensor(imgs), patch_size=8, dtype=torch.float32,
                              fast_math=False).numpy()
    np.testing.assert_allclose(got, _jax_forward(jcm, imgs), rtol=2e-5, atol=2e-5)


def test_port_written_compact_reads_in_jax(artifacts, tmp_path):
    """load_compact then save_compact in the port writes the JAX file back
    byte for byte; JAX's load_compact gives equal arrays and meta."""
    root, _, cms, _, _ = artifacts
    src = os.path.join(root, "sub-dataset0", "compact.msgpack")
    out = str(tmp_path / "port" / "compact.msgpack")
    save_compact(out, load_compact(src, device="cpu"))
    assert open(out, "rb").read() == open(src, "rb").read()
    a, b = jcv.load_compact(out), cms[0]
    assert (a.head_dim, a.distilled, a.eps) == (b.head_dim, b.distilled, np.float32(b.eps))
    flat_a, flat_b = (jax.tree_util.tree_leaves_with_path((m.embed, m.layers, m.head))
                      for m in (a, b))
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(ValueError, match="quantize"):
        save_compact(str(tmp_path / "q.msgpack"), quantize_compact(load_compact(src, "cpu")))


def test_full_width_division_written_by_jax_runs_in_the_port(tmp_path):
    """Division 0 of the deployed ensemble: JAX save_compact -> the port's
    load_compact and forward, B 1, against JAX's forward of its own file."""
    cfg, params_list, gates_list = deploy.build_inputs(1)
    g = gates_list[0]
    jcm = jcv.compact_vit_ragged(params_list[0], JGates(jnp.asarray(g.head),
                                                        jnp.asarray(g.neuron)),
                                 jax_cfg("dedeit", num_classes=25))
    path = str(tmp_path / "compact.msgpack")
    jcv.save_compact(path, jcm)
    imgs = np.random.default_rng(2).normal(size=(1, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jcv.compact_forward(jcv.load_compact(path), jnp.asarray(imgs),
                                          patch_size=16, dtype=jnp.float32, use_pallas=False,
                                          fast_math=False))
    with torch.inference_mode():
        got = compact_forward(load_compact(path, device="cpu"), torch.tensor(imgs),
                              patch_size=16, dtype=torch.float32, fast_math=False).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-3


# ---------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def engine(artifacts):
    root, ens_path, *_ = artifacts
    return build_engine_from_artifacts(root, ens_path, cfg=SCFG, log=None, device="cpu")


def _jax_logits(artifacts, imgs, ens_vars=None):
    _, _, cms, ens, vars0 = artifacts
    x = jnormalize(jnp.asarray(imgs), jnp.float32)  # uint8 scaled by 1/255 once
    cls_s, dist_s = jcv.stack_division_features(cms, x, patch_size=8, dtype=jnp.float32,
                                                use_pallas=False, fast_math=False)
    return np.asarray(ens.apply(ens_vars or vars0, cls_s, dist_s).logits)


def test_engine_from_jax_artifacts_matches_jax(artifacts, engine):
    assert (engine.num_divisions, engine.num_classes) == (D, K)
    assert engine.ens.teacher_size == 48 and engine.ens.family == "deit"
    imgs = _imgs(5, seed=3)
    np.testing.assert_allclose(engine.predict(imgs), _jax_logits(artifacts, imgs),
                               rtol=2e-5, atol=2e-5)


def test_engine_pairing_family_and_discovery_errors(artifacts, tmp_path):
    root, *_ = artifacts
    tok = jnp.zeros((D + 1, 2, CFG.embed_dim))
    bad = JEnsMLP(num_classes=K, sub_size=CFG.embed_dim, num_divisions=D + 1, teacher_size=48,
                  family="deit", dtype=jnp.float32)
    p = str(tmp_path / "bad.msgpack")
    jck.save_pytree(p, {"ens_params": bad.init(jax.random.key(0), tok, tok)["params"]})
    with pytest.raises(ValueError, match="pairing"):
        build_engine_from_artifacts(root, p, cfg=SCFG, log=None, device="cpu")
    vit = JEnsMLP(num_classes=K, sub_size=CFG.embed_dim, num_divisions=D, teacher_size=None,
                  family="vit", dtype=jnp.float32)
    tok = jnp.zeros((D, 2, CFG.embed_dim))
    p = str(tmp_path / "vit.msgpack")
    jck.save_pytree(p, {"params": vit.init(jax.random.key(0), tok, None)["params"]})
    with pytest.raises(ValueError, match="'vit' but compact backbones are 'deit'"):
        build_engine_from_artifacts(root, p, cfg=SCFG, log=None, device="cpu")
    with pytest.raises(FileNotFoundError, match="sub-dataset0"):
        build_engine_from_artifacts(str(tmp_path), None, cfg=SCFG, log=None, device="cpu")


def test_engine_smoke_mode_without_fusion_checkpoint(artifacts):
    root, *_ = artifacts
    logs = []
    e = build_engine_from_artifacts(root, None, num_divisions=2, cfg=SCFG, log=logs.append,
                                    device="cpu")
    assert "RANDOM fusion head" in logs[0] and "2 divisions" in logs[1]
    assert (e.num_divisions, e.num_classes, e.ens.teacher_size) == (2, K, 768)
    assert np.isfinite(e.predict(_imgs(1))).all()


# ---------------------------------------------------------------- POST /reload


@pytest.fixture(scope="module")
def server(engine):
    httpd, batcher = build_server(engine, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield "http://%s:%d" % httpd.server_address[:2]
    httpd.shutdown()
    httpd.server_close()
    batcher.stop()
    t.join(timeout=10)


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _predict(server, imgs):
    code, out = _post(server + "/predict", imgs.tobytes(),
                      {"X-Image-Shape": ",".join(map(str, imgs.shape))})
    assert code == 200
    return out["predictions"]


def _reload(server, path):
    return _post(server + "/reload", json.dumps({"ens_path": path}).encode())


def test_reload_hot_swaps_the_fusion_head(artifacts, engine, server, tmp_path):
    """tests/test_serving_daemon.py:300-360 on the port's engine."""
    root, ens_path, _, ens, _ = artifacts
    imgs = _imgs(2, seed=11)
    before = _predict(server, imgs)
    tok = jnp.zeros((D, 2, CFG.embed_dim))
    alt = ens.init(jax.random.key(7), tok, tok)
    alt_path = str(tmp_path / "alt.msgpack")
    jck.save_pytree(alt_path, {"ens_params": alt["params"]})
    code, out = _reload(server, alt_path)
    assert code == 200 and out == {"status": "reloaded", "ens_path": alt_path}
    after = _predict(server, imgs)
    assert any(b["probs"] != a["probs"] for b, a in zip(before, after))
    np.testing.assert_allclose(engine.predict(imgs), _jax_logits(artifacts, imgs, alt),
                               rtol=2e-5, atol=2e-5)
    # wrong geometry -> 400, serving state unchanged
    bad = JEnsMLP(num_classes=K + 1, sub_size=CFG.embed_dim, num_divisions=D, teacher_size=48,
                  family="deit", dtype=jnp.float32)
    bad_path = str(tmp_path / "badgeom.msgpack")
    jck.save_pytree(bad_path, {"ens_params": bad.init(jax.random.key(0), tok, tok)["params"]})
    code, out = _reload(server, bad_path)
    assert code == 400 and "geometry" in out["error"]
    # same shapes, another dtype -> 400
    bf_path = str(tmp_path / "bf16.msgpack")
    jck.save_pytree(bf_path, {"ens_params": jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), alt["params"])})
    code, out = _reload(server, bf_path)
    assert code == 400 and "geometry" in out["error"]
    assert _reload(server, str(tmp_path / "missing.msgpack"))[0] == 400
    notdict = str(tmp_path / "notdict.msgpack")
    with open(notdict, "wb") as f:
        f.write(mp.packb([1, 2, 3]))
    code, out = _reload(server, notdict)
    assert code == 400 and "not a checkpoint dict" in out["error"]
    corrupt = str(tmp_path / "corrupt.msgpack")
    with open(corrupt, "wb") as f:
        f.write(b"not msgpack \x00\xff garbage")
    assert _reload(server, corrupt)[0] == 400
    # an orbax checkpoint of the same head (by its '.msgpack' name) -> 200;
    # an empty '.orbax' directory -> 400
    tck.save_pytree_orbax(str(tmp_path / "alt_ob.orbax"),
                          {"ens_params": jax.device_get(alt["params"])})
    tck.wait_for_checkpoints()
    code, out = _reload(server, str(tmp_path / "alt_ob.msgpack"))
    assert code == 200 and out["status"] == "reloaded"
    (tmp_path / "ck.orbax").mkdir()
    code, out = _reload(server, str(tmp_path / "ck.msgpack"))
    assert code == 400 and "orbax" in out["error"]
    for raw in (b"[1,2]", b"\"x\"", b"{\"ens_path\": 5}", b"{nope"):
        assert _post(server + "/reload", raw)[0] == 400
    assert after == _predict(server, imgs)  # none of the refusals changed the head
    # restore the module-scoped server's original head
    assert _reload(server, ens_path)[0] == 200
    assert _predict(server, imgs) == before
