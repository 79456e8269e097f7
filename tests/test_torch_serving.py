"""The port's serving path (devit_tpu_torch/serving/daemon.py and
devit_tpu_torch/deploy.py) vs the JAX package.

The full-width case holds the port's four deployed divisions + EnsMLP
against bench.build_artifacts()'s JAX forward at f32 (rel <= 1e-3). The toy
cases pin the engine (bucket padding, chunking), the micro-batcher and the
HTTP wire protocol. The port's engine scales images by 1/255 once, as the
offline eval path does, so its reference is JAX stack_division_features +
EnsMLP.apply on normalize(uint8), not the JAX daemon (which scales twice)."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.data.pipeline import normalize as jnormalize
from devit_tpu.models import compact_vit as jcv
from devit_tpu.models.ensemble import EnsMLP as JEnsMLP
from devit_tpu.models.vit import Gates as JGates
from devit_tpu.models.vit import VisionTransformer
from devit_tpu_torch import deploy
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.data.pipeline import normalize
from devit_tpu_torch.io.bridge import compact_from_jax_params, ensmlp_from_jax_params
from devit_tpu_torch.models.compact_vit import compact_forward, stack_division_features
from devit_tpu_torch.parallel import serve as collab
from devit_tpu_torch.serving.daemon import (InferenceEngine, MicroBatcher, ServeConfig,
                                            build_server)

IMG, D, K = 32, 3, 9
TOY = dict(img_size=IMG, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=K)
SCFG = ServeConfig(input_size=IMG, patch_size=8, buckets=(2, 4, 8), max_wait_ms=5.0,
                   dtype=torch.float32, fast_math=False)
TOL = dict(rtol=1e-4, atol=1e-4)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _imgs(n, size=IMG, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def toy():
    """D toy divisions + a flax EnsMLP, in both packages (same weights)."""
    cfg = jax_cfg("dedeit", **TOY)
    model = VisionTransformer(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    jcms, tcms = [], []
    for d in range(D):
        params = model.init(jax.random.key(d), jnp.zeros((2, IMG, IMG, 3)))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        head = np.zeros((2, 4), np.float32)
        neuron = np.zeros((2, 256), np.float32)
        for l, (hk, nk) in enumerate([(2, 64), (3, 128)]):
            head[l, rng.choice(4, hk, replace=False)] = 1
            neuron[l, rng.choice(256, nk, replace=False)] = 1
        jcms.append(jcv.compact_vit_ragged(params, JGates(jnp.asarray(head), jnp.asarray(neuron)),
                                           cfg, neuron_multiple=8))
        tcms.append(compact_from_jax_params(params, (head, neuron), get_vit_config("dedeit", **TOY),
                                            neuron_multiple=8, device="cpu"))
    jens = JEnsMLP(num_classes=K, sub_size=64, num_divisions=D, teacher_size=48,
                   family="deit", dtype=jnp.float32)
    tok = jnp.zeros((D, 2, 64))
    ens_vars = jens.init(jax.random.key(99), tok, tok)
    tens = ensmlp_from_jax_params(jax.tree_util.tree_map(np.asarray, ens_vars["params"]),
                                  num_divisions=D, dtype=torch.float32, device="cpu")
    return jcms, jens, ens_vars, tcms, tens


@pytest.fixture(scope="module")
def engine(toy):
    *_, tcms, tens = toy
    return InferenceEngine(tcms, tens, SCFG, device="cpu")


def _jax_logits(toy, imgs):
    jcms, jens, ens_vars, _, _ = toy
    x = jnormalize(jnp.asarray(imgs), jnp.float32)  # uint8 scaled by 1/255 once
    cls_s, dist_s = jcv.stack_division_features(jcms, x, patch_size=8, dtype=jnp.float32,
                                                use_pallas=False, fast_math=False)
    return np.asarray(jens.apply(ens_vars, cls_s, dist_s).logits)


# ---------------------------------------------------------------- the engine


def test_normalize_matches_jax():
    imgs = _imgs(2, seed=3)
    got = normalize(torch.from_numpy(imgs), torch.float32).numpy()
    want = np.asarray(jnormalize(jnp.asarray(imgs), jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_normalize_equals_jax_bit_for_bit_on_every_uint8_value():
    """Every uint8 value in every channel: the division by 255 is the IEEE
    quotient, as JAX computes it (a product with the reciprocal is an ulp off
    for many values)."""
    imgs = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    got = normalize(torch.from_numpy(imgs), torch.float32).numpy()
    want = np.asarray(jnormalize(jnp.asarray(imgs), jnp.float32))
    assert np.array_equal(got, want)


def test_engine_matches_jax_offline_forward(toy, engine):
    imgs = _imgs(4, seed=1)
    got = engine.predict(imgs)
    assert got.dtype == np.float32 and got.shape == (4, K)
    np.testing.assert_allclose(got, _jax_logits(toy, imgs), **TOL)


def test_bucket_padding_and_chunking(engine, monkeypatch):
    # the engine's forward is the collaborative server's (parallel/serve.py)
    seen = []
    real = collab.stack_division_features

    def spy(cms, images, **kw):
        seen.append(images.shape[0])
        return real(cms, images, **kw)

    monkeypatch.setattr(collab, "stack_division_features", spy)
    imgs = _imgs(11, seed=2)
    full = engine.predict(imgs)  # 11 > 8: chunk 8, then 3 padded to bucket 4
    assert seen == [8, 4]
    seen.clear()
    one = engine.predict(imgs[5:6])  # 1 padded to bucket 2
    assert seen == [2]
    np.testing.assert_allclose(one[0], full[5], **TOL)
    np.testing.assert_allclose(engine.predict(imgs[8:11]), full[8:], **TOL)


def test_predict_rejects_wrong_shape_and_dtype(engine):
    with pytest.raises(ValueError, match="expects"):
        engine.predict(_imgs(2, size=IMG * 2))
    with pytest.raises(ValueError, match="uint8"):
        engine.predict(_imgs(2).astype(np.float32))


def test_serve_config_defaults_and_cuda_default():
    cfg = ServeConfig()
    assert cfg.buckets == (1, 8, 32, 128, 256)
    assert cfg.dtype == torch.bfloat16 and cfg.fast_math
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine([], None, cfg)  # default device is cuda, never cpu


# ------------------------------------------------------------ micro-batching


def test_batcher_coalesces_queued_requests(engine):
    b = MicroBatcher(engine)  # not started: both requests queue first
    f1 = b.submit(_imgs(2, seed=4))
    f2 = b.submit(_imgs(3, seed=5))
    b.start()
    r1, r2 = f1.result(timeout=60), f2.result(timeout=60)
    b.stop()
    assert r1.shape == (2, K) and r2.shape == (3, K)
    snap = b.snapshot()
    assert (snap["batches"], snap["coalesced"], snap["requests"], snap["images"]) == (1, 1, 2, 5)
    np.testing.assert_allclose(r2, engine.predict(_imgs(3, seed=5)), **TOL)


def test_batcher_drains_ready_queue_past_wait_window(engine):
    b = MicroBatcher(engine)
    f1 = b.submit(_imgs(1, seed=20))
    f2 = b.submit(_imgs(1, seed=21))
    time.sleep((SCFG.max_wait_ms + 20) / 1000.0)  # the window has expired
    b.start()
    f1.result(timeout=60), f2.result(timeout=60)
    b.stop()
    assert b.stats["batches"] == 1 and b.stats["coalesced"] == 1


def test_batcher_delivers_exceptions_and_stop_fails_queued(engine):
    b = MicroBatcher(engine).start()
    fut = b.submit(_imgs(1, size=IMG * 2))  # wrong shape: predict raises
    with pytest.raises(ValueError):
        fut.result(timeout=60)
    b.stop()
    assert not b._thread.is_alive()
    idle = MicroBatcher(engine)  # never started: the request stays queued
    fut = idle.submit(_imgs(1))
    idle.stop()
    with pytest.raises(RuntimeError, match="shutting down"):
        fut.result(timeout=5)


# ------------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def server(engine):
    httpd, batcher = build_server(engine, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    host, port = httpd.server_address[:2]
    yield f"http://{host}:{port}"
    httpd.shutdown()
    httpd.server_close()
    batcher.stop()
    t.join(timeout=10)


def _post(url, body, shape, path="/predict"):
    req = urllib.request.Request(url + path, data=body,
                                 headers={"X-Image-Shape": ",".join(map(str, shape))})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_predict_round_trip(server, engine):
    imgs = _imgs(3, seed=6)
    code, out = _post(server, imgs.tobytes(), imgs.shape)
    assert code == 200 and out["latency_ms"] > 0
    logits = engine.predict(imgs)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    for i, pred in enumerate(out["predictions"]):
        assert pred["topk"] == np.argsort(-logits[i])[:SCFG.topk].tolist()
        np.testing.assert_allclose(pred["probs"], p[i, pred["topk"]], atol=2e-6)
    code, out = _post(server + "", imgs[0].tobytes(), imgs[0].shape, "/predict?topk=2")
    assert code == 200 and len(out["predictions"]) == 1
    assert len(out["predictions"][0]["topk"]) == 2


def test_http_resizes_offsize_clients(server):
    imgs = _imgs(2, size=50, seed=7)
    code, out = _post(server, imgs.tobytes(), imgs.shape)
    assert code == 200 and len(out["predictions"]) == 2


def test_http_error_paths(server):
    imgs = _imgs(1)
    assert _post(server, imgs.tobytes()[:-7], imgs.shape)[0] == 400  # short body
    assert _post(server, b"xx", (2, 2))[0] == 400  # bad shape header
    # /reload takes a JSON body naming a fusion checkpoint: image bytes are a 400
    assert _post(server, imgs.tobytes(), imgs.shape, "/reload")[0] == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope", timeout=60)
    assert e.value.code == 404


def test_http_healthz_and_stats(server):
    imgs = _imgs(2, seed=8)
    assert _post(server, imgs.tobytes(), imgs.shape)[0] == 200
    with urllib.request.urlopen(server + "/healthz", timeout=60) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["device"] == "cpu"
    assert (h["num_divisions"], h["num_classes"], h["buckets"]) == (D, K, [2, 4, 8])
    with urllib.request.urlopen(server + "/stats", timeout=60) as r:
        s = json.loads(r.read())
    assert s["requests"] >= 1 and s["images"] >= 1 and s["latency_ms_p50"] >= 0


# ------------------------------------------------------ the deployed ensemble


def test_full_width_ensemble_matches_bench_artifacts():
    """bench.build_artifacts(): four full-width dedeit divisions + EnsMLP
    (teacher 768, 100 classes). The port builds the same divisions itself
    (deploy.build_artifacts) and takes the flax fusion head across the
    bridge; both run at f32 with strict numerics, B=2."""
    jcfg, jcms, jens, ens_vars = bench.build_artifacts()
    tcfg, tcms, _ = deploy.build_artifacts(device="cpu")
    assert [cm.num_heads for cm in tcms] == [[lp["num_heads"] for lp in cm.layers]
                                             for cm in jcms]
    tens = ensmlp_from_jax_params(jax.tree_util.tree_map(np.asarray, ens_vars["params"]),
                                  num_divisions=4, dtype=torch.float32, device="cpu")
    imgs = _imgs(2, size=224, seed=13)

    x = jnormalize(jnp.asarray(imgs), jnp.float32)
    cls_s, dist_s = jcv.stack_division_features(jcms, x, patch_size=16, dtype=jnp.float32,
                                                use_pallas=False, fast_math=False)
    jens32 = JEnsMLP(num_classes=100, sub_size=jcfg.embed_dim, num_divisions=4,
                     teacher_size=768, family="deit", dtype=jnp.float32)
    want = np.asarray(jens32.apply(ens_vars, cls_s, dist_s).logits)

    with torch.inference_mode():
        tx = normalize(torch.from_numpy(imgs), torch.float32)
        tcls, tdist = stack_division_features(tcms, tx, patch_size=16, dtype=torch.float32,
                                              use_kernel=True, fast_math=False)
        got = tens(tcls, tdist).logits.numpy()
        # per-division features agree too, not only the fused logits
        assert _rel(tcls.numpy(), np.asarray(cls_s)) <= 1e-3
        assert _rel(tdist.numpy(), np.asarray(dist_s)) <= 1e-3
    assert got.shape == (2, 100)
    assert _rel(got, want) <= 1e-3


def test_deployed_artifacts_geometry():
    """The port's deploy.build_artifacts at full width: 48 attention layers
    with kept heads 1..5 (two zero-kept layers as one dummy head each)."""
    cfg, cms, ens = deploy.build_artifacts(device="cpu")
    heads = [h for cm in cms for h in cm.num_heads]
    assert len(heads) == 48 and sum(heads) == 168 and min(heads) == 1 and max(heads) == 5
    assert (ens.num_classes, ens.teacher_size, ens.family, ens.sub_size) == (100, 768, "deit", 384)
    x = torch.zeros((1, 224, 224, 3))
    with torch.inference_mode():
        cls_f, dist_f = compact_forward(cms[0], x, patch_size=16, dtype=torch.bfloat16,
                                        features_only=True)
    assert cls_f.shape == dist_f.shape == (1, 384) and torch.isfinite(cls_f.float()).all()
