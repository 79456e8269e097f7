"""The port's collaborative server (devit_tpu_torch/parallel/serve.py)
against the JAX package's (devit_tpu/parallel/serve.py) and the port's
single-device engine, as tests/test_serve.py holds the JAX server: four
ragged compact divisions from the same numpy weights and gates, f32, plain
attention, on one CPU device; the lag-depth stream against per-batch
serving; and the placement bookkeeping over a list of cards (the placement
itself needs several cards, which a one-card machine cannot show).

Tolerance: logits 1e-5 (relative and absolute)."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.models import vit as jvit
from devit_tpu.models.compact_vit import compact_vit_ragged as jax_compact
from devit_tpu.models.ensemble import EnsMLP as JEnsMLP
from devit_tpu.parallel.serve import make_collaborative_server as jax_server
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.data.pipeline import normalize
from devit_tpu_torch.io.bridge import ensmlp_from_jax_params, vit_to_jax_params
from devit_tpu_torch.models.vit import VisionTransformer
from devit_tpu_torch.models.compact_vit import compact_vit_ragged
from devit_tpu_torch.parallel import serve as collab
from devit_tpu_torch.parallel.serve import make_collaborative_server, placement, serving_devices
from devit_tpu_torch.serving.daemon import InferenceEngine, ServeConfig, build_server

GEOM = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=9)
KW = dict(patch_size=8, dtype=torch.float32, use_kernel=False, fast_math=False)


@pytest.fixture(scope="module")
def built():
    """Four divisions (JAX weights, random ragged gates) in both packages,
    and an EnsMLP head."""
    rng = np.random.default_rng(0)
    jcms, tcms = [], []
    for d in range(4):
        # weights drawn by the port's initializers, as the JAX package's tree
        model = VisionTransformer(get_vit_config("dedeit", **GEOM), dtype=torch.float32)
        params = vit_to_jax_params(model.reset_parameters(torch.Generator().manual_seed(d)))
        head, neuron = np.zeros((2, 4), np.float32), np.zeros((2, 256), np.float32)
        for l, (hk, nk) in enumerate([(2, 64), (3, 128)]):
            head[l, rng.choice(4, hk, replace=False)] = 1
            neuron[l, rng.choice(256, nk, replace=False)] = 1
        jcms.append(jax_compact(params, jvit.Gates(jnp.asarray(head), jnp.asarray(neuron)),
                                jax_cfg("dedeit", **GEOM), neuron_multiple=8))
        tcms.append(compact_vit_ragged(params, jvit.Gates(head, neuron),
                                       get_vit_config("dedeit", **GEOM), neuron_multiple=8,
                                       device="cpu"))
    jens = JEnsMLP(num_classes=9, sub_size=64, num_divisions=4, teacher_size=32,
                   family="deit", dtype=jnp.float32)
    tok = jnp.zeros((4, 2, 64))
    ens_vars = jens.init(jax.random.key(99), tok, tok)
    ens = ensmlp_from_jax_params(jax.device_get(ens_vars["params"]), num_divisions=4,
                                 dtype=torch.float32, device="cpu")
    return jcms, tcms, jens, ens_vars, ens


def _server(built, **kw):
    _, tcms, _, _, ens = built
    ev = {k: v.detach() for k, v in ens.named_parameters()}
    serve = make_collaborative_server(tcms, lambda e, c, t: functional_call(ens, e, (c, t)), ev,
                                      devices=[torch.device("cpu")], **KW, **kw)
    return serve, ev


def test_collaborative_serve_matches_engine_and_jax(built):
    jcms, tcms, jens, ens_vars, ens = built
    serve, ev = _server(built)
    assert serve.division_devices == [torch.device("cpu")] * 4
    assert serve.fusion_device == torch.device("cpu")
    assert all(p.device.type == "cpu" for cm in serve.placed_divisions
               for p in cm.parameters())
    u8 = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    x = normalize(torch.from_numpy(u8), torch.float32)
    got = serve(ev, x).numpy()

    engine = InferenceEngine(tcms, ens, ServeConfig(input_size=32, patch_size=8,
                                                    buckets=(3,), dtype=torch.float32,
                                                    use_kernel=False, fast_math=False),
                             device="cpu")
    np.testing.assert_allclose(got, engine.predict(u8), rtol=1e-5, atol=1e-5)
    assert engine.division_devices == [torch.device("cpu")] * 4

    jserve = jax_server(jcms, lambda e, c, t: jens.apply(e, c, t), ens_vars, patch_size=8,
                        devices=jax.devices()[:1], dtype=jnp.float32, use_pallas=False,
                        fast_math=False)
    want = np.asarray(jserve(ens_vars, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # the fusion weights passed at call time are the ones used
    zeros = {k: torch.zeros_like(v) for k, v in ev.items()}
    assert not np.allclose(serve(zeros, x).numpy(), got)


def test_stream_matches_per_batch_serve(built):
    serve, ev = _server(built)
    g = torch.Generator().manual_seed(2)
    batches = [torch.randn((3, 32, 32, 3), generator=g) for _ in range(5)]
    want = [serve(ev, b).numpy() for b in batches]
    for depth in (1, 2, 7):  # 7 > len(batches): every batch in flight at once
        got = list(serve.stream(ev, batches, depth=depth))
        assert len(got) == len(batches)
        for k, (a, b) in enumerate(zip(got, want)):
            assert isinstance(a, np.ndarray) and a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"depth={depth} batch={k}")
    assert list(serve.stream(ev, [])) == []
    with pytest.raises(ValueError, match="depth"):
        next(serve.stream(ev, batches, depth=0))


def test_fusion_device_defaults_and_overrides():
    """The bookkeeping of tests/test_serve.py's fusion cases on a list of
    eight cards (no card is touched): divisions round robin, fusion on the
    first spare card, else the first card; an explicit fusion device wins."""
    cards = [torch.device("cuda", i) for i in range(8)]
    divs, fusion = placement(4, cards)
    assert divs == cards[:4] and fusion == cards[4]
    assert fusion not in divs
    divs, fusion = placement(4, cards[:4])
    assert divs == cards[:4] and fusion == cards[0]
    assert placement(4, cards, fusion_device="cuda:7")[1] == cards[7]
    divs, fusion = placement(4, cards[:2])
    assert divs == [cards[0], cards[1], cards[0], cards[1]] and fusion == cards[0]
    with pytest.raises(ValueError):
        placement(4, [])


@pytest.mark.parametrize("world", [1, 2, 4])
def test_each_rank_places_on_its_own_card(monkeypatch, world):
    """What a server on each rank places, with four cards mocked (no card
    is touched): one process spreads the divisions over every card, the
    fusion on the first; under several ranks each rank's server keeps to
    the card its rank resolved (cuda:{local_rank % 4}), as each JAX process
    sees only its own chips; the CPU stays the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(collab, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(collab, "world_size", lambda: world)
    cards = [torch.device("cuda", i) for i in range(4)]
    for rank in range(world):
        own = torch.device("cuda", rank % 4)
        divs, fusion = placement(4, serving_devices(own))
        if world == 1:
            assert divs == cards and fusion == cards[0]
        else:
            assert divs == [own] * 4 and fusion == own
    assert serving_devices(torch.device("cpu")) == [torch.device("cpu")]


def test_healthz_reports_the_placement(built):
    """GET /healthz names each division's device and the fusion device (one
    CPU device here: the collaborative server on the engine's device)."""
    _, tcms, _, _, ens = built
    engine = InferenceEngine(tcms, ens, ServeConfig(input_size=32, patch_size=8, buckets=(2,),
                                                    dtype=torch.float32, use_kernel=False),
                             device="cpu")
    httpd, batcher = build_server(engine, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        host, port = httpd.server_address[:2]
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as r:
            h = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
        t.join(timeout=10)
    assert not t.is_alive()
    assert h["division_devices"] == ["cpu"] * 4 and h["fusion_device"] == "cpu"
