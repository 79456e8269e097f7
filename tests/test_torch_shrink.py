"""Stage 3 of the port (devit_tpu_torch/core/hsic.py, rank.py, shrink.py,
compact.py, metrics.py and the folded candidate gates of models/vit.py) vs
the JAX package on the same numpy inputs, at f32 on the CPU: HSIC and its
batched forms, neuron and head scores and ranks, the folded gated forward
against per-candidate forwards and JAX's vmapped apply, evaluate_policies
with a ragged val tail, model_shrink's .npy files byte for byte, padded
compaction leaf for leaf, and the parameter counts. The JAX side runs its
plain XLA attention, as its own CPU tests do."""

import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.core import compact as jcompact
from devit_tpu.core import hsic as jhsic
from devit_tpu.core import metrics as jmetrics
from devit_tpu.core import rank as jrank
from devit_tpu.core import shrink as jshrink
from devit_tpu.data.pipeline import normalize as jnormalize
from devit_tpu.models import vit as jvit
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.core import compact as tcompact
from devit_tpu_torch.core import hsic as thsic
from devit_tpu_torch.core import metrics as tmetrics
from devit_tpu_torch.core import rank as trank
from devit_tpu_torch.core import shrink as tshrink
from devit_tpu_torch.data.pipeline import normalize as tnormalize
from devit_tpu_torch.io.bridge import vit_from_jax_params, vit_to_jax_params
from devit_tpu_torch.models import vit as tvit
from tests.test_torch_cuda import head_score_bound, ill_conditioned_heads

TOY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=7)
HIDDEN = 256
TIE_TOL = 1e-5  # scores within this (relative to max |score|) count as tied


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _init(seed):
    jm = jvit.VisionTransformer(jax_cfg("dedeit", **TOY), dtype=jnp.float32)
    return jm, jax.device_get(jm.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)))["params"])


def _setup(B=4, seed=0):
    """The toy dedeit (JAX module, port config, numpy parameters) and a
    (B, 32, 32, 3) f32 input; parameters are read, never written."""
    jm, params = _init(seed)
    x = np.random.default_rng(seed).standard_normal((B, 32, 32, 3)).astype(np.float32)
    return jm, get_vit_config("dedeit", **TOY), params, x


def _port(cfg, params, **kw):
    return vit_from_jax_params(params, cfg, device="cpu", dtype=torch.float32, **kw)


def _ranks_agree(got_rank, want_scores, tol=TIE_TOL):
    """The port's ranks equal the argsort of JAX's scores at every sorted
    position whose neighbouring scores differ by more than tol * max|score|;
    returns how many positions lie inside a tie."""
    want_rank = np.argsort(want_scores, axis=-1)
    s = np.take_along_axis(want_scores, want_rank, axis=-1)
    gap = np.diff(s, axis=-1) > tol * np.abs(want_scores).max()
    clear = np.ones(s.shape, bool)
    clear[:, 1:] &= gap
    clear[:, :-1] &= gap
    np.testing.assert_array_equal(got_rank[clear], want_rank[clear])
    return int((~clear).sum())


# ---- core/hsic.py


@pytest.mark.parametrize("y_kernel", ["linear", "rbf"])
@pytest.mark.parametrize("mean_sub", [True, False])
def test_hsic_matches_jax(y_kernel, mean_sub):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 20)).astype(np.float32)
    y = (0.3 * rng.standard_normal((12, 5))).astype(np.float32)
    want = jhsic.hsic(jnp.asarray(x), jnp.asarray(y), y_kernel=y_kernel, mean_sub=mean_sub)
    got = thsic.hsic(_t(x), _t(y), y_kernel=y_kernel, mean_sub=mean_sub)
    assert got.dtype == torch.float32 and got.shape == ()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("C", [1, 6])
def test_hsic_relevance_and_redundancy_match_jax(C):
    rng = np.random.default_rng(C)
    xs = (0.5 * rng.standard_normal((C, 10, 18))).astype(np.float32)
    probs = jax.device_get(jax.nn.softmax(jnp.asarray(rng.standard_normal((10, 7)),
                                                      jnp.float32), axis=-1))
    rel = thsic.hsic_relevance_many(_t(xs), _t(probs))
    want = jax.jit(jhsic.hsic_relevance_many)(jnp.asarray(xs), jnp.asarray(probs))
    assert rel.shape == (C,) and _rel(rel, want) <= 1e-5
    red = thsic.hsic_redundancy_matrix(_t(xs))
    want = jax.jit(jhsic.hsic_redundancy_matrix)(jnp.asarray(xs))
    assert red.shape == (C, C) and _rel(red, want) <= 1e-5


def test_mean_sub_is_the_reference_expression():
    # the division binds to the mean term only, with the unbiased std
    x = np.random.default_rng(1).standard_normal((9, 4)).astype(np.float32)
    want = x - x.mean(0) / (x.std(0, ddof=1) + 1e-12)
    np.testing.assert_allclose(thsic._mean_sub(_t(x)).numpy(), want, rtol=1e-6, atol=1e-6)
    assert _rel(thsic._mean_sub(_t(x)), jhsic._mean_sub(jnp.asarray(x))) <= 1e-6


def test_sq_dists_keep_f32_accuracy_on_offset_rows():
    # small spreads on a large common offset (what _mean_sub leaves): the
    # distances stay within 1e-5 of the f64 ones, as the rows are centred
    rng = np.random.default_rng(2)
    x = (3.0 + 0.01 * rng.standard_normal((4, 16, 198))).astype(np.float32)
    exact = ((x[:, :, None].astype(np.float64) - x[:, None]) ** 2).sum(-1)
    assert _rel(thsic._sq_dists(_t(x)), exact) <= 1e-5


def test_hsic_keeps_tf32_off_and_restores_the_flag():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with thsic.f32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ---- core/rank.py


@pytest.mark.parametrize("H", [1, 4])
def test_neuron_and_head_scores_match_jax(H):
    rng = np.random.default_rng(H)
    L, B, N = 2, 8, 18
    act = rng.standard_normal((L, B, N, HIDDEN)).astype(np.float32)
    head_out = rng.standard_normal((L, B, N, H, 16)).astype(np.float32)
    probs = jax.device_get(jax.nn.softmax(jnp.asarray(rng.standard_normal((B, 7)),
                                                      jnp.float32), axis=-1))
    jh, ja = jax.device_get(jrank._neuron_scores(jnp.asarray(act), jnp.asarray(probs)))
    th, ta = trank._neuron_scores(_t(act), _t(probs))
    assert _rel(th, jh) <= 1e-5 and _rel(ta, ja) <= 1e-5
    want = jax.device_get(jrank._head_scores(jnp.asarray(head_out), jnp.asarray(probs)))
    got = trank._head_scores(_t(head_out), _t(probs))
    assert got.shape == (L, H) and torch.isfinite(got).all()
    assert _rel(got, want) <= 1e-5


def test_ill_conditioned_head_scores_within_their_rounding_bound():
    """Head features spread tinily against every kernel width (exp near 1):
    f32 loses digits here, as in the reference's formula; the CPU's f32
    scores stay within the bound that the grams' conditioning gives against
    f64 (tests/test_torch_cuda.py holds the card to the same bound)."""
    head_out, probs = ill_conditioned_heads()
    want, bound = head_score_bound(head_out, probs)
    assert bound < 1e-3  # kappa ~2.5e3: 3.4 of f32's 7.2 digits cancel
    got = trank._head_scores(head_out, probs)
    rel = _rel(got, want)
    print(f"ill-conditioned head scores, CPU vs f64: {rel:.3e} (bound {bound:.3e})")
    assert got.dtype == torch.float32 and rel <= bound


def test_rank_functions_match_jax_outside_ties():
    jm, cfg, params, x = _setup(B=8)
    rng = np.random.default_rng(3)
    head = (rng.random((2, 4)) > 0.3).astype(np.float32)
    neuron = (rng.random((2, HIDDEN)) > 0.3).astype(np.float32)
    variables = {"params": params}
    apply = jax.jit(lambda v, x, g, c: jm.apply(v, x, gates=g, capture_rank_stats=c),
                    static_argnums=(3,))
    model = _port(cfg, params)
    for gates in (None, (head, neuron)):
        jg = None if gates is None else jvit.Gates(*map(jnp.asarray, gates))
        tg = None if gates is None else tvit.Gates(*map(_t, gates))
        out = apply(variables, jnp.asarray(x), jg, True)
        probs = jax.nn.softmax(out.logits.astype(jnp.float32), axis=-1)
        hs, acts = jax.device_get(jrank._neuron_scores(out.neuron_act, probs))
        scores = np.stack([0.1 * jrank._minmax(h) + 0.9 * jrank._minmax(a)
                           for h, a in zip(hs, acts)])
        got = trank.mlp_neuron_rank(model, _t(x), tg)
        assert got.shape == (2, HIDDEN) and got.dtype == np.int64
        # JAX's own scores carry ~1e-4 of f32 rounding on these captures (its
        # distances are not centred), so the 1e-5 tie is the tighter test;
        # the positions it excuses stay few (4 and 6 of 512 here)
        n_tied = _ranks_agree(got, scores)
        assert n_tied <= 0.02 * got.size, n_tied
        head_scores = jax.device_get(jrank._head_scores(out.head_out, probs))
        _ranks_agree(trank.attn_head_rank(model, _t(x), tg), head_scores)
        np.testing.assert_array_equal(trank.attn_head_rank(model, _t(x), tg),
                                      jrank.attn_head_rank(apply, variables, jnp.asarray(x), jg))


def test_policies_to_gates_and_check_sparsity_equal_jax():
    rng = np.random.default_rng(0)
    n_rank = np.stack([rng.permutation(HIDDEN) for _ in range(2)])
    h_rank = np.stack([rng.permutation(4) for _ in range(2)])
    policies = rng.uniform(0, 0.9, (5, 4)).tolist()
    want = jshrink.policies_to_gates(policies, n_rank, h_rank, 2)
    got = tshrink.policies_to_gates(policies, n_rank, h_rank, 2)
    assert got.head.shape == (5, 2, 4) and got.neuron.shape == (5, 2, HIDDEN)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))
    for c in range(5):
        jg = jvit.Gates(want.head[c], want.neuron[c])
        for gates in (tvit.Gates(got.head[c], got.neuron[c]),
                      tvit.Gates(_t(got.head[c]), _t(got.neuron[c]))):
            for g, w in zip(trank.check_sparsity(gates), jrank.check_sparsity(jg)):
                np.testing.assert_array_equal(g, w)


def test_random_point_equals_jax():
    assert tshrink.random_point(0.3 * 9.19, 1, 0.0, 0.9, 24, seed=5) == jshrink.random_point(
        0.3 * 9.19, 1, 0.0, 0.9, 24, seed=5)


# ---- the folded candidate forward (models/vit.py, core/shrink.py)


def _candidate_gates(C, seed=2, binary=True):
    rng = np.random.default_rng(seed)
    if binary:
        return ((rng.random((C, 2, 4)) > 0.3).astype(np.float32),
                (rng.random((C, 2, HIDDEN)) > 0.3).astype(np.float32))
    return (rng.random((C, 2, 4)).astype(np.float32),
            rng.random((C, 2, HIDDEN)).astype(np.float32))


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("binary", [True, False])
def test_folded_forward_matches_per_candidate_and_jax_vmap(use_kernel, binary):
    jm, cfg, params, x = _setup(B=3)
    C, B = 3, 3
    head, neuron = _candidate_gates(C, binary=binary)
    model = _port(cfg, params, use_kernel=use_kernel)
    folded, xf = tshrink.fold_candidates(tvit.Gates(_t(head), _t(neuron)), _t(x))
    assert folded.head.shape == (2, C * B, 4) and xf.shape == (C * B, *x.shape[1:])
    with torch.no_grad():
        got = model(xf, folded).logits.view(C, B, -1)
        per = torch.stack([model(_t(x), tvit.Gates(_t(head[c]), _t(neuron[c]))).logits
                           for c in range(C)])
    assert _rel(got, per) <= 1e-5
    want = jax.jit(jax.vmap(lambda hg, ng: jm.apply({"params": params}, jnp.asarray(x),
                                                    gates=jvit.Gates(hg, ng)).logits))(
        jnp.asarray(head), jnp.asarray(neuron))
    assert _rel(got, want) <= 1e-5


def _val_batches(images, labels, bs):
    return [(images[s:s + bs], labels[s:s + bs]) for s in range(0, len(labels), bs)]


def _jax_apply_logits(jm):
    return lambda v, imgs, gates: jm.apply(v, imgs, gates=gates).logits


def test_evaluate_policies_counts_equal_jax_with_ragged_tail_and_candidates():
    jm, cfg, params, _ = _setup()
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (21, 32, 32, 3), dtype=np.uint8)  # batches 8, 8, 5
    labels = rng.integers(0, 7, 21)
    head, neuron = _candidate_gates(5, seed=6)  # 5 candidates in chunks of 2
    kw = dict(candidate_chunk=2)
    want = jshrink.evaluate_policies(
        _jax_apply_logits(jm), {"params": params}, jvit.Gates(jnp.asarray(head),
                                                              jnp.asarray(neuron)),
        _val_batches(images, labels, 8), prepare=lambda im: jnormalize(im, jnp.float32), **kw)
    got = tshrink.evaluate_policies(
        _port(cfg, params), tvit.Gates(head, neuron), _val_batches(images, labels, 8),
        prepare=lambda im: tnormalize(im, torch.float32), **kw)
    assert got.dtype == np.float64 and got.shape == (5,)
    np.testing.assert_array_equal(got, want)
    # counted out of the 21 real images: the padded rows never match
    assert np.allclose(got * 21 / 100, np.round(got * 21 / 100))


def test_evaluate_policies_full_width_dedeit():
    """Full dedeit (384 wide, 12 layers, 6 heads, N 198), 25 classes, B 2,
    C 2, seeded numpy parameters."""
    cfg = get_vit_config("dedeit", num_classes=25)
    rng = np.random.default_rng(0)
    params = tvit.map_leaves(lambda s: (0.02 * rng.standard_normal(s)).astype(np.float32),
                             tvit.vit_param_shapes(cfg))
    images = rng.integers(0, 256, (3, 224, 224, 3), dtype=np.uint8)  # batches 2, 1
    labels = rng.integers(0, 25, 3)
    n_rank = np.stack([rng.permutation(1536) for _ in range(12)])
    h_rank = np.stack([rng.permutation(6) for _ in range(12)])
    policies = jshrink.screen(0.3 * 9.19, 2, 0.0, 0.9, 12, seed=0)
    jg = jshrink.policies_to_gates(policies, n_rank, h_rank, 12)
    jm = jvit.VisionTransformer(jax_cfg("dedeit", num_classes=25), dtype=jnp.float32)
    want = jshrink.evaluate_policies(_jax_apply_logits(jm), {"params": params}, jg,
                                     _val_batches(images, labels, 2), candidate_chunk=2,
                                     prepare=lambda im: jnormalize(im, jnp.float32))
    got = tshrink.evaluate_policies(
        _port(cfg, params), tshrink.policies_to_gates(policies, n_rank, h_rank, 12),
        _val_batches(images, labels, 2), candidate_chunk=2,
        prepare=lambda im: tnormalize(im, torch.float32))
    np.testing.assert_array_equal(got, want)


def _near_tied_rows(logits, tol=1e-5):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) < tol * np.abs(logits).max()


def test_model_shrink_npy_files_equal_jax(tmp_path):
    jm, cfg, params, _ = _setup()
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (13, 32, 32, 3), dtype=np.uint8)  # batches 6, 6, 1
    labels = rng.integers(0, 7, 13)
    n_rank = np.stack([rng.permutation(HIDDEN) for _ in range(2)])
    h_rank = np.stack([rng.permutation(4) for _ in range(2)])
    kw = dict(layer=2, shrink_ratio=0.45, population=7, full_gmacs=None, emb=64, head=4,
              seq_length=cfg.seq_len, candidate_chunk=3, seed=11)
    want = jshrink.model_shrink(_jax_apply_logits(jm), {"params": params}, n_rank, h_rank,
                                lambda: _val_batches(images, labels, 6),
                                prepare=lambda im: jnormalize(im, jnp.float32), **kw)
    model = _port(cfg, params)
    got = tshrink.model_shrink(model, n_rank, h_rank, lambda: _val_batches(images, labels, 6),
                               prepare=lambda im: tnormalize(im, torch.float32), **kw)
    files = {}
    for side, res in (("jax", want), ("port", got)):
        d = tmp_path / side
        d.mkdir()
        np.save(d / "shrinked_policy.npy", res.policies)
        np.save(d / "shrinked_accuracy.npy", res.accuracies)
        files[side] = {f: (d / f).read_bytes() for f in os.listdir(d)}
    assert files["port"]["shrinked_policy.npy"] == files["jax"]["shrinked_policy.npy"]
    if files["port"]["shrinked_accuracy.npy"] != files["jax"]["shrinked_accuracy.npy"]:
        # a near tie of the top-2 logits may flip an argmax between the two
        # packages: excuse exactly the tied rows, and say so
        gates = tshrink.policies_to_gates(got.policies, n_rank, h_rank, 2)
        x = tnormalize(_t(images), torch.float32)
        with torch.no_grad():
            folded, xf = tshrink.fold_candidates(tvit.Gates(_t(gates.head), _t(gates.neuron)),
                                                 x)
            logits = model(xf, folded).logits.view(len(got.policies), 13, -1).numpy()
        tied = _near_tied_rows(logits).sum(axis=1)
        diff = np.abs(got.accuracies - want.accuracies) * 13 / 100
        assert (np.round(diff) <= tied).all(), (diff, tied)
        warnings.warn(f"shrinked_accuracy.npy differs from JAX's only on near-tied rows "
                      f"({int(tied.sum())} tied): held by counts, not byte for byte")
    else:
        assert got.best.tolist() == want.best.tolist()


# ---- core/compact.py


def _compact_gates(seed):
    rng = np.random.default_rng(seed)
    head = (rng.random((2, 4)) > 0.5).astype(np.float32)
    head[:, 0] = 1.0
    neuron = (rng.random((2, HIDDEN)) > 0.6).astype(np.float32)
    return head, neuron


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def _assert_tree_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("kw", [{}, dict(neuron_multiple=8, min_keep_heads=3),
                                dict(head_multiple=2, min_keep_neurons=200)])
def test_compact_vit_params_bit_equal_to_jax_and_to_the_gated_model(kw):
    jm, cfg, params, x = _setup(B=3)
    head, neuron = _compact_gates(8)
    want_p, want_cfg = jcompact.compact_vit_params(
        params, jvit.Gates(jnp.asarray(head), jnp.asarray(neuron)), jax_cfg("dedeit", **TOY),
        **kw)
    model = _port(cfg, params)
    got_p, got_cfg = tcompact.compact_vit_params(model, tvit.Gates(head, neuron), cfg, **kw)
    assert (got_cfg.num_heads, got_cfg.hidden_dim, got_cfg.head_dim) == (
        want_cfg.num_heads, want_cfg.hidden_dim, want_cfg.head_dim)
    _assert_tree_equal(vit_to_jax_params(got_p), jax.device_get(want_p))
    cm = tvit.VisionTransformer(got_cfg, dtype=torch.float32)
    cm.load_state_dict(got_p)
    with torch.no_grad():
        gated = model(_t(x), tvit.Gates(_t(head), _t(neuron))).logits
        assert _rel(cm(_t(x)).logits, gated) <= 1e-5


def test_compact_rejects_fractional_gates():
    _, cfg, params, _ = _setup()
    head, neuron = _compact_gates(8)
    head[0, 1] = 0.5
    with pytest.raises(ValueError, match="binary"):
        tcompact.compact_vit_params(_port(cfg, params), tvit.Gates(head, neuron), cfg)


def test_compact_divisions_bit_equal_to_jax():
    setups = [_setup(seed=s) for s in (0, 1)]
    gates = [_compact_gates(s) for s in (3, 4)]
    want_p, want_cfg = jcompact.compact_divisions(
        [p for _, _, p, _ in setups], [jvit.Gates(*map(jnp.asarray, g)) for g in gates],
        jax_cfg("dedeit", **TOY), min_keep_heads=1)
    cfg = setups[0][1]
    got_p, got_cfg = tcompact.compact_divisions(
        [dict(_port(cfg, p).named_parameters()) for _, _, p, _ in setups],
        [tvit.Gates(_t(h), _t(n)) for h, n in gates], cfg, min_keep_heads=1)
    assert (got_cfg.num_heads, got_cfg.hidden_dim) == (want_cfg.num_heads, want_cfg.hidden_dim)
    for g, w in zip(got_p, want_p):
        _assert_tree_equal(vit_to_jax_params(g), jax.device_get(w))


# ---- core/metrics.py


def test_param_counts_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        ns, hs = rng.uniform(0, 0.9, 12).tolist(), rng.uniform(0, 0.9, 12).tolist()
        kw = dict(emb=384, head=6, seq_length=197)
        assert tmetrics.cal_shrink_paras(ns, hs, **kw) == jmetrics.cal_shrink_paras(ns, hs, **kw)
    _, cfg, params, _ = _setup()
    model = _port(cfg, params)
    want = jmetrics.count_params_brute(params)
    assert tmetrics.count_params_brute(model) == want
    assert tmetrics.count_params_brute(dict(model.named_parameters())) == want
    assert tmetrics.count_params_brute(vit_to_jax_params(model)) == want
