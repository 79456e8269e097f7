"""The port's text stack (devit_tpu_torch/models/text.py and the text
converters of io/bridge.py) against the JAX package's devit_tpu/models/text.py,
at tests/test_text.py's geometries: the JAX modules' own `init` weights
carried across by text_from_jax_params, inputs from a numpy seed.

Tolerances: max|port - JAX| / max|JAX| <= 1e-5 at f32 (products and
softmaxes summed in another order), <= 2e-2 at bf16; the masks, the output
lengths and the converters' round trip exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from devit_tpu.models import text as jtext
from devit_tpu_torch.io.bridge import text_from_jax_params, text_to_jax_params
from devit_tpu_torch.models import text as ttext

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
NO_DRAWS = dict(dropout=0.0, attention_dropout=0.0, stochastic_depth=0.0)
CCT_KW = dict(vocab_size=50, num_classes=4, word_seq_len=16, word_embedding_dim=24,
              embedding_dim=32, num_layers=2, num_heads=4)


def _rel(got, want):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mask(B, L, keep):
    m = np.zeros((B, L), np.float32)
    for b, k in enumerate(keep):
        m[b, :k] = 1.0
    return m


def _params(module, *args, seed=0, **kw):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(
        module.init(jax.random.key(seed), *args, **kw)["params"]))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: np.asarray(tree)}


def _ids(B, L, seed, vocab=50):
    return np.random.default_rng(seed).integers(0, vocab, (B, L))


def test_embedder_matches_jax_and_zeroes_its_padding_row():
    V, E, B, L = 20, 16, 3, 10
    ids, mask = _ids(B, L, 1, V), _mask(B, L, [10, 6, 3])
    jm = jtext.Embedder(vocab_size=V, embedding_dim=E, padding_idx=1, dtype=jnp.float32)
    p = _params(jm, jnp.asarray(ids))
    want, _ = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask))
    tm = text_from_jax_params(p, module=ttext.Embedder, vocab_size=V, embedding_dim=E,
                              padding_idx=1, device="cpu", dtype=torch.float32)
    got, back = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel(got, want) <= TOL[torch.float32] and back is not None
    fresh = ttext.Embedder(V, E, padding_idx=1, device="cpu")
    assert torch.all(fresh.embedding[1] == 0) and fresh.embedding.dtype == torch.float32


@pytest.mark.parametrize("max_pool,act", [(True, True), (True, False), (False, True),
                                          (False, False)])
def test_tokenizer_matches_jax_with_and_without_a_mask(max_pool, act):
    B, L, E, C = 2, 17, 16, 24
    x = np.random.default_rng(2).standard_normal((B, L, E)).astype(np.float32)
    mask = _mask(B, L, [17, 5])
    kw = dict(kernel_size=3, stride=2, padding=1, pooling_kernel_size=3, pooling_stride=2,
              pooling_padding=1, use_activation=act, max_pool=max_pool)
    jm = jtext.TextTokenizer(n_output_channels=C, dtype=jnp.float32, **kw)
    p = _params(jm, jnp.asarray(x))
    tm = text_from_jax_params(p, module=ttext.TextTokenizer, embedding_dim=E,
                              n_output_channels=C, device="cpu", dtype=torch.float32, **kw)
    for m in (mask, None):
        want, _ = jm.apply({"params": p}, jnp.asarray(x), None if m is None else jnp.asarray(m))
        got, _ = tm(torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        assert got.shape == want.shape and _rel(got, want) <= TOL[torch.float32]
    assert tm.seq_len(L) == jm.seq_len(L) == got.shape[1]


@pytest.mark.parametrize("k,s,p,max_pool", [(3, 2, 1, True), (4, 2, 1, True), (2, 1, 0, False),
                                            (5, 3, 2, True)])
def test_forward_mask_and_seq_len_equal_jax(k, s, p, max_pool):
    B, L = 4, 23
    mask = _mask(B, L, [23, 11, 1, 0])
    mask[0, 5:9] = 0.0  # a hole in the middle
    kw = dict(kernel_size=k, stride=s, padding=p, pooling_kernel_size=3, pooling_stride=2,
              pooling_padding=1, max_pool=max_pool)
    jm = jtext.TextTokenizer(n_output_channels=8, **kw)
    tm = ttext.TextTokenizer(6, 8, device="cpu", **kw)
    want = np.asarray(jm.forward_mask(jnp.asarray(mask)))
    got = tm.forward_mask(torch.from_numpy(mask)).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    for n in (L, 64, 7):
        assert tm.seq_len(n) == jm.seq_len(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_layer_matches_jax_with_a_fully_masked_row(dtype):
    B, N, D, H = 4, 4, 32, 4
    x = np.random.default_rng(3).standard_normal((B, N, D)).astype(np.float32)
    mask = _mask(B, N, [4, 2, 0, 3]) > 0  # row 2 masked everywhere
    jm = jtext.MaskedTextLayer(embedding_dim=D, num_heads=H, dim_feedforward=64, dropout=0.0,
                               attention_dropout=0.0, dtype=JDT[dtype])
    carry = (jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(mask))
    p = _params(jm, carry, (jnp.float32(0.0),))
    (want, _), _ = jm.apply({"params": p}, carry, (jnp.float32(0.0),))
    tm = text_from_jax_params(p, module=ttext.MaskedTextLayer, embedding_dim=D, num_heads=H,
                              dim_feedforward=64, dropout=0.0, attention_dropout=0.0,
                              device="cpu", dtype=dtype)
    got = tm(torch.from_numpy(x).to(dtype), torch.from_numpy(mask))
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert _rel(got, np.asarray(want.astype(jnp.float32))) <= TOL[dtype]


@pytest.mark.parametrize("pe", ["none", "sine", "learnable"])
@pytest.mark.parametrize("seq_pool", [True, False])
def test_classifier_matches_jax_and_round_trips(pe, seq_pool):
    B, N, D = 4, 4, 32  # TextCCT's classifier at CCT_KW
    x = np.random.default_rng(4).standard_normal((B, N, D)).astype(np.float32)
    mask = _mask(B, N, [4, 3, 0, 1])
    kw = dict(seq_len=N, num_classes=4, embedding_dim=D, num_layers=2, num_heads=4,
              mlp_ratio=2.0, positional_embedding=pe, seq_pool=seq_pool, **NO_DRAWS)
    jm = jtext.MaskedTextClassifier(dtype=jnp.float32, **kw)
    p = _params(jm, jnp.asarray(x), jnp.asarray(mask))
    if pe == "learnable":  # the reference's (1, N+1, D) shape, class token counted
        assert p["positional_emb"].shape == (1, N + (1 if seq_pool else 2), D)
    tm = text_from_jax_params(p, module=ttext.MaskedTextClassifier, device="cpu",
                              dtype=torch.float32, **kw)
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask))
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and _rel(got, want) <= TOL[torch.float32]
    back = _flat(text_to_jax_params(tm))
    assert back.keys() == _flat(p).keys()
    assert all(np.array_equal(back[k], v) for k, v in _flat(p).items())


@pytest.fixture(scope="module")
def jax_cct():
    """JAX TextCCT parameters at CCT_KW (f32; a rate or the compute dtype
    changes none of them) and a batch with padded tails and a fully masked
    row."""
    B, L = 4, CCT_KW["word_seq_len"]
    ids = _ids(B, L, 5)
    mask = _mask(B, L, [16, 9, 2, 0])
    ids[mask == 0] = 1  # padded tails carry the padding id
    p = _params(jtext.TextCCT(**CCT_KW), jnp.asarray(ids), jnp.asarray(mask))
    return ids, mask, p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_text_cct_end_to_end_matches_jax(jax_cct, dtype):
    ids, mask, p = jax_cct
    jm = jtext.TextCCT(dtype=JDT[dtype], **CCT_KW)
    tm = text_from_jax_params(p, device="cpu", dtype=dtype, **CCT_KW)
    for m in (mask, None):
        want = jm.apply({"params": p}, jnp.asarray(ids), None if m is None else jnp.asarray(m))
        got = tm(torch.from_numpy(ids), None if m is None else torch.from_numpy(m))
        assert got.shape == (len(ids), CCT_KW["num_classes"]) and got.dtype == torch.float32
        assert _rel(got, want) <= TOL[dtype]


def test_garbage_ids_under_the_mask_change_no_logit(jax_cct):
    ids, mask, p = jax_cct
    tm = text_from_jax_params(p, device="cpu", dtype=torch.float32, **CCT_KW)
    garbage = ids.copy()
    garbage[mask == 0] = np.random.default_rng(7).integers(0, 50, int((mask == 0).sum()))
    with torch.no_grad():
        base = tm(torch.from_numpy(ids), torch.from_numpy(mask))
        moved = tm(torch.from_numpy(garbage), torch.from_numpy(mask))
    assert torch.equal(base, moved)
    jm = jtext.TextCCT(dtype=jnp.float32, **CCT_KW)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(garbage), jnp.asarray(mask)))
    assert _rel(moved, want) <= TOL[torch.float32]


def test_value_errors_carry_jax_messages():
    x = jnp.zeros((2, 6, 32))
    kw = dict(seq_len=8, num_classes=3, embedding_dim=32, num_layers=1, num_heads=4)
    for pe, xs in (("sine", x), ("bogus", jnp.zeros((2, 8, 32)))):
        jm = jtext.MaskedTextClassifier(positional_embedding=pe, **kw)
        with pytest.raises(ValueError) as want:
            jm.init(jax.random.key(0), xs)
        tm = ttext.MaskedTextClassifier(positional_embedding=pe, device="cpu", **kw)
        with pytest.raises(ValueError) as got:
            tm(torch.zeros(tuple(xs.shape), dtype=torch.bfloat16))
        assert str(got.value) == str(want.value)


def test_converters_round_trip_exactly(jax_cct):
    _, _, p = jax_cct
    back = text_to_jax_params(text_from_jax_params(p, device="cpu", **CCT_KW))
    want, got = _flat(p), _flat(back)
    assert want.keys() == got.keys()
    assert all(np.array_equal(got[k], want[k]) and got[k].dtype == np.float32 for k in want)


def _port_step(model, ids, mask, labels, generator=None):
    names = [n for n, _ in model.named_parameters()]
    logits = model(torch.from_numpy(ids), torch.from_numpy(mask), train=True,
                   generator=generator)
    loss = F.cross_entropy(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


def test_training_step_matches_jax_grad_with_the_rates_at_zero(jax_cct):
    ids, mask, p = jax_cct
    labels = np.array([0, 3, 1, 2])
    kw = dict(CCT_KW, **NO_DRAWS)
    jm = jtext.TextCCT(dtype=jnp.float32, **kw)

    def jloss(params):
        # drop-path at rate 0 still asks for a key: its masks are all ones
        logits = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask), train=True,
                          rngs={"dropout": jax.random.key(0)})
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), labels[:, None], 1))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(p)
    model = text_from_jax_params(p, device="cpu", dtype=torch.float32, **kw)
    loss, grads = _port_step(model, ids, mask, labels)
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want, got = _flat(jax.device_get(want)), _flat(text_to_jax_params(grads))
    assert want.keys() == got.keys()
    for k in want:
        # the attention_pool bias's gradient is zero in exact arithmetic (a
        # softmax ignores a shared shift): both sides round to ~1e-9 there
        err = np.abs(got[k] - want[k]).max()
        assert err <= 1e-5 * np.abs(want[k]).max() + 1e-8, k


def test_training_step_draws_follow_the_generator():
    B, L = 4, CCT_KW["word_seq_len"]
    ids, mask = _ids(B, L, 10), _mask(B, L, [16, 12, 5, 9])
    labels = np.array([0, 3, 1, 2])
    kw = dict(CCT_KW, dropout=0.1, attention_dropout=0.1, stochastic_depth=0.3)
    model = ttext.TextCCT(**kw, dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        model(torch.from_numpy(ids), torch.from_numpy(mask), train=True)
    steps = [_port_step(model, ids, mask, labels, torch.Generator().manual_seed(s))
             for s in (5, 5, 6)]
    (l1, g1), (l2, g2), (l3, g3) = steps
    assert l1 == l2 and all(torch.equal(g1[k], g2[k]) for k in g1)
    assert l1 != l3 and not torch.equal(g1["classifier.blocks.1.linear1.kernel"],
                                        g3["classifier.blocks.1.linear1.kernel"])
    with torch.no_grad():  # eval draws nothing
        a = model(torch.from_numpy(ids), torch.from_numpy(mask))
        b = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.equal(a, b)
