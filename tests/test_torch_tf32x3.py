"""The numerics behind the port's f32 kernels on the tensor cores
(devit_tpu_torch/kernels/csrc/long_tf32.cuh, wide.cuh past head width 128,
block_attention.cu's block_gemm_tf32, mma_common.cuh mma_3xtf32):
three TF32 passes a product (3xTF32) keep f32 accuracy, one pass does not.

A numpy emulation of the kernels' split: big = x rounded to TF32 (to
nearest, ties away from zero, on the low 13 mantissa bits: cvt.rna.tf32.f32,
which the kernels write as an integer add and mask), small = x - big rounded
the same way, and a b = small big + big small + big big. The products of
TF32 values are exact in f64 and are summed there (the tensor core's own
accumulation is not modelled). Every product of the kernels goes through it
(q k^T, p v; g v^T, p^T g, ds k, ds^T q) for the attention forward and dq,
dk and dv, on inputs made from a seed, against the JAX package's f32
fused_attention and its VJP in interpret mode (as tests/test_kernels.py runs
them on the CPU); and the block half (fused_block_attention at f32: qkv at
depth C, the attention's products, proj at depth K) against the JAX
package's f32 fused_block_attention in interpret mode. 3xTF32 stays within
1e-4 (max-abs over max-ref, the f32 tolerance of the card's checks); one
TF32 pass misses it and is at least 10x farther."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from devit_tpu.kernels import attention as jattn

TOL = 1e-4


def tf32(x: np.ndarray) -> np.ndarray:
    """x (f32) rounded to TF32: to nearest on the low 13 mantissa bits, ties
    away from zero (the magnitude's bits plus half a TF32 ulp, masked)."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(x: np.ndarray):
    big = tf32(x)
    return big, tf32(x.astype(np.float32) - big)


def mm3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as 3xTF32: small big + big small + big big, rounded to f32."""
    (ab, as_), (bb, bs) = split(a), split(b)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    return (f(as_) @ f(bb) + f(ab) @ f(bs) + f(ab) @ f(bb)).astype(np.float32)


def mm1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as one TF32 pass, rounded to f32."""
    return (tf32(a).astype(np.float64) @ tf32(b).astype(np.float64)).astype(np.float32)


def attention_and_grads(qkv: np.ndarray, g: np.ndarray, H: int, mm):
    """The forward o (B, N, C) and dqkv (B, N, 3C) with every product taken
    by mm, the rest in f32 as the kernels compute it (f32 softmax, ds
    unrounded at f32)."""
    B, N, C3 = qkv.shape
    dh = C3 // (3 * H)
    scale = np.float32(1.0) / np.sqrt(np.float32(dh))
    x = qkv.reshape(B, N, 3, H, dh).transpose(2, 0, 3, 1, 4)  # (3, B, H, N, dh)
    gh = g.reshape(B, N, H, dh).transpose(0, 2, 1, 3)
    o = np.empty((B, H, N, dh), np.float32)
    d = np.empty((3, B, H, N, dh), np.float32)
    for b in range(B):
        for h in range(H):
            q, k, v, gg = x[0, b, h], x[1, b, h], x[2, b, h], gh[b, h]
            s = mm(q, k.T) * scale
            e = np.exp(s - s.max(axis=-1, keepdims=True))
            p = (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)
            o[b, h] = mm(p, v)
            dp = mm(gg, v.T)
            ds = (p * (dp - np.sum(dp * p, axis=-1, keepdims=True)) * scale).astype(np.float32)
            d[0, b, h], d[1, b, h], d[2, b, h] = mm(ds, k), mm(ds.T, q), mm(p.T, gg)
    return (o.transpose(0, 2, 1, 3).reshape(B, N, H * dh),
            d.transpose(1, 3, 0, 2, 4).reshape(B, N, 3 * H * dh))


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # a TF32 ulp at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -20, 1 + 3 * ulp / 2,
                  3.0, 0.0, -0.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0, -0.0], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    assert np.signbit(tf32(x)[-1])
    rng = np.random.default_rng(0)
    y = rng.standard_normal(10_000).astype(np.float32)
    big, small = split(y)
    assert not (big.view(np.uint32) & 0x1FFF).any() and not (small.view(np.uint32) & 0x1FFF).any()
    # big + small holds x to ~2^-22 of it; big alone to ~2^-11
    assert np.abs((big.astype(np.float64) + small - y) / y).max() < 2.0 ** -21
    assert np.abs((big.astype(np.float64) - y) / y).max() > 2.0 ** -13


@pytest.mark.parametrize("N", [198, 578])
@pytest.mark.parametrize("dh", [64, 128])
def test_3xtf32_keeps_f32_accuracy_where_one_pass_does_not(N, dh):
    _hold_3xtf32(N, dh)


# past head width 128 (csrc/wide.cuh): the same products over wider heads,
# dh 192 (embed 768 at 4 heads) and 256 (768 at 3)
@pytest.mark.parametrize("dh", [192, 256])
def test_3xtf32_keeps_f32_accuracy_past_head_width_128(dh):
    _hold_3xtf32(198, dh)


def _hold_3xtf32(N: int, dh: int) -> None:
    B, H = 1, 2
    rng = np.random.default_rng(N * 1000 + dh)
    qkv = rng.standard_normal((B, N, 3 * H * dh)).astype(np.float32)
    g = rng.standard_normal((B, N, H * dh)).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jattn.make_trainable_attention(
        H, block_b=1, interpret=True)(x), jnp.asarray(qkv))
    want_o = np.asarray(out)
    np.testing.assert_allclose(
        want_o, np.asarray(jattn.fused_attention(jnp.asarray(qkv), None, num_heads=H,
                                                 block_b=1, interpret=True)), rtol=1e-6)
    want_d = np.asarray(vjp(jnp.asarray(g))[0])
    C = H * dh
    errs = {}
    for name, mm in (("3xtf32", mm3), ("1xtf32", mm1)):
        o, d = attention_and_grads(qkv, g, H, mm)
        errs[name] = [_rel(o, want_o)] + [_rel(d[..., i * C:(i + 1) * C],
                                              want_d[..., i * C:(i + 1) * C]) for i in range(3)]
    three, one = np.array(errs["3xtf32"]), np.array(errs["1xtf32"])
    assert three.max() <= TOL, errs  # o, dq, dk, dv
    assert (one >= 10 * three).all(), errs
    assert one.max() > TOL, errs


# ---- the block half (fused_block_attention at f32: csrc/block_attention.cu,
# LayerNorm + qkv and proj in block_gemm_tf32, the attention between them)


def block_half(a: dict, H: int, mm, eps: float = 1e-6) -> np.ndarray:
    """t + proj(attention(qkv(LayerNorm(t)))) at f32 with every product of
    the kernels' route taken by mm: qkv = h . W at depth C, per head q k^T
    and p v, then t + o . proj at depth K (one product over every head, as
    the proj GEMM sums it), + proj_bias; the LayerNorm and softmax in f32."""
    t = a["t"]
    B, N, C = t.shape
    K = a["qw"].shape[1] // 3
    dh = K // H
    scale = np.float32(1.0) / np.sqrt(np.float32(dh))
    mu = t.mean(axis=-1, keepdims=True, dtype=np.float32)
    var = np.square(t - mu).mean(axis=-1, keepdims=True, dtype=np.float32)
    h = ((t - mu) / np.sqrt(var + np.float32(eps)) * a["ns"] + a["nb"]).astype(np.float32)
    out = np.empty_like(t)
    for b in range(B):
        qkv = mm(h[b], a["qw"]) + a["qb"]
        q, k, v = (qkv[:, i * K:(i + 1) * K].reshape(N, H, dh).transpose(1, 0, 2)
                   for i in range(3))
        o = np.empty((N, H, dh), np.float32)
        for hd in range(H):
            s = mm(q[hd], k[hd].T) * scale
            e = np.exp(s - s.max(axis=-1, keepdims=True))
            p = (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)
            o[:, hd] = mm(p, v[hd])
        out[b] = t[b] + mm(o.reshape(N, K), a["pw"]) + a["pb"]
    return out


# the deployed divisions' width (C 384, six heads of 64) and a head past 128
# (C 768, four heads of 192), N 198: the GEMMs' depths 384 and 768
@pytest.mark.parametrize("C,H,dh", [(384, 6, 64), (768, 4, 192)])
def test_3xtf32_keeps_f32_accuracy_in_the_block_half(C, H, dh):
    N, K = 198, H * dh
    rng = np.random.default_rng(C + dh)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = dict(t=f(1, N, C), ns=1 + 0.1 * f(C), nb=0.1 * f(C), qw=0.1 * f(C, 3 * K),
             qb=0.1 * f(3 * K), pw=0.1 * f(K, C), pb=0.1 * f(C))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    want = np.asarray(jattn.fused_block_attention(
        *(jnp.asarray(a[k]) for k in ("t", "ns", "nb", "qw", "qb", "pw", "pb")), num_heads=H,
        eps=1e-6, block_b=1, interpret=True))
    three, one = _rel(block_half(a, H, mm3), want), _rel(block_half(a, H, mm1), want)
    assert three <= TOL, (three, one)
    assert one >= 10 * three and one > TOL, (three, one)
