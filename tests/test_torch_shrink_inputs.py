"""The port's canonical deployed inputs are bit-identical to the JAX
package's: screen() policies, build_gates() masks and the seeded division
params of bench.build_inputs()."""

import jax
import numpy as np
import pytest

import bench
from devit_tpu.core import metrics as jmetrics
from devit_tpu.core import rank as jrank
from devit_tpu.core import shrink as jshrink
from devit_tpu_torch import deploy
from devit_tpu_torch.core import metrics as tmetrics
from devit_tpu_torch.core import rank as trank
from devit_tpu_torch.core import shrink as tshrink
from devit_tpu_torch.models.vit import map_leaves

TARGET = 0.3 * 9.19


@pytest.mark.parametrize("seed", [42, 43, 44, 45])
def test_screen_and_gates_bit_identical(seed):
    want = jshrink.screen(TARGET, 1, 0.0, 0.9, 12, seed=seed)
    got = tshrink.screen(TARGET, 1, 0.0, 0.9, 12, seed=seed)
    assert got == want
    rng = np.random.default_rng(seed)
    n_rank = np.stack([rng.permutation(1536) for _ in range(12)])
    h_rank = np.stack([rng.permutation(6) for _ in range(12)])
    p = got[0]
    jg = jrank.build_gates(n_rank, h_rank, p[:12], p[12:])
    tg = trank.build_gates(n_rank, h_rank, p[:12], p[12:])
    for j, t in zip(jg, tg):
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, np.asarray(j))


def test_flops_and_macs_match():
    rng = np.random.default_rng(0)
    for _ in range(20):
        ns, hs = rng.uniform(0, 0.9, 12).tolist(), rng.uniform(0, 0.9, 12).tolist()
        kw = dict(emb=384, head=6, seq_length=197)
        assert tmetrics.cal_shrink_flops(ns, hs, **kw) == jmetrics.cal_shrink_flops(ns, hs, **kw)
        assert tmetrics.cal_shrink_macs(ns, hs, **kw) == jmetrics.cal_shrink_macs(ns, hs, **kw)


def test_mask_from_rank_keeps_float_floor():
    # int(width*(1.0-ratio)): 6*(1-0.5) -> 3, 6*(1-1/3) -> 3 (4.0000000001 floors)
    for ratio in (0.0, 0.5, 1 / 3, 0.9, 0.999):
        row = np.arange(6)[::-1].copy()
        np.testing.assert_array_equal(trank._mask_from_rank(row, 6, ratio),
                                      jrank._mask_from_rank(row, 6, ratio))


def test_build_inputs_bit_identical_to_bench():
    jcfg, jparams, jgates = bench.build_inputs()
    tcfg, tparams, tgates = deploy.build_inputs()
    assert (tcfg.embed_dim, tcfg.depth, tcfg.num_heads, tcfg.num_classes, tcfg.distilled) == (
        jcfg.embed_dim, jcfg.depth, jcfg.num_heads, jcfg.num_classes, jcfg.distilled)
    for jp, tp, jg, tg in zip(jparams, tparams, jgates, tgates):
        jl = jax.tree_util.tree_leaves(jp)
        tl = []
        map_leaves(tl.append, tp)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tg.head, np.asarray(jg.head))
        np.testing.assert_array_equal(tg.neuron, np.asarray(jg.neuron))
    kept = [[int(h.sum()) for h in g.head] for g in tgates]
    assert kept == [[4, 0, 5, 3, 2, 5, 5, 5, 1, 5, 4, 5],
                    [1, 5, 4, 1, 5, 3, 4, 4, 5, 2, 5, 4],
                    [4, 2, 5, 4, 1, 4, 4, 3, 3, 5, 3, 4],
                    [2, 1, 0, 5, 1, 5, 5, 5, 4, 5, 3, 1]]
