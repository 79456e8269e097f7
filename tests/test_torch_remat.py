"""Selective rematerialization (`remat_policy`) of the port's
VisionTransformer (devit_tpu_torch/models/vit.py) against full remat and
against the JAX package's policies of the same names, at tests/test_vit.py's
TINY geometry, f32, through the trainable attention (use_kernel=True, whose
plain version runs on the CPU).

A policy changes only what a block saves and what its backward recomputes:
gradients equal full remat's bit for bit, with and without dropout and
drop-path, and JAX's within tests/test_vit.py's rtol 1e-5, atol 1e-6. A
policy that silently saved nothing different would pass those checks too, so
the last test counts, under a TorchDispatchMode, the ops that each backward
re-runs beyond what the backward of the model without remat runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from devit_tpu.configs import get_vit_config as jax_cfg
from devit_tpu.models import vit as jvit
from devit_tpu_torch.configs import get_vit_config
from devit_tpu_torch.io.bridge import vit_from_jax_params, vit_to_jax_params
from devit_tpu_torch.kernels.attention import trainable_attention_op

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=4, num_heads=4, num_classes=10,
            drop_rate=0.0, drop_path_rate=0.0)
DRAWS = dict(TINY, drop_rate=0.1, drop_path_rate=0.1)
POLICIES = [None, "nothing_saveable", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims",
            "dots_and_attn", "everything_saveable"]
MM, BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default


@pytest.fixture(scope="module")
def setup():
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    y = np.array([1, 3])
    jm = jvit.VisionTransformer(jax_cfg("dedeit", **TINY), dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jm.init(jax.random.key(0), jnp.asarray(x))["params"]))
    return params, x, y


def _model(params, policy, cfg=TINY, **kw):
    kw.setdefault("use_kernel", True)
    return vit_from_jax_params(params, get_vit_config("dedeit", **cfg), device="cpu",
                               dtype=torch.float32, remat_policy=policy, **kw)


def _loss(model, x, y, seed=0):
    out = model(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(seed))
    return torch.mean((out.cls_logits - torch.nn.functional.one_hot(torch.from_numpy(y), 10)) ** 2)


def _port_grads(model, x, y, seed=0):
    # the dist head takes no part in the loss: zeros there, as jax.grad gives
    grads = torch.autograd.grad(_loss(model, x, y, seed), list(model.parameters()),
                                allow_unused=True, materialize_grads=True)
    return dict(zip([n for n, _ in model.named_parameters()], grads))


def _jax_grads(params, x, y, policy):
    model = jvit.VisionTransformer(jax_cfg("dedeit", **TINY), dtype=jnp.float32,
                                   use_pallas=True, remat_policy=policy)

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.key(0)})
        return jnp.mean((out.cls_logits - jax.nn.one_hot(y, 10)) ** 2)

    return jax.device_get(jax.grad(loss_fn)(params))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], prefix + (key,)).items()}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def full_remat(setup):
    params, x, y = setup
    return (_port_grads(_model(params, None), x, y),
            _port_grads(_model(params, None, DRAWS), x, y, seed=3))


@pytest.mark.parametrize("policy", POLICIES)
def test_grads_equal_full_remat_bit_for_bit_and_jax_under_the_same_name(setup, full_remat,
                                                                         policy):
    params, x, y = setup
    got = _port_grads(_model(params, policy), x, y)
    assert got.keys() == full_remat[0].keys()
    assert all(torch.equal(got[k], full_remat[0][k]) for k in got)
    want, mine = _flat(_jax_grads(params, x, y, policy)), _flat(vit_to_jax_params(got))
    assert want.keys() == mine.keys()
    for k in want:
        np.testing.assert_allclose(mine[k], want[k], rtol=1e-5, atol=1e-6, err_msg=str(k))


@pytest.mark.parametrize("policy", POLICIES)
def test_grads_with_dropout_and_drop_path_equal_full_remat(setup, full_remat, policy):
    params, x, y = setup
    got = _port_grads(_model(params, policy, DRAWS), x, y, seed=3)
    assert all(torch.equal(got[k], full_remat[1][k]) for k in got)
    # the draws matter: another seed drops other branches
    k = "blocks.2.fc1.kernel"
    assert not torch.equal(_port_grads(_model(params, policy, DRAWS), x, y, seed=4)[k], got[k])


@pytest.mark.parametrize("name", ["save_only_these_names", "save_any_names_but_these",
                                  "save_from_both_policies", "offload_dot_with_no_batch_dims",
                                  "dots_and_attention"])
def test_other_names_raise_where_jax_raises(setup, name):
    params, x, y = setup
    model = _model(params, name)
    with torch.no_grad():
        model(torch.from_numpy(x))  # eval: no remat, no check
    _loss(_model(params, name, use_remat=False), x, y)  # no remat, no check
    with pytest.raises(ValueError, match="remat_policy") as got:
        _loss(model, x, y)
    with pytest.raises(ValueError, match="remat_policy") as want:
        _jax_grads(params, x, y, name)
    assert str(got.value) == str(want.value)


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(model, x, y) -> dict:
    loss = _loss(model, x, y)
    with _Count() as count:
        torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return count.ops


@pytest.mark.parametrize("use_kernel", [True, False])
def test_each_policy_changes_what_the_backward_recomputes(setup, use_kernel):
    """Ops each backward runs beyond the no-remat backward's: full remat
    re-runs qkv, proj and fc1 of every block and the attention forward (the
    op on the kernel path, its two bmm on the plain path); fc2 it does not,
    as the recompute stops at the last tensor the backward needs, fc2's
    input. The dot policies re-run no Dense product, the no-batch ones still
    the plain attention's bmm; dots_and_attn and everything_saveable re-run
    neither."""
    params, x, y = setup
    depth = TINY["depth"]
    base = _backward_ops(_model(params, None, use_remat=False, use_kernel=use_kernel), x, y)
    attn = {True: {trainable_attention_op: depth}, False: {BMM: 2 * depth}}[use_kernel]
    dense = {MM: 3 * depth}
    want = {None: {**dense, **attn}, "nothing_saveable": {**dense, **attn},
            "dots_with_no_batch_dims_saveable": attn, "checkpoint_dots_with_no_batch_dims": attn,
            "dots_saveable": attn if use_kernel else {}, "checkpoint_dots": attn if use_kernel else {},
            "dots_and_attn": {}, "everything_saveable": {}}
    for policy in POLICIES:
        model = _model(params, policy, use_kernel=use_kernel)
        ops = _backward_ops(model, x, y)
        extra = {op: ops.get(op, 0) - base.get(op, 0) for op in (MM, BMM, trainable_attention_op)}
        assert {op: n for op, n in extra.items() if n} == want[policy], policy
