"""Base ops of the (De)ViT forward (counterpart of devit_tpu/models/vit.py).

This slice carries what the deployed serving path needs: the gate container,
the LayerNorm and GELU numerics, and the shapes of the flax parameter tree
(so seeded parameters can be drawn in the JAX package's leaf order without
flax). The gated `VisionTransformer` comes with the training slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from devit_tpu_torch.configs import ViTConfig


class Gates(NamedTuple):
    """Structural-shrink masks. 1.0 = keep, 0.0 = pruned.

    `head`:   (depth, num_heads)
    `neuron`: (depth, hidden_dim)
    """

    head: Any
    neuron: Any


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, stat_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm with statistics in `stat_dtype` (f32 by default; the serving
    fast_math mode takes them in the compute dtype). Written out rather than
    F.layer_norm, which always takes f32 statistics."""
    dtype = x.dtype
    xs = x.to(stat_dtype)
    mean = xs.mean(dim=-1, keepdim=True)
    var = (xs - mean).square().mean(dim=-1, keepdim=True)
    y = (xs - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(stat_dtype) + bias.to(stat_dtype)
    return y.to(dtype)


def fast_erf(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz–Stegun 7.1.26 (max abs error 1.5e-7), computed in
    f32 and cast back to the input dtype — the same constants and rounding
    as the JAX package, so both packages agree on the exact-erf GELU."""
    xf = x.to(torch.float32)
    z = xf.abs()
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
           + t * (-1.453152027 + t * 1.061405429))))
    e = 1.0 - poly * torch.exp(-z * z)
    return (torch.sign(xf) * e).to(x.dtype)


def fast_gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU with the A&S erf (see fast_erf)."""
    xf = x.to(torch.float32)
    return (0.5 * xf * (1.0 + fast_erf(xf * 0.7071067811865476))).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU the fast_math serving mode uses (jax.nn.gelu with
    approximate=True)."""
    return F.gelu(x, approximate="tanh")


def vit_param_shapes(cfg: ViTConfig) -> dict:
    """Shapes of the flax `VisionTransformer(cfg).init(...)["params"]` tree,
    as a nested dict whose keys iterate in sorted order — the order in which
    jax.tree_util walks it. Blocks carry the leading depth axis of nn.scan."""
    L, C, A, K = cfg.depth, cfg.embed_dim, cfg.attn_dim, cfg.num_classes
    hidden = cfg.hidden_dim
    p = cfg.patch_size

    def dense(i, o):
        return {"bias": (o,), "kernel": (i, o)}

    def dense_l(i, o):
        return {"bias": (L, o), "kernel": (L, i, o)}

    norm_l = {"bias": (L, C), "scale": (L, C)}
    blocks = {"fc1": dense_l(C, hidden), "fc2": dense_l(hidden, C),
              "norm1": dict(norm_l), "norm2": dict(norm_l),
              "proj": dense_l(A, C), "qkv": dense_l(C, 3 * A)}
    if not cfg.qkv_bias:
        del blocks["qkv"]["bias"]
    tree = {
        "blocks": blocks,
        "cls_token": (1, 1, C),
        "head": dense(C, K),
        "norm": {"bias": (C,), "scale": (C,)},
        "patch_embed": dense(p * p * cfg.in_chans, C),
        "pos_embed": (1, cfg.seq_len, C),
    }
    if cfg.distilled:
        tree["dist_token"] = (1, 1, C)
        tree["head_dist"] = dense(C, K)
    if cfg.representation_size is not None and not cfg.distilled:
        tree["pre_logits"] = dense(C, cfg.representation_size)
        tree["head"] = dense(cfg.representation_size, K)
    if cfg.resize_dim is not None:
        for name in ("resize_att_mlp", "resize_encoder_mlp", "resize_mlp"):
            tree[name] = dense(C, cfg.resize_dim)
    return map_leaves(lambda shape: shape, tree)


def map_leaves(fn, tree):
    """Apply fn to every leaf of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)
