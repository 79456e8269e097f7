"""Ragged-compact ViT: per-layer exact-width inference forward (counterpart
of devit_tpu/models/compact_vit.py:41-136, :159-254, :309-326).

Each layer keeps exactly its kept heads and kept MLP neurons (the MLP width
zero-padded to a multiple of `neuron_multiple`), so the forward runs the
shrunk model's real MACs. Weights keep the JAX package's (in, out) layout,
so x @ kernel is the same product as jnp.dot(x, kernel).

fast_math (the serving default) deviates from the strict numerics in two
ways, as in the JAX package: the tanh GELU, and LayerNorm statistics in the
compute dtype. Attention softmax is f32 under every flag.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from devit_tpu_torch.configs import ViTConfig
from devit_tpu_torch.device import DeviceLike, resolve_device
from devit_tpu_torch.kernels.attention import fused_attention, reference_attention
from devit_tpu_torch.models.vit import Gates, fast_gelu, gelu_tanh, layer_norm


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _frozen(a) -> nn.Parameter:
    return nn.Parameter(torch.tensor(np.asarray(a, np.float32)), requires_grad=False)


class CompactLayer(nn.Module):
    """One ragged block: `num_heads` kept heads, exact MLP width."""

    def __init__(self, lp: dict, num_heads: int):
        super().__init__()
        self.num_heads = int(num_heads)  # static Python int, sets the kernel's shape
        self.norm1_scale = _frozen(lp["norm1"]["scale"])
        self.norm1_bias = _frozen(lp["norm1"]["bias"])
        self.qkv_kernel = _frozen(lp["qkv_kernel"])
        self.qkv_bias = _frozen(lp["qkv_bias"]) if "qkv_bias" in lp else None
        self.proj_kernel = _frozen(lp["proj_kernel"])
        self.proj_bias = _frozen(lp["proj_bias"])
        self.norm2_scale = _frozen(lp["norm2"]["scale"])
        self.norm2_bias = _frozen(lp["norm2"]["bias"])
        self.fc1_kernel = _frozen(lp["fc1_kernel"])
        self.fc1_bias = _frozen(lp["fc1_bias"])
        self.fc2_kernel = _frozen(lp["fc2_kernel"])
        self.fc2_bias = _frozen(lp["fc2_bias"])


class CompactViT(nn.Module):
    """Deployment artifact: embedding, ragged layers and classifier head(s)."""

    def __init__(self, embed: dict, layers: Sequence[Tuple[dict, int]], head: dict,
                 *, head_dim: int, distilled: bool, eps: float):
        super().__init__()
        self.head_dim = head_dim
        self.distilled = distilled
        self.eps = eps
        self.patch_kernel = _frozen(embed["patch_kernel"])
        self.patch_bias = _frozen(embed["patch_bias"])
        self.cls_token = _frozen(embed["cls_token"])
        self.dist_token = _frozen(embed["dist_token"]) if distilled else None
        self.pos_embed = _frozen(embed["pos_embed"])
        self.norm_scale = _frozen(embed["norm"]["scale"])
        self.norm_bias = _frozen(embed["norm"]["bias"])
        self.layers = nn.ModuleList(CompactLayer(lp, kh) for lp, kh in layers)
        self.head = nn.ParameterDict(
            {f"{name}_{k}": _frozen(head[name][k])
             for name in ("head", "head_dist") if name in head
             for k in ("kernel", "bias")})

    @property
    def num_heads(self) -> List[int]:
        return [lp.num_heads for lp in self.layers]


def compact_vit_ragged(
    params: dict,
    gates: Gates,
    cfg: ViTConfig,
    *,
    neuron_multiple: int = 128,
    device: DeviceLike = None,
) -> CompactViT:
    """Gather kept heads/neurons per layer into exact-width weights.

    params: the flax parameter tree of a gated VisionTransformer as a nested
    dict of numpy arrays; gates: binary (0/1) head and neuron masks. The MLP
    width is zero-padded to a multiple of `neuron_multiple`.
    """
    dev = resolve_device(device)
    head = np.asarray(gates.head)
    neuron = np.asarray(gates.neuron)
    if not (np.isin(head, (0.0, 1.0)).all() and np.isin(neuron, (0.0, 1.0)).all()):
        # compaction DROPS pruned slots: a fractional gate would scale
        # activations in the gated model but be rounded to keep/drop here
        raise ValueError("compact_vit_ragged requires binary (0/1) gates")
    if cfg.representation_size:
        raise NotImplementedError(
            "compact_vit_ragged does not carry the pre_logits "
            "(representation_size) head")
    L, H = head.shape
    hidden = neuron.shape[1]
    C = cfg.embed_dim
    dh = cfg.head_dim

    blocks = params["blocks"]
    qkv_k = np.asarray(blocks["qkv"]["kernel"]).reshape(L, C, 3, H, dh)
    qkv_b = blocks["qkv"].get("bias")
    if qkv_b is not None:
        qkv_b = np.asarray(qkv_b).reshape(L, 3, H, dh)
    proj_k = np.asarray(blocks["proj"]["kernel"]).reshape(L, H, dh, C)
    arr = lambda name, key: np.asarray(blocks[name][key])

    layers = []
    for l in range(L):
        hi = np.nonzero(head[l])[0]
        ni = np.nonzero(neuron[l])[0]
        # a layer with no kept head keeps one all-zero dummy head
        kh = max(len(hi), 1)
        kn = max(min(_round_up(len(ni), neuron_multiple), hidden), 1)
        # pad with arbitrary extra indices but zero their weights
        hi_pad = np.concatenate([hi, np.zeros(kh - len(hi), np.int64)])
        ni_pad = np.concatenate([ni, np.zeros(kn - len(ni), np.int64)])
        h_mask = (np.arange(kh) < len(hi)).astype(np.float32)
        n_mask = (np.arange(kn) < len(ni)).astype(np.float32)
        lp = {
            "norm1": {k: arr("norm1", k)[l] for k in ("scale", "bias")},
            "norm2": {k: arr("norm2", k)[l] for k in ("scale", "bias")},
            "qkv_kernel": (qkv_k[l][:, :, hi_pad] * h_mask[None, None, :, None])
            .reshape(C, 3 * kh * dh),
            "proj_kernel": proj_k[l][hi_pad].reshape(kh * dh, C)
            * np.repeat(h_mask, dh)[:, None],
            "proj_bias": arr("proj", "bias")[l],
            "fc1_kernel": arr("fc1", "kernel")[l][:, ni_pad] * n_mask[None, :],
            "fc1_bias": arr("fc1", "bias")[l][ni_pad] * n_mask,
            "fc2_kernel": arr("fc2", "kernel")[l][ni_pad] * n_mask[:, None],
            "fc2_bias": arr("fc2", "bias")[l],
        }
        if qkv_b is not None:
            lp["qkv_bias"] = (qkv_b[l][:, hi_pad] * h_mask[None, :, None]).reshape(3 * kh * dh)
        layers.append((lp, kh))

    embed = {
        "patch_kernel": params["patch_embed"]["kernel"],
        "patch_bias": params["patch_embed"]["bias"],
        "cls_token": params["cls_token"],
        "pos_embed": params["pos_embed"],
        "norm": params["norm"],
    }
    if cfg.distilled:
        embed["dist_token"] = params["dist_token"]
    head_p = {name: params[name] for name in ("head", "head_dist") if name in params}
    model = CompactViT(embed, layers, head_p, head_dim=dh,
                       distilled=cfg.distilled, eps=cfg.layer_norm_eps)
    return model.to(dev)


def compact_forward(
    model: CompactViT,
    x: torch.Tensor,  # (B, H, W, 3)
    *,
    patch_size: int,
    dtype: torch.dtype = torch.bfloat16,
    use_kernel: bool = True,
    fast_math: bool = True,
    features_only: bool = False,
):
    """Inference forward over ragged layers. Returns logits, or the
    (cls, dist) features with features_only (dist is None if undistilled).

    use_kernel: attention through `fused_attention` (the CUDA kernel on a
    CUDA tensor); False takes `reference_attention`.
    """
    stat = dtype if fast_math else torch.float32
    attention = fused_attention if use_kernel else reference_attention
    gelu = gelu_tanh if fast_math else fast_gelu
    w = lambda p: p.to(dtype)

    B, Hh, Ww, Cin = x.shape
    g = Hh // patch_size
    xp = x.reshape(B, g, patch_size, g, patch_size, Cin)
    xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, -1).to(dtype)
    t = torch.matmul(xp, w(model.patch_kernel)) + w(model.patch_bias)
    C = t.shape[-1]
    toks = [w(model.cls_token).expand(B, 1, C)]
    if model.distilled:
        toks.append(w(model.dist_token).expand(B, 1, C))
    t = torch.cat(toks + [t], dim=1) + w(model.pos_embed)

    for lp in model.layers:
        h = layer_norm(t, lp.norm1_scale, lp.norm1_bias, model.eps, stat)
        qkv = torch.matmul(h, w(lp.qkv_kernel))
        if lp.qkv_bias is not None:
            qkv = qkv + w(lp.qkv_bias)
        att = attention(qkv, None, num_heads=lp.num_heads)
        att = torch.matmul(att, w(lp.proj_kernel)) + w(lp.proj_bias)
        t = t + att
        h = layer_norm(t, lp.norm2_scale, lp.norm2_bias, model.eps, stat)
        h = torch.matmul(h, w(lp.fc1_kernel)) + w(lp.fc1_bias)
        h = gelu(h)
        h = torch.matmul(h, w(lp.fc2_kernel)) + w(lp.fc2_bias)
        t = t + h

    t = layer_norm(t, model.norm_scale, model.norm_bias, model.eps, stat)
    cls_feat = t[:, 0]
    dist_feat = t[:, 1] if model.distilled else None
    if features_only or not len(model.head):
        return cls_feat, dist_feat
    hp = model.head
    logits = (torch.matmul(cls_feat, w(hp["head_kernel"])) + w(hp["head_bias"])).float()
    if model.distilled and "head_dist_kernel" in hp:
        d = (torch.matmul(dist_feat, w(hp["head_dist_kernel"]))
             + w(hp["head_dist_bias"])).float()
        logits = (logits + d) / 2.0
    return logits


def stack_division_features(cms: Sequence[CompactViT], images: torch.Tensor, *,
                            patch_size: int, dtype: torch.dtype = torch.bfloat16,
                            use_kernel: bool = True, fast_math: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run every compact division on the same batch and stack the token
    features division-major: (cls (D, B, C), dist (D, B, C) or None)."""
    feats = [compact_forward(cm, images, patch_size=patch_size, dtype=dtype,
                             use_kernel=use_kernel, fast_math=fast_math,
                             features_only=True) for cm in cms]
    cls_stack = torch.stack([c for c, _ in feats])
    dist_stack = (None if feats[0][1] is None
                  else torch.stack([d for _, d in feats]))
    return cls_stack, dist_stack
