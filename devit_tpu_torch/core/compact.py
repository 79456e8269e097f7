"""Structural compaction: physically remove pruned heads and neurons
(counterpart of devit_tpu/core/compact.py).

Given a VisionTransformer's parameters and binary gates, gather the kept
attention heads and MLP neurons into dense, smaller weights. The compacted
model computes what the gated model computes, but runs the reduced MACs.

Ragged per-layer kept counts are padded to the per-model maximum (the MLP
width rounded up to `neuron_multiple`) with zero weights, so every layer has
one geometry: a padded head has zero q/k/v weights and bias and zero proj
rows, a padded neuron a zero fc1 column and bias and a zero fc2 row, so
neither contributes. The result loads into `VisionTransformer(new_cfg)`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from devit_tpu_torch.configs import ViTConfig
from devit_tpu_torch.models.compact_vit import _round_up
from devit_tpu_torch.models.vit import Gates


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return {k: v.detach() for k, v in params.named_parameters()}
    return dict(params)


def compact_vit_params(
    params,
    gates: Gates,
    cfg: ViTConfig,
    *,
    head_multiple: int = 1,
    neuron_multiple: int = 128,
    min_keep_heads: Optional[int] = None,
    min_keep_neurons: Optional[int] = None,
) -> Tuple[dict, ViTConfig]:
    """Gather kept heads/neurons into compact shapes.

    params: a VisionTransformer, or a mapping of its parameter names to
    tensors; gates: (L, H) / (L, hidden) binary masks (numpy or tensors).
    Returns ({parameter name: tensor} for VisionTransformer(new_cfg), new_cfg
    with num_heads, hidden_override and head_dim_override set). Tensors stay
    on the parameters' device and dtype; every kept value is copied exactly.
    """
    head, neuron = gates.numpy()
    if not (np.isin(head, (0.0, 1.0)).all() and np.isin(neuron, (0.0, 1.0)).all()):
        # compaction drops pruned slots: a fractional gate, which scales
        # activations in the gated model, would silently round to keep/drop
        raise ValueError("compact_vit_params requires binary (0/1) gates")
    L, H = head.shape
    _, hidden = neuron.shape
    dh = cfg.head_dim
    C = cfg.embed_dim

    keep_h = max(int(head.sum(-1).max()), 1)
    keep_n = max(int(neuron.sum(-1).max()), 1)
    if min_keep_heads:
        keep_h = max(keep_h, min_keep_heads)
    if min_keep_neurons:
        keep_n = max(keep_n, min_keep_neurons)
    keep_h = min(_round_up(keep_h, head_multiple), H)
    keep_n = min(_round_up(keep_n, neuron_multiple), hidden)

    p = _named(params)
    out = dict(p)
    for l in range(L):
        pre = f"blocks.{l}."
        hi = torch.as_tensor(np.nonzero(head[l])[0], device=p[pre + "qkv.kernel"].device)
        ni = torch.as_tensor(np.nonzero(neuron[l])[0], device=hi.device)
        n_h, n_n = len(hi), len(ni)

        qkv_k = p[pre + "qkv.kernel"].reshape(C, 3, H, dh)
        new = qkv_k.new_zeros((C, 3, keep_h, dh))
        new[:, :, :n_h] = qkv_k[:, :, hi]
        out[pre + "qkv.kernel"] = new.reshape(C, 3 * keep_h * dh)
        if pre + "qkv.bias" in p:
            qkv_b = p[pre + "qkv.bias"].reshape(3, H, dh)
            new = qkv_b.new_zeros((3, keep_h, dh))
            new[:, :n_h] = qkv_b[:, hi]
            out[pre + "qkv.bias"] = new.reshape(3 * keep_h * dh)
        proj_k = p[pre + "proj.kernel"].reshape(H, dh, C)
        new = proj_k.new_zeros((keep_h, dh, C))
        new[:n_h] = proj_k[hi]
        out[pre + "proj.kernel"] = new.reshape(keep_h * dh, C)

        fc1_k, fc1_b, fc2_k = (p[pre + k] for k in ("fc1.kernel", "fc1.bias", "fc2.kernel"))
        new = fc1_k.new_zeros((C, keep_n))
        new[:, :n_n] = fc1_k[:, ni]
        out[pre + "fc1.kernel"] = new
        new = fc1_b.new_zeros((keep_n,))
        new[:n_n] = fc1_b[ni]
        out[pre + "fc1.bias"] = new
        new = fc2_k.new_zeros((keep_n, C))
        new[:n_n] = fc2_k[ni]
        out[pre + "fc2.kernel"] = new

    new_cfg = cfg.replace(num_heads=keep_h, hidden_override=keep_n, head_dim_override=dh)
    return out, new_cfg


def compact_divisions(
    params_list: Sequence,
    gates_list: Sequence[Gates],
    cfg: ViTConfig,
    **kw,
) -> Tuple[List[dict], ViTConfig]:
    """Compact every division to ONE common (max over divisions) geometry."""
    heads, neurons = zip(*(g.numpy() for g in gates_list))
    # the cross-division max is a floor, not a default: an explicit min_keep_*
    # below some division's kept count would otherwise give each division its
    # own geometry while the returned config names only the last one's
    kw["min_keep_heads"] = max(kw.get("min_keep_heads") or 0,
                               max(int(h.sum(-1).max()) for h in heads))
    kw["min_keep_neurons"] = max(kw.get("min_keep_neurons") or 0,
                                 max(int(n.sum(-1).max()) for n in neurons))
    out, final_cfg = [], None
    for p, g in zip(params_list, gates_list):
        cp, final_cfg = compact_vit_params(p, g, cfg, **kw)
        out.append(cp)
    return out, final_cfg
