"""Importance ranking of MLP neurons and attention heads, and gate building
(counterpart of devit_tpu/core/rank.py).

- Neuron score: on ONE training batch, per neuron,
  0.1 * minmax(HSIC(neuron activations over tokens, softmax logits))
  + 0.9 * minmax(sum |activation|); rank = argsort ascending.
- Head score: per head, HSIC relevance of the channel-mean head output vs
  the softmax logits, minus 0.1 * the mean pairwise RBF-HSIC redundancy
  against the other heads; rank = argsort ascending.
- Masks keep the top int(width * (1 - ratio)) entries.

The scores are computed on the model's device (core/hsic.py, every layer's
candidates in one batched product); `_minmax` and the argsort run on the
host in numpy, as the JAX package does: torch.argsort breaks ties
differently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from devit_tpu_torch.core.hsic import at_least_f32, hsic_redundancy_matrix, hsic_relevance_many
from devit_tpu_torch.models.vit import Gates


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = np.min(x), np.max(x)
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)


def _neuron_scores(neuron_act: torch.Tensor,
                   probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, B, N, hidden), (B, K) -> HSIC scores (L, hidden), activation sums
    (L, hidden), f32 (f64 for f64 inputs) on the activations' device."""
    hs, acts = [], []
    for act_l in neuron_act:
        act_l = at_least_f32(act_l)
        hs.append(hsic_relevance_many(act_l.permute(2, 0, 1), probs))  # (hidden, B, N)
        acts.append(act_l.abs().sum(dim=(0, 1)))
    return torch.stack(hs), torch.stack(acts)


def _head_scores(head_out: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """(L, B, N, H, dh), (B, K) -> combined scores (L, H)."""
    out = []
    for ho_l in head_out:
        xs = at_least_f32(ho_l).mean(dim=-1).permute(2, 0, 1)  # channel-mean, (H, B, N)
        rel = hsic_relevance_many(xs, probs)
        red = hsic_redundancy_matrix(xs)
        H = xs.shape[0]
        # H = 1: no other head to be redundant with, so the redundancy is 0,
        # not the 0/0 NaN that would give argsort garbage ranks
        off_diag_mean = (red.sum(dim=1) - torch.diagonal(red)) / max(H - 1, 1)
        out.append(rel - 0.1 * off_diag_mean)
    return torch.stack(out)


def neuron_rank_scores(hsic_s: np.ndarray, act_s: np.ndarray) -> np.ndarray:
    """Per-layer combined neuron scores from _neuron_scores' two outputs."""
    return np.stack([0.1 * _minmax(h) + 0.9 * _minmax(a) for h, a in zip(hsic_s, act_s)])


def _capture(model, images: torch.Tensor, gates: Optional[Gates]):
    with torch.no_grad():
        out = model(images, gates, capture_rank_stats=True)
        return out, torch.softmax(out.logits.float(), dim=-1)


def mlp_neuron_rank(model, images: torch.Tensor, gates: Optional[Gates] = None) -> np.ndarray:
    """Rank neurons per layer, ascending importance: (L, hidden) int array.
    One capture forward of `model` (a VisionTransformer) on one batch."""
    out, probs = _capture(model, images, gates)
    with torch.no_grad():
        hsic_s, act_s = _neuron_scores(out.neuron_act, probs)
    return np.argsort(neuron_rank_scores(hsic_s.cpu().numpy(), act_s.cpu().numpy()), axis=-1)


def attn_head_rank(model, images: torch.Tensor, gates: Optional[Gates] = None) -> np.ndarray:
    """Rank heads per layer, ascending importance: (L, H) int array."""
    out, probs = _capture(model, images, gates)
    with torch.no_grad():
        scores = _head_scores(out.head_out, probs)
    return np.argsort(scores.cpu().numpy(), axis=-1)


def _mask_from_rank(rank_row: np.ndarray, width: int, ratio: float) -> np.ndarray:
    """Keep the top int(width*(1-ratio)) by importance (imp_rank.py:55-58)."""
    num_keep = int(width * (1.0 - ratio))
    keep = rank_row[::-1][:num_keep]
    mask = np.zeros(width, dtype=np.float32)
    mask[keep] = 1.0
    return mask


def build_gates(
    neuron_rank: np.ndarray,
    head_rank: np.ndarray,
    neuron_sparsity,
    head_sparsity,
) -> Gates:
    """Per-layer sparsity vectors + ranks -> Gates of float32 numpy masks.

    neuron_rank: (L, hidden); head_rank: (L, H); sparsities: length-L
    sequences of pruned fractions.
    """
    L, hidden = neuron_rank.shape
    _, H = head_rank.shape
    neuron = np.stack(
        [_mask_from_rank(neuron_rank[l], hidden, float(neuron_sparsity[l])) for l in range(L)]
    )
    head = np.stack(
        [_mask_from_rank(head_rank[l], H, float(head_sparsity[l])) for l in range(L)]
    )
    return Gates(head=head, neuron=neuron)


def check_sparsity(gates: Gates) -> Tuple[np.ndarray, np.ndarray]:
    """Fraction pruned per layer: (neuron, head)."""
    head, neuron = gates.numpy()
    return (neuron == 0).mean(axis=-1), (head == 0).mean(axis=-1)
