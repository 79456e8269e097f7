"""Gate building from importance ranks (counterpart of
devit_tpu/core/rank.py:93-121; the HSIC ranking comes with the shrink
slice)."""

from __future__ import annotations

import numpy as np

from devit_tpu_torch.models.vit import Gates


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
