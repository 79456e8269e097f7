"""Analytic parameter counts, FLOPs and MACs under head & neuron sparsity
(counterpart of devit_tpu/core/metrics.py). The int() floors on kept widths
match the reference (core/compute_metric.py:1-69) exactly, so policy
searches land on the same MACs-feasible set."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch


def cal_shrink_paras(
    neuron_sparsity: Sequence[float],
    head_sparsity: Sequence[float],
    emb: int = 768,
    seq_length: int = 197,
    mlp_ratio: float = 4,
    head: int = 12,
    layer: int = 12,
    num_class: int = 1000,
) -> float:
    """Parameter count in millions."""
    if len(head_sparsity) != layer:
        raise ValueError("head sparsity length != layer count")

    paras = 0.0
    channel = 3
    patch_size = 16
    head_dim = emb / head
    # embedding: patch conv + bias, pos embed, cls token
    paras += emb * channel * patch_size ** 2 + emb + seq_length * emb + emb

    ln = 2 * emb
    for n_s, h_s in zip(neuron_sparsity, head_sparsity):
        shrink_head = int((1 - h_s) * head)
        mhsa = shrink_head * 3 * emb * head_dim + shrink_head * head_dim * emb + emb
        mlp = 2 * emb * int(mlp_ratio * (1 - n_s) * emb) + emb + int(mlp_ratio * (1 - n_s) * emb)
        paras += ln + mhsa + ln + mlp

    cls = emb * num_class + num_class
    paras += ln + cls
    return paras / 1e6


def cal_shrink_flops(
    neuron_sparsity: Sequence[float],
    head_sparsity: Sequence[float],
    emb: int = 768,
    seq_length: int = 197,
    mlp_ratio: float = 4,
    head: int = 12,
    layer: int = 12,
    num_class: int = 1000,
) -> float:
    """FLOPs in G (softmax and norms neglected)."""
    if len(head_sparsity) != layer:
        raise ValueError("head sparsity length != layer count")

    flops = 0.0
    channel = 3
    img_size = 224
    head_dim = emb / head
    flops += 2 * channel * emb * img_size ** 2

    for n_s, h_s in zip(neuron_sparsity, head_sparsity):
        sa = (
            3 * 2 * seq_length * emb * head_dim
            + 2 * head_dim * seq_length ** 2
            + 2 * head_dim * seq_length ** 2
        )
        shrink_head = int((1 - h_s) * head)
        mhsa = sa * shrink_head + seq_length * 2 * head_dim * shrink_head * emb
        mlp = (
            seq_length * int(mlp_ratio * (1 - n_s) * emb) * 2 * emb
            + seq_length * emb * 2 * int(mlp_ratio * (1 - n_s) * emb)
        )
        flops += mhsa + mlp

    flops += 2 * emb * num_class
    return flops / 1e9


def cal_shrink_macs(
    neuron_sparsity: Sequence[float],
    head_sparsity: Sequence[float],
    emb: int = 768,
    seq_length: int = 197,
    mlp_ratio: float = 4,
    head: int = 12,
    layer: int = 12,
    num_class: int = 1000,
) -> float:
    """MACs in G = FLOPs / 2."""
    return cal_shrink_flops(
        neuron_sparsity, head_sparsity, emb, seq_length, mlp_ratio, head, layer, num_class
    ) / 2


# the reference's full dedeit cost anchor (shrink_imp.py:144): targets are
# ratio * 9.19 GMACs
DEDEIT_FULL_GMACS = 9.19


def count_params_brute(params) -> int:
    """Exact parameter count of a module, or of a mapping (nested or flat) of
    tensors or arrays, for testing the analytic formula."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, Mapping):
        return sum(count_params_brute(v) for v in params.values())
    if isinstance(params, torch.Tensor):
        return params.numel()
    return int(np.asarray(params).size)
