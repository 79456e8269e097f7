"""Everything a cell's inputs are made of, drawn from its seed: weights,
shrink gates, images and batches.

Weights are drawn on the device in one call, float32 (the type in which
both programs keep them), one flat normal vector split into the leaves of
`reference.model.leaf_shapes`: kernels, biases and tokens N(0, 0.02),
LayerNorm scales 1 + N(0, 0.02). The benchmark makes them and hands the same
values to the program under test and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_STREAMS = {"weights": 1, "gates": 2, "images": 3, "traffic": 4, "draws": 5, "sample": 6}


def sub_seed(seed: int, stream: str) -> int:
    """A seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + _STREAMS[stream]) % (2 ** 63)


def generator(seed: int, stream: str, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def seeded_leaves(shapes: Dict[str, Tuple[int, ...]], seed: int, device, *,
                  host: bool = False, std: float = 0.02) -> dict:
    """The leaves of `shapes`, drawn in one call on `device`; with host=True
    brought to the host in one copy, as numpy arrays."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                       device=device) * std
    if host:
        flat = flat.cpu().numpy()
    leaves, off = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        t = flat[off:off + n].reshape(shape)
        leaves[name] = t + 1.0 if name.endswith(".scale") else t
        off += n
    return leaves


def policy_gates(policy: dict, depth: int, heads: int, hidden: int, seed: int
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One (head (L, H), neuron (L, hidden)) pair of 0/1 float32 masks per
    division: layer l keeps policy["heads"][d][l] heads and
    policy["neurons"][d][l] neurons, the ones a seeded random rank puts
    first (the shrink's importance ranks, drawn)."""
    g = generator(seed, "gates")
    out = []
    for kh_row, kn_row in zip(policy["heads"], policy["neurons"]):
        if len(kh_row) != depth or len(kn_row) != depth:
            raise ValueError(f"a policy row has {len(kh_row)}/{len(kn_row)} layers, "
                             f"the model {depth}")
        head = np.zeros((depth, heads), np.float32)
        neuron = np.zeros((depth, hidden), np.float32)
        for l in range(depth):
            head[l, torch.randperm(heads, generator=g)[:kh_row[l]].numpy()] = 1.0
            neuron[l, torch.randperm(hidden, generator=g)[:kn_row[l]].numpy()] = 1.0
        out.append((head, neuron))
    return out


def flax_tree(leaves: Dict[str, np.ndarray], depth: int) -> dict:
    """Per-layer leaves -> the nested parameter tree (blocks stacked on a
    leading depth axis) that the port's compaction takes."""
    blocks = {}
    for mod, key in (("norm1", "scale"), ("norm1", "bias"), ("qkv", "kernel"), ("qkv", "bias"),
                     ("proj", "kernel"), ("proj", "bias"), ("norm2", "scale"), ("norm2", "bias"),
                     ("fc1", "kernel"), ("fc1", "bias"), ("fc2", "kernel"), ("fc2", "bias")):
        blocks.setdefault(mod, {})[key] = np.stack(
            [leaves[f"blocks.{i}.{mod}.{key}"] for i in range(depth)])
    tree = {"blocks": blocks,
            "patch_embed": {"kernel": leaves["patch_embed.kernel"],
                            "bias": leaves["patch_embed.bias"]},
            "cls_token": leaves["cls_token"], "pos_embed": leaves["pos_embed"],
            "norm": {"scale": leaves["norm.scale"], "bias": leaves["norm.bias"]}}
    if "dist_token" in leaves:
        tree["dist_token"] = leaves["dist_token"]
    return tree


def image_pool(count: int, side: int, seed: int, device) -> np.ndarray:
    """`count` uint8 RGB images (count, side, side, 3), drawn on the device
    and brought to the host once."""
    g = generator(seed, "images", device)
    return torch.randint(0, 256, (count, side, side, 3), generator=g, device=device,
                         dtype=torch.uint8).cpu().numpy()


def train_batches(count: int, batch: int, side: int, classes: int, seed: int, device
                  ) -> Sequence[Tuple[torch.Tensor, torch.Tensor]]:
    """`count` distinct batches of normalised bfloat16 images and labels,
    made on the device."""
    g = generator(seed, "images", device)
    images = torch.randn((count, batch, side, side, 3), generator=g, device=device,
                         dtype=torch.bfloat16)
    labels = torch.randint(0, classes, (count, batch), generator=g, device=device)
    return [(images[i], labels[i]) for i in range(count)]
