"""MACs-constrained sparsity-policy sampling (counterpart of
devit_tpu/core/shrink.py:33-72; the batched candidate evaluation comes with
the shrink slice)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from devit_tpu_torch.core.metrics import cal_shrink_macs


def screen(
    macs_target: float,
    population: int,
    lb: float,
    ub: float,
    layer: int,
    *,
    emb: int = 384,
    head: int = 6,
    seq_length: int = 197,
    mlp_ratio: float = 4,
    seed: Optional[int] = None,
) -> list:
    """Rejection-sample `population` sparsity vectors (2*layer dims) whose MACs
    are within 2% of macs_target. Same generator and draw order as the JAX
    package, so a seed gives the same policies."""
    rng = np.random.default_rng(seed)
    res: list = []
    n_params = layer * 2
    max_tries = max(population * 200000, 1000000)
    tries = 0
    while len(res) < population:
        tries += 1
        if tries > max_tries:
            full = cal_shrink_macs([0.0] * layer, [0.0] * layer, emb=emb,
                                   mlp_ratio=mlp_ratio, seq_length=seq_length,
                                   head=head, layer=layer)
            raise RuntimeError(
                f"screen(): no MACs-feasible policies after {tries} samples — "
                f"target {macs_target:.3f}G unreachable for this geometry "
                f"(full model = {full:.3f}G)")
        ratio = rng.uniform(lb, ub, size=(n_params,)).tolist()
        macs = cal_shrink_macs(
            neuron_sparsity=ratio[:layer], head_sparsity=ratio[layer:],
            emb=emb, mlp_ratio=mlp_ratio, seq_length=seq_length, head=head, layer=layer,
        )
        if abs(macs - macs_target) <= 0.02 * macs_target and ratio not in res:
            res.append(ratio)
    return res
