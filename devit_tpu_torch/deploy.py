"""The canonical deployed artifacts: 4 shrunk dedeit divisions + EnsMLP
(counterpart of bench.py:125-175 in the JAX package).

Each division is shrunk with the reference's canonical policy search
settings (shrink ratio 0.3, MACs within 2% of 0.3 x 9.19 GMACs, seeds
42..45), gated from seeded random ranks, and compacted into ragged layers.
The division weights are random, drawn with numpy in the flax tree's leaf
order, so they are bit-identical to the JAX package's. The fusion head is
drawn here from its own numpy seed (the JAX package draws it with
jax.random, which the port cannot reproduce).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from devit_tpu_torch.configs import ViTConfig, get_vit_config
from devit_tpu_torch.core.metrics import DEDEIT_FULL_GMACS
from devit_tpu_torch.core.rank import build_gates
from devit_tpu_torch.core.shrink import screen
from devit_tpu_torch.device import DeviceLike, resolve_device
from devit_tpu_torch.models.compact_vit import CompactViT, compact_vit_ragged
from devit_tpu_torch.models.ensemble import EnsMLP
from devit_tpu_torch.models.vit import Gates, map_leaves, vit_param_shapes

SHRINK_RATIO = 0.3
ENS_SEED = 9


def build_inputs(num_div: int = 4) -> Tuple[ViTConfig, List[dict], List[Gates]]:
    """Canonical shrink policies, gates and raw division params (numpy).
    Returns (cfg, params_list, gates_list)."""
    cfg = get_vit_config("dedeit", num_classes=25)
    rngnp = np.random.default_rng(0)
    # first MACs-feasible sample per division
    policies = [screen(SHRINK_RATIO * DEDEIT_FULL_GMACS, 1, 0.0, 0.9, cfg.depth,
                       seed=42 + i)[0] for i in range(num_div)]
    n_rank = np.stack([rngnp.permutation(cfg.hidden_dim) for _ in range(cfg.depth)])
    h_rank = np.stack([rngnp.permutation(cfg.num_heads) for _ in range(cfg.depth)])
    gates_list = [build_gates(n_rank, h_rank, p[: cfg.depth], p[cfg.depth:])
                  for p in policies]
    shapes = vit_param_shapes(cfg)

    def make_params(seed):
        rng = np.random.default_rng(seed)
        return map_leaves(
            lambda s: rng.normal(scale=0.02, size=s).astype(np.float32), shapes)

    return cfg, [make_params(i) for i in range(num_div)], gates_list


def init_ensmlp(ens: EnsMLP, seed: int) -> EnsMLP:
    """Random fusion weights: kernels ~ N(0, 0.02), zero biases (the flax
    initialisers' distributions), drawn with numpy in sorted name order."""
    rng = np.random.default_rng(seed)
    params = {name: {"kernel": rng.normal(scale=0.02, size=tuple(m.kernel.shape)),
                     "bias": np.zeros(tuple(m.bias.shape))}
              for name, m in sorted(ens.named_children())}
    return ens.load_params(params)


def build_artifacts(num_div: int = 4, device: DeviceLike = None
                    ) -> Tuple[ViTConfig, List[CompactViT], EnsMLP]:
    """The canonical deployed ensemble on `device` (cuda by default):
    (cfg, compact divisions, EnsMLP with teacher_size 768, 100 classes)."""
    dev = resolve_device(device)
    cfg, params, gates_list = build_inputs(num_div)
    cms = [compact_vit_ragged(p, g, cfg, device=dev) for p, g in zip(params, gates_list)]
    ens = EnsMLP(num_classes=100, sub_size=cfg.embed_dim, num_divisions=num_div,
                 teacher_size=768, family="deit")
    return cfg, cms, init_ensmlp(ens, ENS_SEED).to(dev)
