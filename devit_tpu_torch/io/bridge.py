"""Carry parameters of the JAX package into the port's modules.

Inputs are the flax parameter trees as nested dicts of arrays (numpy, or
anything np.asarray takes); the port copies them as float32, bit for bit.
Reading the JAX package's .msgpack artifacts waits for a later slice.
"""

from __future__ import annotations

import numpy as np

from devit_tpu_torch.configs import ViTConfig
from devit_tpu_torch.device import DeviceLike, resolve_device
from devit_tpu_torch.models.compact_vit import CompactViT, compact_vit_ragged
from devit_tpu_torch.models.ensemble import EnsMLP
from devit_tpu_torch.models.vit import Gates, map_leaves


def compact_from_jax_params(params_np: dict, gates_np, cfg: ViTConfig, *,
                            device: DeviceLike = None, **kw) -> CompactViT:
    """A gated VisionTransformer's flax params + its (head, neuron) gates ->
    the port's ragged CompactViT. `kw` goes to compact_vit_ragged."""
    params = map_leaves(lambda a: np.asarray(a, np.float32), params_np)
    head, neuron = gates_np
    gates = Gates(head=np.asarray(head, np.float32), neuron=np.asarray(neuron, np.float32))
    return compact_vit_ragged(params, gates, cfg, device=device, **kw)


def ensmlp_from_jax_params(ens_params_np: dict, *, num_divisions: int, dtype=None,
                           device: DeviceLike = None) -> EnsMLP:
    """A flax EnsMLP `params` tree -> the port's EnsMLP. The fusion geometry
    (classes, teacher width, family) is read from the tree's own shapes."""
    dev = resolve_device(device)
    kc = np.asarray(ens_params_np["cls_classifier"]["kernel"])
    fused = (np.asarray(ens_params_np["cls_mlp"]["kernel"]).shape[0]
             if "cls_mlp" in ens_params_np else kc.shape[0])
    if fused % num_divisions:
        raise ValueError(f"fused width {fused} is not a multiple of "
                         f"num_divisions={num_divisions}")
    kw = {} if dtype is None else {"dtype": dtype}
    ens = EnsMLP(num_classes=int(kc.shape[1]), sub_size=fused // num_divisions,
                 num_divisions=num_divisions,
                 teacher_size=int(kc.shape[0]) if "cls_mlp" in ens_params_np else None,
                 family="deit" if "dist_classifier" in ens_params_np else "vit", **kw)
    return ens.load_params(ens_params_np).to(dev)
