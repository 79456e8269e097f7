"""Carry parameters of the JAX package into the port's modules.

Inputs are the flax parameter trees as nested dicts of arrays (numpy, or
anything np.asarray takes, or the torch tensors io/checkpoint.py reads for
bfloat16 leaves); the port copies them as float32, bit for bit.

A VisionTransformer's tree (and a CCT's, and a TextCCT's classifier) is
scan-stacked: every `blocks/*` leaf carries a leading depth axis, which the
port's `blocks.<i>.*` parameters split. The ensemble's division-stacked
tree (init_multivit) puts the division axis in front of that: a `blocks/*`
leaf is (D, depth, ...), the port's stacked `blocks.<i>.*` entry (D, ...).
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from devit_tpu_torch.configs import CCTConfig, ViTConfig
from devit_tpu_torch.device import DeviceLike, resolve_device
from devit_tpu_torch.models.cct import CCT
from devit_tpu_torch.models.compact_vit import CompactViT, compact_vit_ragged
from devit_tpu_torch.models.ensemble import EnsMLP
from devit_tpu_torch.models.text import TextCCT
from devit_tpu_torch.models.vit import Gates, VisionTransformer, map_leaves


def _flax_path(name: str):
    """Port parameter name -> (flax tree path, layer index or None): the
    index after a `blocks` part is the scanned layer's (`blocks.<i>.*` of a
    ViT or CCT, `classifier.blocks.<i>.*` of a TextCCT)."""
    parts = name.split(".")
    if "blocks" in parts:
        i = parts.index("blocks")
        return parts[:i + 1] + parts[i + 2:], int(parts[i + 1])
    return parts, None


def vit_from_jax_params(params_np: dict, cfg: ViTConfig, *, device: DeviceLike = None,
                        **model_kw) -> VisionTransformer:
    """A flax VisionTransformer `params` tree -> the port's module (f32, bit
    for bit). `model_kw` goes to VisionTransformer (dtype, use_kernel, ...)."""
    return _load_module(VisionTransformer(cfg, **model_kw), params_np, device)


def cct_from_jax_params(params_np: dict, cfg: CCTConfig, *, device: DeviceLike = None,
                        **model_kw) -> CCT:
    """A flax CCT `params` tree -> the port's CCT (f32, bit for bit).
    `model_kw` goes to CCT (dtype). The inverse is vit_to_jax_params, which
    takes any module with the flax names, and the stacked and `values`
    converters below serve both families alike."""
    return _load_module(CCT(cfg, **model_kw), params_np, device)


def text_from_jax_params(params_np: dict, *, device: DeviceLike = None,
                         dtype: torch.dtype = torch.bfloat16, module: type = TextCCT,
                         **text_kw) -> torch.nn.Module:
    """A flax text-stack `params` tree -> the port's module (f32, bit for
    bit): `module` is TextCCT by default, or any class of models/text.py
    (Embedder, TextTokenizer, MaskedTextLayer, MaskedTextClassifier), built
    from `text_kw`, its constructor's arguments. A TextCCT tree holds
    `embedder/embedding`, `tokenizer/conv/kernel` and `classifier/*`, whose
    `blocks/*` leaves carry the scanned layer axis."""
    return _load_module(module(**text_kw, dtype=dtype, device="cpu"), params_np, device)


def text_to_jax_params(model: torch.nn.Module) -> dict:
    """The inverse of text_from_jax_params: the module's parameters as the
    flax tree of f32 numpy arrays, `classifier/blocks/*` stacked on a
    leading layer axis."""
    return vit_to_jax_params(model)


def _load_module(model: torch.nn.Module, params_np: dict, device: DeviceLike):
    """Copy a scan-stacked flax tree into `model`'s parameters, every leaf
    used and every parameter filled."""
    names = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, p in names.items():
            path, layer = _flax_path(name)
            node = params_np
            for key in path:
                node = node[key]
            src = np.asarray(node, np.float32)
            if layer is not None:
                src = src[layer]
            if src.shape != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: shape {src.shape} != {tuple(p.shape)}")
            p.copy_(torch.tensor(src))
            seen.add("/".join(path))
    extra = set(_flat_paths(params_np)) - seen
    if extra:
        raise ValueError(f"flax leaves without a port parameter: {sorted(extra)}")
    return model.to(resolve_device(device))


def _flat_paths(tree, prefix=""):
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _flat_paths(tree[k], f"{prefix}{k}/")
        return out
    return [prefix[:-1]]


def vit_to_jax_params(values: Union[VisionTransformer, Mapping[str, torch.Tensor]]) -> dict:
    """The inverse: the module's parameters, or any {port name: tensor} of
    the same names (gradients, an EMA copy), as a scan-stacked nested dict of
    f32 numpy arrays shaped like the flax tree."""
    if isinstance(values, torch.nn.Module):
        values = dict(values.named_parameters())
    return _to_tree(values, layer_axis=0)


def _to_tree(values: Mapping[str, torch.Tensor], layer_axis: int) -> dict:
    tree: dict = {}
    stacks: dict = {}
    for name, t in values.items():
        path, layer = _flax_path(name)
        arr = t.detach().float().cpu().numpy()
        if layer is None:
            _put(tree, path, arr)
        else:
            stacks.setdefault(tuple(path), {})[layer] = arr
    for path, layers in stacks.items():
        _put(tree, list(path), np.stack([layers[i] for i in range(len(layers))], axis=layer_axis))
    return tree


def vit_values_from_jax_params(params_np: dict, names) -> dict:
    """The inverse of vit_to_jax_params for a {port name: tensor} dict: a
    scan-stacked tree -> {name: f32 numpy array} for each of `names`."""
    out = {}
    for name in names:
        path, layer = _flax_path(name)
        node = params_np
        for key in path:
            node = node[key]
        arr = np.asarray(node, np.float32)
        out[name] = arr[layer] if layer is not None else arr
    return out


def stacked_vit_from_jax_params(stacked_np: dict, model: VisionTransformer, *,
                                device: DeviceLike = None) -> dict:
    """A division-stacked flax VisionTransformer `params` tree (every leaf
    (D, ...), `blocks/*` (D, depth, ...)) -> the port's stacked dict
    {name: (D, ...) trainable f32 tensor} over `model`'s parameter names, bit
    for bit. The tree may lack the classifier heads (a features_only init)."""
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    depth, dev = model.cfg.depth, resolve_device(device)
    out = {}
    for path in _flat_paths(stacked_np):
        node = stacked_np
        for key in path.split("/"):
            node = node[key]
        arr = np.asarray(node, np.float32)
        parts = path.split("/")
        names = ([(f"blocks.{i}." + ".".join(parts[1:]), arr[:, i]) for i in range(depth)]
                 if parts[0] == "blocks" else [(".".join(parts), arr)])
        for name, a in names:
            if name not in shapes:
                raise ValueError(f"flax leaf {path} has no port parameter {name}")
            if a.shape[1:] != shapes[name]:
                raise ValueError(f"{path}: per-division shape {a.shape[1:]} != {shapes[name]}")
            out[name] = torch.nn.Parameter(torch.tensor(np.ascontiguousarray(a), device=dev))
    return {k: out[k] for k in shapes if k in out}  # the model's parameter order


def stacked_vit_values_from_jax_params(stacked_np: dict, names) -> dict:
    """The inverse of stacked_vit_to_jax_params for a {port name: (D, ...)}
    dict: a division-stacked tree -> {name: f32 numpy array} for `names`."""
    out = {}
    for name in names:
        path, layer = _flax_path(name)
        node = stacked_np
        for key in path:
            node = node[key]
        arr = np.asarray(node.float() if isinstance(node, torch.Tensor) else node, np.float32)
        out[name] = arr[:, layer] if layer is not None else arr
    return out


def stacked_vit_to_jax_params(stacked: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: a stacked {port name: (D, ...)} dict (parameters,
    gradients, an EMA copy) -> the division-stacked flax tree of f32 numpy
    arrays, `blocks/*` leaves (D, depth, ...)."""
    return _to_tree(stacked, layer_axis=1)


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


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
    kc = ens_params_np["cls_classifier"]["kernel"]
    fused = (ens_params_np["cls_mlp"]["kernel"].shape[0]
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


def ensmlp_to_jax_params(values: Union[EnsMLP, Mapping[str, torch.Tensor]]) -> dict:
    """The inverse of ensmlp_from_jax_params: the head's parameters, or any
    {port name: tensor} of the same names, as the flax EnsMLP `params` tree of
    f32 numpy arrays."""
    if isinstance(values, torch.nn.Module):
        values = dict(values.named_parameters())
    tree: dict = {}
    for name, t in values.items():
        _put(tree, name.split("."), t.detach().float().cpu().numpy())
    return tree


def ensmlp_values_from_jax_params(ens_params_np: dict, names) -> dict:
    """The inverse of ensmlp_to_jax_params for a {port name: tensor} dict:
    {name: f32 numpy array} for `names`."""
    out = {}
    for name in names:
        node = ens_params_np
        for key in name.split("."):
            node = node[key]
        out[name] = np.asarray(node.float() if isinstance(node, torch.Tensor) else node,
                               np.float32)
    return out
