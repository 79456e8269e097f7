"""Ragged-compact ViT: per-layer exact-width inference forward (counterpart
of devit_tpu/models/compact_vit.py).

Each layer keeps exactly its kept heads and kept MLP neurons (the MLP width
zero-padded to a multiple of `neuron_multiple`), so the forward runs the
shrunk model's real MACs. Weights keep the JAX package's (in, out) layout,
so x @ kernel is the same product as jnp.dot(x, kernel).

fast_math (the serving default) deviates from the strict numerics in two
ways, as in the JAX package: the tanh GELU, and LayerNorm statistics in the
compute dtype. Attention softmax is f32 under every flag.

The int8 serving variant (`quantize_compact`, then `compact_forward(...,
int8=True)`) runs each layer's four weight products through
`fused_int8_matmul` (the CUDA kernel on a CUDA tensor; the plain
`dynamic_int8_matmul` with use_kernel=False) and its attention through the
plain `reference_attention`, as the JAX package's int8 branch does.
`save_compact` / `load_compact` write and read the deploy stage's
`compact.msgpack` in the JAX package's format; quantize after loading.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from devit_tpu_torch.configs import ViTConfig
from devit_tpu_torch.device import DeviceLike, resolve_device
from devit_tpu_torch.io.checkpoint import restore_pytree, save_pytree
from devit_tpu_torch.kernels.attention import fused_attention, reference_attention
from devit_tpu_torch.kernels.quant import dynamic_int8_matmul, fused_int8_matmul, quantize_weight
from devit_tpu_torch.models.vit import Gates, fast_gelu, gelu_tanh, layer_norm

_QUANTIZED = ("qkv", "proj", "fc1", "fc2")  # the weight products quantize_compact replaces


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _frozen(a) -> nn.Parameter:
    """A frozen f32 parameter from a numpy array or a torch tensor (a loaded
    artifact's bfloat16 leaves are tensors)."""
    t = (a.detach().float().contiguous().clone() if isinstance(a, torch.Tensor)
         else torch.tensor(np.ascontiguousarray(a, np.float32)))
    return nn.Parameter(t, requires_grad=False)


class CompactLayer(nn.Module):
    """One ragged block: `num_heads` kept heads, exact MLP width. After
    quantize_compact its four weight products are QuantizedLinear
    submodules (qkv_q, proj_q, fc1_q, fc2_q) in place of the float kernels
    and biases."""

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

    @property
    def quantized(self) -> bool:
        return any(hasattr(lp, "qkv_q") for lp in self.layers)


def compact_vit_ragged(
    params: dict,
    gates: Gates,
    cfg: ViTConfig,
    *,
    head_multiple: int = 1,
    neuron_multiple: int = 128,
    device: DeviceLike = None,
) -> CompactViT:
    """Gather kept heads/neurons per layer into exact-width weights.

    params: the flax parameter tree of a gated VisionTransformer as a nested
    dict of numpy arrays; gates: binary (0/1) head and neuron masks. The kept
    heads are zero-padded to a multiple of `head_multiple` and the MLP width
    to a multiple of `neuron_multiple`, each capped at the full width.
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
        kh = max(min(_round_up(len(hi), head_multiple), H), 1)
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




def quantize_compact(model: CompactViT) -> CompactViT:
    """Int8 serving variant: a copy of `model` whose layers carry their four
    weight products as QuantizedLinear (per-channel scales) in place of the
    float kernels and biases. Use with compact_forward(..., int8=True)."""
    qm = copy.deepcopy(model)
    for lp in qm.layers:
        for name in _QUANTIZED:
            kernel, bias = getattr(lp, f"{name}_kernel"), getattr(lp, f"{name}_bias")
            setattr(lp, f"{name}_q", quantize_weight(kernel, bias))
            delattr(lp, f"{name}_kernel")
            delattr(lp, f"{name}_bias")
    return qm


def embed_patches(model: CompactViT, x: torch.Tensor, *, patch_size: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Images (B, H, W, 3) -> the first layer's tokens (B, N, C) in dtype."""
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
    return torch.cat(toks + [t], dim=1) + w(model.pos_embed)


def attention_half(lp: CompactLayer, t: torch.Tensor, *, eps: float,
                   dtype: torch.dtype = torch.bfloat16, use_kernel: bool = True,
                   fast_math: bool = True, int8: bool = False) -> torch.Tensor:
    """t + proj(attention(qkv(LN1(t)))), split: each product rounded to
    dtype on its own (the sequence fused_block_attention replaces)."""
    stat = dtype if fast_math else torch.float32
    h = layer_norm(t, lp.norm1_scale, lp.norm1_bias, eps, stat)
    if int8:
        mm = fused_int8_matmul if use_kernel else dynamic_int8_matmul
        # the JAX package's int8 branch takes the plain attention
        att = reference_attention(mm(h, lp.qkv_q, out_dtype=dtype), None, num_heads=lp.num_heads)
        return t + mm(att, lp.proj_q, out_dtype=dtype)
    qkv = torch.matmul(h, lp.qkv_kernel.to(dtype))
    if lp.qkv_bias is not None:
        qkv = qkv + lp.qkv_bias.to(dtype)
    attention = fused_attention if use_kernel else reference_attention
    att = attention(qkv, None, num_heads=lp.num_heads)
    return t + (torch.matmul(att, lp.proj_kernel.to(dtype)) + lp.proj_bias.to(dtype))


def mlp_half(lp: CompactLayer, t: torch.Tensor, *, eps: float,
             dtype: torch.dtype = torch.bfloat16, use_kernel: bool = True,
             fast_math: bool = True, int8: bool = False) -> torch.Tensor:
    """t + fc2(gelu(fc1(LN2(t))))."""
    stat = dtype if fast_math else torch.float32
    gelu = gelu_tanh if fast_math else fast_gelu
    h = layer_norm(t, lp.norm2_scale, lp.norm2_bias, eps, stat)
    if int8:
        mm = fused_int8_matmul if use_kernel else dynamic_int8_matmul
        return t + mm(gelu(mm(h, lp.fc1_q, out_dtype=dtype)), lp.fc2_q, out_dtype=dtype)
    h = gelu(torch.matmul(h, lp.fc1_kernel.to(dtype)) + lp.fc1_bias.to(dtype))
    return t + (torch.matmul(h, lp.fc2_kernel.to(dtype)) + lp.fc2_bias.to(dtype))


def compact_forward(
    model: CompactViT,
    x: torch.Tensor,  # (B, H, W, 3)
    *,
    patch_size: int,
    dtype: torch.dtype = torch.bfloat16,
    use_kernel: bool = True,
    fast_math: bool = True,
    features_only: bool = False,
    int8: bool = False,
):
    """Inference forward over ragged layers. Returns logits, or the
    (cls, dist) features with features_only (dist is None if undistilled).

    use_kernel: attention through `fused_attention` (the CUDA kernel on a
    CUDA tensor), or with int8 the four weight products through
    `fused_int8_matmul`; False takes the plain versions. int8 needs a
    quantize_compact model.
    """
    if int8 != model.quantized:
        raise ValueError("compact_forward(int8=True) takes a quantize_compact model and "
                         "int8=False a float one")
    kw = dict(eps=model.eps, dtype=dtype, use_kernel=use_kernel, fast_math=fast_math, int8=int8)
    t = embed_patches(model, x, patch_size=patch_size, dtype=dtype)
    for lp in model.layers:
        t = mlp_half(lp, attention_half(lp, t, **kw), **kw)

    w = lambda p: p.to(dtype)
    stat = dtype if fast_math else torch.float32
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
                            use_kernel: bool = True, fast_math: bool = True,
                            int8: bool = False, out_device: Optional[torch.device] = None
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run every compact division on the same batch and stack the token
    features division-major on `out_device` (default the images' device):
    (cls (D, B, C), dist (D, B, C) or None). Each division runs where its
    weights lie; the batch goes once to each such device, and only the
    (B, C) tokens come back (parallel/serve.py)."""
    images = torch.as_tensor(images)
    out_device = images.device if out_device is None else out_device
    on_device, feats = {}, []
    for cm in cms:
        dev = cm.pos_embed.device
        if dev not in on_device:
            on_device[dev] = images.to(dev, non_blocking=True)
        feats.append(compact_forward(cm, on_device[dev], patch_size=patch_size, dtype=dtype,
                                     use_kernel=use_kernel, fast_math=fast_math,
                                     features_only=True, int8=int8))
    cls_stack = torch.stack([c.to(out_device, non_blocking=True) for c, _ in feats])
    dist_stack = (None if feats[0][1] is None
                  else torch.stack([d.to(out_device, non_blocking=True) for _, d in feats]))
    return cls_stack, dist_stack


def _np(p: torch.Tensor) -> np.ndarray:
    return p.detach().float().cpu().numpy()


def save_compact(path: str, model: CompactViT) -> None:
    """Write the deployment artifact as the JAX package's save_compact does
    (the same tree, key order and dtypes: f32 arrays, the static meta beside
    them). Float models only: quantize after load_compact."""
    if model.quantized:
        raise ValueError("save_compact cannot serialize a quantize_compact model; "
                         "save the bf16 artifact and quantize after load_compact")
    embed = {"patch_kernel": _np(model.patch_kernel), "patch_bias": _np(model.patch_bias),
             "cls_token": _np(model.cls_token), "pos_embed": _np(model.pos_embed),
             "norm": {"scale": _np(model.norm_scale), "bias": _np(model.norm_bias)}}
    if model.distilled:
        embed["dist_token"] = _np(model.dist_token)
    layers = {}
    for i, lp in enumerate(model.layers):
        layer = {"norm1": {"bias": _np(lp.norm1_bias), "scale": _np(lp.norm1_scale)},
                 "norm2": {"bias": _np(lp.norm2_bias), "scale": _np(lp.norm2_scale)}}
        for name in ("fc1_bias", "fc1_kernel", "fc2_bias", "fc2_kernel", "proj_bias",
                     "proj_kernel", "qkv_bias", "qkv_kernel"):
            if getattr(lp, name) is not None:
                layer[name] = _np(getattr(lp, name))
        layers[str(i)] = dict(sorted(layer.items()))  # the JAX tree's sorted order
    head = {name: {k: _np(model.head[f"{name}_{k}"]) for k in ("bias", "kernel")}
            for name in ("head", "head_dist") if f"{name}_kernel" in model.head}
    save_pytree(path, {
        "embed": embed,
        "layers": layers,
        "head": head,
        "meta": {
            "num_heads": np.asarray(model.num_heads, np.int32),
            "head_dim": np.int32(model.head_dim),
            "distilled": np.int32(model.distilled),
            "eps": np.float32(model.eps),
        },
    })


def load_compact(path: str, device: DeviceLike = None) -> CompactViT:
    """Read a `compact.msgpack` that either package's save_compact wrote,
    onto `device` (cuda by default)."""
    tree = restore_pytree(path)
    meta = tree["meta"]
    heads = [int(h) for h in np.asarray(meta["num_heads"]).reshape(-1)]
    layers = [(tree["layers"][str(i)], kh) for i, kh in enumerate(heads)]
    model = CompactViT(tree["embed"], layers, tree.get("head", {}),
                       head_dim=int(meta["head_dim"]), distilled=bool(int(meta["distilled"])),
                       eps=float(meta["eps"]))
    return model.to(resolve_device(device))
