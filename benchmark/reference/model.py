"""Plain float32 reference of the DeViT forward: the gated (De)ViT backbone
with its drop-path, the EnsMLP token fusion, and the serving input
normalisation.

Written from the published description (DeiT, timm's VisionTransformer; the
DeViT EnsMLP head of ensemble_models.py) with plain torch operations. It
imports nothing of the program under test and takes only what the benchmark
made: full-width weights, binary gates and inputs. Compaction is not
reproduced: a pruned head's output and a pruned neuron's activation are
multiplied by their zero gate, which is what dropping them means.

Parameters are a flat {name: tensor} dict with one leaf per layer, named as
the port's VisionTransformer names them (`blocks.<i>.qkv.kernel`, (in, out)
kernels). The qkv kernel's output columns are laid out (3, heads, head_dim)
and the proj kernel's input rows (heads, head_dim).

`Precision` decides how every matrix product is computed: "f32" (TF32 off,
the reference) or "fp8" (both operands rounded to float8 e4m3 with one
scale a tensor, the gradients to e5m2: the control that a lower precision
than the configuration's must fail).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def set_strict_f32() -> None:
    """Float32 products in full float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` with one scale for the whole tensor (its largest
    magnitude maps to the format's largest finite value), back in x's dtype."""
    amax = x.detach().abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax.float() / _FP8_MAX[dtype]
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


class Precision:
    """How a matrix product is computed: "f32" or "fp8" (module docstring)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r}: f32 or fp8")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            a, b = _Fp8.apply(a), _Fp8.apply(b)
        return torch.matmul(a, b)


def geometry(cfg: dict) -> dict:
    """The sizes the forward needs, from a configuration file's model keys."""
    C, H = cfg["embed_dim"], cfg["num_heads"]
    side = cfg["img_size"] // cfg["patch_size"]
    prefix = 2 if cfg["distilled"] else 1
    return dict(C=C, H=H, dh=C // H, A=C, L=cfg["depth"], hidden=int(C * cfg["mlp_ratio"]),
                P=cfg["patch_size"], side=side, N=side * side + prefix, prefix=prefix,
                eps=cfg["layer_norm_eps"], K=cfg["num_classes"])


def leaf_shapes(cfg: dict, with_head: bool = True) -> Dict[str, Tuple[int, ...]]:
    """{leaf name: shape} of one (De)ViT, in a fixed order."""
    g = geometry(cfg)
    C, L, hid = g["C"], g["L"], g["hidden"]
    out = {"patch_embed.kernel": (g["P"] * g["P"] * 3, C), "patch_embed.bias": (C,),
           "cls_token": (1, 1, C)}
    if cfg["distilled"]:
        out["dist_token"] = (1, 1, C)
    out["pos_embed"] = (1, g["N"], C)
    for i in range(L):
        b = f"blocks.{i}."
        out.update({b + "norm1.scale": (C,), b + "norm1.bias": (C,),
                    b + "qkv.kernel": (C, 3 * g["A"]), b + "qkv.bias": (3 * g["A"],),
                    b + "proj.kernel": (g["A"], C), b + "proj.bias": (C,),
                    b + "norm2.scale": (C,), b + "norm2.bias": (C,),
                    b + "fc1.kernel": (C, hid), b + "fc1.bias": (hid,),
                    b + "fc2.kernel": (hid, C), b + "fc2.bias": (C,)})
    out["norm.scale"], out["norm.bias"] = (C,), (C,)
    if with_head:
        out["head.kernel"], out["head.bias"] = (C, g["K"]), (g["K"],)
        if cfg["distilled"]:
            out["head_dist.kernel"], out["head_dist.bias"] = (C, g["K"]), (g["K"],)
    return out


def ensmlp_shapes(ens: dict, sub_size: int, divisions: int) -> Dict[str, Tuple[int, ...]]:
    """{leaf name: shape} of the EnsMLP fusion head."""
    fused, width, K = divisions * sub_size, ens["teacher_size"], ens["num_classes"]
    out = {}
    for b in ("cls", "dist") if ens["family"] == "deit" else ("cls",):
        out[f"{b}_mlp.kernel"], out[f"{b}_mlp.bias"] = (fused, width), (width,)
        out[f"{b}_classifier.kernel"], out[f"{b}_classifier.bias"] = (width, K), (K,)
    return out


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) in [0, 255] -> ImageNet-standardised float32."""
    x = images_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    """GELU: "erf" (exact) or "tanh" (the tanh approximation)."""
    if form == "tanh":
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def vit_tokens(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, *,
               head_gate: Optional[torch.Tensor] = None,
               neuron_gate: Optional[torch.Tensor] = None,
               keep: Optional[torch.Tensor] = None, rates: Sequence[float] = (),
               gelu_form: str = "erf", prec: Precision = Precision()) -> torch.Tensor:
    """Normalised images (B, H, W, 3) -> the final LayerNorm's (B, N, C)
    tokens. head_gate (L, H) and neuron_gate (L, hidden) are 0/1 masks (None:
    all kept); keep (L, 2, B) the drop-path keep masks of each layer's two
    branches with their rates (None: no drop-path)."""
    g = geometry(cfg)
    B, C, H, dh, L, P, side = x.shape[0], g["C"], g["H"], g["dh"], g["L"], g["P"], g["side"]
    mm = prec.mm
    xp = x.reshape(B, side, P, side, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, side * side, -1)
    t = mm(xp, p["patch_embed.kernel"]) + p["patch_embed.bias"]
    prefix = [p["cls_token"].expand(B, 1, C)]
    if cfg["distilled"]:
        prefix.append(p["dist_token"].expand(B, 1, C))
    t = torch.cat(prefix + [t], dim=1) + p["pos_embed"]
    N = t.shape[1]

    def branch(y, layer, which):
        if keep is None:
            return y
        return y * keep[layer, which].view(B, 1, 1) / (1.0 - rates[layer])

    for i in range(L):
        b = f"blocks.{i}."
        h = layer_norm(t, p[b + "norm1.scale"], p[b + "norm1.bias"], g["eps"])
        qkv = (mm(h, p[b + "qkv.kernel"]) + p[b + "qkv.bias"]).reshape(B, N, 3, H, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        probs = torch.softmax(mm(q, k.transpose(-1, -2)) * dh ** -0.5, dim=-1)
        o = mm(probs, v)
        if head_gate is not None:
            o = o * head_gate[i].view(1, H, 1, 1)
        o = o.transpose(1, 2).reshape(B, N, H * dh)
        t = t + branch(mm(o, p[b + "proj.kernel"]) + p[b + "proj.bias"], i, 0)
        h = layer_norm(t, p[b + "norm2.scale"], p[b + "norm2.bias"], g["eps"])
        h = gelu(mm(h, p[b + "fc1.kernel"]) + p[b + "fc1.bias"], gelu_form)
        if neuron_gate is not None:
            h = h * neuron_gate[i]
        t = t + branch(mm(h, p[b + "fc2.kernel"]) + p[b + "fc2.bias"], i, 1)
    return layer_norm(t, p["norm.scale"], p["norm.bias"], g["eps"])


def head_logits(p: Dict[str, torch.Tensor], tokens: torch.Tensor, prec: Precision = Precision()):
    """The cls head's logits (B, K) from vit_tokens' output."""
    return prec.mm(tokens[:, 0], p["head.kernel"]) + p["head.bias"]


def ensmlp_logits(e: Dict[str, torch.Tensor], cls_tokens: List[torch.Tensor],
                  dist_tokens: List[torch.Tensor], family: str,
                  prec: Precision = Precision()) -> torch.Tensor:
    """EnsMLP: each branch concatenates the divisions' tokens division-major
    per image, projects them to the teacher width and classifies; the deit
    family averages the cls and dist branches."""
    def branch(name, toks):
        x = torch.cat(toks, dim=-1)
        x = prec.mm(x, e[f"{name}_mlp.kernel"]) + e[f"{name}_mlp.bias"]
        return prec.mm(x, e[f"{name}_classifier.kernel"]) + e[f"{name}_classifier.bias"]

    logits = branch("cls", cls_tokens)
    if family == "deit":
        logits = (logits + branch("dist", dist_tokens)) / 2.0
    return logits


@torch.no_grad()
def ensemble_logits(divisions: Sequence[Dict[str, torch.Tensor]], gates: Sequence[tuple],
                    ens: Dict[str, torch.Tensor], images_u8: torch.Tensor, cfg: dict, *,
                    prec: Precision = Precision(), block: int = 64) -> torch.Tensor:
    """The deployed ensemble on uint8 images: every gated division, then the
    fusion; `block` images at a time so that it fits beside nothing else."""
    outs = []
    for s in range(0, images_u8.shape[0], block):
        x = normalize(images_u8[s:s + block])
        cls_t, dist_t = [], []
        for p, (hg, ng) in zip(divisions, gates):
            t = vit_tokens(p, x, cfg, head_gate=hg, neuron_gate=ng,
                           gelu_form=cfg["serving"]["gelu"], prec=prec)
            cls_t.append(t[:, 0])
            dist_t.append(t[:, 1])
        outs.append(ensmlp_logits(ens, cls_t, dist_t, cfg["ensemble"]["family"], prec))
    return torch.cat(outs)
