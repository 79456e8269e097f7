"""Plain float32 V-MoE: the forward of a ViT whose listed layers carry
sparse experts, their auxiliary losses and the stage-2 loss, written from
the paper (Riquelme et al. 2021, arXiv:2106.05974, §2 and Appendix A) with
plain torch operations. It imports nothing but torch: neither the port's
kernels and models nor JAX.

Parameters are a flat {name: tensor} dict named as the port's
VisionTransformer names them (`blocks.<i>.qkv.kernel`, (in, out) kernels; a
MoE layer's `blocks.<i>.router.kernel` (C, E) and stacked experts
`blocks.<i>.experts.fc1.kernel` (E, C, hidden), `.bias` (E, hidden),
`fc2` (E, hidden, C), (E, C)). `cfg` is a dict of the ViTConfig fields.

A MoE layer, on h = LN2(x) over the batch's T tokens (one group), E experts,
K choices a token, sigma = 1 / E:
    logits = h W_r;  noisy = logits + eps, eps ~ N(0, sigma^2) (training;
    drawn as sigma * randn((T, E)) from a generator seeded with the layer's
    seed on h's device);  gates = softmax(noisy)
    choice[t, :] = the K largest noisy[t], a tie to the lower index
    w[t, j] = gates[t, choice[t, j]]
    cap = round(K T capacity_ratio / E); the choices ranked first choices in
    token order, then second choices, ...; a choice is kept while fewer than
    cap earlier-ranked choices went to its expert, else dropped
    y[t] = sum over kept j of w[t, j] MLP_choice(h[t]), MLP_e(u) =
    fc2_e(GELU(fc1_e(u))) (exact erf GELU)
    imp_e = sum_t gates[t, e];  L_imp = (std(imp) / mean(imp))^2
    thr_t = noisy[t, choice[t, K-1]];  p[t, e] = 1 - Phi((thr_t - logits[t, e]) / sigma)
    load_e = sum_t p[t, e];  L_load = (std(load) / mean(load))^2
with the population std; the model's aux is the mean over its MoE layers of
(L_imp + L_load) / 2, and the stage-2 loss is the label-smoothed
cross-entropy of the cls head plus aux_loss_weight times aux.

Set TF32 off (`strict_f32`) before comparing on a card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * scale + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def draws(cfg: dict, generator: torch.Generator, batch: int):
    """The stage-2 step's draws after the mixup's, in the port's order: the
    (L, 2, B) drop-path keep masks, then one router-noise seed a MoE layer."""
    L = cfg["depth"]
    rates = torch.linspace(0.0, cfg["drop_path_rate"], L).tolist()
    keep = None
    if cfg["drop_path_rate"] > 0:
        probs = torch.tensor([1.0 - r for r in rates]).view(L, 1, 1, 1, 1)
        keep = torch.bernoulli(probs.expand(L, 2, batch, 1, 1).contiguous(),
                               generator=generator).view(L, 2, batch)
    seeds = torch.randint(0, 2 ** 62, (len(cfg["moe_layers"]),), generator=generator).tolist()
    return rates, keep, dict(zip(cfg["moe_layers"], seeds))


def assign(choice: List[List[int]], experts: int, cap: int) -> List[List[int]]:
    """slot[t][j]: the position of choice (t, j) in its expert, or -1 where
    dropped (first choices in token order, then second choices, ...)."""
    T, K = len(choice), len(choice[0])
    fill = [0] * experts
    slot = [[-1] * K for _ in range(T)]
    for j in range(K):
        for t in range(T):
            e = choice[t][j]
            if fill[e] < cap:
                slot[t][j] = fill[e]
            fill[e] += 1
    return slot


def moe_layer(p: Dict[str, torch.Tensor], i: int, h: torch.Tensor, cfg: dict,
              seed: Optional[int], train: bool):
    """(y (T, C), aux or None) of MoE layer i on h (T, C)."""
    b = f"blocks.{i}."
    T = h.shape[0]
    E, K = cfg["num_experts"], cfg["top_k"]
    sigma = 1.0 / E
    logits = h @ p[b + "router.kernel"]
    noisy = logits
    if train:
        g = torch.Generator(device=h.device).manual_seed(seed)
        noisy = logits + torch.randn((T, E), generator=g, device=h.device) * sigma
    gates = torch.softmax(noisy, dim=-1)
    order = torch.sort(noisy.detach(), dim=-1, descending=True, stable=True).indices
    choice = order[:, :K]
    cap = int(round(K * T * cfg["capacity_ratio"] / E))
    slot = assign(choice.tolist(), E, cap)
    y = torch.zeros_like(h)
    for e in range(E):
        toks = [(t, j) for t in range(T) for j in range(K)
                if choice[t, j] == e and slot[t][j] >= 0]
        if not toks:
            continue
        rows = torch.tensor([t for t, _ in toks], device=h.device)
        cols = torch.tensor([j for _, j in toks], device=h.device)
        u = gelu(h[rows] @ p[b + "experts.fc1.kernel"][e] + p[b + "experts.fc1.bias"][e])
        u = u @ p[b + "experts.fc2.kernel"][e] + p[b + "experts.fc2.bias"][e]
        wt = gates[rows, choice[rows, cols]]
        y = y.index_add(0, rows, wt[:, None] * u)
    if not train:
        return y, None
    thr = noisy.gather(1, choice[:, K - 1:K])
    prob = 0.5 * torch.erfc((thr - logits) / sigma / math.sqrt(2.0))

    def cv2(v):
        return (v.std(unbiased=False) / v.mean()) ** 2

    return y, 0.5 * (cv2(gates.sum(0)) + cv2(prob.sum(0)))


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, *, train: bool = False,
            keep: Optional[torch.Tensor] = None, rates=(), seeds: Optional[dict] = None):
    """Images (B, H, W, 3) -> (cls logits (B, classes), aux or None)."""
    B, C, H = x.shape[0], cfg["embed_dim"], cfg["num_heads"]
    P = cfg["patch_size"]
    side = cfg["img_size"] // P
    dh = C // H
    xp = x.reshape(B, side, P, side, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, side * side, -1)
    t = xp @ p["patch_embed.kernel"] + p["patch_embed.bias"]
    t = torch.cat([p["cls_token"].expand(B, 1, C), t], dim=1) + p["pos_embed"]
    N = t.shape[1]
    auxes = []

    def branch(y, i, which):
        if keep is None:
            return y
        return y * keep[i, which].view(B, 1, 1) / (1.0 - rates[i])

    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        h = layer_norm(t, p[b + "norm1.scale"], p[b + "norm1.bias"], cfg["layer_norm_eps"])
        qkv = (h @ p[b + "qkv.kernel"] + p[b + "qkv.bias"]).reshape(B, N, 3, H, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1) @ v
        o = att.transpose(1, 2).reshape(B, N, C) @ p[b + "proj.kernel"] + p[b + "proj.bias"]
        t = t + branch(o, i, 0)
        h = layer_norm(t, p[b + "norm2.scale"], p[b + "norm2.bias"], cfg["layer_norm_eps"])
        if i in cfg["moe_layers"]:
            y, aux = moe_layer(p, i, h.reshape(B * N, C), cfg,
                               None if seeds is None else seeds[i], train)
            y = y.reshape(B, N, C)
            if aux is not None:
                auxes.append(aux)
        else:
            y = gelu(h @ p[b + "fc1.kernel"] + p[b + "fc1.bias"]) @ p[b + "fc2.kernel"] \
                + p[b + "fc2.bias"]
        t = t + branch(y, i, 1)
    t = layer_norm(t, p["norm.scale"], p["norm.bias"], cfg["layer_norm_eps"])
    logits = t[:, 0] @ p["head.kernel"] + p["head.bias"]
    return logits, (torch.stack(auxes).mean() if auxes else None)


def stage2_loss(p: Dict[str, torch.Tensor], images: torch.Tensor, labels: torch.Tensor,
                cfg: dict, generator: torch.Generator, smoothing: float):
    """(loss, aux) of one stage-2 step without mixup: the label-smoothed
    cross-entropy plus aux_loss_weight times aux, the draws from
    `generator` in the port's order."""
    rates, keep, seeds = draws(cfg, generator, images.shape[0])
    keep = None if keep is None else keep.to(images.device)
    logits, aux = forward(p, images, cfg, train=True, keep=keep, rates=rates, seeds=seeds)
    K = logits.shape[-1]
    target = torch.full_like(logits, smoothing / K)
    target[torch.arange(len(labels), device=logits.device), labels] += 1.0 - smoothing
    ce = torch.sum(-target * torch.log_softmax(logits, dim=-1), dim=-1).mean()
    return ce + cfg["aux_loss_weight"] * aux, aux
