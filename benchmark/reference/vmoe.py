"""Plain float32 reference of V-MoE's stage-2 step (Riquelme et al. 2021,
arXiv:2106.05974, §2 and Appendix A, on DeViT's stage-2 recipe): the ViT
of `model.py` whose listed layers route each token to its top-K of E expert
MLPs under a capacity, with the auxiliary losses added to the stage-2
loss. It imports nothing of the program under test.

A MoE layer, on h = LN2(x) over the batch's T tokens (one group), sigma =
1 / E:
    logits = h W_r                     W_r (C, E), no bias
    noisy  = logits + sigma * randn((T, E))   drawn from a generator on h's
                                       device seeded with the layer's seed
    gates  = softmax(noisy)
    choice[t, :] = the K largest noisy[t] (a stable sort: a tie to the
                   lower index)
    cap = round(K T capacity_ratio / E); choices ranked first choices in
    token order, then second choices, ...; a choice is kept while fewer
    than cap earlier-ranked choices went to its expert
    y[t] = sum over kept (t, j) of gates[t, choice[t, j]] MLP_e(h[t]),
    MLP_e(u) = fc2_e(GELU(fc1_e(u))), the exact-erf GELU
    imp_e = sum_t gates[t, e]          L_imp  = (std(imp) / mean(imp))^2
    thr_t = noisy[t, choice[t, K-1]]   p[t, e] = 1 - Phi((thr_t - logits[t, e]) / sigma)
    load_e = sum_t p[t, e]             L_load = (std(load) / mean(load))^2
(population std); the step's loss is the soft-target cross-entropy of the
cls head plus aux_loss_weight times the mean over the MoE layers of
(L_imp + L_load) / 2.

The step draws from the benchmark's CPU generator in the program's order:
the mixup's draws and the drop-path masks (`stage2.py`), then one
router-noise seed a MoE layer (`torch.randint(0, 2**62, (layers,))`).

Teacher-forced routing: given the program's expert choices of a step
(`forced`, {layer: (T, K)}), the reference routes by them and computes its
own gates, slots, experts and losses from them, so a routing decision that
rounding flips between the two does not part the trajectories; given the
program's layer inputs too, it counts the tokens where its own top-K on
the program's input differs from the program's choice (`route_disagree`).

Each block is recomputed in the backward pass (torch.utils.checkpoint over
the plain ops, the noise drawn again from its seed), so three f32 steps of
V-MoE-L/16 at batch 128 fit on one card; a routing group is never split.
No EMA: the configuration has none.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import model as base
from benchmark.reference.model import Precision, gelu, head_logits, layer_norm
from benchmark.reference.stage2 import Stage2Reference, drop_path_keep, mix_batch


def leaf_shapes(cfg: dict, with_head: bool = True) -> Dict[str, Tuple[int, ...]]:
    """{leaf name: shape} of the model, in the program's parameter order: a
    MoE layer's `router.kernel` (C, E) and stacked `experts.fc1/fc2`
    ((E, C, hidden), (E, hidden), (E, hidden, C), (E, C)) in place of
    fc1 and fc2."""
    g = base.geometry(cfg)
    C, hid, E = g["C"], g["hidden"], cfg["num_experts"]
    out = {}
    for name, shape in base.leaf_shapes(cfg, with_head).items():
        parts = name.split(".")
        if parts[0] == "blocks" and int(parts[1]) in cfg["moe_layers"] and parts[2] in ("fc1",
                                                                                      "fc2"):
            if name.endswith("fc1.kernel"):
                b = f"blocks.{parts[1]}."
                out.update({b + "router.kernel": (C, E),
                            b + "experts.fc1.kernel": (E, C, hid), b + "experts.fc1.bias": (E, hid),
                            b + "experts.fc2.kernel": (E, hid, C), b + "experts.fc2.bias": (E, C)})
            continue
        out[name] = shape
    return out


def capacity(cfg: dict, tokens: int) -> int:
    return int(round(cfg["top_k"] * tokens * cfg["capacity_ratio"] / cfg["num_experts"]))


def noise(seed: int, tokens: int, experts: int, device) -> torch.Tensor:
    """sigma * N(0, 1) draws of one layer, sigma = 1 / experts."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((tokens, experts), generator=g, device=device) * (1.0 / experts)


def top_k(noisy: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(noisy, dim=-1, descending=True, stable=True).indices[:, :k]


def own_choice(p: Dict[str, torch.Tensor], layer: int, h: torch.Tensor, seed: int, cfg: dict,
               prec: Precision) -> torch.Tensor:
    """The reference's top-K on a layer input h (T, C)."""
    logits = prec.mm(h.float(), p[f"blocks.{layer}.router.kernel"])
    return top_k(logits + noise(seed, h.shape[0], cfg["num_experts"], h.device), cfg["top_k"])


def moe_layer(p: Dict[str, torch.Tensor], i: int, h: torch.Tensor, cfg: dict, seed: int,
              forced: Optional[torch.Tensor], prec: Precision, record: Optional[dict] = None):
    """(y (T, C), the layer's aux) of MoE layer i on h (T, C), routed by
    `forced` (T, K) where given, else by its own top-K; `record` keeps the
    layer's first (h, choice) on the host."""
    b = f"blocks.{i}."
    T, E, K = h.shape[0], cfg["num_experts"], cfg["top_k"]
    sigma = 1.0 / E
    logits = prec.mm(h, p[b + "router.kernel"])
    noisy = logits + noise(seed, T, E, h.device)
    gates = torch.softmax(noisy, dim=-1)
    choice = top_k(noisy.detach(), K) if forced is None else forced.to(h.device)
    if record is not None and i not in record:
        record[i] = (h.detach().cpu(), choice.cpu())
    flat = choice.t().reshape(-1)  # first choices in token order, then second, ...
    onehot = torch.nn.functional.one_hot(flat, E)
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    kept = before < capacity(cfg, T)
    y = torch.zeros_like(h)
    for e in range(E):
        idx = torch.nonzero((flat == e) & kept)[:, 0]
        if idx.numel() == 0:
            continue
        tok = idx % T
        u = gelu(prec.mm(h[tok], p[b + "experts.fc1.kernel"][e]) + p[b + "experts.fc1.bias"][e],
                 "erf")
        u = prec.mm(u, p[b + "experts.fc2.kernel"][e]) + p[b + "experts.fc2.bias"][e]
        y = y.index_add(0, tok, gates[tok, e][:, None] * u)
    thr = noisy.gather(1, choice[:, K - 1:K])
    prob = 0.5 * torch.erfc((thr - logits) / sigma / math.sqrt(2.0))

    def cv2(v):
        return (v.std(unbiased=False) / v.mean()) ** 2

    return y, 0.5 * (cv2(gates.sum(0)) + cv2(prob.sum(0)))


def vmoe_tokens(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict, *, keep, rates,
                seeds: Dict[int, int], forced: Optional[dict], prec: Precision,
                record: Optional[dict] = None):
    """Mixed images (B, H, W, 3) -> (the final LayerNorm's tokens, the mean
    aux over the MoE layers), each block recomputed in the backward pass;
    keep (L, 2, B) the drop-path keep masks with their rates, or None."""
    g = base.geometry(cfg)
    B, C, H, dh, P, side = x.shape[0], g["C"], g["H"], g["dh"], g["P"], g["side"]
    mm = prec.mm
    xp = x.reshape(B, side, P, side, P, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, side * side, -1)
    t = mm(xp, p["patch_embed.kernel"]) + p["patch_embed.bias"]
    t = torch.cat([p["cls_token"].expand(B, 1, C), t], dim=1) + p["pos_embed"]
    N = t.shape[1]

    def branch(y, i, which):
        if keep is None:
            return y
        return y * keep[i, which].view(B, 1, 1) / (1.0 - rates[i])

    def block(t, i):
        b = f"blocks.{i}."
        h = layer_norm(t, p[b + "norm1.scale"], p[b + "norm1.bias"], g["eps"])
        qkv = (mm(h, p[b + "qkv.kernel"]) + p[b + "qkv.bias"]).reshape(B, N, 3, H, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = mm(torch.softmax(mm(q, k.transpose(-1, -2)) * dh ** -0.5, dim=-1), v)
        o = mm(o.transpose(1, 2).reshape(B, N, C), p[b + "proj.kernel"]) + p[b + "proj.bias"]
        t = t + branch(o, i, 0)
        h = layer_norm(t, p[b + "norm2.scale"], p[b + "norm2.bias"], g["eps"])
        aux = None
        if i in cfg["moe_layers"]:
            y, aux = moe_layer(p, i, h.reshape(B * N, C), cfg, seeds[i],
                               None if forced is None else forced[i], prec, record)
            y = y.reshape(B, N, C)
        else:
            y = mm(gelu(mm(h, p[b + "fc1.kernel"]) + p[b + "fc1.bias"], "erf"),
                   p[b + "fc2.kernel"]) + p[b + "fc2.bias"]
        return t + branch(y, i, 1), aux

    auxes = []
    for i in range(g["L"]):
        t, aux = checkpoint(block, t, i, use_reentrant=False)
        if aux is not None:
            auxes.append(aux)
    return layer_norm(t, p["norm.scale"], p["norm.bias"], g["eps"]), torch.stack(auxes).mean()


class VMoEReference(Stage2Reference):
    """The stage-2 state and step of a V-MoE in plain PyTorch: parameters
    and AdamW moments as {name: tensor} dicts (no EMA)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, prec: Precision = Precision()):
        self.cfg = cfg
        self.prec = prec
        self.params = {k: v.detach().float().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.ema = {}
        self.count = 0
        self.rates = torch.linspace(0.0, cfg["drop_path_rate"], cfg["depth"]).tolist()

    def loss_and_grads(self, images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
                       forced: Optional[dict] = None, inputs: Optional[dict] = None,
                       record: Optional[dict] = None):
        """(loss, gradients, [tokens whose own top-K on the program's input
        differs from the program's choice, tokens] or None); `record` as
        moe_layer's."""
        cfg = self.cfg
        x, soft = mix_batch(gen, images, labels, cfg["mixup"], cfg["num_classes"])
        keep = None
        if cfg["drop_path_rate"] > 0:
            keep = drop_path_keep(gen, self.rates, x.shape[0]).to(x.device)
        drawn = torch.randint(0, 2 ** 62, (len(cfg["moe_layers"]),), generator=gen).tolist()
        seeds = dict(zip(cfg["moe_layers"], drawn))
        disagree = None
        if forced is not None and inputs is not None:
            disagree = [0, 0]
            with torch.no_grad():
                for i in cfg["moe_layers"]:
                    h = inputs[i].to(x.device)
                    mine = own_choice(self.params, i, h, seeds[i], cfg, self.prec)
                    disagree[0] += int((mine != forced[i].to(x.device)).any(1).sum())
                    disagree[1] += h.shape[0]
        tokens, aux = vmoe_tokens(self.params, x, cfg, keep=keep, rates=self.rates, seeds=seeds,
                                  forced=forced, prec=self.prec, record=record)
        logits = head_logits(self.params, tokens, self.prec)
        loss = torch.sum(-soft * torch.log_softmax(logits, dim=-1), dim=-1).mean()
        loss = loss + cfg["aux_loss_weight"] * aux
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(self.params[k]) if g is None else g
                               for k, g in zip(names, grads)}, disagree

    def step(self, images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
             fault: Optional[str] = None, forced: Optional[dict] = None,
             inputs: Optional[dict] = None, record: Optional[dict] = None):
        """One step; returns (loss, gradients as the optimizer took them,
        disagreement as loss_and_grads'). `fault` as Stage2Reference.step's:
        "half" (the half batch routes by its own top-K) or "frozen"."""
        if fault == "half":
            images, labels = images[: images.shape[0] // 2], labels[: labels.shape[0] // 2]
            forced = inputs = None
        loss, grads, disagree = self.loss_and_grads(images, labels, gen, forced, inputs, record)
        if fault == "frozen":
            return loss, grads, disagree
        return loss, self.apply(grads), disagree

