"""Plain float32 reference of DeViT's stage-2 step (train_subdata.py): mixup
or cutmix against the reversed batch with a label-smoothed soft target,
drop-path, the cls head's soft-target cross-entropy, optional global-norm
clipping, AdamW under timm's warm-up + cosine schedule, and the EMA.

The step's random draws come from one CPU `torch.Generator` that the
benchmark seeds and hands to both sides. They are drawn in timm's order for
one batch: the mixup/cutmix switch, both Beta draws (Marsaglia-Tsang gamma
variates in float64), the apply gate, the cutmix box centre, then every
layer's drop-path keep masks as one (L, 2, B) Bernoulli draw. The program
under test draws the same numbers in the same order from its copy of the
generator, so the two sides mix the same images and drop the same branches.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from benchmark.reference.model import Precision, head_logits, vit_tokens


def _gamma(gen: torch.Generator, alpha: float) -> torch.Tensor:
    """One Gamma(alpha, 1) variate, float64 (Marsaglia-Tsang; alpha < 1 by
    the U^(1/alpha) boost)."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    kw = dict(generator=gen, dtype=torch.float64)
    while True:
        x = torch.randn((), **kw)
        v = (1.0 + c * x) ** 3
        u = torch.rand((), **kw)
        if v > 0 and torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(1e-300)):
            out = d * v
            break
    if alpha < 1.0:
        out = out * torch.rand((), **kw) ** (1.0 / alpha)
    return out


def _beta(gen: torch.Generator, alpha: float) -> torch.Tensor:
    x, y = _gamma(gen, alpha), _gamma(gen, alpha)
    return (x / (x + y)).float()


def mix_batch(gen: torch.Generator, images: torch.Tensor, labels: torch.Tensor, mix: dict,
              num_classes: int):
    """timm Mixup in batch mode: (mixed images f32, soft targets (B, K))."""
    B, H, W, _ = images.shape
    off = mix["label_smoothing"] / num_classes
    hot = torch.full((B, num_classes), off, device=images.device)
    hot[torch.arange(B, device=images.device), labels.long()] = 1.0 - mix["label_smoothing"] + off
    use_cut = bool(torch.rand((), generator=gen) < mix["switch_prob"])
    lam_cut, lam_mix = _beta(gen, mix["cutmix_alpha"]), _beta(gen, mix["mixup_alpha"])
    lam = lam_cut if use_cut else lam_mix
    if not bool(torch.rand((), generator=gen) < mix["prob"]):
        lam = torch.ones(())
    ratio = torch.sqrt(1.0 - lam.float())
    cut_h, cut_w = int((H * ratio).to(torch.int32)), int((W * ratio).to(torch.int32))
    cy = int(torch.randint(0, H, (), generator=gen, dtype=torch.int32))
    cx = int(torch.randint(0, W, (), generator=gen, dtype=torch.int32))
    y1, y2 = min(max(cy - cut_h // 2, 0), H), min(max(cy + cut_h // 2, 0), H)
    x1, x2 = min(max(cx - cut_w // 2, 0), W), min(max(cx + cut_w // 2, 0), W)
    x = images.float()
    flipped = x.flip(0)
    lam = float(lam)
    if use_cut and lam != 1.0:
        x = x.clone()
        x[:, y1:y2, x1:x2] = flipped[:, y1:y2, x1:x2]
        lam = 1.0 - (y2 - y1) * (x2 - x1) / (H * W)
    else:
        x = x * lam + flipped * (1.0 - lam)
    return x, hot * lam + hot.flip(0) * (1.0 - lam)


def drop_path_keep(gen: torch.Generator, rates, batch: int) -> torch.Tensor:
    """(L, 2, B) Bernoulli(1 - rate) keep masks of every layer's branches."""
    keep = torch.tensor([1.0 - r for r in rates]).view(-1, 1, 1, 1, 1)
    keep = keep.expand(len(rates), 2, batch, 1, 1).contiguous()
    return torch.bernoulli(keep, generator=gen).view(len(rates), 2, batch)


def lr_at(opt: dict, step: int) -> float:
    """timm's per-step cosine schedule with linear warm-up, at the update
    count before the update."""
    spe = opt["steps_per_epoch"]
    warm = opt["warmup_epochs"] * spe
    total = max(opt["epochs"] * spe, warm + 1)
    if step < warm:
        return opt["warmup_lr"] + (opt["lr"] - opt["warmup_lr"]) * step / max(warm, 1)
    progress = min(step / total, 1.0)
    return opt["min_lr"] + 0.5 * (opt["lr"] - opt["min_lr"]) * (1.0 + math.cos(math.pi * progress))


def decays(name: str, shape) -> bool:
    """AdamW's weight decay applies to kernels only: no bias, LayerNorm
    scale, token or position embedding."""
    no = ("bias", "scale", "cls_token", "dist_token", "pos_embed")
    return not any(part in no for part in name.split(".")) and len(shape) >= 2


class Stage2Reference:
    """The stage-2 training state and step in plain PyTorch: parameters,
    AdamW moments and EMA, as {name: tensor} dicts."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: dict, prec: Precision = Precision()):
        self.cfg = cfg
        self.prec = prec
        self.params = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.ema = {k: v.detach().clone() for k, v in self.params.items()}
        self.count = 0
        # stochastic depth's linear rule, evaluated in float32 as timm does
        self.rates = torch.linspace(0.0, cfg["drop_path_rate"], cfg["depth"]).tolist()

    def loss_and_grads(self, images: torch.Tensor, labels: torch.Tensor,
                       gen: torch.Generator):
        cfg = self.cfg
        x, soft = mix_batch(gen, images, labels, cfg["mixup"], cfg["num_classes"])
        keep = drop_path_keep(gen, self.rates, x.shape[0]).to(x.device)
        tokens = vit_tokens(self.params, x, cfg, keep=keep, rates=self.rates,
                            gelu_form="erf", prec=self.prec)
        logits = head_logits(self.params, tokens, self.prec)
        loss = torch.sum(-soft * torch.log_softmax(logits, dim=-1), dim=-1).mean()
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(self.params[k]) if g is None else g
                               for k, g in zip(names, grads)}

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One AdamW update and EMA update; returns the gradients as the
        optimizer took them (after clipping)."""
        opt = self.cfg["optimizer"]
        if opt.get("clip_grad") is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if norm >= opt["clip_grad"]:
                grads = {k: g * (opt["clip_grad"] / norm) for k, g in grads.items()}
        lr = lr_at(opt, self.count)
        self.count += 1
        b1, b2, eps, wd = opt["beta1"], opt["beta2"], opt["eps"], opt["weight_decay"]
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.nu[k].mul_(b2).add_(g * g, alpha=1.0 - b2)
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + eps)
            if decays(k, p.shape):
                u = u + wd * p
            p.sub_(lr * u)
        d = self.cfg["ema_decay"]
        for k, e in self.ema.items():
            e.mul_(d).add_(self.params[k], alpha=1.0 - d)
        return grads

    def step(self, images: torch.Tensor, labels: torch.Tensor, gen: torch.Generator,
             fault: Optional[str] = None):
        """One step; returns (loss, gradients as the optimizer took them).
        `fault` plants a known fault for the benchmark's own checks:
        "half" leaves out half of the batch, "frozen" skips the update."""
        if fault == "half":
            images, labels = images[: images.shape[0] // 2], labels[: labels.shape[0] // 2]
        loss, grads = self.loss_and_grads(images, labels, gen)
        if fault == "frozen":
            return loss, grads
        return loss, self.apply(grads)
