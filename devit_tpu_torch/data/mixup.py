"""Mixup / CutMix (counterpart of devit_tpu/data/mixup.py): timm's `Mixup`
with timm-0.5.4 semantics in batch, pair and elem modes, cutmix_minmax, the
area-corrected lam and label smoothing folded into the soft target.

The mixing parameters (lam, the cutmix switch, the boxes) are drawn from a
`torch.Generator` on its own device (the CPU in the training step, as timm
draws them on the host); the mixing itself runs where the images are.
Beta draws use Marsaglia-Tsang gamma sampling, since torch's Beta sampler
takes no generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from devit_tpu_torch.device import to_device


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    cutmix_minmax: Optional[Tuple[float, float]] = None
    prob: float = 1.0
    switch_prob: float = 0.5
    mode: str = "batch"  # batch | pair | elem
    label_smoothing: float = 0.1
    num_classes: int = 100

    @property
    def effective_cutmix_alpha(self) -> float:
        # timm Mixup.__init__: cutmix_minmax forces cutmix_alpha = 1.0
        return 1.0 if self.cutmix_minmax is not None else self.cutmix_alpha

    @property
    def active(self) -> bool:
        return self.mixup_alpha > 0 or self.effective_cutmix_alpha > 0


def _gamma(gen: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """Gamma(alpha, 1) in f64 by Marsaglia-Tsang (alpha < 1 boosted by
    U^(1/alpha))."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    kw = dict(generator=gen, dtype=torch.float64, device=gen.device)
    out = torch.empty(shape, dtype=torch.float64, device=gen.device)
    todo = torch.ones(shape, dtype=torch.bool, device=gen.device)
    while bool(todo.any()):
        x = torch.randn(shape, **kw)
        v = (1.0 + c * x) ** 3
        u = torch.rand(shape, **kw)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out = torch.where(todo & ok, d * v, out)
        todo = todo & ~ok
    if alpha < 1.0:
        out = out * torch.rand(shape, **kw) ** (1.0 / alpha)
    return out


def _beta(gen: torch.Generator, alpha: float, shape=()) -> torch.Tensor:
    """Beta(alpha, alpha) as f32."""
    x, y = _gamma(gen, alpha, shape), _gamma(gen, alpha, shape)
    return (x / (x + y)).float()


def _one_hot_smooth(labels: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    hot = torch.zeros((labels.shape[0], num_classes), device=labels.device)
    hot.scatter_(1, labels.long()[:, None], 1.0)
    return hot * (on - off) + off


def _rand_bbox(gen: torch.Generator, h: int, w: int, lam: torch.Tensor):
    """timm rand_bbox: cut a sqrt(1-lam)-scaled box at a uniform center."""
    ratio = torch.sqrt(1.0 - lam.float())
    cut_h = (h * ratio).to(torch.int32)
    cut_w = (w * ratio).to(torch.int32)
    ry = torch.randint(0, h, (), generator=gen, device=gen.device, dtype=torch.int32)
    rx = torch.randint(0, w, (), generator=gen, device=gen.device, dtype=torch.int32)
    y1 = torch.clamp(ry - cut_h // 2, 0, h)
    y2 = torch.clamp(ry + cut_h // 2, 0, h)
    x1 = torch.clamp(rx - cut_w // 2, 0, w)
    x2 = torch.clamp(rx + cut_w // 2, 0, w)
    return y1, y2, x1, x2


def _rand_bbox_minmax(gen: torch.Generator, h: int, w: int, minmax: Tuple[float, float]):
    """timm rand_bbox_minmax: side lengths uniform in [minmax0*S, minmax1*S),
    top-left uniform so the box fits."""
    kw = dict(generator=gen, device=gen.device)
    cut_h = torch.randint(int(h * minmax[0]), int(h * minmax[1]), (), dtype=torch.int32, **kw)
    cut_w = torch.randint(int(w * minmax[0]), int(w * minmax[1]), (), dtype=torch.int32, **kw)
    y1 = torch.floor(torch.rand((), **kw) * (h - cut_h)).to(torch.int32)
    x1 = torch.floor(torch.rand((), **kw) * (w - cut_w)).to(torch.int32)
    return y1, y1 + cut_h, x1, x1 + cut_w


def _sample_box(gen: torch.Generator, h: int, w: int, lam: torch.Tensor, cfg: MixupConfig):
    if cfg.cutmix_minmax is not None:
        return _rand_bbox_minmax(gen, h, w, cfg.cutmix_minmax)
    return _rand_bbox(gen, h, w, lam)


def _params(gen: torch.Generator, cfg: MixupConfig, shape=()):
    """(lam, use_cutmix) in timm's order: switch coin, then the matching
    Beta, then the apply-probability gate folds lam back to 1."""
    cutmix_alpha = cfg.effective_cutmix_alpha
    kw = dict(generator=gen, device=gen.device)
    if cfg.mixup_alpha > 0 and cutmix_alpha > 0:
        use_cutmix = torch.rand(shape, **kw) < cfg.switch_prob
        lam = torch.where(use_cutmix, _beta(gen, cutmix_alpha, shape),
                          _beta(gen, cfg.mixup_alpha, shape))
    elif cfg.mixup_alpha > 0:
        use_cutmix = torch.zeros(shape, dtype=torch.bool, device=gen.device)
        lam = _beta(gen, cfg.mixup_alpha, shape)
    else:
        use_cutmix = torch.ones(shape, dtype=torch.bool, device=gen.device)
        lam = _beta(gen, cutmix_alpha, shape)
    apply = torch.rand(shape, **kw) < cfg.prob
    return torch.where(apply, lam, torch.ones_like(lam)), use_cutmix


def _mix_with_flipped(images: torch.Tensor, lam: torch.Tensor, use_cutmix: torch.Tensor,
                      boxes, h: int, w: int):
    """Per-sample (or broadcast scalar) mixing against the flipped batch, in
    f32; returns (mixed, area-corrected lam)."""
    dev = images.device
    lam = to_device(torch.as_tensor(lam, dtype=torch.float32), dev)
    use_cutmix = to_device(torch.as_tensor(use_cutmix), dev)
    y1, y2, x1, x2 = (to_device(torch.as_tensor(v), dev) for v in boxes)
    x = images.float()
    flipped = x.flip(0)
    lam_b = lam.reshape(lam.shape + (1,) * (x.ndim - lam.ndim))
    mixed_mix = x * lam_b + flipped * (1.0 - lam_b)
    yy = torch.arange(h, device=dev)[None, :, None, None]
    xx = torch.arange(w, device=dev)[None, None, :, None]

    def exp(v):  # (.,) box coord -> broadcastable against (B,H,W,C)
        return v.reshape(v.shape + (1,) * 3)

    in_box = (yy >= exp(y1)) & (yy < exp(y2)) & (xx >= exp(x1)) & (xx < exp(x2))
    mixed_cut = torch.where(in_box, flipped, x)
    lam_c = 1.0 - ((y2 - y1) * (x2 - x1)).float() / (h * w)
    # lam == 1 (apply gate off) stays untouched even on the cutmix branch
    use_cut = use_cutmix & (lam != 1.0)
    uc = use_cut.reshape(use_cut.shape + (1,) * (x.ndim - use_cut.ndim))
    mixed = torch.where(uc, mixed_cut, mixed_mix)
    return mixed, torch.where(use_cut, lam_c, lam)


def mixup_cutmix(gen: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
                 cfg: MixupConfig):
    """timm Mixup.__call__: images (B,H,W,C) NHWC, int labels (B,).

    Returns (mixed images in the input dtype, soft targets (B, K) f32).
    Pairing is batch reversal in every mode."""
    B, H, W, _ = images.shape
    targets = _one_hot_smooth(labels, cfg.num_classes, cfg.label_smoothing)
    if not cfg.active:
        return images, targets
    if cfg.mode == "batch":
        lam, use_cutmix = _params(gen, cfg)
        boxes = _sample_box(gen, H, W, lam, cfg)
    elif cfg.mode in ("elem", "pair"):
        n = B
        if cfg.mode == "pair":
            if B % 2:
                raise ValueError("mixup mode='pair' needs an even batch (timm asserts this)")
            n = B // 2
        lam, use_cutmix = _params(gen, cfg, (n,))
        per = [_sample_box(gen, H, W, lam[i], cfg) for i in range(n)]
        boxes = tuple(torch.stack([p[j] for p in per]) for j in range(4))
        if cfg.mode == "pair":
            # pair (i, B-1-i) shares lam and swaps the SAME box -> mirror
            lam = torch.cat([lam, lam.flip(0)])
            use_cutmix = torch.cat([use_cutmix, use_cutmix.flip(0)])
            boxes = tuple(torch.cat([b, b.flip(0)]) for b in boxes)
    else:
        raise ValueError(f"mixup mode {cfg.mode!r}: expected batch|pair|elem")
    mixed, lam = _mix_with_flipped(images, lam, use_cutmix, boxes, H, W)
    lam_t = lam.reshape(lam.shape + (1,) * (targets.ndim - lam.ndim))
    soft = targets * lam_t + targets.flip(0) * (1.0 - lam_t)
    return mixed.to(images.dtype), soft
