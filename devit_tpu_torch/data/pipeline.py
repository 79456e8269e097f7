"""The train and eval transforms on batched NHWC images (counterpart of
devit_tpu/data/pipeline.py).

Eval: Resize(int(256/224 * size)) + CenterCrop + normalize. Train:
RandomResizedCrop (or the small-image RandomCrop(pad 4)), hflip,
RandAugment (data/randaugment.py) or color jitter, normalize, random
erasing in the normalized domain.

Every random choice is drawn on the host from an explicit torch.Generator
(`draw_train`, the crop boxes, flips, jitter order and factors, RandAugment
choices, erase boxes and their fill) and applied to the images on their own
device (`apply_train`), so the same draws give the same images on the CPU
and on the card. jax.random's streams cannot be reproduced: the draws match
the JAX package's in distribution, and applying fixed draws matches its
arithmetic.

Resampling follows jax.image.scale_and_translate, not F.interpolate: the
Keys cubic kernel (a = -0.5) or the triangle, widened when downscaling
(antialias), weights normalised per output sample, samples whose centre
falls outside the input zeroed. Each axis is a (B, in, out) weight matrix
built from the sample's scale and translation and applied as a batched
product, in f32 (full precision on the card: no TF32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from devit_tpu_torch.core.hsic import f32_matmul

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    img_size: int = 224
    # timm create_transform(no_aug=True): Resize(img_size) + CenterCrop +
    # Normalize, no randomness
    no_aug: bool = False
    hflip: bool = True
    rrc_scale: Tuple[float, float] = (0.08, 1.0)
    rrc_ratio: Tuple[float, float] = (3 / 4, 4 / 3)
    interpolation: str = "bicubic"  # bicubic | bilinear | random (per sample)
    color_jitter: float = 0.4
    reprob: float = 0.25  # random erasing probability
    re_mode: str = "pixel"  # pixel | rand | const
    re_count: int = 1  # timm max_count: count ~ randint(1, re_count)
    randaugment: bool = True
    ra_magnitude: int = 9  # rand-m9-mstd0.5-inc1
    ra_std: float = 0.5
    ra_num_ops: int = 2
    ra_inc: bool = True
    ra_weighted: bool = False  # timm 'w0' op-choice weights
    # AutoAugment policy name: host-PIL path only (data/autoaugment.py)
    autoaugment: Optional[str] = None
    small_image: bool = False  # RandomCrop(pad 4) path for 32x32 inputs


def _scalar(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def normalize(images: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8/float [0,255] NHWC -> standardized float (scaled by 1/255 once).

    Every division is by a tensor on the images' device: PyTorch's CUDA
    `tensor / python_scalar` multiplies by the reciprocal, which can be an ulp
    off the IEEE quotient that JAX (and the CPU) compute."""
    x = images.to(torch.float32)
    x = x / _scalar(255.0, x.device)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


# ---------------------------------------------------------------- resampling


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def _weight_mat(in_size: int, out_size: int, inv_scale: torch.Tensor,
                translation: torch.Tensor, method: str) -> torch.Tensor:
    """jax.image's compute_weight_mat (antialias on) for B samples: inv_scale
    and translation (B,) f32 -> (B, in_size, out_size) f32."""
    dev = inv_scale.device
    inv_scale, translation = inv_scale[:, None, None], translation[:, None, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)[None, None, :]
    sample_f = (out_idx + 0.5) * inv_scale - translation * inv_scale - 0.5  # (B, 1, out)
    in_idx = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    w = _KERNELS[method]((sample_f - in_idx).abs() / kernel_scale)
    total = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def _resample(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) f32 through (B, H, oh) and (B, W, ow) -> (B, oh, ow, C)."""
    B, H, W, C = x.shape
    y = torch.bmm(wy.transpose(1, 2), x.reshape(B, H, W * C))  # (B, oh, W*C)
    oh = y.shape[1]
    y = y.reshape(B, oh, W, C).permute(0, 1, 3, 2).reshape(B, oh * C, W)
    y = torch.bmm(y, wx)  # (B, oh*C, ow)
    return y.reshape(B, oh, C, -1).permute(0, 1, 3, 2).contiguous()


def resize(images: torch.Tensor, oh: int, ow: int, method: str = "cubic") -> torch.Tensor:
    """jax.image.resize(images, (B, oh, ow, C), method) in f32: the scale is
    out/in, its inverse taken in double and rounded to f32, no translation."""
    B, H, W, C = images.shape
    x = images.to(torch.float32)
    dev = x.device
    ones = torch.ones(B, dtype=torch.float32, device=dev)
    zeros = torch.zeros(B, dtype=torch.float32, device=dev)
    wy = (_weight_mat(H, oh, ones * float(np.float32(1.0 / np.float32(oh / H))), zeros, method)
          if oh != H else None)
    wx = (_weight_mat(W, ow, ones * float(np.float32(1.0 / np.float32(ow / W))), zeros, method)
          if ow != W else None)
    with f32_matmul():  # TF32 would keep ~10 mantissa bits
        if wy is None:
            wy = torch.eye(H, dtype=torch.float32, device=dev).expand(B, H, H)
        if wx is None:
            wx = torch.eye(W, dtype=torch.float32, device=dev).expand(B, W, W)
        return _resample(x, wy, wx)


def resize_bicubic(images: torch.Tensor, size: int) -> torch.Tensor:
    return resize(images, size, size, "cubic")


def resize_center_crop(images: torch.Tensor, scale_size: int, img_size: int,
                       method: str = "cubic") -> torch.Tensor:
    """torchvision Resize(int) + CenterCrop: the shorter side to scale_size
    (the longer int-truncated), then a centre crop at int(round((dim -
    crop) / 2)). Returns f32 pixels."""
    B, H, W, C = images.shape
    if H <= W:
        nh, nw = scale_size, int(scale_size * W / H)
    else:
        nh, nw = int(scale_size * H / W), scale_size
    x = resize(images, nh, nw, method)
    top = int(round((nh - img_size) / 2.0))
    left = int(round((nw - img_size) / 2.0))
    return x[:, top:top + img_size, left:left + img_size, :]


def eval_transform(images: torch.Tensor, img_size: int = 224,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Resize(int(256/224 * size)) + CenterCrop(size) + normalize; inputs
    already at the target size are only normalized."""
    B, H, W, C = images.shape
    if (H, W) == (img_size, img_size):
        return normalize(images, dtype)
    return normalize(resize_center_crop(images, int((256 / 224) * img_size), img_size), dtype)


# ---------------------------------------------------------------- host draws


@dataclasses.dataclass
class EraseBox:
    """One random-erasing box of sample b: rows y0 .. y0 + h, columns x0 ..
    x0 + w, filled with `fill` ((h, w, C) 'pixel', (C,) 'rand', None
    'const': zeros), in the normalized domain."""

    b: int
    y0: int
    x0: int
    h: int
    w: int
    fill: Optional[torch.Tensor]


@dataclasses.dataclass
class TrainDraws:
    """Every random choice of one train_transform call, on the host.
    crop: (B, 4) f32 [y0, x0, h, w] of the RRC box, or (B, 2) int64 pad-4
    offsets [oy, ox] for the small-image crop; cubic: (B,) bool (the
    resample filter per sample); flip: (B,) bool; ra: RandAugment's draws
    (data/randaugment.py RandAugmentDraws) or None; jitter: (B, 3) f32
    brightness/contrast/saturation factors and jitter_perm (B,) int64 (an
    index into JITTER_PERMS), or None; erase: the boxes in the order they
    land."""

    crop: torch.Tensor
    cubic: torch.Tensor
    flip: torch.Tensor
    ra: Optional[object] = None
    jitter: Optional[torch.Tensor] = None
    jitter_perm: Optional[torch.Tensor] = None
    erase: List[EraseBox] = dataclasses.field(default_factory=list)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    """U[lo, hi) in f32, as jax.random.uniform(minval, maxval) scales."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    lo_t, hi_t = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def _randint(gen: torch.Generator, hi: torch.Tensor) -> torch.Tensor:
    """U{0, hi - 1} per element of the int64 tensor hi (>= 1)."""
    return torch.minimum((torch.rand(hi.shape, generator=gen, dtype=torch.float64)
                          * hi).long(), hi - 1)


def _draw_rrc(gen: torch.Generator, B: int, H: int, W: int, cfg: AugmentConfig) -> torch.Tensor:
    """torchvision RandomResizedCrop.get_params for B samples, in f32 as the
    JAX package computes it: 10 tries of (area, log-uniform aspect), sides
    rounded, the first try that fits wins; else the ratio-clamped centre
    crop. Returns (B, 4) f32 [y0, x0, h, w]."""
    area = H * W * _uniform(gen, (B, 10), cfg.rrc_scale[0], cfg.rrc_scale[1])
    ratio = torch.exp(_uniform(gen, (B, 10), math.log(cfg.rrc_ratio[0]),
                               math.log(cfg.rrc_ratio[1])))
    ws = torch.round(torch.sqrt(area * ratio))
    hs = torch.round(torch.sqrt(area / ratio))
    valid = (ws > 0) & (ws <= W) & (hs > 0) & (hs <= H)
    idx = valid.to(torch.int8).argmax(dim=1, keepdim=True)  # the first valid try
    any_valid = valid.any(dim=1)
    in_ratio = W / H
    if in_ratio < cfg.rrc_ratio[0]:
        fw, fh = W, int(round(W / cfg.rrc_ratio[0]))
    elif in_ratio > cfg.rrc_ratio[1]:
        fh, fw = H, int(round(H * cfg.rrc_ratio[1]))
    else:
        fw, fh = W, H
    w = torch.where(any_valid, ws.gather(1, idx)[:, 0], torch.tensor(float(fw)))
    h = torch.where(any_valid, hs.gather(1, idx)[:, 0], torch.tensor(float(fh)))
    i = _randint(gen, (H - h + 1).long()).float()
    j = _randint(gen, (W - w + 1).long()).float()
    y0 = torch.where(any_valid, i, torch.tensor(float((H - fh) // 2)))
    x0 = torch.where(any_valid, j, torch.tensor(float((W - fw) // 2)))
    return torch.stack([y0, x0, h, w], dim=1)


JITTER_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def _draw_erase(gen: torch.Generator, B: int, H: int, W: int, C: int, prob: float,
                mode: str, max_count: int) -> List[EraseBox]:
    """timm RandomErasing for B samples: one apply coin each; count ~
    randint(1, max_count) boxes, each of area budget area/count from 10
    tries of (area, log-uniform aspect), the first that fits (h < H, w < W)
    wins, none -> no box; the fill per mode, N(0, 1)."""
    if mode not in ("pixel", "rand", "const"):
        raise ValueError(f"--remode {mode!r}: expected pixel|rand|const")
    boxes = []
    apply = torch.rand(B, generator=gen) < prob
    for b in range(B):
        if not bool(apply[b]):
            continue
        count = 1 if max_count == 1 else int(torch.randint(1, max_count + 1, (), generator=gen))
        for _ in range(count):
            area = (H * W / count) * _uniform(gen, (10,), 0.02, 1 / 3)
            ratio = torch.exp(_uniform(gen, (10,), math.log(0.3), math.log(10 / 3)))
            ehs = torch.round(torch.sqrt(area * ratio))
            ews = torch.round(torch.sqrt(area / ratio))
            valid = (ehs > 0) & (ehs < H) & (ews > 0) & (ews < W)
            pos = torch.rand(2, generator=gen)
            if not bool(valid.any()):
                continue
            k = int(valid.to(torch.int8).argmax())
            eh, ew = int(ehs[k]), int(ews[k])
            y0 = int(math.floor(float(pos[0]) * (H - eh + 1)))
            x0 = int(math.floor(float(pos[1]) * (W - ew + 1)))
            fill = (torch.randn((eh, ew, C), generator=gen) if mode == "pixel"
                    else torch.randn((C,), generator=gen) if mode == "rand" else None)
            boxes.append(EraseBox(b, y0, x0, eh, ew, fill))
    return boxes


def draw_train(gen: torch.Generator, shape, cfg: AugmentConfig) -> TrainDraws:
    """Every random choice train_transform makes for a (B, H, W, C) batch,
    drawn on the host from `gen` (a CPU generator)."""
    B, H, W, C = shape
    if cfg.small_image:
        crop = torch.randint(0, 9, (B, 2), generator=gen)
    else:
        crop = _draw_rrc(gen, B, H, W, cfg)
    if cfg.interpolation not in ("bicubic", "bilinear", "random"):
        raise ValueError(f"--train-interpolation {cfg.interpolation!r}: "
                         "expected bicubic|bilinear|random")
    coin = torch.rand(B, generator=gen) < 0.5
    cubic = (coin if cfg.interpolation == "random"
             else torch.full((B,), cfg.interpolation == "bicubic"))
    flip = (torch.rand(B, generator=gen) < 0.5) if cfg.hflip else torch.zeros(B, dtype=torch.bool)
    draws = TrainDraws(crop=crop, cubic=cubic, flip=flip)
    if cfg.randaugment:
        from devit_tpu_torch.data.randaugment import draw_rand_augment

        draws.ra = draw_rand_augment(gen, B, magnitude=cfg.ra_magnitude, mag_std=cfg.ra_std,
                                     num_ops=cfg.ra_num_ops, inc=cfg.ra_inc,
                                     weighted=cfg.ra_weighted)
    elif cfg.color_jitter > 0:
        lo = max(0.0, 1.0 - cfg.color_jitter)
        draws.jitter = _uniform(gen, (B, 3), lo, 1 + cfg.color_jitter)
        draws.jitter_perm = torch.randint(0, len(JITTER_PERMS), (B,), generator=gen)
    if cfg.reprob > 0:
        out_hw = (H, W) if cfg.small_image else (cfg.img_size, cfg.img_size)
        draws.erase = _draw_erase(gen, B, *out_hw, C, cfg.reprob, cfg.re_mode, cfg.re_count)
    return draws


# ---------------------------------------------------------------- device side


def random_resized_crop(images: torch.Tensor, crop: torch.Tensor, cubic: torch.Tensor,
                        img_size: int) -> torch.Tensor:
    """Crop each sample's [y0, x0, h, w] box and resample it to img_size in
    one scale_and_translate (scale img_size / side, translation -origin *
    scale, f32), cubic or linear per sample. Returns f32 pixels."""
    B, H, W, C = images.shape
    dev = images.device
    crop = crop.to(dev)
    y0, x0, h, w = crop.unbind(1)
    size = _scalar(float(img_size), dev)
    sy, sx = size / h, size / w
    one = _scalar(1.0, dev)
    iy, ix = one / sy, one / sx
    ty, tx = -y0 * sy, -x0 * sx
    def weights(n, inv, tr):
        if bool(cubic.all()) or not bool(cubic.any()):  # one filter for the batch
            return _weight_mat(n, img_size, inv, tr, "cubic" if bool(cubic.all()) else "linear")
        return torch.where(cubic.to(dev)[:, None, None], _weight_mat(n, img_size, inv, tr, "cubic"),
                           _weight_mat(n, img_size, inv, tr, "linear"))

    wy, wx = weights(H, iy, ty), weights(W, ix, tx)
    with f32_matmul():  # TF32 would keep ~10 mantissa bits
        return _resample(images.to(torch.float32), wy, wx)


def random_crop_pad4(images: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """torchvision RandomCrop(padding=4): zero-pad 4, crop back at each
    sample's [oy, ox] in 0..8."""
    B, H, W, C = images.shape
    padded = torch.nn.functional.pad(images.to(torch.float32), (0, 0, 4, 4, 4, 4))
    dev = images.device
    rows = offsets[:, 0].to(dev)[:, None] + torch.arange(H, device=dev)[None]  # (B, H)
    cols = offsets[:, 1].to(dev)[:, None] + torch.arange(W, device=dev)[None]
    b = torch.arange(B, device=dev)[:, None, None]
    return padded[b, rows[:, :, None], cols[:, None, :]]


_LUMA = (0.299, 0.587, 0.114)  # ITU-R 601


def gray(x: torch.Tensor) -> torch.Tensor:
    """Luma of (..., 3) f32 pixels, (...,)."""
    return x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1] + x[..., 2] * _LUMA[2]


def color_jitter(images: torch.Tensor, factors: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter(brightness, contrast, saturation) with each
    sample's factors (B, 3) applied in its order JITTER_PERMS[perm], each op
    clamped to [0, 255]; contrast blends toward the mean luma of the image,
    saturation toward each pixel's luma."""
    dev = images.device
    f = factors.to(dev)[:, :, None, None, None]  # (B, 3, 1, 1, 1)
    order = torch.tensor(JITTER_PERMS, device=dev)[perm.to(dev)]  # (B, 3)

    def apply(op: int, x: torch.Tensor) -> torch.Tensor:
        if op == 0:
            return torch.clamp(x * f[:, 0], 0.0, 255.0)
        if op == 1:
            m = gray(x).mean(dim=(1, 2))[:, None, None, None]
            return torch.clamp(m + f[:, 1] * (x - m), 0.0, 255.0)
        g = gray(x)[..., None]
        return torch.clamp(g + f[:, 2] * (x - g), 0.0, 255.0)

    x = images.to(torch.float32)
    for slot in range(3):
        outs = torch.stack([apply(op, x) for op in range(3)])  # (3, B, H, W, C)
        x = outs[order[:, slot], torch.arange(x.shape[0], device=dev)]
    return x


def random_erase(x: torch.Tensor, boxes: List[EraseBox]) -> torch.Tensor:
    """Erase the boxes in order (an overlap overwrites), in place on the
    normalized f32 batch x, which it returns."""
    for box in boxes:
        region = x[box.b, box.y0:box.y0 + box.h, box.x0:box.x0 + box.w]
        if box.fill is None:
            region.zero_()
        else:
            region.copy_(box.fill.to(x.device).expand_as(region))
    return x


def apply_train(images: torch.Tensor, draws: TrainDraws, cfg: AugmentConfig,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The train transform of fixed draws on the images' device: uint8 (B,
    H, W, 3) -> normalized (B, img_size, img_size, 3) of `dtype`."""
    if cfg.small_image:
        x = random_crop_pad4(images, draws.crop)
    else:
        x = random_resized_crop(images, draws.crop, draws.cubic, cfg.img_size)
    flip = draws.flip.to(x.device)[:, None, None, None]
    x = torch.where(flip, x.flip(2), x)
    if draws.ra is not None:
        from devit_tpu_torch.data.randaugment import apply_rand_augment

        x = apply_rand_augment(x, draws.ra)
    elif draws.jitter is not None:
        x = color_jitter(x, draws.jitter, draws.jitter_perm)
    x = normalize(x, torch.float32)
    return random_erase(x, draws.erase).to(dtype)


def finish_transform(gen: torch.Generator, images: torch.Tensor, cfg: AugmentConfig,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The device tail of host-augmented batches (data/host_augment.py):
    normalize, then random erasing (boxes drawn on the host from gen)."""
    out = normalize(images, torch.float32)
    if cfg.reprob > 0:
        B, H, W, C = images.shape
        out = random_erase(out, _draw_erase(gen, B, H, W, C, cfg.reprob, cfg.re_mode,
                                            cfg.re_count))
    return out.to(dtype)


def train_transform(gen: torch.Generator, images: torch.Tensor, cfg: AugmentConfig,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Batched train augmentation: uint8 (B, H, W, 3) on any device ->
    normalized (B, size, size, 3) there; the draws from `gen` on the host."""
    if cfg.autoaugment is not None and not cfg.no_aug:
        raise ValueError("AutoAugment (--aa original/cifar10) has no device implementation: "
                         "its geometric ops are host-PIL only (data/autoaugment.py)")
    if cfg.no_aug:
        # timm transforms_noaug_train: Resize(img_size) + CenterCrop +
        # Normalize (the resize honours the interpolation; 'random' ->
        # bilinear, as timm 0.5.4 falls back)
        B, H, W, C = images.shape
        method = {"bicubic": "cubic", "bilinear": "linear", "random": "linear"}[cfg.interpolation]
        x = (images.to(torch.float32) if (H, W) == (cfg.img_size, cfg.img_size)
             else resize_center_crop(images, cfg.img_size, cfg.img_size, method=method))
        return normalize(x, dtype)
    return apply_train(images, draw_train(gen, tuple(images.shape), cfg), cfg, dtype)
