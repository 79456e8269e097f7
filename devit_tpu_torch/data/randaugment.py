"""RandAugment on batched device images (counterpart of
devit_tpu/data/randaugment.py), timm's `rand-m9-mstd0.5-inc1` policy.

Ops work on f32 [0, 255] NHWC batches with one magnitude per sample, and
follow the JAX package (not timm) where the two differ: geometric ops are
bilinear with PIL's pixel-centre convention and the per-channel fill (124,
116, 104); equalize is PIL's per-channel histogram; sharpness a 3x3
smoothing kernel with the border kept; posterize/solarize/enhance maps in
the increasing (inc) and non-increasing forms.

The draws (op per slot, apply coin, jittered magnitude and its sign) are
made on the host (`draw_rand_augment`) and applied on the images' device
(`apply_rand_augment`): for each slot, the samples that apply op k are
gathered, transformed together and written back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from devit_tpu_torch.data.pipeline import gray

_MAX_MAG = 10.0
_FILL = (124.0, 116.0, 104.0)  # timm's fill: the rounded IMAGENET mean


def _col(m: torch.Tensor) -> torch.Tensor:
    """(N,) per-sample values -> (N, 1, 1, 1)."""
    return m[:, None, None, None]


# ---------------------------------------------------------------- geometry


def _affine(images: torch.Tensor, matrix: torch.Tensor, center: bool = True) -> torch.Tensor:
    """The inverse affine [a b ty; c d tx] per sample (matrix (N, 6)),
    anchored at the image centre (PIL rotate) or the top-left origin (PIL's
    AffineTransform, timm's shear/translate). Bilinear, out-of-image taps
    take the channel's fill (jax.scipy.ndimage.map_coordinates, order 1,
    constant mode)."""
    N, H, W, C = images.shape
    dev = images.device
    cy, cx = (H / 2.0, W / 2.0) if center else (0.0, 0.0)
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    y = yy + 0.5 - cy
    x = xx + 0.5 - cx
    m = [matrix[:, i][:, None, None] for i in range(6)]
    src_y = m[0] * y + m[1] * x + m[2] + cy - 0.5  # (N, H, W)
    src_x = m[3] * y + m[4] * x + m[5] + cx - 0.5
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - y0, src_x - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    iy0, ix0 = y0.long(), x0.long()
    fill = torch.tensor(_FILL, dtype=torch.float32, device=dev)
    flat = images.reshape(N, H * W, C)
    out = None
    for iy, wy in ((iy0, wy0), (iy0 + 1, wy1)):
        for ix, wx in ((ix0, wx0), (ix0 + 1, wx1)):
            ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(N, H * W, 1)
            v = torch.gather(flat, 1, idx.expand(N, H * W, C)).reshape(N, H, W, C)
            term = (wy * wx)[..., None] * torch.where(ok[..., None], v, fill)
            out = term if out is None else out + term
    return out


def _stack6(*cols) -> torch.Tensor:
    return torch.stack(cols, dim=1)


def _rotate(images, mag):
    rad = torch.deg2rad(mag / _MAX_MAG * 30.0)
    c, s = torch.cos(rad), torch.sin(rad)
    z = torch.zeros_like(mag)
    return _affine(images, _stack6(c, s, z, -s, c, z))


def _shear_x(images, mag):
    sh = mag / _MAX_MAG * 0.3
    o, z = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine(images, _stack6(o, z, z, sh, o, z), center=False)


def _shear_y(images, mag):
    sh = mag / _MAX_MAG * 0.3
    o, z = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine(images, _stack6(o, sh, z, z, o, z), center=False)


def _translate_x(images, mag):
    t = mag / _MAX_MAG * 0.45 * images.shape[2]
    o, z = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine(images, _stack6(o, z, z, z, o, t), center=False)


def _translate_y(images, mag):
    t = mag / _MAX_MAG * 0.45 * images.shape[1]
    o, z = torch.ones_like(mag), torch.zeros_like(mag)
    return _affine(images, _stack6(o, z, t, z, o, z), center=False)


# ---------------------------------------------------------------- intensity


def _autocontrast(images, mag):
    lo = images.amin(dim=(1, 2), keepdim=True)
    hi = images.amax(dim=(1, 2), keepdim=True)
    scale = 255.0 / torch.clamp(hi - lo, min=1e-5)
    return torch.where(hi > lo, (images - lo) * scale, images)


def _equalize(images, mag):
    """PIL ImageOps.equalize per sample and channel: step = (total - count
    of the last non-empty bin) // 255; lut[i] = (step // 2 + exclusive
    cdf[i]) // step; step 0 -> identity."""
    N, H, W, C = images.shape
    ints = torch.clamp(torch.round(images), 0, 255).long()  # (N, H, W, C)
    flat = ints.permute(0, 3, 1, 2).reshape(N * C, H * W)
    hist = torch.zeros((N * C, 256), dtype=torch.long, device=images.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    last = 255 - torch.flip(hist > 0, dims=[1]).to(torch.int8).argmax(dim=1)
    step = (hist.sum(dim=1) - hist.gather(1, last[:, None])[:, 0]) // 255
    cdf_excl = torch.cumsum(hist, dim=1) - hist
    lut = torch.clamp((step[:, None] // 2 + cdf_excl) // torch.clamp(step, min=1)[:, None], 0, 255)
    mapped = torch.where(step[:, None] == 0, flat, lut.gather(1, flat))
    return mapped.reshape(N, C, H, W).permute(0, 2, 3, 1).to(torch.float32)


def _invert(images, mag):
    return 255.0 - images


def _posterize_bits(images, bits):
    q = torch.exp2((8 - bits).to(torch.float32))
    return torch.floor(images / _col(q)) * _col(q)


def _posterize(images, mag):
    # timm PosterizeIncreasing: keep 4 - int(4 m / 10) bits
    return _posterize_bits(images, 4 - torch.floor(mag / _MAX_MAG * 4).long())


def _posterize_noinc(images, mag):
    # timm Posterize: keep int(4 m / 10) bits
    return _posterize_bits(images, torch.floor(mag / _MAX_MAG * 4).long())


def _solarize(images, mag):
    thresh = _col(256.0 - torch.floor(mag / _MAX_MAG * 256.0))
    return torch.where(images >= thresh, 255.0 - images, images)


def _solarize_noinc(images, mag):
    thresh = _col(torch.floor(mag / _MAX_MAG * 256.0))
    return torch.where(images >= thresh, 255.0 - images, images)


def _solarize_add(images, mag):
    add = _col(torch.floor(mag / _MAX_MAG * 110.0))
    return torch.where(images < 128.0, torch.clamp(images + add, 0, 255), images)


def _blend_factor(mag):
    return mag / _MAX_MAG * 0.9


def _color(images, mag):
    f = _col(1.0 + _blend_factor(mag))
    g = gray(images)[..., None]
    return torch.clamp(g + (images - g) * f, 0, 255)


def _contrast(images, mag):
    # PIL ImageEnhance.Contrast blends toward int(mean luma + 0.5)
    f = _col(1.0 + _blend_factor(mag))
    mean = _col(torch.floor(gray(images).mean(dim=(1, 2)) + 0.5))
    return torch.clamp(mean + (images - mean) * f, 0, 255)


def _brightness(images, mag):
    return torch.clamp(images * _col(1.0 + _blend_factor(mag)), 0, 255)


def _sharpness(images, mag):
    """PIL's SMOOTH filter ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13) inside,
    the 1-pixel border unfiltered, then the blend. Sums written out (no
    convolution library call: cuDNN would take TF32)."""
    f = _col(1.0 + _blend_factor(mag))
    w1, w5 = float(np.float32(1.0 / 13.0)), float(np.float32(5.0 / 13.0))
    H, W = images.shape[1:3]
    x = images
    inner = x[:, 1:H - 1, 1:W - 1] * w5
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                inner = inner + x[:, 1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx] * w1
    blurred = x.clone()
    blurred[:, 1:H - 1, 1:W - 1] = inner
    return torch.clamp(blurred + (images - blurred) * f, 0, 255)


OPS = [
    _autocontrast, _equalize, _invert, _rotate, _posterize, _solarize,
    _solarize_add, _color, _contrast, _brightness, _sharpness,
    _shear_x, _shear_y, _translate_x, _translate_y,
]
OP_NAMES = [
    "autocontrast", "equalize", "invert", "rotate", "posterize", "solarize",
    "solarize_add", "color", "contrast", "brightness", "sharpness",
    "shear_x", "shear_y", "translate_x", "translate_y",
]
# timm _RAND_CHOICE_WEIGHTS_0 ('w0') in OP_NAMES order
CHOICE_WEIGHTS_0 = (0.025, 0.005, 0.0, 0.3, 0.0, 0.005, 0.005, 0.025, 0.005, 0.005, 0.025,
                    0.2, 0.2, 0.1, 0.1)
_ENHANCE_OPS = {7, 8, 9, 10}
_GEOM_SIGNED = {3, 11, 12, 13, 14}
# the ops whose output steps at integer boundaries of the input
STEPPED_OPS = {"posterize", "solarize", "solarize_add", "equalize", "autocontrast", "contrast"}


def op(index: int, inc: bool = True):
    """The op at OP_NAMES[index] in the increasing (inc) or timm's
    non-increasing set: f(images (N, H, W, C) f32, mag (N,) f32)."""
    if not inc and index == 4:
        return _posterize_noinc
    if not inc and index == 5:
        return _solarize_noinc
    return OPS[index]


def weighted_op_indices(gen: torch.Generator, batch: int, num_ops: int) -> torch.Tensor:
    """timm w0 op choice: num_ops distinct indices per sample drawn from
    CHOICE_WEIGHTS_0 without replacement (Gumbel-top-k, which is
    distributed as sequential weighted draws without replacement);
    zero-weight ops are never chosen. (batch, num_ops) int64."""
    logits = torch.log(torch.tensor(CHOICE_WEIGHTS_0, dtype=torch.float64))
    u = torch.rand((batch, len(OPS)), generator=gen, dtype=torch.float64)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-300)))
    return torch.topk(logits + gumbel, num_ops, dim=1).indices


@dataclasses.dataclass
class RandAugmentDraws:
    """op (B, S) int64 indices into OPS; apply (B, S) bool; mag (B, S) f32,
    the magnitude each op receives (jittered, clipped, signed where the op
    is signed, 2m - 10 for the non-inc enhance ops); inc: the op set."""

    op: torch.Tensor
    apply: torch.Tensor
    mag: torch.Tensor
    inc: bool = True


def draw_rand_augment(gen: torch.Generator, batch: int, magnitude: float = 9.0,
                      mag_std: float = 0.5, num_ops: int = 2, prob: float = 0.5,
                      inc: bool = True, weighted: bool = False) -> RandAugmentDraws:
    """RandAugment's draws for `batch` samples, on the host: per slot an op
    (uniform, or w0 without replacement), an apply coin (prob), a magnitude
    magnitude + N(0, mag_std) (uniform(0, magnitude) for an infinite std),
    clipped to [0, 10], and a sign (-1 with probability 0.5)."""
    if weighted:
        ops = weighted_op_indices(gen, batch, num_ops)
    else:
        ops = torch.randint(0, len(OPS), (batch, num_ops), generator=gen)
    apply = torch.rand((batch, num_ops), generator=gen) < prob
    if math.isinf(mag_std):
        mag = torch.rand((batch, num_ops), generator=gen) * magnitude
    elif mag_std > 0:
        mag = magnitude + torch.randn((batch, num_ops), generator=gen) * mag_std
    else:
        mag = torch.full((batch, num_ops), float(magnitude))
    mag = torch.clamp(mag.to(torch.float32), 0.0, _MAX_MAG)
    sign = torch.where(torch.rand((batch, num_ops), generator=gen) < 0.5, -1.0, 1.0)
    signed_ops = _GEOM_SIGNED | (_ENHANCE_OPS if inc else set())
    signed = torch.tensor([i in signed_ops for i in range(len(OPS))])[ops]
    noinc_enh = torch.tensor([(not inc) and i in _ENHANCE_OPS for i in range(len(OPS))])[ops]
    m = torch.where(signed, mag * sign, mag)
    m = torch.where(noinc_enh, 2.0 * mag - _MAX_MAG, m)
    return RandAugmentDraws(op=ops, apply=apply, mag=m.to(torch.float32), inc=inc)


def apply_rand_augment(images: torch.Tensor, draws: RandAugmentDraws) -> torch.Tensor:
    """The drawn ops on f32 (B, H, W, C) [0, 255] images on their device:
    slot by slot, the samples applying op k gathered, transformed and
    written back."""
    x = images.to(torch.float32).clone()
    dev = x.device
    for slot in range(draws.op.shape[1]):
        ops, apply, mag = draws.op[:, slot], draws.apply[:, slot], draws.mag[:, slot]
        for k in torch.unique(ops[apply]).tolist():
            rows = torch.nonzero(apply & (ops == k))[:, 0]
            idx = rows.to(dev)
            x[idx] = op(k, draws.inc)(x[idx], mag[rows].to(dev))
    return x


def rand_augment(gen: torch.Generator, images: torch.Tensor, magnitude: float = 9.0,
                 mag_std: float = 0.5, num_ops: int = 2, prob: float = 0.5, inc: bool = True,
                 weighted: bool = False) -> torch.Tensor:
    """`num_ops` random ops per sample, each with probability `prob`, the
    magnitude jittered by N(0, mag_std); draws from gen on the host."""
    draws = draw_rand_augment(gen, images.shape[0], magnitude, mag_std, num_ops, prob, inc,
                              weighted)
    return apply_rand_augment(images, draws)
