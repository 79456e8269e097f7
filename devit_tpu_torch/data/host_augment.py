"""Host-side train augmentation: PIL RandomResizedCrop + hflip + RandAugment
(or AutoAugment), run in BatchIterator's prefetch threads so it overlaps
the device's work (a copy of devit_tpu/data/host_augment.py; only its
imports change).

Each op is the PIL call timm makes. The device then runs normalize, random
erasing and mixup (data/pipeline.py finish_transform, data/mixup.py), the
tensor-space ops timm also runs after ToTensor. PIL is imported inside the
functions: the module imports without it, and a machine without PIL uses
the device transform (data/pipeline.py train_transform).

Threaded with a shared ThreadPoolExecutor (PIL releases the GIL for the
heavy ops). Determinism: one np.random Generator seeded per (seed, epoch,
batch_index, sample).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

_FILL = (124, 116, 104)  # timm aa_params img_mean fill
_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    # locked: two producer threads (an abandoned epoch's still-draining
    # producer + the next epoch's) can race the first call; the loser's
    # executor would leak its idle workers for the process lifetime
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1))
    return _POOL


# ----------------------------------------------------- timm RandAugment (PIL)


def _enhance_factor(mag: float) -> float:
    return 1.0 + 0.9 * mag / 10.0  # increasing variant; sign applied by caller


def _apply_op(img, name: str, mag: float, rng: np.random.Generator,
              resample=None, inc: bool = True):
    """One timm rand_augment_ops op at (possibly negative) magnitude `mag` —
    each body is the PIL call timm 0.5.4 makes. `resample` is the geometric
    ops' filter: a PIL constant, or a tuple for timm's 'random' train
    interpolation (_RANDOM_INTERPOLATION: choose per op application).
    inc=False selects the NON-increasing level maps (recipes without 'inc1'):
    Posterize keeps int(4m/10) bits, Solarize threshold int(256m/10), enhance
    factor 0.1 + 1.8m/10 unsigned (callers pass mag unsigned then)."""
    from PIL import Image, ImageEnhance, ImageOps

    if resample is None:
        resample = Image.BICUBIC
    elif isinstance(resample, tuple):
        resample = resample[int(rng.integers(0, len(resample)))]
    if name == "autocontrast":
        return ImageOps.autocontrast(img)
    if name == "equalize":
        return ImageOps.equalize(img)
    if name == "invert":
        return ImageOps.invert(img)
    if name == "rotate":
        return img.rotate(30.0 * mag / 10.0, resample=resample,
                          fillcolor=_FILL)
    if name == "posterize":
        bits = (int(4 * abs(mag) / 10) if not inc
                else max(0, 4 - int(4 * abs(mag) / 10)))
        return ImageOps.posterize(img, bits)
    if name == "solarize":
        thresh = (int(256 * abs(mag) / 10) if not inc
                  else 256 - int(256 * abs(mag) / 10))
        # thresh can be 256 (inc m=0 / non-inc m=10): "above every pixel",
        # identity — PIL's lut comprehension handles it
        return ImageOps.solarize(img, thresh)
    if name == "solarize_add":
        add = int(110 * abs(mag) / 10)
        lut = [min(255, i + add) if i < 128 else i for i in range(256)]
        return img.point(lut * len(img.getbands()))
    def _ef(m: float) -> float:
        # non-inc: timm _enhance_level_to_arg, 0.1 + 1.8m/10 (unsigned)
        return _enhance_factor(m) if inc else 0.1 + 1.8 * abs(m) / 10.0

    if name == "color":
        return ImageEnhance.Color(img).enhance(_ef(mag))
    if name == "contrast":
        return ImageEnhance.Contrast(img).enhance(_ef(mag))
    if name == "brightness":
        return ImageEnhance.Brightness(img).enhance(_ef(mag))
    if name == "sharpness":
        return ImageEnhance.Sharpness(img).enhance(_ef(mag))
    if name == "shear_x":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0.3 * mag / 10.0, 0, 0, 1, 0),
                             resample=resample, fillcolor=_FILL)
    if name == "shear_y":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, 0, 0.3 * mag / 10.0, 1, 0),
                             resample=resample, fillcolor=_FILL)
    if name == "translate_x":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, 0.45 * mag / 10.0 * img.size[0], 0, 1, 0),
                             resample=resample, fillcolor=_FILL)
    if name == "translate_y":
        return img.transform(img.size, Image.AFFINE,
                             (1, 0, 0, 0, 1, 0.45 * mag / 10.0 * img.size[1]),
                             resample=resample, fillcolor=_FILL)
    raise KeyError(name)


_OP_NAMES = [
    "autocontrast", "equalize", "invert", "rotate", "posterize", "solarize",
    "solarize_add", "color", "contrast", "brightness", "sharpness",
    "shear_x", "shear_y", "translate_x", "translate_y",
]
_SIGNED = {"rotate", "shear_x", "shear_y", "translate_x", "translate_y",
           "color", "contrast", "brightness", "sharpness"}
_GEOM_SIGNED = {"rotate", "shear_x", "shear_y", "translate_x", "translate_y"}
# timm _RAND_CHOICE_WEIGHTS_0 in _OP_NAMES order (see randaugment.py
# CHOICE_WEIGHTS_0 for the per-name table; sums to exactly 1.0)
_CHOICE_WEIGHTS_0 = (0.025, 0.005, 0.0, 0.3, 0.0, 0.005, 0.005, 0.025,
                     0.005, 0.005, 0.025, 0.2, 0.2, 0.1, 0.1)


def _rand_augment_pil(img, rng: np.random.Generator, magnitude: float,
                      mag_std: float, num_ops: int, prob: float,
                      resample=None, inc: bool = True, weighted: bool = False):
    # non-inc mode: enhance ops use the unsigned 0.1+1.8m/10 map — only the
    # geometric ops keep timm's random negation
    signed = _SIGNED if inc else _GEOM_SIGNED
    if weighted:
        # timm RandAugment.__call__: np.random.choice(ops, num_layers,
        # replace=choice_weights is None, p=choice_weights) — with w0 the
        # ops applied to one image are drawn WITHOUT replacement (distinct)
        names = [_OP_NAMES[i] for i in rng.choice(
            len(_OP_NAMES), size=num_ops, replace=False, p=_CHOICE_WEIGHTS_0)]
    else:
        names = [_OP_NAMES[rng.integers(len(_OP_NAMES))]
                 for _ in range(num_ops)]
    for name in names:
        if rng.random() >= prob:
            continue
        if np.isinf(mag_std):
            # timm AugmentOp: magnitude_std == inf -> uniform(0, magnitude),
            # then the unconditional min(_MAX_LEVEL, max(0, .)) clip all
            # branches share (auto_augment.py in the pinned 0.5.4; reachable
            # via 'mstdinf' — the 'mstd100 -> inf' shorthand is a timm>=0.6
            # convention the pinned version does not have)
            mag = float(np.clip(rng.uniform(0.0, magnitude), 0.0, 10.0))
        elif mag_std > 0:
            mag = float(np.clip(rng.normal(magnitude, mag_std), 0.0, 10.0))
        else:
            mag = float(np.clip(magnitude, 0.0, 10.0))
        if name in signed and rng.random() < 0.5:
            mag = -mag
        img = _apply_op(img, name, mag, rng, resample=resample, inc=inc)
    return img


# -------------------------------------------------- torchvision RRC (PIL)


def _rrc_params(rng: np.random.Generator, w: int, h: int,
                scale: Tuple[float, float], ratio: Tuple[float, float]):
    """torchvision RandomResizedCrop.get_params: 10 tries, first valid."""
    area = w * h
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target = area * rng.uniform(scale[0], scale[1])
        ar = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            i = int(rng.integers(0, h - ch + 1))
            j = int(rng.integers(0, w - cw + 1))
            return i, j, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


def make_host_train_augment(cfg, seed: int = 0):
    """Returns `transform(images_u8, epoch, batch_index) -> uint8
    (B, img_size, img_size, 3)` applying RRC + hflip + RandAugment (or the
    reference's AutoAugment policy, cfg.autoaugment) per image with PIL,
    threaded. Small-image inputs (cfg.small_image) get RandomCrop(pad 4)
    instead of RRC — the reference's transform[0] swap (get_dataset.py:92-96).
    `cfg` is a data.pipeline.AugmentConfig."""
    from PIL import Image, ImageOps

    # timm 0.5.4 transforms_imagenet_train: aa_params['interpolation'] is the
    # TRAIN interpolation unless 'random', which leaves timm's
    # _RANDOM_INTERPOLATION = (BILINEAR, BICUBIC), chosen per op application.
    # (--train-interpolation bilinear must warp the RA geometric ops with
    # bilinear too, not just the RRC.)
    _interp = getattr(cfg, "interpolation", "bicubic")
    ra_resample = ((Image.BILINEAR, Image.BICUBIC) if _interp == "random"
                   else {"bicubic": Image.BICUBIC,
                         "bilinear": Image.BILINEAR}[_interp])

    aa_policy = None
    if getattr(cfg, "autoaugment", None):
        from devit_tpu_torch.data.autoaugment import get_policy

        aa_policy = get_policy(cfg.autoaugment)

    def one(img_np: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        img = Image.fromarray(img_np)
        if cfg.small_image:
            # torchvision RandomCrop(img_size, padding=4), fill 0
            img = ImageOps.expand(img, border=4, fill=0)
            i = int(rng.integers(0, img.size[1] - cfg.img_size + 1))
            j = int(rng.integers(0, img.size[0] - cfg.img_size + 1))
            img = img.crop((j, i, j + cfg.img_size, i + cfg.img_size))
        else:
            i, j, ch, cw = _rrc_params(rng, img.size[0], img.size[1],
                                       cfg.rrc_scale, cfg.rrc_ratio)
            interp = getattr(cfg, "interpolation", "bicubic")
            if interp == "random":
                # timm RandomResizedCropAndInterpolation 'random':
                # random.choice((BILINEAR, BICUBIC)) per call
                resample = (Image.BILINEAR, Image.BICUBIC)[int(rng.integers(0, 2))]
            else:
                resample = {"bicubic": Image.BICUBIC,
                            "bilinear": Image.BILINEAR}[interp]
            img = img.resize((cfg.img_size, cfg.img_size), resample,
                             box=(j, i, j + cw, i + ch))
        if cfg.hflip and rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if aa_policy is not None:
            from devit_tpu_torch.data.autoaugment import auto_augment_pil

            img = auto_augment_pil(img, rng, aa_policy)
        elif cfg.randaugment:
            img = _rand_augment_pil(img, rng, float(cfg.ra_magnitude),
                                    cfg.ra_std, cfg.ra_num_ops, prob=0.5,
                                    resample=ra_resample,
                                    inc=getattr(cfg, "ra_inc", True),
                                    weighted=getattr(cfg, "ra_weighted", False))
        return np.asarray(img, np.uint8)

    def transform(images: np.ndarray, epoch: int, batch_index: int) -> np.ndarray:
        rngs = [np.random.default_rng(
                    (seed, epoch, batch_index, k)) for k in range(len(images))]
        out = list(_pool().map(one, images, rngs))
        return np.stack(out)

    return transform
