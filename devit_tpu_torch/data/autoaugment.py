"""AutoAugment policies for `--aa original` / `--aa cifar10` (host PIL path).

The reference's entry scripts advertise AutoAugment through the --aa flag
("v0" or "original", train_subdata.py:103-105 / shrink.py:106) and the tree
carries its own AutoAugment implementation — utils/autoaug.py +
utils/transforms.py (DeepVoltaire), the AutoAugment-paper ImageNet/CIFAR10
policies. That pair is dead code on the reference's live path (no entry
script imports it; timm would interpret the flag instead), but it is the only
AutoAugment artifact actually IN the reference tree, so it is the semantics
we pin: the policy tables below are the reference's own sub-policy tables
(autoaug.py:22-51, 76-106) and each op body is the PIL call its
transforms.py makes — verified op-for-op and table-for-table against the
reference's own module in tests/test_autoaugment_parity.py.

(A second resolved reference bug lives here: utils/autoaug.py crashes on any
numpy >= 1.24 at SubPolicy construction — `astype(np.int)`, removed from
numpy — so the reference's own AutoAugment cannot even be instantiated as
committed. The parity test patches np.int to run it.)

Op-semantics notes carried over exactly from the reference transforms.py:
- shear uses BICUBIC resampling; translate uses the PIL default (NEAREST).
- rotate composites the RGBA-rotated image over solid gray 128 (not a
  fillcolor rotate) — the DeepVoltaire trick for filled corners.
- the enhance ops use factor 1 + magnitude*sign (symmetric around identity),
  NOT timm-RA's 1 + 0.9*mag/10 convention.
- posterize bits walk 8..4 over magnitude indices; solarize thresholds walk
  256..0 (both DIFFER from the timm-RA ranges in host_augment.py).

Like the RandAugment host path, this runs as PIL in the BatchIterator
prefetch workers (a copy of devit_tpu/data/autoaugment.py; only its imports
change).
"""

from __future__ import annotations

import numpy as np

_FILL = (128, 128, 128)  # reference SubPolicy fillcolor default

# (p1, op1, magnitude_idx1, p2, op2, magnitude_idx2) — the reference's
# ImageNetPolicy table verbatim (utils/autoaug.py:22-51; the AutoAugment
# paper's 25 ImageNet sub-policies). Parity-pinned; do not "fix" duplicates.
IMAGENET_POLICY = [
    (0.4, "posterize", 8, 0.6, "rotate", 9),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
    (0.6, "posterize", 7, 0.6, "posterize", 6),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.4, "equalize", 4, 0.8, "rotate", 8),
    (0.6, "solarize", 3, 0.6, "equalize", 7),
    (0.8, "posterize", 5, 1.0, "equalize", 2),
    (0.2, "rotate", 3, 0.6, "solarize", 8),
    (0.6, "equalize", 8, 0.4, "posterize", 6),
    (0.8, "rotate", 8, 0.4, "color", 0),
    (0.4, "rotate", 9, 0.6, "equalize", 2),
    (0.0, "equalize", 7, 0.8, "equalize", 8),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "rotate", 8, 1.0, "color", 2),
    (0.8, "color", 8, 0.8, "solarize", 7),
    (0.4, "sharpness", 7, 0.6, "invert", 8),
    (0.6, "shearX", 5, 1.0, "equalize", 9),
    (0.4, "color", 0, 0.6, "equalize", 3),
    (0.4, "equalize", 7, 0.2, "solarize", 4),
    (0.6, "solarize", 5, 0.6, "autocontrast", 5),
    (0.6, "invert", 4, 1.0, "equalize", 8),
    (0.6, "color", 4, 1.0, "contrast", 8),
    (0.8, "equalize", 8, 0.6, "equalize", 3),
]

# utils/autoaug.py:76-106 — the AutoAugment paper's 25 CIFAR10 sub-policies.
CIFAR10_POLICY = [
    (0.1, "invert", 7, 0.2, "contrast", 6),
    (0.7, "rotate", 2, 0.3, "translateX", 9),
    (0.8, "sharpness", 1, 0.9, "sharpness", 3),
    (0.5, "shearY", 8, 0.7, "translateY", 9),
    (0.5, "autocontrast", 8, 0.9, "equalize", 2),
    (0.2, "shearY", 7, 0.3, "posterize", 7),
    (0.4, "color", 3, 0.6, "brightness", 7),
    (0.3, "sharpness", 9, 0.7, "brightness", 9),
    (0.6, "equalize", 5, 0.5, "equalize", 1),
    (0.6, "contrast", 7, 0.6, "sharpness", 5),
    (0.7, "color", 7, 0.5, "translateX", 8),
    (0.3, "equalize", 7, 0.4, "autocontrast", 8),
    (0.4, "translateY", 3, 0.2, "sharpness", 6),
    (0.9, "brightness", 6, 0.2, "color", 8),
    (0.5, "solarize", 2, 0.0, "invert", 3),
    (0.2, "equalize", 0, 0.6, "autocontrast", 0),
    (0.2, "equalize", 8, 0.6, "equalize", 4),
    (0.9, "color", 9, 0.6, "equalize", 6),
    (0.8, "autocontrast", 4, 0.2, "solarize", 8),
    (0.1, "brightness", 3, 0.7, "color", 0),
    (0.4, "solarize", 5, 0.9, "autocontrast", 3),
    (0.9, "translateY", 9, 0.7, "translateY", 9),
    (0.9, "autocontrast", 2, 0.8, "solarize", 3),
    (0.8, "equalize", 8, 0.1, "invert", 3),
    (0.7, "translateY", 9, 0.9, "autocontrast", 1),
]

_POLICIES = {"original": IMAGENET_POLICY, "cifar10": CIFAR10_POLICY}

_SIGNED = {"shearX", "shearY", "translateX", "translateY",
           "color", "contrast", "sharpness", "brightness"}


def get_policy(name: str):
    """'original' -> the ImageNet policy, 'cifar10' -> the CIFAR10 policy."""
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown AutoAugment policy {name!r}; supported: "
            f"{sorted(_POLICIES)} (the policies in the reference's "
            "utils/autoaug.py; timm's 'v0' TF policy is not in the "
            "reference tree and is not implemented)") from None


def op_magnitude(name: str, idx: int) -> float:
    """The reference's SubPolicy magnitude ranges (autoaug.py:117-133):
    10-point linspaces indexed by the policy's magnitude index."""
    if name in ("shearX", "shearY"):
        return float(np.linspace(0, 0.3, 10)[idx])
    if name in ("translateX", "translateY"):
        return float(np.linspace(0, 150 / 331, 10)[idx])
    if name == "rotate":
        return float(np.linspace(0, 30, 10)[idx])
    if name in ("color", "contrast", "sharpness", "brightness"):
        return float(np.linspace(0.0, 0.9, 10)[idx])
    if name == "posterize":
        return int(np.round(np.linspace(8, 4, 10), 0)[idx])
    if name == "solarize":
        return float(np.linspace(256, 0, 10)[idx])
    if name in ("autocontrast", "equalize", "invert"):
        return 0.0
    raise KeyError(name)


def apply_op(img, name: str, magnitude: float, sign: int = 1):
    """One reference transforms.py op at `magnitude` with the random sign
    factored out (sign in {-1, +1}; ignored by unsigned ops)."""
    from PIL import Image, ImageEnhance, ImageOps

    if name == "shearX":
        return img.transform(
            img.size, Image.AFFINE, (1, magnitude * sign, 0, 0, 1, 0),
            Image.BICUBIC, fillcolor=_FILL)
    if name == "shearY":
        return img.transform(
            img.size, Image.AFFINE, (1, 0, 0, magnitude * sign, 1, 0),
            Image.BICUBIC, fillcolor=_FILL)
    if name == "translateX":
        # NO resample arg in the reference (PIL default NEAREST) — unlike shear
        return img.transform(
            img.size, Image.AFFINE,
            (1, 0, magnitude * img.size[0] * sign, 0, 1, 0), fillcolor=_FILL)
    if name == "translateY":
        return img.transform(
            img.size, Image.AFFINE,
            (1, 0, 0, 0, 1, magnitude * img.size[1] * sign), fillcolor=_FILL)
    if name == "rotate":
        # DeepVoltaire filled-corner rotate: RGBA rotate composited over gray
        rot = img.convert("RGBA").rotate(magnitude)
        return Image.composite(
            rot, Image.new("RGBA", rot.size, (128,) * 4), rot).convert(img.mode)
    if name == "color":
        return ImageEnhance.Color(img).enhance(1 + magnitude * sign)
    if name == "contrast":
        return ImageEnhance.Contrast(img).enhance(1 + magnitude * sign)
    if name == "sharpness":
        return ImageEnhance.Sharpness(img).enhance(1 + magnitude * sign)
    if name == "brightness":
        return ImageEnhance.Brightness(img).enhance(1 + magnitude * sign)
    if name == "posterize":
        return ImageOps.posterize(img, int(magnitude))
    if name == "solarize":
        return ImageOps.solarize(img, magnitude)
    if name == "autocontrast":
        return ImageOps.autocontrast(img)
    if name == "equalize":
        return ImageOps.equalize(img)
    if name == "invert":
        return ImageOps.invert(img)
    raise KeyError(name)


def auto_augment_pil(img, rng: np.random.Generator, policy):
    """One AutoAugment application: pick a sub-policy uniformly, apply its two
    ops each with its own probability (reference SubPolicy.__call__), signs
    drawn per application for the signed ops (transforms.py random.choice)."""
    p1, op1, idx1, p2, op2, idx2 = policy[int(rng.integers(len(policy)))]
    for p, name, idx in ((p1, op1, idx1), (p2, op2, idx2)):
        if rng.random() < p:
            sign = 1 if name not in _SIGNED or rng.random() < 0.5 else -1
            img = apply_op(img, name, op_magnitude(name, idx), sign)
    return img
