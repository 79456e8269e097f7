"""The port's train and eval transforms (devit_tpu_torch/data/pipeline.py)
against the JAX package's (devit_tpu/data/pipeline.py) on the CPU.

Resampling: resize, the centre crop, eval_transform and the
random-resized crop on fixed boxes against jax.image.resize /
scale_and_translate (cubic and linear, up- and downscaling), within 1e-4 of
255 (f32 sums in another order). Color jitter, random erasing and
finish_transform on fixed draws: the JAX draws are recovered from the same
keys (the JAX functions' own jax.random splits), handed to the port, and the
outputs compared within 1e-4 of 255. train_transform's host draws: their
distributions (rates, ranges) against what the JAX package draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.data import pipeline as J
from devit_tpu_torch.data import pipeline as P

TOL = 1e-4 * 255


def _images(B, H, W, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, H, W, 3)).astype(np.uint8)


@pytest.mark.parametrize("method", ["cubic", "linear"])
@pytest.mark.parametrize("out_hw", [(64, 80), (16, 20), (45, 31)])
def test_resize_matches_jax(method, out_hw):
    img = _images(2, 32, 40)
    want = np.asarray(jax.image.resize(jnp.asarray(img, jnp.float32), (2, *out_hw, 3),
                                       method=method))
    got = P.resize(torch.from_numpy(img), *out_hw, method).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("shape,size", [((2, 32, 40), 24), ((2, 48, 30), 40), ((1, 32, 32), 64)])
def test_center_crop_and_eval_match_jax(shape, size):
    img = _images(*shape, seed=size)
    scale = int(256 / 224 * size)
    for method in ("cubic", "linear"):
        want = np.asarray(J.resize_center_crop(jnp.asarray(img), scale, size, method=method))
        got = P.resize_center_crop(torch.from_numpy(img), scale, size, method=method).numpy()
        assert got.shape == want.shape and np.abs(got - want).max() <= TOL
    want = np.asarray(J.eval_transform(jnp.asarray(img), size, jnp.float32))
    got = P.eval_transform(torch.from_numpy(img), size, torch.float32).numpy()
    assert np.abs(got - want).max() <= TOL / 50  # normalized: (x / 255 - mean) / std
    same = _images(2, size, size)
    np.testing.assert_array_equal(P.eval_transform(torch.from_numpy(same), size, torch.float32),
                                  np.asarray(J.normalize(jnp.asarray(same), jnp.float32)))


@pytest.mark.parametrize("method", ["cubic", "linear"])
def test_random_resized_crop_on_fixed_boxes_matches_scale_and_translate(method):
    img = _images(4, 32, 40, seed=3)
    size = 48  # upscaling the small boxes, downscaling none; 20 below downscales
    boxes = np.array([[3, 5, 20, 30], [0, 0, 32, 40], [10, 2, 7, 9], [1, 1, 30, 11]], np.float32)
    for out in (size, 20):
        want = []
        for b, (y0, x0, h, w) in enumerate(boxes):
            scale = jnp.array([out / h, out / w], jnp.float32)
            want.append(np.asarray(jax.image.scale_and_translate(
                jnp.asarray(img[b], jnp.float32), (out, out, 3), (0, 1), scale,
                -jnp.array([y0, x0]) * scale, method=method)))
        got = P.random_resized_crop(torch.from_numpy(img), torch.from_numpy(boxes),
                                    torch.full((4,), method == "cubic"), out).numpy()
        assert np.abs(got - np.stack(want)).max() <= TOL, (out, method)


def _jax_jitter_draws(key, strength):
    """The factors and permutation J._color_jitter draws from `key`."""
    rb, rc, rs, rp = jax.random.split(key, 4)
    lo = max(0.0, 1.0 - strength)
    f = [float(jax.random.uniform(r, minval=lo, maxval=1 + strength)) for r in (rb, rc, rs)]
    return f, int(jax.random.randint(rp, (), 0, 6))


def test_color_jitter_on_fixed_draws_matches_jax():
    img = _images(6, 24, 20, seed=5).astype(np.float32)
    keys = jax.random.split(jax.random.key(7), 6)
    want, factors, perms = [], [], []
    for b in range(6):
        want.append(np.asarray(J._color_jitter(keys[b], jnp.asarray(img[b]), 0.4)))
        f, p = _jax_jitter_draws(keys[b], 0.4)
        factors.append(f)
        perms.append(p)
    assert len(set(perms)) > 1
    got = P.color_jitter(torch.from_numpy(img), torch.tensor(factors),
                         torch.tensor(perms)).numpy()
    assert np.abs(got - np.stack(want)).max() <= TOL


def _jax_erase_boxes(key, image, prob, mode, max_count, b):
    """The boxes (with their fill) J._random_erase draws from `key`, as
    port EraseBoxes."""
    H, W, C = image.shape
    r_apply, r_count, r_boxes = jax.random.split(key, 3)
    if not float(jax.random.uniform(r_apply)) < prob:
        return []
    count = 1 if max_count == 1 else int(jax.random.randint(r_count, (), 1, max_count + 1))
    boxes = []
    for k, kr in enumerate(jax.random.split(r_boxes, max_count)):
        if k >= count:
            break
        r_area, r_ratio, r_pos, r_noise = jax.random.split(kr, 4)
        area = (H * W / count) * jax.random.uniform(r_area, (10,), minval=0.02, maxval=1 / 3)
        ratio = jnp.exp(jax.random.uniform(r_ratio, (10,), minval=jnp.log(0.3),
                                           maxval=jnp.log(10 / 3)))
        ehs, ews = np.asarray(jnp.round(jnp.sqrt(area * ratio))), np.asarray(
            jnp.round(jnp.sqrt(area / ratio)))
        valid = (ehs > 0) & (ehs < H) & (ews > 0) & (ews < W)
        if not valid.any():
            continue
        i = int(np.argmax(valid))
        eh, ew = int(ehs[i]), int(ews[i])
        py, px = np.asarray(jax.random.uniform(r_pos, (2,)))
        y0, x0 = int(np.floor(py * (H - eh + 1))), int(np.floor(px * (W - ew + 1)))
        if mode == "pixel":
            fill = np.asarray(jax.random.normal(r_noise, image.shape))[y0:y0 + eh, x0:x0 + ew]
        elif mode == "rand":
            fill = np.asarray(jax.random.normal(r_noise, (1, 1, C)))[0, 0]
        else:
            fill = None
        boxes.append(P.EraseBox(b, y0, x0, eh, ew, None if fill is None else torch.tensor(fill)))
    return boxes


@pytest.mark.parametrize("mode,max_count", [("pixel", 1), ("rand", 3), ("const", 2)])
def test_random_erase_and_finish_on_fixed_draws_match_jax(mode, max_count):
    img = _images(8, 20, 24, seed=9)
    x = np.asarray(J.normalize(jnp.asarray(img), jnp.float32))
    keys = jax.random.split(jax.random.key(mode == "pixel"), 8)
    want = np.stack([np.asarray(J._random_erase(keys[b], jnp.asarray(x[b]), 0.7, mode,
                                                max_count)) for b in range(8)])
    boxes = [bx for b in range(8) for bx in _jax_erase_boxes(keys[b], x[b], 0.7, mode,
                                                              max_count, b)]
    assert boxes
    got = P.random_erase(P.normalize(torch.from_numpy(img), torch.float32), boxes).numpy()
    assert np.abs(got - want).max() <= TOL / 50
    # finish_transform: normalize, then the erase boxes it draws itself
    cfg = P.AugmentConfig(reprob=0.0)
    np.testing.assert_array_equal(
        P.finish_transform(torch.Generator(), torch.from_numpy(img), cfg, torch.float32),
        P.normalize(torch.from_numpy(img), torch.float32))
    cfg = P.AugmentConfig(reprob=1.0, re_mode=mode, re_count=max_count)
    out = P.finish_transform(torch.Generator().manual_seed(0), torch.from_numpy(img), cfg,
                             torch.float32).numpy()
    base = P.normalize(torch.from_numpy(img), torch.float32).numpy()
    changed = (out != base).any(axis=(1, 2, 3))
    assert changed.sum() >= 6 and out.dtype == np.float32


def test_train_transform_draw_distributions():
    """4096 samples of the host draws: the RRC box within the scale and
    aspect bounds (or the centre-crop fallback), flips, RandAugment's op
    choice, apply coins, magnitudes and signs, erase rate, at the rates the
    JAX package draws them."""
    cfg = P.AugmentConfig(img_size=32)
    d = P.draw_train(torch.Generator().manual_seed(0), (4096, 36, 36, 3), cfg)
    y0, x0, h, w = d.crop.unbind(1)
    frac = (h * w) / (36 * 36)
    assert bool((y0 >= 0).all() and (y0 + h <= 36).all() and (x0 + w <= 36).all())
    assert 0.07 <= float(frac.min()) and float(frac.max()) <= 1.0
    ratio = w / h
    assert float(ratio.min()) >= 0.7 and float(ratio.max()) <= 1.45  # 3/4..4/3 after rounding
    assert abs(float(frac.mean()) - 0.54) < 0.05  # E[U(0.08, 1)] less the rejected tries
    assert abs(float(d.flip.float().mean()) - 0.5) < 0.03 and bool(d.cubic.all())
    ops = d.ra.op.flatten()
    counts = torch.bincount(ops, minlength=15).float() / ops.numel()
    assert float((counts - 1 / 15).abs().max()) < 0.02
    assert abs(float(d.ra.apply.float().mean()) - 0.5) < 0.03
    mag = d.ra.mag.abs()
    assert abs(float(mag.mean()) - 9.0) < 0.05 and float(mag.max()) <= 10.0
    signed = torch.isin(d.ra.op, torch.tensor([3, 7, 8, 9, 10, 11, 12, 13, 14]))
    assert abs(float((d.ra.mag[signed] < 0).float().mean()) - 0.5) < 0.03
    assert not bool((d.ra.mag[~signed] < 0).any())
    erased = {bx.b for bx in d.erase}
    assert abs(len(erased) / 4096 - 0.25) < 0.03
    # the same draws give the same images; the transform's output
    imgs = torch.from_numpy(_images(8, 36, 36))
    d8 = P.draw_train(torch.Generator().manual_seed(1), (8, 36, 36, 3), cfg)
    a = P.apply_train(imgs, d8, cfg, torch.float32)
    np.testing.assert_array_equal(a, P.apply_train(imgs, d8, cfg, torch.float32))
    assert a.shape == (8, 32, 32, 3) and bool(torch.isfinite(a).all())
    out = P.train_transform(torch.Generator().manual_seed(1), imgs, cfg, torch.float32)
    np.testing.assert_array_equal(out, a)


def test_jitter_small_image_and_random_interpolation_draws():
    cfg = P.AugmentConfig(img_size=32, randaugment=False, small_image=True,
                          interpolation="random", reprob=0.0)
    d = P.draw_train(torch.Generator().manual_seed(2), (2048, 32, 32, 3), cfg)
    assert d.crop.shape == (2048, 2) and int(d.crop.min()) == 0 and int(d.crop.max()) == 8
    assert abs(float(d.cubic.float().mean()) - 0.5) < 0.04
    assert float(d.jitter.min()) >= 0.6 and float(d.jitter.max()) <= 1.4
    assert set(d.jitter_perm.tolist()) == set(range(6)) and not d.erase
    imgs = torch.from_numpy(_images(4, 32, 32))
    d4 = P.draw_train(torch.Generator().manual_seed(3), (4, 32, 32, 3), cfg)
    x = P.apply_train(imgs, d4, cfg, torch.float32)
    pad = np.pad(imgs.numpy().astype(np.float32), ((0, 0), (4, 4), (4, 4), (0, 0)))
    oy, ox = d4.crop[0].tolist()
    crop = pad[0, oy:oy + 32, ox:ox + 32]
    crop = crop[:, ::-1] if bool(d4.flip[0]) else crop
    want = P.color_jitter(torch.from_numpy(np.ascontiguousarray(crop))[None], d4.jitter[:1],
                          d4.jitter_perm[:1])
    np.testing.assert_allclose(x[0], P.normalize(want, torch.float32)[0], atol=1e-5)
    with pytest.raises(ValueError, match="AutoAugment"):
        P.train_transform(torch.Generator(), imgs, P.AugmentConfig(autoaugment="original"))


def test_no_aug_matches_jax():
    img = _images(2, 40, 48, seed=4)
    for interp in ("bicubic", "bilinear", "random"):
        jcfg = J.AugmentConfig(img_size=32, no_aug=True, interpolation=interp)
        pcfg = P.AugmentConfig(img_size=32, no_aug=True, interpolation=interp)
        want = np.asarray(J.train_transform(jax.random.key(0), jnp.asarray(img), jcfg,
                                            jnp.float32))
        got = P.train_transform(torch.Generator(), torch.from_numpy(img), pcfg,
                                torch.float32).numpy()
        assert np.abs(got - want).max() <= TOL / 50
