"""The port's RandAugment (devit_tpu_torch/data/randaugment.py) against the
JAX package's (devit_tpu/data/randaugment.py) on the CPU.

Every op at several magnitudes, in the increasing and non-increasing sets,
on exact uint8-valued inputs: the stepped ops (posterize, solarize,
solarize_add, equalize, autocontrast, contrast) bit for bit, the continuous
ones within 1e-4 of 255 (f32 sums and trigonometry in another order). The
chain of two ops on fixed draws: after a geometric op the second op's input
is no longer integer, so a stepped second op may flip where its input lies
within 1e-3 of a step; such pixels are excused and their count printed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devit_tpu.data import randaugment as J
from devit_tpu_torch.data import randaugment as R

TOL = 1e-4 * 255
MAGS = (0.0, 3.3, 9.0, 10.0, -7.5)


def _images(n=4, h=24, w=28, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, h, w, 3)).astype(np.float32)
    img[1] = np.clip(img[1] * 0.3 + 40, 0, 255).round()  # a low-contrast image
    img[2, :, :, 1] = 77.0  # a constant channel (autocontrast's, equalize's step 0)
    return img


def _jax_op(k: int, inc: bool):
    if not inc and k == 4:
        return J._posterize_noinc
    if not inc and k == 5:
        return J._solarize_noinc
    return J.OPS[k]


@pytest.mark.parametrize("inc", [True, False])
@pytest.mark.parametrize("k", range(len(J.OPS)))
def test_op_matches_jax(k, inc):
    img = _images(seed=k)
    stepped = J.OP_NAMES[k] in R.STEPPED_OPS
    for mag in MAGS:
        want = np.stack([np.asarray(_jax_op(k, inc)(jnp.asarray(im), jnp.float32(mag)))
                         for im in img])
        got = R.op(k, inc)(torch.from_numpy(img), torch.full((len(img),), mag)).numpy()
        if stepped:
            np.testing.assert_array_equal(got, want, err_msg=f"{J.OP_NAMES[k]} m={mag}")
        else:
            assert np.abs(got - want).max() <= TOL, (J.OP_NAMES[k], mag)


def test_op_names_and_weights_match_jax():
    assert R.OP_NAMES == J.OP_NAMES and R.CHOICE_WEIGHTS_0 == J.CHOICE_WEIGHTS_0
    assert R._FILL == J._FILL


def test_weighted_op_indices():
    idx = R.weighted_op_indices(torch.Generator().manual_seed(0), 20000, 2)
    assert all(a != b for a, b in idx.tolist())  # without replacement
    zero = [i for i, w in enumerate(R.CHOICE_WEIGHTS_0) if w == 0.0]
    assert not torch.isin(idx, torch.tensor(zero)).any()
    first = torch.bincount(idx[:, 0], minlength=15).float() / 20000
    np.testing.assert_allclose(first.numpy(), R.CHOICE_WEIGHTS_0, atol=0.012)


def _near_step(x: np.ndarray) -> np.ndarray:
    """Pixels with a channel within 1e-3 of a step of the stepped ops (an
    integer, for floor/threshold/histogram bins; a half, for round)."""
    d = np.abs(x * 2 - np.round(x * 2)) / 2
    return (d < 1e-3).any(axis=-1)


@pytest.mark.parametrize("inc", [True, False])
def test_chain_on_fixed_draws_matches_jax(inc):
    n = 64
    img = _images(n, 20, 20, seed=11)
    draws = R.draw_rand_augment(torch.Generator().manual_seed(5), n, inc=inc, prob=0.8)
    got = R.apply_rand_augment(torch.from_numpy(img), draws).numpy()
    excused = 0
    for b in range(n):
        x = jnp.asarray(img[b])
        near = np.zeros(img.shape[1:3], bool)
        for s in range(draws.op.shape[1]):
            if not bool(draws.apply[b, s]):
                continue
            k = int(draws.op[b, s])
            if J.OP_NAMES[k] in R.STEPPED_OPS:
                if J.OP_NAMES[k] in ("contrast", "equalize", "autocontrast"):
                    # whole-image statistics: one flip moves every pixel
                    near |= _near_step(np.asarray(x)).any()
                else:
                    near |= _near_step(np.asarray(x))
            x = _jax_op(k, inc)(x, jnp.float32(float(draws.mag[b, s])))
        diff = np.abs(got[b] - np.asarray(x)).max(axis=-1)
        bad = (diff > TOL) & ~near
        assert not bad.any(), (b, draws.op[b].tolist(), float(diff.max()))
        excused += int(((diff > TOL) & near).sum())
    print(f"chain inc={inc}: {excused} of {n * 400} pixels excused (input within 1e-3 "
          f"of a step)")
    assert excused <= n * 400 // 20
