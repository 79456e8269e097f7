"""Dataset helpers (counterpart of devit_tpu/data/datasets.py). This slice
carries only the eval-batch padder that train/loop.run_eval needs; the
dataset readers come with the data slice."""

from __future__ import annotations

import numpy as np


def pad_batch_to_steady(images, labels, batch_size):
    """Pad a ragged drop_last=False FINAL batch to the steady shape: zero
    images, labels -1 (train/steps.eval_counters excludes label < 0 rows from
    every counter). Returns (images, labels, batch_size, n_real); batch_size
    None means 'infer from this (first) batch'. Raises if a batch grows past
    the steady shape: only the final batch may be ragged."""
    images = np.asarray(images)
    labels = np.asarray(labels)
    n = labels.shape[0]
    if batch_size is None:
        batch_size = n
    elif n > batch_size:
        raise ValueError(f"val batch of {n} exceeds the steady shape {batch_size}; only "
                         "the FINAL batch may be ragged (smaller)")
    if n < batch_size:
        pad = batch_size - n
        images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        labels = np.concatenate([labels, np.full(pad, -1, labels.dtype)])
    return images, labels, batch_size, n
