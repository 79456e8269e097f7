"""Array-backed datasets, division views and host batch iteration
(counterpart of devit_tpu/data/datasets.py: `ArrayDataset`,
`synthetic_dataset`, `pad_batch_to_steady` and `BatchIterator`; the
dataset loaders and the multithreaded C++ row gather come with the data
slice).

Images are uint8 NHWC numpy arrays; batches are host numpy arrays, moved to
the device by the consumer.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from devit_tpu_torch.data.splitter import DivisionManifest


@dataclasses.dataclass
class ArrayDataset:
    """Images (N,H,W,3) uint8 + int labels (len(self),).

    `images` may be an in-RAM array or a read-only np.memmap. `indices`, when
    set, is a row indirection into `images` (lazy division views over a
    memmap); `labels` are always dense and already remapped for the view."""

    images: np.ndarray
    labels: np.ndarray
    num_classes: int
    indices: np.ndarray = None

    def __len__(self) -> int:
        return len(self.labels)

    def rows(self, b: np.ndarray) -> np.ndarray:
        """Map batch positions -> physical rows of `images`."""
        return b if self.indices is None else self.indices[b]

    def division_view(self, manifest: DivisionManifest, division: int) -> "ArrayDataset":
        """Class-disjoint sub-dataset with local labels. Over a memmap the
        view is an index indirection (nothing is copied)."""
        idx = manifest.select_indices(self.labels, division)
        labels = manifest.remap_labels(self.labels[idx], division)
        nc = manifest.num_division_classes(division)
        rows = self.rows(idx)
        if isinstance(self.images, np.memmap):
            return ArrayDataset(self.images, labels, nc, indices=rows)
        return ArrayDataset(images=self.images[rows], labels=labels, num_classes=nc)


def synthetic_dataset(
    num_classes: int, n: int, img_size: int = 32, seed: int = 0
) -> ArrayDataset:
    """Class-dependent synthetic images, bit for bit the JAX package's.

    The per-class signal comes from a fixed generator (independent of
    `seed`), so train (seed 0) and val (seed 1) share the class patterns; it
    is low-frequency (an 8x8 pattern upsampled to img_size), so it survives
    crops and flips. Per-sample noise and the label draw use `seed`."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    class_rng = np.random.default_rng((1234, num_classes, img_size))
    coarse = class_rng.integers(40, 216, (num_classes, 8, 8, 3))
    g = max(1, -(-img_size // 8))  # ceil: upsample past img_size, then crop
    base = np.repeat(np.repeat(coarse, g, axis=1), g, axis=2)[
        :, :img_size, :img_size]
    noise = rng.integers(-20, 20, (n, img_size, img_size, 3))
    images = np.clip(base[labels] + noise, 0, 255).astype(np.uint8)
    return ArrayDataset(images=images, labels=labels.astype(np.int64), num_classes=num_classes)


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """dst[i] = src[idx[i]]. Negative or out-of-range indices raise
    IndexError (numpy would wrap a negative one; -1 is the padded-label
    sentinel and must never reach a gather)."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise IndexError(
            f"gather_rows: index out of range [0, {src.shape[0]}): "
            f"min {int(idx.min())}, max {int(idx.max())}")
    return src[idx]


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


class BatchIterator:
    """Host-side batcher: shuffles indices per epoch and yields uint8 numpy
    batches (drop_last for one batch shape). With prefetch > 0 a background
    thread assembles up to `prefetch` batches ahead, so the host gather and
    `host_transform` overlap the consumer's device work."""

    def __init__(
        self,
        ds: ArrayDataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        repeated_aug: int = 0,
        prefetch: int = 2,
        host_transform=None,
    ):
        self.ds = ds
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.repeated_aug = repeated_aug
        self.prefetch = prefetch
        self.host_transform = host_transform
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_len(self) -> int:
        n = len(self.ds)
        if self.repeated_aug > 0:
            # the RASampler truncation, floor(n/256)*256; below 256 samples
            # the reference degenerates to zero, so fall back to n
            return (n // 256) * 256 or n
        return n

    def __len__(self) -> int:
        n = self._epoch_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.ds)
        rng = np.random.default_rng(self.seed + self.epoch)
        base = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.repeated_aug > 0:
            # RASampler: each sample repeated `repeated_aug` times adjacent
            # (the copies land in one batch and take independent
            # augmentations), truncated to the epoch length
            return np.repeat(base, self.repeated_aug)[: self._epoch_len()]
        return base

    def _assemble(self, b: np.ndarray, k: int, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        imgs = gather_rows(self.ds.images, self.ds.rows(b))
        if self.host_transform is not None:
            # `epoch` is the value captured when the iteration started: a
            # set_epoch() while the producer still drains must not stamp the
            # next epoch's augmentation seeds onto this epoch's permutation
            imgs = self.host_transform(imgs, epoch, k)
        return imgs, self.ds.labels[b]

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        epoch = self.epoch
        idx = self._epoch_indices()
        n = len(idx)
        end = n - (n % self.batch_size) if self.drop_last else n
        for k, s in enumerate(range(0, end, self.batch_size)):
            yield self._assemble(idx[s : s + self.batch_size], k, epoch)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _END = object()
        stop = threading.Event()

        def producer():
            try:
                for item in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(_END)
            except BaseException as e:  # surface errors at the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=2.0)
