"""Datasets: array-backed sources, division views and host batch iteration
(counterpart of devit_tpu/data/datasets.py).

Sources: CIFAR-100/10 from the standard python pickles, image-folder trees
(PIL decode, cached next to the tree as .npz, or as a raw uint8 memmap above
DEVIT_MMAP_BYTES), the fine-grained layouts (data/fine_grained.py) and
synthetic data. Images are uint8 NHWC numpy arrays; BatchIterator gathers
batches with the native C++ gather (io/native.py) and hands host numpy
arrays to the consumer, which moves them to the device. PIL is imported
only where an image file is decoded.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Iterator, Tuple

import numpy as np

from devit_tpu_torch.data.splitter import DivisionManifest
from devit_tpu_torch.io.native import gather_rows

DATASET_NUM_CLASSES = {"cifar100": 100, "cifar10": 10, "IMNET": 1000, "flowers": 102,
                       "cars": 196, "pets": 37}


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


def load_cifar100(data_path: str, train: bool) -> ArrayDataset:
    """Standard cifar-100-python pickles -> uint8 NHWC arrays."""
    fname = "train" if train else "test"
    path = os.path.join(data_path, "cifar-100-python", fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"CIFAR-100 not found at {path}; place the extracted cifar-100-python "
            "directory under data_path (the loader downloads nothing)."
        )
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC uint8
    labels = np.asarray(d[b"fine_labels"], dtype=np.int64)
    return ArrayDataset(images=np.ascontiguousarray(images), labels=labels, num_classes=100)


def load_cifar10(data_path: str, train: bool) -> ArrayDataset:
    """Standard cifar-10-batches-py pickles (data_batch_1..5 / test_batch) ->
    uint8 NHWC arrays. Covers the reference's dormant utils/data_loader.py
    CIFAR-10 surface through the live pipeline."""
    root = os.path.join(data_path, "cifar-10-batches-py")
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    imgs, labels = [], []
    for fname in names:
        path = os.path.join(root, fname)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"CIFAR-10 not found at {path}; place the extracted "
                "cifar-10-batches-py directory under data_path (the loader "
                "downloads nothing)."
            )
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.append(np.asarray(d[b"labels"], dtype=np.int64))
    return ArrayDataset(
        images=np.ascontiguousarray(np.concatenate(imgs)),
        labels=np.concatenate(labels), num_classes=10,
    )


def ingest_resize(im, img_size: int):
    """Aspect-PRESERVING ingest to a square uint8 cache: shorter side ->
    S = int(img_size*256/224) — the SAME int truncation eval_transform
    (data/pipeline.py) and torchvision Resize use, so the cache side equals the
    eval resize target and no second resample happens. The eval path's
    Resize(256/224*size)+CenterCrop(size) over this cache reproduces
    torchvision's transform of the ORIGINAL image pixel-exactly whenever
    S-img_size is even (true for every canonical size: 224->256, 384->438,
    32->36; the two center crops then compose: round((nh-S)/2) + (S-size)/2
    == round((nh-size)/2)). For an odd S-size gap the composed crop is offset
    by half a pixel — documented, not asserted. A plain square resize here
    would squash aspect — different pixels from the reference for every
    non-square photo (get_dataset.py:99-105). Train RRC samples from this SxS
    cache (capped at S resolution — the in-memory deviation from decoding
    originals per epoch; documented)."""
    from PIL import Image

    S = int(img_size * 256 / 224)
    w, h = im.size
    if w <= h:
        nw, nh = S, int(S * h / w)
    else:
        nh, nw = S, int(S * w / h)
    im = im.resize((nw, nh), Image.BICUBIC)
    left = int(round((nw - S) / 2.0))
    top = int(round((nh - S) / 2.0))
    return im.crop((left, top, left + S, top + S))


def _mmap_threshold_bytes() -> int:
    """Datasets whose decoded cache exceeds this go to a disk-backed memmap
    instead of RAM (ImageNet-1K train ≈ 250 GB at the 256² cache — the
    in-RAM path cannot hold it). Override with DEVIT_MMAP_BYTES."""
    return int(os.environ.get("DEVIT_MMAP_BYTES", 8 << 30))


def decode_files_to_dataset(files, num_classes: int, img_size: int,
                            cache_base: str, cache: bool = True) -> ArrayDataset:
    """Decode (path, label) pairs into an ArrayDataset with a persistent
    cache next to the data. Undecodable files are skipped (torchvision
    ImageFolder tolerance). Two cache forms, chosen by decoded size:

    - `<cache_base>.npz` (in-RAM arrays) below DEVIT_MMAP_BYTES;
    - `<cache_base>.u8` raw uint8 memmap + `.u8.meta.npz` above it
      (ImageNet-1K train ≈ 250 GB at the 256² cache side — batches then
      stream through the OS page cache via the native gather, and division
      views stay lazy index indirections).
    """
    S = int(img_size * 256 / 224)
    cache_path = cache_base + ".npz"
    mmap_path = cache_base + ".u8"
    meta_path = mmap_path + ".meta.npz"
    if cache and os.path.exists(meta_path):
        meta = np.load(meta_path)
        n = len(meta["labels"])
        # the .u8 and the meta are replaced independently by (possibly
        # concurrent) writers; identical content is expected but enforce it —
        # np.memmap(mode='r') would silently accept a LARGER file and pair
        # every row past the divergence with the wrong label
        actual = os.path.getsize(mmap_path)
        if actual != n * S * S * 3:
            raise ValueError(
                f"dataset cache inconsistent: {mmap_path} holds "
                f"{actual // (S * S * 3)} rows but {meta_path} lists {n} "
                f"labels (torn concurrent ingest?) — delete both and re-run "
                "`devit ingest`")
        images = np.memmap(mmap_path, dtype=np.uint8, mode="r",
                           shape=(n, S, S, 3))
        return ArrayDataset(images, meta["labels"], int(meta["num_classes"]))
    if cache and os.path.exists(cache_path):
        z = np.load(cache_path)
        return ArrayDataset(z["images"], z["labels"], int(z["num_classes"]))

    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def decode_one(item):
        fpath, li = item
        try:
            with Image.open(fpath) as im:
                return np.asarray(ingest_resize(im.convert("RGB"), img_size),
                                  dtype=np.uint8), li
        except Exception:
            return None, li

    files = list(files)
    use_mmap = len(files) * S * S * 3 > _mmap_threshold_bytes()
    # per-PID tmp names + os.replace: parallel per-division stage launches
    # hit the same uncached tree concurrently; each writer builds its own
    # tmp and the atomic replaces guarantee readers never see a torn file
    # (both writers decode the same deterministic list, so last-wins is
    # content-identical)
    tmp_suffix = f".tmp.{os.getpid()}"
    if use_mmap:
        # decode straight into the file; failed decodes are skipped, so the
        # file is truncated to the real count afterwards and reopened r/o
        buf = np.memmap(mmap_path + tmp_suffix, dtype=np.uint8, mode="w+",
                        shape=(len(files), S, S, 3))
    # threaded decode (PIL releases the GIL in decode/resize), ordered
    # chunked collection so peak RAM stays ~chunk regardless of dataset size
    # — the one-time replacement for the reference's per-epoch DataLoader
    # worker decodes
    workers = int(os.environ.get("DEVIT_INGEST_THREADS",
                                 min(os.cpu_count() or 1, 16)))
    chunk = 1024
    images, labels, m = [], [], 0
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for s in range(0, len(files), chunk):
            for arr, li in ex.map(decode_one, files[s : s + chunk]):
                if arr is None:
                    continue
                if use_mmap:
                    buf[m] = arr
                else:
                    images.append(arr)
                labels.append(li)
                m += 1
    labels = np.asarray(labels, np.int64)
    if m == 0:
        # every decode failed (undecodable files are skipped by design,
        # torchvision tolerance) — without this the in-RAM path dies at
        # np.stack([]) and the memmap path at 'cannot mmap an empty file',
        # neither naming the actual cause
        raise ValueError(
            f"{cache_base}: none of the {len(files)} listed files decoded as "
            f"images — wrong --data-path, or a corrupt/truncated extraction?")

    if use_mmap:
        buf.flush()
        del buf
        with open(mmap_path + tmp_suffix, "r+b") as f:
            f.truncate(m * S * S * 3)
        if not cache:
            # a memmap needs SOME backing file, but cache=False must not
            # touch the canonical cache names — keep the per-PID tmp as the
            # backing store and remove it at interpreter exit
            import atexit

            backing = mmap_path + tmp_suffix
            atexit.register(lambda p=backing: os.path.exists(p) and os.unlink(p))
            imgs = np.memmap(backing, dtype=np.uint8, mode="r", shape=(m, S, S, 3))
            return ArrayDataset(imgs, labels, num_classes)
        os.replace(mmap_path + tmp_suffix, mmap_path)
        # meta LAST (its existence is the cache-hit signal) and atomically —
        # np.savez appends '.npz' unless the name already ends with it
        meta_tmp = meta_path[:-len(".npz")] + tmp_suffix + ".npz"
        np.savez(meta_tmp, labels=labels, num_classes=num_classes)
        os.replace(meta_tmp, meta_path)
        imgs = np.memmap(mmap_path, dtype=np.uint8, mode="r", shape=(m, S, S, 3))
        return ArrayDataset(imgs, labels, num_classes)

    ds = ArrayDataset(
        images=np.stack(images), labels=labels, num_classes=num_classes
    )
    if cache:
        cache_tmp = cache_path[:-len(".npz")] + tmp_suffix + ".npz"
        np.savez(cache_tmp, images=ds.images, labels=ds.labels,
                 num_classes=ds.num_classes)
        os.replace(cache_tmp, cache_path)
    return ds


def load_image_folder(root: str, img_size: int = 224, cache: bool = True) -> ArrayDataset:
    """ImageFolder tree -> resized uint8 arrays (lexicographic class order,
    torchvision semantics). Decoded once and cached next to the tree; see
    decode_files_to_dataset for the RAM-vs-memmap cache policy."""
    # v3: ingest S uses the eval path's int truncation (was round, which
    # diverged from the eval resize target for img_size != 224)
    base = os.path.join(root, f".devit_cache_v3_{img_size}")
    if cache and (os.path.exists(base + ".u8.meta.npz")
                  or os.path.exists(base + ".npz")):
        return decode_files_to_dataset([], 0, img_size, base, cache=True)
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)) and not d.startswith(".")
    )
    files = []
    for li, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        files += [(os.path.join(cdir, f), li) for f in sorted(os.listdir(cdir))
                  if os.path.isfile(os.path.join(cdir, f))]
    return decode_files_to_dataset(
        files, len(classes), img_size,
        os.path.join(root, f".devit_cache_v3_{img_size}"), cache=cache)


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


def build_dataset(
    name: str, data_path: str, train: bool, img_size: int = 224,
    inat_category: str = "name",
) -> ArrayDataset:
    """Dispatch mirroring reference build_dataset (get_dataset.py:17-58).
    inat_category selects the iNaturalist taxonomic label rank
    (--inat-category, train_subdata.py:162; get_dataset.py:47-55)."""
    if name.startswith("synthetic"):
        # synthetic[:<num_classes>[:<n>[:<img_size>]]] — smoke tests / benches
        parts = name.split(":")
        k = int(parts[1]) if len(parts) > 1 else 100
        n = int(parts[2]) if len(parts) > 2 else (2048 if train else 512)
        s = int(parts[3]) if len(parts) > 3 else img_size
        return synthetic_dataset(k, n, img_size=s, seed=0 if train else 1)
    if name == "cifar100":
        return load_cifar100(data_path, train)
    if name == "cifar10":
        return load_cifar10(data_path, train)
    if name in ("IMNET",):
        split = "train" if train else "val"
        return load_image_folder(os.path.join(data_path, split), img_size)
    if name in ("flowers", "cars", "pets"):
        # standard extracted archives first (reference data/datasets.py layouts),
        # then a plain image-folder tree as fallback
        from devit_tpu_torch.data import fine_grained as FG

        split = "train" if train else "test"
        loader = {"flowers": FG.load_flowers102, "cars": FG.load_stanford_cars,
                  "pets": FG.load_oxford_pets}[name]
        try:
            return loader(data_path, split, img_size)
        except (FileNotFoundError, ImportError):
            # ImportError: scipy (the .mat split readers) may be absent on a
            # host; fall through to the image-folder path
            pass
        root = os.path.join(data_path, name, split)
        if os.path.isdir(root):
            return load_image_folder(root, img_size)
        raise FileNotFoundError(
            f"{name}: neither the standard archive layout under {data_path} nor "
            f"an image-folder tree at {root} was found"
        )
    if name in ("INAT", "INAT19"):
        from devit_tpu_torch.data import fine_grained as FG

        year = 2018 if name == "INAT" else 2019
        return FG.load_inat(data_path, "train" if train else "val", year=year,
                            category=inat_category, img_size=img_size)
    raise KeyError(f"unknown dataset {name!r}")


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
    batches (drop_last for one batch shape), gathered by the native C++
    gather. With prefetch > 0 a background thread assembles up to
    `prefetch` batches ahead, so the host gather (which releases the GIL)
    and `host_transform` overlap the consumer's device work."""

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
