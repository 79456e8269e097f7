"""Fine-grained dataset readers: Flowers-102, Stanford Cars, Oxford-IIIT Pet,
iNaturalist.

Parity surface: reference `data/datasets.py` — vendored torchvision datasets
`Flowers102` (:20-131), `StanfordCars` (:134-246), `OxfordIIITPet` (:249-363),
`INatDataset` (:366-404). Those classes download + verify archives; these
readers consume the standard extracted on-disk layouts and decode to
`ArrayDataset` (resized uint8, cached as .npz). A copy of
devit_tpu/data/fine_grained.py; only its imports change.

Class counts (reference get_dataset.py:17-58): flowers 102, cars 196, pets 37.

Cache naming: `.devit_v3_*` — v3 bumped when ingest_resize switched its S
from round() to the eval path's int() truncation (a v2 cache built at e.g.
img_size 384 holds 439px images where v3 expects 438; reusing it would break
the pixel-exact eval composition silently).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from devit_tpu_torch.data.datasets import ArrayDataset, decode_files_to_dataset


def _check_extraction(paths: List[str], labels: List[int], num_classes: int,
                      name: str) -> None:
    """Torn-extraction diagnosis: the reference's vendored
    torchvision datasets verify archive md5s at download time
    (data/datasets.py:107-127 of the original DeViT); the readers take
    pre-extracted archives, so verify the EXTRACTION instead — every
    annotated image must exist and be non-empty, and every label must be in
    range. Without this, a truncated `cars_train.tgz` extraction surfaces as
    silent decode skips (wrong dataset size) or an index error deep in
    training."""
    bad = sorted({int(l) for l in labels if not 0 <= int(l) < num_classes})
    if bad:
        raise ValueError(
            f"{name}: annotation labels out of range [0, {num_classes}): "
            f"{bad[:10]}{'...' if len(bad) > 10 else ''} — corrupt or "
            f"mismatched annotation files?")
    missing = [p for p in paths if not os.path.isfile(p)]
    empty = [] if missing else [p for p in paths
                                if os.path.getsize(p) == 0]
    if missing or empty:
        ex = (missing or empty)[:5]
        raise FileNotFoundError(
            f"{name}: {len(missing)} of {len(paths)} annotated images "
            f"missing, {len(empty)} empty (torn archive extraction?) — "
            f"first few: {ex}. Re-extract the dataset archive and re-run.")


def _decode(paths: List[str], labels: List[int], num_classes: int,
            img_size: int, cache_path: str, name: str = "dataset") -> ArrayDataset:
    """Shared decode+cache (datasets.decode_files_to_dataset): .npz in RAM
    below DEVIT_MMAP_BYTES, raw uint8 memmap above it (iNat-2018 train is
    ~437k images ≈ 86 GB at the 256² cache side — RAM-infeasible)."""
    base = cache_path[:-len(".npz")] if cache_path.endswith(".npz") else cache_path
    # only on a cache MISS: after ingest the source images may legitimately
    # be gone (cache is self-contained), and stat-ing ~437k files on every
    # cached load would be wasted work
    if not (os.path.exists(base + ".npz")
            or os.path.exists(base + ".u8.meta.npz")):
        _check_extraction(paths, labels, num_classes, name)
    return decode_files_to_dataset(zip(paths, labels), num_classes, img_size,
                                   base, cache=True)


def load_flowers102(root: str, split: str, img_size: int = 224) -> ArrayDataset:
    """Standard layout: root/flowers-102/{jpg/image_%05d.jpg, imagelabels.mat,
    setid.mat}. Train split = train+val like the reference splitter
    (splite_dataset.py:39-43); labels shifted to 0-based."""
    from scipy.io import loadmat

    base = os.path.join(root, "flowers-102")
    labels_all = loadmat(os.path.join(base, "imagelabels.mat"))["labels"][0] - 1
    setid = loadmat(os.path.join(base, "setid.mat"))
    split_ids = {
        "train": np.concatenate([setid["trnid"][0], setid["valid"][0]]),
        "trainonly": setid["trnid"][0],
        "val": setid["valid"][0],
        "test": setid["tstid"][0],
    }[split]
    paths = [os.path.join(base, "jpg", f"image_{i:05d}.jpg") for i in split_ids]
    labels = [int(labels_all[i - 1]) for i in split_ids]
    return _decode(paths, labels, 102, img_size,
                   os.path.join(base, f".devit_v3_{split}_{img_size}.npz"),
                   name=f"flowers-102/{split}")


def load_stanford_cars(root: str, split: str, img_size: int = 224) -> ArrayDataset:
    """Standard layout: root/stanford_cars/{cars_train, cars_test,
    devkit/cars_train_annos.mat, cars_test_annos_withlabels.mat}."""
    from scipy.io import loadmat

    base = os.path.join(root, "stanford_cars")
    if split == "train":
        annos = loadmat(os.path.join(base, "devkit", "cars_train_annos.mat"))
        img_dir = os.path.join(base, "cars_train")
    else:
        annos = loadmat(os.path.join(base, "cars_test_annos_withlabels.mat"))
        img_dir = os.path.join(base, "cars_test")
    paths, labels = [], []
    for a in annos["annotations"][0]:
        labels.append(int(a["class"][0, 0]) - 1)
        paths.append(os.path.join(img_dir, str(a["fname"][0])))
    return _decode(paths, labels, 196, img_size,
                   os.path.join(base, f".devit_v3_{split}_{img_size}.npz"),
                   name=f"stanford_cars/{split}")


def load_oxford_pets(root: str, split: str, img_size: int = 224) -> ArrayDataset:
    """Standard layout: root/oxford-iiit-pet/{images, annotations/{trainval.txt,
    test.txt}}; label = breed id (1-37) - 1."""
    base = os.path.join(root, "oxford-iiit-pet")
    ann = os.path.join(base, "annotations",
                       "trainval.txt" if split == "train" else "test.txt")
    paths, labels = [], []
    with open(ann) as f:
        for line in f:
            name, class_id, *_ = line.strip().split()
            paths.append(os.path.join(base, "images", name + ".jpg"))
            labels.append(int(class_id) - 1)
    return _decode(paths, labels, 37, img_size,
                   os.path.join(base, f".devit_v3_{split}_{img_size}.npz"),
                   name=f"oxford-iiit-pet/{split}")


def load_inat(root: str, split: str, year: int = 2018, category: str = "name",
              img_size: int = 224) -> ArrayDataset:
    """iNaturalist layout (reference INatDataset, datasets.py:366-404):
    root/train{year}.json + categories.json; label space defined by the chosen
    category field."""
    ann_file = os.path.join(root, f"{'train' if split == 'train' else 'val'}{year}.json")
    with open(ann_file) as f:
        data = json.load(f)
    with open(os.path.join(root, "categories.json")) as f:
        categories = json.load(f)

    targeter = {}
    for c in categories:
        key = c[category]
        if key not in targeter:
            targeter[key] = len(targeter)
    num_classes = len(targeter)

    id_to_cat = {c["id"]: c for c in categories}
    img_by_id = {im["id"]: im["file_name"] for im in data["images"]}
    paths, labels = [], []
    for ann in data["annotations"]:
        cat = id_to_cat[ann["category_id"]]
        paths.append(os.path.join(root, img_by_id[ann["image_id"]]))
        labels.append(targeter[cat[category]])
    # cache key MUST include category: the label space (and num_classes)
    # depends on it, so a 'name' cache served to a --inat-category kingdom
    # run would silently train on the wrong labels
    return _decode(paths, labels, num_classes, img_size,
                   os.path.join(root, f".devit_v3_{split}{year}_{category}_{img_size}.npz"),
                   name=f"inat{year}/{split}")


def inat_num_classes(root: str, category: str = "name") -> int:
    """Class count from categories.json alone — split_main needs only this
    integer; deriving it via a full load_inat would decode the entire ~437k-
    image split (hours + ~86 GB) to read one number."""
    with open(os.path.join(root, "categories.json")) as f:
        categories = json.load(f)
    seen = set()
    for c in categories:
        seen.add(c[category])
    return len(seen)
