"""Class-disjoint dataset partition, stage 1 of the pipeline (counterpart of
devit_tpu/data/splitter.py, all of it; it imports no JAX, and the port keeps
its own copy).

Seed-42 Python `random.shuffle` of the class-id list, split into
`num_division` contiguous chunks. The split is a manifest (per-division
global class ids plus the global -> local label map) and division datasets
are index views over the original arrays. The manifest's JSON file equals
the JAX package's byte for byte.

Local label order follows ImageFolder semantics: class directories are named
str(global_label) and ImageFolder sorts names lexicographically, so local
label 0 is the string-least global id (the reference's behaviour; checkpoint
compatibility depends on it).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
from typing import Dict, List, Sequence

import numpy as np


def split_classes(num_classes: int, num_division: int, seed: int = 42) -> List[List[int]]:
    """Seed-42-compatible contiguous chunk split (splite_dataset.py:51-56)."""
    rng = random.Random(seed)
    label_list = list(range(num_classes))
    rng.shuffle(label_list)
    n = num_classes
    # proportional i*n//D boundaries, the reference's formula verbatim at all
    # five of its dataset branches (for i = D-1 the end is exactly n, so no
    # special last-chunk case exists)
    return [label_list[i * n // num_division : (i + 1) * n // num_division]
            for i in range(num_division)]


def local_label_map(class_ids: Sequence[int]) -> Dict[int, int]:
    """global id -> local label, ordered like ImageFolder (string sort of
    directory names str(global_id))."""
    ordered = sorted(class_ids, key=str)
    return {g: i for i, g in enumerate(ordered)}


@dataclasses.dataclass
class DivisionManifest:
    """The whole stage-1 artifact."""

    num_classes: int
    num_division: int
    seed: int
    divisions: List[List[int]]  # global class ids per division

    @classmethod
    def create(cls, num_classes: int, num_division: int, seed: int = 42) -> "DivisionManifest":
        return cls(
            num_classes=num_classes,
            num_division=num_division,
            seed=seed,
            divisions=split_classes(num_classes, num_division, seed),
        )

    def classes(self, division: int) -> List[int]:
        return self.divisions[division]

    def label_map(self, division: int) -> Dict[int, int]:
        return local_label_map(self.divisions[division])

    def num_division_classes(self, division: int) -> int:
        return len(self.divisions[division])

    def global_label_of(self, division: int, local: int) -> int:
        ordered = sorted(self.divisions[division], key=str)
        return ordered[local]

    def division_to_global_matrix(self) -> np.ndarray:
        """(num_division, max_local) int matrix mapping local -> global label,
        -1 padded; used to scatter per-division logits into full-label space."""
        width = max(len(d) for d in self.divisions)
        mat = np.full((self.num_division, width), -1, dtype=np.int32)
        for d in range(self.num_division):
            ordered = sorted(self.divisions[d], key=str)
            mat[d, : len(ordered)] = ordered
        return mat

    def select_indices(self, labels: np.ndarray, division: int) -> np.ndarray:
        """Indices of samples whose global label belongs to this division."""
        mask = np.isin(labels, np.asarray(self.divisions[division]))
        return np.nonzero(mask)[0]

    def remap_labels(self, labels: np.ndarray, division: int) -> np.ndarray:
        """Global labels -> local labels for this division's samples."""
        m = self.label_map(division)
        lut = np.full(self.num_classes, -1, dtype=np.int64)
        for g, l in m.items():
            lut[g] = l
        out = lut[labels]
        assert (out >= 0).all(), "labels outside this division"
        return out

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "DivisionManifest":
        with open(path) as f:
            return cls(**json.load(f))


def materialize_imagefolder(manifest: DivisionManifest, data_path: str,
                            output_path: str, link: bool = True,
                            log=None) -> List[str]:
    """Physically export the reference's `sub-dataset{i}` ImageFolder trees
    (splite_dataset.py:120-177): `<data_path>/{train,val|test}/<class>/...` ->
    `<output>/sub-dataset{i}/{train_dataset,test_dataset}/<class>/...`.

    The manifest is the source of truth everywhere in THIS framework; this
    export exists for external tooling (and the reference's own stages) that
    expects the physical directory layout. Class directory NAMES are copied
    verbatim, exactly like the reference's copytree; the manifest's class ids
    index the lexicographic class-dir order (torchvision ImageFolder
    semantics, same convention as data/datasets.load_image_folder).

    Hardlinks by default (no extra disk for a same-filesystem export, the
    common case); falls back to copy2 per file across filesystems or with
    link=False. Idempotent: existing destination files are left in place.
    Returns the sub-dataset{i} roots."""
    train_root = os.path.join(data_path, "train")
    val_root = next((os.path.join(data_path, s) for s in ("val", "test")
                     if os.path.isdir(os.path.join(data_path, s))), None)
    if not os.path.isdir(train_root) or val_root is None:
        raise FileNotFoundError(
            f"materialize needs an ImageFolder layout "
            f"<data_path>/train + <data_path>/val|test under {data_path!r} "
            f"(array-backed datasets have nothing to export — the manifest "
            f"alone drives every devit stage)")
    classes = sorted(d for d in os.listdir(train_root)
                     if os.path.isdir(os.path.join(train_root, d))
                     and not d.startswith("."))
    if len(classes) != manifest.num_classes:
        raise ValueError(
            f"{train_root} has {len(classes)} class dirs but the manifest "
            f"was built for {manifest.num_classes} classes")

    def _export(src_dir: str, dst_dir: str) -> None:
        # recursive, like the reference's copytree (and torchvision's
        # make_dataset, which walks class dirs recursively — nested
        # session/date subdirs are real data, not layout noise)
        for base, _, names in os.walk(src_dir):
            rel = os.path.relpath(base, src_dir)
            out_base = dst_dir if rel == "." else os.path.join(dst_dir, rel)
            os.makedirs(out_base, exist_ok=True)
            for f in sorted(names):
                s, d = os.path.join(base, f), os.path.join(out_base, f)
                if not os.path.isfile(s) or os.path.exists(d):
                    continue
                if link:
                    try:
                        os.link(s, d)  # atomic: link lands whole or not at all
                        continue
                    except OSError:  # cross-device / fs without hardlinks
                        pass
                # copy via per-PID tmp + atomic replace so an interrupted run
                # can never leave a truncated file that the exists-skip above
                # would treat as done on the next run
                tmp = f"{d}.{os.getpid()}.tmp"
                shutil.copy2(s, tmp)
                os.replace(tmp, d)

    roots = []
    for i, div in enumerate(manifest.divisions):
        root = os.path.join(output_path, f"sub-dataset{i}")
        for cid in div:
            cls = classes[cid]
            _export(os.path.join(train_root, cls),
                    os.path.join(root, "train_dataset", cls))
            _export(os.path.join(val_root, cls),
                    os.path.join(root, "test_dataset", cls))
        if log is not None:
            log.info(f"  materialized {root}: {len(div)} classes")
        roots.append(root)
    return roots
