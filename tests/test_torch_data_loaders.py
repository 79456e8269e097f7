"""The port's dataset loaders, host augmentation and native gather
(devit_tpu_torch/data/datasets.py, fine_grained.py, host_augment.py,
autoaugment.py, io/native.py) against the JAX package's on the CPU.

Each loader reads a tree the test writes (CIFAR pickles, an image folder
with its .npz and memmap caches, the Flowers-102, Stanford Cars,
Oxford-IIIT Pet and iNaturalist layouts), once through each package, and the
arrays must be equal. The host augment and AutoAugment run on the same
np.random.Generator seeds and must give the same uint8 images. The C++
gather must equal numpy's fancy indexing.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest

from devit_tpu.data import autoaugment as jaa
from devit_tpu.data import datasets as jds
from devit_tpu.data import fine_grained as jfg
from devit_tpu.data import host_augment as jha
from devit_tpu.data.pipeline import AugmentConfig as JConfig
from devit_tpu_torch.data import autoaugment as taa
from devit_tpu_torch.data import datasets as tds
from devit_tpu_torch.data import fine_grained as tfg
from devit_tpu_torch.data import host_augment as tha
from devit_tpu_torch.data.pipeline import AugmentConfig as TConfig
from devit_tpu_torch.io import native

IMG = 32


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a.images), np.asarray(b.images))
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.num_classes == b.num_classes


def _write_jpg(path, seed, hw=(40, 48)):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, (*hw, 3), dtype=np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def test_cifar_pickles(tmp_path):
    rng = np.random.default_rng(0)
    c100 = tmp_path / "cifar-100-python"
    c100.mkdir()
    for split, n in (("train", 12), ("test", 6)):
        with open(c100 / split, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"fine_labels": rng.integers(0, 100, n).tolist()}, f)
    c10 = tmp_path / "cifar-10-batches-py"
    c10.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(c10 / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 4).tolist()}, f)
    for name in ("cifar100", "cifar10"):
        for train in (True, False):
            got = tds.build_dataset(name, str(tmp_path), train)
            _same(got, jds.build_dataset(name, str(tmp_path), train))
            assert got.images.dtype == np.uint8 and got.images.shape[1:] == (32, 32, 3)
    with pytest.raises(FileNotFoundError):
        tds.load_cifar100(str(tmp_path / "absent"), True)


def _folder(root, seed):
    for c in range(3):
        for i in range(3):
            _write_jpg(str(root / f"class{c}" / f"im{i}.jpg"), seed + 10 * c + i,
                       hw=(40 + 8 * i, 48 - 4 * c))


@pytest.mark.parametrize("memmap", [False, True])
def test_image_folder_and_its_caches(tmp_path, monkeypatch, memmap):
    if memmap:  # every decoded cache above one byte goes to the raw uint8 memmap
        monkeypatch.setenv("DEVIT_MMAP_BYTES", "1")
    a, b = tmp_path / "a", tmp_path / "b"
    _folder(a, 0)
    shutil.copytree(a, b)
    want = jds.load_image_folder(str(a), IMG)
    got = tds.load_image_folder(str(b), IMG)  # decoded by the port
    _same(got, want)
    assert isinstance(got.images, np.memmap) == memmap
    S = int(IMG * 256 / 224)
    assert got.images.shape == (9, S, S, 3)
    _same(tds.load_image_folder(str(a), IMG), want)  # the JAX package's cache
    _same(jds.load_image_folder(str(b), IMG), want)  # the port's cache
    # IMNET dispatches to the image folder of the split
    os.makedirs(tmp_path / "imnet")
    shutil.copytree(a, tmp_path / "imnet" / "train")
    _same(tds.build_dataset("IMNET", str(tmp_path / "imnet"), True, IMG), want)


def _flowers(root):
    from scipy.io import savemat

    base = root / "flowers-102"
    for i in range(1, 7):
        _write_jpg(str(base / "jpg" / f"image_{i:05d}.jpg"), seed=i)
    savemat(str(base / "imagelabels.mat"), {"labels": np.array([[1, 2, 3, 1, 2, 3]], np.uint8)})
    savemat(str(base / "setid.mat"), {"trnid": np.array([[1, 2]], np.uint16),
                                      "valid": np.array([[3, 4]], np.uint16),
                                      "tstid": np.array([[5, 6]], np.uint16)})


def _cars(root):
    from scipy.io import savemat

    base = root / "stanford_cars"
    names = [f"{i:05d}.jpg" for i in range(1, 4)]
    for split in ("cars_train", "cars_test"):
        for k, n in enumerate(names):
            _write_jpg(str(base / split / n), seed=100 + k)

    def annos(labels):
        ann = np.empty((len(labels),), dtype=[("bbox_x1", "O"), ("fname", "O"), ("class", "O")])
        for k, (n, c) in enumerate(zip(names, labels)):
            ann[k] = (np.array([[1]], np.uint8), n, np.array([[c]], np.uint8))
        return ann.reshape(1, -1)

    os.makedirs(str(base / "devkit"), exist_ok=True)
    savemat(str(base / "devkit" / "cars_train_annos.mat"), {"annotations": annos([1, 5, 196])})
    savemat(str(base / "cars_test_annos_withlabels.mat"), {"annotations": annos([2, 5, 1])})


def _pets(root):
    base = root / "oxford-iiit-pet"
    for k, name in enumerate(["Abyssinian_1", "Abyssinian_2", "yorkshire_10", "beagle_3"]):
        _write_jpg(str(base / "images" / f"{name}.jpg"), seed=200 + k)
    os.makedirs(str(base / "annotations"), exist_ok=True)
    (base / "annotations" / "trainval.txt").write_text(
        "Abyssinian_1 1 1 1\nAbyssinian_2 1 1 1\nyorkshire_10 37 2 25\n")
    (base / "annotations" / "test.txt").write_text("beagle_3 5 2 2\n")


def _inat(root):
    cats = [{"id": 10, "name": "sp_a", "kingdom": "Animalia"},
            {"id": 20, "name": "sp_b", "kingdom": "Plantae"},
            {"id": 30, "name": "sp_c", "kingdom": "Animalia"}]
    imgs = [{"id": i, "file_name": f"train_val2018/img_{i}.jpg"} for i in range(3)]
    anns = [{"image_id": 0, "category_id": 20}, {"image_id": 1, "category_id": 10},
            {"image_id": 2, "category_id": 30}]
    for i in range(3):
        _write_jpg(str(root / "train_val2018" / f"img_{i}.jpg"), seed=300 + i)
    (root / "train2018.json").write_text(json.dumps({"images": imgs, "annotations": anns}))
    (root / "val2018.json").write_text(json.dumps({"images": imgs[:1], "annotations": anns[:1]}))
    (root / "categories.json").write_text(json.dumps(cats))


@pytest.mark.parametrize("name", ["flowers", "cars", "pets", "INAT"])
def test_fine_grained_layouts(tmp_path, name):
    a, b = tmp_path / "a", tmp_path / "b"
    for root in (a, b):
        root.mkdir()
        {"flowers": _flowers, "cars": _cars, "pets": _pets, "INAT": _inat}[name](root)
    for train in (True, False):
        want = jds.build_dataset(name, str(a), train, IMG)
        _same(tds.build_dataset(name, str(b), train, IMG), want)
    if name == "INAT":
        for cat in ("name", "kingdom"):
            _same(tfg.load_inat(str(b), "train", year=2018, category=cat, img_size=IMG),
                  jfg.load_inat(str(a), "train", year=2018, category=cat, img_size=IMG))


def test_host_augment_and_autoaugment_equal_the_jax_packages():
    batch = np.random.default_rng(3).integers(0, 256, (6, 40, 40, 3), dtype=np.uint8)
    for kw in (dict(), dict(interpolation="random"), dict(randaugment=False),
               dict(ra_inc=False, ra_std=float("inf")), dict(autoaugment="original"),
               dict(small_image=True, img_size=40)):
        kw.setdefault("img_size", 32)
        want = jha.make_host_train_augment(JConfig(**kw), seed=5)(batch, 2, 1)
        got = tha.make_host_train_augment(TConfig(**kw), seed=5)(batch, 2, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
    from PIL import Image

    img = Image.fromarray(batch[0])
    for policy in ("original", "cifar10"):
        for seed in range(4):
            want = jaa.auto_augment_pil(img, np.random.default_rng(seed), jaa.get_policy(policy))
            got = taa.auto_augment_pil(img, np.random.default_rng(seed), taa.get_policy(policy))
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_native_gather_equals_numpy(tmp_path):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 256, (300, 6, 5, 3), dtype=np.uint8)
    before = native.gather_rows.launches
    for idx in (np.array([0, 299, 5, 5]), rng.integers(0, 300, 257), np.array([], np.int64)):
        np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
        np.testing.assert_array_equal(native.gather_rows(src, idx, n_threads=1), src[idx])
    assert native.gather_rows.launches == before + 6
    mm = np.memmap(str(tmp_path / "rows.u8"), dtype=np.uint8, mode="w+", shape=src.shape)
    mm[:] = src
    np.testing.assert_array_equal(native.gather_rows(mm, np.arange(299, -1, -7)),
                                  src[np.arange(299, -1, -7)])
    for bad in ([-1], [300], [0, 400]):
        with pytest.raises(IndexError, match="out of range"):
            native.gather_rows(src, np.array(bad))
    # another dtype or a strided view: numpy's indexing, not counted
    n = native.gather_rows.launches
    np.testing.assert_array_equal(native.gather_rows(src.astype(np.float32), [1, 2]),
                                  src[[1, 2]].astype(np.float32))
    np.testing.assert_array_equal(native.gather_rows(src[::2], [1, 2]), src[::2][[1, 2]])
    assert native.gather_rows.launches == n
    assert native.build().parent.name == "devit_tpu_torch_host"
    # BatchIterator gathers through it
    ds = tds.ArrayDataset(src, np.arange(300) % 7, 7)
    it = tds.BatchIterator(ds, 64, shuffle=True, seed=1, prefetch=0)
    jit = jds.BatchIterator(jds.ArrayDataset(src, np.arange(300) % 7, 7), 64, shuffle=True,
                            seed=1, prefetch=0)
    n = native.gather_rows.launches
    for (a, la), (b, lb) in zip(it, jit):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    assert native.gather_rows.launches == n + len(it) == n + 4
