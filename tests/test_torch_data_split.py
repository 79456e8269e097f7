"""Stage-1 data of the port (devit_tpu_torch/data/splitter.py and the
ArrayDataset / synthetic_dataset / BatchIterator part of data/datasets.py)
vs the JAX package: the class split and the manifest's JSON file byte for
byte, the ImageFolder export, synthetic images and division views bit for
bit, BatchIterator batch for batch in every mode, and the gather's range
check."""

import os

import numpy as np
import pytest

from devit_tpu.data import datasets as jdata
from devit_tpu.data import splitter as jsplit
from devit_tpu_torch.data import datasets as tdata
from devit_tpu_torch.data import splitter as tsplit


@pytest.mark.parametrize("num_classes,num_division", [(100, 4), (102, 4), (10, 3), (7, 7)])
def test_split_and_label_maps_equal_jax(num_classes, num_division):
    got = tsplit.split_classes(num_classes, num_division)
    assert got == jsplit.split_classes(num_classes, num_division)
    for d in got:
        assert tsplit.local_label_map(d) == jsplit.local_label_map(d)


def test_manifest_json_equals_jax_byte_for_byte(tmp_path):
    want = jsplit.DivisionManifest.create(100, 4, seed=42)
    got = tsplit.DivisionManifest.create(100, 4, seed=42)
    want.save(str(tmp_path / "jax.json"))
    got.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    back = tsplit.DivisionManifest.load(str(tmp_path / "jax.json"))
    assert back == got
    labels = np.arange(100)
    for d in range(4):
        assert back.label_map(d) == want.label_map(d)
        assert back.global_label_of(d, 3) == want.global_label_of(d, 3)
        np.testing.assert_array_equal(back.select_indices(labels, d),
                                      want.select_indices(labels, d))
        idx = want.select_indices(labels, d)
        np.testing.assert_array_equal(back.remap_labels(labels[idx], d),
                                      want.remap_labels(labels[idx], d))
    np.testing.assert_array_equal(back.division_to_global_matrix(),
                                  want.division_to_global_matrix())


def _tree(root):
    return sorted((os.path.relpath(os.path.join(b, f), root),
                   open(os.path.join(b, f), "rb").read())
                  for b, _, names in os.walk(root) for f in names)


@pytest.mark.parametrize("link", [True, False])
def test_materialize_imagefolder_equals_jax(tmp_path, link):
    src = tmp_path / "data"
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for cls in (f"class_{c}" for c in "abcdef"):
            d = src / split / cls
            d.mkdir(parents=True)
            (d / "im.bin").write_bytes(rng.integers(0, 256, 16, np.uint8).tobytes())
    (src / "train" / "class_a" / "session1").mkdir()
    (src / "train" / "class_a" / "session1" / "deep.bin").write_bytes(b"x")
    manifest = tsplit.DivisionManifest.create(6, 2, seed=42)
    got = tsplit.materialize_imagefolder(manifest, str(src), str(tmp_path / "port"), link=link)
    want = jsplit.materialize_imagefolder(jsplit.DivisionManifest.create(6, 2, seed=42),
                                          str(src), str(tmp_path / "jax"), link=link)
    assert [os.path.basename(r) for r in got] == [os.path.basename(r) for r in want]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    with pytest.raises(FileNotFoundError):
        tsplit.materialize_imagefolder(manifest, str(tmp_path / "nothing"), str(tmp_path / "o"))


@pytest.mark.parametrize("num_classes,n,img_size,seed", [(100, 64, 32, 0), (10, 9, 20, 1),
                                                         (25, 4, 224, 1)])
def test_synthetic_dataset_and_division_view_bit_equal(num_classes, n, img_size, seed):
    want = jdata.synthetic_dataset(num_classes, n, img_size, seed=seed)
    got = tdata.synthetic_dataset(num_classes, n, img_size, seed=seed)
    for k in ("images", "labels"):
        w, g = getattr(want, k), getattr(got, k)
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    assert got.num_classes == want.num_classes
    man = tsplit.DivisionManifest.create(num_classes, 2, seed=42)
    jman = jsplit.DivisionManifest.create(num_classes, 2, seed=42)
    for d in range(2):
        gv, wv = got.division_view(man, d), want.division_view(jman, d)
        assert gv.num_classes == wv.num_classes
        np.testing.assert_array_equal(gv.images, wv.images)
        np.testing.assert_array_equal(gv.labels, wv.labels)
        np.testing.assert_array_equal(gv.rows(np.arange(len(gv))), wv.rows(np.arange(len(wv))))


def test_division_view_over_a_memmap_stays_lazy(tmp_path):
    ds = tdata.synthetic_dataset(6, 40, 8, seed=3)
    mm = np.memmap(tmp_path / "imgs.u8", dtype=np.uint8, mode="w+", shape=ds.images.shape)
    mm[:] = ds.images
    mm.flush()
    ro = np.memmap(tmp_path / "imgs.u8", dtype=np.uint8, mode="r", shape=ds.images.shape)
    man = tsplit.DivisionManifest.create(6, 2, seed=42)
    jman = jsplit.DivisionManifest.create(6, 2, seed=42)
    for d in range(2):
        lazy = tdata.ArrayDataset(ro, ds.labels, 6).division_view(man, d)
        want = jdata.ArrayDataset(ro, ds.labels, 6).division_view(jman, d)
        assert isinstance(lazy.images, np.memmap) and lazy.indices is not None
        np.testing.assert_array_equal(lazy.indices, want.indices)
        for (gi, gl), (wi, wl) in zip(tdata.BatchIterator(lazy, 4, seed=5, prefetch=0),
                                      jdata.BatchIterator(want, 4, seed=5, prefetch=0)):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def _host_transform(imgs, epoch, k):
    return (imgs.astype(np.int32) + 7 * epoch + k).astype(np.uint8)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("repeated_aug", [0, 3])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_batch_iterator_equals_jax(shuffle, drop_last, repeated_aug, prefetch):
    # 300 samples: past 256, so repeated_aug truncates to 256
    ds = tdata.synthetic_dataset(10, 300, 8, seed=2)
    jds = jdata.ArrayDataset(ds.images, ds.labels, ds.num_classes)
    kw = dict(shuffle=shuffle, seed=4, drop_last=drop_last, repeated_aug=repeated_aug,
              prefetch=prefetch, host_transform=_host_transform)
    got, want = tdata.BatchIterator(ds, 32, **kw), jdata.BatchIterator(jds, 32, **kw)
    assert len(got) == len(want)
    for epoch in (0, 3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        g, w = list(got), list(want)
        assert len(g) == len(w) == len(got)
        for (gi, gl), (wi, wl) in zip(g, w):
            assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_batch_iterator_small_dataset_and_early_stop():
    ds = tdata.synthetic_dataset(5, 20, 8, seed=0)
    jds = jdata.ArrayDataset(ds.images, ds.labels, ds.num_classes)
    for kw in (dict(repeated_aug=3, drop_last=False), dict(drop_last=True)):
        got = [b for b in tdata.BatchIterator(ds, 6, prefetch=2, **kw)]
        want = [b for b in jdata.BatchIterator(jds, 6, prefetch=2, **kw)]
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    it = iter(tdata.BatchIterator(ds, 2, prefetch=1))
    next(it)
    it.close()  # a consumer that stops early ends the producer thread


def test_gather_rejects_out_of_range_rows():
    src = np.arange(24, dtype=np.uint8).reshape(6, 4)
    np.testing.assert_array_equal(tdata.gather_rows(src, np.array([5, 0, 5])),
                                  src[[5, 0, 5]])
    for bad in ([-1], [6], [0, 7]):
        with pytest.raises(IndexError):
            tdata.gather_rows(src, np.array(bad))
    ds = tdata.ArrayDataset(src.reshape(6, 2, 2, 1), np.zeros(3, np.int64), 1,
                            indices=np.array([0, 1, 9]))
    with pytest.raises(IndexError):
        list(tdata.BatchIterator(ds, 3, shuffle=False, prefetch=2))
