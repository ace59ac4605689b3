"""The port's ImageFolder input (``data/imagefolder.py``) against the JAX
package's, on the CPU, bit for bit: the file list and labels (mixed-case
extensions, JPEGs, a file of another size), shards, the train stream with
and without the host-side flip and crop, the padded eval stream with a
forced batch count, and the synthetic writer's pixels. Where the native
decoder did not build, ``data/png.py`` gives the same batches for PNGs at
the target size.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
from PIL import Image

from tensorflowdistributedlearning_tpu.data import imagefolder as jimf
from tensorflowdistributedlearning_tpu_torch.data import imagefolder as timf
from tensorflowdistributedlearning_tpu_torch.native import loader as tloader

HW = (12, 10)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 classes of 12x10 RGB images: PNGs, a .JPG and a .jpeg, a PNG of
    another size (resized on decode), and a file that is not an image."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for k, name in enumerate(("cat", "bird", "dog")):
        d = root / name
        d.mkdir()
        for i in range(5 + k):
            Image.fromarray(rng.integers(0, 256, (*HW, 3), dtype=np.uint8)).save(d / f"im{i}.png")
        (d / "notes.txt").write_text("not an image")
    Image.fromarray(rng.integers(0, 256, (*HW, 3), dtype=np.uint8)).save(root / "cat" / "upper.JPG", quality=90)
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)).save(root / "dog" / "big.jpeg", quality=90)
    Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(root / "bird" / "other.png")
    return str(root)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_file_list_labels_and_shards_match_jax(folder):
    port, jax_ds = timf.ImageFolder(folder, HW), jimf.ImageFolder(folder, HW)
    assert port.paths == jax_ds.paths and len(port) == 21
    assert np.array_equal(port.labels, jax_ds.labels) and port.class_names == jax_ds.class_names
    assert port.num_classes == jax_ds.num_classes == 3
    for count in (2, 3):
        for index in range(count):
            a, b = port.shard(index, count), jax_ds.shard(index, count)
            assert a.paths == b.paths and np.array_equal(a.labels, b.labels)
    assert port.host_shard().paths == port.paths
    with pytest.raises(ValueError, match="No class directories"):
        timf.ImageFolder(os.path.join(folder, "cat"), HW)


@pytest.mark.parametrize("augment", [False, True])
def test_train_batches_match_jax(folder, augment):
    port, jax_ds = timf.ImageFolder(folder, HW), jimf.ImageFolder(folder, HW)
    got = list(timf.train_batches(port, 8, seed=4, steps=6, augment=augment, crop_padding=2))
    want = list(jimf.train_batches(jax_ds, 8, seed=4, steps=6, augment=augment, crop_padding=2))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("num_batches", [None, 5])
def test_eval_batches_match_jax(folder, num_batches):
    port, jax_ds = timf.ImageFolder(folder, HW).shard(1, 2), jimf.ImageFolder(folder, HW).shard(1, 2)
    got = list(timf.eval_batches(port, 4, num_batches=num_batches))
    want = list(jimf.eval_batches(jax_ds, 4, num_batches=num_batches))
    assert len(got) == len(want) == (num_batches or 3)
    for a, b in zip(got, want):
        _same(a, b)
    assert sum(float(b["valid"].sum()) for b in got) == len(port) == 10
    empty = timf.ImageFolder(folder, HW, paths=[], labels=np.zeros(0, np.int32), class_names=["a"])
    _same(next(timf.eval_batches(empty, 4, num_batches=1)),
          next(jimf.eval_batches(jimf.ImageFolder(folder, HW, paths=[], labels=np.zeros(0, np.int32),
                                                  class_names=["a"]), 4, num_batches=1)))


@pytest.mark.parametrize("channels", [3, 1])
def test_synthetic_writer_writes_jaxs_pixels(tmp_path, channels):
    timf.write_synthetic_imagefolder(str(tmp_path / "port"), 3, 4, HW, channels=channels, seed=7)
    jimf.write_synthetic_imagefolder(str(tmp_path / "jax"), 3, 4, HW, channels=channels, seed=7)
    port, jax_ds = timf.ImageFolder(str(tmp_path / "port"), HW, channels), \
        jimf.ImageFolder(str(tmp_path / "jax"), HW, channels)
    assert [os.path.relpath(p, tmp_path / "port") for p in port.paths] == \
        [os.path.relpath(p, tmp_path / "jax") for p in jax_ds.paths]
    for a, b in zip(port.paths, jax_ds.paths):
        assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
    rows = np.arange(len(port))
    assert np.array_equal(port.decode(rows), jax_ds.decode(rows))
    # an existing file is kept: a rerun rewrites nothing
    before = {p: os.path.getmtime(p) for p in port.paths}
    timf.write_synthetic_imagefolder(str(tmp_path / "port"), 3, 4, HW, channels=channels, seed=8)
    assert {p: os.path.getmtime(p) for p in port.paths} == before


def test_png_py_gives_the_native_batches(tmp_path, monkeypatch):
    timf.write_synthetic_imagefolder(str(tmp_path), 2, 5, HW, seed=3)
    ds = timf.ImageFolder(str(tmp_path), HW)
    native = list(timf.train_batches(ds, 4, seed=1, steps=3, augment=False))
    monkeypatch.setitem(tloader._libs, "io", None)
    assert tloader.decoder() == "png.py"
    for a, b in zip(timf.train_batches(ds, 4, seed=1, steps=3, augment=False), native, strict=True):
        _same(a, b)
