"""The port's data path against the JAX package's, on the CPU: fold
manifests and batch streams (numpy in both packages: identical), PNG decode
(identical bytes), the inverse affine warp given one matrix (bilinear 1e-5,
nearest exact away from .5 ties), the affine builders, reflect padding, and
the sampled augmentation by its distribution (torch's generator cannot
reproduce ``jax.random``'s bits).
"""

from __future__ import annotations

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.data import augment as jaug
from tensorflowdistributedlearning_tpu.data import folds as jfolds
from tensorflowdistributedlearning_tpu.data import pipeline as jpipe
from tensorflowdistributedlearning_tpu.data import synthetic as jsyn
from tensorflowdistributedlearning_tpu_torch.data import augment as taug
from tensorflowdistributedlearning_tpu_torch.data import folds as tfolds
from tensorflowdistributedlearning_tpu_torch.data import pipeline as tpipe
from tensorflowdistributedlearning_tpu_torch.data import png as tpng
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tests.conftest import make_salt_dataset


@pytest.fixture(scope="module")
def salt(tmp_path_factory):
    data, _, ids = make_salt_dataset(tmp_path_factory.mktemp("salt"), n_images=20, shape=(21, 21))
    return data, ids


# -- folds and batch streams: identical ---------------------------------------------------


@pytest.mark.parametrize("n_splits,seed", [(2, 0), (5, 42), (3, 7)])
def test_fold_manifests_identical_to_jax(n_splits, seed):
    rng = np.random.default_rng(seed)
    ids = [f"id{i:03d}" for i in range(37)]
    coverage = rng.uniform(0, 1, 37) * (rng.uniform(size=37) > 0.3)
    y = tfolds.coverage_to_class(coverage)
    np.testing.assert_array_equal(y, jfolds.coverage_to_class(coverage))
    assert tfolds.build_fold_manifests(ids, y, n_splits, seed) == jfolds.build_fold_manifests(ids, y, n_splits, seed)


def test_write_fold_manifests_idempotent_and_readable_by_jax(tmp_path):
    ids = [f"x{i}" for i in range(12)]
    y = [i % 3 for i in range(12)]
    first = tfolds.write_fold_manifests(str(tmp_path), ids, y, 3, 1)
    assert jfolds.read_fold_manifests(str(tmp_path)) == first
    # a second call reuses the written split whatever it is given
    assert tfolds.write_fold_manifests(str(tmp_path), ids, [0] * 12, 3, 99) == first
    assert tfolds.read_fold_manifests(str(tmp_path)) == first


def test_dataset_and_train_batches_identical_to_jax(salt):
    data, ids = salt
    tds = tpipe.InMemoryDataset.from_directory(data, ids=ids)
    jds = jpipe.InMemoryDataset.from_directory(data, ids=ids)
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.masks, jds.masks)
    np.testing.assert_array_equal(tpipe.mask_coverage(tds.masks), jpipe.mask_coverage(jds.masks))
    assert tpipe.discover_ids(data) == jpipe.discover_ids(data)
    got = list(tpipe.train_batches(tds, 6, seed=3, steps=9))
    want = list(jpipe.train_batches(jds, 6, seed=3, steps=9))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["masks"], w["masks"])
    sub = ids[3:11]
    np.testing.assert_array_equal(tds.select(sub).images, jds.select(sub).images)


@pytest.mark.parametrize("n,bs,num", [(10, 4, None), (8, 4, None), (3, 4, 2), (0, 4, 1)])
def test_eval_index_batches_identical_to_jax(n, bs, num):
    got = list(tpipe.eval_index_batches(n, bs, num))
    want = list(jpipe.eval_index_batches(n, bs, num))
    assert len(got) == len(want)
    for (gr, gv), (wr, wv) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gv, wv)


def test_eval_batches_identical_to_jax(salt):
    data, ids = salt
    tds = tpipe.InMemoryDataset.from_directory(data, ids=ids)
    jds = jpipe.InMemoryDataset.from_directory(data, ids=ids)
    for g, w in zip(tpipe.eval_batches(tds, 8), jpipe.eval_batches(jds, 8)):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_synthetic_batches_identical_to_jax():
    for g, w in zip(tsyn.synthetic_batches("segmentation", 3, seed=5, steps=2, input_shape=(17, 17)),
                    jsyn.synthetic_batches("segmentation", 3, seed=5, steps=2, input_shape=(17, 17))):
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["labels"], w["labels"])


def test_device_prefetch_places_in_order_and_reraises():
    seen = list(tpipe.device_prefetch(iter(range(5)), lambda i: i * 10, depth=2))
    assert seen == [0, 10, 20, 30, 40]

    def bad():
        yield 1
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(tpipe.device_prefetch(bad(), lambda i: i, depth=1))
    with pytest.raises(ValueError):
        tpipe.device_prefetch(iter([]), lambda i: i, depth=0)
    placed = tpipe.to_device({"images": np.ones((2, 3), np.float32)}, torch.device("cpu"))
    assert placed["images"].dtype == torch.float32 and placed["images"].shape == (2, 3)


# -- PNG codec: the bytes PIL gives ------------------------------------------------------


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_matches_pil(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(len(mode))
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    # smooth gradients plus noise, so PIL's adaptive filters pick every row filter
    base = np.add.outer(np.arange(37), np.arange(29)).astype(np.float64)
    arr = np.stack([(base * (c + 1) + rng.integers(0, 40, base.shape)) % 256 for c in range(channels)], -1)
    arr = arr.astype(np.uint8)
    path = os.path.join(tmp_path, f"{mode}.png")
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(path)
    with Image.open(path) as im:
        want = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(tpng.read_png_gray(path), want)


def test_png_writer_round_trips_through_pil(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 256, (13, 17)).astype(np.uint8)
    path = os.path.join(tmp_path, "w.png")
    tpng.write_png_gray(path, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(tpng.read_png_gray(path), img)
    np.testing.assert_array_equal(tpipe.load_png(path)[..., 0], img.astype(np.float32) / np.float32(255.0))


# -- the warp given one matrix ------------------------------------------------------------


def _matrices():
    rot = np.asarray(jaug._rotation(jnp.asarray(0.3), 31.0, 31.0))
    trans = np.asarray(jaug._translation(jnp.asarray(2.37), jnp.asarray(-4.61)))
    zoom = np.asarray(jaug._zoom_crop(jnp.asarray(0.93), jnp.asarray(1.7), jnp.asarray(0.4)))
    flip = np.asarray(jaug._hflip(31.0)) @ np.asarray(jaug._vflip(31.0))
    return {"rot": rot, "rot_trans": rot @ trans, "zoom": zoom @ rot, "flip": flip @ trans}


@pytest.mark.parametrize("name", ["rot", "rot_trans", "zoom", "flip"])
def test_apply_warp_matches_jax_given_one_matrix(name):
    m = _matrices()[name].astype(np.float32)
    rng = np.random.default_rng(1)
    image = rng.normal(size=(31, 31, 2)).astype(np.float32)
    mask = (rng.uniform(size=(31, 31, 1)) > 0.5).astype(np.float32)
    want = np.asarray(jaug._apply_warp(jnp.asarray(image), jnp.asarray(m), order=1))
    got = taug._apply_warp(torch.from_numpy(image), torch.from_numpy(m), order=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)  # bilinear: 1e-5
    want0 = np.asarray(jaug._apply_warp(jnp.asarray(mask), jnp.asarray(m), order=0))
    got0 = taug._apply_warp(torch.from_numpy(mask), torch.from_numpy(m), order=0).numpy()
    # nearest: exact away from .5 ties of the sampling coordinates
    ys, xs = np.meshgrid(np.arange(31, dtype=np.float32), np.arange(31, dtype=np.float32), indexing="ij")
    cx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    cy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    away = (np.abs(np.abs(cx - np.floor(cx)) - 0.5) > 1e-4) & (np.abs(np.abs(cy - np.floor(cy)) - 0.5) > 1e-4)
    assert away.mean() > 0.9
    np.testing.assert_array_equal(got0[away], want0[away])


def test_warp_rounds_half_away_from_zero_like_map_coordinates():
    image = np.arange(25, dtype=np.float32).reshape(5, 5, 1)
    m = np.array([[1, 0, 0.5], [0, 1, -0.5], [0, 0, 1]], np.float32)  # exact .5 shifts
    want = np.asarray(jaug._apply_warp(jnp.asarray(image), jnp.asarray(m), order=0))
    got = taug._apply_warp(torch.from_numpy(image), torch.from_numpy(m), order=0).numpy()
    np.testing.assert_array_equal(got, want)


def test_warp_of_central_window_equals_central_crop_of_warp():
    rng = np.random.default_rng(2)
    images = torch.from_numpy(rng.normal(size=(3, 41, 41, 1)).astype(np.float32))
    mats = torch.from_numpy(np.stack([_matrices()[k] for k in ("rot", "zoom", "flip")]).astype(np.float32))
    full = taug._warp_batch(images, mats, 1)
    window = taug._warp_batch(images, mats, 1, out_hw=(21, 21))
    torch.testing.assert_close(window, taug.central_crop(full, (21, 21)), rtol=0, atol=0)
    np.testing.assert_array_equal(
        taug.central_crop(full, (21, 21)).numpy(), np.asarray(jaug.central_crop(jnp.asarray(full.numpy()), (21, 21)))
    )


def test_affine_builders_match_jax():
    np.testing.assert_array_equal(taug._hflip(31.0)[0].numpy(), np.asarray(jaug._hflip(31.0)))
    np.testing.assert_array_equal(taug._vflip(17.0)[0].numpy(), np.asarray(jaug._vflip(17.0)))
    np.testing.assert_allclose(
        taug._rotation(torch.tensor([0.3]), 31.0, 29.0)[0].numpy(),
        np.asarray(jaug._rotation(jnp.asarray(0.3), 31.0, 29.0)), atol=1e-6,
    )
    np.testing.assert_array_equal(
        taug._translation(torch.tensor([2.5]), torch.tensor([-1.25]))[0].numpy(),
        np.asarray(jaug._translation(jnp.asarray(2.5), jnp.asarray(-1.25))),
    )
    np.testing.assert_array_equal(
        taug._zoom_crop(torch.tensor([0.9]), torch.tensor([1.5]), torch.tensor([2.0]))[0].numpy(),
        np.asarray(jaug._zoom_crop(jnp.asarray(0.9), jnp.asarray(1.5), jnp.asarray(2.0))),
    )


@pytest.mark.parametrize("n,pad", [(7, 3), (5, 12), (2, 4), (1, 3)])
def test_reflect_pad_matches_jnp_reflect(n, pad):
    x = np.arange(2 * n * n, dtype=np.float32).reshape(1, n, n, 2)
    want = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="reflect")
    np.testing.assert_array_equal(taug._reflect_pad(torch.from_numpy(x), pad).numpy(), want)


# -- sampled augmentation: by distribution ------------------------------------------------


def test_sample_affine_distribution():
    cfg = taug.AugmentConfig(crop_probability=0.0)
    n, size = 4000, 181.0
    gen = torch.Generator().manual_seed(0)
    m = taug._sample_affine(gen, n, cfg, size, size).numpy()
    det = np.linalg.det(m[:, :2, :2])
    # flips: each coin at p=0.5, so the orientation flips in half the cases
    np.testing.assert_allclose((det < 0).mean(), 0.5, atol=0.03)
    # rotation within +-10 degrees: the linear part is a signed rotation
    angle = np.degrees(np.arctan2(np.abs(m[:, 1, 0]), np.abs(m[:, 0, 0])))
    assert angle.max() <= 10.0 + 1e-3 and angle.max() > 9.0
    # the center moves by at most the shift range (0.2 * height) per axis
    c = (size - 1) / 2
    moved = m[:, :2, :2] @ np.array([c, c]) + m[:, :2, 2] - c
    assert np.abs(moved).max() <= 0.2 * size * math.sqrt(2) + 1e-3
    # the JAX sampler obeys the same bounds
    import jax

    jm = np.stack([np.asarray(jaug._sample_affine(k, jaug.AugmentConfig(crop_probability=0.0), size, size))
                   for k in jax.random.split(jax.random.key(0), 200)])
    jdet = np.linalg.det(jm[:, :2, :2])
    assert set(np.round(np.abs(jdet), 4)) == set(np.round(np.abs(det), 4)) == {1.0}


def test_augment_batch_shapes_and_mask_values():
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.normal(size=(6, 21, 21, 1)).astype(np.float32))
    masks = torch.from_numpy((rng.uniform(size=(6, 21, 21, 1)) > 0.5).astype(np.float32))
    out = taug.augment_batch(torch.Generator().manual_seed(1), images, masks, taug.AugmentConfig(pad=8))
    assert out["images"].shape == (6, 21, 21, 2) and out["labels"].shape == (6, 21, 21, 1)
    assert set(np.unique(out["labels"].numpy())) <= {0.0, 1.0}
    np.testing.assert_allclose(out["images"][..., 1:].numpy(),
                               taug.laplacian(out["images"][..., :1]).numpy(), atol=1e-6)
    again = taug.augment_batch(torch.Generator().manual_seed(1), images, masks, taug.AugmentConfig(pad=8))
    torch.testing.assert_close(out["images"], again["images"], rtol=0, atol=0)
    # identity config: no geometry, only the Laplacian channel
    ident = taug.AugmentConfig(horizontal_flip=False, vertical_flip=False, rotate_range=0.0, crop_probability=0.0,
                               height_shift_range=0.0, width_shift_range=0.0, transpose_probability=0.0)
    same = taug.augment_batch(torch.Generator().manual_seed(2), images, masks, ident)
    torch.testing.assert_close(same["images"][..., :1], images, rtol=0, atol=1e-6)
    torch.testing.assert_close(same["labels"], masks, rtol=0, atol=0)
    prep = taug.prepare_eval_batch(images, masks)
    np.testing.assert_allclose(prep["images"].numpy(),
                               np.asarray(jaug.prepare_eval_batch(jnp.asarray(images.numpy()),
                                                                  jnp.asarray(masks.numpy()))["images"]), atol=1e-5)
