"""On-disk classification data in the ImageFolder layout (counterpart of the
JAX package's ``data/imagefolder.py``; the same file lists, shards, seeds and
batches).

``{root}/{class}/{id}.{png|jpg|jpeg}``: sorted class names map to labels
0..K-1, and only the file list lives in memory. Each rank keeps its
round-robin shard of the list; batches decode on demand through
``native.decode_image_batch`` (the native decoder, or ``data/png.py`` for
PNGs at the target size where the native decoder did not build).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tensorflowdistributedlearning_tpu_torch.data.png import encode_png
from tensorflowdistributedlearning_tpu_torch.data.pipeline import eval_index_batches
from tensorflowdistributedlearning_tpu_torch.parallel import multihost

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


class ImageFolder:
    """A lazily decoded labelled image set in ImageFolder layout."""

    def __init__(
        self,
        root: str,
        image_size: Tuple[int, int],
        channels: int = 3,
        paths: Optional[List[str]] = None,
        labels: Optional[np.ndarray] = None,
        class_names: Optional[List[str]] = None,
    ):
        self.root = root
        self.image_size = tuple(image_size)
        self.channels = channels
        if paths is None:
            class_names = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
            if not class_names:
                raise ValueError(f"No class directories under {root}")
            paths, labels_list = [], []
            for k, name in enumerate(class_names):
                class_dir = os.path.join(root, name)
                # extensions compared lower-cased: .JPG/.PNG/.JPEG count
                files = sorted(
                    os.path.join(class_dir, f) for f in os.listdir(class_dir)
                    if os.path.splitext(f)[1].lower() in IMAGE_EXTENSIONS
                )
                paths.extend(files)
                labels_list.extend([k] * len(files))
            if not paths:
                raise ValueError(f"No .png/.jpg/.jpeg files under {root}/<class>/")
            labels = np.asarray(labels_list, np.int32)
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int32)
        self.class_names = list(class_names or [])

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def num_classes(self) -> int:
        return len(self.class_names) if self.class_names else int(self.labels.max()) + 1

    def shard(self, index: int, count: int) -> "ImageFolder":
        """Round-robin shard ``index`` of ``count``."""
        rows = np.arange(index, len(self.paths), count)
        return ImageFolder(self.root, self.image_size, self.channels, paths=[self.paths[i] for i in rows],
                           labels=self.labels[rows], class_names=self.class_names)

    def host_shard(self) -> "ImageFolder":
        """This rank's shard (of its data slot, ``multihost.data_slot``)."""
        return self.shard(*multihost.data_slot())

    def decode(self, rows: Sequence[int]) -> np.ndarray:
        """The given rows as [n, H, W, C] float32 in [0, 1]."""
        from tensorflowdistributedlearning_tpu_torch.native import decode_image_batch

        h, w = self.image_size
        return decode_image_batch([self.paths[i] for i in rows], h, w, channels=self.channels)


# ImageNet channel statistics
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _normalize(images: np.ndarray, channels: int) -> np.ndarray:
    if channels == 3:
        return (images - IMAGENET_MEAN) / IMAGENET_STD
    return (images - images.mean()) / max(images.std(), 1e-6)


def _augment(images: np.ndarray, rng: np.random.Generator, crop_padding: int) -> np.ndarray:
    """Random horizontal flip and an optional reflect-padded random crop,
    per image."""
    n, h, w, _ = images.shape
    flip = rng.random(n) < 0.5
    images[flip] = images[flip, :, ::-1]
    if crop_padding > 0:
        p = crop_padding
        padded = np.pad(images, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")
        ys = rng.integers(0, 2 * p + 1, n)
        xs = rng.integers(0, 2 * p + 1, n)
        images = np.stack([padded[i, ys[i] : ys[i] + h, xs[i] : xs[i] + w] for i in range(n)])
    return images


def train_batches(
    dataset: ImageFolder,
    batch_size: int,
    seed: int,
    steps: Optional[int] = None,
    augment: bool = True,
    crop_padding: int = 4,
) -> Iterator[Dict[str, np.ndarray]]:
    """An infinite (or ``steps``-bounded) shuffled ``{'images', 'labels'}``
    stream, decoded per batch; epoch permutations chain as in
    ``pipeline.train_batches``. ``augment`` applies the host-side flip and
    crop; ``fit`` passes False and augments on the device."""
    n = len(dataset)
    if n == 0:
        raise ValueError("Empty dataset")
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    pos = 0
    emitted = 0
    while steps is None or emitted < steps:
        while len(order) - pos < batch_size:
            order = np.concatenate([order[pos:], rng.permutation(n)])
            pos = 0
        rows = order[pos : pos + batch_size]
        pos += batch_size
        emitted += 1
        images = dataset.decode(rows)
        if augment:
            images = _augment(images, rng, crop_padding)
        yield {"images": _normalize(images, dataset.channels), "labels": dataset.labels[rows]}


def eval_batches(
    dataset: ImageFolder, batch_size: int, num_batches: Optional[int] = None
) -> Iterator[Dict[str, np.ndarray]]:
    """One ordered pass, decoded per batch, under
    ``pipeline.eval_index_batches``' padding contract (wrap-around pad rows
    with ``valid = 0``, a forced step count, zeros for an empty shard)."""
    n = len(dataset)
    h, w = dataset.image_size
    for rows, valid in eval_index_batches(n, batch_size, num_batches):
        if n == 0:
            images = np.zeros((batch_size, h, w, dataset.channels), np.float32)
            labels = np.zeros(batch_size, np.int32)
        else:
            images = _normalize(dataset.decode(rows), dataset.channels)
            labels = dataset.labels[rows]
        yield {"images": images, "labels": labels, "valid": valid}


def write_synthetic_imagefolder(
    root: str, num_classes: int, per_class: int, image_size: Tuple[int, int], channels: int = 3, seed: int = 0
) -> None:
    """Write a synthetic, learnable ImageFolder set as PNG files
    (class-conditional brightness: pixels ~ N((k + 0.5) / K · 255, 40)); the
    same pixels as the JAX package's writer from the same seed. A file that
    exists is kept, and its draw skipped, as there."""
    rng = np.random.default_rng(seed)
    h, w = image_size
    for k in range(num_classes):
        d = os.path.join(root, f"class{k:03d}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            path = os.path.join(d, f"im{i:04d}.png")
            if os.path.exists(path):
                continue
            base = (k + 0.5) / num_classes * 255.0
            arr = np.clip(rng.normal(base, 40.0, (h, w, channels)), 0, 255).astype(np.uint8)
            with open(path, "wb") as f:
                f.write(encode_png(arr[..., 0] if channels == 1 else arr))
