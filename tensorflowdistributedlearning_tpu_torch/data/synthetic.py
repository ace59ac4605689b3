"""Synthetic data generators for tests and smoke runs (counterpart of
``tensorflowdistributedlearning_tpu/data/synthetic.py``, which is pure numpy:
the same seed gives the same batches in both packages)."""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def synthetic_segmentation_batch(
    rng: np.random.Generator,
    batch_size: int,
    input_shape: Tuple[int, int] = (101, 101),
    channels: int = 2,
) -> Dict[str, np.ndarray]:
    """Random-disk masks with correlated images — learnable in a few steps.

    Mimics the TGS salt layout the reference trained on: images [B, H, W, C] float32,
    labels [B, H, W, 1] in {0, 1} (reference: preprocessing/preprocessing.py:91-97).
    """
    h, w = input_shape
    yy, xx = np.mgrid[0:h, 0:w]
    images = np.empty((batch_size, h, w, channels), np.float32)
    labels = np.empty((batch_size, h, w, 1), np.float32)
    for i in range(batch_size):
        cy, cx = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        r = rng.uniform(0.1, 0.3) * min(h, w)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < r**2).astype(np.float32)
        labels[i, :, :, 0] = mask
        base = mask * 1.5 - 0.75 + rng.normal(0, 0.2, (h, w))
        for c in range(channels):
            images[i, :, :, c] = base
    return {"images": images, "labels": labels}


def synthetic_classification_batch(
    rng: np.random.Generator,
    batch_size: int,
    input_shape: Tuple[int, int] = (32, 32),
    channels: int = 3,
    num_classes: int = 10,
) -> Dict[str, np.ndarray]:
    """Class-conditional Gaussian blobs; labels [B] int32."""
    h, w = input_shape
    labels = rng.integers(0, num_classes, batch_size).astype(np.int32)
    images = rng.normal(0, 0.3, (batch_size, h, w, channels)).astype(np.float32)
    images += (labels[:, None, None, None].astype(np.float32) / num_classes) - 0.5
    return {"images": images, "labels": labels}


def synthetic_batches(
    kind: str,
    batch_size: int,
    seed: int = 0,
    steps: Optional[int] = None,
    start_index: int = 0,
    index_keyed: bool = False,
    **kwargs,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite (or ``steps``-bounded) stream of synthetic batches.

    ``index_keyed=True`` makes batch ``i`` a pure function of ``(seed, i)``
    (fresh ``default_rng((seed, i))`` per batch) and starts at
    ``start_index`` — the restart-invariant form the resilience contract
    needs: a run resumed at step k sees bit-for-bit the batches the
    uninterrupted run saw from step k. The default streaming form (one rng
    across the stream) is byte-stable with what it always produced, which the
    determinism goldens pin."""
    if kind not in ("segmentation", "classification"):
        raise ValueError(f"Unknown synthetic data kind {kind!r}")
    make = (
        synthetic_segmentation_batch
        if kind == "segmentation"
        else synthetic_classification_batch
    )
    if index_keyed:
        i = start_index
        while steps is None or i < start_index + steps:
            yield make(np.random.default_rng((seed, i)), batch_size, **kwargs)
            i += 1
        return
    if start_index:
        raise ValueError("start_index requires index_keyed=True")
    rng = np.random.default_rng(seed)
    i = 0
    while steps is None or i < steps:
        yield make(rng, batch_size, **kwargs)
        i += 1
