"""Kaggle TGS-salt submission helpers (counterpart of the JAX package's
``data/kaggle.py`` ``rle_encode``, ``rle_decode`` and ``write_submission``):
the run-length encoding of a binary mask and the ``id,rle_mask`` CSV that
the fold × TTA ensemble prediction ends in. The rest of that module (the
CSV readers and the coverage classes from ``train.csv``) is not ported yet.
"""

from __future__ import annotations

import csv
from typing import List, Tuple

import numpy as np


def rle_encode(mask: np.ndarray) -> str:
    """Kaggle run-length encoding of a binary mask (column-major,
    1-indexed): ``"start length start length ..."``, empty for an empty
    mask."""
    pixels = np.asarray(mask, np.uint8).flatten(order="F")
    padded = np.concatenate([[0], pixels, [0]])
    changes = np.flatnonzero(padded[1:] != padded[:-1]) + 1
    starts, ends = changes[::2], changes[1::2]
    return " ".join(f"{s} {e - s}" for s, e in zip(starts, ends))


def rle_decode(rle: str, shape: Tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`rle_encode`; an empty string gives an empty mask."""
    mask = np.zeros(shape[0] * shape[1], np.uint8)
    if rle.strip():
        nums = np.asarray(rle.split(), np.int64)
        starts, lengths = nums[::2] - 1, nums[1::2]
        for s, n in zip(starts, lengths):
            mask[s : s + n] = 1
    return mask.reshape(shape, order="F")


def write_submission(path: str, ids: List[str], masks: np.ndarray) -> None:
    """Write a Kaggle submission CSV (``id,rle_mask``) from [N, H, W, 1]
    binary masks, row ``i`` encoding ``masks[i, :, :, 0]``."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["id", "rle_mask"])
        for i, id_ in enumerate(ids):
            writer.writerow([id_, rle_encode(masks[i, :, :, 0])])
