"""Kaggle TGS-salt data-preparation helpers (counterpart of the JAX package's
``data/kaggle.py``): the notebooks' data-preparation cells as a library.
:func:`load_tgs_training_set` gives ``Trainer.train`` its ids and
stratification classes from ``train.csv`` (or the images directory) and the
masks' coverage bins; the run-length encoding of a binary mask and the
``id,rle_mask`` CSV are what the fold × TTA ensemble prediction ends in.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tensorflowdistributedlearning_tpu_torch.data.folds import coverage_to_class
from tensorflowdistributedlearning_tpu_torch.data.pipeline import discover_ids, load_masks, mask_coverage


def read_two_column_csv(path: str) -> Dict[str, str]:
    """``{first column: second column}`` of a headered CSV (``train.csv``:
    id, rle_mask; ``depths.csv``: id, z). A plain ``open``: the JAX
    package retries a failed open through its resilience layer, which the
    port brings with queue A 14."""
    out: Dict[str, str] = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        next(reader, None)  # header
        for row in reader:
            if row:
                out[row[0]] = row[1] if len(row) > 1 else ""
    return out


def load_depths(csv_path: str) -> Dict[str, float]:
    """id -> depth from ``depths.csv`` (rows without a depth are left out)."""
    return {k: float(v) for k, v in read_two_column_csv(csv_path).items() if v}


def load_tgs_training_set(
    data_dir: str, train_csv: Optional[str] = None, n_classes: int = 11
) -> Tuple[List[str], np.ndarray]:
    """``(ids, stratification classes)`` for ``Trainer.train``: the
    notebooks' X and y. Ids come from ``train_csv`` when given (sorted; an
    id without ``{data_dir}/images/{id}.png`` raises ``FileNotFoundError``),
    else from the images directory; no ids raises ``ValueError``. The
    classes are the coverage bins (``coverage_to_class``) of the decoded
    masks; only the masks are decoded here."""
    if train_csv is not None:
        ids = sorted(read_two_column_csv(train_csv))
        missing = [i for i in ids if not os.path.exists(os.path.join(data_dir, "images", f"{i}.png"))]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} ids from {train_csv} have no image under {data_dir}/images (first: {missing[0]})"
            )
    else:
        ids = discover_ids(data_dir)
    if not ids:
        raise ValueError(f"No examples found under {data_dir}/images")
    classes = coverage_to_class(mask_coverage(load_masks(data_dir, ids)), n_classes)
    return ids, classes


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
