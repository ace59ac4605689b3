"""Stratified K-fold management with index manifests (counterpart of
``tensorflowdistributedlearning_tpu/data/folds.py``, which is pure numpy:
this is the same algorithm, so the port writes the same ``folds.json`` as
the JAX package for the same ids, classes and seed).

Folds are plain index manifests written once as JSON (the reference used
symlink trees). Stratification matches the reference training script: per-image mask
coverage binned into 11 classes (``cov_to_class``) fed to a stratified
K-fold split.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def coverage_to_class(coverage: np.ndarray, n_classes: int = 11) -> np.ndarray:
    """Bin mask coverage fractions in [0, 1] into ``n_classes`` stratification classes
    (the notebooks' ``cov_to_class``: ceil(coverage * 10) → 0..10)."""
    coverage = np.asarray(coverage, np.float64)
    return np.ceil(coverage * (n_classes - 1)).astype(np.int64)


def stratified_kfold(
    y: Sequence[int], n_splits: int, seed: int, shuffle: bool = True
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Stratified K-fold over class labels ``y``; returns [(train_idx, eval_idx)] per
    fold (the reference delegated to sklearn's StratifiedKFold, model.py:134-136).

    Pure-numpy round-robin-within-class assignment: samples of each class are shuffled
    and dealt to folds as evenly as possible, so every fold's class histogram differs
    from the global one by at most one sample per class — the StratifiedKFold contract.
    """
    y = np.asarray(y)
    if n_splits < 2:
        raise ValueError(f"n_splits must be >= 2, got {n_splits}")
    rng = np.random.default_rng(seed)
    fold_of = np.empty(len(y), np.int64)
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        if shuffle:
            idx = rng.permutation(idx)
        fold_of[idx] = np.arange(len(idx)) % n_splits
    return [
        (np.flatnonzero(fold_of != f), np.flatnonzero(fold_of == f))
        for f in range(n_splits)
    ]


def build_fold_manifests(
    ids: Sequence[str], y: Sequence[int], n_splits: int, seed: int
) -> List[Dict[str, List[str]]]:
    """Per-fold {"train": [...ids], "eval": [...ids]} manifests."""
    ids = list(ids)
    return [
        {
            "train": [ids[i] for i in train_idx],
            "eval": [ids[i] for i in eval_idx],
        }
        for train_idx, eval_idx in stratified_kfold(y, n_splits, seed)
    ]


def write_fold_manifests(
    model_dir: str,
    ids: Sequence[str],
    y: Sequence[int],
    n_splits: int,
    seed: int,
) -> List[Dict[str, List[str]]]:
    """Write ``{model_dir}/folds.json`` once; re-running reuses the existing split —
    the idempotency the reference got from its symlink-exists check (reference:
    preprocessing/preprocessing.py:80-88)."""
    path = os.path.join(model_dir, "folds.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    manifests = build_fold_manifests(ids, y, n_splits, seed)
    os.makedirs(model_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(manifests, f)
    return manifests


def read_fold_manifests(model_dir: str) -> List[Dict[str, List[str]]]:
    with open(os.path.join(model_dir, "folds.json")) as f:
        return json.load(f)
