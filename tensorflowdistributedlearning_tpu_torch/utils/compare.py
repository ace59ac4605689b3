"""Best-model comparison (counterpart of the JAX package's
``utils/compare.py``): the comparison the reference's
``metric_comparisson`` meant, the right way around."""

from __future__ import annotations

from typing import Mapping


def metric_comparison(
    best_eval_result: Mapping[str, float],
    current_eval_result: Mapping[str, float],
    key: str = "metrics/mean_iou",
    greater_is_better: bool = True,
) -> bool:
    """True iff ``current_eval_result[key]`` improves on ``best_eval_result[key]``."""
    if not best_eval_result or key not in best_eval_result:
        raise ValueError(f"best_eval_result cannot be empty and must contain {key!r}")
    if not current_eval_result or key not in current_eval_result:
        raise ValueError(f"current_eval_result cannot be empty and must contain {key!r}")
    if greater_is_better:
        return current_eval_result[key] > best_eval_result[key]
    return current_eval_result[key] < best_eval_result[key]
