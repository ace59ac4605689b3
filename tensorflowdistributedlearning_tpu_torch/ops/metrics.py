"""Streaming metrics (counterpart of
``tensorflowdistributedlearning_tpu/ops/metrics.py``).

``Mean`` is the explicit (total, count) streaming state; its tensors stay on
the device they were computed on, so a train loop accumulates without a host
sync and fetches once. Semantics as in the JAX package: per-image IoU from
the binary confusion counts with the empty-mask rule (TP+FP+FN == 0 scores
1.0), the reference's nonstandard ``mean(score * (score > t))`` threshold
form over 0.50..0.95 (SURVEY §2.4.14), and per-image pixel accuracy. The
classifier's per-example top-1 and top-k hits.

Ties among the logits: ``jax.lax.top_k`` keeps the lower index first;
``torch.topk`` on the CPU and CUDA does not promise an order among equal
values, and ``torch.argmax`` and ``jnp.argmax`` both take the first index.
So top-1 agrees with the JAX package on every input, top-k on logits whose
k-th and (k+1)-th values differ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

IOU_THRESHOLDS = (0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95)


@dataclasses.dataclass(frozen=True)
class Mean:
    """Functional streaming mean: ``update`` and ``merge`` return new
    states; ``compute`` is ``total / max(count, 1)``."""

    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def empty(cls, device=None) -> "Mean":
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return cls(total=zero, count=zero.clone())

    def update(self, values: torch.Tensor, weights: Optional[torch.Tensor] = None) -> "Mean":
        """Add ``values``; optional per-value ``weights`` (0 excludes a value,
        e.g. the wrap-around padding of the last eval batch)."""
        values = values.float()
        if weights is None:
            return Mean(self.total + values.sum(), self.count + values.numel())
        weights = torch.broadcast_to(weights.float(), values.shape)
        return Mean(self.total + (values * weights).sum(), self.count + weights.sum())

    def merge(self, other: "Mean") -> "Mean":
        return Mean(self.total + other.total, self.count + other.count)

    def compute(self) -> torch.Tensor:
        return self.total / torch.clamp(self.count, min=1.0)


def _flatten_per_image(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def iou_scores(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-image thresholded IoU scores of binary masks [B, ...], shape [B]."""
    t = _flatten_per_image(y_true).float()
    p = _flatten_per_image(y_pred).float()
    tp = (t * p).sum(dim=1)
    fp = ((1.0 - t) * p).sum(dim=1)
    fn = (t * (1.0 - p)).sum(dim=1)
    denominator = tp + fp + fn
    score = torch.where(denominator > 0, tp / torch.clamp(denominator, min=1e-12), torch.ones_like(tp))
    thresholds = torch.tensor(IOU_THRESHOLDS, dtype=torch.float32, device=score.device)
    return torch.mean(score[:, None] * (score[:, None] > thresholds[None, :]).float(), dim=1)


def mean_accuracy_scores(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-image pixel accuracy, shape [B]."""
    t = _flatten_per_image(y_true)
    p = _flatten_per_image(y_pred)
    return torch.mean((t == p).float(), dim=1)


def miou(y_true: torch.Tensor, y_pred: torch.Tensor, state: Optional[Mean] = None) -> Tuple[torch.Tensor, Mean]:
    """Streaming thresholded mIoU: ``(value, new_state)``."""
    state = Mean.empty(y_true.device) if state is None else state
    new_state = state.update(iou_scores(y_true, y_pred))
    return new_state.compute(), new_state


def mean_accuracy(
    y_true: torch.Tensor, y_pred: torch.Tensor, state: Optional[Mean] = None
) -> Tuple[torch.Tensor, Mean]:
    """Streaming pixel accuracy: ``(value, new_state)``."""
    state = Mean.empty(y_true.device) if state is None else state
    new_state = state.update(mean_accuracy_scores(y_true, y_pred))
    return new_state.compute(), new_state


def top1_accuracy_scores(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example top-1 hits, shape [B] float32."""
    return (torch.argmax(logits, dim=-1) == labels.long()).float()


def topk_accuracy_scores(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Per-example top-k hits, shape [B] float32; top-1 when ``k`` is at
    least the class count (every class in the top set would score a
    constant 1)."""
    if k >= logits.shape[-1]:
        return top1_accuracy_scores(logits, labels)
    top = torch.topk(logits, k, dim=-1).indices
    return (top == labels.long()[:, None]).any(dim=-1).float()
