"""Lovász hinge and softmax cross entropy (counterpart of
``tensorflowdistributedlearning_tpu/ops/losses.py``).

The per-image loss runs batched: one descending ``torch.sort`` per image
row (``lax.top_k`` over all pixels in the JAX package), cumulative sums along
the row, and a dot with the detached Lovász gradient. Void pixels keep the
JAX package's fixed-shape masking: their errors are set to ``-1e9`` so they
sort last, and they are weighted out of the cumulative sums, so an all-void
image has loss 0.

The sort is stable, so tied errors keep pixel order, as ``lax.top_k`` does.
Among ties the order only moves the gradient between the tied pixels, never
the loss.
"""

from __future__ import annotations

from typing import Optional

import torch

# errors of void pixels: they sort strictly last and relu() of them is 0
_VOID_ERROR = -1e9


def lovasz_grad(gt_sorted: torch.Tensor, valid_sorted: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors, along the last
    axis. ``gt_sorted``: [..., P] 0/1 ground truth ordered by descending
    error; ``valid_sorted``: optional 0/1 mask in the same order (void
    positions get delta 0)."""
    if valid_sorted is None:
        valid_sorted = torch.ones_like(gt_sorted)
    gt_sorted = gt_sorted * valid_sorted
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum((1.0 - gt_sorted) * valid_sorted, dim=-1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


def _lovasz_hinge_rows(
    logits: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Lovász hinge of each row of [N, P] logits against 0/1 labels; [N]."""
    labels = labels.to(logits.dtype)
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits * signs
    if valid is not None:
        valid = valid.to(logits.dtype)
        errors = torch.where(valid > 0, errors, torch.full_like(errors, _VOID_ERROR))
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True, stable=True)
    gt_sorted = torch.gather(labels, -1, perm)
    valid_sorted = None if valid is None else torch.gather(valid, -1, perm)
    grad = lovasz_grad(gt_sorted, valid_sorted)
    return (torch.relu(errors_sorted) * grad.detach()).sum(dim=-1)


def lovasz_hinge_flat(logits: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary Lovász hinge over a flat pixel vector: ``logits`` [P], 0/1
    ``labels`` [P], optional 0/1 ``valid`` [P]; a scalar."""
    return _lovasz_hinge_rows(
        logits[None], labels[None], None if valid is None else valid[None]
    )[0]


def lovasz_hinge_per_image(
    logits: torch.Tensor, labels: torch.Tensor, ignore: Optional[int] = None
) -> torch.Tensor:
    """Per-image Lovász hinge losses of [B, H, W] scores, shape [B]."""
    n = logits.shape[0]
    valid = None if ignore is None else (labels != ignore).reshape(n, -1)
    return _lovasz_hinge_rows(logits.reshape(n, -1), labels.reshape(n, -1), valid)


def lovasz_hinge(
    logits: torch.Tensor, labels: torch.Tensor, per_image: bool = True, ignore: Optional[int] = None
) -> torch.Tensor:
    """Binary Lovász hinge of [B, H, W] scores: the mean of the per-image
    losses (``per_image=True``) or one loss over the flattened batch."""
    if per_image:
        return lovasz_hinge_per_image(logits, labels, ignore).mean()
    valid = None if ignore is None else (labels != ignore).reshape(-1)
    return lovasz_hinge_flat(logits.reshape(-1), labels.reshape(-1), valid)


def lovasz_loss(y_true: torch.Tensor, y_pred: torch.Tensor, data_format: str = "NHWC") -> torch.Tensor:
    """Layout-aware wrapper: squeezes the channel axis of the labels and of
    the raw logits and runs the per-image hinge in float32."""
    axis = -1 if data_format == "NHWC" else 1
    labels = y_true.squeeze(axis)
    logits = y_pred.squeeze(axis)
    return lovasz_hinge(logits.float(), labels, per_image=True, ignore=None)


def sigmoid_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable mean BCE-with-logits, written as the JAX package
    writes it: ``max(x, 0) - x·z + log1p(exp(-|x|))``."""
    labels = labels.to(logits.dtype)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_cross_entropy_per_example(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Per-example softmax cross entropy of [B, K] logits against integer
    labels [B], shape [B], from a float32 ``log_softmax``. With
    ``label_smoothing`` s the target is ``(1-s)·onehot + s/K``, written as
    the JAX package writes it: ``-(1-s)·logp_true - (s/K)·sum(logp)``
    (``F.cross_entropy(label_smoothing=s)`` is the same quantity summed in
    another order)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    true_logp = torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if label_smoothing:
        k = logits.shape[-1]
        return -(1.0 - label_smoothing) * true_logp - (label_smoothing / k) * logp.sum(dim=-1)
    return -true_logp


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean of :func:`softmax_cross_entropy_per_example`."""
    return softmax_cross_entropy_per_example(logits, labels, label_smoothing).mean()
