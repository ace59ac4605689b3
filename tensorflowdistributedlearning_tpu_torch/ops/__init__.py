"""Losses and metrics of the port (counterpart of the JAX package's
``ops``), under its exported names; the kernels' wrappers live in
``ops.kernels``, ``ops.flash_attention`` and ``ops.quant_kernels``."""

from tensorflowdistributedlearning_tpu_torch.ops.losses import (
    lovasz_grad,
    lovasz_hinge,
    lovasz_hinge_flat,
    lovasz_loss,
    sigmoid_cross_entropy,
    softmax_cross_entropy,
)
from tensorflowdistributedlearning_tpu_torch.ops.metrics import (
    IOU_THRESHOLDS,
    Mean,
    iou_scores,
    mean_accuracy_scores,
    miou,
    mean_accuracy,
)

__all__ = [
    "lovasz_grad",
    "lovasz_hinge",
    "lovasz_hinge_flat",
    "lovasz_loss",
    "sigmoid_cross_entropy",
    "softmax_cross_entropy",
    "IOU_THRESHOLDS",
    "Mean",
    "iou_scores",
    "mean_accuracy_scores",
    "miou",
    "mean_accuracy",
]
