"""Task heads (counterpart of the JAX package's ``train/step.py``). This slice
carries the segmentation task's prediction heads; losses, metrics and the
train/eval steps arrive with the training slice."""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from tensorflowdistributedlearning_tpu_torch.ops import kernels


@dataclasses.dataclass(frozen=True)
class SegmentationTask:
    """Binary segmentation: per-pixel sigmoid probabilities and the mask
    thresholded at ``threshold``."""

    threshold: float = 0.5

    def predictions(self, logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The unfused head: ``sigmoid``, then ``probs > threshold``."""
        probs = torch.sigmoid(logits)
        return {"probabilities": probs, "mask": (probs > self.threshold).float()}

    def serve_predictions(self, logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The serving head: the same outputs as :meth:`predictions`, from one
        pass over the logits through :func:`kernels.fused_sigmoid_mask`
        (bit-identical by contract)."""
        probs, mask = kernels.fused_sigmoid_mask(logits, self.threshold)
        return {"probabilities": probs, "mask": mask}
