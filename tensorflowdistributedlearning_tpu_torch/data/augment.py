"""Serving-side preprocessing (counterpart of the JAX package's
``data/augment.py:normalize``, ``laplacian`` and ``add_laplace_channel``).
The training augmentations arrive with the training slice. Tensors are
NHWC, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# TGS Salt dataset intensity statistics (the JAX package's MEAN/STD)
MEAN = 0.47194585
STD = 0.16105755

# the isotropic 3x3 Laplacian stencil of the JAX package
_LAPLACE_KERNEL = (
    (0.5, 1.0, 0.5),
    (1.0, -6.0, 1.0),
    (0.5, 1.0, 0.5),
)


def normalize(image: torch.Tensor) -> torch.Tensor:
    """(x - MEAN) / STD."""
    return (image - MEAN) / STD


def laplacian(images: torch.Tensor) -> torch.Tensor:
    """Per-channel 3x3 Laplacian of a [B, H, W, C] batch, SAME zero padding."""
    c = images.shape[-1]
    kernel = torch.tensor(_LAPLACE_KERNEL, dtype=images.dtype, device=images.device)
    kernel = kernel.repeat(c, 1, 1, 1)  # [C, 1, 3, 3], one filter per channel
    out = F.conv2d(images.permute(0, 3, 1, 2), kernel, padding=1, groups=c)
    return out.permute(0, 2, 3, 1)


def add_laplace_channel(images: torch.Tensor) -> torch.Tensor:
    """Concatenate the Laplacian as extra channels: [B,H,W,C] -> [B,H,W,2C]."""
    return torch.cat([images, laplacian(images)], dim=-1)
