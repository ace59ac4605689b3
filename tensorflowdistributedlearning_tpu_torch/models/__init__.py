"""Model factory (counterpart of ``tensorflowdistributedlearning_tpu/models``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, require_supported
from tensorflowdistributedlearning_tpu_torch.models.layers import (
    BatchNorm,
    ConvBN,
    DepthwiseConv2D,
    SplitSeparableConv2D,
    fixed_padding,
    subsample,
    upsample,
)
from tensorflowdistributedlearning_tpu_torch.models.resnet import (
    ResNetBackbone,
    ResNetSegmentation,
)
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike, resolve_device

# flax's truncated_normal initializers cut at +-2 stddev; variance_scaling's
# truncated form divides by the stddev of that truncated unit normal
_TRUNC_STD = 0.87962566103423978


def _trunc_normal(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initializers, drawn from ``generator``: convs He
    (variance_scaling(2.0, fan_in, truncated_normal)), depthwise kernels
    truncated normal 0.33, pointwise 0.06, biases zero, BN scale one /
    bias zero, running statistics mean 0 / var 1."""
    pointwise = {id(m.pointwise) for m in model.modules() if isinstance(m, SplitSeparableConv2D)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                if id(m) in pointwise:
                    _trunc_normal(m.weight, 0.06, generator)
                else:
                    fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                    _trunc_normal(m.weight, math.sqrt(2.0 / fan_in) / _TRUNC_STD, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, DepthwiseConv2D):
                _trunc_normal(m.weight, 0.33, generator)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                if m.weight is not None:
                    m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


def build_model(
    config: ModelConfig, device: DeviceLike = None, *, generator: Optional[torch.Generator] = None
) -> nn.Module:
    """The segmentation network for ``config``, initialised from
    ``generator`` (seed 0 when None), in eval mode on ``device`` (CUDA when
    None; raises without it)."""
    device = resolve_device(device)
    require_supported(config)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_weights(ResNetSegmentation(config), generator)
    return model.to(device).eval()


__all__ = [
    "ConvBN",
    "ResNetBackbone",
    "ResNetSegmentation",
    "SplitSeparableConv2D",
    "build_model",
    "fixed_padding",
    "init_weights",
    "subsample",
    "upsample",
]
