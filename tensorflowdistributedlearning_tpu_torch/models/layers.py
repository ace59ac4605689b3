"""Shared layer library (counterpart of
``tensorflowdistributedlearning_tpu/models/layers.py``).

Layout: every activation tensor of the model is a contiguous NHWC tensor,
the JAX package's layout, so the kernels (ops/kernels.py) take it as it is.
Convolutions run on its NCHW view ``x.permute(0, 3, 1, 2)``, which is a
``torch.channels_last`` tensor: cuDNN takes it natively and returns
channels_last, whose NHWC view is contiguous again. Plain convolutions and
1x1 projections stay ``F.conv2d``, as the JAX package leaves them to XLA.

Padding follows flax's ``"SAME"`` rule exactly, including its uneven split
(low = total // 2) for stride-2 convs and the max-pool at even sizes, which
``torch``'s symmetric ``padding=`` cannot express; such pads are applied
explicitly with ``F.pad``.

Inference only in this slice: a module in training mode raises
``NotImplementedError`` (training is a later slice of the port).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowdistributedlearning_tpu_torch.ops import kernels


def scaled_width(channels: int, multiplier: float) -> int:
    """Stage width under ``ModelConfig.width_multiplier`` (>= 1 channel)."""
    return max(1, int(round(channels * multiplier)))


def same_pads(size: int, kernel_size: int, stride: int = 1, rate: int = 1) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: ``(low, high)`` with
    ``low = total // 2``."""
    effective = (kernel_size - 1) * rate + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x: torch.Tensor, ph: Tuple[int, int], pw: Tuple[int, int], value: float = 0.0) -> torch.Tensor:
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


def conv2d_same(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
    stride: int = 1, rate: int = 1,
) -> torch.Tensor:
    """``flax.linen.Conv(padding="SAME")`` on NHWC ``x`` with an OIHW
    ``weight``; returns NHWC."""
    k = weight.shape[-1]
    ph = same_pads(x.shape[1], weight.shape[-2], stride, rate)
    pw = same_pads(x.shape[2], k, stride, rate)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = _pad_nhwc(x, ph, pw)
        padding = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding, dilation=rate)
    return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """``flax.linen.max_pool(padding="SAME")`` on NHWC: pads with -inf."""
    ph = same_pads(x.shape[1], window, stride)
    pw = same_pads(x.shape[2], window, stride)
    x = _pad_nhwc(x, ph, pw, value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def fixed_padding(x: torch.Tensor, kernel_size: int, mode: str = "constant", rate: int = 1) -> torch.Tensor:
    """Explicit spatial padding independent of input size; ``x`` is NHWC.
    ``mode``: "constant" (zeros), "symmetric" (edge included) or "reflect"
    (edge skipped), as in the JAX package."""
    effective = kernel_size + (kernel_size - 1) * (rate - 1)
    pad_total = effective - 1
    pad_beg = pad_total // 2
    pad_end = pad_total - pad_beg
    if mode == "constant":
        return _pad_nhwc(x, (pad_beg, pad_end), (pad_beg, pad_end))
    if mode not in ("symmetric", "reflect"):
        raise ValueError(f"unknown padding mode {mode!r}")
    off = 0 if mode == "symmetric" else 1
    for axis in (1, 2):
        size = x.shape[axis]
        parts = []
        if pad_beg:
            parts.append(x.narrow(axis, off, pad_beg).flip(axis))
        parts.append(x)
        if pad_end:
            parts.append(x.narrow(axis, size - pad_end - off, pad_end).flip(axis))
        x = torch.cat(parts, dim=axis)
    return x


def subsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Spatial subsampling by strided slicing (NHWC)."""
    if stride == 1:
        return x
    return x[:, ::stride, ::stride, :]


def upsample(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling with symmetric edge padding: pad 1 px, resize to
    (h+4, w+4) with half-pixel centers, trim 2 px per side. For upsampling,
    ``jax.image.resize(method="bilinear")`` and
    ``F.interpolate(mode="bilinear", align_corners=False)`` sample the same
    points with the same weights (their anti-aliasing only differs when
    shrinking, which no call site does)."""
    h, w = int(out_hw[0]), int(out_hw[1])
    x = fixed_padding(x, 3, mode="symmetric")
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h + 4, w + 4), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)[:, 2:-2, 2:-2, :]


def _inference_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} in training mode: the port serves in "
            "this slice; training (batch statistics, backward kernels) is "
            "ROADMAP queue A's next slice. Call .eval() first."
        )


class BatchNorm(nn.Module):
    """Inference BatchNorm with a fused activation (and optional residual),
    through :func:`kernels.bn_act_folded`. Parameters ``weight``/``bias``
    and buffers ``running_mean``/``running_var`` mirror flax's
    ``scale``/``bias`` and ``mean``/``var``. The f32 fold into ``m, b`` is
    cached and recomputed whenever a parameter or buffer changes."""

    def __init__(self, num_features: int, eps: float = 1e-3, scale: bool = True):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(num_features)) if scale else None
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self._fold_key = None
        self._fold = None

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        tensors = [t for t in (self.weight, self.bias, self.running_mean, self.running_var) if t is not None]
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if key != self._fold_key:
            scale = self.weight if self.weight is not None else torch.ones_like(self.bias)
            with torch.no_grad():
                self._fold = kernels.fold_bn(scale, self.bias, self.running_mean, self.running_var, self.eps)
            self._fold_key = key
        return self._fold

    def forward(self, x: torch.Tensor, act: str = "relu", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        _inference_only(self)
        m, b = self.folded()
        return kernels.bn_act_folded(x.contiguous(), m, b, act, residual)


class ConvBN(nn.Module):
    """Conv2D (no bias) + BatchNorm + relu, flax SAME padding. Submodule
    names ``conv``/``bn`` match the flax tree."""

    def __init__(
        self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
        rate: int = 1, bn_epsilon: float = 1e-3, bn_scale: bool = True,
    ):
        super().__init__()
        self.stride, self.rate = stride, rate
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride=stride, dilation=rate, bias=False)
        self.bn = BatchNorm(features, bn_epsilon, bn_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same(x, self.conv.weight, None, self.stride, self.rate)
        return self.bn(y, act="relu")


class DepthwiseConv2D(nn.Module):
    """Stride-1 SAME depthwise conv + bias. ``weight`` is ``[kh, kw, C]``,
    the kernel's layout (flax's ``[kh, kw, 1, C]`` without its unit axis).
    ``use_kernel=True`` takes :func:`kernels.depthwise_conv2d` (the CUDA
    kernel on a CUDA tensor); False the grouped-conv plain version."""

    def __init__(self, channels: int, kernel_size: int = 3, rate: int = 1, use_kernel: bool = False):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"DepthwiseConv2D requires an odd kernel_size, got {kernel_size}")
        self.rate = rate
        self.use_kernel = use_kernel
        self.weight = nn.Parameter(torch.empty(kernel_size, kernel_size, channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _inference_only(self)
        dw = kernels.depthwise_conv2d if self.use_kernel else kernels.depthwise_conv2d_plain
        return dw(x.contiguous(), self.weight, self.rate) + self.bias


class SplitSeparableConv2D(nn.Module):
    """Depthwise (+ bias, relu) then pointwise 1x1 (no bias) + BN + relu;
    submodule names ``depthwise``/``pointwise``/``pointwise_bn`` match the
    flax tree."""

    def __init__(
        self, in_channels: int, features: int, kernel_size: int = 3, rate: int = 1,
        bn_epsilon: float = 1e-3, bn_scale: bool = True, use_kernel: bool = False,
    ):
        super().__init__()
        self.depthwise = DepthwiseConv2D(in_channels, kernel_size, rate, use_kernel)
        self.pointwise = nn.Conv2d(in_channels, features, 1, bias=False)
        self.pointwise_bn = BatchNorm(features, bn_epsilon, bn_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.depthwise(x))
        x = conv2d_same(x, self.pointwise.weight)
        return self.pointwise_bn(x, act="relu")
