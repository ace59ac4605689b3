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

Training mode follows flax: BatchNorm normalises with the batch mean and
the biased batch variance and moves its running statistics by the decay;
eval mode folds the running statistics into the fused BN+act kernel.

Dtypes follow flax's promotion with the model's ``dtype=float32``: every
conv, depthwise conv and BN computes in float32 whatever its input's dtype,
except that a BatchNorm whose parameters are bfloat16 (the quantized
serving specs, ``train/quantize.py``) computes as flax does in the promoted
dtype of its input and its bf16 statistics (bf16 for a bf16 input) and
returns float32. Convolutions are called through their modules, so the
int8-compute serving path can swap a module (``ops/quant_kernels.py``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tensorflowdistributedlearning_tpu_torch.parallel import collectives


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


class Conv2dSame(nn.Conv2d):
    """``flax.linen.Conv(padding="SAME", dtype=float32)`` on NHWC input: the
    input is promoted to float32 (a bf16 input from an int8-compute layer),
    then :func:`conv2d_same`. Parameters as ``nn.Conv2d``'s (OIHW)."""

    same_padding = "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x.float(), self.weight, self.bias, self.stride[0], self.dilation[0])


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` with a fused activation (and optional residual).
    Parameters ``weight``/``bias`` and buffers ``running_mean``/
    ``running_var`` mirror flax's ``scale``/``bias`` and ``mean``/``var``.

    Training mode (:meth:`train`): flax's statistics exactly — the batch mean
    and ``max(E[x²] − E[x]², 0)`` (the biased variance, flax's fast form)
    over (B, H, W) in f32, ``y = (x − mean) · (rsqrt(var + eps) · scale) +
    bias``, and ``running = decay · running + (1 − decay) · batch`` with the
    biased variance (``F.batch_norm`` would store the unbiased one). Plain
    differentiable ops; the activation follows. With ``sync`` and a process
    group the statistics span the global batch, as flax's BN with an
    ``axis_name``: the per-rank ``[E[x], E[x²]]`` go through the
    differentiable :func:`collectives.pmean` before the variance is formed.

    Eval mode: through :func:`kernels.bn_act_folded` (an input that is not
    float32 is promoted first); the f32 fold into ``m, b`` is cached and
    recomputed whenever a parameter or buffer changes. With bfloat16
    parameters and statistics (the quantized serving specs) it is flax's
    unfolded form instead (:func:`kernels.bn_act_unfolded`, float32 out)."""

    def __init__(
        self, num_features: int, eps: float = 1e-3, scale: bool = True, decay: float = 0.99, sync: bool = False
    ):
        super().__init__()
        self.eps = float(eps)
        self.decay = float(decay)
        self.sync = sync
        self.weight = nn.Parameter(torch.ones(num_features)) if scale else None
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self._fold_key = None
        self._fold = None

    @property
    def bf16_params(self) -> bool:
        return self.running_var.dtype == torch.bfloat16

    def _cached(self, kind: str, compute):
        tensors = [t for t in (self.weight, self.bias, self.running_mean, self.running_var) if t is not None]
        key = (kind,) + tuple((t.data_ptr(), t._version) for t in tensors)
        if key != self._fold_key:
            with torch.no_grad():
                self._fold = compute()
            self._fold_key = key
        return self._fold

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The f32 fold ``(m, b)`` of float32 parameters."""
        scale = self.weight if self.weight is not None else torch.ones_like(self.bias)
        return self._cached(
            "folded", lambda: kernels.fold_bn(scale, self.bias, self.running_mean, self.running_var, self.eps)
        )

    def unfolded(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """flax's ``(mean, mul, bias)`` of bfloat16 parameters
        (:func:`kernels.unfold_bn_bf16`)."""
        return self._cached(
            "unfolded",
            lambda: kernels.unfold_bn_bf16(self.weight, self.bias, self.running_mean, self.running_var, self.eps),
        )

    def _moments(self, xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``E[x], E[x²]`` over (B, H, W) of the float32 input, over the
        global batch under ``sync``."""
        mean = xf.mean(dim=(0, 1, 2))
        mean_sq = (xf * xf).mean(dim=(0, 1, 2))
        if self.sync and collectives.is_initialized():
            mean, mean_sq = collectives.pmean(torch.stack([mean, mean_sq]))
        return mean, mean_sq

    def _batch_normalize(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean, mean_sq = self._moments(xf)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(self.decay * self.running_mean + (1.0 - self.decay) * mean)
            self.running_var.copy_(self.decay * self.running_var + (1.0 - self.decay) * var)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        return (xf - mean) * mul + self.bias

    def forward(self, x: torch.Tensor, act: str = "relu", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            y = self._batch_normalize(x)
            if residual is not None:
                y = y + residual
            return kernels.activate(y, act)
        if self.bf16_params:
            if residual is not None:
                raise NotImplementedError("BatchNorm with bfloat16 parameters takes no residual")
            mean, mul, bias = self.unfolded()
            return kernels.bn_act_unfolded(x.contiguous(), mean, mul, bias, act)
        m, b = self.folded()
        return kernels.bn_act_folded(x.float().contiguous(), m, b, act, residual)


@contextlib.contextmanager
def split_moments(world: int) -> Iterator[None]:
    """For the duration, training-mode BatchNorm forms ``[E[x], E[x²]]`` as
    synchronized BN over ``world`` ranks forms them from its batch's
    ``world`` contiguous row blocks (the rows :func:`mesh.shard_rows` gives
    each rank): the mean of the blocks' moments. Everything after the
    moments is :meth:`BatchNorm._batch_normalize`'s. One process then
    computes the statistics of a data-parallel step on the whole batch,
    which is what the data-parallel step is held against in its tests."""
    plain = BatchNorm._moments

    def moments(self, xf):
        blocks = xf.chunk(world)
        stacked = sum(torch.stack([b.mean(dim=(0, 1, 2)), (b * b).mean(dim=(0, 1, 2))]) for b in blocks) / world
        return stacked[0], stacked[1]

    BatchNorm._moments = moments
    try:
        yield
    finally:
        BatchNorm._moments = plain


class ConvBN(nn.Module):
    """Conv2D (no bias) + BatchNorm + relu, flax SAME padding. Submodule
    names ``conv``/``bn`` match the flax tree."""

    def __init__(
        self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
        rate: int = 1, bn_epsilon: float = 1e-3, bn_scale: bool = True, bn_decay: float = 0.99,
    ):
        super().__init__()
        self.stride, self.rate = stride, rate
        self.conv = Conv2dSame(in_channels, features, kernel_size, stride=stride, dilation=rate, bias=False)
        self.bn = BatchNorm(features, bn_epsilon, bn_scale, bn_decay)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), act="relu")


class DepthwiseConv2D(nn.Module):
    """Stride-1 SAME depthwise conv + bias. ``weight`` is ``[kh, kw, C]``,
    the kernel's layout (flax's ``[kh, kw, 1, C]`` without its unit axis).
    ``use_kernel=True`` takes :func:`kernels.depthwise_conv2d` (the CUDA
    kernels, forward and backward, on a CUDA tensor); False the grouped-conv
    plain version."""

    def __init__(self, channels: int, kernel_size: int = 3, rate: int = 1, use_kernel: bool = False):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"DepthwiseConv2D requires an odd kernel_size, got {kernel_size}")
        self.rate = rate
        self.use_kernel = use_kernel
        self.weight = nn.Parameter(torch.empty(kernel_size, kernel_size, channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw = kernels.depthwise_conv2d if self.use_kernel else kernels.depthwise_conv2d_plain
        return dw(x.float().contiguous(), self.weight, self.rate) + self.bias


class SplitSeparableConv2D(nn.Module):
    """Depthwise (+ bias, relu) then pointwise 1x1 (no bias) + BN + relu;
    submodule names ``depthwise``/``pointwise``/``pointwise_bn`` match the
    flax tree."""

    def __init__(
        self, in_channels: int, features: int, kernel_size: int = 3, rate: int = 1,
        bn_epsilon: float = 1e-3, bn_scale: bool = True, use_kernel: bool = False, bn_decay: float = 0.99,
    ):
        super().__init__()
        self.depthwise = DepthwiseConv2D(in_channels, kernel_size, rate, use_kernel)
        self.pointwise = Conv2dSame(in_channels, features, 1, bias=False)
        self.pointwise_bn = BatchNorm(features, bn_epsilon, bn_scale, bn_decay)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.depthwise(x))
        return self.pointwise_bn(self.pointwise(x), act="relu")
