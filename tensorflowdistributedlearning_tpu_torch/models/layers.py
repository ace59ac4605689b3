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

Dtypes follow flax's layers under the model's ``ModelConfig.dtype``, which
each layer holds as its ``compute_dtype`` (float32 parameters either way):

- float32: every conv, depthwise conv and BN computes in float32 whatever
  its input's dtype (a bf16 input from an int8-compute layer is promoted);
- bfloat16: a conv casts its input and filter to bf16 and returns bf16,
  its bias added in bf16 after the product (flax's ``nn.Conv(dtype=bf16)``:
  two roundings); a depthwise conv computes in float32 from bf16 inputs
  and rounds once (the kernel's rule), its bias added in bf16; BatchNorm
  takes its statistics and normalises in float32 and returns bf16
  (``nn.BatchNorm(dtype=bf16)`` with float32 parameters), in eval mode
  through the bf16-activation arm of :func:`kernels.bn_act_folded`.

Each cast of a parameter is a differentiable ``Tensor.to``, so float32
parameters receive float32 gradients of the bf16 computation, as flax's
promotion does under ``jax.grad``. A BatchNorm whose parameters are
bfloat16 (the quantized serving specs, ``train/quantize.py``) computes as
flax does in the promoted dtype of its input and its bf16 statistics (bf16
for a bf16 input), returned in the compute dtype. Convolutions are called
through their modules, so the int8-compute serving path can swap a module
(``ops/quant_kernels.py``).

Stochastic layers (Xception-41's pre-logits dropout) own no random state:
a training-mode draw takes its generator from :func:`dropout_key`, which
the train step sets for each forward from (seed, step, data index,
accumulation chunk), as the JAX step folds those into its ``dropout`` PRNG
key.

Tensor parallelism (``parallel/tensor.py``): a layer whose ``tp`` is set
holds this rank's channel slices of its parameters and runs through
``tp.column`` (convs, ``ConvBN``, Dense, the pointwise half of
:class:`SplitSeparableConv2D`) or ``tp.channelwise`` (BatchNorm, the
depthwise conv); its input and output are whole. A layer with ``tp``
None computes on whatever parameters it holds, so the members of a
tensor-parallel ``ConvBN`` compute this rank's channels.

Sequence parallelism (``parallel/spatial.py``): a layer whose ``spatial``
is set runs on this rank's block of the rows. A :class:`Conv2dSame` with
a kernel above 1x1 then runs through the halo exchange with the same
parameters (the JAX package's ``SpatialConv``, whose "param tree is
identical to nn.Conv"), and a :class:`BatchNorm` takes its statistics
over the sequence group (over every rank under ``sync``), as the JAX package's
``bn_axis_name`` of ``SEQUENCE_AXIS`` (or ``(BATCH, SEQUENCE)``) does.
``models.set_spatial`` marks a model's H-sharded layers.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils import checkpoint as checkpoint_lib

from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh
from tensorflowdistributedlearning_tpu_torch.parallel import spatial as spatial_lib


# the key of the forward in progress: {"seed": int, device: its generator}
_DROPOUT_KEY: contextvars.ContextVar[Optional[Dict]] = contextvars.ContextVar("dropout_key", default=None)


@contextlib.contextmanager
def dropout_key(seed: int) -> Iterator[None]:
    """For the duration, training-mode dropout draws from one stream seeded
    with ``seed`` (a generator per device, made at the first draw there;
    later draws continue it)."""
    token = _DROPOUT_KEY.set({"seed": int(seed)})
    try:
        yield
    finally:
        _DROPOUT_KEY.reset(token)


def dropout_generator(device: torch.device) -> torch.Generator:
    """The generator of the :func:`dropout_key` in force on ``device``;
    raises without one (a module keeps no stream of its own)."""
    key = _DROPOUT_KEY.get()
    if key is None:
        raise RuntimeError(
            "a training-mode dropout draw needs a key: run the forward under models.layers.dropout_key(seed) "
            "(the train step keys it by seed, step, data index and accumulation chunk)"
        )
    device = torch.device(device)
    if device not in key:
        key[device] = torch.Generator(device=device).manual_seed(key["seed"])
    return key[device]


def scaled_width(channels: int, multiplier: float) -> int:
    """Stage width under ``ModelConfig.width_multiplier`` (>= 1 channel)."""
    return max(1, int(round(channels * multiplier)))


def compute_dtype_of(config) -> torch.dtype:
    """The compute dtype of a ``ModelConfig``: bf16 under
    ``dtype="bfloat16"``, float32 otherwise."""
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def promote_dtype(x: torch.Tensor, dtype) -> torch.dtype:
    """flax's ``promote_dtype``: the given dtype, or (None) the result type
    of the input and the float32 parameters."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


class Dense(nn.Linear):
    """flax ``nn.Dense`` with ``dtype``: ``weight`` [out, in] (flax's
    ``kernel`` transposed), product then bias add in the compute dtype."""

    tp = None

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp.column(self._forward, x) if self.tp is not None else self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = promote_dtype(x, self.dtype)
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y + self.bias.to(dt)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/block, W/block, block*block*C], channel order
    (dy, dx, c), as the JAX package's ``space_to_depth``."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth needs H, W divisible by {block}, got {h}x{w}")
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block, block * block * c)


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
    stride: int = 1, rate: int = 1, groups: int = 1,
) -> torch.Tensor:
    """``flax.linen.Conv(padding="SAME", feature_group_count=groups)`` on
    NHWC ``x`` with an OIHW ``weight``; returns NHWC."""
    k = weight.shape[-1]
    ph = same_pads(x.shape[1], weight.shape[-2], stride, rate)
    pw = same_pads(x.shape[2], k, stride, rate)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        x = _pad_nhwc(x, ph, pw)
        padding = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding, dilation=rate, groups=groups)
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


def _bilinear_weights(m: int, n: int, device=None) -> torch.Tensor:
    """[m, n] float32: the weight of input row i in output row j when
    ``jax.image.resize(method="bilinear")`` scales m rows to n (n >= m),
    computed as its ``compute_weight_mat`` computes it, op by op in float32
    (half-pixel centres, the triangle kernel, each column normalised by its
    sum, columns that sample outside the input zeroed)."""
    f32 = torch.float32
    inv = torch.tensor(1.0 / (n / m), dtype=f32, device=device)
    sample = (torch.arange(n, dtype=f32, device=device) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(m, dtype=f32, device=device)[:, None]).abs()
    weights = torch.clamp(1 - dist, min=0)
    total = weights.sum(dim=0, keepdim=True)
    eps = float(torch.finfo(f32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps, weights / torch.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], weights, 0)


def _resize_bf16(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, method="bilinear")`` of an NHWC tensor of bf16
    values (held as bf16 or float32) as JAX computes it for bf16: the
    weights rounded to bf16, one axis contracted, then the other, each
    product sum rounded to bf16. ``jnp.einsum`` contracts first the axis
    whose order costs fewer multiply-adds (the rows on a tie). Each output
    sums at most two nonzero products of bf16 values, exact in float32, so
    the float32 contractions round once, as a bf16 dot with float32
    accumulation does. Returns bf16."""
    _, h, w, _ = x.shape
    wh = _bilinear_weights(h, out_h, x.device).to(torch.bfloat16).float()
    ww = _bilinear_weights(w, out_w, x.device).to(torch.bfloat16).float()
    x = x.float()
    if h * w * out_h + out_h * w * out_w <= h * w * out_w + h * out_w * out_h:
        y = torch.einsum("nhwc,hk->nkwc", x, wh).to(torch.bfloat16)
        return torch.einsum("nkwc,wl->nklc", y.float(), ww).to(torch.bfloat16)
    y = torch.einsum("nhwc,wl->nhlc", x, ww).to(torch.bfloat16)
    return torch.einsum("nhlc,hk->nklc", y.float(), wh).to(torch.bfloat16)


def upsample(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling with symmetric edge padding: pad 1 px, resize to
    (h+4, w+4) with half-pixel centers, trim 2 px per side, in ``x``'s
    dtype. For upsampling a float32 tensor,
    ``jax.image.resize(method="bilinear")`` and
    ``F.interpolate(mode="bilinear", align_corners=False)`` sample the same
    points with the same weights (their anti-aliasing only differs when
    shrinking, which no call site does). A bf16 tensor is resized as JAX
    resizes it, in bf16 (:func:`_resize_bf16`, bit for bit JAX's forward);
    its float32 copy is padded (the same values), so the padding's
    backward sums the reflected rows' gradients in float32."""
    h, w = int(out_hw[0]), int(out_hw[1])
    if x.dtype == torch.bfloat16:
        return _resize_bf16(fixed_padding(x.float(), 3, mode="symmetric"), h + 4, w + 4)[:, 2:-2, 2:-2, :]
    x = fixed_padding(x, 3, mode="symmetric")
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h + 4, w + 4), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)[:, 2:-2, 2:-2, :]


class Conv2dSame(nn.Conv2d):
    """``flax.linen.Conv(padding="SAME", dtype=compute_dtype)`` on NHWC
    input. float32: the input is promoted (a bf16 input from an
    int8-compute layer), then :func:`conv2d_same`; bf16: input and filter
    cast to bf16, the product rounded, then the bias added in bf16.
    Parameters as ``nn.Conv2d``'s (OIHW)."""

    same_padding = "SAME"
    tp = None
    # H-sharded over the sequence group (``models.set_spatial``)
    spatial = False

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp.column(self._forward, x) if self.tp is not None else self._forward(x)

    def _spatial_forward(self, x: torch.Tensor, phase: str) -> torch.Tensor:
        """:func:`spatial_lib.spatial_conv2d` of this rank's block in the
        compute dtype, then the bias added in it (the JAX ``SpatialConv``)."""
        dt = self.compute_dtype
        y = spatial_lib.spatial_conv2d(
            x.float() if dt == torch.float32 else x.to(dt), self.weight.to(dt), stride=self.stride[0],
            rate=self.dilation[0], groups=self.groups, phase=phase,
        )
        return y if self.bias is None else y + self.bias.to(dt)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.spatial and self.kernel_size[0] > 1:
            return self._spatial_forward(x, "same")
        if dt == torch.float32:
            return conv2d_same(x.float(), self.weight, self.bias, self.stride[0], self.dilation[0], self.groups)
        y = conv2d_same(x.to(dt), self.weight.to(dt), None, self.stride[0], self.dilation[0], self.groups)
        return y if self.bias is None else y + self.bias.to(dt)


class SpaceToDepthConv(nn.Conv2d):
    """The JAX package's ``SpaceToDepthConv``: a 3x3 stride-2 SAME conv
    computed as a 2x2 stride-1 conv on :func:`space_to_depth` (2) of its
    input, the same function with a 4x deeper contraction. The parameter is
    the canonical 3x3 filter (``weight`` [F, C, 3, 3], flax's ``conv/
    kernel`` [3, 3, C, F]), transformed at every call: padded to 4x4 at the
    high edge, each side split as (block, offset) and the offsets folded
    into the contraction in ``space_to_depth``'s (dy, dx, c) order; the 2x2
    conv pads (0, 1). Needs even input sides. No bias."""

    def __init__(self, in_channels: int, features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, features, 3, stride=2, bias=False)
        self.compute_dtype = compute_dtype

    def folded_weight(self) -> torch.Tensor:
        """The 2x2 filter over ``4 * C`` channels, OIHW (of the filters
        this module holds: a tensor-parallel rank's slice of them)."""
        f, c = self.weight.shape[:2]
        k44 = F.pad(self.weight.permute(2, 3, 1, 0), (0, 0, 0, 0, 0, 1, 0, 1))  # HWIO, high edge
        k2 = k44.reshape(2, 2, 2, 2, c, f).permute(0, 2, 1, 3, 4, 5).reshape(2, 2, 4 * c, f)
        return k2.permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = _pad_nhwc(space_to_depth(x.to(dt), 2), (0, 1), (0, 1))
        return F.conv2d(y.permute(0, 3, 1, 2), self.folded_weight().to(dt)).permute(0, 2, 3, 1)


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

    Eval mode: through :func:`kernels.bn_act_folded` on the input in the
    compute dtype (float32: promoted; bf16: the kernel's bf16-activation
    arm); the f32 fold into ``m, b`` is cached and recomputed whenever a
    parameter or buffer changes. With bfloat16 parameters and statistics
    (the quantized serving specs) it is flax's unfolded form instead
    (:func:`kernels.bn_act_unfolded`). Either mode returns
    ``compute_dtype``: the float32 result rounded once in bf16 compute.

    ``sync`` reduces over the data group of ``parallel/mesh.py`` (the
    default group without tensor parallelism); ``tp`` runs the layer on
    this rank's channels (statistics, running statistics and, in eval
    mode, the fused kernel all on the slice)."""

    tp = None
    # statistics over the sequence group (models.set_spatial)
    spatial = False

    def __init__(
        self, num_features: int, eps: float = 1e-3, scale: bool = True, decay: float = 0.99, sync: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.eps = float(eps)
        self.decay = float(decay)
        self.sync = sync
        self.compute_dtype = compute_dtype
        # set while a rematerialized unit is recomputed (remat_call): batch
        # statistics as in training, running ones kept
        self.frozen_stats = False
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
        global batch under ``sync``; a ``spatial`` layer's over the
        sequence group's row blocks (equal blocks: the mean of their
        moments), under ``sync`` over every rank."""
        mean = xf.mean(dim=(0, 1, 2))
        mean_sq = (xf * xf).mean(dim=(0, 1, 2))
        if (self.sync or self.spatial) and collectives.is_initialized():
            if self.spatial:
                group = mesh.layout().world_group if self.sync else mesh.sequence_group()
            else:
                group = mesh.data_group()
            mean, mean_sq = collectives.pmean(torch.stack([mean, mean_sq]), group)
        return mean, mean_sq

    def _batch_normalize(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean, mean_sq = self._moments(xf)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        if not self.frozen_stats:
            self._update_running(mean, var)
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        return (xf - mean) * mul + self.bias

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.copy_(self.decay * self.running_mean + (1.0 - self.decay) * mean)
            self.running_var.copy_(self.decay * self.running_var + (1.0 - self.decay) * var)

    def forward(self, x: torch.Tensor, act: str = "relu", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.channelwise(lambda xs, rs: self._forward(xs, act, rs), x, residual)
        return self._forward(x, act, residual)

    def _forward(self, x: torch.Tensor, act: str, residual: Optional[torch.Tensor]) -> torch.Tensor:
        dt = self.compute_dtype
        if self.training:
            y = self._batch_normalize(x)
            if residual is not None:
                y = y + residual
            return kernels.activate(y, act).to(dt)
        if self.bf16_params:
            if residual is not None:
                raise NotImplementedError("BatchNorm with bfloat16 parameters takes no residual")
            mean, mul, bias = self.unfolded()
            return kernels.bn_act_unfolded(x.contiguous(), mean, mul, bias, act).to(dt)
        m, b = self.folded()
        r = None if residual is None else residual.to(dt).contiguous()
        return kernels.bn_act_folded(x.to(dt).contiguous(), m, b, act, r)


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


@contextlib.contextmanager
def synced_batch_norm(module: nn.Module, on: bool = True) -> Iterator[None]:
    """For the duration (when ``on``), the BatchNorms under ``module`` take
    their training statistics over the data group, as ``sync`` does."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm) and not m.sync] if on else []
    for m in bns:
        m.sync = True
    try:
        yield
    finally:
        for m in bns:
            m.sync = False


@contextlib.contextmanager
def _running_stats_frozen(module: nn.Module) -> Iterator[None]:
    """For the duration, the BatchNorms under ``module`` normalise with
    their batch statistics as in training but leave the running statistics
    alone: the recompute of a rematerialized unit."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.frozen_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen_stats = False


def remat_call(unit: nn.Module, x: torch.Tensor, remat: bool):
    """``unit(x)``; with ``remat`` in training mode under autograd, through
    ``torch.utils.checkpoint`` (non-reentrant), as flax's ``nn.remat`` of
    the unit: its activations are recomputed in the backward pass, the
    recompute under :func:`_running_stats_frozen` so that BatchNorm's
    running statistics move once a step."""
    if not (remat and unit.training and torch.is_grad_enabled()):
        return unit(x)
    return checkpoint_lib.checkpoint(
        unit, x, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _running_stats_frozen(unit)),
    )


class ConvBN(nn.Module):
    """Conv2D (no bias) + BatchNorm + relu, flax SAME padding. Submodule
    names ``conv``/``bn`` match the flax tree. ``space_to_depth`` makes the
    conv a :class:`SpaceToDepthConv`, which computes exactly the 3x3
    stride-2 rate-1 conv and raises for any other, as the JAX ``ConvBN``
    does."""

    tp = None

    def __init__(
        self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1,
        rate: int = 1, bn_epsilon: float = 1e-3, bn_scale: bool = True, bn_decay: float = 0.99,
        space_to_depth: bool = False, compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.stride, self.rate = stride, rate
        if space_to_depth:
            if kernel_size != 3 or stride != 2 or rate != 1:
                raise ValueError(
                    "space_to_depth implements exactly the 3x3 stride-2 rate-1 stem conv; got "
                    f"kernel_size={kernel_size}, stride={stride}, rate={rate}"
                )
            self.conv = SpaceToDepthConv(in_channels, features, compute_dtype)
        else:
            self.conv = Conv2dSame(in_channels, features, kernel_size, stride=stride, dilation=rate, bias=False,
                                   compute_dtype=compute_dtype)
        self.bn = BatchNorm(features, bn_epsilon, bn_scale, bn_decay, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp.column(self._forward, x) if self.tp is not None else self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x), act="relu")


class DepthwiseConv2D(nn.Module):
    """Stride-1 SAME depthwise conv + bias. ``weight`` is ``[kh, kw, C]``,
    the kernel's layout (flax's ``[kh, kw, 1, C]`` without its unit axis).
    ``use_kernel=True`` takes :func:`kernels.depthwise_conv2d` (the CUDA
    kernels, forward and backward, on a CUDA tensor); False the grouped-conv
    plain version. Input and filter are cast to ``compute_dtype`` (the
    kernels' bf16 arms in bf16 compute), then the bias is added in it.
    Under ``tp`` the kernel gets this rank's channels of the input, a
    fresh contiguous tensor."""

    tp = None

    def __init__(
        self, channels: int, kernel_size: int = 3, rate: int = 1, use_kernel: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"DepthwiseConv2D requires an odd kernel_size, got {kernel_size}")
        self.rate = rate
        self.use_kernel = use_kernel
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(kernel_size, kernel_size, channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp.channelwise(self._forward, x) if self.tp is not None else self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        dw = kernels.depthwise_conv2d if self.use_kernel else kernels.depthwise_conv2d_plain
        return dw(x.to(dt).contiguous(), self.weight.to(dt), self.rate) + self.bias.to(dt)


class SplitSeparableConv2D(nn.Module):
    """Depthwise (+ bias, relu) then pointwise 1x1 (no bias) + BN + relu;
    submodule names ``depthwise``/``pointwise``/``pointwise_bn`` match the
    flax tree. Under tensor parallelism the depthwise conv has its own
    ``tp``, and this module's ``tp`` runs the pointwise pair."""

    tp = None

    def __init__(
        self, in_channels: int, features: int, kernel_size: int = 3, rate: int = 1,
        bn_epsilon: float = 1e-3, bn_scale: bool = True, use_kernel: bool = False, bn_decay: float = 0.99,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.depthwise = DepthwiseConv2D(in_channels, kernel_size, rate, use_kernel, compute_dtype)
        self.pointwise = Conv2dSame(in_channels, features, 1, bias=False, compute_dtype=compute_dtype)
        self.pointwise_bn = BatchNorm(features, bn_epsilon, bn_scale, bn_decay, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.depthwise(x))
        return self.tp.column(self._pointwise, x) if self.tp is not None else self._pointwise(x)

    def _pointwise(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_bn(self.pointwise(x), act="relu")
