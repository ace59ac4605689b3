"""Xception-41 backbone, segmenter and classifier (counterpart of the JAX
package's ``models/xception.py``: ``SeparableConvSame`` :41,
``XceptionUnit`` :145, ``xception_41_block_specs`` :212, ``XceptionBackbone``
:237, ``XceptionSegmentation`` :306, ``Xception41`` :386).

The DeepLab Xception-41: a root of two 3x3 convs (32 stride 2, then 64),
then the entry flow (three conv-skip blocks of stride 2 at widths 128, 256,
728), the middle flow (eight 728-wide sum-skip units) and the exit flow (a
conv-skip block [728, 1024, 1024] of stride 2, then [1536, 1536, 2048] with
no skip and the activation inside its separable convs, at the multi-grid
rates). Every conv is followed by BatchNorm. ``output_stride`` turns the
strides past the target (output_stride / 2, the root's stride) into atrous
rates. The segmenter puts the ResNet's ASPP and DeepLabV3+ decoder on it,
with the stride-4 ``entry_block1`` features as the skip; the classifier
pools, drops out (``keep_prob``) and projects to the logits.

The separable convs' depthwise half is flax's grouped ``nn.Conv``
(``feature_group_count=C``), SAME at stride 1 and ``fixed_padding`` + VALID
with a stride: here a grouped convolution, the same function, computed by
``F.conv2d`` as the JAX package computes it by XLA; no kernel of the port
is involved. The ASPP's split-separable convs take the depthwise kernels
under ``use_pallas_depthwise``, and every BatchNorm in eval mode the
``bn_act`` kernel, as in the ResNet.

The classifier's pipeline-parallel decomposition (JAX ``:421-579``):
:class:`XceptionEntryFlow` and :class:`XceptionExitHead` are views over
the canonical :class:`Xception41`, the middle flow's 8 units go over the
stage group (``grouped_middle_stage_fn``, ``train/pipeline_step.py``).

Module names mirror the flax tree (``backbone.entry_block1_unit1.
separable_conv1.depthwise.weight`` is flax's ``params/backbone/
entry_block1_unit1/separable_conv1/depthwise/kernel``), so
``utils/convert.py`` maps one onto the other; a grouped filter ``[C, 1, 3,
3]`` is flax's ``[3, 3, 1, C]`` transposed as any conv filter.

The classifier's dropout draws its masks from the generator of the
``layers.dropout_key`` in force, which the train step keys by
(``TrainConfig.seed``, step, rank, accumulation chunk) as the JAX step
folds them into its PRNG key: the module holds no random state, so a
resumed run continues the uninterrupted stream. The bits cannot match
``jax.random``'s; the keying does.

Under sequence parallelism (``models.set_spatial``) the backbone runs on
this rank's block of the rows: its convs, the grouped depthwise ones too,
through the halo exchange (``Conv2dSame.spatial``; a strided depthwise
conv in the ``fixed`` phase), its BatchNorms over the sequence group. The
segmenter all-gathers ``features`` and the skip before the head; the
classifier pools with ``spatial_global_mean``, and every rank of a
sequence group draws the same dropout mask (the key holds no sequence
index).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, require_supported
from tensorflowdistributedlearning_tpu_torch.models.layers import (
    BatchNorm,
    Conv2dSame,
    ConvBN,
    Dense,
    compute_dtype_of,
    dropout_generator,
    fixed_padding,
    scaled_width,
)
from tensorflowdistributedlearning_tpu_torch.models.resnet import ASPP, deeplab_head
from tensorflowdistributedlearning_tpu_torch.parallel import spatial as spatial_lib

# pre-logits dropout keep probability (the JAX package's single source)
DEFAULT_KEEP_PROB = 0.5


class DepthwiseConvSame(Conv2dSame):
    """flax ``nn.Conv(C, k, feature_group_count=C, use_bias=False)`` on
    NHWC: SAME padding at stride 1; at a stride, ``fixed_padding`` then
    VALID, as ``SeparableConvSame`` pads. Weight ``[C, 1, k, k]``."""

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1, rate: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, kernel_size, stride=stride, dilation=rate, groups=channels, bias=False,
                         compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial:
            # grouped, through the halo exchange: SAME at stride 1, fixed_padding + VALID at a stride
            return self._spatial_forward(x, "fixed" if self.stride[0] > 1 else "same")
        if self.stride[0] == 1:
            return super().forward(x)
        dt = self.compute_dtype
        x = fixed_padding(x.float() if dt == torch.float32 else x.to(dt), self.kernel_size[0], rate=self.dilation[0])
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(dt), None, stride=self.stride, dilation=self.dilation,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class SeparableConvSame(nn.Module):
    """Depthwise + pointwise conv pair with BatchNorm after each and the
    activation inside (after each BN) under ``activation_inside``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3, stride: int = 1, rate: int = 1,
                 activation_inside: bool = False, bn_decay: float = 0.99, bn_epsilon: float = 1e-3,
                 bn_scale: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = "relu" if activation_inside else "none"
        bn = dict(eps=bn_epsilon, scale=bn_scale, decay=bn_decay, compute_dtype=compute_dtype)
        self.depthwise = DepthwiseConvSame(in_channels, kernel_size, stride, rate, compute_dtype)
        self.depthwise_bn = BatchNorm(in_channels, **bn)
        self.pointwise = Conv2dSame(in_channels, features, 1, bias=False, compute_dtype=compute_dtype)
        self.pointwise_bn = BatchNorm(features, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.depthwise_bn(self.depthwise(x), act=self.act)
        return self.pointwise_bn(self.pointwise(x), act=self.act)


@dataclasses.dataclass(frozen=True)
class XceptionUnitSpec:
    depth_list: Tuple[int, int, int]
    skip_connection_type: str  # 'conv' | 'sum' | 'none'
    stride: int
    unit_rate_list: Tuple[int, int, int] = (1, 1, 1)
    activation_inside: bool = False


@dataclasses.dataclass(frozen=True)
class XceptionBlockSpec:
    name: str
    units: Tuple[XceptionUnitSpec, ...]


class XceptionUnit(nn.Module):
    """One Xception module: three pre-relu separable convs (the stride on
    the third) plus a conv, sum or no shortcut."""

    def __init__(self, in_channels: int, spec: XceptionUnitSpec, rate: int = 1, bn_decay: float = 0.99,
                 bn_epsilon: float = 1e-3, bn_scale: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if spec.skip_connection_type not in ("conv", "sum", "none"):
            raise ValueError("Unsupported skip connection type.")
        self.spec = spec
        bn = dict(bn_decay=bn_decay, bn_epsilon=bn_epsilon, bn_scale=bn_scale, compute_dtype=compute_dtype)
        channels = in_channels
        for i in range(3):
            self.add_module(f"separable_conv{i + 1}", SeparableConvSame(
                channels, spec.depth_list[i], 3, stride=spec.stride if i == 2 else 1,
                rate=rate * spec.unit_rate_list[i], activation_inside=spec.activation_inside, **bn,
            ))
            channels = spec.depth_list[i]
        if spec.skip_connection_type == "conv":
            self.shortcut = Conv2dSame(in_channels, spec.depth_list[-1], 1, stride=spec.stride, bias=False,
                                       compute_dtype=compute_dtype)
            self.shortcut_bn = BatchNorm(spec.depth_list[-1], bn_epsilon, bn_scale, bn_decay,
                                         compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        for i in range(3):
            residual = getattr(self, f"separable_conv{i + 1}")(torch.relu(residual))
        kind = self.spec.skip_connection_type
        if kind == "conv":
            return residual + self.shortcut_bn(self.shortcut(x), act="none")
        if kind == "sum":
            return residual + x
        return residual


def xception_41_block_specs(
    multi_grid: Tuple[int, int, int] = (1, 1, 1), width_multiplier: float = 1.0
) -> Tuple[XceptionBlockSpec, ...]:
    """The Xception-41 block table; widths scale by ``width_multiplier``."""

    def block(name, depths, skip, num_units, stride, rates=(1, 1, 1), act_inside=False):
        unit = XceptionUnitSpec(
            depth_list=tuple(scaled_width(d, width_multiplier) for d in depths), skip_connection_type=skip,
            stride=stride, unit_rate_list=tuple(rates), activation_inside=act_inside,
        )
        return XceptionBlockSpec(name, (unit,) * num_units)

    return (
        block("entry_block1", (128, 128, 128), "conv", 1, 2),
        block("entry_block2", (256, 256, 256), "conv", 1, 2),
        block("entry_block3", (728, 728, 728), "conv", 1, 2),
        block("middle_block1", (728, 728, 728), "sum", 8, 1),
        block("exit_block1", (728, 1024, 1024), "conv", 1, 2),
        block("exit_block2", (1536, 1536, 2048), "none", 1, 1, multi_grid, True),
    )


class XceptionBackbone(nn.Module):
    """Xception feature extractor with atrous ``output_stride`` control;
    ``forward`` casts the input to the compute dtype and returns the
    end-point dict ('root', each block's name, 'features')."""

    def __init__(self, config: ModelConfig, multi_grid: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        cfg = config
        wm = cfg.width_multiplier
        self.compute_dtype = compute_dtype_of(cfg)
        bn = dict(bn_decay=cfg.batch_norm_decay, bn_epsilon=cfg.batch_norm_epsilon, bn_scale=cfg.batch_norm_scale,
                  compute_dtype=self.compute_dtype)
        if cfg.output_stride is not None:
            if cfg.output_stride % 2 != 0:
                raise ValueError("The output_stride needs to be a multiple of 2.")
            target_stride = cfg.output_stride // 2  # the root strides by 2
        else:
            target_stride = None
        c1, c2 = scaled_width(32, wm), scaled_width(64, wm)
        self.conv1_1 = ConvBN(cfg.input_channels, c1, 3, stride=2, space_to_depth=cfg.stem_space_to_depth,
                              bn_epsilon=cfg.batch_norm_epsilon, bn_scale=cfg.batch_norm_scale,
                              bn_decay=cfg.batch_norm_decay, compute_dtype=self.compute_dtype)
        self.conv1_2 = ConvBN(c1, c2, 3, bn_epsilon=cfg.batch_norm_epsilon, bn_scale=cfg.batch_norm_scale,
                              bn_decay=cfg.batch_norm_decay, compute_dtype=self.compute_dtype)
        self.unit_names = []
        self.block_ends: Dict[str, str] = {}
        channels = c2
        current_stride, rate = 1, 1
        for blk in xception_41_block_specs(multi_grid, wm):
            for i, unit in enumerate(blk.units):
                if target_stride is not None and current_stride == target_stride:
                    applied, unit_rate = dataclasses.replace(unit, stride=1), rate
                    rate *= unit.stride
                else:
                    applied, unit_rate = unit, 1
                    current_stride *= unit.stride
                name = f"{blk.name}_unit{i + 1}"
                self.add_module(name, XceptionUnit(channels, applied, unit_rate, **bn))
                self.unit_names.append(name)
                self.block_ends[name] = blk.name
                channels = applied.depth_list[-1]
        if target_stride is not None and current_stride != target_stride:
            raise ValueError("The target output_stride cannot be reached.")
        self.out_channels = channels
        self.skip_channels = scaled_width(128, wm)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        end_points: Dict[str, torch.Tensor] = {}
        x = self.conv1_2(self.conv1_1(x.to(self.compute_dtype)))
        end_points["root"] = x
        for name in self.unit_names:
            x = getattr(self, name)(x)
            end_points[self.block_ends[name]] = x
        end_points["features"] = x
        return end_points


class XceptionSegmentation(nn.Module):
    """Xception-41 + ASPP + DeepLabV3+ decoder with the ``entry_block1``
    skip: float32 logits [B, H, W, 1] at input resolution from NHWC input,
    whatever the compute dtype. The head's submodules (``aspp``,
    ``decoder_conv_1x1``, ``decoder_conv_3x3``) sit at the top level, as
    in flax."""

    # H-sharded backbone, whole-map head (models.set_spatial)
    spatial = False

    def __init__(self, config: ModelConfig):
        super().__init__()
        require_supported(config)
        self.config = config
        dtype = compute_dtype_of(config)
        self.backbone = XceptionBackbone(config, multi_grid=(1, 2, 1))
        self.aspp = ASPP(config, self.backbone.out_channels)
        self.decoder_conv_1x1 = ConvBN(
            self.backbone.skip_channels, config.base_depth, 1, bn_epsilon=config.batch_norm_epsilon,
            bn_scale=config.batch_norm_scale, bn_decay=config.batch_norm_decay, compute_dtype=dtype,
        )
        self.decoder_conv_3x3 = Conv2dSame(2 * config.base_depth, 1, 3, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        end_points = self.backbone(x)
        features, skip = end_points["features"], end_points["entry_block1"]
        if self.spatial:
            features = spatial_lib.spatial_gather(features)
            skip = spatial_lib.spatial_gather(skip)
        return deeplab_head(self, features, skip)


class Xception41(nn.Module):
    """Xception-41 classifier: the backbone with every stride applied, a
    mean pool (float32 sums, in the compute dtype, as ``jnp.mean``), then in
    float32 the pre-logits dropout (training mode only, ``keep_prob``) and
    the Dense ``logits``. Without ``num_classes`` it returns the pooled
    features."""

    # H-sharded backbone, pooled with spatial_global_mean (models.set_spatial)
    spatial = False

    def __init__(self, config: ModelConfig, keep_prob: float = DEFAULT_KEEP_PROB):
        super().__init__()
        require_supported(config)
        self.config = config
        self.keep_prob = float(keep_prob)
        self.backbone = XceptionBackbone(dataclasses.replace(config, output_stride=None))
        self.logits = Dense(self.backbone.out_channels, config.num_classes, None) if config.num_classes else None

    def _dropout(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.keep_prob, self.training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = self.backbone(x)["features"]
        pooled = spatial_lib.spatial_global_mean(features).float() if self.spatial else global_pool(features)
        if self.logits is None:
            return pooled
        return self.logits(self._dropout(pooled))


def dropout(x: torch.Tensor, keep_prob: float, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout(1 - keep_prob)``: ``x / keep_prob`` where a uniform
    draw is below ``keep_prob``, else 0, in training mode only; the draw
    from :func:`layers.dropout_generator`."""
    if not training or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=dropout_generator(x.device), device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def global_pool(features: torch.Tensor) -> torch.Tensor:
    """The classifier's mean pool: float32 sums, in the compute dtype, as
    ``jnp.mean``, then float32."""
    return features.float().mean(dim=(1, 2)).to(features.dtype).float()


# -- pipeline parallelism of the classifier (train/pipeline_step.py) ---------
#
# The middle flow (8 identical 728-wide sum-skip units) is the GPipe runner's
# homogeneous-stage case (parallel/pipeline.py) and runs over the stage group;
# the entry flow (root + the three conv-skip blocks) and the exit flow with the
# head run replicated on every stage. The flows are views over the canonical
# Xception41: their submodules are its own, under its names, so checkpoints,
# serving export and eval stay interchangeable with every other strategy.

MIDDLE_FLOW_UNITS = 8
MIDDLE_FLOW_PREFIX = "middle_block1_unit"


class XceptionEntryFlow(nn.Module):
    """Root convs and entry blocks 1-3 of a canonical :class:`Xception41`
    (its backbone's modules, under their names): NHWC images to the
    middle flow's input, in the compute dtype."""

    def __init__(self, model: Xception41):
        super().__init__()
        backbone = model.backbone
        self.compute_dtype = backbone.compute_dtype
        self.conv1_1, self.conv1_2 = backbone.conv1_1, backbone.conv1_2
        self.unit_names = [n for n in backbone.unit_names if n.startswith("entry_")]
        for name in self.unit_names:
            self.add_module(name, getattr(backbone, name))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1_2(self.conv1_1(x.to(self.compute_dtype)))
        for name in self.unit_names:
            x = getattr(self, name)(x)
        return x


class XceptionExitHead(nn.Module):
    """Exit blocks 1-2, the global pool, the pre-logits dropout (the
    classifier's ``keep_prob``) and the ``logits`` Dense of a canonical
    :class:`Xception41` (its modules, under their names)."""

    def __init__(self, model: Xception41):
        super().__init__()
        backbone = model.backbone
        self.keep_prob = model.keep_prob
        self.unit_names = [n for n in backbone.unit_names if n.startswith("exit_")]
        for name in self.unit_names:
            self.add_module(name, getattr(backbone, name))
        self.logits = model.logits

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.unit_names:
            x = getattr(self, name)(x)
        return self.logits(dropout(global_pool(x), self.keep_prob, self.training))


def middle_unit_module(config: ModelConfig, device=None) -> XceptionUnit:
    """One 728-wide sum-skip middle-flow unit of ``config`` (classifier
    layout: stride 1, rate 1), with its BatchNorm settings and compute
    dtype: the computation and parameter shapes all 8 units share."""
    wm = config.width_multiplier
    width = scaled_width(728, wm)
    spec = XceptionUnitSpec(depth_list=(width, width, width), skip_connection_type="sum", stride=1)
    unit = XceptionUnit(width, spec, 1, bn_decay=config.batch_norm_decay, bn_epsilon=config.batch_norm_epsilon,
                        bn_scale=config.batch_norm_scale, compute_dtype=compute_dtype_of(config))
    return unit if device is None else unit.to(device)


def middle_units(model: Xception41):
    """The canonical model's 8 middle-flow units, in order."""
    return [getattr(model.backbone, f"{MIDDLE_FLOW_PREFIX}{i + 1}") for i in range(MIDDLE_FLOW_UNITS)]


def stack_middle_unit_tree(backbone_tree, n_stages: int):
    """The 8 middle units' entries of ``backbone_tree`` (a mapping by the
    backbone's names, ``middle_block1_unit{1..8}.<name>``: parameters or
    BN statistics) stacked into the grouped ``{<name>: [K, 8/K, ...]}``
    the stages take their slots of."""
    if MIDDLE_FLOW_UNITS % n_stages:
        raise ValueError(f"{MIDDLE_FLOW_UNITS} middle-flow units not divisible into {n_stages} pipeline stages")
    units = []
    for i in range(MIDDLE_FLOW_UNITS):
        prefix = f"{MIDDLE_FLOW_PREFIX}{i + 1}."
        units.append({n[len(prefix):]: t for n, t in backbone_tree.items() if n.startswith(prefix)})
    group = MIDDLE_FLOW_UNITS // n_stages
    return {name: torch.stack([u[name] for u in units]).reshape((n_stages, group) + tuple(units[0][name].shape))
            for name in units[0]}


def unstack_middle_unit_tree(stacked_tree):
    """Reverse :func:`stack_middle_unit_tree`: ``{<name>: [K, G, ...]}`` to
    the backbone's ``{middle_block1_unit{n}.<name>: tensor}``."""
    out = {}
    for name, leaf in stacked_tree.items():
        flat = leaf.reshape((MIDDLE_FLOW_UNITS,) + tuple(leaf.shape[2:]))
        for i in range(MIDDLE_FLOW_UNITS):
            out[f"{MIDDLE_FLOW_PREFIX}{i + 1}.{name}"] = flat[i]
    return out


def _batch_norms(units):
    return [m for unit in units for m in unit.modules() if isinstance(m, BatchNorm)]


def grouped_middle_stage_fn(config: ModelConfig, units_per_stage: int, train: bool):
    """The stage function over a stage's bundle, which here is its
    ``units_per_stage`` consecutive middle units themselves (their
    parameters and running statistics; JAX's bundle is their stacked
    trees): the units applied in order.

    Train form (for ``pipeline_apply_aux``): ``stage_fn(units, x) -> (y,
    new_stats)``; BatchNorm normalizes with the microbatch's statistics
    (the GPipe regime) and ``new_stats`` is the running statistics each BN
    (in module order, mean then variance) would hold after this
    microbatch's update from the values it holds at the call, which are
    restored after it. Eval form (for ``pipeline_apply``): the running
    statistics, nothing moved."""

    def check(units):
        if len(units) != units_per_stage:
            raise ValueError(f"a stage of {units_per_stage} middle units got {len(units)}")

    def train_stage_fn(units, x: torch.Tensor):
        check(units)
        bns = _batch_norms(units)
        held = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
        for unit in units:
            x = unit(x)
        new = [t.clone() for bn in bns for t in (bn.running_mean, bn.running_var)]
        with torch.no_grad():
            for bn, (mean, var) in zip(bns, held):
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)
        return x, new

    def eval_stage_fn(units, x: torch.Tensor) -> torch.Tensor:
        check(units)
        for unit in units:
            x = unit(x)
        return x

    return train_stage_fn if train else eval_stage_fn


def set_running_stats(units, stats) -> None:
    """Write ``stats`` (the train stage function's order: each BN's mean
    then variance) into the units' BatchNorm running statistics."""
    with torch.no_grad():
        for bn, mean, var in zip(_batch_norms(units), stats[0::2], stats[1::2]):
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
