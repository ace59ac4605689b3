"""ResNet-v2-beta backbone with the DeepLabV3+ segmentation head and the
classification head (counterpart of
``tensorflowdistributedlearning_tpu/models/resnet.py``). Training mode
(``model.train()``) is the JAX ``train=True`` forward: the same graph, with
BatchNorm on batch statistics.

The backbone takes both block layouts (``reference``: the reference's
wide stages and atrous block4; ``classic``: the published ResNet-50/101/152
ladder), both unit types (bottleneck, basic block), the plain or the
space-to-depth stem, and computes in ``ModelConfig.dtype`` (the input cast
to it first; float32 logits either way). ``remat`` recomputes each residual
unit in the backward pass (``torch.utils.checkpoint``, non-reentrant) in
place of storing its activations, as flax's ``nn.remat`` per unit; the
recompute leaves BatchNorm's running statistics where the forward put them.

Module and parameter names mirror the flax tree (``backbone.block1_unit1.
conv2.bn.running_var`` is flax's ``batch_stats/backbone/block1_unit1/conv2/
bn/var``), so ``utils/convert.py`` maps one onto the other by name. Unlike
flax, torch modules are built with their input widths, so each module here
is given the channel count it receives.

Sequence parallelism (``models.set_spatial``; the JAX modules'
``spatial_axis_name``): the backbone runs on this rank's block of the rows,
its k x k convs through the halo exchange (``Conv2dSame.spatial``), its
stem pool through ``spatial_max_pool`` and its BatchNorms over the
sequence group; the segmenter all-gathers ``features`` and the skip before
the head, which then runs on whole maps on every rank of the group, and
the classifier pools with ``spatial_global_mean``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, require_supported
from tensorflowdistributedlearning_tpu_torch.parallel import spatial as spatial_lib
from tensorflowdistributedlearning_tpu_torch.models.layers import (
    BatchNorm,
    Conv2dSame,
    ConvBN,
    Dense,
    SplitSeparableConv2D,
    compute_dtype_of,
    max_pool_same,
    remat_call,
    scaled_width,
    subsample,
    upsample,
)

DEFAULT_MULTI_GRID = (2, 2, 2)
SEGMENTATION_MULTI_GRID = (1, 2, 1)


@dataclasses.dataclass(frozen=True)
class UnitSpec:
    depth: int
    depth_bottleneck: int
    stride: int
    unit_rate: int = 1


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    name: str
    units: Tuple[UnitSpec, ...]


def resnet_block_specs(
    n_blocks: Tuple[int, ...],
    multi_grid: Tuple[int, int, int] = SEGMENTATION_MULTI_GRID,
    width_multiplier: float = 1.0,
) -> Tuple[BlockSpec, ...]:
    """Block layout of the reference's ``resnet_v2``: three stages with the
    stride-2 unit last, then the atrous multi-grid stage (depth 1024 /
    bottleneck 256 / stride 1). Widths scale by ``width_multiplier``."""
    if len(n_blocks) != 3:
        raise ValueError("Expect n_blocks to have length 3.")
    if len(multi_grid) != 3:
        raise ValueError("Expect multi_grid to have length 3.")

    def w(c: int) -> int:
        return scaled_width(c, width_multiplier)

    def stage(name: str, base_depth: int, num_units: int) -> BlockSpec:
        units = tuple(
            UnitSpec(depth=w(base_depth * 4), depth_bottleneck=w(base_depth), stride=1)
            for _ in range(num_units - 1)
        ) + (UnitSpec(depth=w(base_depth * 4), depth_bottleneck=w(base_depth), stride=2),)
        return BlockSpec(name, units)

    block4 = BlockSpec(
        "block4",
        tuple(UnitSpec(depth=w(1024), depth_bottleneck=w(256), stride=1, unit_rate=r) for r in multi_grid),
    )
    return (
        stage("block1", 128, n_blocks[0]),
        stage("block2", 256, n_blocks[1]),
        stage("block3", 512, n_blocks[2]),
        block4,
    )


def classic_block_specs(n_blocks: Tuple[int, ...], width_multiplier: float = 1.0) -> Tuple[BlockSpec, ...]:
    """The published ResNet-50/101/152 ladder: four stages at bottleneck
    widths 64/128/256/512 (outputs 256/512/1024/2048), the stride-2 unit
    last in each of the first three, the fourth unstrided (overall stride
    32 with the root's 4)."""
    if len(n_blocks) != 4:
        raise ValueError("classic layout expects n_blocks of length 4, e.g. (3, 4, 6, 3)")

    def w(c: int) -> int:
        return scaled_width(c, width_multiplier)

    specs = []
    for name, base, num_units, last_stride in zip(
        ("block1", "block2", "block3", "block4"), (64, 128, 256, 512), n_blocks, (2, 2, 2, 1)
    ):
        units = tuple(
            UnitSpec(depth=w(base * 4), depth_bottleneck=w(base), stride=1) for _ in range(num_units - 1)
        ) + (UnitSpec(depth=w(base * 4), depth_bottleneck=w(base), stride=last_stride),)
        specs.append(BlockSpec(name, units))
    return tuple(specs)


def stack_blocks_dense(blocks, output_stride: Optional[int]):
    """slim ``stack_blocks_dense`` semantics: yields ``(block name, unit
    index, applied spec, accumulated rate)``; strides apply until the target
    stride (output_stride / 4, the root's stride) is reached, then
    accumulate into atrous rates."""
    if output_stride is not None:
        if output_stride % 4 != 0:
            raise ValueError("The output_stride needs to be a multiple of 4.")
        target_stride = output_stride // 4
    else:
        target_stride = None
    current_stride, rate = 1, 1
    for block in blocks:
        for i, unit in enumerate(block.units):
            if target_stride is not None and current_stride == target_stride:
                applied = dataclasses.replace(unit, stride=1)
                unit_rate_accum = rate
                rate *= unit.stride
            else:
                applied = unit
                unit_rate_accum = 1
                current_stride *= unit.stride
            yield block.name, i, applied, unit_rate_accum
    if target_stride is not None and current_stride != target_stride:
        raise ValueError("output_stride is unreachable with this block layout.")


class BottleneckUnit(nn.Module):
    """Pre-activation bottleneck unit: preact BN+relu -> 1x1 reduce (BN+relu)
    -> 3x3 atrous (BN+relu, stride fused) -> 1x1 expand (bias); shortcut is
    the subsampled input or a 1x1 conv of the preactivation. Returns
    ``(relu(shortcut + residual), residual)`` in the compute dtype (and
    under int8-compute both terms leave int8 convs in bf16, so the add and
    the residual stream are bf16, as in flax)."""

    out_width = "depth"

    def __init__(
        self, in_channels: int, spec: UnitSpec, rate: int = 1, bn_epsilon: float = 1e-3,
        bn_scale: bool = True, bn_decay: float = 0.99, compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.spec = spec
        common = dict(bn_epsilon=bn_epsilon, bn_scale=bn_scale, bn_decay=bn_decay, compute_dtype=compute_dtype)
        self.preact = BatchNorm(in_channels, bn_epsilon, bn_scale, bn_decay, compute_dtype=compute_dtype)
        self.shortcut = (
            Conv2dSame(in_channels, spec.depth, 1, stride=spec.stride, compute_dtype=compute_dtype)
            if spec.depth != in_channels
            else None
        )
        self.conv1 = ConvBN(in_channels, spec.depth_bottleneck, 1, **common)
        self.conv2 = ConvBN(
            spec.depth_bottleneck, spec.depth_bottleneck, 3, stride=spec.stride,
            rate=rate * spec.unit_rate, **common,
        )
        self.conv3 = Conv2dSame(spec.depth_bottleneck, spec.depth, 1, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor):
        preact = self.preact(x, act="relu")
        if self.shortcut is None:
            shortcut = subsample(x, self.spec.stride)
        else:
            shortcut = self.shortcut(preact)
        residual = self.conv3(self.conv2(self.conv1(preact)))
        return torch.relu(shortcut + residual), residual


class BasicBlockUnit(nn.Module):
    """Pre-activation basic (two-conv) unit: preact BN+relu -> 3x3 (BN+relu,
    stride fused) -> 3x3 atrous (bias); shortcut is the subsampled input or
    a 1x1 conv of the preactivation. Its output width is
    ``depth_bottleneck``: the reference's basic block ignores ``depth``.
    Returns ``(relu(shortcut + residual), residual)``."""

    out_width = "depth_bottleneck"

    def __init__(
        self, in_channels: int, spec: UnitSpec, rate: int = 1, bn_epsilon: float = 1e-3,
        bn_scale: bool = True, bn_decay: float = 0.99, compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.spec = spec
        width = spec.depth_bottleneck
        self.preact = BatchNorm(in_channels, bn_epsilon, bn_scale, bn_decay, compute_dtype=compute_dtype)
        self.shortcut = (
            Conv2dSame(in_channels, width, 1, stride=spec.stride, compute_dtype=compute_dtype)
            if width != in_channels
            else None
        )
        self.conv1 = ConvBN(in_channels, width, 3, stride=spec.stride, bn_epsilon=bn_epsilon, bn_scale=bn_scale,
                            bn_decay=bn_decay, compute_dtype=compute_dtype)
        self.conv2 = Conv2dSame(width, width, 3, dilation=rate * spec.unit_rate, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor):
        preact = self.preact(x, act="relu")
        shortcut = subsample(x, self.spec.stride) if self.shortcut is None else self.shortcut(preact)
        residual = self.conv2(self.conv1(preact))
        return torch.relu(shortcut + residual), residual


class ResNetBackbone(nn.Module):
    """ResNet-v2-beta feature extractor: root of three 3x3 convs (first
    stride 2; space-to-depth under ``stem_space_to_depth``), SAME max-pool,
    post-norm BN+relu, then the residual stages of the configured layout and
    unit type under output_stride control (None: every stride applied).
    ``forward`` casts the input to the compute dtype and returns the
    end-point dict ('root', each 'block{i}', 'block1_unit1_residual',
    'features')."""

    # H-sharded over the sequence group (models.set_spatial)
    spatial = False

    def __init__(self, config: ModelConfig, multi_grid: Tuple[int, int, int] = SEGMENTATION_MULTI_GRID):
        super().__init__()
        require_supported(config)
        cfg = config
        wm = cfg.width_multiplier
        self.compute_dtype = compute_dtype_of(cfg)
        self.remat = cfg.remat
        common = dict(
            bn_epsilon=cfg.batch_norm_epsilon, bn_scale=cfg.batch_norm_scale, bn_decay=cfg.batch_norm_decay,
            compute_dtype=self.compute_dtype,
        )
        c1, c3 = scaled_width(64, wm), scaled_width(128, wm)
        self.conv1_1 = ConvBN(cfg.input_channels, c1, 3, stride=2, space_to_depth=cfg.stem_space_to_depth, **common)
        self.conv1_2 = ConvBN(c1, c1, 3, **common)
        self.conv1_3 = ConvBN(c1, c3, 3, **common)
        self.postnorm = BatchNorm(c3, cfg.batch_norm_epsilon, cfg.batch_norm_scale, cfg.batch_norm_decay,
                                  compute_dtype=self.compute_dtype)
        self.unit_names = []
        self.block_ends: Dict[str, str] = {}
        channels = c3
        if cfg.block_layout == "classic":
            blocks = classic_block_specs(cfg.n_blocks, wm)
        else:
            blocks = resnet_block_specs(cfg.n_blocks, multi_grid, wm)
        unit_cls = BasicBlockUnit if cfg.block_type == "basic_block" else BottleneckUnit
        for block_name, i, spec, rate in stack_blocks_dense(blocks, cfg.output_stride):
            name = f"{block_name}_unit{i + 1}"
            self.add_module(name, unit_cls(channels, spec, rate, **common))
            self.unit_names.append(name)
            self.block_ends[block_name] = name
            channels = getattr(spec, unit_cls.out_width)
        self.out_channels = channels
        self.skip_channels = getattr(blocks[0].units[0], unit_cls.out_width)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        end_points: Dict[str, torch.Tensor] = {}
        x = self.conv1_3(self.conv1_2(self.conv1_1(x.to(self.compute_dtype))))
        x = spatial_lib.spatial_max_pool(x, 3, 2) if self.spatial else max_pool_same(x, 3, 2)
        x = self.postnorm(x, act="relu")
        end_points["root"] = x
        last_of = {unit: block for block, unit in self.block_ends.items()}
        for name in self.unit_names:
            x, residual = remat_call(getattr(self, name), x, self.remat)
            if name == "block1_unit1":
                end_points["block1_unit1_residual"] = residual
            if name in last_of:
                end_points[last_of[name]] = x
        end_points["features"] = x
        return end_points


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1 conv, three split-separable
    atrous convs at rates 2/4/8, a global-pool branch upsampled back,
    concatenated and fused by a 1x1 conv."""

    def __init__(self, config: ModelConfig, in_channels: int):
        super().__init__()
        cfg = config
        depth = cfg.base_depth
        self.compute_dtype = compute_dtype_of(cfg)
        common = dict(
            bn_epsilon=cfg.batch_norm_epsilon, bn_scale=cfg.batch_norm_scale, bn_decay=cfg.batch_norm_decay,
            compute_dtype=self.compute_dtype,
        )
        sep = dict(common, use_kernel=cfg.use_pallas_depthwise)
        self.conv_1x1 = ConvBN(in_channels, depth, 1, **common)
        self.conv_3x3_1 = SplitSeparableConv2D(in_channels, depth, 3, rate=2, **sep)
        self.conv_3x3_2 = SplitSeparableConv2D(in_channels, depth, 3, rate=4, **sep)
        self.conv_3x3_3 = SplitSeparableConv2D(in_channels, depth, 3, rate=8, **sep)
        self.pool_conv_1x1 = ConvBN(in_channels, depth, 1, **common)
        self.project = ConvBN(5 * depth, depth, 1, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_size = x.shape[1:3]
        a1 = self.conv_1x1(x)
        a2 = self.conv_3x3_1(x)
        a3 = self.conv_3x3_2(x)
        a4 = self.conv_3x3_3(x)
        # jnp.mean: f32 sum and division, result in x's dtype
        pooled = self.pool_conv_1x1(x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype))
        a5 = upsample_to(pooled, out_size, self.compute_dtype)
        return self.project(torch.cat([a1, a2, a3, a4, a5], dim=-1))


def upsample_to(x: torch.Tensor, out_hw, dtype: torch.dtype) -> torch.Tensor:
    """:func:`upsample` of ``x``, cast to ``dtype``: the JAX head's
    ``upsample(...).astype(dtype)``."""
    return upsample(x, out_hw).to(dtype)


class ResNetSegmentation(nn.Module):
    """Backbone + ASPP + DeepLabV3+ decoder with the block1 skip, producing
    per-pixel float32 logits [B, H, W, 1] at input resolution from NHWC
    input [B, H, W, input_channels], whatever the compute dtype. The
    head's submodules (``aspp``, ``decoder_conv_1x1``, ``decoder_conv_3x3``)
    sit at the top level, as ``deeplab_head`` binds them in flax."""

    spatial = False

    def __init__(self, config: ModelConfig):
        super().__init__()
        require_supported(config)
        self.config = config
        dtype = compute_dtype_of(config)
        self.backbone = ResNetBackbone(config, SEGMENTATION_MULTI_GRID)
        common = dict(
            bn_epsilon=config.batch_norm_epsilon, bn_scale=config.batch_norm_scale,
            bn_decay=config.batch_norm_decay, compute_dtype=dtype,
        )
        self.aspp = ASPP(config, self.backbone.out_channels)
        self.decoder_conv_1x1 = ConvBN(self.backbone.skip_channels, config.base_depth, 1, **common)
        self.decoder_conv_3x3 = Conv2dSame(2 * config.base_depth, 1, 3, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        end_points = self.backbone(x)
        features, skip = end_points["features"], end_points["block1_unit1_residual"]
        if self.spatial:
            # the head's upsamplings and the per-image loss need whole maps
            features = spatial_lib.spatial_gather(features)
            skip = spatial_lib.spatial_gather(skip)
        return deeplab_head(self, features, skip)


def deeplab_head(net: nn.Module, features: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Shared DeepLabV3+ head over ``net``'s ``aspp``/``decoder_conv_1x1``/
    ``decoder_conv_3x3``: ASPP, upsample to the skip's resolution, 1x1
    projected skip concat, 3x3 fuse to one channel, bilinear upsample to the
    configured input resolution in float32."""
    aspp = net.aspp(features)
    aspp_up = upsample_to(aspp, skip.shape[1:3], net.aspp.compute_dtype)
    decoder = torch.cat([net.decoder_conv_1x1(skip), aspp_up], dim=-1)
    decoder = net.decoder_conv_3x3(decoder)
    return upsample(decoder.float(), net.config.input_shape).contiguous()


class ResNetClassifier(nn.Module):
    """Classification path: the backbone with every stride applied
    (``output_stride=None``, overall stride 32) and the default multi-grid
    (2, 2, 2), a mean pool over H, W (float32 sums, in the compute dtype,
    as ``jnp.mean``), then the float32 Dense ``logits``. Returns [B,
    num_classes] float32 logits."""

    spatial = False

    def __init__(self, config: ModelConfig):
        super().__init__()
        require_supported(config)
        if config.num_classes is None:
            raise ValueError("ResNetClassifier requires config.num_classes")
        self.config = config
        self.backbone = ResNetBackbone(dataclasses.replace(config, output_stride=None), DEFAULT_MULTI_GRID)
        self.logits = Dense(self.backbone.out_channels, config.num_classes, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = self.backbone(x)["features"]
        if self.spatial:
            pooled = spatial_lib.spatial_global_mean(features)
        else:
            pooled = features.float().mean(dim=(1, 2)).to(features.dtype)
        return self.logits(pooled.float())
