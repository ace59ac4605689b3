"""ResNet-v2-beta backbone with the DeepLabV3+ segmentation head (counterpart
of ``tensorflowdistributedlearning_tpu/models/resnet.py``), inference only.

Module and parameter names mirror the flax tree (``backbone.block1_unit1.
conv2.bn.running_var`` is flax's ``batch_stats/backbone/block1_unit1/conv2/
bn/var``), so ``utils/convert.py`` maps one onto the other by name. Unlike
flax, torch modules are built with their input widths, so each module here
is given the channel count it receives.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, require_supported
from tensorflowdistributedlearning_tpu_torch.models.layers import (
    BatchNorm,
    ConvBN,
    SplitSeparableConv2D,
    conv2d_same,
    max_pool_same,
    scaled_width,
    subsample,
    upsample,
)

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
    ``(relu(shortcut + residual), residual)``."""

    def __init__(self, in_channels: int, spec: UnitSpec, rate: int = 1, bn_epsilon: float = 1e-3, bn_scale: bool = True):
        super().__init__()
        self.spec = spec
        common = dict(bn_epsilon=bn_epsilon, bn_scale=bn_scale)
        self.preact = BatchNorm(in_channels, bn_epsilon, bn_scale)
        self.shortcut = (
            nn.Conv2d(in_channels, spec.depth, 1, stride=spec.stride)
            if spec.depth != in_channels
            else None
        )
        self.conv1 = ConvBN(in_channels, spec.depth_bottleneck, 1, **common)
        self.conv2 = ConvBN(
            spec.depth_bottleneck, spec.depth_bottleneck, 3, stride=spec.stride,
            rate=rate * spec.unit_rate, **common,
        )
        self.conv3 = nn.Conv2d(spec.depth_bottleneck, spec.depth, 1)

    def forward(self, x: torch.Tensor):
        preact = self.preact(x, act="relu")
        if self.shortcut is None:
            shortcut = subsample(x, self.spec.stride)
        else:
            shortcut = conv2d_same(preact, self.shortcut.weight, self.shortcut.bias, self.spec.stride)
        residual = self.conv2(self.conv1(preact))
        residual = conv2d_same(residual, self.conv3.weight, self.conv3.bias)
        return torch.relu(shortcut + residual), residual


class ResNetBackbone(nn.Module):
    """ResNet-v2-beta feature extractor: root of three 3x3 convs (first
    stride 2), SAME max-pool, post-norm BN+relu, then the residual stages
    under output_stride control. ``forward`` returns the end-point dict
    ('root', each 'block{i}', 'block1_unit1_residual', 'features')."""

    def __init__(self, config: ModelConfig, multi_grid: Tuple[int, int, int] = SEGMENTATION_MULTI_GRID):
        super().__init__()
        require_supported(config)
        cfg = config
        wm = cfg.width_multiplier
        common = dict(bn_epsilon=cfg.batch_norm_epsilon, bn_scale=cfg.batch_norm_scale)
        c1, c3 = scaled_width(64, wm), scaled_width(128, wm)
        self.conv1_1 = ConvBN(cfg.input_channels, c1, 3, stride=2, **common)
        self.conv1_2 = ConvBN(c1, c1, 3, **common)
        self.conv1_3 = ConvBN(c1, c3, 3, **common)
        self.postnorm = BatchNorm(c3, cfg.batch_norm_epsilon, cfg.batch_norm_scale)
        self.unit_names = []
        self.block_ends: Dict[str, str] = {}
        channels = c3
        blocks = resnet_block_specs(cfg.n_blocks, multi_grid, wm)
        for block_name, i, spec, rate in stack_blocks_dense(blocks, cfg.output_stride):
            name = f"{block_name}_unit{i + 1}"
            self.add_module(name, BottleneckUnit(channels, spec, rate, **common))
            self.unit_names.append(name)
            self.block_ends[block_name] = name
            channels = spec.depth
        self.out_channels = channels
        self.skip_channels = blocks[0].units[0].depth

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        end_points: Dict[str, torch.Tensor] = {}
        x = self.conv1_3(self.conv1_2(self.conv1_1(x)))
        x = max_pool_same(x, 3, 2)
        x = self.postnorm(x, act="relu")
        end_points["root"] = x
        last_of = {unit: block for block, unit in self.block_ends.items()}
        for name in self.unit_names:
            x, residual = getattr(self, name)(x)
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
        common = dict(bn_epsilon=cfg.batch_norm_epsilon, bn_scale=cfg.batch_norm_scale)
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
        pooled = self.pool_conv_1x1(x.mean(dim=(1, 2), keepdim=True))
        a5 = upsample(pooled, out_size)
        return self.project(torch.cat([a1, a2, a3, a4, a5], dim=-1))


class ResNetSegmentation(nn.Module):
    """Backbone + ASPP + DeepLabV3+ decoder with the block1 skip, producing
    per-pixel float32 logits [B, H, W, 1] at input resolution from NHWC
    input [B, H, W, input_channels]. The head's submodules (``aspp``,
    ``decoder_conv_1x1``, ``decoder_conv_3x3``) sit at the top level, as
    ``deeplab_head`` binds them in flax."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        require_supported(config)
        self.config = config
        self.backbone = ResNetBackbone(config, SEGMENTATION_MULTI_GRID)
        common = dict(bn_epsilon=config.batch_norm_epsilon, bn_scale=config.batch_norm_scale)
        self.aspp = ASPP(config, self.backbone.out_channels)
        self.decoder_conv_1x1 = ConvBN(self.backbone.skip_channels, config.base_depth, 1, **common)
        self.decoder_conv_3x3 = nn.Conv2d(2 * config.base_depth, 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        end_points = self.backbone(x.float())
        return deeplab_head(self, end_points["features"], end_points["block1_unit1_residual"])


def deeplab_head(net: nn.Module, features: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Shared DeepLabV3+ head over ``net``'s ``aspp``/``decoder_conv_1x1``/
    ``decoder_conv_3x3``: ASPP, upsample to the skip's resolution, 1x1
    projected skip concat, 3x3 fuse to one channel, bilinear upsample to the
    configured input resolution in float32."""
    aspp = net.aspp(features)
    aspp_up = upsample(aspp, skip.shape[1:3])
    decoder = torch.cat([net.decoder_conv_1x1(skip), aspp_up], dim=-1)
    decoder = conv2d_same(decoder, net.decoder_conv_3x3.weight, net.decoder_conv_3x3.bias)
    return upsample(decoder.float(), net.config.input_shape).contiguous()
