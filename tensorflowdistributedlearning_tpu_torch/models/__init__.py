"""Model factory (counterpart of ``tensorflowdistributedlearning_tpu/models``):
the ResNet and Xception-41 segmenters and classifiers and the ViT
classifier, plain or H-sharded over the sequence group
(:func:`set_spatial`, the JAX ``build_model``'s ``spatial_axis_name``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, require_supported
from tensorflowdistributedlearning_tpu_torch.models.layers import (
    BatchNorm,
    Conv2dSame,
    ConvBN,
    SpaceToDepthConv,
    Dense,
    DepthwiseConv2D,
    SplitSeparableConv2D,
    fixed_padding,
    subsample,
    upsample,
)
from tensorflowdistributedlearning_tpu_torch.models.resnet import (
    ResNetBackbone,
    ResNetClassifier,
    ResNetSegmentation,
)
from tensorflowdistributedlearning_tpu_torch.models.vit import (
    LayerNorm,
    MoEMlp,
    MultiHeadSelfAttention,
    PatchEmbed,
    TransformerBlock,
    ViTClassifier,
    pipeline_stage_fn,
    stack_vit_block_params,
)
from tensorflowdistributedlearning_tpu_torch.models.xception import (
    SeparableConvSame,
    Xception41,
    XceptionBackbone,
    XceptionSegmentation,
)
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike, resolve_device

# flax's truncated_normal initializers cut at +-2 stddev; variance_scaling's
# truncated form divides by the stddev of that truncated unit normal
_TRUNC_STD = 0.87962566103423978


def _trunc_normal(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initializers, drawn from ``generator``: convs (the
    space-to-depth stem's canonical 3x3 filter too) and the ResNet
    classifier's Dense ``logits`` He (variance_scaling(2.0, fan_in,
    truncated_normal)), depthwise kernels (Xception's grouped ones too)
    truncated normal 0.33, pointwise 0.06, biases zero, BN scale one / bias
    zero, running statistics mean 0 / var 1."""
    separable = [m for m in model.modules() if isinstance(m, (SplitSeparableConv2D, SeparableConvSame))]
    pointwise = {id(m.pointwise) for m in separable}
    grouped_depthwise = {id(m.depthwise) for m in separable if isinstance(m, SeparableConvSame)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                if id(m) in pointwise:
                    _trunc_normal(m.weight, 0.06, generator)
                elif id(m) in grouped_depthwise:
                    _trunc_normal(m.weight, 0.33, generator)
                else:
                    fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                    _trunc_normal(m.weight, math.sqrt(2.0 / fan_in) / _TRUNC_STD, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                _trunc_normal(m.weight, math.sqrt(2.0 / m.weight.shape[1]) / _TRUNC_STD, generator)
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


def init_vit_weights(model: ViTClassifier, generator: torch.Generator) -> nn.Module:
    """flax's initializers for the ViT, drawn from ``generator``: Dense and
    patch-conv kernels lecun-normal (variance_scaling(1.0, fan_in,
    truncated_normal)), biases zero, LayerNorm scale one / bias zero,
    ``pos_embedding`` normal with stddev 0.02; an MoE layer's router normal
    with stddev 0.02 and its expert matrices lecun-normal over each
    expert's fan-in (``lecun_normal(batch_axis=(0,))``)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Dense, PatchEmbed)):
                fan_in = m.weight[0].numel()
                _trunc_normal(m.weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD, generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MoEMlp):
                m.router.normal_(0.0, 0.02, generator=generator)
                for w in (m.w_in, m.w_out):
                    _trunc_normal(w, math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD, generator)
                m.b_in.zero_()
                m.b_out.zero_()
        model.pos_embedding.normal_(0.0, 0.02, generator=generator)
    return model


def model_for(config: ModelConfig) -> nn.Module:
    """The uninitialised network of ``config`` on the current default device
    (``torch.device("meta")`` builds a template without memory): the ViT
    classifier for ``backbone="vit"``, else the ResNet or Xception-41
    (``backbone``) classifier with ``num_classes`` and segmentation network
    without."""
    require_supported(config)
    if config.backbone == "vit":
        return ViTClassifier(config)
    if config.backbone == "xception":
        return Xception41(config) if config.num_classes is not None else XceptionSegmentation(config)
    if config.num_classes is not None:
        return ResNetClassifier(config)
    return ResNetSegmentation(config)


def _set_sync_batch_norm(model: nn.Module, sync: bool) -> nn.Module:
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync = sync
    return model


def set_spatial(model: nn.Module) -> nn.Module:
    """Mark ``model``'s H-sharded layers for sequence parallelism, in
    place: for the CNNs the backbone's convs (a k x k one
    then runs through the halo exchange), its BatchNorms (statistics over
    the sequence group) and its stem pool, and the network's gather before
    the segmentation head or global mean before the classifier's logits;
    for the ViT the classifier (position slice, pooled mean) and its
    attention layers (ring attention). The parameters do not change, so a
    plain model's weights and checkpoints serve as they are (the JAX
    ``SpatialConv``'s "param tree is identical to nn.Conv"). Raises the
    JAX ``ConvBN``'s ``ValueError`` for a space-to-depth stem."""
    if isinstance(model, ViTClassifier):
        marked = [model] + [m for m in model.modules() if isinstance(m, MultiHeadSelfAttention)]
    else:
        backbone = model.backbone
        if any(isinstance(m, SpaceToDepthConv) for m in backbone.modules()):
            raise ValueError(
                "space_to_depth reshapes H into channels and cannot compose "
                "with an H-sharded (sequence-parallel) conv"
            )
        marked = [model, backbone] + [m for m in backbone.modules() if isinstance(m, (Conv2dSame, BatchNorm))]
    for m in marked:
        m.spatial = True
    return model


def empty_model(
    config: ModelConfig, device: DeviceLike = None, *, sync_batch_norm: bool = False, spatial: bool = False
) -> nn.Module:
    """The network of ``config`` with its tensors allocated on ``device``
    (CUDA when None) and left uninitialised, in eval mode: built on
    ``torch.device("meta")``, then ``to_empty``. It draws nothing, so it is
    the template of a restore, whose strict ``load_state_dict`` overwrites
    every tensor. ``spatial``: :func:`set_spatial`."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = model_for(config)
    if spatial:
        set_spatial(model)
    return _set_sync_batch_norm(model, sync_batch_norm).to_empty(device=device).eval()


def build_model(
    config: ModelConfig,
    device: DeviceLike = None,
    *,
    generator: Optional[torch.Generator] = None,
    sync_batch_norm: bool = False,
    spatial: bool = False,
) -> nn.Module:
    """The network for ``config`` (:func:`model_for`), initialised from
    ``generator`` (seed 0 when None), in eval mode on ``device`` (CUDA when
    None; raises without it). ``sync_batch_norm``: every BatchNorm takes its
    training statistics over the global batch of a data-parallel run (the
    JAX package's ``bn_axis_name=BATCH_AXIS``). ``spatial``: H-sharded over
    the sequence group (:func:`set_spatial`), with the plain network's
    weights (the draw does not depend on it)."""
    device = resolve_device(device)
    model = _set_sync_batch_norm(model_for(config), sync_batch_norm)
    if spatial:
        set_spatial(model)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if isinstance(model, ViTClassifier):
        model = init_vit_weights(model, generator)
    else:
        model = init_weights(model, generator)
    return model.to(device).eval()


__all__ = [
    "ConvBN",
    "ResNetBackbone",
    "ResNetClassifier",
    "ResNetSegmentation",
    "SplitSeparableConv2D",
    "TransformerBlock",
    "ViTClassifier",
    "Xception41",
    "XceptionBackbone",
    "XceptionSegmentation",
    "build_model",
    "empty_model",
    "fixed_padding",
    "init_vit_weights",
    "init_weights",
    "model_for",
    "pipeline_stage_fn",
    "set_spatial",
    "stack_vit_block_params",
    "subsample",
    "upsample",
]
