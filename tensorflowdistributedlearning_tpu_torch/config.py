"""Typed model configuration (counterpart of
``tensorflowdistributedlearning_tpu/config.py``).

``ModelConfig`` mirrors the JAX package's field for field, with the same
defaults and the same ``__post_init__`` checks, so one JSON config drives
both packages. ``TrainConfig`` arrives with the training slice. This slice
serves the ResNet segmentation family in float32; the knobs it does not run
yet are rejected by :func:`require_supported` with the queue item that will
bring them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (see the JAX package's ``ModelConfig`` for
    the provenance of each default)."""

    backbone: str = "resnet"  # "resnet" | "xception" | "vit"
    weight_decay: float = 0.001
    batch_norm_decay: float = 0.99
    batch_norm_epsilon: float = 0.001
    batch_norm_scale: bool = True
    output_stride: int = 8
    input_shape: Tuple[int, int] = (101, 101)
    input_channels: int = 2
    base_depth: int = 256
    n_blocks: Tuple[int, ...] = (3, 4, 6)
    block_layout: str = "reference"
    block_type: str = "bottleneck"
    num_classes: Optional[int] = None
    dtype: str = "float32"
    # route each depthwise conv to the hand-written CUDA kernel (True) or to
    # the grouped-conv plain version (False); parameters are identical
    use_pallas_depthwise: bool = False
    remat: bool = False
    stem_space_to_depth: bool = False
    width_multiplier: float = 1.0
    patch_size: int = 16
    embed_dim: int = 384
    vit_layers: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    use_fused_attention: bool = False
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        # JSON round trips hand back lists; keep the frozen, hashable tuples
        object.__setattr__(self, "input_shape", tuple(self.input_shape))
        object.__setattr__(self, "n_blocks", tuple(self.n_blocks))
        if self.backbone not in ("resnet", "xception", "vit"):
            raise ValueError(f"Unknown backbone {self.backbone!r}")
        if self.block_type not in ("bottleneck", "basic_block"):
            raise ValueError(f"Unknown block type {self.block_type!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown dtype {self.dtype!r}")
        if self.block_layout not in ("reference", "classic"):
            raise ValueError(f"Unknown block_layout {self.block_layout!r}")
        if self.block_layout == "classic":
            if self.backbone != "resnet":
                raise ValueError("block_layout='classic' applies to backbone='resnet' only")
            if len(self.n_blocks) != 4:
                raise ValueError(
                    "block_layout='classic' expects n_blocks of length 4, "
                    f"e.g. (3, 4, 6, 3) for ResNet-50; got {self.n_blocks}"
                )
        if self.width_multiplier <= 0:
            raise ValueError("width_multiplier must be positive")
        if self.stem_space_to_depth:
            if self.backbone == "vit":
                raise ValueError(
                    "stem_space_to_depth applies to conv stems "
                    "(backbone='resnet'/'xception'); ViT patchification already "
                    "folds pixels into the contraction"
                )
            if self.input_shape[0] % 2 or self.input_shape[1] % 2:
                raise ValueError(
                    f"stem_space_to_depth needs even input dims, got {self.input_shape}"
                )
        if self.moe_experts < 0:
            raise ValueError(f"moe_experts must be >= 0, got {self.moe_experts}")
        if self.moe_experts:
            if self.backbone != "vit":
                raise ValueError(
                    "moe_experts requires backbone='vit' (the MoE FFN replaces "
                    "transformer-block MLPs)"
                )
            if self.vit_layers < 2:
                raise ValueError(
                    "moe_experts needs vit_layers >= 2 (every OTHER block is "
                    "MoE; a 1-layer stack would have none)"
                )

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["input_shape"] = list(self.input_shape)
        d["n_blocks"] = list(self.n_blocks)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown ModelConfig fields: {unknown}")
        return cls(**d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ModelConfig":
        return cls.from_dict(json.loads(text))


# knobs of the JAX package that later slices of the port bring, with the
# ROADMAP queue item that brings each
_LATER = (
    (lambda c: c.backbone == "xception", "backbone='xception' (queue A 12)"),
    (lambda c: c.backbone == "vit", "backbone='vit' (queue A 12, queue B 7)"),
    (lambda c: c.num_classes is not None, "the classification head (queue A 12)"),
    (lambda c: c.dtype == "bfloat16", "dtype='bfloat16' (queue A 11)"),
    (lambda c: c.stem_space_to_depth, "stem_space_to_depth (queue A 3)"),
    (lambda c: c.block_type == "basic_block", "block_type='basic_block' (queue A 3)"),
    (lambda c: c.block_layout == "classic", "block_layout='classic' (queue A 3)"),
)


def require_supported(config: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration this slice of the
    port does not run yet, naming the ROADMAP item that brings it."""
    for test, what in _LATER:
        if test(config):
            raise NotImplementedError(
                f"{what} is not ported yet; this slice serves the float32 "
                "ResNet segmentation model (see ROADMAP.md)"
            )
