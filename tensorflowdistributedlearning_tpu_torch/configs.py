"""Named configurations (counterpart of
``tensorflowdistributedlearning_tpu/configs.py``).

A copy of the JAX package's ``PRESETS``, built on the port's own
``ModelConfig`` and ``TrainConfig`` (the port imports nothing of the JAX
package, plain-data modules included), with the same names, values and
descriptions; ``tests/test_torch_vit.py`` holds every preset's
:meth:`Preset.to_dict` equal to the JAX one. The comments that give the
provenance of each value are the JAX package's. What the port runs of each preset is what
:func:`config.require_supported` and :func:`config.require_supported_training`
accept: every preset; ``resnet50_bf16_8k`` trains with its ZeRO-1
weight-update sharding (``parallel/zero.py``) at whatever world size the
caller launches, and ``vit_s16_moe_imagenet`` with every expert local or,
under ``expert_parallel`` 8, one expert per rank (``parallel/expert.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig


@dataclasses.dataclass(frozen=True)
class Preset:
    model: ModelConfig
    train: TrainConfig
    global_batch: int
    description: str

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model.to_dict(),
            "train": dataclasses.asdict(self.train),
            "global_batch": self.global_batch,
            "description": self.description,
        }


def _imagenet_model(**kw) -> ModelConfig:
    base = dict(
        num_classes=1000,
        input_shape=(224, 224),
        input_channels=3,
        output_stride=None,  # standard stride-32 classification trunk
        dtype="bfloat16",
    )
    base.update(kw)
    return ModelConfig(**base)


# 90 epochs of ImageNet-1k at global batch 1024 (1.28M images): the standard
# ResNet recipe behind the 76%-top-1 north star (BASELINE.md) — SGD Nesterov
# momentum 0.9, lr linearly scaled 0.1 x (batch/256) = 0.4, 5-epoch linear
# warmup, cosine decay to ~0, weight decay 1e-4 on kernels only
# (Goyal et al., arXiv:1706.02677).
_IMAGENET_1K_TRAIN = TrainConfig(
    optimizer="sgd",
    lr=0.4,
    lr_schedule="cosine",
    lr_warmup_steps=6_255,
    lr_decay_steps=112_590,
    label_smoothing=0.1,
    weight_decay=1e-4,
)

PRESETS: Dict[str, Preset] = {
    # the reference's production config: TGS salt segmentation, 5-fold, batch 64,
    # Adam 1e-3 halving each 10k steps (reference: model.py:33, 457-462;
    # Untitled.ipynb cells 7-8)
    "tgs_salt": Preset(
        model=ModelConfig(),
        train=TrainConfig(),
        global_batch=64,
        description="Reference parity: ResNet-v2-beta + DeepLabV3+ head, 101x101x2, "
        "5-fold CV, Lovász hinge (reference: model.py defaults)",
    ),
    "tgs_salt_bf16": Preset(
        model=ModelConfig(dtype="bfloat16"),
        train=TrainConfig(),
        global_batch=64,
        description="TPU-native variant of the reference workload: identical "
        "architecture/loss with bf16 compute (params, loss, and metrics stay "
        "f32; convs/matmuls run at the MXU's bf16 rate)",
    ),
    # BASELINE.json "ResNet-50 single-tower CIFAR-10 (CPU smoke test)"
    "cifar10_smoke": Preset(
        model=ModelConfig(
            num_classes=10,
            input_shape=(32, 32),
            input_channels=3,
            n_blocks=(1, 1, 1),
            base_depth=64,
            output_stride=None,
        ),
        train=TrainConfig(n_folds=2, checkpoint_every_steps=100),
        global_batch=64,
        description="CIFAR-10-shaped smoke config runnable on a CPU mesh",
    ),
    # the elastic/resilience drill shape: one step is milliseconds on a CPU
    # mesh, checkpoints land every 2 steps (dense resume points for
    # kill-and-resize drills), and every step writes a ledger window (the
    # straggler probe needs per-step cross-host comparisons). Micro-sized on
    # purpose: tests/bench_elastic drive REAL multi-process worlds with it.
    "elastic_smoke": Preset(
        model=ModelConfig(
            num_classes=4,
            input_shape=(16, 16),
            input_channels=3,
            n_blocks=(1, 1, 1),
            base_depth=8,
            width_multiplier=0.0625,
            output_stride=None,
        ),
        train=TrainConfig(
            checkpoint_every_steps=2,
            train_log_every_steps=1,
            augmentation="none",
        ),
        global_batch=8,
        description="Micro classification config for elastic-resize and "
        "kill-drill runs: millisecond steps on a CPU mesh, checkpoint "
        "every 2 steps, a ledger window every step",
    ),
    # BASELINE.json "ResNet-50 multi-tower data-parallel (ImageNet-1k)"
    "resnet50_imagenet": Preset(
        model=_imagenet_model(n_blocks=(3, 4, 6)),
        train=_IMAGENET_1K_TRAIN,
        global_batch=1024,
        description="ResNet-50 ImageNet-1k data-parallel, bf16",
    ),
    # Standard-width ResNet-50: the published 25.6M-param architecture that
    # ImageNet numbers (and BASELINE.md's 360 images/sec/chip V100 figure)
    # actually quote. The reference-family presets above run the reference's
    # ~3x-FLOPs wide layout (doubled stage widths + atrous stage,
    # reference: core/resnet.py:330-344); this one is the apples-to-apples
    # benchmark architecture.
    "resnet50_classic_imagenet": Preset(
        model=_imagenet_model(
            n_blocks=(3, 4, 6, 3),
            block_layout="classic",
            # on in the JAX package on TPU evidence; the port computes the
            # same function (layers.SpaceToDepthConv)
            stem_space_to_depth=True,
        ),
        train=_IMAGENET_1K_TRAIN,
        global_batch=1024,
        description="Standard ResNet-50 (classic 64/128/256/512 widths) "
        "ImageNet-1k data-parallel, bf16, space-to-depth stem",
    ),
    # BASELINE.json "ResNet-101 / ResNet-152 deeper variants"
    "resnet101_imagenet": Preset(
        model=_imagenet_model(n_blocks=(3, 4, 23)),
        train=_IMAGENET_1K_TRAIN,
        global_batch=1024,
        description="ResNet-101 ImageNet-1k data-parallel, bf16",
    ),
    "resnet152_imagenet": Preset(
        model=_imagenet_model(n_blocks=(3, 8, 36)),
        train=_IMAGENET_1K_TRAIN,
        global_batch=1024,
        description="ResNet-152 ImageNet-1k data-parallel, bf16",
    ),
    # BASELINE.json "Xception multi-tower data-parallel (ImageNet-1k)"
    "xception41_imagenet": Preset(
        model=_imagenet_model(backbone="xception"),
        train=_IMAGENET_1K_TRAIN,
        global_batch=1024,
        description="Xception-41 ImageNet-1k data-parallel, bf16 (the backbone the "
        "reference shipped broken, fixed here — SURVEY §2.4.8-10)",
    ),
    # Beyond-parity: ViT-S/16 — the transformer classifier whose attention runs
    # as ring attention under sequence_parallel (parallel/ring_attention.py)
    "vit_s16_imagenet": Preset(
        model=_imagenet_model(
            backbone="vit",
            patch_size=16,
            embed_dim=384,
            vit_layers=12,
            num_heads=6,
            # in the port: every attention call goes through the
            # online-softmax kernel (ops/flash_attention.py), at any length
            use_fused_attention=True,
        ),
        # transformers keep Adam (SGD momentum trains ViTs poorly); standard
        # lr 1e-3 + long warmup, sharing the 90-epoch cosine horizon; with
        # weight_decay the chain is AdamW — wd 0.1 is the DeiT/ViT-S recipe
        # (arXiv:2012.12877)
        train=dataclasses.replace(
            _IMAGENET_1K_TRAIN,
            optimizer="adam",
            lr=0.001,
            lr_warmup_steps=10_000,
            weight_decay=0.1,
            # global-norm clip 1.0 — the ViT/DeiT training stabilizer
            # (arXiv:2010.11929 App. B.1; rides the optimizer chain)
            grad_clip_norm=1.0,
        ),
        global_batch=1024,
        description="ViT-S/16 ImageNet-1k, bf16; sequence-parallelizable via "
        "ring attention (--sequence-parallel)",
    ),
    # Beyond-parity: Switch-style MoE ViT — every other block's FFN is a
    # top-1-routed 8-expert MoE with the load-balancing auxiliary loss
    # (arXiv:2101.03961); ~4x the FFN capacity of ViT-S at ~1x the per-token
    # FLOPs. Train data-parallel anywhere, or --expert-parallel 8 to place
    # one expert per chip with all-to-all dispatch.
    "vit_s16_moe_imagenet": Preset(
        model=_imagenet_model(
            backbone="vit",
            patch_size=16,
            embed_dim=384,
            vit_layers=12,
            num_heads=6,
            moe_experts=8,
            # as in vit_s16_imagenet
            use_fused_attention=True,
        ),
        train=dataclasses.replace(
            _IMAGENET_1K_TRAIN,
            optimizer="adam",
            lr=0.001,
            lr_warmup_steps=10_000,
            weight_decay=0.1,
            # global-norm clip 1.0 — the ViT/DeiT training stabilizer
            # (arXiv:2010.11929 App. B.1; rides the optimizer chain)
            grad_clip_norm=1.0,
        ),
        global_batch=1024,
        description="ViT-S/16 Switch-MoE (8 experts, top-1 routing + load-"
        "balancing loss) ImageNet-1k, bf16; expert-parallelizable "
        "(--expert-parallel 8)",
    ),
    # BASELINE.json "ResNet-50 bfloat16 large-batch (8k) on v5e-64 pod"
    "resnet50_bf16_8k": Preset(
        model=_imagenet_model(n_blocks=(3, 4, 6), remat=True),
        # LARS with layer-wise trust ratios is what holds accuracy at batch 8k
        # (You et al., arXiv:1708.03888; the MLPerf ResNet recipe): base lr
        # linear-scaled to the batch, 10-epoch warmup, cosine decay, wd 1e-4
        # masked to kernels (BN/bias excluded from decay AND trust scaling)
        train=TrainConfig(
            optimizer="lars",
            lr=3.2,
            lr_schedule="cosine",
            lr_warmup_steps=1_564,   # 10 epochs
            lr_decay_steps=14_080,
            label_smoothing=0.1,
            weight_decay=1e-4,
            async_checkpointing=True,
            # ZeRO-1: at dp=64 the replicated LARS momentum + master math is
            # pure waste — shard the slots and the update across the data
            # axis (parallel/zero.py; numerics pinned identical by
            # tests/test_zero1.py, per-chip bytes recorded by bench.py)
            weight_update_sharding=True,
        ),
        global_batch=8192,
        description="ResNet-50 bf16 large-batch (8k) pod config (v5e-64: 128/chip), "
        "LARS optimizer, ZeRO-1 weight-update sharding",
    ),
}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise ValueError(
            f"Unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name]


def resnet_depth_blocks(depth: int) -> Tuple[int, int, int]:
    """Stage sizes for the standard ResNet depths (the units before the
    3-unit atrous stage; (3, 4, 6) is ResNet-50), the JAX package's
    ``configs.resnet_depth_blocks``."""
    table = {50: (3, 4, 6), 101: (3, 4, 23), 152: (3, 8, 36)}
    if depth not in table:
        raise ValueError(f"Unsupported ResNet depth {depth}; choose from {sorted(table)}")
    return table[depth]
