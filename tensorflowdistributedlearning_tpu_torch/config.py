"""Typed model configuration (counterpart of
``tensorflowdistributedlearning_tpu/config.py``).

``ModelConfig`` and ``TrainConfig`` mirror the JAX package's field for
field, with the same defaults and the same ``__post_init__`` checks, so one
JSON config drives both packages. The port serves and trains the ResNet
family (the segmenter and the classifier, every block layout, block type
and stem, float32 or bfloat16 compute, with or without ``remat``; on one
device, or data-parallel over ranks with per-rank or synchronized
BatchNorm), the Xception-41 models and the ViT classifier, its Switch-MoE
variant included, in float32 or bfloat16; the knobs it does not run yet
are rejected by :func:`require_supported_training` with the queue item
that will bring them.
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


def require_supported(config: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration the port does not
    run. It runs every model the JAX package builds: the ResNet segmenter
    and classifier (``num_classes``) at every block layout, block type and
    stem, the Xception-41 segmenter and classifier
    (``backbone="xception"``), and the ViT classifier (``backbone="vit"``,
    with or without ``use_fused_attention``, dense or with the Switch-MoE
    blocks of ``moe_experts``), each in float32 or bfloat16 compute. A ViT
    without ``num_classes`` raises ``ValueError`` when it is built, as the
    JAX model does when it is applied. A fused-attention ViT must have a
    head width that the attention kernels are built for (queue C 2 of
    ROADMAP.md)."""
    if config.backbone == "vit" and config.use_fused_attention:
        _require_kernel_head_dim(config)


def _require_kernel_head_dim(config: ModelConfig) -> None:
    """A fused-attention ViT's head width must be one that every attention
    kernel it can reach is built for (``KERNEL_HEAD_DIMS`` by input dtype):
    a bfloat16-compute ViT feeds the bf16 kernel only; a float32-compute one
    feeds the float32 kernel under the ``float32`` spec and the bf16 kernel
    under ``int8-compute``, whose int8 matmuls return bf16. Refused here, at
    the config check, and not at the first forward on the card."""
    import torch

    from tensorflowdistributedlearning_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    if config.embed_dim % config.num_heads:
        return  # the model's build refuses this geometry with its own error
    d = config.embed_dim // config.num_heads
    dtypes = (torch.bfloat16,) if config.dtype == "bfloat16" else (torch.float32, torch.bfloat16)
    allowed = sorted(set.intersection(*(set(KERNEL_HEAD_DIMS[t]) for t in dtypes)))
    if d not in allowed:
        raise NotImplementedError(
            f"use_fused_attention with head width embed_dim / num_heads = {config.embed_dim} / "
            f"{config.num_heads}: the attention kernels take head widths {allowed} (queue C 2 of "
            "ROADMAP.md); use one of them or use_fused_attention=False"
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (see the JAX package's ``TrainConfig``
    for the provenance and meaning of each field and default: Adam under the
    reference's continuous exponential decay, checkpoints every 500 steps,
    eval throttled to >= 300 s).

    The trainers' host loop and observability, as in the JAX package:

    - ``telemetry`` (default on): the run ledger ``telemetry.jsonl`` in the
      model directory (``obs/telemetry.py``) with a ``step_window`` event
      every ``train_log_every_steps`` steps (the data-wait / step /
      fetch-wait split, images/s, ``mfu``, the input queues; its scalars are
      the window's last step's, as TensorBoard's), eval, checkpoint and
      cost events, and a ``memory`` event every
      ``telemetry_memory_every_windows`` windows. The TensorBoard event
      files are written either way (rank 0).
    - ``trace_sample_rate``: the share of step, eval and checkpoint spans
      persisted as ``trace`` events.
    - ``profile_every_windows`` > 0: a ``torch.profiler`` capture of three
      train steps every that many windows, ledgered as ``profile_capture``
      and a ``train`` ``op_roofline``.
    - ``health_monitors`` (default on): the NaN guard, loss-spike,
      step-time and data-starved monitors over the windows, with
      ``nan_guard`` ``warn``, ``abort`` (write the final checkpoint, then
      raise ``HealthAbortError``) or ``off``.
    - ``dispatch_ahead_steps`` (default 2): how many train steps the host
      may launch ahead of the card before it waits on the oldest (under the
      ``fetch_wait`` span); a window's metrics are copied to the host behind
      an event and written at the next boundary. 0 is the synchronous loop:
      each window's metrics are read in place, which waits for the card.

    ``async_checkpointing`` is accepted and has no effect (saves are
    synchronous). ``data_service_workers`` (default 2) sets the streaming
    data service's workers that feed ``Trainer.train``'s folds and
    ``fit``'s record shards (0: the in-line streams); ``augmentation``,
    ``label_smoothing`` and ``eval_holdout_fraction`` (the held-out share of
    the train record shards) act in ``fit()`` only. The knobs that would
    change what a run does and that the port does not run yet raise in
    :func:`require_supported_training`."""

    data_format: str = "NHWC"
    optimizer: str = "adam"  # "adam" | "sgd" (Nesterov) | "lars"
    sgd_momentum: float = 0.9
    weight_decay: float = 0.0
    ema_decay: float = 0.0
    grad_clip_norm: float = 0.0
    grad_accum_steps: int = 1
    label_smoothing: float = 0.0
    augmentation: str = "flip_crop"
    lr: float = 0.001
    lr_schedule: str = "exponential"  # "exponential" | "cosine"
    lr_decay_steps: int = 10_000
    lr_decay_rate: float = 0.5
    lr_warmup_steps: int = 0
    n_devices: Optional[int] = None
    parallelism: str = "explicit"
    hbm_budget_gb: Optional[float] = None
    sequence_parallel: int = 1
    model_parallel: int = 1
    pipeline_parallel: int = 1
    pipeline_microbatches: Optional[int] = None
    expert_parallel: int = 1
    weight_update_sharding: bool = False
    sync_batch_norm: bool = False
    n_folds: int = 5
    seed: int = 42
    save_best: int = 5
    checkpoint_every_steps: int = 500
    eval_throttle_secs: int = 300
    eval_every_steps: Optional[int] = None
    train_log_every_steps: int = 20
    telemetry: bool = True
    compile_cache_dir: Optional[str] = None
    telemetry_memory_every_windows: int = 5
    trace_sample_rate: float = 0.0
    profile_every_windows: int = 0
    health_monitors: bool = True
    nan_guard: str = "warn"
    async_checkpointing: bool = False
    prefetch_depth: int = 2
    dispatch_ahead_steps: int = 2
    data_service_workers: int = 2
    eval_holdout_fraction: float = 0.0

    def __post_init__(self):
        if self.data_format not in ("NCHW", "NHWC"):
            raise ValueError(f"Unknown data format {self.data_format}. Has to be either NCHW or NHWC")
        if self.parallelism not in ("explicit", "auto"):
            raise ValueError(f"parallelism must be 'explicit' or 'auto', got {self.parallelism!r}")
        if self.hbm_budget_gb is not None and self.hbm_budget_gb <= 0:
            raise ValueError(f"hbm_budget_gb must be positive, got {self.hbm_budget_gb}")
        for name in ("sequence_parallel", "model_parallel", "pipeline_parallel", "expert_parallel"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.model_parallel > 1 and self.sequence_parallel > 1:
            raise ValueError(
                "model_parallel and sequence_parallel cannot both exceed 1: the GSPMD tensor-parallel step and "
                "the shard_map spatial step are different execution strategies"
            )
        if self.pipeline_parallel > 1 and (self.model_parallel > 1 or self.sequence_parallel > 1):
            raise ValueError(
                "pipeline_parallel cannot combine with model_parallel or sequence_parallel: the GPipe stage "
                "runner, the GSPMD tensor-parallel step, and the shard_map spatial step are different execution "
                "strategies over the same mesh axes"
            )
        if self.pipeline_microbatches is not None and (
            self.pipeline_microbatches < self.pipeline_parallel or self.pipeline_parallel == 1
        ):
            raise ValueError(
                "pipeline_microbatches requires pipeline_parallel > 1 and at least one microbatch per "
                f"stage (got microbatches={self.pipeline_microbatches}, stages={self.pipeline_parallel})"
            )
        if self.weight_update_sharding and self.pipeline_parallel > 1:
            raise ValueError("weight_update_sharding cannot combine with pipeline_parallel")
        if self.sync_batch_norm and self.pipeline_parallel > 1:
            raise ValueError("sync_batch_norm cannot combine with pipeline_parallel")
        if self.expert_parallel > 1 and (
            self.model_parallel > 1 or self.sequence_parallel > 1 or self.pipeline_parallel > 1
        ):
            raise ValueError(
                "expert_parallel cannot combine with model_parallel, sequence_parallel, or pipeline_parallel: each "
                "owns the model/sequence mesh axes as a different execution strategy"
            )
        if self.augmentation not in ("flip_crop", "crop", "none", "mixup", "cutmix"):
            raise ValueError(f"Unknown augmentation {self.augmentation!r}")
        if self.augmentation in ("mixup", "cutmix") and (self.sequence_parallel > 1 or self.pipeline_parallel > 1):
            raise ValueError(
                f"augmentation={self.augmentation!r} pairs examples through extra per-example batch fields "
                "(labels_b/lam), which the sequence-parallel and pipeline execution strategies do not thread; use "
                "the data/tensor-parallel step"
            )
        if self.lr_schedule not in ("exponential", "cosine"):
            raise ValueError(f"Unknown lr_schedule {self.lr_schedule!r}")
        if self.optimizer not in ("adam", "sgd", "lars"):
            raise ValueError(f"Unknown optimizer {self.optimizer!r}")
        if self.weight_decay < 0:
            raise ValueError(f"weight_decay must be >= 0, got {self.weight_decay}")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.grad_clip_norm < 0:
            raise ValueError(f"grad_clip_norm must be >= 0, got {self.grad_clip_norm}")
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}")
        if self.grad_accum_steps > 1 and (self.model_parallel > 1 or self.pipeline_parallel > 1):
            raise ValueError(
                "grad_accum_steps > 1 runs inside the shard_map data/spatial-parallel step; the GSPMD "
                "tensor-parallel and pipeline strategies define their own batch math"
            )
        for name in ("train_log_every_steps", "checkpoint_every_steps"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.eval_every_steps is not None and self.eval_every_steps < 1:
            raise ValueError(
                "eval_every_steps must be >= 1 (or None for the checkpoint-coupled default), "
                f"got {self.eval_every_steps}"
            )
        if self.eval_throttle_secs < 0:
            raise ValueError(f"eval_throttle_secs must be >= 0, got {self.eval_throttle_secs}")
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.data_service_workers < 0:
            raise ValueError(f"data_service_workers must be >= 0, got {self.data_service_workers}")
        if self.dispatch_ahead_steps < 0:
            raise ValueError(f"dispatch_ahead_steps must be >= 0, got {self.dispatch_ahead_steps}")
        if self.telemetry_memory_every_windows < 1:
            raise ValueError(
                f"telemetry_memory_every_windows must be >= 1, got {self.telemetry_memory_every_windows}"
            )
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError(f"trace_sample_rate must be in [0, 1], got {self.trace_sample_rate}")
        if self.profile_every_windows < 0:
            raise ValueError(f"profile_every_windows must be >= 0, got {self.profile_every_windows}")
        if self.nan_guard not in ("warn", "abort", "off"):
            raise ValueError(f"nan_guard must be one of ('warn', 'abort', 'off'), got {self.nan_guard!r}")
        if not 0.0 <= self.eval_holdout_fraction < 1.0:
            raise ValueError(f"eval_holdout_fraction must be in [0, 1), got {self.eval_holdout_fraction}")


def validate_training_data_format(cfg: TrainConfig) -> None:
    """Reject NCHW at the training boundary, as the JAX package does: the
    input pipeline feeds NHWC by construction; NCHW is honored where arrays
    cross the serving/predict boundary."""
    if cfg.data_format == "NCHW":
        raise ValueError(
            "data_format='NCHW' applies to the serving/predict boundary only; training input is "
            "NHWC by construction. Train with NHWC, then serve with data_format='NCHW'."
        )


# training configurations the port refuses, with the ROADMAP item that
# names each
_REFUSED_TRAINING = (
    (
        lambda m, c: c.model_parallel > 1 and m.backbone == "xception",
        "tensor parallelism (model_parallel > 1) of the Xception-41 models (queue A 12.2) is not trained: the JAX "
        "package's own tensor-parallel step cannot train them (its dropout raises flax's InvalidRngError; "
        "ROADMAP.md, standing findings); the port trains data-, tensor-, pipeline-, expert- and "
        "sequence-parallel otherwise",
    ),
    (
        lambda m, c: c.compile_cache_dir is not None,
        "compile_cache_dir (no compile cache in eager PyTorch) is not ported yet; the port trains data-, tensor-, "
        "pipeline-, expert- and sequence-parallel only (see ROADMAP.md)",
    ),
)


# the Switch-MoE ViT's tensor-parallel step beside data parallelism, which
# needs the process group's size
_MOE_TP_BESIDE_DP = (
    "tensor parallelism (model_parallel > 1) of the Switch-MoE ViT beside data parallelism (queue A 12.2) is not "
    "trained: the JAX package's tensor-parallel step routes the global batch's tokens as one pool, and the port "
    "routes each data index's rows as its own, so capacity and drops would differ (ROADMAP.md, standing "
    "findings); the port trains it tensor-parallel at data_parallel 1, and data- or expert-parallel"
)


def require_supported_layout(model_config: ModelConfig, train_config: TrainConfig, n_devices: int) -> None:
    """Raise ``NotImplementedError`` for a configuration the port refuses
    only on ``n_devices`` ranks: the Switch-MoE ViT at ``model_parallel``
    > 1 with a data-parallel degree above 1."""
    tp = train_config.model_parallel
    if model_config.moe_experts and tp > 1 and n_devices // tp > 1:
        raise NotImplementedError(_MOE_TP_BESIDE_DP)


def require_supported_training(model_config: ModelConfig, train_config: TrainConfig,
                               n_devices: Optional[int] = None) -> None:
    """Raise ``NotImplementedError`` for a model or training configuration
    the port does not train, naming the ROADMAP item. It trains every
    model :func:`require_supported` accepts (the ResNet and Xception-41
    segmenters and classifiers, the ViT classifier, dense or Switch-MoE;
    float32 or bfloat16 compute; ``remat`` per residual unit or
    transformer block) with Adam, SGD or LARS, ``grad_accum_steps`` >= 1,
    on one device or data-parallel, with or without ZeRO-1's sharded
    weight update (``weight_update_sharding``, ``parallel/zero.py``), the
    ResNet models and the dense ViT also tensor-parallel
    (``model_parallel`` > 1, ``parallel/tensor.py``), the MoE ViT so at
    data_parallel 1 (given ``n_devices``, the ranks' count,
    :func:`require_supported_layout` refuses it beside data parallelism:
    queue A 12.2), the dense ViT and the
    Xception-41 classifier also as GPipe pipelines (``pipeline_parallel`` >
    1, ``fit`` only: ``train/pipeline_step.py``, whose
    ``validate_pipeline_config`` raises the JAX package's ``ValueError``
    for any other model), the MoE ViT also expert-parallel
    (``expert_parallel`` > 1, one expert per rank of the model axis,
    ``parallel/expert.py``; it must equal ``moe_experts``, or this raises
    the JAX ``fit``'s ``ValueError``), and every dense model also H-sharded
    over a sequence axis (``sequence_parallel`` > 1,
    ``parallel/spatial.py`` and ``parallel/ring_attention.py``, with or
    without ZeRO-1 over the data axis; ``validate_spatial_config`` raises
    the JAX package's ``ValueError`` for an input height the degree does
    not admit and for the MoE ViT), under every observability knob, with
    the layout given or planned (``parallelism='auto'``,
    ``parallel/planner.py``; the trainers take it resolved). It refuses
    tensor parallelism of the Xception-41 models, which the JAX package's
    step cannot train either (queue A 12.2's standing finding), and
    ``compile_cache_dir``."""
    require_supported(model_config)
    for test, what in _REFUSED_TRAINING:
        if test(model_config, train_config):
            raise NotImplementedError(what)
    if n_devices is not None:
        require_supported_layout(model_config, train_config, n_devices)
    if train_config.expert_parallel > 1 and train_config.expert_parallel != model_config.moe_experts:
        raise ValueError(
            f"expert_parallel={train_config.expert_parallel} requires moe_experts={train_config.expert_parallel} "
            f"(one expert per shard); got moe_experts={model_config.moe_experts}"
        )
    if train_config.sequence_parallel > 1:
        from tensorflowdistributedlearning_tpu_torch.parallel.spatial import validate_spatial_config

        validate_spatial_config(model_config, train_config.sequence_parallel)
    if train_config.pipeline_parallel > 1:
        from tensorflowdistributedlearning_tpu_torch.train.pipeline_step import validate_pipeline_config

        validate_pipeline_config(model_config, train_config.pipeline_parallel,
                                 train_config.pipeline_microbatches or train_config.pipeline_parallel)
