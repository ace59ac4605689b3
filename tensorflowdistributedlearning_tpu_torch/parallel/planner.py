"""Parallelism planner: one layout from model + memory budget + topology
(counterpart of the JAX package's ``parallel/planner.py``, its structure
and names kept).

- **Enumerate** candidate ``(dp, tp, pp, spatial, expert, zero1)`` layouts
  over the device topology (:func:`detect_topology`);
- **Reject** the indivisible ones with a named constraint (the reasons'
  strings are the JAX package's, and the pipeline and sequence rules call
  the port's own validators, which raise the JAX texts) and the
  over-budget ones with exact predicted bytes per device. The parameter
  and optimizer-state accounting applies the real spec rules
  (``tensor.tensor_parallel_spec_for_shape``,
  ``zero.weight_update_spec_for_degrees``) to every leaf of the state in
  flax's shapes (:func:`profile_model`), so it equals the JAX planner's
  bytes, and JAX's ``tree_bytes_per_device`` of the placed state, exactly;
- **Score** the survivors with the JAX package's comms-vs-compute cost
  model and constants, and return a :class:`ParallelPlan`, the one object
  both trainers consume (``ParallelPlan.overrides()`` and the run header's
  ``plan``, ``ParallelPlan.header()``).

Entry points: :func:`plan` (pin any subset of the layout, plan the rest),
:func:`plan_for_config` / :func:`validate_config` (the trainers' wrappers;
an explicit layout is validated through the same machinery) and
:func:`render_plan_table` (the ``plan`` command's table).

What differs from the JAX package:

- :func:`profile_model` builds the model on the meta device (no memory is
  touched) and reads every parameter and BatchNorm statistic in flax's
  order through ``zero.flax_layout``; the optimizer state is optax's for
  the configured chain (:func:`_optax_state`): its slots have their
  parameter's shape, and its step counters are optax's int32 scalars, not
  the per-parameter float32 steps torch's Adam keeps. The activation term
  sums every module's output bytes of a meta-device forward through
  forward hooks (flax's ``capture_intermediates``); the module boundaries
  differ, so it is close to JAX's, not equal.
- :func:`detect_topology`: a port rank owns one device, and the ranks of
  one host are its local devices (JAX's process is a host here). See its
  docstring for what ranks that share one card see.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "PlanError",
    "Layout",
    "MeasuredCosts",
    "Topology",
    "ModelProfile",
    "Candidate",
    "ParallelPlan",
    "detect_topology",
    "profile_model",
    "measured_costs_from_workdir",
    "measured_margin_from_workdir",
    "plan",
    "plan_for_config",
    "validate_config",
    "render_plan_table",
]


class PlanError(ValueError):
    """A layout (requested or required) cannot run: the message carries the
    named constraint (e.g. ``model_axis_indivisible``)."""


# -- cost-model constants (the JAX package's) ---------------------------------

# peak bf16 matmul FLOP/s per chip by device_kind substring (the JAX
# package's table, TPUs only; a CUDA card's peak comes from
# obs/profiler.resolve_peak_flops). Unknown kinds fall back to
# DEFAULT_PEAK_FLOPS: only the compute/comms ratio orders candidates.
PEAK_FLOPS_BY_KIND = {
    "v6e": 918e12,
    "v6": 918e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v5": 197e12,
    "v4": 275e12,
    "v3": 123e12,
    "v2": 45e12,
}
DEFAULT_PEAK_FLOPS = 100e12
# per-chip interconnect bandwidth the comm terms divide by
ICI_BYTES_PER_SEC = 4.5e10
# backward-pass factor on live activations; remat trades them back
ACTIVATION_BWD_FACTOR = 2.0
# fixed launch/sync latency per collective op: an accelerator with a real
# interconnect pays the first, a CPU host the second
COLLECTIVE_LATENCY_S = 1e-5
COLLECTIVE_LATENCY_CPU_S = 1e-4
# spatial halo exchange: fraction of the per-chip activation bytes that
# crosses the sequence axis per step
SPATIAL_HALO_FRAC = 0.1

# reject-reason names (stable strings — tests and the CLI table key on them)
REJECT_MODEL_AXIS = "model_axis_indivisible"
REJECT_SPANS_PROCESSES = "batch_shard_spans_processes"
REJECT_BATCH = "batch_indivisible"
REJECT_PROCESS_BATCH = "process_batch_indivisible"
REJECT_GRAD_ACCUM = "grad_accum_indivisible"
REJECT_MICROBATCH = "microbatch_indivisible"
REJECT_PIPELINE = "pipeline_unsupported"
REJECT_SPATIAL = "spatial_stride_indivisible"
REJECT_EXPERT = "expert_mismatch"
REJECT_CONFLICT = "strategy_conflict"
REJECT_BUDGET = "over_budget"
# the soft reject set: a pinned layout failing only these comes back with a
# warning instead of raising
_SOFT_REJECTS = frozenset({REJECT_BUDGET})

# the mesh axis names (parallel/mesh.py's, the JAX package's)
BATCH_AXIS = "batch"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "sequence"


@dataclasses.dataclass(frozen=True)
class Layout:
    """One concrete assignment of every parallelism knob (the fields mirror
    ``TrainConfig``; ``data_parallel`` is derived, carried for display)."""

    data_parallel: int
    model_parallel: int = 1
    pipeline_parallel: int = 1
    sequence_parallel: int = 1
    expert_parallel: int = 1
    weight_update_sharding: bool = False

    @property
    def model_axis(self) -> int:
        """The model axis's degree: tp, pp and ep are mutually exclusive
        riders on it."""
        return max(self.model_parallel, self.pipeline_parallel, self.expert_parallel)

    @property
    def denom(self) -> int:
        return self.model_axis * self.sequence_parallel

    def describe(self) -> str:
        parts = [f"dp{self.data_parallel}"]
        if self.model_parallel > 1:
            parts.append(f"tp{self.model_parallel}")
        if self.pipeline_parallel > 1:
            parts.append(f"pp{self.pipeline_parallel}")
        if self.sequence_parallel > 1:
            parts.append(f"sp{self.sequence_parallel}")
        if self.expert_parallel > 1:
            parts.append(f"ep{self.expert_parallel}")
        if self.weight_update_sharding:
            parts.append("zero1")
        return "x".join(parts)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def _cuda_kind(kind: str) -> bool:
    """Whether ``kind`` names a CUDA card (the port's device kinds are
    ``torch.cuda.get_device_name`` strings, or ``cpu``)."""
    from tensorflowdistributedlearning_tpu_torch.obs.profiler import PEAK_FLOPS_BY_KIND as CARDS

    kind = kind.lower()
    return "nvidia" in kind or any(key in kind for key in CARDS)


@dataclasses.dataclass(frozen=True)
class Topology:
    """The device fabric a plan targets: :func:`detect_topology`'s, or built
    by hand for what-if planning (a TPU ``device_kind`` scores exactly as
    the JAX package's planner scores it)."""

    n_devices: int
    local_device_count: int
    process_count: int = 1
    hbm_bytes_per_device: Optional[int] = None
    device_kind: str = "cpu"

    def peak_flops(self) -> float:
        """The JAX package's table for a TPU kind; a CUDA card's from
        ``obs.profiler.resolve_peak_flops`` (``TFDL_PEAK_FLOPS`` overrides
        it); else :data:`DEFAULT_PEAK_FLOPS`."""
        kind = self.device_kind.lower()
        for key, flops in PEAK_FLOPS_BY_KIND.items():
            if key in kind:
                return flops
        if _cuda_kind(kind):
            from tensorflowdistributedlearning_tpu_torch.obs.profiler import resolve_peak_flops

            return resolve_peak_flops(self.device_kind) or DEFAULT_PEAK_FLOPS
        return DEFAULT_PEAK_FLOPS

    def collective_latency_s(self) -> float:
        """:data:`COLLECTIVE_LATENCY_S` for a TPU and for a CUDA card (a
        card's collectives are NCCL's, over NVLink or PCIe, launched on the
        device as a TPU's are over ICI); :data:`COLLECTIVE_LATENCY_CPU_S`
        for a CPU host."""
        kind = self.device_kind.lower()
        if any(key in kind for key in PEAK_FLOPS_BY_KIND) or _cuda_kind(kind):
            return COLLECTIVE_LATENCY_S
        return COLLECTIVE_LATENCY_CPU_S


def detect_topology(
    n_devices: Optional[int] = None,
    hbm_bytes_per_device: Optional[int] = None,
    device=None,
) -> Topology:
    """The topology of this run: a port rank owns one device, so the
    devices are the world size of the process group (one without one),
    truncated to ``n_devices``, which may not exceed it. A JAX process is a
    host here: the ranks of one host are its local devices
    (``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else every rank; the
    pod shape of ``multihost.process_info``). ``device`` (CUDA when None,
    and then a card is needed) names the kind: the card's
    ``torch.cuda.get_device_name``, or ``cpu``, whose ranks report no
    memory.

    Ranks that share one card (the GPU host's gloo ranks, ``mesh.py``) each
    see their share of it: the per-device memory is the card's
    ``bytes_limit`` (``utils.profiling.memory_stats``) divided by the local
    ranks per card, ceil(local ranks / cards). The latency they pay is a
    CUDA card's (:meth:`Topology.collective_latency_s`), though gloo
    stages their collectives through the host."""
    import torch

    from tensorflowdistributedlearning_tpu_torch.parallel import multihost
    from tensorflowdistributedlearning_tpu_torch.utils.devices import resolve_device

    info = multihost.process_info()
    visible = info["global_device_count"]
    n = visible if n_devices is None else n_devices
    if n > visible:
        raise PlanError(f"requested {n} devices but only {visible} are visible")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", visible))
    if local < 1 or visible % local:
        local = visible
    dev = torch.device("cpu") if device is not None and torch.device(device).type == "cpu" else resolve_device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        kind = torch.cuda.get_device_name(index)
        if hbm_bytes_per_device is None:
            from tensorflowdistributedlearning_tpu_torch.utils.profiling import memory_stats

            try:
                stats = memory_stats([dev]) or {}
            except Exception:  # noqa: BLE001 — a failed allocator probe is not fatal
                stats = {}
            limits = [int(s["bytes_limit"]) for s in stats.values() if s.get("bytes_limit")]
            if limits:
                sharing = -(-local // max(torch.cuda.device_count(), 1))
                hbm_bytes_per_device = min(limits) // sharing
    else:
        kind = "cpu"
    return Topology(
        n_devices=n,
        local_device_count=min(n, local),
        process_count=max(visible // local, 1),
        hbm_bytes_per_device=hbm_bytes_per_device,
        device_kind=kind,
    )


@dataclasses.dataclass(frozen=True)
class Leaf:
    """An abstract leaf: shape and numpy dtype, no storage (the counterpart
    of ``jax.ShapeDtypeStruct`` in a :class:`ModelProfile`'s trees)."""

    shape: Tuple[int, ...]
    dtype: Any = np.float32

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _leaves(tree) -> List[Any]:
    """The leaves (objects with a ``shape``) of a nest of dicts, lists and
    tuples, in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree] if getattr(tree, "shape", None) is not None else []


@dataclasses.dataclass
class ModelProfile:
    """Abstract view of one training state (trees of :class:`Leaf` in flax's
    shapes) plus an activation estimate: everything candidate evaluation
    needs, no device memory touched. Tests build these by hand."""

    params: Any
    batch_stats: Any
    opt_state: Any
    activation_bytes_per_example: int
    param_count: int
    # layer-ish count (leaves of rank 2 and up) for the per-collective
    # latency term
    n_layers: int = 1

    @property
    def params_bytes(self) -> int:
        return _tree_bytes(self.params, lambda s: ())

    @property
    def opt_state_bytes(self) -> int:
        return _tree_bytes(self.opt_state, lambda s: ())


def _leaf_bytes(leaf) -> int:
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return 0
    return int(np.prod(tuple(shape), dtype=np.int64)) * np.dtype(leaf.dtype).itemsize


_NP_DTYPES = {"float32": np.float32, "float64": np.float64, "float16": np.float16, "bfloat16": np.float16,
              "int32": np.int32, "int64": np.int64, "int8": np.int8, "uint8": np.uint8}


def _abstract(shape, dtype) -> Leaf:
    """A :class:`Leaf` of ``shape`` for a torch ``dtype`` (bfloat16 stands as
    a 2-byte numpy type: only its size counts)."""
    return Leaf(tuple(int(d) for d in shape), _NP_DTYPES[str(dtype).replace("torch.", "")])


def _optax_state(params: Dict[str, Leaf], train_config) -> Dict[str, Any]:
    """The leaves of the JAX package's ``make_optimizer`` chain state for
    ``params``: Adam keeps two moments and two int32 counts (its own and
    the schedule's), SGD and LARS a trace and the schedule's count; the
    EMA tracker a copy of the parameters. Clipping, decay and trust-ratio
    masks keep nothing."""
    count = Leaf((), np.int32)
    if train_config.optimizer == "adam":
        state: Dict[str, Any] = {"mu": dict(params), "nu": dict(params), "count": [count, count]}
    else:
        state = {"trace": dict(params), "count": [count]}
    if train_config.ema_decay:
        state["ema"] = dict(params)
    return state


def profile_model(model_config, train_config) -> ModelProfile:
    """Abstract profile of the training state ``(model_config,
    train_config)`` would build: its parameters and BatchNorm statistics in
    flax's shapes (the model built on the meta device, read through
    ``zero.flax_layout``), the optimizer chain's state as optax keeps it,
    and an activation estimate (:func:`_activation_bytes_per_example`).
    Memoized on the model and the optimizer fields that shape its state."""
    return _profile_model_cached(model_config, train_config.optimizer, bool(train_config.ema_decay))


@functools.lru_cache(maxsize=64)
def _profile_model_cached(model_config, optimizer: str, ema: bool) -> ModelProfile:
    import torch

    from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
    from tensorflowdistributedlearning_tpu_torch.models import model_for
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm
    from tensorflowdistributedlearning_tpu_torch.parallel.zero import flax_layout
    from tensorflowdistributedlearning_tpu_torch.utils.params import count_params

    # the plain arms: a meta tensor launches no kernel
    plain = dataclasses.replace(model_config, use_pallas_depthwise=False, use_fused_attention=False)
    with torch.device("meta"):
        model = model_for(plain).eval()
    params: Dict[str, Leaf] = {}
    stats: Dict[str, Leaf] = {}
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for name, p in module.named_parameters(recurse=False):
            params[prefix + name] = _abstract(flax_layout(module, name, tuple(p.shape))[0], p.dtype)
        if isinstance(module, BatchNorm):
            for name, b in module.named_buffers(recurse=False):
                stats[prefix + name] = _abstract(b.shape, b.dtype)
    opt_state = _optax_state(params, TrainConfig(optimizer=optimizer, ema_decay=0.9 if ema else 0.0))
    n_layers = sum(1 for leaf in params.values() if leaf.ndim >= 2)
    return ModelProfile(
        params=params,
        batch_stats=stats,
        opt_state=opt_state,
        activation_bytes_per_example=_activation_bytes_per_example(model, model_config),
        param_count=count_params(params),
        n_layers=max(n_layers, 1),
    )


def _activation_bytes_per_example(model, model_config) -> int:
    """The input's bytes plus every module's output bytes (forward hooks on
    a meta-device eval forward of one example): the counterpart of the
    JAX package's captured-intermediates sum. Falls back to 64 times the
    input when the forward cannot run on the meta device."""
    import torch

    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm

    h, w = model_config.input_shape
    sample = Leaf((1, h, w, model_config.input_channels), np.float32)
    input_bytes = _leaf_bytes(sample)
    total = [0]

    def hook(module, inputs, output):
        for t in _leaves(output):
            if isinstance(t, torch.Tensor):
                total[0] += t.numel() * t.element_size()

    # BatchNorm in training mode computes in plain ops (its eval arm is the
    # CUDA kernel, which a meta tensor cannot launch); the shapes are eval's
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.train()
    handles = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        with torch.no_grad():
            model(torch.empty(sample.shape, device="meta"))
        return int(input_bytes + total[0])
    except Exception:  # noqa: BLE001 — an estimate, not a gate
        return int(input_bytes * 64)
    finally:
        for handle in handles:
            handle.remove()


# -- exact shard accounting --------------------------------------------------


def _tree_bytes(tree, spec_for_shape, sizes: Optional[Dict[str, int]] = None) -> int:
    """Per-device bytes of an abstract tree under a spec rule: each
    dimension named in a leaf's spec divides by the product of its axes'
    degrees (the rules shard divisible dimensions only, so this is exact)."""
    sizes = sizes or {}
    total = 0
    for leaf in _leaves(tree):
        dims = list(leaf.shape)
        for i, names in enumerate(spec_for_shape(tuple(leaf.shape))):
            if names is None:
                continue
            for name in names if isinstance(names, tuple) else (names,):
                dims[i] //= sizes.get(name, 1)
        total += int(np.prod(dims, dtype=np.int64)) * np.dtype(leaf.dtype).itemsize
    return total


def _weight_update_spec(shape: Tuple[int, ...], dp: int, tp: int) -> Tuple:
    """JAX's ``weight_update_spec_for_degrees`` as a spec tuple, from the
    port's rules: the model axis on ``tensor.model_dim``, the batch axis
    on ``zero.weight_update_spec_for_degrees``'s dimension (stacked as
    ``(model, batch)`` where the two coincide)."""
    from tensorflowdistributedlearning_tpu_torch.parallel.tensor import model_dim
    from tensorflowdistributedlearning_tpu_torch.parallel.zero import weight_update_spec_for_degrees

    spec: List[Any] = [None] * len(shape)
    model = model_dim(shape, tp) if tp > 1 else None
    if model is not None:
        spec[model] = MODEL_AXIS
    batch = weight_update_spec_for_degrees(shape, dp=dp, tp=tp)
    if batch is not None:
        spec[batch] = (MODEL_AXIS, BATCH_AXIS) if batch == model else BATCH_AXIS
    return tuple(spec) if any(s is not None for s in spec) else ()


def _layout_bytes(
    profile: ModelProfile,
    layout: Layout,
    *,
    per_chip_examples: float,
    remat: bool,
) -> Dict[str, int]:
    """Predicted bytes per device per component under ``layout``'s real spec
    rules (replicated / tensor / ZeRO-1, the functions placement uses)."""
    from tensorflowdistributedlearning_tpu_torch.parallel.tensor import tensor_parallel_spec_for_shape

    tp = layout.model_parallel
    sizes = {
        BATCH_AXIS: layout.data_parallel,
        MODEL_AXIS: layout.model_axis,
        SEQUENCE_AXIS: layout.sequence_parallel,
    }
    replicated = lambda shape: ()  # noqa: E731 — the trivial spec rule
    param_rule = (lambda s: tensor_parallel_spec_for_shape(s, tp)) if tp > 1 else replicated
    if layout.weight_update_sharding:
        opt_rule = lambda s: _weight_update_spec(s, layout.data_parallel, tp)  # noqa: E731
    else:
        opt_rule = param_rule
    params_bytes = _tree_bytes(profile.params, param_rule, sizes)
    stats_bytes = _tree_bytes(profile.batch_stats, param_rule, sizes)
    opt_bytes = _tree_bytes(profile.opt_state, opt_rule, sizes)
    act = profile.activation_bytes_per_example * per_chip_examples
    act *= 1.0 if remat else ACTIVATION_BWD_FACTOR
    act /= max(layout.sequence_parallel, 1)
    return {
        "params_bytes_per_chip": params_bytes,
        "batch_stats_bytes_per_chip": stats_bytes,
        "opt_state_bytes_per_chip": opt_bytes,
        "activation_bytes_per_chip": int(act),
        "total_bytes_per_chip": params_bytes + stats_bytes + opt_bytes + int(act),
    }


# -- candidate evaluation ----------------------------------------------------


@dataclasses.dataclass
class Candidate:
    layout: Layout
    feasible: bool = False
    reject_reason: Optional[str] = None
    reject_detail: Optional[str] = None
    bytes: Optional[Dict[str, int]] = None
    headroom_frac: Optional[float] = None
    compute_s: Optional[float] = None
    comm_s: Optional[float] = None
    score: Optional[float] = None
    # the analytic-constants score, kept alongside when `score` was priced
    # with measured rates — the plan table's measured-vs-analytic columns
    score_analytic: Optional[float] = None

    def to_json(self) -> Dict:
        out: Dict = {
            "layout": self.layout.to_json(),
            "feasible": self.feasible,
        }
        if self.reject_reason:
            out["reject_reason"] = self.reject_reason
            if self.reject_detail:
                out["reject_detail"] = self.reject_detail
        if self.bytes:
            out["predicted"] = dict(self.bytes)
        if self.headroom_frac is not None:
            out["headroom_frac"] = self.headroom_frac
        if self.score is not None:
            out["score"] = self.score
        if self.score_analytic is not None:
            out["score_analytic"] = self.score_analytic
        return out


def _check_conflicts(layout: Layout, train_config) -> Optional[Tuple[str, str]]:
    """The strategy mutual-exclusivity matrix (mirroring
    ``TrainConfig.__post_init__`` and the trainers): tp/pp/ep each own the
    model axis exclusively, sequence parallelism is its own execution
    strategy, the GPipe runner owns its own update placement (no ZeRO-1) and
    batch math (no grad accumulation), and the mixing augmentations thread
    extra batch fields only the data/tensor-parallel step carries. Enumerated
    layouts never combine riders, so this primarily guards PINNED combos —
    and keeps auto from choosing a layout the config would then reject."""
    riders = [
        d for d in (
            layout.model_parallel, layout.pipeline_parallel,
            layout.expert_parallel,
        ) if d > 1
    ]
    if len(riders) > 1 or (riders and layout.sequence_parallel > 1):
        return REJECT_CONFLICT, (
            f"{layout.describe()}: tensor/pipeline/expert/sequence "
            "parallelism are mutually exclusive execution strategies over "
            "the same mesh axes (one rider at a time)"
        )
    if layout.pipeline_parallel > 1 and layout.weight_update_sharding:
        return REJECT_CONFLICT, (
            "weight_update_sharding cannot combine with pipeline_parallel: "
            "the GPipe stage runner owns its own update placement"
        )
    accum = getattr(train_config, "grad_accum_steps", 1)
    if accum > 1 and (
        layout.model_parallel > 1 or layout.pipeline_parallel > 1
    ):
        return REJECT_CONFLICT, (
            f"grad_accum_steps={accum} runs inside the shard_map "
            "data/spatial step; the GSPMD tensor-parallel and pipeline "
            "strategies define their own batch math"
        )
    augmentation = getattr(train_config, "augmentation", "flip_crop")
    if augmentation in ("mixup", "cutmix") and (
        layout.sequence_parallel > 1 or layout.pipeline_parallel > 1
    ):
        return REJECT_CONFLICT, (
            f"augmentation={augmentation!r} threads paired-example batch "
            "fields the sequence-parallel and pipeline strategies do not "
            "carry"
        )
    if layout.pipeline_parallel > 1 and getattr(
        train_config, "sync_batch_norm", False
    ):
        return REJECT_CONFLICT, (
            "sync_batch_norm cannot combine with pipeline_parallel: the "
            "GPipe schedule computes BN statistics microbatch-wise"
        )
    return None


def _check_divisibility(
    layout: Layout,
    model_config,
    topo: Topology,
    global_batch: int,
    grad_accum: int,
    microbatches: Optional[int],
) -> Optional[Tuple[str, str]]:
    """First failed (reason, detail) pair, None when the layout divides. The
    rules mirror the execution strategies' own trace-time checks — pipeline
    and spatial delegate to the REAL validators so the constraints can never
    drift apart."""
    n, denom = topo.n_devices, layout.denom
    if n % denom:
        return REJECT_MODEL_AXIS, (
            f"{n} devices not divisible by model_axis*sequence = {denom}"
        )
    if topo.process_count > 1 and topo.local_device_count % denom:
        return REJECT_SPANS_PROCESSES, (
            f"model_axis*sequence = {denom} does not divide the "
            f"{topo.local_device_count} devices local to each process — a "
            "data-parallel shard would span processes"
        )
    # process divisibility first: every valid dp is a multiple of the
    # process count (a batch shard never spans processes), so checking dp
    # first would mask this with the less actionable per-dp message
    if global_batch % topo.process_count:
        return REJECT_PROCESS_BATCH, (
            f"global batch {global_batch} not divisible by process count "
            f"{topo.process_count}"
        )
    dp = layout.data_parallel
    if global_batch % dp:
        return REJECT_BATCH, (
            f"global batch {global_batch} not divisible by data-parallel "
            f"degree {dp}"
        )
    local_bs = global_batch // dp
    if local_bs % grad_accum:
        return REJECT_GRAD_ACCUM, (
            f"per-shard batch {local_bs} not divisible by "
            f"grad_accum_steps={grad_accum}"
        )
    if layout.pipeline_parallel > 1:
        from tensorflowdistributedlearning_tpu_torch.train.pipeline_step import (
            validate_pipeline_config,
        )

        micro = microbatches or layout.pipeline_parallel
        try:
            validate_pipeline_config(
                model_config, layout.pipeline_parallel, micro
            )
        except ValueError as e:
            return REJECT_PIPELINE, str(e)
        if local_bs % micro:
            return REJECT_MICROBATCH, (
                f"per-replica batch {local_bs} not divisible into "
                f"{micro} pipeline microbatches"
            )
    if layout.sequence_parallel > 1:
        from tensorflowdistributedlearning_tpu_torch.parallel.spatial import (
            validate_spatial_config,
        )

        try:
            validate_spatial_config(model_config, layout.sequence_parallel)
        except ValueError as e:
            return REJECT_SPATIAL, str(e)
    if layout.expert_parallel > 1:
        experts = getattr(model_config, "moe_experts", 0)
        if layout.expert_parallel != experts:
            return REJECT_EXPERT, (
                f"expert_parallel={layout.expert_parallel} requires "
                f"moe_experts={layout.expert_parallel} (one expert per "
                f"shard); the model has {experts}"
            )
    return None


@dataclasses.dataclass(frozen=True)
class MeasuredCosts:
    """Measured rates that replace the cost model's analytic constants —
    this box's numbers instead of the public peak table. Read back from the
    continuous profiler's ledgered ``op_roofline`` events
    (:func:`measured_costs_from_workdir`).

    ``flops_per_sec_per_chip`` is the achieved END-TO-END rate (analytic
    step FLOPs over measured step wall) — deliberately not the MXU-only
    rate: it folds in the HBM-bound reality the analytic peak ignores, so
    measured scores are absolute step-time estimates where analytic scores
    are only a relative ordering. ``collective_bytes_per_sec`` is the
    achieved per-chip collective bandwidth from the xplane ``collectives``
    bucket; ``None`` falls back to ``ICI_BYTES_PER_SEC`` (CPU runs, or
    captures whose layout priced no collective volume)."""

    flops_per_sec_per_chip: float
    collective_bytes_per_sec: Optional[float] = None
    captures: int = 0
    source: Optional[str] = None  # the workdir the rooflines came from

    def to_json(self) -> Dict:
        out: Dict = {
            "flops_per_sec_per_chip": self.flops_per_sec_per_chip,
            "captures": self.captures,
        }
        if self.collective_bytes_per_sec is not None:
            out["collective_bytes_per_sec"] = self.collective_bytes_per_sec
        if self.source:
            out["source"] = self.source
        return out


def _cost(
    profile: ModelProfile,
    layout: Layout,
    topo: Topology,
    bytes_per_chip: Dict[str, int],
    global_batch: int,
    microbatches: Optional[int],
    measured: Optional[MeasuredCosts] = None,
) -> Tuple[float, float]:
    """(compute_s, comm_s) for one step under the simple cost model.

    Compute: a dense-proxy ``6 * params * examples`` FLOP count split over
    the chips, inflated by the GPipe bubble ``(K-1)/M`` for pipeline layouts.
    Comms, per chip per step (ring-collective volumes over ICI):

    - data-parallel gradient all-reduce: ``2 * P_chip * (dp-1)/dp`` where
      ``P_chip`` is the per-chip gradient bytes (full params, /tp under TP);
    - ZeRO-1 adds the parameter all-gather ``P_chip * (dp-1)/dp`` (its win is
      memory and 1/dp update compute, which the budget gate prices — at
      equal feasibility plain DP therefore scores no worse, the intended
      tie-break);
    - tensor parallel adds per-layer activation all-reduces, approximated by
      the summed intermediate activations ``2 * A * (tp-1)/tp``;
    - pipeline adds stage-boundary activations ``2 * A / pp``;
    - spatial adds the halo exchange ``SPATIAL_HALO_FRAC * A``;
    - expert parallel adds the token all-to-all ``2 * A * (ep-1)/ep``.

    Every collective additionally pays ``COLLECTIVE_LATENCY_S`` per op:
    data parallel launches ONE bucketed all-reduce, tensor/expert parallel
    launch ~2 per layer — the fixed cost that keeps TP from winning on small
    models where its lower all-reduce volume would otherwise look free.

    With ``measured`` (:class:`MeasuredCosts`, from a prior run's ledgered
    rooflines) the achieved FLOP/s replaces the peak table and the achieved
    collective bandwidth replaces ``ICI_BYTES_PER_SEC`` — same model, this
    box's rates.
    """
    dp = layout.data_parallel
    tp = layout.model_parallel
    act = float(bytes_per_chip["activation_bytes_per_chip"])
    grad_bytes = float(bytes_per_chip["params_bytes_per_chip"])

    flops_per_chip_rate = (
        measured.flops_per_sec_per_chip if measured else topo.peak_flops()
    )
    ici_bytes_per_sec = (
        measured.collective_bytes_per_sec
        if measured and measured.collective_bytes_per_sec
        else ICI_BYTES_PER_SEC
    )
    flops = 6.0 * profile.param_count * global_batch
    compute = flops / topo.n_devices / flops_per_chip_rate
    if layout.pipeline_parallel > 1:
        micro = microbatches or layout.pipeline_parallel
        compute *= 1.0 + (layout.pipeline_parallel - 1) / micro

    comm = 0.0
    latency_ops = 0
    if dp > 1:
        comm += 2.0 * grad_bytes * (dp - 1) / dp
        latency_ops += 1
        if layout.weight_update_sharding:
            comm += grad_bytes * (dp - 1) / dp
            latency_ops += 1
    if tp > 1:
        comm += 2.0 * act * (tp - 1) / tp
        latency_ops += 2 * profile.n_layers
    if layout.pipeline_parallel > 1:
        comm += 2.0 * act / layout.pipeline_parallel
        latency_ops += 2 * (microbatches or layout.pipeline_parallel)
    if layout.sequence_parallel > 1:
        comm += SPATIAL_HALO_FRAC * act
        latency_ops += profile.n_layers
    if layout.expert_parallel > 1:
        ep = layout.expert_parallel
        comm += 2.0 * act * (ep - 1) / ep
        latency_ops += 2 * profile.n_layers
    return (
        compute,
        comm / ici_bytes_per_sec
        + latency_ops * topo.collective_latency_s(),
    )


def _evaluate(
    profile: ModelProfile,
    layout: Layout,
    model_config,
    train_config,
    topo: Topology,
    global_batch: int,
    grad_accum: int,
    microbatches: Optional[int],
    budget_bytes: Optional[int],
    measured_margin_bytes: int = 0,
    measured_costs: Optional[MeasuredCosts] = None,
) -> Candidate:
    cand = Candidate(layout=layout)
    failed = _check_conflicts(layout, train_config) or _check_divisibility(
        layout, model_config, topo, global_batch, grad_accum, microbatches
    )
    if failed:
        cand.reject_reason, cand.reject_detail = failed
        return cand
    local_bs = global_batch // layout.data_parallel
    per_chip_examples = local_bs / max(grad_accum, 1)
    if layout.pipeline_parallel > 1:
        per_chip_examples = local_bs / (
            microbatches or layout.pipeline_parallel
        )
    cand.bytes = _layout_bytes(
        profile,
        layout,
        per_chip_examples=per_chip_examples,
        remat=bool(getattr(model_config, "remat", False)),
    )
    if measured_margin_bytes > 0:
        # the ledgered measured-vs-predicted watermark residual of a PRIOR
        # run (obs/capacity.py): activations/workspace the abstract estimate
        # missed. A separate field (never folded into the per-component
        # predictions — those stay tree_bytes_per_device-exact) that the
        # budget gate adds on top.
        cand.bytes["measured_margin_bytes"] = int(measured_margin_bytes)
        cand.bytes["total_bytes_per_chip"] += int(measured_margin_bytes)
    if budget_bytes:
        cand.headroom_frac = round(
            1.0 - cand.bytes["total_bytes_per_chip"] / budget_bytes, 4
        )
        if cand.bytes["total_bytes_per_chip"] > budget_bytes:
            cand.reject_reason = REJECT_BUDGET
            cand.reject_detail = (
                f"predicted {cand.bytes['total_bytes_per_chip']} bytes/chip "
                f"> budget {budget_bytes}"
                + (
                    f" (incl. {measured_margin_bytes} measured margin)"
                    if measured_margin_bytes > 0 else ""
                )
            )
            return cand
    cand.feasible = True
    compute, comm = _cost(
        profile, layout, topo, cand.bytes, global_batch, microbatches,
        measured=measured_costs,
    )
    cand.compute_s, cand.comm_s = compute, comm
    cand.score = compute + comm
    if measured_costs is not None:
        # keep the analytic score alongside so the plan table can show
        # measured-vs-analytic per candidate (and a re-score is auditable)
        a_compute, a_comm = _cost(
            profile, layout, topo, cand.bytes, global_batch, microbatches
        )
        cand.score_analytic = a_compute + a_comm
    return cand


def _enumerate_layouts(model_config, topo: Topology) -> List[Layout]:
    """Every layout shape the execution strategies can run on ``topo``:
    pure DP, one model-axis rider (tp | pp | ep) OR spatial at each divisor
    of the device count, each with and without ZeRO-1 where it composes
    (dp > 1, not pipeline — the GPipe runner owns its own update placement)."""
    n = topo.n_devices
    divisors = [d for d in range(2, n + 1) if n % d == 0]
    shapes: List[Dict] = [{}]
    shapes += [{"model_parallel": d} for d in divisors]
    if getattr(model_config, "backbone", None) in ("vit", "xception"):
        shapes += [{"pipeline_parallel": d} for d in divisors]
    shapes += [{"sequence_parallel": d} for d in divisors]
    experts = getattr(model_config, "moe_experts", 0)
    if experts and n % experts == 0 and experts > 1:
        shapes.append({"expert_parallel": experts})
    layouts: List[Layout] = []
    for shape in shapes:
        base = Layout(data_parallel=1, **shape)
        # every enumerated shape's denom divides n (divisor-driven); pinned
        # combinations that do not are appended by plan() and rejected with
        # the named constraint
        layout = dataclasses.replace(base, data_parallel=max(n // base.denom, 1))
        layouts.append(layout)
        if layout.data_parallel > 1 and layout.pipeline_parallel == 1:
            layouts.append(
                dataclasses.replace(layout, weight_update_sharding=True)
            )
    return layouts


def _matches_pinned(layout: Layout, pinned: Dict) -> bool:
    return all(getattr(layout, k) == v for k, v in pinned.items())


def _layout_from_pinned(pinned: Dict, topo: Topology) -> Layout:
    base = Layout(data_parallel=1, **pinned)
    denom = base.denom
    dp = topo.n_devices // denom if topo.n_devices % denom == 0 else 1
    return dataclasses.replace(base, data_parallel=max(dp, 1))


def _complexity(layout: Layout) -> Tuple:
    """Deterministic tie-break: at equal score prefer the simpler layout —
    pure DP beats any model-axis rider, no-ZeRO beats ZeRO (nothing to gain
    when memory already fits), lower degrees beat higher."""
    return (
        layout.denom,
        int(layout.weight_update_sharding),
        layout.model_parallel,
        layout.pipeline_parallel,
        layout.sequence_parallel,
        layout.expert_parallel,
    )


@dataclasses.dataclass
class ParallelPlan:
    """The planner's verdict: the chosen layout plus the whole candidate
    table. ``source`` records how it was reached (``auto`` — scored — vs
    ``explicit`` — requested degrees validated through the same machinery)."""

    chosen: Candidate
    candidates: List[Candidate]
    source: str
    global_batch: int
    topology: Topology
    hbm_bytes_per_device: Optional[int]
    warnings: List[str] = dataclasses.field(default_factory=list)
    # the measured rates the scores were priced with (None = analytic
    # constants); `cost_provenance` is the run-header stamp
    measured_costs: Optional[MeasuredCosts] = None

    @property
    def cost_provenance(self) -> str:
        """``"measured"`` when candidate scores were priced with a prior
        run's ledgered roofline rates, ``"analytic"`` for the constants."""
        return "measured" if self.measured_costs is not None else "analytic"

    @property
    def layout(self) -> Layout:
        return self.chosen.layout

    def overrides(self) -> Dict:
        """``dataclasses.replace(TrainConfig, **overrides)`` kwargs applying
        this plan's layout (the single consumption point both trainers use)."""
        lay = self.layout
        return {
            "model_parallel": lay.model_parallel,
            "pipeline_parallel": lay.pipeline_parallel,
            "sequence_parallel": lay.sequence_parallel,
            "expert_parallel": lay.expert_parallel,
            "weight_update_sharding": lay.weight_update_sharding,
        }

    def header(self) -> Dict:
        """The run-header ledger field (``plan`` — see docs/LEDGER_SCHEMA.md):
        layout + predicted bytes/chip + verdict, JSON-clean."""
        out: Dict = {
            "source": self.source,
            "layout": self.layout.to_json(),
            "predicted": dict(self.chosen.bytes or {}),
            "feasible": self.chosen.feasible,
            "candidates_considered": len(self.candidates),
            "candidates_feasible": sum(
                1 for c in self.candidates if c.feasible
            ),
        }
        if self.hbm_bytes_per_device:
            out["hbm_bytes_per_device"] = self.hbm_bytes_per_device
            if self.chosen.headroom_frac is not None:
                out["headroom_frac"] = self.chosen.headroom_frac
        if self.chosen.score is not None:
            out["score"] = round(self.chosen.score, 9)
        out["cost_provenance"] = self.cost_provenance
        if self.measured_costs is not None:
            out["measured_costs"] = self.measured_costs.to_json()
            if self.chosen.score_analytic is not None:
                out["score_analytic"] = round(self.chosen.score_analytic, 9)
        if self.chosen.reject_reason:
            out["reject_reason"] = self.chosen.reject_reason
        if self.warnings:
            out["warnings"] = list(self.warnings)
        return out

    def to_json(self) -> Dict:
        return {
            **self.header(),
            "global_batch": self.global_batch,
            "topology": dataclasses.asdict(self.topology),
            "candidates": [c.to_json() for c in self.candidates],
        }


def plan(
    model_config,
    train_config,
    global_batch: int,
    *,
    topology: Optional[Topology] = None,
    profile: Optional[ModelProfile] = None,
    pinned: Optional[Dict] = None,
    hbm_bytes_per_device: Optional[int] = None,
    source: Optional[str] = None,
    measured_margin_bytes: Optional[int] = None,
    measured_costs: Optional[MeasuredCosts] = None,
    device=None,
) -> ParallelPlan:
    """The engine. ``pinned`` holds the layout fields explicit flags fixed
    (explicit flags always win); the planner fills the rest by score. With
    every field pinned this is the hand-spec validator: a layout failing a
    HARD (divisibility) constraint raises :class:`PlanError` with the named
    reason; an over-budget pinned layout comes back with a warning instead
    (the activation estimate must not veto an explicit request).

    ``measured_margin_bytes`` closes the activation-estimate feedback loop:
    pass a prior run's ledgered measured-vs-predicted watermark residual
    (:func:`measured_margin_from_workdir`) and every candidate's budget check
    adds it on top of the abstract estimate — the elastic coordinator's
    re-plan (parallel/elastic.py) sources it from the workdir it is about to
    resume.

    ``measured_costs`` closes the COST-model loop the same way
    (:func:`measured_costs_from_workdir`): candidate scores are priced with
    a prior run's achieved FLOP/s and collective bandwidth instead of the
    analytic constants, and the plan's ``cost_provenance`` header stamp
    flips to ``"measured"``.

    ``device`` (the port's): the card whose topology :func:`detect_topology`
    reads when no ``topology`` is given (``"cpu"`` plans for CPU ranks)."""
    pinned = dict(pinned or {})
    if topology is None:
        topology = detect_topology(getattr(train_config, "n_devices", None), device=device)
    budget = hbm_bytes_per_device
    if budget is None:
        gb = getattr(train_config, "hbm_budget_gb", None)
        if gb:
            budget = int(gb * (1 << 30))
    if budget is None:
        budget = topology.hbm_bytes_per_device
    if profile is None:
        profile = profile_model(model_config, train_config)
    grad_accum = getattr(train_config, "grad_accum_steps", 1)
    microbatches = getattr(train_config, "pipeline_microbatches", None)

    layouts = _enumerate_layouts(model_config, topology)
    if pinned and not any(_matches_pinned(l, pinned) for l in layouts):
        # a pinned combination outside the enumerated shapes (e.g. an
        # indivisible model-axis degree) still gets evaluated so the
        # rejection carries the named constraint
        layouts.append(_layout_from_pinned(pinned, topology))
    seen = set()
    candidates: List[Candidate] = []
    for layout in layouts:
        if layout in seen:
            continue
        seen.add(layout)
        candidates.append(
            _evaluate(
                profile, layout, model_config, train_config, topology,
                global_batch, grad_accum, microbatches, budget,
                measured_margin_bytes=int(measured_margin_bytes or 0),
                measured_costs=measured_costs,
            )
        )
    matching = [c for c in candidates if _matches_pinned(c.layout, pinned)]
    feasible = [c for c in matching if c.feasible]
    fully_pinned = set(pinned) >= {
        "model_parallel", "pipeline_parallel", "sequence_parallel",
        "expert_parallel", "weight_update_sharding",
    }
    warnings: List[str] = []
    if not feasible:
        rejected = matching or candidates
        soft = [
            c for c in rejected
            if c.reject_reason in _SOFT_REJECTS
        ]
        if fully_pinned and soft:
            # explicit spec over budget: warn, do not veto
            chosen = soft[0]
            warnings.append(
                f"requested layout {chosen.layout.describe()} predicted over "
                f"the HBM budget: {chosen.reject_detail}"
            )
        else:
            reasons = "; ".join(
                f"{c.layout.describe()}: {c.reject_reason}"
                + (f" ({c.reject_detail})" if c.reject_detail else "")
                for c in rejected[:8]
            )
            raise PlanError(
                ("no feasible parallelism layout" if not pinned else
                 "requested parallelism layout is not feasible")
                + f" for {topology.n_devices} device(s), global batch "
                f"{global_batch}: {reasons}"
            )
    else:
        chosen = min(
            feasible, key=lambda c: (c.score, _complexity(c.layout))
        )
    return ParallelPlan(
        chosen=chosen,
        candidates=candidates,
        source=source or ("explicit" if fully_pinned else "auto"),
        global_batch=global_batch,
        topology=topology,
        hbm_bytes_per_device=budget,
        warnings=warnings,
        measured_costs=measured_costs,
    )


def measured_margin_from_workdir(workdir: str) -> Optional[int]:
    """The activation/workspace residual a prior run under ``workdir``
    measured: the last ``memory_watermark`` event's
    ``measured_minus_predicted_bytes`` across every per-process ledger (the
    worst: a plan must fit the hungriest rank). None when no run ledgered
    watermarks or the workdir has no ledger; a negative residual clamps to
    0 (the margin only adds safety)."""
    from tensorflowdistributedlearning_tpu_torch.obs import capacity as capacity_lib
    from tensorflowdistributedlearning_tpu_torch.obs import fleet as fleet_lib

    deltas = []
    try:
        ledgers = fleet_lib.discover_ledgers(workdir)
    except OSError:
        return None
    for led in ledgers:
        marks = capacity_lib.aggregate_watermark_events(led.events)
        if marks and marks.get("measured_minus_predicted_bytes") is not None:
            deltas.append(int(marks["measured_minus_predicted_bytes"]))
    if not deltas:
        return None
    return max(0, max(deltas))


def measured_costs_from_workdir(workdir: str) -> Optional[MeasuredCosts]:
    """Measured cost-model rates from the ``op_roofline`` events a prior run
    under ``workdir`` ledgered (``obs/profiler.py``): the achieved FLOP/s
    per device and, when a capture priced a collective volume, the
    achieved collective bandwidth. Per ledger the last roofline wins,
    across ledgers the minimum. None when the workdir has no ledger or no
    roofline carries an achieved rate."""
    from tensorflowdistributedlearning_tpu_torch.obs import fleet as fleet_lib
    from tensorflowdistributedlearning_tpu_torch.obs.profiler import OP_ROOFLINE_EVENT

    try:
        ledgers = fleet_lib.discover_ledgers(workdir)
    except OSError:
        return None
    flops_rates: List[float] = []
    coll_rates: List[float] = []
    captures = 0
    for led in ledgers:
        last_flops = None
        last_coll = None
        for e in led.events:
            if e.get("event") != OP_ROOFLINE_EVENT:
                continue
            captures += 1
            if e.get("achieved_flops_per_sec_per_chip"):
                last_flops = float(e["achieved_flops_per_sec_per_chip"])
            if e.get("achieved_collective_bytes_per_sec"):
                last_coll = float(e["achieved_collective_bytes_per_sec"])
        if last_flops is not None:
            flops_rates.append(last_flops)
        if last_coll is not None:
            coll_rates.append(last_coll)
    if not flops_rates:
        return None
    return MeasuredCosts(
        flops_per_sec_per_chip=min(flops_rates),
        collective_bytes_per_sec=min(coll_rates) if coll_rates else None,
        captures=captures,
        source=workdir,
    )


def _pinned_from_config(train_config) -> Dict:
    return {
        "model_parallel": train_config.model_parallel,
        "pipeline_parallel": train_config.pipeline_parallel,
        "sequence_parallel": train_config.sequence_parallel,
        "expert_parallel": train_config.expert_parallel,
        "weight_update_sharding": train_config.weight_update_sharding,
    }


def plan_for_config(
    model_config,
    train_config,
    global_batch: int,
    *,
    topology: Optional[Topology] = None,
    profile: Optional[ModelProfile] = None,
    workdir: Optional[str] = None,
    device=None,
) -> ParallelPlan:
    """The trainer-facing entry: ``parallelism='auto'`` plans freely with any
    non-default degree pinned (explicit flags win); ``'explicit'`` validates
    the requested layout through the same machinery.

    ``workdir`` (the run's model dir) closes the measured-costs loop on the
    auto path: when a PRIOR run in the same workdir ledgered rooflines
    (``profile_every_windows``), auto candidates are re-scored with that
    box's achieved rates and the run header's ``cost_provenance`` flips to
    ``"measured"`` — profile once, plan better forever after."""
    if getattr(train_config, "parallelism", "explicit") == "auto":
        pinned = {}
        for k, v in _pinned_from_config(train_config).items():
            # NB: a `v not in (1, False)` filter would drop a pinned ZeRO
            # flag, because True == 1 in Python — compare per-field defaults
            default = False if k == "weight_update_sharding" else 1
            if v != default:
                pinned[k] = v
        measured = None
        if workdir:
            try:
                measured = measured_costs_from_workdir(workdir)
            except Exception:  # noqa: BLE001 — a torn ledger must not block
                measured = None
        return plan(
            model_config, train_config, global_batch,
            topology=topology, profile=profile, pinned=pinned, source="auto",
            measured_costs=measured, device=device,
        )
    return validate_config(
        model_config, train_config, global_batch,
        topology=topology, profile=profile, device=device,
    )


def validate_config(
    model_config,
    train_config,
    global_batch: int,
    *,
    topology: Optional[Topology] = None,
    profile: Optional[ModelProfile] = None,
    device=None,
) -> ParallelPlan:
    """Route a hand spec (or a preset's hardcoded flags) through the planner:
    indivisible degrees fail at parse time with the NAMED constraint; the
    returned plan carries the exact predicted bytes/chip for the run header."""
    return plan(
        model_config, train_config, global_batch,
        topology=topology, profile=profile,
        pinned=_pinned_from_config(train_config), source="explicit",
        device=device,
    )


# -- rendering ---------------------------------------------------------------


def _mb(x: Optional[int]) -> str:
    return f"{x / (1 << 20):9.1f}" if x is not None else "      n/a"


def render_plan_table(p: ParallelPlan) -> str:
    """The ``plan`` CLI's human view: one row per candidate — layout,
    predicted params/opt/activation/total MB per chip, headroom against the
    budget, score — with the chosen row marked and every rejection named."""
    topo = p.topology
    lines = [
        f"== parallelism plan ({p.source}): {topo.n_devices} device(s) "
        f"[{topo.device_kind}], {topo.process_count} process(es), "
        f"global batch {p.global_batch}",
    ]
    if p.hbm_bytes_per_device:
        lines.append(
            f"   HBM budget: {p.hbm_bytes_per_device / (1 << 30):.2f} GiB/chip"
        )
    else:
        lines.append(
            "   HBM budget: none (divisibility-only feasibility; pass "
            "--hbm-gb or run on a backend that reports bytes_limit)"
        )
    measured = p.measured_costs is not None
    if measured:
        mc = p.measured_costs
        rate = f"{mc.flops_per_sec_per_chip / 1e12:.2f} TFLOP/s/chip"
        coll = (
            f", {mc.collective_bytes_per_sec / 1e9:.1f} GB/s collective"
            if mc.collective_bytes_per_sec
            else ""
        )
        lines.append(
            f"   cost provenance: measured ({rate}{coll}; "
            f"{mc.captures} roofline capture(s) from {mc.source})"
        )
    else:
        lines.append(
            "   cost provenance: analytic (peak-FLOPs table + ICI constant; "
            "pass --measured-costs-from WORKDIR to price with ledgered "
            "roofline rates)"
        )
    score_cols = (
        f"{'measured':>12}  {'analytic':>12}" if measured else f"{'score':>12}"
    )
    lines.append(
        f"   {'layout':<22} {'params':>9} {'opt':>9} {'act':>9} "
        f"{'total':>9}  {'headroom':>8}  {score_cols}  verdict"
    )
    order = sorted(
        p.candidates,
        key=lambda c: (
            not c.feasible,
            c.score if c.score is not None else math.inf,
            _complexity(c.layout),
        ),
    )
    for c in order:
        mark = "->" if c.layout == p.layout else "  "
        b = c.bytes or {}
        headroom = (
            f"{c.headroom_frac:8.1%}" if c.headroom_frac is not None else "     n/a"
        )
        score = f"{c.score:12.6f}" if c.score is not None else "         n/a"
        if measured:
            analytic = (
                f"{c.score_analytic:12.6f}"
                if c.score_analytic is not None
                else "         n/a"
            )
            score = f"{score}  {analytic}"
        verdict = (
            "chosen" if c.layout == p.layout else
            ("ok" if c.feasible else
             f"rejected: {c.reject_reason}")
        )
        lines.append(
            f" {mark} {c.layout.describe():<22} "
            f"{_mb(b.get('params_bytes_per_chip'))} "
            f"{_mb(b.get('opt_state_bytes_per_chip'))} "
            f"{_mb(b.get('activation_bytes_per_chip'))} "
            f"{_mb(b.get('total_bytes_per_chip'))}  "
            f"{headroom}  {score}  {verdict}"
        )
        if not c.feasible and c.reject_detail:
            lines.append(f"      {c.reject_detail}")
    for w in p.warnings:
        lines.append(f"   WARNING: {w}")
    lines.append(
        f"   chosen: {p.layout.describe()} "
        f"(MB/chip are per-chip predictions under the real placement specs; "
        f"params+opt match tree_bytes_per_device exactly)"
    )
    return "\n".join(lines)
