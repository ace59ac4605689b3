"""Task heads, optimizers and the train, eval and predict steps
(counterpart of the JAX package's ``train/step.py``).

The JAX step is one jitted SPMD function of (state, batch); here a step is
eager PyTorch on one device that updates the :class:`TrainState` in place
and returns its metric contributions as device-resident ``Mean`` states, so
the loop never waits on the device until it reads them. In a data-parallel
run each rank runs the step on its shard, with the JAX step's collectives
made explicit (``make_train_step(data_parallel=True)``) over the data group
of ``parallel/mesh.py``; under tensor parallelism (``parallel/tensor.py``)
the ranks of a model group run the step on the same rows, their layers'
collectives inside the forward and backward.

Under sequence parallelism (``sequence_parallel = sp`` > 1,
``parallel/spatial.py``) the ranks of a sequence group take the same rows
and each its block of the images' rows (:func:`spatial_batch`, for a
model that ``models.set_spatial`` marked); the model
gathers the blocks before its head, so every rank of the group computes
the same whole logits and the same loss. Every collective's backward is
the transpose of its forward (JAX's autodiff through ``shard_map``), so
the sum over all ranks of their gradients is the gradient of the sum of
all ranks' losses: sp times the data group's. The flat gradient is
therefore averaged over every rank, the data ranks times the sequence ranks
(``mesh.gradient_group``), which is JAX's ``_mean_grads`` (the automatic
psum, then the divide by each axis's size). It holds leaf by leaf: a
backbone leaf's gradient on each rank is sp times its block's share (the
gather's backward sums the group's sp equal cotangents), a head leaf's is
the whole gradient on each rank, and either way the mean over the
sequence ranks is the data group's gradient. ``collectives.pmean``'s
backward is the same mean whichever of the two objectives a docstring
names, so the BatchNorm statistics follow the same rule. The BN running
statistics are identical on the ranks of a sequence group (their
statistics are taken over it), so their mean over the data group is their
mean over every rank; the metric states are summed over the data group
only; the dropout stream is keyed by the data index, never the sequence
index, so the ranks of a group draw one mask.

Semantics kept from the JAX package:

- the segmenter's objective is the per-image Lovász hinge alone, the
  classifier's softmax cross entropy (:class:`ClassificationTask`);
  ``weight_decay`` is
  passed but ``apply_weight_decay`` stays False, as the reference declared an
  l2 regularizer and never minimized it;
- update k uses the learning rate ``schedule(k)``, k = 0, 1, ... (optax
  evaluates its schedule at the pre-increment count);
- ``adam`` is ``torch.optim.Adam`` (optax's eps outside the square root,
  eps_root 0), ``weight_decay > 0`` makes it AdamW with decay on the
  conv and Dense kernels only (:func:`kernel_decay_mask`), ``sgd`` is Nesterov
  momentum (decay before momentum), ``lars`` is ``optax.lars`` (:class:`Lars`:
  masked decay, masked trust ratio, lr, then Nesterov momentum of the
  lr-scaled update), ``grad_clip_norm`` clips the global norm the way
  ``optax.clip_by_global_norm`` does, and ``ema_decay`` tracks an
  exponential moving average of the parameters for eval and export;
- ``grad_accum_steps`` (``make_train_step(accum=)``) splits the batch into
  chunks run in order against the same parameters (BN statistics moving
  chunk by chunk), sums their gradients as ``a + g / accum``, merges their
  metrics, and takes one update (one all-reduce, data-parallel);
- the auxiliary losses a model records in its training forward (the MoE
  ViT's load balancing, ``models.vit.pop_aux_losses``, the JAX step's
  ``aux_loss`` collection) join each chunk's objective and its ``loss``
  metric.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
from tensorflowdistributedlearning_tpu_torch.models.layers import DepthwiseConv2D, dropout_key, synced_batch_norm
from tensorflowdistributedlearning_tpu_torch.models.vit import MoEMlp, pop_aux_losses
from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tensorflowdistributedlearning_tpu_torch.ops import losses as losses_lib
from tensorflowdistributedlearning_tpu_torch.ops import metrics as metrics_lib
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh
from tensorflowdistributedlearning_tpu_torch.parallel import tensor as tensor_lib
from tensorflowdistributedlearning_tpu_torch.train.state import pmean_batch_stats

Metrics = Dict[str, metrics_lib.Mean]


@dataclasses.dataclass(frozen=True)
class SegmentationTask:
    """Binary segmentation: per-image Lovász hinge on the logits; thresholded
    mIoU and pixel accuracy on ``sigmoid(logits) > threshold``."""

    threshold: float = 0.5

    def loss(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return losses_lib.lovasz_loss(batch["labels"], logits, "NHWC")

    def loss_per_example(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return losses_lib.lovasz_hinge_per_image(logits.squeeze(-1).float(), batch["labels"].squeeze(-1))

    def metric_scores(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        predicted = (torch.sigmoid(logits) > self.threshold).float()
        labels = batch["labels"]
        return {
            "metrics/mean_iou": metrics_lib.iou_scores(labels, predicted),
            "metrics/mean_acc": metrics_lib.mean_accuracy_scores(labels, predicted),
        }

    def predictions(self, logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The unfused head: ``sigmoid``, then ``probs > threshold``."""
        probs = torch.sigmoid(logits)
        return {"probabilities": probs, "mask": (probs > self.threshold).float()}

    def serve_predictions(self, logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The serving head: the same outputs as :meth:`predictions`, from one
        pass over the logits through :func:`kernels.fused_sigmoid_mask`
        (bit-identical by contract)."""
        probs, mask = kernels.fused_sigmoid_mask(logits, self.threshold)
        return {"probabilities": probs, "mask": mask}


@dataclasses.dataclass(frozen=True)
class ClassificationTask:
    """Softmax classification (the JAX package's ``ClassificationTask``,
    ``train/step.py:334-389``): cross entropy with ``label_smoothing`` in the
    train loss only (eval is plain cross entropy, so metrics compare across
    smoothing settings); under mixup or cutmix (a batch with ``labels_b``
    and ``lam``) the loss is ``mean(lam·CE(labels) + (1-lam)·CE(labels_b))``;
    top-1 and, with more than 5 classes, top-5 hits."""

    label_smoothing: float = 0.0

    def loss(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "lam" in batch:
            ce_a = losses_lib.softmax_cross_entropy_per_example(logits, batch["labels"], self.label_smoothing)
            ce_b = losses_lib.softmax_cross_entropy_per_example(logits, batch["labels_b"], self.label_smoothing)
            lam = batch["lam"]
            return torch.mean(lam * ce_a + (1.0 - lam) * ce_b)
        return losses_lib.softmax_cross_entropy(logits, batch["labels"], self.label_smoothing)

    def loss_per_example(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return losses_lib.softmax_cross_entropy_per_example(logits, batch["labels"])

    def metric_scores(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        scores = {"metrics/top1": metrics_lib.top1_accuracy_scores(logits, batch["labels"])}
        if logits.shape[-1] > 5:
            scores["metrics/top5"] = metrics_lib.topk_accuracy_scores(logits, batch["labels"], k=5)
        return scores

    def predictions(self, logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``probabilities``: the softmax over the last axis in the logits'
        dtype, as ``jax.nn.softmax`` writes it (``exp(x - max)`` over its
        sum); ``class``: the argmax of the logits as int32 (jnp.argmax's
        dtype), first index on ties."""
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        return {"probabilities": probs, "class": torch.argmax(logits, dim=-1).to(torch.int32)}

    def serve_predictions(self, logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The serving head: :meth:`predictions` (softmax and argmax have no
        fused kernel in the JAX package either)."""
        return self.predictions(logits)


def task_for(config) -> "SegmentationTask | ClassificationTask":
    """The task of a ``ModelConfig``: classification when it has
    ``num_classes``, segmentation otherwise."""
    return ClassificationTask() if config.num_classes is not None else SegmentationTask()


# -- learning rate -----------------------------------------------------------


def make_host_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The configured schedule as a host function of the update count:
    ``exponential`` (lr · rate^(step / decay_steps), continuous) or
    ``cosine`` (optional linear warmup, then cosine decay to 0)."""
    lr = float(cfg.lr)
    if cfg.lr_schedule == "cosine":
        warmup = cfg.lr_warmup_steps
        if warmup == 0:
            decay_steps = max(cfg.lr_decay_steps, 1)

            def sched(step: int) -> float:
                frac = min(max(step, 0), decay_steps) / decay_steps
                return lr * 0.5 * (1.0 + math.cos(math.pi * frac))

            return sched
        decay_steps = max(cfg.lr_decay_steps, warmup + 1)

        def sched(step: int) -> float:
            if step < warmup:
                return lr * max(step, 0) / warmup
            frac = min(step - warmup, decay_steps - warmup) / (decay_steps - warmup)
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))

        return sched
    transition, rate = cfg.lr_decay_steps, cfg.lr_decay_rate

    def sched(step: int) -> float:
        return lr * rate ** (step / transition)

    return sched


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The schedule the optimizer follows. Eager PyTorch sets each update's
    lr from the host, so this is :func:`make_host_lr_schedule`."""
    return make_host_lr_schedule(cfg)


# -- optimizer ---------------------------------------------------------------


# the MoE layer's weight matrices and router, the JAX package's
# _DECAYED_LEAF_NAMES beside ``kernel``
MOE_DECAYED = frozenset({"w_in", "w_out", "router"})


def kernel_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """``{parameter name: decayed}``: True only for the weight matrices, the
    leaves flax names ``kernel`` (``nn.Conv2d``, depthwise and Dense
    weights, the ViT's patch conv) and an MoE layer's ``w_in``, ``w_out``
    and ``router``; BN and LayerNorm scale and bias, every bias (the MoE
    ``b_in`` and ``b_out`` too) and the ViT's ``pos_embedding`` stay
    undecayed."""
    mask = {}
    for mod_name, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            mask[full] = (name == "weight" and isinstance(module, (nn.Conv2d, nn.Linear, DepthwiseConv2D))) or (
                isinstance(module, MoEMlp) and name in MOE_DECAYED)
    return mask


# optax.lars' defaults that the JAX package keeps
LARS_TRUST_COEFFICIENT = 0.001
LARS_EPS = 0.0


class Lars(torch.optim.Optimizer):
    """``optax.lars(lr, weight_decay, weight_decay_mask=m,
    trust_ratio_mask=m, momentum, nesterov=True)`` with the JAX package's
    mask ``m`` = the kernels (:func:`kernel_decay_mask`), update by update:
    for a masked parameter ``u = g + weight_decay·p``, then ``u = u·ratio``
    with ``ratio = trust_coefficient·|p| / (|u| + eps)`` (1 where either
    norm is 0); an unmasked one keeps ``u = g``; then ``u = -lr·u`` and the
    trace ``t = u + momentum·t``, the update ``u + momentum·t`` (Nesterov,
    as the JAX package chains it) added to ``p``. The learning rate scales before the momentum, so this
    is not SGD with a factor. A param group's ``masked`` flag says which
    rule applies; ``state[p]["trace"]`` is optax's ``TraceState.trace``."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay, masked=True))
        # ids of the leaves that are one rank's slice of a parameter: over
        # the data group (ZeRO-1, ``parallel/zero.py``) and over the model
        # group (tensor parallelism); their norms sum over those ranks
        self.sharded: set = set()
        self.model_sharded: set = set()
        self.data_group = None
        self.model_group = None

    def _sharded_norms(self) -> Dict[int, tuple]:
        """``{id(leaf): (|p|, |u|)}`` of the masked sliced leaves, the norms
        of the whole parameter and update: each slice's squared sums, one
        all-reduce over the ranks that hold the leaf's slices (the data
        group, the model group, or every rank for a leaf sliced both
        ways), the square root."""
        todo: Dict[str, list] = {"data": [], "model": [], "both": []}
        for group in self.param_groups:
            if not group["masked"]:
                continue
            for p in group["params"]:
                kind = {(True, False): "data", (False, True): "model", (True, True): "both"}.get(
                    (id(p) in self.sharded, id(p) in self.model_sharded))
                if kind is not None and p.grad is not None:
                    u = p.grad + group["weight_decay"] * p if group["weight_decay"] else p.grad
                    todo[kind].append((p, torch.sum(p * p), torch.sum(u * u)))
        out = {}
        for kind, over in (("data", self.data_group), ("model", self.model_group), ("both", None)):
            if not todo[kind]:
                continue
            sums = torch.stack([s for _, ps, us in todo[kind] for s in (ps, us)])
            collectives.psum_(sums, over)
            norms = torch.sqrt(sums)
            out.update({id(p): (norms[2 * i], norms[2 * i + 1]) for i, (p, _, _) in enumerate(todo[kind])})
        return out

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lars.step takes no closure")
        sharded = self._sharded_norms()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if group["masked"]:
                    if group["weight_decay"]:
                        u = u + group["weight_decay"] * p
                    if id(p) in sharded:
                        p_norm, u_norm = sharded[id(p)]
                    else:
                        p_norm = torch.linalg.vector_norm(p)
                        u_norm = torch.linalg.vector_norm(u)
                    ratio = LARS_TRUST_COEFFICIENT * p_norm / (u_norm + LARS_EPS)
                    u = u * torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)
                u = u * -group["lr"]
                state = self.state[p]
                trace = state.get("trace")
                trace = u if trace is None else u + group["momentum"] * trace
                state["trace"] = trace
                p.add_(u + group["momentum"] * trace)
        return None


def make_optimizer(
    cfg: TrainConfig, model: nn.Module, leaves: Optional[Dict[str, torch.Tensor]] = None
) -> torch.optim.Optimizer:
    """The configured optimizer over ``model``'s parameters, in two param
    groups (decayed kernels first, then the rest) when ``weight_decay > 0``,
    and always for ``lars`` (its masked kernels, then the rest). The lr is
    set per update by :meth:`TrainState.apply_gradients`. ``leaves`` (a
    ZeRO-1 layout's, ``parallel/zero.py``) puts each parameter's update
    leaf, by name, in its place, in the same groups and order."""
    named = [(n, leaves[n] if leaves is not None else p) for n, p in model.named_parameters()]
    if cfg.optimizer == "lars":
        mask = kernel_decay_mask(model)
        groups = [
            {"params": [p for n, p in named if mask[n]], "masked": True},
            {"params": [p for n, p in named if not mask[n]], "masked": False},
        ]
        return Lars(groups, lr=make_lr_schedule(cfg)(0), momentum=cfg.sgd_momentum, weight_decay=cfg.weight_decay)
    if cfg.weight_decay:
        mask = kernel_decay_mask(model)
        groups = [
            {"params": [p for n, p in named if mask[n]], "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
        ]
    else:
        groups = [{"params": [p for _, p in named], "weight_decay": 0.0}]
    lr = make_lr_schedule(cfg)(0)
    if cfg.optimizer == "sgd":
        # optax's Nesterov trace at momentum 0 is plain SGD, which torch's SGD
        # takes only without the Nesterov flag
        return torch.optim.SGD(groups, lr=lr, momentum=cfg.sgd_momentum, nesterov=cfg.sgd_momentum > 0)
    if cfg.weight_decay:
        return torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _scalar_dtype() -> torch.dtype:
    """The dtype torch's Adam keeps its ``step`` in."""
    return torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32


def _slot_shapes(optimizer: torch.optim.Optimizer, group: Dict, p: torch.Tensor) -> Dict[str, tuple]:
    """``{slot: (shape, dtype)}`` that ``optimizer``'s first update
    allocates for the leaf ``p``: Adam's ``step`` (a host scalar),
    ``exp_avg`` and ``exp_avg_sq``; SGD's ``momentum_buffer`` (with
    momentum); LARS's ``trace``."""
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return {"step": ((), _scalar_dtype()), "exp_avg": (tuple(p.shape), p.dtype),
                "exp_avg_sq": (tuple(p.shape), p.dtype)}
    if isinstance(optimizer, torch.optim.SGD):
        return {"momentum_buffer": (tuple(p.shape), p.dtype)} if group["momentum"] else {}
    if isinstance(optimizer, Lars):
        return {"trace": (tuple(p.shape), p.dtype)}
    raise TypeError(f"no slot rule for {type(optimizer).__name__}")


def init_optimizer_slots(optimizer: torch.optim.Optimizer) -> None:
    """Allocate, as zeros, every slot that ``optimizer``'s first update
    would allocate and that it does not hold yet (torch allocates its slots
    lazily; optax's ``init`` at once). The first update from a zero slot is
    the update from none: Adam's moments start at 0, and a zero trace or
    momentum buffer plus the first update is that update."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            for key, (shape, dtype) in _slot_shapes(optimizer, group, p).items():
                if key not in state:
                    device = torch.device("cpu") if key == "step" else p.device
                    state[key] = torch.zeros(shape, dtype=dtype, device=device)


def optimizer_slot_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the slots ``optimizer`` holds once it has taken an update
    (:func:`init_optimizer_slots`' allocation), whether or not torch has
    allocated them yet; under ZeRO-1 its leaves are this rank's slices."""
    total = 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            for shape, dtype in _slot_shapes(optimizer, group, p).values():
                total += math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return total


def clip_by_global_norm(params, max_norm: float, sharded: frozenset = frozenset(), group=None) -> None:
    """``optax.clip_by_global_norm`` in place: gradients unchanged when their
    global l2 norm is below ``max_norm``, else ``g / norm * max_norm``.
    ``sharded`` holds the ids of the parameters that are this rank's slice
    of a leaf split over ``group`` (tensor parallelism): their squared sums
    are summed over the group once, each whole leaf's counted once."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    if sharded:
        whole = [p.grad for p in params if p.grad is not None and id(p) not in sharded]
        sliced = torch.stack([torch.sum(p.grad.float() * p.grad.float()) for p in params
                              if p.grad is not None and id(p) in sharded]).sum()
        collectives.psum_(sliced, group)
        norm = torch.sqrt(sum((torch.sum(g.float() * g.float()) for g in whole), sliced))
    else:
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


# -- metrics -----------------------------------------------------------------


def _l2_penalty(model: nn.Module) -> torch.Tensor:
    """slim-style l2: sum(w²)/2 over the kernels (:func:`kernel_decay_mask`)."""
    mask = kernel_decay_mask(model)
    total = None
    for name, p in model.named_parameters():
        if mask[name]:
            term = 0.5 * torch.sum(p.float() * p.float())
            total = term if total is None else total + term
    return total if total is not None else torch.zeros(())


def _metric_deltas(
    scores: Dict[str, torch.Tensor], loss: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> Metrics:
    """Per-step metric contributions as ``Mean`` states. ``weights`` ([B]
    0/1) excludes padded eval examples; ``loss`` is then per-example [B]."""
    device = loss.device
    out: Metrics = {name: metrics_lib.Mean.empty(device).update(s, weights) for name, s in scores.items()}
    out["loss"] = metrics_lib.Mean.empty(device).update(
        loss if loss.dim() else loss[None], weights if loss.dim() else None
    )
    return out


def merge_metrics(acc: Optional[Metrics], new: Metrics) -> Metrics:
    """Accumulate per-step metric states across steps."""
    if acc is None:
        return new
    return {k: acc[k].merge(v) for k, v in new.items()}


def compute_metrics(acc: Metrics) -> Dict[str, float]:
    """The accumulated means as host floats (one device-to-host copy)."""
    names = list(acc)
    values = torch.stack([acc[k].compute() for k in names]).cpu().tolist()
    return dict(zip(names, values))


# -- steps -------------------------------------------------------------------


def forward_backward(
    state, task, batch: Dict[str, torch.Tensor], *, weight_decay: float = 0.0, apply_weight_decay: bool = False
):
    """The training-mode forward and backward of one batch: gradients land in
    the parameters' ``.grad``, BN running statistics move; returns the loss
    (the model's recorded auxiliary losses included) and the (detached)
    logits. The optimizer is not touched."""
    model = state.model
    model.train()
    state.zero_grad()
    logits = model(batch["images"])
    loss = task.loss(logits, batch)
    for aux in pop_aux_losses(model):
        loss = loss + aux
    if apply_weight_decay and weight_decay:
        loss = loss + weight_decay * _l2_penalty(model)
    loss.backward()
    return loss.detach(), logits.detach()


def psum_metrics(metrics: Metrics) -> Metrics:
    """Total the metric states over every rank, in place (one collective;
    the JAX step's ``_psum_metrics``). Under tensor parallelism the ranks of
    a model group hold states of the same rows, so every total and count is
    ``tp`` times the data group's and the means are the same: summed over
    every rank, they are one on every rank. Under sequence parallelism the
    states are summed over the data group only (the JAX step's psum over
    the batch axis; the ranks of a sequence group hold the same states)."""
    group = mesh.data_group() if mesh.sequence_parallel_degree() > 1 else None
    collectives.psum_([t for m in metrics.values() for t in (m.total, m.count)], group)
    return metrics


def spatial_batch(batch: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """``batch`` (the data slot's rows, whole images) as ``model`` takes
    it on this rank: an H-sharded model (``models.set_spatial``) its
    sequence index's block of the images' rows, every other entry whole
    (``mesh.shard_batch_spatial``); ``batch`` itself for a plain model or
    without a sequence axis."""
    if getattr(model, "spatial", False) and mesh.sequence_parallel_degree() > 1:
        return mesh.shard_batch_spatial(batch, rows=False)
    return batch


def split_batch(batch: Dict[str, torch.Tensor], accum: int):
    """The ``accum`` consecutive row chunks of ``batch`` (the JAX step's
    ``x.reshape((accum, local // accum) + ...)``); entries without the
    batch's leading dimension (a scalar) go to every chunk. Raises
    ``ValueError`` when the rows do not divide."""
    local = batch["images"].shape[0]
    if local % accum:
        raise ValueError(
            f"grad accumulation needs the per-shard batch ({local}) divisible by grad_accum_steps ({accum})"
        )
    n = local // accum
    return [
        {k: v[i * n:(i + 1) * n] if v.dim() and v.shape[0] == local else v for k, v in batch.items()}
        for i in range(accum)
    ]


def dropout_seed(seed: int, step: int, index: int, chunk: int) -> int:
    """The dropout stream's seed for one forward: a pure function of
    (``TrainConfig.seed``, the update count, the data index, the
    accumulation chunk), the four things the JAX step folds into its
    ``dropout`` key (``fold_in(fold_in(fold_in(key(seed), step), batch
    index), chunk)``). A resumed run draws what the uninterrupted one drew;
    data positions draw their own masks for their own rows, and the ranks
    of one model group the same ones."""
    return int(np.random.SeedSequence([seed, step, index, chunk]).generate_state(1, np.uint64)[0] >> 1)


def make_train_step(
    task, *, data_parallel: bool = False, weight_decay: float = 0.0, apply_weight_decay: bool = False,
    accum: int = 1, seed: int = 0, global_batch_norm: bool = False,
):
    """``step(state, batch) -> (state, metrics)``: forward and backward in
    training mode, one optimizer update, metric contributions computed from
    the pre-update logits (as the JAX step computes them). Each chunk's
    forward runs under the ``layers.dropout_key`` of :func:`dropout_seed`
    (``seed`` is ``TrainConfig.seed``).

    ``accum`` > 1 (``TrainConfig.grad_accum_steps``): the batch splits into
    ``accum`` chunks (:func:`split_batch`), each run forward and backward in
    order against the same parameters (the BN running statistics move
    through the chunks in order), their gradients summed as ``a + g /
    accum`` from zero in the flat gradient buffer, their metrics merged;
    then one update, as the JAX step's scan does.

    ``data_parallel``: the step of one rank of a process group, on its shard
    of the global batch (BN on the shard's statistics, or the global batch's
    under ``sync_batch_norm``). The gradient, kept in one flat buffer, is
    averaged over the ranks before the update, so clipping, the update and
    the EMA see the gradient of the global-batch mean loss; the BN running
    statistics are averaged after the update and the metric states summed.
    Without a group every reduction is the identity. A state under ZeRO-1
    (``state.zero``, ``parallel/zero.py``) takes its update sharded, on
    the same averaged gradient.

    The gradient and the BN running statistics reduce over the data group
    (``parallel/mesh.py``): under tensor parallelism each rank's are its
    channel slice's, and the whole leaves' are averaged over the model
    group too (``tensor.pmean_replicated``). Under expert parallelism the
    gradient is averaged over every rank (``mesh.gradient_group``): the
    ranks of an expert group hold the same rows, and their mean is the
    dense step's gradient (``parallel/expert.py``). ``global_batch_norm``
    (``fit``'s tensor-parallel step, ``tensor.make_train_step_gspmd``)
    takes the BN statistics of every forward over the global batch, the
    data group's mean of the moments, so the running statistics need no
    mean after the update."""

    if accum < 1:
        raise ValueError(f"accum must be >= 1, got {accum}")

    def chunk_step(state, chunk: Dict[str, torch.Tensor], index: int) -> Metrics:
        with dropout_key(dropout_seed(seed, state.step, mesh.data_index(), index)), \
                synced_batch_norm(state.model, global_batch_norm):
            loss, logits = forward_backward(
                state, task, chunk, weight_decay=weight_decay, apply_weight_decay=apply_weight_decay
            )
        with torch.no_grad():
            return _metric_deltas(task.metric_scores(logits, chunk), loss)

    def step(state, batch: Dict[str, torch.Tensor]):
        batch = spatial_batch(batch, state.model)
        if data_parallel or accum > 1 or state.zero is not None:
            state.flatten_grads()
        if accum == 1:
            metrics = chunk_step(state, batch, 0)
        else:
            chunks = split_batch(batch, accum)
            total = torch.zeros_like(state.flat_grad)
            metrics = None
            for index, chunk in enumerate(chunks):
                metrics = merge_metrics(metrics, chunk_step(state, chunk, index))
                total.add_(state.flat_grad / accum)
            state.flat_grad.copy_(total)
        if data_parallel:
            collectives.pmean_(state.flat_grad, mesh.gradient_group())
        tensor_lib.pmean_replicated(state)
        state.apply_gradients()
        if data_parallel:
            if not global_batch_norm:
                pmean_batch_stats(state.model)
            psum_metrics(metrics)
        return state, metrics

    return step


def make_eval_step(task, *, data_parallel: bool = False):
    """``step(model, batch) -> metrics``: inference-mode forward (BN on its
    running statistics) and per-example losses, weighted by ``batch['valid']``
    when present; ``data_parallel`` sums the metric states over the
    ranks."""

    def step(model: nn.Module, batch: Dict[str, torch.Tensor]) -> Metrics:
        model.eval()
        batch = spatial_batch(batch, model)
        with torch.no_grad():
            logits = model(batch["images"])
            loss = task.loss_per_example(logits, batch)
            metrics = _metric_deltas(task.metric_scores(logits, batch), loss, batch.get("valid"))
        return psum_metrics(metrics) if data_parallel else metrics

    return step


def make_predict_step(task):
    """``step(model, batch) -> predictions`` in inference mode (under
    sequence parallelism each rank forwards its block of the rows, and
    every rank of the group returns the whole predictions)."""

    def step(model: nn.Module, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.no_grad():
            return task.predictions(model(spatial_batch(batch, model)["images"]))

    return step
