"""Training state (counterpart of the JAX package's ``train/state.py``).

The JAX ``TrainState`` is an immutable pytree of (step, params,
batch_stats, opt_state); here it is the model (parameters and BN running
statistics), its ``torch.optim`` optimizer, the host-side update count, the
lr schedule, and the optional parameter EMA. Steps update it in place.

In a data-parallel run every rank holds a replica: :func:`replicate` copies
rank 0's state to every rank after init and after every restore, the step
averages the gradients before the one update, and
:func:`pmean_batch_stats` averages the BN running statistics after it, so
the replicas stay bitwise equal.

Under ``TrainConfig.weight_update_sharding`` (ZeRO-1, ``parallel/zero.py``)
over more than one rank the state carries a :class:`zero.ZeroLayout`
(``zero``): the parameters and BN statistics stay whole on every rank, the
optimizer's slots and the EMA hold this rank's slices, and the update runs
sharded. :meth:`TrainState.state_dict` gathers the slots and the EMA whole,
in the replicated format, and :meth:`TrainState.load_state_dict` slices a
whole state: a checkpoint does not depend on the layout, and restores into
a replicated state or a ZeRO-1 one at any world size. Both, like
:meth:`TrainState.eval_params` (which gathers the EMA) and
:func:`replicate`, are collectives then: every rank calls them.

Under ``TrainConfig.expert_parallel`` the state is the replicated one:
its MoE layers run one expert per rank of the expert group
(``parallel/expert.py``), and every rank holds and updates every expert's
parameters, as the JAX package's replicated tree.

Under ``TrainConfig.model_parallel`` (tensor parallelism,
``parallel/tensor.py``) the state carries a
:class:`tensor.TensorParallelLayout` (``tp``): the parameters, the BN
running statistics, the slots and the EMA are this rank's channel slices
(ZeRO-1 then slices the slots and the EMA over the data group), the
update, the BN statistics' mean and the metrics reduce over the data
group, and :meth:`TrainState.state_dict` gathers every slice over the
model group: the checkpoint format stays the replicated one at any
``(dp, tp)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm
from tensorflowdistributedlearning_tpu_torch.models.vit import set_expert_group
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
from tensorflowdistributedlearning_tpu_torch.parallel import tensor as tensor_lib
from tensorflowdistributedlearning_tpu_torch.parallel import zero as zero_lib
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike, resolve_device


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    grad_clip_norm: float = 0.0
    ema_decay: float = 0.0
    ema: Optional[Dict[str, torch.Tensor]] = None
    # the parameters' gradients as one buffer (``.grad`` are views into it),
    # made by :meth:`flatten_grads` for the data-parallel step's all-reduce
    flat_grad: Optional[torch.Tensor] = None
    # the ZeRO-1 layout; None when the update is replicated
    zero: Optional[zero_lib.ZeroLayout] = None
    # the tensor-parallel layout; None without tensor parallelism
    tp: Optional[tensor_lib.TensorParallelLayout] = None

    @property
    def sharded(self) -> bool:
        """Whether any part of the state is a slice (ZeRO-1 or tensor
        parallelism): its whole form is then a collective."""
        return self.zero is not None or self.tp is not None

    def param_count(self) -> int:
        """The whole model's parameter count (the slices' wholes under
        tensor parallelism)."""
        if self.tp is None:
            return sum(p.numel() for p in self.model.parameters())
        return sum(self.tp.whole_numel(n, p) for n, p in self.model.named_parameters())

    def model_state_dict(self, model: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
        """The whole ``state_dict`` of ``model`` (default: the state's; an
        eval view of it), gathered over the model group under tensor
        parallelism (a collective then)."""
        sd = (self.model if model is None else model).state_dict()
        return sd if self.tp is None else self.tp.whole_state_dict(sd)

    def optimizer_names(self):
        """The parameter names of the optimizer's leaves, in its index order."""
        if self.zero is not None:
            return self.zero.names_in_order(self.optimizer)
        return tensor_lib.optimizer_names(self.model, self.optimizer)

    def flatten_grads(self) -> torch.Tensor:
        """The flat gradient buffer, allocated on the first call."""
        if self.flat_grad is None:
            self.flat_grad = collectives.flat_grad_buffer(self.model.parameters())
        return self.flat_grad

    def zero_grad(self) -> None:
        """Clear the gradients before a backward: zero the flat buffer in
        place when there is one (its views stay the ``.grad``), else set
        every ``.grad`` to None."""
        if self.flat_grad is not None:
            self.flat_grad.zero_()
        else:
            self.optimizer.zero_grad(set_to_none=True)
            self.model.zero_grad(set_to_none=True)

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``: optional
        global-norm clip, lr = ``schedule(step)``, the update, the EMA, and
        ``step += 1``; sharded under ZeRO-1."""
        from tensorflowdistributedlearning_tpu_torch.train.step import clip_by_global_norm

        if self.zero is not None:
            zero_lib.apply_gradients_sharded(self)
            return
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        if self.grad_clip_norm:
            clip_by_global_norm(params, self.grad_clip_norm, tensor_lib.sharded_param_ids(self),
                                self.tp.group if self.tp is not None else None)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.ema is not None:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    e = self.ema[name]
                    e.copy_(e * self.ema_decay + p * (1.0 - self.ema_decay))
        self.step += 1

    @contextlib.contextmanager
    def eval_params(self):
        """The eval/export view: the EMA parameters swapped in for the
        duration when an EMA is tracked, the live ones otherwise. Under
        ZeRO-1 the EMA's slices are gathered whole first (every rank);
        under tensor parallelism the view holds this rank's slices."""
        if self.ema is None:
            yield self.model
            return
        ema = self.ema
        if self.zero is not None:
            names = sorted(self.ema)
            ema = dict(zip(names, self.zero.gather([(n, self.ema[n]) for n in names])))
        live = {}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                live[name] = p.detach().clone()
                p.copy_(ema[name])
        try:
            yield self.model
        finally:
            with torch.no_grad():
                for name, p in self.model.named_parameters():
                    p.copy_(live[name])

    def state_dict(self) -> Dict:
        """The whole state in the replicated format (under ZeRO-1 the slots
        and the EMA gathered over the data group, under tensor parallelism
        every slice over the model group: a collective)."""
        optimizer, ema = self.optimizer.state_dict(), self.ema
        names = self.optimizer_names()
        if self.zero is not None:
            optimizer, ema = zero_lib.whole_state(self.zero, self.optimizer, self.ema)
        if self.tp is not None:
            optimizer = tensor_lib.whole_optimizer_state(self.tp, names, optimizer)
            if ema is not None:
                ema_names = sorted(ema)
                ema = dict(zip(ema_names, self.tp.gather([(n, ema[n]) for n in ema_names])))
        out = {
            "step": self.step,
            "model": self.model_state_dict(),
            "optimizer_type": type(self.optimizer).__name__,
            "optimizer": optimizer,
        }
        if ema is not None:
            out["ema"] = ema
        return out

    def load_state_dict(self, state: Dict) -> None:
        """Strict restore of a :meth:`state_dict` (raises on a mismatch)."""
        if state.get("optimizer_type") != type(self.optimizer).__name__:
            raise KeyError(
                f"the checkpoint holds {state.get('optimizer_type')} state, the run uses {type(self.optimizer).__name__}"
            )
        if (self.ema is None) != ("ema" not in state):
            raise KeyError("checkpoint and state disagree on whether a parameter EMA is tracked")
        if self.ema is not None:
            missing = set(self.ema) ^ set(state["ema"])
            if missing:
                raise KeyError(f"EMA entries differ: {sorted(missing)[:5]}")
        model_sd, optimizer, ema = state["model"], state["optimizer"], state.get("ema")
        if self.tp is not None:
            model_sd = self.tp.slice_state_dict(model_sd)
            optimizer = tensor_lib.slice_optimizer_state(self.tp, self.optimizer_names(), optimizer)
            if ema is not None:
                ema = {n: self.tp.slice(n, e) for n, e in ema.items()}
        self.model.load_state_dict(model_sd, strict=True)
        if self.zero is not None:
            zero_lib.load_whole_state(self, optimizer, ema)
        else:
            self.optimizer.load_state_dict(optimizer)
            if self.ema is not None:
                with torch.no_grad():
                    for name, e in self.ema.items():
                        e.copy_(ema[name])
        self.step = int(state["step"])


def create_train_state(
    model_config: ModelConfig,
    train_config: TrainConfig,
    device: DeviceLike = None,
    *,
    generator: Optional[torch.Generator] = None,
    state_dict: Optional[Dict[str, torch.Tensor]] = None,
    step: int = 0,
) -> TrainState:
    """A fresh training state on ``device`` (CUDA when None; raises without
    it): the model built from ``generator`` (or, with ``state_dict``, e.g.
    ``utils.convert.from_flax``, allocated without a draw and loaded
    strictly), in training mode, with the configured optimizer at update
    count ``step``."""
    from tensorflowdistributedlearning_tpu_torch.config import require_supported_training
    from tensorflowdistributedlearning_tpu_torch.models import build_model, empty_model

    require_supported_training(model_config, train_config)
    device = resolve_device(device)
    sync = train_config.sync_batch_norm
    if state_dict is None:
        model = build_model(model_config, device, generator=generator, sync_batch_norm=sync)
    else:
        model = empty_model(model_config, device, sync_batch_norm=sync)
        model.load_state_dict(state_dict, strict=True)
    return _state_of(model, train_config, step)


def template_train_state(model_config: ModelConfig, train_config: TrainConfig, device: DeviceLike = None) -> TrainState:
    """The template a restore fills: a training state whose model is
    :func:`models.empty_model` (allocated, not initialised; no draw) with
    the configured optimizer and EMA. ``CheckpointManager.restore_latest``,
    ``restore_best`` and ``restore_best_or_raise`` overwrite every tensor
    (a periodic checkpoint also the optimizer state) or raise; use the
    state only after one of them succeeded."""
    from tensorflowdistributedlearning_tpu_torch.config import require_supported_training
    from tensorflowdistributedlearning_tpu_torch.models import empty_model

    require_supported_training(model_config, train_config)
    model = empty_model(model_config, device, sync_batch_norm=train_config.sync_batch_norm)
    return _state_of(model, train_config, 0)


def _state_of(model: nn.Module, train_config: TrainConfig, step: int) -> TrainState:
    """``model`` in training mode with the configured optimizer, schedule,
    clip and EMA (a copy of its parameters) at update count ``step``; cut
    to this rank's slices under ``model_parallel`` > 1 (the process's mesh,
    ``parallel/mesh.py``) and under ZeRO-1 over more than one data
    position; under ``expert_parallel`` > 1 its MoE layers dispatch over
    the mesh's expert group, the parameters whole on every rank; under
    ``sequence_parallel`` > 1 its backbone runs H-sharded over the mesh's
    sequence group (``models.set_spatial``), the parameters whole on every
    rank (the JAX trainers' plain twin for init: the draw is the plain
    network's)."""
    from tensorflowdistributedlearning_tpu_torch.train.step import make_lr_schedule, make_optimizer

    model.train()
    ema = None
    if train_config.ema_decay:
        ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    state = TrainState(
        model=model,
        optimizer=make_optimizer(train_config, model),
        schedule=make_lr_schedule(train_config),
        step=int(step),
        grad_clip_norm=train_config.grad_clip_norm,
        ema_decay=train_config.ema_decay,
        ema=ema,
    )
    if train_config.model_parallel > 1:
        mesh.init_mesh(train_config.model_parallel)
        tensor_lib.shard_state_tensor_parallel(state, train_config)
    if train_config.expert_parallel > 1:
        mesh.init_mesh_for(train_config)
        set_expert_group(model, mesh.expert_group())
    if train_config.sequence_parallel > 1:
        from tensorflowdistributedlearning_tpu_torch.models import set_spatial

        mesh.init_mesh_for(train_config)
        set_spatial(model)
    if train_config.weight_update_sharding and mesh.data_parallel_degree() > 1:
        zero_lib.shard_state(state, train_config)
    return state


def replicate(state: TrainState) -> TrainState:
    """Copy rank 0's state to every rank, in place (returned): parameters,
    BN running statistics, optimizer state, EMA and update count. A no-op
    without a process group. Under ZeRO-1 or tensor parallelism rank 0's
    whole state (its :meth:`TrainState.state_dict`, gathered first) is
    broadcast and every rank takes its slices of it."""
    if not collectives.is_initialized():
        return state
    if state.sharded:
        whole = state.state_dict()
        tensors = list(whole["model"].values())
        for i in sorted(whole["optimizer"]["state"], key=int):
            slots = whole["optimizer"]["state"][i]
            tensors += [v for _, v in sorted(slots.items()) if isinstance(v, torch.Tensor)]
        if state.ema is not None:
            tensors += [whole["ema"][name] for name in sorted(whole["ema"])]
        collectives.broadcast_(tensors)
        whole["step"] = int(multihost.broadcast_object(state.step))
        state.load_state_dict(whole)
        return state
    tensors = list(state.model.state_dict().values())
    for p in state.model.parameters():
        tensors += [v for _, v in sorted(state.optimizer.state.get(p, {}).items()) if isinstance(v, torch.Tensor)]
    if state.ema is not None:
        tensors += [state.ema[name] for name in sorted(state.ema)]
    collectives.broadcast_(tensors)
    state.step = int(multihost.broadcast_object(state.step))
    return state


def batch_stat_buffers(model: nn.Module):
    """The BN running means and variances of ``model``."""
    return [t for m in model.modules() if isinstance(m, BatchNorm) for t in (m.running_mean, m.running_var)]


def pmean_batch_stats(model: nn.Module) -> None:
    """Average the BN running statistics over the data group, in place (one
    collective), as the JAX step ``pmean``s its new ``batch_stats``."""
    collectives.pmean_(batch_stat_buffers(model), mesh.data_group())
