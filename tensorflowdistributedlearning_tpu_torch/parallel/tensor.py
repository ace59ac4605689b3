"""Tensor (model) parallelism over the channel dimension (counterpart of the
JAX package's ``parallel/tensor.py``).

The JAX package annotates every parameter leaf with a sharding of its
trailing dimension in flax's order over the ``model`` mesh axis (a conv's
``C_out``, a Dense kernel's ``D_out``, a depthwise kernel's ``C``, every
BN vector), wherever the degree divides it, and lets GSPMD insert the
collectives. Here the collectives are written out:

- The rule (:func:`_spec_for_leaf`, :func:`tensor_parallel_spec_for_shape`)
  is JAX's, read on the flax shape of each port tensor
  (:func:`tensor_parallel_specs` maps it through ``zero.flax_layout``, so
  the slice lands on the port dimension that holds flax's trailing one).
  Rank ``(d, m)`` of the ``(dp, tp)`` grid (``parallel/mesh.py``) holds
  block m of every sharded leaf: the elements of JAX's shard on device
  ``d·tp + m``.
- The layers (:func:`shard_model`): every layer that owns a sharded leaf
  runs on this rank's slice of its parameters. A layer that contracts
  over its input channels (a conv, ``ConvBN``, a Dense, the pointwise half
  of a split-separable conv) takes its input marked replicated (the
  backward sums the input's cotangent over the model group), computes its
  own output channels and all-gathers them (:meth:`TensorParallel.column`);
  a per-channel layer (BatchNorm, the depthwise conv) takes its own
  channels of the replicated input, so no communication comes before its
  kernel, and all-gathers its output (:meth:`TensorParallel.channelwise`).
  BatchNorm keeps its statistics and running statistics on its channel
  slice. The ViT's patch conv takes the column form; its LayerNorm's
  leaves (its statistics span the whole row), its position table and the
  Switch-MoE layer's leaves are gathered whole where they are used
  (parameters, not activations: a gather of 196 x 384 floats against one
  of the tokens), and the layer runs its plain form on the whole input.
  Attention runs on whole heads on every rank. A layer
  whose leaves the rule leaves whole runs replicated. Every activation
  between layers is whole on every rank of the model group.
- The state (:func:`shard_state_tensor_parallel`): the parameters, the BN
  running statistics, the optimizer slots and the EMA are this rank's
  slices; ``TrainState.state_dict`` gathers them into the replicated
  format and ``load_state_dict`` slices a whole state
  (:class:`TensorParallelLayout`). ZeRO-1 (``parallel/zero.py``) then
  slices the optimizer state of the sliced leaves over the data group.
- The steps: ``Trainer`` runs the data-parallel step over the data group
  with per-tower BatchNorm (JAX's ``make_train_step(auto_model=True)``);
  ``fit`` runs :func:`make_train_step_gspmd`, whose BatchNorm statistics
  span the global batch (JAX's whole-step ``jit``).

Xception-41 (grouped convs) has no tensor-parallel form: the JAX
package's own step cannot train it tensor-parallel (queue A 12.2's
standing finding), ``config.require_supported_training`` refuses it, and
:func:`shard_model` raises for any layer it has no form for.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh
from tensorflowdistributedlearning_tpu_torch.parallel.zero import flax_layout

MODEL_AXIS = "model"


def _spec_for_leaf(shape: Sequence[int], axes: Sequence[Tuple[str, int]]) -> Tuple:
    """JAX's rule: shard the trailing dimension of ``shape`` over the
    ``(axis name, degree)`` pairs whose degree exceeds 1, dropping pairs
    from the right until their product divides it. Returns the spec as a
    tuple of per-dimension entries (None, a name, or a tuple of names),
    ``()`` for a replicated leaf, as ``tuple(PartitionSpec)`` reads."""
    shape = tuple(shape)
    usable = [(a, d) for a, d in axes if d > 1]
    while usable:
        total = int(np.prod([d for _, d in usable]))
        if shape and shape[-1] % total == 0:
            spec: List[Any] = [None] * len(shape)
            names = tuple(a for a, _ in usable)
            spec[-1] = names if len(names) > 1 else names[0]
            return tuple(spec)
        usable = usable[:-1]
    return ()


def tensor_parallel_spec_for_shape(shape: Sequence[int], tp: int) -> Tuple:
    """The tensor-parallel spec of a leaf of ``shape`` (flax's order) at
    degree ``tp``: JAX's ``tensor_parallel_spec_for_shape``."""
    return _spec_for_leaf(shape, ((MODEL_AXIS, tp),))


def model_dim(shape: Sequence[int], tp: int) -> Optional[int]:
    """The flax dimension of ``shape`` the model axis shards (the trailing
    one), or None."""
    spec = tensor_parallel_spec_for_shape(shape, tp)
    return len(spec) - 1 if spec else None


def _named_leaves(model: nn.Module):
    """``(full name, module, local name, tensor)`` of every parameter and
    buffer of ``model``, under their ``state_dict`` names."""
    for mod_name, module in model.named_modules():
        for name, t in list(module.named_parameters(recurse=False)) + list(module.named_buffers(recurse=False)):
            yield (f"{mod_name}.{name}" if mod_name else name), module, name, t


def tensor_parallel_specs(model: nn.Module, tp: int) -> Dict[str, Optional[int]]:
    """``{state name: the port dimension the model axis shards, or None}``
    for every parameter and BN buffer of the whole ``model`` at degree
    ``tp`` (JAX's ``tensor_parallel_specs`` through ``flax_layout``)."""
    dims: Dict[str, Optional[int]] = {}
    for full, module, name, t in _named_leaves(model):
        flax_shape, axes = flax_layout(module, name, tuple(t.shape))
        dim = model_dim(flax_shape, tp)
        dims[full] = None if dim is None else axes.index(dim)
    return dims


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """What a tensor-parallel layer needs: the degree, this rank's model
    index and the model group (None: the default group)."""

    degree: int
    index: int
    group: Any = None

    def mark(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.mark_replicated(x, self.group)

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.slice_channels(x, self.group)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return collectives.gather_channels(y, self.group)

    def column(self, fn: Callable, x: torch.Tensor) -> torch.Tensor:
        """A layer that contracts over the input channels: ``fn`` of the
        replicated input gives this rank's output channels, gathered."""
        return self.gather(fn(self.mark(x)))

    def channelwise(self, fn: Callable, x: torch.Tensor, *more: Optional[torch.Tensor]) -> torch.Tensor:
        """A per-channel layer: ``fn`` of this rank's channels of ``x``
        (and of each tensor of ``more``, None passing through), gathered."""
        return self.gather(fn(self.slice(x), *(None if t is None else self.slice(t) for t in more)))


class TensorParallelLayout:
    """Rank ``index`` of ``degree``'s slices of a model's state: ``dims``
    (:func:`tensor_parallel_specs`), the slicing of whole tensors and the
    gather of slices over ``group`` (the model group)."""

    def __init__(self, dims: Dict[str, Optional[int]], degree: int, index: int, group=None):
        self.dims = dict(dims)
        self.degree = int(degree)
        self.index = int(index)
        self.group = group

    @property
    def sharded(self) -> List[str]:
        """The names of the state tensors this layout slices."""
        return [n for n, d in self.dims.items() if d is not None]

    def slice(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice (a view) of ``whole``, the whole tensor of the
        state entry ``name``; ``whole`` itself for a replicated entry."""
        dim = self.dims[name]
        if dim is None:
            return whole
        k = whole.shape[dim] // self.degree
        return whole.narrow(dim, self.index * k, k)

    def gather(self, items: Sequence[Tuple[str, torch.Tensor]]) -> List[torch.Tensor]:
        """The whole tensors of ``(state name, this rank's slice)`` pairs,
        in order; a replicated entry's tensor comes back as it is. A
        collective every rank of the model group makes with the same names
        in the same order."""
        out: List[Optional[torch.Tensor]] = [t for _, t in items]
        idx = [i for i, (name, _) in enumerate(items) if self.dims[name] is not None]
        wholes = collectives.gather_blocks([(items[i][1], self.dims[items[i][0]]) for i in idx], self.group)
        for i, whole in zip(idx, wholes):
            out[i] = whole
        return out

    def whole_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A model ``state_dict`` of slices, whole (a collective)."""
        names = list(state_dict)
        return dict(zip(names, self.gather([(n, state_dict[n]) for n in names])))

    def slice_state_dict(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole model ``state_dict`` cut to this rank's slices."""
        return {n: self.slice(n, t) if n in self.dims else t for n, t in state_dict.items()}

    def whole_numel(self, name: str, t: torch.Tensor) -> int:
        """The element count of the whole entry ``name`` of slice ``t``."""
        return t.numel() * (self.degree if self.dims[name] is not None else 1)


def _owns_leaves(module: nn.Module) -> bool:
    return any(True for _ in module.parameters(recurse=False)) or any(True for _ in module.buffers(recurse=False))


def shard_model(model: nn.Module, layout: TensorParallelLayout) -> nn.Module:
    """Cut ``model`` (whole, as every rank built it) to this rank's slices
    in place and give each layer that owns a sharded leaf its
    tensor-parallel form (the layer's ``tp``). Raises
    ``NotImplementedError`` for a layer that owns leaves and has no such
    form, and ``ValueError`` when a layer's leaves disagree on the rule."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import (
        BatchNorm,
        Conv2dSame,
        ConvBN,
        Dense,
        DepthwiseConv2D,
        SplitSeparableConv2D,
    )
    from tensorflowdistributedlearning_tpu_torch.models.vit import LayerNorm, MoEMlp, PatchEmbed, ViTClassifier

    ctx = TensorParallel(layout.degree, layout.index, layout.group)
    prefix = {id(m): n for n, m in model.named_modules()}
    covered: set = set()

    def leaves(module: nn.Module) -> List[str]:
        p = prefix[id(module)]
        return [f"{p}.{n}" if p else n for n, _, _, _ in _named_leaves(module)]

    def unit(module: nn.Module, members: Sequence[nn.Module], names: Optional[List[str]] = None) -> None:
        names = names if names is not None else [n for m in members for n in leaves(m)]
        sharded = {layout.dims[n] is not None for n in names}
        if len(sharded) != 1:
            raise ValueError(f"{prefix[id(module)]}: the leaves of one layer disagree on the tensor-parallel rule")
        if sharded.pop():
            module.tp = ctx
            covered.update(names)

    def visit(module: nn.Module) -> None:
        if isinstance(module, ConvBN):
            unit(module, [module])
        elif isinstance(module, SplitSeparableConv2D):
            visit(module.depthwise)
            unit(module, [module.pointwise, module.pointwise_bn])
        elif isinstance(module, (Dense, DepthwiseConv2D, BatchNorm, LayerNorm, PatchEmbed, MoEMlp)) or (
            isinstance(module, Conv2dSame) and module.groups == 1
        ):
            unit(module, [module])
        elif isinstance(module, ViTClassifier):
            # its own leaf, the position table, is gathered where it is added
            p = prefix[id(module)]
            unit(module, [], [f"{p}.pos_embedding" if p else "pos_embedding"])
            for child in module.children():
                visit(child)
        elif _owns_leaves(module):
            raise NotImplementedError(
                f"{prefix[id(module)] or type(module).__name__} ({type(module).__name__}) has no tensor-parallel "
                "form (queue A 12.2: the grouped convs of Xception-41, which the JAX package's step cannot train "
                "tensor-parallel either)"
            )
        else:
            for child in module.children():
                visit(child)

    visit(model)
    missing = set(layout.sharded) - covered
    if missing:
        raise ValueError(f"sharded leaves outside every tensor-parallel layer: {sorted(missing)[:5]}")
    with torch.no_grad():
        for full, module, name, t in list(_named_leaves(model)):
            if layout.dims[full] is None:
                continue
            local = layout.slice(full, t).clone()
            if name in module._parameters:
                module._parameters[name].data = local
            else:
                module._buffers[name] = local
    return model


def layout_for(model: nn.Module, degree: Optional[int] = None, index: Optional[int] = None,
               group=None) -> TensorParallelLayout:
    """The layout of the whole ``model`` at ``degree`` for model index
    ``index`` (default: the process's mesh, and its model group)."""
    if degree is None:
        lay = mesh.layout()
        if lay.pipeline or lay.expert:
            kind = "a pipeline's stage group" if lay.pipeline else "an expert group"
            raise ValueError(f"the model group is {kind}: no tensor-parallel layout")
        degree, index, group = lay.tp, lay.model_index, lay.model_group
    return TensorParallelLayout(tensor_parallel_specs(model, degree), degree, index, group)


def shard_state_tensor_parallel(state, train_config, degree: Optional[int] = None, index: Optional[int] = None,
                                group=None):
    """``state`` (a fresh or restored replicated ``TrainState``, before any
    ZeRO-1 sharding) cut to this rank's slices, in place and returned: the
    parameters and BN running statistics (:func:`shard_model`), the
    configured optimizer over the sliced parameters with its slots sliced
    from ``state``'s, and the EMA. ``degree`` and ``index`` default to the
    process's mesh (then ``group`` is its model group). JAX's
    ``shard_state_tensor_parallel``."""
    from tensorflowdistributedlearning_tpu_torch.train.step import Lars, make_optimizer

    if state.zero is not None:
        raise ValueError("slice a replicated state for tensor parallelism before its ZeRO-1 sharding")
    layout = layout_for(state.model, degree, index, group)
    names = optimizer_names(state.model, state.optimizer)
    whole_optimizer = state.optimizer.state_dict()
    shard_model(state.model, layout)
    state.optimizer = make_optimizer(train_config, state.model)
    if whole_optimizer["state"]:
        state.optimizer.load_state_dict(slice_optimizer_state(layout, names, whole_optimizer))
    if state.ema is not None:
        state.ema = {name: layout.slice(name, e).clone() for name, e in state.ema.items()}
    state.tp = layout
    state.flat_grad = None
    if isinstance(state.optimizer, Lars):
        # its trust ratio reads the whole leaf's norms
        state.optimizer.model_sharded = sharded_param_ids(state)
        state.optimizer.model_group = layout.group
    return state


def optimizer_names(model: nn.Module, optimizer: torch.optim.Optimizer) -> List[str]:
    """The parameter names of ``optimizer``'s parameters in its state_dict's
    index order (its parameters are ``model``'s)."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_slots(names: List[str], opt_state: Dict, fn) -> Dict:
    """``opt_state`` (a torch optimizer state dict) with every non-scalar
    slot tensor ``v`` of parameter ``names[i]`` replaced by ``fn(name, v)``."""
    state = {
        i: {k: fn(names[int(i)], v) if isinstance(v, torch.Tensor) and v.dim() > 0 else v for k, v in slots.items()}
        for i, slots in opt_state["state"].items()
    }
    return {"state": state, "param_groups": opt_state["param_groups"]}


def slice_optimizer_state(layout: TensorParallelLayout, names: List[str], opt_state: Dict) -> Dict:
    """A whole optimizer state dict cut to this rank's slot slices."""
    return _map_slots(names, opt_state, lambda name, v: layout.slice(name, v).clone())


def whole_optimizer_state(layout: TensorParallelLayout, names: List[str], opt_state: Dict) -> Dict:
    """An optimizer state dict of slot slices, whole: one gather over the
    model group for every sliced slot, in index order."""
    keys = [(i, k) for i in sorted(opt_state["state"], key=int) for k, v in sorted(opt_state["state"][i].items())
            if isinstance(v, torch.Tensor) and v.dim() > 0]
    wholes = layout.gather([(names[int(i)], opt_state["state"][i][k]) for i, k in keys])
    state = {i: dict(v) for i, v in opt_state["state"].items()}
    for (i, k), whole in zip(keys, wholes):
        state[i][k] = whole
    return {"state": state, "param_groups": opt_state["param_groups"]}


def sharded_param_ids(state) -> set:
    """The ids of the parameters of ``state.model`` that are model-axis
    slices (empty without tensor parallelism)."""
    if state.tp is None:
        return set()
    return {id(p) for n, p in state.model.named_parameters() if state.tp.dims[n] is not None}


def pmean_replicated(state) -> None:
    """Average the gradients of the leaves the rule leaves whole, and the
    BN statistics it leaves whole, over the model group, in place (one
    collective each; nothing without tensor parallelism). Every rank of the
    group computes them from the same replicated activations, so they
    agree up to the rounding of the card's algorithm choices (cuDNN picks
    per process, and some backward kernels add atomically); the mean keeps
    the whole leaves of the group's ranks bit for bit one."""
    if state.tp is None:
        return
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm

    dims = state.tp.dims
    grads = [p.grad for n, p in state.model.named_parameters() if dims[n] is None and p.grad is not None]
    collectives.pmean_(grads, state.tp.group)
    stats = [t for mod_name, m in state.model.named_modules() if isinstance(m, BatchNorm)
             for name, t in m.named_buffers(recurse=False) if dims[f"{mod_name}.{name}" if mod_name else name] is None]
    collectives.pmean_(stats, state.tp.group)


def make_train_step_gspmd(task, *, weight_decay: float = 0.0, seed: int = 0):
    """``fit``'s tensor-parallel step (JAX's ``make_train_step_gspmd``):
    the step of the (dp, tp) grid with BatchNorm statistics over the global
    batch (the per-rank moments averaged over the data group, as JAX's
    whole-step ``jit`` computes them over the global tensor), the gradient
    averaged over the data group, the update (ZeRO-1's when the state has
    a layout) and the metric sums. JAX's step applies the model with no
    ``rngs``; the ResNet classifiers and the ViT train here, which draw
    nothing."""
    from tensorflowdistributedlearning_tpu_torch.train.step import make_train_step

    return make_train_step(task, data_parallel=True, weight_decay=weight_decay, seed=seed, global_batch_norm=True)


def make_eval_step_gspmd(task):
    """The tensor-parallel eval step (JAX's ``make_eval_step_gspmd``): the
    inference forward of the sliced model, metrics summed over the data
    group."""
    from tensorflowdistributedlearning_tpu_torch.train.step import make_eval_step

    return make_eval_step(task, data_parallel=True)


def place_batch_gspmd(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global host ``batch`` (its data index's block,
    the same on every rank of its model group) on ``device``: JAX's
    ``place_batch_gspmd``."""
    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib

    rows = mesh.shard_rows(len(next(iter(batch.values()))))
    return pipeline_lib.to_device({k: np.asarray(v)[rows] for k, v in batch.items()}, torch.device(device))
