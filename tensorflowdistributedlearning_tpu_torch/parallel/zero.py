"""Cross-replica (ZeRO-1) sharding of the weight update and the optimizer
state (counterpart of the JAX package's ``parallel/zero.py``).

In plain data parallelism every rank holds the whole optimizer state
(Adam's two moments, the SGD or LARS momentum trace, the parameter EMA) and
runs the same update W times. Under ``TrainConfig.weight_update_sharding``
data position d of dp keeps and updates only its 1/dp slice of every slot
and of the EMA, then all-gathers the updated parameter slices over the
data group (``parallel/mesh.py``), so every rank ends the step with its
whole parameters: "Automatic Cross-Replica Sharding of Weight Update in
Data-Parallel Training" (arXiv:2004.13336). Without tensor parallelism the
data group is every rank.

- The spec rule (:func:`weight_update_spec_for_degrees`): a leaf shards on
  its largest dimension that the data-parallel degree divides (the first
  one on a tie), or stays whole (scalars, odd-sized vectors). The rule
  reads the leaf's shape in the JAX package's (flax's) order: a conv
  filter ``[kh, kw, C_in, C_out]``, a Dense kernel ``[in, out]``, a
  depthwise kernel ``[kh, kw, 1, C]``; the shard lands on the port
  dimension that holds that flax dimension (:func:`weight_update_specs`).
  So rank r holds the elements of the JAX package's shard r, ties included
  (a ``[3, 3, 64, 64]`` filter shards ``C_in`` in both packages, where the
  port's own ``[64, 64, 3, 3]`` order would pick ``C_out``). The bytes a
  rank holds are the same under either order; the elements are not.
  Under tensor parallelism (``tp > 1``, ``parallel/tensor.py``) the rule
  is JAX's composition: a leaf keeps its model-axis shard of the trailing
  dimension, the batch axis takes the largest dimension the model axis
  left that dp divides, and when none does and ``tp·dp`` divides the
  trailing dimension the two axes stack there as ``(model, batch)``:
  rank ``(d, m)`` holds block ``m·dp + d``. Either way the data slice is
  a slice of the rank's tensor-parallel slice.
- The layout (:class:`ZeroLayout`): parameters and BN buffers stay whole on
  every rank (JAX's ``param_placement_specs``). A sharded parameter's
  update leaf is this rank's slice of it, a view into one contiguous
  buffer per dtype; a whole parameter is its own leaf, updated on every
  rank. The optimizer is the port's own (``train.step.make_optimizer``)
  over the leaves, so its slots are slices too; so are the EMA's entries.
- The update (:func:`apply_gradients_sharded`), after the step's
  all-reduce of the flat gradient: the global-norm clip over the whole
  gradient, each leaf's ``.grad`` its slice of the gradient (a view), the
  optimizer's and the EMA's update of the leaves, then one all-gather per
  dtype of the leaf buffer, whose rank blocks are copied into the
  parameters' slices. Adam, AdamW and SGD are elementwise, so the step is
  bit for bit the replicated one; LARS reads ‖p‖ and ‖u‖ of the whole
  leaf, which a slice gets from one all-reduce of the slices' squared sums
  over the groups it is sliced over (another summation order: within a
  bound, not bit for bit).
- Checkpoints do not depend on the layout: :func:`whole_state` gathers
  the slots and the EMA into the replicated format, and
  :func:`load_whole_state` slices a whole state into this rank's leaves.

As in the JAX package the gradient is all-reduced whole and then sliced; a
reduce-scatter in its place is a later change. Collectives go through
:mod:`.collectives` (gloo on the CPU and for ranks that share a card, NCCL
otherwise).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh
from tensorflowdistributedlearning_tpu_torch.parallel.mesh import largest_divisible_dim


def weight_update_spec_for_degrees(shape: Sequence[int], *, dp: int, tp: int = 1) -> Optional[int]:
    """The dimension of a leaf of ``shape`` (in flax's order) that the
    batch axis of ZeRO-1 shards over ``dp`` data-parallel positions, or
    None (no data slice): where JAX's ``weight_update_spec_for_degrees``
    names the batch axis, alone or stacked as ``(model, batch)`` on the
    trailing dimension. The model axis's dimension is
    ``tensor.model_dim(shape, tp)``."""
    from tensorflowdistributedlearning_tpu_torch.parallel.tensor import model_dim

    if dp <= 1:
        return None
    shape = tuple(shape)
    taken = model_dim(shape, tp) if tp > 1 else None
    dim = largest_divisible_dim(shape, dp, taken=None if taken is None else {taken})
    if dim is None and taken is not None and shape[-1] % (tp * dp) == 0:
        return taken
    return dim


def flax_layout(module: nn.Module, name: str, shape: Tuple[int, ...]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(flax shape, axes)`` of the parameter ``name`` of ``module`` (a port
    tensor of ``shape``): port dimension i is flax dimension ``axes[i]``.
    OIHW conv filters are flax's HWIO, Dense weights ``[out, in]`` flax's
    ``[in, out]``, depthwise ``[kh, kw, C]`` flax's ``[kh, kw, 1, C]`` (the
    layouts ``utils/convert.py`` maps); every other leaf is flax's as it is."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import DepthwiseConv2D

    if name == "weight" and isinstance(module, nn.Conv2d):
        axes = (3, 2, 0, 1)
    elif name == "weight" and isinstance(module, nn.Linear):
        axes = (1, 0)
    elif name == "weight" and isinstance(module, DepthwiseConv2D):
        kh, kw, c = shape
        return (kh, kw, 1, c), (0, 1, 3)
    else:
        return tuple(shape), tuple(range(len(shape)))
    flax_shape = [0] * len(shape)
    for i, a in enumerate(axes):
        flax_shape[a] = shape[i]
    return tuple(flax_shape), axes


def weight_update_specs(model: nn.Module, dp: int, tp=None) -> Dict[str, Optional[int]]:
    """``{parameter name: the port dimension its data slice is cut on, or
    None}`` over ``dp`` data positions. ``tp`` (a
    ``tensor.TensorParallelLayout``) says which of ``model``'s parameters
    are model-axis slices: the rule reads their whole shape, and the data
    slice is cut from the rank's slice. The parameters' gradients,
    optimizer slots and EMA entries have their parameter's shape and take
    its spec."""
    specs: Dict[str, Optional[int]] = {}
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            flax_shape, axes = flax_layout(module, name, tuple(p.shape))
            degree = 1
            if tp is not None:
                degree = tp.degree
                if tp.dims[full] is not None:
                    flax_shape = list(flax_shape)
                    flax_shape[axes[tp.dims[full]]] *= tp.degree
            dim = weight_update_spec_for_degrees(flax_shape, dp=dp, tp=degree)
            specs[full] = None if dim is None else axes.index(dim)
    return specs


@dataclasses.dataclass
class _Entry:
    name: str
    param: nn.Parameter
    dim: int
    leaf: torch.Tensor
    offset: int


class ZeroLayout:
    """This rank's share of the weight update: for every parameter of
    ``model`` its update leaf (:attr:`leaves`: this rank's slice of a
    sharded parameter, a view into :attr:`flat`, or the parameter itself)
    and its shard dimension (:attr:`dims`). ``world`` and ``rank`` are the
    data-parallel degree and this rank's data index, ``group`` the data
    group, all by default the process's mesh (``parallel/mesh.py``); ``tp``
    is the state's tensor-parallel layout when ``model`` holds model-axis
    slices. A layout made without a group (for its accounting) gathers
    nothing."""

    def __init__(self, model: nn.Module, world: Optional[int] = None, rank: Optional[int] = None, group=None,
                 tp=None):
        if world is None:
            lay = mesh.layout()
            world, rank, group = lay.dp, lay.data_index, lay.data_group
        self.world = int(world)
        self.rank = collectives.rank() if rank is None else int(rank)
        self.group = group
        self.tp = tp
        self.dims = weight_update_specs(model, self.world, tp)
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        sizes: Dict[tuple, int] = {}
        for name, p in self.params.items():
            if self.dims[name] is not None:
                key = (p.dtype, p.device)
                sizes[key] = sizes.get(key, 0) + p.numel() // self.world
        # one contiguous buffer per (dtype, device): the all-gather's input
        self.flat: Dict[tuple, torch.Tensor] = {
            key: torch.empty(n, dtype=key[0], device=key[1]) for key, n in sizes.items()
        }
        self.entries: Dict[tuple, List[_Entry]] = {key: [] for key in sizes}
        self.leaves: Dict[str, torch.Tensor] = {}
        offsets = dict.fromkeys(sizes, 0)
        for name, p in self.params.items():
            dim = self.dims[name]
            if dim is None:
                self.leaves[name] = p
                continue
            key = (p.dtype, p.device)
            shape = list(p.shape)
            shape[dim] //= self.world
            n = p.numel() // self.world
            leaf = self.flat[key][offsets[key]:offsets[key] + n].view(shape)
            self.entries[key].append(_Entry(name, p, dim, leaf, offsets[key]))
            offsets[key] += n
            self.leaves[name] = leaf
        self.name_of = {id(leaf): name for name, leaf in self.leaves.items()}
        self.pull_params()

    @property
    def sharded(self) -> List[str]:
        """The names of the parameters this layout shards."""
        return [name for name, dim in self.dims.items() if dim is not None]

    def slice(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice (a view) of ``whole``, a tensor shaped like
        the parameter ``name``; ``whole`` itself for a whole leaf."""
        dim = self.dims[name]
        if dim is None:
            return whole
        if tuple(whole.shape) != tuple(self.params[name].shape):
            raise ValueError(f"{name}: a whole tensor of shape {tuple(whole.shape)} for a parameter of shape "
                             f"{tuple(self.params[name].shape)}")
        k = whole.shape[dim] // self.world
        return whole.narrow(dim, self.rank * k, k)

    @torch.no_grad()
    def pull_params(self) -> None:
        """Copy this rank's slices of the parameters into the leaves (after
        anything wrote the parameters: a restore, a broadcast)."""
        for entries in self.entries.values():
            for e in entries:
                e.leaf.copy_(self.slice(e.name, e.param))

    def set_grads(self) -> None:
        """Point every sharded leaf's ``.grad`` at its slice of the
        parameter's gradient (a view: no copy)."""
        for entries in self.entries.values():
            for e in entries:
                e.leaf.grad = None if e.param.grad is None else self.slice(e.name, e.param.grad)

    def names_in_order(self, optimizer: torch.optim.Optimizer) -> List[str]:
        """The parameter names of ``optimizer``'s leaves in its state_dict's
        index order (group by group)."""
        return [self.name_of[id(p)] for g in optimizer.param_groups for p in g["params"]]

    def params_in_order(self, optimizer: torch.optim.Optimizer) -> List[nn.Parameter]:
        """The whole parameters of ``optimizer``'s leaves, in its order (the
        replicated optimizer's order, which the clip's sum follows)."""
        return [self.params[name] for name in self.names_in_order(optimizer)]

    @torch.no_grad()
    def gather_params(self) -> None:
        """All-gather the leaf buffers (one collective per dtype) and write
        every rank's block into the parameters' slices."""
        for key, flat in self.flat.items():
            blocks = collectives.all_gather(flat, self.group)
            for r in range(self.world):
                for e in self.entries[key]:
                    k = e.param.shape[e.dim] // self.world
                    e.param.narrow(e.dim, r * k, k).copy_(blocks[r, e.offset:e.offset + e.leaf.numel()].view(e.leaf.shape))

    @torch.no_grad()
    def gather(self, items: Sequence[Tuple[str, torch.Tensor]]) -> List[torch.Tensor]:
        """The whole tensors of ``(parameter name, this rank's slice)``
        pairs (a slot, an EMA entry), in order: one all-gather per dtype
        over every rank, which must call it with the same names in the same
        order. A whole leaf's tensor comes back as it is."""
        out: List[torch.Tensor] = [t for _, t in items]
        idx = [i for i, (name, _) in enumerate(items) if self.dims[name] is not None]
        wholes = collectives.gather_blocks([(items[i][1], self.dims[items[i][0]]) for i in idx], self.group)
        for i, whole in zip(idx, wholes):
            out[i] = whole
        return out


def shard_state(state, train_config, world: Optional[int] = None, rank: Optional[int] = None, group=None):
    """``state`` (a ``TrainState``, replicated or already cut to its
    tensor-parallel slices) under ZeRO-1 over ``world`` data positions as
    position ``rank`` (default: the process's mesh and its data group), in
    place and returned: the layout, the configured optimizer over its
    leaves with every slot allocated (sliced from ``state``'s slots where
    it had any), and the EMA sliced. JAX's ``shard_state_weight_update``."""
    from tensorflowdistributedlearning_tpu_torch.train.step import init_optimizer_slots, make_optimizer

    layout = ZeroLayout(state.model, world, rank, group, tp=state.tp)
    whole_optimizer = state.optimizer.state_dict()
    state.optimizer = make_optimizer(train_config, state.model, leaves=layout.leaves)
    bind(layout, state.optimizer)
    if whole_optimizer["state"]:
        _load_sliced_optimizer(layout, state.optimizer, whole_optimizer)
    init_optimizer_slots(state.optimizer)
    if state.ema is not None:
        state.ema = {name: layout.slice(name, e).clone() for name, e in state.ema.items()}
    state.zero = layout
    return state


def bind(layout: ZeroLayout, optimizer: torch.optim.Optimizer) -> None:
    """Tell a LARS optimizer which of its leaves are data slices and which
    model-axis slices, whose norms it then reduces over the data group,
    the model group, or every rank for a leaf sliced both ways."""
    from tensorflowdistributedlearning_tpu_torch.train.step import Lars

    if isinstance(optimizer, Lars):
        optimizer.sharded = {id(layout.leaves[name]) for name in layout.sharded}
        optimizer.data_group = layout.group
        if layout.tp is not None:
            optimizer.model_sharded = {id(layout.leaves[name]) for name in layout.leaves
                                       if layout.tp.dims[name] is not None}
            optimizer.model_group = layout.tp.group


def apply_gradients_sharded(state) -> None:
    """One ZeRO-1 update of ``state`` from the whole, all-reduced gradient
    in the parameters' ``.grad``: the global-norm clip over the whole
    gradient, lr = ``schedule(step)``, the optimizer's and the EMA's update
    of this rank's leaves, the all-gather of the parameters, ``step += 1``
    (JAX's ``apply_gradients_sharded``)."""
    from tensorflowdistributedlearning_tpu_torch.train.step import clip_by_global_norm

    layout = state.zero
    if state.grad_clip_norm:
        params = layout.params_in_order(state.optimizer)
        clip_by_global_norm(params, state.grad_clip_norm, *_model_sliced(state))
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    layout.set_grads()
    state.optimizer.step()
    if state.ema is not None:
        with torch.no_grad():
            for name, leaf in layout.leaves.items():
                e = state.ema[name]
                e.copy_(e * state.ema_decay + leaf * (1.0 - state.ema_decay))
    layout.gather_params()
    state.step += 1


def _model_sliced(state) -> Tuple[set, object]:
    """``(ids of the model-axis slices among the parameters, the model
    group)`` of ``state``, the clip's reduction (empty without tensor
    parallelism)."""
    from tensorflowdistributedlearning_tpu_torch.parallel.tensor import sharded_param_ids

    return sharded_param_ids(state), (state.tp.group if state.tp is not None else None)


def _sharded_slots(layout: ZeroLayout, names: List[str], opt_state: Dict) -> List[Tuple[int, str, str]]:
    """``(index, slot key, parameter name)`` of every sliced slot of a
    torch optimizer state dict, in index order (the order every rank
    gathers in)."""
    out = []
    for i in sorted(opt_state, key=int):
        name = names[int(i)]
        if layout.dims[name] is None:
            continue
        for key, v in opt_state[i].items():
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                out.append((i, key, name))
    return out


def whole_state(layout: ZeroLayout, optimizer: torch.optim.Optimizer, ema: Optional[Dict[str, torch.Tensor]]):
    """``(optimizer state dict, EMA)`` in the replicated format: every
    sliced slot and EMA entry gathered whole (a collective every rank
    makes)."""
    opt = optimizer.state_dict()
    names = layout.names_in_order(optimizer)
    slots = _sharded_slots(layout, names, opt["state"])
    ema_names = sorted(ema) if ema is not None else []
    wholes = layout.gather([(name, opt["state"][i][key]) for i, key, name in slots]
                           + [(name, ema[name]) for name in ema_names])
    state = {i: dict(v) for i, v in opt["state"].items()}
    for (i, key, _), whole in zip(slots, wholes):
        state[i][key] = whole
    whole_ema = dict(zip(ema_names, wholes[len(slots):])) if ema is not None else None
    return {"state": state, "param_groups": opt["param_groups"]}, whole_ema


def _load_sliced_optimizer(layout: ZeroLayout, optimizer: torch.optim.Optimizer, whole: Dict) -> None:
    names = layout.names_in_order(optimizer)
    state = {}
    for i, slots in whole["state"].items():
        name = names[int(i)]
        state[i] = {
            k: layout.slice(name, v).clone() if isinstance(v, torch.Tensor) and v.dim() > 0 else v
            for k, v in slots.items()
        }
    optimizer.load_state_dict({"state": state, "param_groups": whole["param_groups"]})


def load_whole_state(state, optimizer_state: Dict, ema: Optional[Dict[str, torch.Tensor]]) -> None:
    """Load a replicated-format optimizer state dict and EMA into a ZeRO-1
    ``state`` whose model holds the whole parameters already: the leaves
    re-sliced from the parameters, the slots and the EMA sliced to this
    rank's share (allocated where the state dict has none)."""
    from tensorflowdistributedlearning_tpu_torch.train.step import init_optimizer_slots

    layout = state.zero
    layout.pull_params()
    _load_sliced_optimizer(layout, state.optimizer, optimizer_state)
    bind(layout, state.optimizer)
    init_optimizer_slots(state.optimizer)
    if ema is not None:
        with torch.no_grad():
            for name, e in state.ema.items():
                e.copy_(layout.slice(name, ema[name]))


def all_gather_bytes(layout: ZeroLayout) -> int:
    """Bytes one step's parameter all-gather lands on each rank (its data
    group's blocks)."""
    return sum(flat.numel() * flat.element_size() * layout.world for flat in layout.flat.values())
