"""Pipeline parallelism: the GPipe fill/drain runner over a stage group
(counterpart of the JAX package's ``parallel/pipeline.py``).

K stages of one homogeneous computation (every stage maps a microbatch to a
tensor of the same shape and dtype: ViT blocks, Xception's middle-flow
units) run on the K ranks of a stage group (``parallel/mesh.py``: the model
group under ``pipeline_parallel``, stage k on model index k). M
microbatches flow through them; stage k runs microbatch m at tick ``m + k``,
``M + K - 1`` ticks in all, so the bubble is ``(K - 1) / (M + K - 1)``
(:func:`bubble_fraction`). Activations go to stage k + 1 by
point-to-point :func:`collectives.send` / :func:`collectives.recv` (under
gloo a CUDA tensor is staged through the host), and the last stage's
output reaches every stage by one broadcast over the group, as JAX sums
the masked tail over the axis (``psum``).

JAX differentiates through its ``lax.scan`` + ``ppermute`` schedule; here
the backward is written by hand. With gradients enabled,
:func:`pipeline_apply` is one ``torch.autograd.Function``: its forward keeps
each microbatch's stage input (a detached leaf) and output; its backward
walks the microbatches in reverse, receives each output's cotangent from
stage k + 1 (the last stage takes its slice of the output's cotangent),
runs ``torch.autograd.backward`` on that output and sends the input's
gradient to stage k - 1. Every rank runs the same fixed order of sends and
receives, a chain from the last stage to the first, so blocking gloo
point-to-point calls cannot deadlock. The output's cotangent on every stage
but the last is ignored: JAX's ``psum`` of the tail transposes to the last
stage's cotangent. A rank whose loss does not read the output (the stages
but the last, in the train steps of ``train/pipeline_step.py``) joins the
reverse schedule through :func:`pipeline_backward`.

The stage's parameters are JAX's ``my_stage_params``: any nest of
dicts, lists and tuples. Its tensors are inputs of the function (detached
inside, their gradients returned, so a slice of a stacked tensor hands its
gradient to its slot as JAX's dynamic index does). Its modules (the
canonical model's own blocks or units) are used as they are: their
parameters receive their gradients in the backward, as leaves do.

``local_stages=K`` runs all K stages in this process in the same order of
operations (the one-rank schedule a distributed run is held against bit
for bit); ``my_stage_params`` is then the sequence of the K stages'
parameters.

JAX's ``stage_in_spec`` (the ``PartitionSpec`` that shards the stacked
stage axis over the model axis) has no PyTorch counterpart: a rank takes
its slot of the stacked tree by index (:func:`make_pipeline_fn`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils import _pytree as pytree

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh


def bubble_fraction(stages: int, microbatches: int) -> float:
    """The fill/drain schedule's idle share, ``(K - 1) / (M + K - 1)``."""
    return (stages - 1) / (microbatches + stages - 1)


class Placement:
    """This process's stages: their indices (``mine``), the stage count
    (``k``), the group and the global ranks of its members (None for the
    one-rank schedule, ``local_stages``, and without a stage group)."""

    def __init__(self, group=None, local_stages: Optional[int] = None):
        self.local_stages = local_stages
        if local_stages is not None:
            self.k, self.mine, self.group, self.ranks = int(local_stages), list(range(int(local_stages))), None, None
            return
        group = mesh.stage_group() if group is None else group
        if group is None or not collectives.is_initialized():
            self.k, self.mine, self.group, self.ranks = 1, [0], None, None
            return
        self.k = dist.get_world_size(group)
        self.mine = [dist.get_rank(group)]
        self.group = group
        self.ranks = [dist.get_global_rank(group, j) for j in range(self.k)]

    @property
    def last(self) -> int:
        """The last stage's index."""
        return self.k - 1

    @property
    def holds_first(self) -> bool:
        return 0 in self.mine

    @property
    def holds_last(self) -> bool:
        return self.last in self.mine

    def remote(self, stage: int) -> bool:
        return 0 <= stage < self.k and stage not in self.mine

    def per_stage(self, fn):
        """``fn(k)`` for this process's stage, or the list of every stage's
        under ``local_stages``: the ``my_stage_params`` of the runner."""
        return [fn(k) for k in self.mine] if self.local_stages is not None else fn(self.mine[0])


class _Run:
    """One call's stage function, parameters and record: each local
    stage's microbatch inputs and outputs (for the backward) and aux."""

    def __init__(self, stage_fn, params_by_stage: Dict[int, Any], place: Placement, with_aux: bool):
        self.stage_fn = stage_fn
        self.params_by_stage = params_by_stage
        self.place = place
        self.with_aux = with_aux
        self.ins: Dict[int, List[torch.Tensor]] = {k: [] for k in place.mine}
        self.outs: Dict[int, List[torch.Tensor]] = {k: [] for k in place.mine}
        self.auxs: Dict[int, List[Any]] = {k: [] for k in place.mine}

    def schedule(self, x_micro: torch.Tensor, keep_graph: bool, x_grad: bool) -> torch.Tensor:
        """The forward: every microbatch through this process's stages in
        order, then the last stage's output on every stage; ``[M, ...]``."""
        place = self.place
        for m in range(x_micro.shape[0]):
            x = None
            for k in place.mine:
                if k == 0:
                    x = x_micro[m]
                elif x is None:
                    x = collectives.recv(x_micro[m], place.ranks[k - 1], place.group)
                if keep_graph:
                    x = x.detach().requires_grad_(k > 0 or x_grad)
                y = self.stage_fn(self.params_by_stage[k], x)
                if self.with_aux:
                    y, aux = y
                    self.auxs[k].append([a.detach() for a in aux])
                if keep_graph:
                    self.ins[k].append(x)
                    self.outs[k].append(y)
                elif k == place.last:
                    self.outs[k].append(y)
                if place.remote(k + 1):
                    collectives.send(y, place.ranks[k + 1], place.group)
                x = y
        if place.holds_last:
            out = torch.stack([y.detach() for y in self.outs[place.last]])
        else:
            out = torch.empty_like(x_micro)
        if place.group is not None and place.k > 1:
            collectives.broadcast_([out], src=place.ranks[place.last], group=place.group)
        if not keep_graph:
            self.outs = {k: [] for k in place.mine}
        return out

    def aux_mean(self) -> List:
        """Each local stage's aux averaged over its M real ticks."""
        return [[torch.stack(leaves).mean(dim=0) for leaves in zip(*self.auxs[k])] for k in self.place.mine]

    def reverse(self, d_out: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The backward: the microbatches in reverse, each output's
        cotangent from the next stage (the last stage's from ``d_out``),
        its backward, its input's gradient to the previous stage; returns
        the first stage's input gradients ``[M, ...]`` (None elsewhere)."""
        place = self.place
        n = len(self.outs[place.mine[0]])
        first = [None] * n
        for m in reversed(range(n)):
            g = None
            for k in reversed(place.mine):
                y, x = self.outs[k][m], self.ins[k][m]
                if k == place.last:
                    g = d_out[m]
                elif g is None:
                    g = collectives.recv(y, place.ranks[k + 1], place.group)
                torch.autograd.backward(y, g)
                g = x.grad
                self.outs[k][m] = self.ins[k][m] = None
                if place.remote(k - 1):
                    collectives.send(g, place.ranks[k - 1], place.group)
                if k == 0:
                    first[m] = g
        return None if first[0] is None else torch.stack(first)


class _Pipeline(torch.autograd.Function):
    """The fill/drain schedule as one autograd node: inputs the microbatches
    and the parameters' tensors, output the pipeline's ``[M, ...]``."""

    @staticmethod
    def forward(ctx, run: _Run, x_micro: torch.Tensor, n_leaves: int, *tensors):
        ctx.run = run
        ctx.n_leaves = n_leaves
        ctx.n_inputs = len(tensors)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in tensors[:n_leaves]]
            ctx.leaves = leaves
            run.params_by_stage = {k: _unflatten(p, leaves) for k, p in run.params_by_stage.items()}
            return run.schedule(x_micro, keep_graph=True, x_grad=x_micro.requires_grad)

    @staticmethod
    def backward(ctx, d_out):
        run = ctx.run
        dx = run.reverse(d_out)
        grads = [leaf.grad for leaf in ctx.leaves]
        ctx.run = ctx.leaves = None
        return (None, dx, None, *grads, *([None] * (ctx.n_inputs - ctx.n_leaves)))


class _Flat:
    """A stage's parameter nest with its tensors numbered: ``spec`` to
    rebuild it, ``slots`` its leaves (a tensor's number among the node's
    inputs, any other leaf as it is)."""

    def __init__(self, spec, slots):
        self.spec, self.slots = spec, slots


def _flatten(params_by_stage: Dict[int, Any]):
    """The tensors of every stage's parameters (inputs of the node, in
    order), the parameters of its modules (inputs only so that the output
    requires a gradient) and each stage's :class:`_Flat`."""
    tensors: List[torch.Tensor] = []
    module_params: List[torch.Tensor] = []
    flats = {}
    for k, params in params_by_stage.items():
        leaves, spec = pytree.tree_flatten(params)
        slots = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                slots.append(len(tensors))
                tensors.append(leaf)
            else:
                slots.append(leaf)
                if isinstance(leaf, nn.Module):
                    module_params += [p for p in leaf.parameters() if p.requires_grad]
        flats[k] = _Flat(spec, slots)
    return tensors, module_params, flats


def _unflatten(flat: _Flat, leaves: Sequence[torch.Tensor]):
    return pytree.tree_unflatten([leaves[s] if isinstance(s, int) else s for s in flat.slots], flat.spec)


def _run(stage_fn, my_stage_params, x_microbatches: torch.Tensor, group, local_stages, with_aux: bool):
    place = Placement(group, local_stages)
    if local_stages is not None:
        if len(my_stage_params) != place.k:
            raise ValueError(f"{len(my_stage_params)} stage parameter sets for {place.k} local stages")
        by_stage = dict(enumerate(my_stage_params))
    else:
        by_stage = {place.mine[0]: my_stage_params}
    tensors, module_params, flats = _flatten(by_stage)
    run = _Run(stage_fn, by_stage, place, with_aux)
    wants = x_microbatches.requires_grad or any(t.requires_grad for t in tensors) or bool(module_params)
    if not (torch.is_grad_enabled() and wants):
        return run.schedule(x_microbatches, keep_graph=False, x_grad=False), run
    run.params_by_stage = flats
    out = _Pipeline.apply(run, x_microbatches, len(tensors), *tensors, *module_params)
    return out, run


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    my_stage_params: Any,
    x_microbatches: torch.Tensor,
    *,
    group=None,
    local_stages: Optional[int] = None,
) -> torch.Tensor:
    """Run the K stages of ``group`` (default: the mesh's stage group) over
    the M microbatches ``x_microbatches`` ``[M, mb, ...]`` (every rank
    passes them; only stage 0 reads them, the others take their shape and
    dtype) and return the pipeline's output ``[M, mb, ...]`` on every
    stage. ``stage_fn(params, x)`` is one stage (its output of ``x``'s
    shape and dtype); ``my_stage_params`` this rank's stage's parameters.
    Differentiable when gradients are enabled (see the module note)."""
    out, _ = _run(stage_fn, my_stage_params, x_microbatches, group, local_stages, with_aux=False)
    return out


def pipeline_apply_aux(
    stage_fn: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, Sequence[torch.Tensor]]],
    my_stage_params: Any,
    x_microbatches: torch.Tensor,
    *,
    group=None,
    local_stages: Optional[int] = None,
) -> Tuple[torch.Tensor, List]:
    """:func:`pipeline_apply` for stages that also emit per-tick state:
    ``stage_fn(params, x) -> (y, aux)`` with ``aux`` a sequence of tensors.
    Returns ``(out, aux_mean)``: ``aux_mean`` is this stage's aux averaged
    over its M real microbatches (the fill and drain ticks run nothing
    here); with ``local_stages`` a list of each stage's. Built for
    BatchNorm in a stage: the aux is the per-microbatch update of the
    running statistics, and since the update is affine in the batch
    statistic, their mean is one update by the microbatches' mean
    statistic."""
    out, run = _run(stage_fn, my_stage_params, x_microbatches, group, local_stages, with_aux=True)
    means = run.aux_mean()
    return out, (means if local_stages is not None else means[0])


def pipeline_backward(out: torch.Tensor) -> None:
    """This rank's part of the reverse schedule of a pipeline output that
    its loss does not read (every stage but the last): the backward of
    ``out`` with a zero cotangent, which the pipeline ignores."""
    torch.autograd.backward(out, out.new_zeros(()).expand(out.shape))


def stack_stage_params(param_trees: Sequence[Any]) -> Any:
    """Stack K per-stage parameter nests on a new leading axis (a rank
    takes its slot by index: :func:`make_pipeline_fn`)."""
    return pytree.tree_map(lambda *leaves: torch.stack(leaves), param_trees[0], *param_trees[1:])


def make_pipeline_fn(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    group=None,
    local_stages: Optional[int] = None,
) -> Callable:
    """``f(stacked_params, x_microbatches)``: the pipeline forward of
    ``stacked_params`` ``[K, ...]`` (K the stage group's size, or
    ``local_stages``), each rank on its slot, over ``[M, mb, ...]``
    microbatches, returning ``[M, mb, ...]`` on every rank. Raises unless
    the stacked stage count is the group's size, with the JAX package's
    text."""

    def run(stacked_params, x_microbatches: torch.Tensor) -> torch.Tensor:
        place = Placement(group, local_stages)
        n_stages = pytree.tree_leaves(stacked_params)[0].shape[0]
        if n_stages != place.k:
            raise ValueError(
                f"{n_stages} pipeline stages on a model axis of size {place.k}; "
                "the stage count must equal the mesh's model-axis size"
            )
        if local_stages is not None:
            mine = [pytree.tree_map(lambda p, s=s: p[s], stacked_params) for s in range(place.k)]
        else:
            mine = pytree.tree_map(lambda p: p[place.mine[0]], stacked_params)
        return pipeline_apply(stage_fn, mine, x_microbatches, group=group, local_stages=local_stages)

    return run
