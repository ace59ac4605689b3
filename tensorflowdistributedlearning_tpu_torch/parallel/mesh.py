"""The (batch, model) layout of the ranks (counterpart of the JAX package's
``parallel/mesh.py``, its model and sequence axes in one slot).

The JAX package reshapes its devices as ``(dp, model, sequence)``; here a
rank owns one device, so with a model axis of size ``tp`` rank r of W is
data index ``r // tp`` and model index ``r % tp`` (:class:`Layout`). The
ranks of one data index form a model group and read the same rows. The
ranks of one model index form a data group: they average their gradients
and BN statistics and sum their metrics. At ``tp = 1`` the data group is
the default group and there is no model group.

Four strategies ride the model axis, as in the JAX package's ``fit``
(``make_mesh(model_parallel=max(model_parallel, pipeline_parallel,
expert_parallel))``) and its sequence axis, which the JAX package never
combines with the other three (``TrainConfig``): tensor parallelism,
whose model group holds the channel slices of one replica
(``parallel/tensor.py``), pipeline parallelism, whose model group is the
stage group of one replica: stage k is model index k
(``parallel/pipeline.py``), expert parallelism, whose model group is the
expert group of one replica: model index e computes expert e of every MoE
layer (``parallel/expert.py``), and sequence
parallelism, whose model group is the sequence group of one replica:
model index s holds the s-th block of every image's rows
(``parallel/spatial.py``, :func:`shard_batch_spatial`), the JAX
package's ``(dp, 1, sp)`` device order.
:attr:`Layout.pipeline`, :attr:`Layout.expert` and
:attr:`Layout.sequence` tell them apart; :func:`model_parallel_degree` is
the tensor-parallel degree alone, :func:`pipeline_parallel_degree` the
stage count alone, :func:`expert_parallel_degree` the expert count alone
and :func:`sequence_parallel_degree` the sequence degree alone.

A global batch lies over the data axis in contiguous blocks: data index d
of dp owns rows ``[d·B/dp, (d+1)·B/dp)`` (:func:`shard_rows`), the rows
``shard_batch`` gives the devices of the d-th batch position.

:func:`init_mesh` sets the layout of the process (the trainers call it);
without it the layout is ``tp = 1`` over the process group, if any.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch.distributed as dist

from tensorflowdistributedlearning_tpu_torch.parallel import collectives

# the JAX package's mesh axis names
BATCH_AXIS = "batch"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "sequence"


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place on the ``(dp, tp)`` grid and its two groups
    (``None`` for the default group, and for no model group at ``tp = 1``)."""

    world: int
    # the model axis's size: the tensor-parallel degree, or the stage count
    # under ``pipeline``
    tp: int
    rank: int
    model_group: Any = None
    data_group: Any = None
    # the default group the groups were made in (None without one)
    world_group: Any = None
    # whether the model group is a pipeline's stage group
    pipeline: bool = False
    # whether the model group is an expert group
    expert: bool = False
    # whether the model group is a sequence group
    sequence: bool = False

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp


_LAYOUT: Optional[Layout] = None


def _world_group():
    return dist.group.WORLD if collectives.is_initialized() else None


def init_mesh(
    model_parallel: int = 1, *, pipeline: bool = False, expert: bool = False, sequence: bool = False
) -> Layout:
    """Lay the ranks of the process group out as ``(world / tp, tp)`` and
    make this process's layout the one every helper here reads; with
    ``pipeline`` the model axis holds pipeline stages, with ``expert`` the
    experts of the MoE layers, with ``sequence`` the row blocks of the
    sequence axis. Every rank calls it
    with the same arguments (it makes every group, in one order). Raises
    when the degree does not divide the world, with the JAX package's
    ``make_mesh`` text."""
    global _LAYOUT
    tp = int(model_parallel)
    pipeline = bool(pipeline) and tp > 1
    expert = bool(expert) and tp > 1
    sequence = bool(sequence) and tp > 1
    world, rank = collectives.world_size(), collectives.rank()
    require_divisible(tp, world)
    current = _LAYOUT
    if current is not None and current.world_group is _world_group() and (
            current.world, current.tp, current.pipeline, current.expert, current.sequence) == (
                world, tp, pipeline, expert, sequence):
        return current
    model_group = data_group = None
    if tp > 1:
        dp = world // tp
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)])
            if d == rank // tp:
                model_group = g
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if m == rank % tp:
                data_group = g
    _LAYOUT = Layout(world, tp, rank, model_group, data_group, _world_group(), pipeline, expert, sequence)
    return _LAYOUT


def require_divisible(degree: int, world: Optional[int] = None) -> None:
    """Raise, with the JAX package's ``make_mesh`` text, unless the model
    axis's ``degree`` divides the world (default: the process group's)."""
    world = collectives.world_size() if world is None else world
    if degree < 1 or world % degree != 0:
        raise ValueError(f"{world} devices not divisible by model_parallel*sequence_parallel={degree}")


def model_axis_degree(train_config) -> int:
    """The model axis's size for a ``TrainConfig``: the largest of its
    tensor, pipeline, expert and sequence degrees."""
    c = train_config
    return max(c.model_parallel, c.pipeline_parallel, c.expert_parallel, c.sequence_parallel)


def init_mesh_for(train_config) -> Layout:
    """:func:`init_mesh` for a ``TrainConfig``: the model axis is the
    largest of ``model_parallel``, ``pipeline_parallel``,
    ``expert_parallel`` and ``sequence_parallel`` (``TrainConfig`` refuses
    two of them above 1), a stage group under the second, an expert group
    under the third and a sequence group under the fourth, as the JAX
    package's trainers build their mesh."""
    pp, ep, sp = train_config.pipeline_parallel, train_config.expert_parallel, train_config.sequence_parallel
    return init_mesh(model_axis_degree(train_config), pipeline=pp > 1, expert=ep > 1, sequence=sp > 1)


def layout() -> Layout:
    """This process's layout: the one :func:`init_mesh` made for the
    current process group, else ``tp = 1`` over it."""
    current = _LAYOUT
    world = collectives.world_size()
    if current is not None and current.world_group is _world_group() and current.world == world:
        return current
    return Layout(world, 1, collectives.rank(), None, None, _world_group())


def axis_sizes(lay: Optional[Layout] = None) -> dict:
    """``{axis name: size}`` of the JAX package's mesh for ``lay`` (default:
    this process's layout), always all three axes: ``batch`` the
    data-parallel degree, ``model`` the tensor, pipeline or expert degree,
    ``sequence`` the sequence degree (the run header's ``mesh``)."""
    lay = layout() if lay is None else lay
    return {BATCH_AXIS: lay.dp, MODEL_AXIS: 1 if lay.sequence else lay.tp, SEQUENCE_AXIS: lay.tp if lay.sequence else 1}


def data_parallel_degree() -> int:
    """The data-parallel degree: the world over the model-parallel degree."""
    return layout().dp


def model_parallel_degree() -> int:
    """The tensor-parallel degree (1 without :func:`init_mesh`, and under
    pipeline, expert or sequence parallelism)."""
    lay = layout()
    return 1 if lay.pipeline or lay.expert or lay.sequence else lay.tp


def pipeline_parallel_degree() -> int:
    """The pipeline's stage count (1 without a stage group)."""
    lay = layout()
    return lay.tp if lay.pipeline else 1


def expert_parallel_degree() -> int:
    """The experts' group size (1 without an expert group)."""
    lay = layout()
    return lay.tp if lay.expert else 1


def sequence_parallel_degree() -> int:
    """The sequence axis's size (1 without a sequence group)."""
    lay = layout()
    return lay.tp if lay.sequence else 1


def data_index() -> int:
    """This rank's position on the data axis (its model group's index)."""
    return layout().data_index


def model_index() -> int:
    """This rank's position on the model axis (its channel slice, or its
    pipeline stage)."""
    return layout().model_index


def data_group():
    """The group the gradients, BN statistics and metrics reduce over: None
    (the default group) at ``tp = 1``; at ``dp = 1`` a group of one rank,
    over which every collective of :mod:`.collectives` is the identity."""
    return layout().data_group


def model_group():
    """The group of the ranks that hold one replica's channel slices or
    pipeline stages (None at ``tp = 1``)."""
    return layout().model_group


def stage_group():
    """The pipeline's stage group: the model group under pipeline
    parallelism, else None."""
    lay = layout()
    return lay.model_group if lay.pipeline else None


def sequence_group():
    """The sequence axis's group: the model group under sequence
    parallelism, else None."""
    lay = layout()
    return lay.model_group if lay.sequence else None


def sequence_index() -> int:
    """This rank's position on the sequence axis: which block of the rows
    it holds (0 without a sequence group)."""
    lay = layout()
    return lay.model_index if lay.sequence else 0


def expert_group():
    """The MoE layers' expert group: the model group under expert
    parallelism, else None."""
    lay = layout()
    return lay.model_group if lay.expert else None


def gradient_group():
    """The group the step averages its gradient over: the data group,
    or every rank under expert parallelism, whose model group's ranks hold
    the same rows and split the experts' gradients between them
    (``parallel/expert.py``), and under sequence parallelism, whose ranks'
    gradients each hold sp times their share of one loss
    (``train/step.py``)."""
    lay = layout()
    return lay.world_group if lay.expert or lay.sequence else lay.data_group


def local_batch_size(global_batch: int, degree: Optional[int] = None) -> int:
    """Per-rank batch size; ``global_batch`` must divide evenly over the
    ``degree`` data positions (default :func:`data_parallel_degree`). The
    check is :func:`multihost.per_process_batch_size`'s, with the error
    text of the JAX package's ``mesh.local_batch_size``."""
    n = data_parallel_degree() if degree is None else degree
    if global_batch % n != 0:
        raise ValueError(f"Batch size {global_batch} must be divisible by the data-parallel degree {n}")
    return global_batch // n


def shard_rows(global_batch: int, index: Optional[int] = None, degree: Optional[int] = None) -> slice:
    """The contiguous rows of a ``global_batch`` that data position
    ``index`` of ``degree`` owns (default: this rank's data index of the
    data-parallel degree; at ``tp = 1`` the rank of the world)."""
    index = data_index() if index is None else index
    local = local_batch_size(global_batch, degree)
    return slice(index * local, (index + 1) * local)


def shard_batch_spatial(tree, *, rows: bool = True):
    """This rank's part of a batch under sequence parallelism (the JAX
    package's ``shard_batch_spatial``): ``images`` get this data index's
    rows (:func:`shard_rows`; ``rows=False`` keeps every row, for a batch
    that already holds the data slot's rows only) and this sequence index's
    block of H; every other entry gets the rows only. H must divide by the
    sequence degree."""
    sp, s = sequence_parallel_degree(), sequence_index()
    out = {}
    for key, x in tree.items():
        if rows and getattr(x, "ndim", 0):
            x = x[shard_rows(x.shape[0])]
        if key == "images":
            if x.shape[1] % sp != 0:
                raise ValueError(f"Spatial extent {x.shape[1]} must be divisible by the sequence-parallel degree {sp}")
            h = x.shape[1] // sp
            x = x[:, s * h:(s + 1) * h]
        out[key] = x
    return out


def largest_divisible_dim(shape: Sequence[int], degree: int, *, taken: Optional[set] = None) -> Optional[int]:
    """Index of the largest dimension of ``shape`` divisible by ``degree``,
    skipping indices in ``taken`` (dimensions another axis already shards);
    None when nothing divides. The first such dimension wins a tie. The
    eligibility rule of the ZeRO-1 weight-update specs
    (:mod:`.zero`): a conv filter shards its widest channel dimension, a
    bias shards outright, and only scalars and odd-sized vectors stay
    whole."""
    taken = taken or set()
    best: Optional[int] = None
    for i, d in enumerate(shape):
        if i in taken or d % degree != 0:
            continue
        if best is None or d > shape[best]:
            best = i
    return best
