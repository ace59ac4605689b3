"""The (batch, model) layout of the ranks (counterpart of the JAX package's
``parallel/mesh.py``, cut to the data and model axes).

The JAX package reshapes its devices as ``(dp, model, sequence)``; here a
rank owns one device, so under ``model_parallel = tp`` rank r of W is data
index ``r // tp`` and model index ``r % tp`` (:class:`Layout`). The ranks
of one data index form a model group: they hold the channel slices of one
replica (``parallel/tensor.py``) and read the same rows. The ranks of one
model index form a data group: they hold the same slices, average their
gradients and BN statistics, and sum their metrics. At ``tp = 1`` the data
group is the default group and there is no model group.

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


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place on the ``(dp, tp)`` grid and its two groups
    (``None`` for the default group, and for no model group at ``tp = 1``)."""

    world: int
    tp: int
    rank: int
    model_group: Any = None
    data_group: Any = None
    # the default group the groups were made in (None without one)
    world_group: Any = None

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


def init_mesh(model_parallel: int = 1) -> Layout:
    """Lay the ranks of the process group out as ``(world / tp, tp)`` and
    make this process's layout the one every helper here reads. Every rank
    calls it with the same degree (it makes every group, in one order).
    Raises when the degree does not divide the world, with the JAX
    package's ``make_mesh`` text."""
    global _LAYOUT
    tp = int(model_parallel)
    world, rank = collectives.world_size(), collectives.rank()
    if tp < 1 or world % tp != 0:
        raise ValueError(f"{world} devices not divisible by model_parallel*sequence_parallel={tp}")
    current = _LAYOUT
    if current is not None and current.world_group is _world_group() and (current.world, current.tp) == (world, tp):
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
    _LAYOUT = Layout(world, tp, rank, model_group, data_group, _world_group())
    return _LAYOUT


def layout() -> Layout:
    """This process's layout: the one :func:`init_mesh` made for the
    current process group, else ``tp = 1`` over it."""
    current = _LAYOUT
    world = collectives.world_size()
    if current is not None and current.world_group is _world_group() and current.world == world:
        return current
    return Layout(world, 1, collectives.rank(), None, None, _world_group())


def data_parallel_degree() -> int:
    """The data-parallel degree: the world over the model-parallel degree."""
    return layout().dp


def model_parallel_degree() -> int:
    """The tensor-parallel degree (1 without :func:`init_mesh`)."""
    return layout().tp


def data_index() -> int:
    """This rank's position on the data axis (its model group's index)."""
    return layout().data_index


def model_index() -> int:
    """This rank's position on the model axis (its channel slice)."""
    return layout().model_index


def data_group():
    """The group the gradients, BN statistics and metrics reduce over: None
    (the default group) at ``tp = 1``; at ``dp = 1`` a group of one rank,
    over which every collective of :mod:`.collectives` is the identity."""
    return layout().data_group


def model_group():
    """The group of the ranks that hold one replica's channel slices (None
    at ``tp = 1``)."""
    return layout().model_group


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
