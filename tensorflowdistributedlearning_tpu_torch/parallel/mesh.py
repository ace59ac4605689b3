"""The one batch axis of the data-parallel step (counterpart of the JAX
package's ``parallel/mesh.py``, cut to the data-parallel mesh).

The JAX package lays a global batch over its ``batch`` mesh axis in
contiguous blocks; here every rank is one position on that axis, so rank r
of W owns rows ``[r·B/W, (r+1)·B/W)`` (:func:`shard_rows`), the rows
``shard_batch`` gives the r-th device.
"""

from __future__ import annotations

from typing import Optional, Sequence

from tensorflowdistributedlearning_tpu_torch.parallel import collectives


# the ranks a global batch is split over (1 without a group), under the
# JAX package's name
data_parallel_degree = collectives.world_size


def local_batch_size(global_batch: int, degree: Optional[int] = None) -> int:
    """Per-rank batch size; ``global_batch`` must divide evenly over the
    ``degree`` ranks (default :func:`data_parallel_degree`). The check is
    :func:`multihost.per_process_batch_size`'s, with the error text of the
    JAX package's ``mesh.local_batch_size`` where that one has the text of
    its ``multihost.per_process_batch_size``."""
    n = data_parallel_degree() if degree is None else degree
    if global_batch % n != 0:
        raise ValueError(f"Batch size {global_batch} must be divisible by the data-parallel degree {n}")
    return global_batch // n


def shard_rows(global_batch: int, rank: Optional[int] = None, world: Optional[int] = None) -> slice:
    """The contiguous rows of a ``global_batch`` that ``rank`` of ``world``
    owns (default: this process in the default group)."""
    rank = collectives.rank() if rank is None else rank
    local = local_batch_size(global_batch, world)
    return slice(rank * local, (rank + 1) * local)


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
