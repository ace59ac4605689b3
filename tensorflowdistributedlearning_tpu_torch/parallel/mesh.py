"""The one batch axis of the data-parallel step (counterpart of the JAX
package's ``parallel/mesh.py``, cut to the data-parallel mesh).

The JAX package lays a global batch over its ``batch`` mesh axis in
contiguous blocks; here every rank is one position on that axis, so rank r
of W owns rows ``[r·B/W, (r+1)·B/W)`` (:func:`shard_rows`), the rows
``shard_batch`` gives the r-th device.
"""

from __future__ import annotations

from typing import Optional

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
