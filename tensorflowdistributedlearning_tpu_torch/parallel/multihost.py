"""Processes of a data-parallel run (counterpart of the JAX package's
``parallel/multihost.py``).

A process is a rank and a rank owns one device: the PyTorch idiom (one
process per card, as ``torchrun`` launches them) and the JAX package's
multi-process model with one device per process. :func:`initialize` joins
the default process group, NCCL for ranks on CUDA devices and gloo for
ranks on the CPU (or for ranks that share one card, which NCCL refuses);
every other function here works with or without a group, and without one is
the single-process answer.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# the telemetry whose `barrier_wait` span times the sync points below (the
# trainers register theirs for the run; at most one run per process)
_probe_telemetry = None


def instrument(telemetry) -> None:
    """Time :func:`barrier` and :func:`broadcast_object` as ``telemetry``'s
    ``barrier_wait`` span: per-window barrier wait lands in the step
    windows, where per-rank asymmetry tells a slow rank from a slow link."""
    global _probe_telemetry
    _probe_telemetry = telemetry


def uninstrument(telemetry=None) -> None:
    """Detach the probe (only if ``telemetry``, when given, is the one
    registered)."""
    global _probe_telemetry
    if telemetry is None or _probe_telemetry is telemetry:
        _probe_telemetry = None


@contextlib.contextmanager
def barrier_probe():
    """The ``barrier_wait`` span around one sync point; a no-op without an
    instrumented, enabled telemetry."""
    tel = _probe_telemetry
    if tel is None or not getattr(tel, "enabled", False):
        yield
        return
    from tensorflowdistributedlearning_tpu_torch.obs.telemetry import SPAN_BARRIER

    with tel.span(SPAN_BARRIER):
        yield


def backend_for(device) -> str:
    """The backend of ranks on ``device``: gloo for the CPU, NCCL otherwise
    (``None`` is this rank's GPU)."""
    return "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> None:
    """Join the default process group; a no-op when one exists.

    With explicit arguments the group is ``coordinator_address`` (``HOST:PORT``
    or a ``tcp://`` / ``file://`` URL), ``num_processes`` ranks and this
    ``process_id``, and a failure to join raises. Without them the group is
    discovered from ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``; without those the run is one process
    and no group is made. ``backend`` defaults to NCCL (the GPU); it is never
    swapped for another. ``timeout`` bounds every collective, in seconds.
    Under NCCL the rank's device (:func:`local_device`) becomes the current
    CUDA device."""
    if collectives.is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    kwargs: Dict[str, Any] = {}
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError(
                "an explicit process group needs coordinator_address, num_processes and process_id together"
            )
        address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs.update(init_method=address, world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        kwargs.update(init_method="env://")
    else:
        return
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA device; ranks on the CPU use backend='gloo'")
        torch.cuda.set_device(local_device_index(kwargs.get("rank", int(os.environ.get("RANK", 0)))))
    dist.init_process_group(backend=backend, **kwargs)


def shutdown() -> None:
    """Leave the default process group, if any."""
    if collectives.is_initialized():
        dist.destroy_process_group()


# the JAX package's names for this rank and the world size
process_index = collectives.rank
process_count = collectives.world_size


def is_main() -> bool:
    """Whether this is rank 0, the process that writes files and logs."""
    return process_index() == 0


def process_info() -> Dict[str, int]:
    """The JAX package's ``process_info`` keys; a rank owns one device."""
    n = process_count()
    return {"process_index": process_index(), "process_count": n, "local_device_count": 1, "global_device_count": n}


def data_slot() -> Tuple[int, int]:
    """``(this rank's data index, the data-parallel degree)``: the slot of
    the input pipeline, which splits batches, ids, record shards and seeds
    over the data positions (``parallel/mesh.py``), so the ranks of one
    model group read the same rows. Without tensor parallelism it is
    ``(process_index(), process_count())``."""
    lay = mesh.layout()
    if lay.tp == 1:
        return process_index(), process_count()
    return lay.data_index, lay.dp


def local_device_index(rank: Optional[int] = None) -> int:
    """This rank's CUDA device index: ``LOCAL_RANK`` when the launcher set
    it, else the rank modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = process_index() if rank is None else rank
    return rank % max(torch.cuda.device_count(), 1)


def local_device() -> torch.device:
    """This rank's GPU, made the current CUDA device; raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a rank runs on its GPU unless the caller passes device='cpu'")
    index = local_device_index()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def require_world_size(n_devices: Optional[int]) -> None:
    """Raise unless ``n_devices`` (a config's device count; None takes
    whatever the launcher set up) is this run's process count: a rank owns
    one device."""
    world = process_count()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"n_devices={n_devices} but this run has {world} process(es): a rank owns one device, so launch "
            f"{n_devices} ranks (torchrun --nproc-per-node {n_devices}, or --coordinator-address/--num-processes/"
            "--process-id on every rank) or leave n_devices unset"
        )


def per_process_batch_size(global_batch: int) -> int:
    """This process's share of every global batch (``global_batch`` over
    the data-parallel degree, :func:`data_slot`)."""
    p = data_slot()[1]
    if global_batch % p != 0:
        raise ValueError(f"Global batch size {global_batch} must be divisible by the process count {p}")
    return global_batch // p


def eval_num_batches(global_n: int, per_process_batch: int) -> int:
    """Eval steps EVERY process runs for a ``global_n``-example eval set split
    round-robin over the processes (``data.pipeline.host_shard``): the
    largest shard, ``ceil(global_n / P)``, sets the count, so every rank
    enters the same number of collectives; smaller shards pad with valid=0
    batches. P is the data-parallel degree (:func:`data_slot`)."""
    p = data_slot()[1]
    max_shard = -(-global_n // p)
    return max(1, -(-max_shard // per_process_batch))


def all_processes_max_batches(local_n: int, per_process_batch: int) -> int:
    """Equalized eval step count when each process holds its own shard of
    unknown global size: the maximum over the processes of
    ``ceil(local_n / batch)`` (an all-reduce MAX)."""
    mine = max(1, -(-local_n // per_process_batch)) if local_n else 1
    if process_count() == 1:
        return mine
    t = torch.tensor([mine], dtype=torch.int64, device=collectives.collective_device())
    collectives.pmax_(t)
    return int(t.item())


def barrier() -> None:
    if collectives.is_initialized():
        with barrier_probe():
            dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` (picklable) on every rank; ``obj`` itself
    without a group. The other ranks return only after rank ``src`` has made
    the call, so a file rank ``src`` wrote before it is complete when they
    return."""
    if not collectives.is_initialized():
        return obj
    box = [obj]
    with barrier_probe():
        dist.broadcast_object_list(box, src=src, device=collectives.collective_device())
    return box[0]
