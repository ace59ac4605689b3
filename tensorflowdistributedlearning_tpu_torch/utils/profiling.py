"""Tracing and profiling utilities (counterpart of the JAX package's
``utils/profiling.py``), over ``torch.profiler``, ``torch.cuda.synchronize``
and the CUDA caching allocator:

- :func:`trace`: a ``torch.profiler`` capture of the enclosed block, written
  to a log directory as a Chrome trace (TensorBoard's and Perfetto's
  viewers read it);
- :func:`annotate`: a named span in the profiler's timeline
  (``torch.profiler.record_function``);
- :func:`sync`: wait for the work behind every tensor of a nest, then fetch
  one value (the JAX package's robust barrier);
- :class:`StepTimer`: per-step wall times in ``obs.metrics.TimeHistogram``;
- :func:`memory_stats` and :func:`log_memory`: per-card allocator bytes
  under the JAX keys ``bytes_in_use``, ``peak_bytes_in_use`` and
  ``bytes_limit``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (host ops, and the card's kernels
    when CUDA is available) of the enclosed block into
    ``logdir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named span visible in the profiler's timeline (host and device)."""
    return torch.profiler.record_function(name)


def sync(tree: Any) -> None:
    """Wait for every tensor of ``tree``: synchronise the cards its CUDA
    tensors live on, then fetch one value (an actual read, the barrier the
    JAX package's ``sync`` ends with)."""
    leaves = list(_tensors(tree))
    if not leaves:
        return
    for index in sorted({t.device.index or 0 for t in leaves if t.device.type == "cuda"}):
        torch.cuda.synchronize(index)
    leaves[0].detach().reshape(-1)[:1].cpu()


class StepTimer:
    """Per-step wall times; ``summary()`` reports mean/p50/p90/p99 and,
    with ``items_per_step``, items/sec. Pass the step's output to
    :meth:`stop` and it is :func:`sync`'d before the clock stops. The
    samples live in an ``obs.metrics.TimeHistogram``, the one step-timing
    implementation the telemetry spans share."""

    def __init__(self, items_per_step: Optional[int] = None):
        from tensorflowdistributedlearning_tpu_torch.obs.metrics import TimeHistogram

        self.items_per_step = items_per_step
        self._hist = TimeHistogram("step")
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, outputs: Any = None) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        if outputs is not None:
            sync(outputs)
        dt = time.perf_counter() - self._t0
        self._hist.record(dt)
        self._t0 = None
        return dt

    @contextlib.contextmanager
    def step(self):
        """``with timer.step(): out = train_step(...); sync(out)``: the caller
        syncs inside the block (or uses ``start()``/``stop(outputs)``),
        otherwise only the launches are timed."""
        self.start()
        yield
        self.stop()

    @property
    def times(self) -> List[float]:
        return self._hist.samples

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        """Timing statistics, the first ``skip_first`` (warm-up) steps left
        out."""
        if not len(self._hist):
            raise RuntimeError("StepTimer.summary(): no steps recorded")
        out = self._hist.summary(skip_first=skip_first)
        out["steps"] = out.pop("count")
        if self.items_per_step:
            out["items_per_sec"] = self.items_per_step / out["mean_s"]
        return out


def memory_stats(devices=None) -> Dict[str, Dict[str, int]]:
    """Per card (``devices``, default every card this process sees):
    ``bytes_in_use``, ``peak_bytes_in_use`` (the caching allocator's
    current and peak allocated bytes) and ``bytes_limit`` (the card's
    memory), keyed ``cuda:{i}``: ``obs.capacity.memory_stats`` with CUDA
    initialised. Empty without CUDA, as the JAX package's leaves out
    devices whose runtime reports nothing (its CPU builds)."""
    from tensorflowdistributedlearning_tpu_torch.obs.capacity import memory_stats as allocator_stats

    if not torch.cuda.is_available():
        return {}
    torch.cuda.init()
    return allocator_stats(devices if devices is not None else [f"cuda:{i}" for i in range(torch.cuda.device_count())])


def log_memory(logger_fn=None) -> Dict[str, Dict[str, int]]:
    """Log (and return) a compact per-card summary: in use, peak, limit."""
    import logging as _logging

    log = logger_fn or _logging.getLogger(__name__).info
    stats = memory_stats()
    for dev, s in stats.items():
        log("%s: %.1f MiB in use (peak %.1f MiB, limit %.1f MiB)", dev, s.get("bytes_in_use", 0) / 2**20,
            s.get("peak_bytes_in_use", 0) / 2**20, s.get("bytes_limit", 0) / 2**20)
    return stats
