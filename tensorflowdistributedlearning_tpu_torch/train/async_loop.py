"""Host–device overlap for the training loops: bounded dispatch-ahead and
deferred window fetches (the port's counterpart of the JAX package's
``train/async_loop.py``, same classes and semantics).

Eager PyTorch launches a step's kernels and returns; the host blocks only
where it reads a device value. The trainers' log windows read their
metrics, so without this module every window drains the card's queue
before the next step is launched, and an eval pass would read its metrics
batch by batch. This module owns the three pieces:

- **bounded dispatch-ahead** (:meth:`HostOverlap.track`): each dispatched
  train step records a ``torch.cuda.Event`` on the stream that ran it; past
  ``TrainConfig.dispatch_ahead_steps`` unfinished steps the host
  synchronizes on the oldest one under the ``fetch_wait`` span, so the
  backpressure is bounded and measured;
- **deferred window metrics** (:meth:`HostOverlap.window` / :meth:`flush`):
  at a window boundary the metrics are copied with ``non_blocking=True``
  into pinned host tensors behind an event, and fetched and emitted at the
  next boundary while the card runs the next window. The window's span
  samples are snapshotted at its boundary, so a window written late still
  describes its own interval. ``flush()`` runs at every eval, checkpoint
  and end boundary;
- **device-resident eval accumulation** (:func:`merge_metrics_device` +
  :func:`fetch_metrics`): the eval accumulator stays on the card, with one
  host transfer per pass (counted under :data:`EVAL_FETCH_COUNTER`).

``dispatch_ahead_steps=0`` is the synchronous loop: the window's metrics
are read in place (under the ``step`` span) and nothing is tracked. On the
CPU there is nothing to wait for: the events are absent and the copies
plain, and only the orderings of this module remain (what the CPU tests
compare with the JAX package's).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import torch

from tensorflowdistributedlearning_tpu_torch.obs.telemetry import SPAN_FETCH_WAIT, SPAN_STEP
from tensorflowdistributedlearning_tpu_torch.ops.metrics import Mean
from tensorflowdistributedlearning_tpu_torch.train import step as step_lib

# registry counter: one increment per eval pass's metric transfer
EVAL_FETCH_COUNTER = "fetch/eval_metrics"


def _first_tensor(tree: Any) -> Optional[torch.Tensor]:
    """The first tensor of a metric-state dict (``Mean`` leaves), or the
    tensor itself."""
    if isinstance(tree, torch.Tensor):
        return tree
    for leaf in tree.values() if isinstance(tree, dict) else ():
        return leaf.total if isinstance(leaf, Mean) else leaf
    return None


def _device_event(tree: Any) -> Optional["torch.cuda.Event"]:
    """An event recorded on the current stream of ``tree``'s card, after
    the work that produced it; None off CUDA."""
    leaf = _first_tensor(tree)
    if leaf is None or leaf.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(leaf.device))
    return event


class DispatchBudget:
    """Bounded dispatch-ahead over any loop of device work: ``track(tree)``
    once per dispatched step with one of its outputs; past ``budget``
    unfinished steps it synchronizes on the oldest (under ``span``, the
    ``fetch_wait`` window span by default; None records nothing). Tracking
    copies nothing. ``budget <= 0`` tracks nothing."""

    def __init__(self, telemetry, budget: int, span: Optional[str] = SPAN_FETCH_WAIT):
        self._tel = telemetry
        self._budget = int(budget)
        self._span = span
        self._inflight: deque = deque()

    @property
    def budget(self) -> int:
        return self._budget

    def track(self, tree: Any) -> None:
        if self._budget <= 0 or _first_tensor(tree) is None:
            return
        self._inflight.append(_device_event(tree))
        if len(self._inflight) > self._budget:
            oldest = self._inflight.popleft()
            if self._span is None:
                _wait(oldest)
            else:
                with self._tel.span(self._span):
                    _wait(oldest)

    def drain(self) -> None:
        """Wait for every tracked step (the newest one's event: a stream
        runs its work in order), under ``span``; nothing is in flight
        after it."""
        if not self._inflight:
            return
        newest = self._inflight[-1]
        self._inflight.clear()
        if self._span is None:
            _wait(newest)
        else:
            with self._tel.span(self._span):
                _wait(newest)


def _wait(event) -> None:
    if event is not None:
        event.synchronize()


def eval_budget(telemetry, dispatch_ahead: int) -> DispatchBudget:
    """The eval pass's in-flight bound: at least 1 (an unbounded host would
    queue every eval batch's copy and forward at once), at most the train
    loop's dispatch-ahead. ``span=None``: these waits sit inside the eval
    span, whose wall time the eval event already holds."""
    return DispatchBudget(telemetry, max(1, int(dispatch_ahead)), span=None)


@dataclasses.dataclass
class PendingWindow:
    """One log window's deferred payload: the step's device metrics and the
    host facts of the emit, captured at the boundary (throughput, the next
    update's lr, the span samples of the window's own interval)."""

    step: int
    metrics: Any  # Dict[str, ops.metrics.Mean] on the device
    steps: int
    lr: float
    images_per_sec: Optional[float] = None
    dirty: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    samples: Optional[Dict[str, List[float]]] = None


def _to_host(metrics: Dict[str, Mean], non_blocking: bool) -> Dict[str, Mean]:
    """The metric states copied to host tensors: pinned, with
    ``non_blocking`` from a card; plain clones on the CPU."""
    out = {}
    for name, m in metrics.items():
        parts = []
        for t in (m.total, m.count):
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=non_blocking)
            else:
                host = t.detach().clone()
            parts.append(host)
        out[name] = Mean(*parts)
    return out


class HostOverlap:
    """The trainers' host–device overlap state machine (one per run phase).

    ``emit(record, scalars)`` is the trainer's write-out (TensorBoard
    scalars and the ledger's window event); it fires in place in sync mode
    and one boundary late in async mode. ``telemetry`` provides the spans
    the blocked time is recorded through (``NULL_TELEMETRY`` works)."""

    def __init__(self, telemetry, *, dispatch_ahead: int = 2,
                 emit: Callable[[PendingWindow, Dict[str, float]], None]):
        self._tel = telemetry
        self._emit = emit
        self._tracker = DispatchBudget(telemetry, max(0, int(dispatch_ahead)))
        self._pending: Optional[PendingWindow] = None
        self._pending_host: Optional[Dict[str, Mean]] = None
        self._pending_event = None

    @property
    def async_mode(self) -> bool:
        return self._tracker.budget > 0

    def track(self, metrics: Any) -> None:
        """Once per dispatched train step, with its metrics: past the budget,
        synchronize on the oldest unfinished step (as ``fetch_wait``). A
        no-op in sync mode."""
        self._tracker.track(metrics)

    def drain(self) -> None:
        """Wait, as ``fetch_wait``, for every step in flight: before the
        host reads a value that depends on them (the trainer's image
        summaries), so that read's wait is not charged to the read. A no-op
        in sync mode, whose window read already waited."""
        self._tracker.drain()

    def window(self, record: PendingWindow) -> None:
        """A log-window boundary. Sync mode reads and emits in place (the
        read waits for this step, under the ``step`` span). Async mode
        emits the previous window, snapshots this window's span samples,
        starts the host copy behind an event and defers."""
        if not self.async_mode:
            with self._tel.span(SPAN_STEP):
                host = _to_host(record.metrics, non_blocking=False)
            self._emit(record, self._scalars(record, host))
            return
        self.flush()
        record.samples = self._tel.drain_window_samples()
        self._pending_host = _to_host(record.metrics, non_blocking=True)
        self._pending_event = _device_event(record.metrics)
        self._pending = record

    def flush(self) -> None:
        """Wait for and emit the deferred window, if any: at every eval,
        checkpoint and end boundary, so the ledger is complete before any
        event that follows. Idempotent."""
        record, self._pending = self._pending, None
        if record is None:
            return
        host, event = self._pending_host, self._pending_event
        self._pending_host = self._pending_event = None
        with self._tel.span(SPAN_FETCH_WAIT):
            _wait(event)
        self._emit(record, self._scalars(record, host))

    @staticmethod
    def _scalars(record: PendingWindow, host_metrics: Dict[str, Mean]) -> Dict[str, float]:
        """The window's scalars: its last step's metrics, the throughput and
        the lr, as the JAX package's."""
        scalars = step_lib.compute_metrics(host_metrics)
        if record.images_per_sec is not None:
            scalars["throughput/images_per_sec"] = record.images_per_sec
        scalars["lr"] = record.lr
        return scalars


def merge_metrics_device(acc: Optional[Dict[str, Mean]], new: Dict[str, Mean]) -> Dict[str, Mean]:
    """The eval pass's streaming merge on the device: ``None`` starts it
    (every leaf must be a ``Mean``, whose merge is addition), later calls
    add."""
    if acc is None:
        for name, leaf in new.items():
            if not isinstance(leaf, Mean):
                raise TypeError(
                    f"eval metric {name!r} is a {type(leaf).__name__}, not a Mean state — the device-resident "
                    "accumulator merges by addition, which is only a valid merge for Mean's (total, count)"
                )
        return new
    return step_lib.merge_metrics(acc, new)


def fetch_metrics(acc: Optional[Dict[str, Mean]], telemetry=None) -> Dict[str, float]:
    """The one host transfer of an eval pass, counted under
    :data:`EVAL_FETCH_COUNTER` in ``telemetry``'s registry."""
    if acc is None:
        raise ValueError("fetch_metrics: no eval batches were accumulated")
    if telemetry is not None:
        telemetry.registry.counter(EVAL_FETCH_COUNTER).inc()
    return step_lib.compute_metrics(acc)
