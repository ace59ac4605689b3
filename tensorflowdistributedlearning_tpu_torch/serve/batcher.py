"""Dynamic micro-batching with a bounded queue and explicit backpressure
(counterpart of the JAX package's ``serve/batcher.py``).

Concurrent callers ``submit`` individually; one worker thread coalesces
what is queued into the largest batch that fits the engine's top bucket,
waiting at most ``max_wait_ms`` after the head request *enqueued*
(continuous batching: a backlog built up during a compute dispatches at
once). The queue is bounded — a full queue raises :class:`QueueFullError`
at submit (HTTP 429) — requests may carry deadlines (expired ones complete
with :class:`DeadlineExceededError`, HTTP 504, without taking a bucket
slot), and ``close(drain=True)`` stops intake and finishes everything
already accepted.

Each request may carry its submitter's ``obs.trace.TraceContext``:
the worker then emits the request's ``queue_wait`` span and, around the
engine call, a ``batch`` span (its own trace, kept when any member request
is sampled) under which the engine's ``pad`` and ``compute`` spans nest;
those two are mirrored onto every member request's trace with a
``batch_span_id`` link. With a ``cost_meter`` attached (the server does),
each batch's engine time is split across its member requests as
chip-seconds (``obs/capacity.py``).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Deque, List, Optional

import numpy as np

from tensorflowdistributedlearning_tpu_torch.obs import trace as trace_lib
from tensorflowdistributedlearning_tpu_torch.serve.engine import InferenceEngine, RequestTooLargeError

__all__ = [
    "DeadlineExceededError",
    "MicroBatcher",
    "QueueFullError",
    "RequestTooLargeError",
    "ServerClosedError",
]


class QueueFullError(RuntimeError):
    """Bounded queue at capacity (HTTP 429); nothing was enqueued."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed while it waited in the queue (HTTP 504)."""


class ServerClosedError(RuntimeError):
    """``submit`` after ``close()`` — the server is draining (HTTP 503)."""


class Request:
    """Future-like handle for one submitted request; ``trace`` is the
    submitter's open span context (or None)."""

    __slots__ = ("x", "n", "deadline_t", "enqueued_t", "trace", "_event", "_result", "_error")

    def __init__(self, x: np.ndarray, deadline_t: Optional[float], trace: Optional[trace_lib.TraceContext] = None):
        self.x = x
        self.n = x.shape[0]
        self.deadline_t = deadline_t
        self.enqueued_t = time.monotonic()
        self.trace = trace
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the outcome; raises the request's structured error."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending after result() timeout")
        if self._error is not None:
            raise self._error
        return self._result

    def _finish(self, result=None, error: Optional[BaseException] = None):
        self._result, self._error = result, error
        self._event.set()


class MicroBatcher:
    """Coalesces concurrent ``submit`` calls into engine-sized batches."""

    def __init__(
        self,
        engine: InferenceEngine,
        *,
        max_batch_size: Optional[int] = None,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        default_deadline_ms: Optional[float] = None,
    ):
        self.engine = engine
        self.max_batch_size = min(max_batch_size or engine.max_batch_size, engine.max_batch_size)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self.max_queue = int(max_queue)
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.default_deadline_ms = default_deadline_ms
        self.registry = engine.registry
        self.cost_meter = None  # obs.capacity.CostMeter, attached by the server
        self._queue: Deque[Request] = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._run, name="serve-microbatcher", daemon=True)
        self._worker.start()

    def submit(
        self, x, *, deadline_ms: Optional[float] = None, trace: Optional[trace_lib.TraceContext] = None
    ) -> Request:
        """Enqueue ``x`` ([n, *example_shape] or one bare example); returns a
        :class:`Request`. Raises at once — never queues — when closed, too
        large, malformed, or the queue is full."""
        x = np.asarray(x, self.engine.input_dtype)
        if x.shape == self.engine.example_shape:
            x = x[None]
        if x.shape[1:] != self.engine.example_shape or x.shape[0] < 1:
            raise ValueError(f"expected [n, *{self.engine.example_shape}] or a bare example, got {x.shape}")
        if x.shape[0] > self.max_batch_size:
            raise RequestTooLargeError(
                f"{x.shape[0]} examples exceeds max_batch_size={self.max_batch_size}; chunk the request"
            )
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline_t = time.monotonic() + deadline_ms / 1000.0 if deadline_ms is not None else None
        req = Request(x, deadline_t, trace=trace)
        with self._cond:
            if self._closed:
                raise ServerClosedError("batcher is draining; not accepting requests")
            if len(self._queue) >= self.max_queue:
                self.registry.counter("serve/rejected_queue_full").inc()
                raise QueueFullError(f"request queue full ({self.max_queue} pending)")
            self._queue.append(req)
            self.registry.counter("serve/requests").inc()
            self.registry.gauge("serve/queue_depth").set(len(self._queue))
            self._cond.notify()
        return req

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0) -> None:
        """Stop intake; with ``drain`` the worker finishes every accepted
        request, otherwise pending ones fail with ServerClosedError."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._queue:
                    self._queue.popleft()._finish(error=ServerClosedError("server shut down before dispatch"))
                self.registry.gauge("serve/queue_depth").set(0)
            self._cond.notify_all()
        self._worker.join(timeout)

    def _expire(self, req: Request) -> None:
        self.registry.counter("serve/deadline_exceeded").inc()
        waited_ms = (time.monotonic() - req.enqueued_t) * 1000
        req._finish(error=DeadlineExceededError(f"deadline expired after {waited_ms:.1f}ms in queue"))

    def _collect(self) -> Optional[List[Request]]:
        """One coalescing window; None only when closed AND drained."""
        batch: List[Request] = []
        total = 0
        window_end: Optional[float] = None
        with self._cond:
            while True:
                now = time.monotonic()
                while self._queue and self._queue[0].deadline_t is not None and now > self._queue[0].deadline_t:
                    self._expire(self._queue.popleft())
                if self._queue and total + self._queue[0].n <= self.max_batch_size:
                    req = self._queue.popleft()
                    batch.append(req)
                    total += req.n
                    if window_end is None:
                        window_end = req.enqueued_t + self.max_wait_s
                    if total >= self.max_batch_size:
                        break
                    continue
                if batch and self._queue:
                    break  # the head request needs the next batch
                if self._closed:
                    if batch:
                        break
                    if not self._queue:
                        return None
                    continue
                if not batch:
                    self._cond.wait()
                    continue
                remaining = window_end - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            self.registry.gauge("serve/queue_depth").set(len(self._queue))
        return batch

    def _execute(self, batch: List[Request]) -> None:
        now = time.monotonic()
        wall_now = time.time()
        wait_h = self.registry.histogram("serve/queue_wait")
        for req in batch:
            wait_h.record(now - req.enqueued_t)
        x = np.concatenate([r.x for r in batch]) if len(batch) > 1 else batch[0].x
        tracer = self.engine.tracer
        traced = [r for r in batch if tracer.enabled and r.trace is not None]
        batch_span = None
        for req in traced:
            tracer.emit(
                trace_lib.SPAN_QUEUE_WAIT,
                trace_id=req.trace.trace_id,
                parent_id=req.trace.span_id,
                start_t=wall_now - (now - req.enqueued_t),
                duration_s=now - req.enqueued_t,
                sampled=req.trace.sampled,
            )
        infer_t0 = time.perf_counter()
        try:
            if traced:
                with tracer.span(
                    trace_lib.SPAN_BATCH,
                    sampled=any(r.trace.sampled for r in traced),
                    attrs={"requests": len(batch), "examples": sum(r.n for r in batch)},
                ) as batch_span:
                    out = self.engine.infer(x)
            else:
                out = self.engine.infer(x)
        except Exception as e:  # noqa: BLE001 — fail the requests, not the worker
            self.registry.counter("serve/errors").inc(len(batch))
            for req in batch:
                req._finish(error=e)
            return
        if self.cost_meter is not None:
            self.cost_meter.add_batch(time.perf_counter() - infer_t0, [r.n for r in batch])
        if batch_span is not None:
            self._emit_member_spans(tracer, traced, batch_span)
        offset = 0
        for req in batch:
            lo, hi = offset, offset + req.n
            req._finish(result={k: v[lo:hi] for k, v in out.items()})
            offset = hi
        self.registry.counter("serve/completed").inc(len(batch))
        self.registry.counter("serve/batches").inc()
        self.registry.counter("serve/batched_examples").inc(offset)

    @staticmethod
    def _emit_member_spans(tracer, traced: List[Request], batch_span) -> None:
        """Mirror the batch's pad and compute spans onto each member
        request's trace, linked to the batch trace's compute span by the
        ``batch_trace_id`` / ``batch_span_id`` attrs."""
        children = {c.name: c for c in batch_span.children}
        compute = children.get(trace_lib.SPAN_COMPUTE)
        for name in (trace_lib.SPAN_PAD, trace_lib.SPAN_COMPUTE):
            child = children.get(name)
            if child is None:
                continue
            link = {
                "batch_trace_id": batch_span.trace_id,
                "batch_span_id": compute.span_id if compute is not None else batch_span.span_id,
                **child.attrs,
            }
            for req in traced:
                tracer.emit(
                    name,
                    trace_id=req.trace.trace_id,
                    parent_id=req.trace.span_id,
                    start_t=child.start_t,
                    duration_s=child.duration_s,
                    sampled=req.trace.sampled,
                    attrs=link,
                )

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            self._execute(batch)
