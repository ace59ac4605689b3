"""Request-granular tracing (the port's copy of the JAX package's
``obs/trace.py``): trace and span ids, sampled spans persisted as ``trace``
ledger events, and the Chrome/Perfetto export.

A span is host wall-clock bookkeeping and never touches the device. The
serve path threads one request through it: the HTTP handler opens the
``request`` root span, and the batcher worker emits retroactive
``queue_wait``/``pad``/``compute`` child spans for each member request,
carrying ``batch_span_id`` attrs that point at the batch trace's own
``compute`` span (one batch serves many requests, so the link is an
attribute, not a parent edge). Sampling is decided per trace at the root:
every span of a sampled trace persists, none of an unsampled one. A disabled
tracer's ``span()`` yields ``None`` after one attribute check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# the ledger event kind sampled spans persist as
TRACE_EVENT = "trace"

# span names the built-in producers use (anything else is allowed)
SPAN_REQUEST = "request"
SPAN_QUEUE_WAIT = "queue_wait"
SPAN_BATCH = "batch"
SPAN_PAD = "pad"
SPAN_COMPUTE = "compute"


def new_id() -> str:
    """64-bit random hex id (trace and span ids share the format). PRNG, not
    ``os.urandom`` — ids need uniqueness, not unpredictability, and the span
    path runs per request, where a syscall is real money."""
    return f"{random.getrandbits(64):016x}"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The portable identity of an open span — what crosses thread/queue
    boundaries (e.g. rides a batcher ``Request``) so another thread can emit
    retroactive child spans into the same trace with the same sampling
    verdict."""

    trace_id: str
    span_id: str
    sampled: bool


@dataclasses.dataclass
class Span:
    """One in-flight (then finished) span. ``children`` collects finished
    child spans while this span is open on the same thread — the serve
    batcher reads the engine's ``pad``/``compute`` children off its ``batch``
    span to mirror them onto member requests."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_t: float
    sampled: bool
    attrs: Dict[str, Any]
    duration_s: float = 0.0
    children: List["Span"] = dataclasses.field(default_factory=list)

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id, self.sampled)


class Tracer:
    """Trace/span factory bound to one emit sink (the run's ledger).

    ``enabled`` is decided once at construction (a sink AND a positive sample
    rate); every path checks it first so a disabled tracer costs one
    attribute read. Thread-local span stacks give automatic parenting within
    a thread; cross-thread spans pass an explicit :class:`TraceContext`.
    """

    def __init__(
        self,
        emit: Optional[Callable[[Dict], None]] = None,
        sample_rate: float = 0.0,
    ):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError(
                f"trace sample_rate must be in [0, 1], got {sample_rate}"
            )
        self.sample_rate = float(sample_rate)
        self.enabled = emit is not None and self.sample_rate > 0.0
        self._emit = emit
        self._tls = threading.local()

    # -- context ------------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def current_context(self) -> Optional[TraceContext]:
        span = self.current()
        return span.context if span is not None else None

    def _sample(self) -> bool:
        return self.sample_rate >= 1.0 or random.random() < self.sample_rate

    # -- spans --------------------------------------------------------------

    @contextlib.contextmanager
    def span(
        self,
        name: str,
        *,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        sampled: Optional[bool] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        """Open a span. With no explicit ``trace_id`` and an enclosing span on
        this thread, the new span joins that trace as a child (inheriting the
        sampling verdict); otherwise it roots a NEW trace whose sampling is
        decided here (or forced via ``sampled``). Yields the :class:`Span`
        (mutate ``attrs`` freely while open), or ``None`` when disabled."""
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        top = stack[-1] if stack else None
        if trace_id is None and top is not None:
            trace_id = top.trace_id
            parent_id = top.span_id if parent_id is None else parent_id
            sampled = top.sampled if sampled is None else sampled
        else:
            trace_id = trace_id or new_id()
            sampled = self._sample() if sampled is None else sampled
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=new_id(),
            parent_id=parent_id,
            start_t=time.time(),
            sampled=bool(sampled),
            attrs=dict(attrs or {}),
        )
        stack.append(span)
        t0 = time.perf_counter()
        try:
            yield span
        finally:
            span.duration_s = time.perf_counter() - t0
            stack.pop()
            if stack:
                stack[-1].children.append(span)
            if span.sampled:
                self._write(span)

    def emit(
        self,
        name: str,
        *,
        trace_id: str,
        parent_id: Optional[str] = None,
        start_t: float,
        duration_s: float,
        sampled: bool = True,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Record a retroactive span from explicit timing — the cross-thread
        path (the batcher worker emitting member-request spans after the
        batch ran). Returns the new span id (generated whether or not the
        span persists, so links stay stable)."""
        span_id = new_id()
        if self.enabled and sampled:
            self._write(
                Span(
                    name=name,
                    trace_id=trace_id,
                    span_id=span_id,
                    parent_id=parent_id,
                    start_t=start_t,
                    sampled=True,
                    attrs=dict(attrs or {}),
                    duration_s=duration_s,
                )
            )
        return span_id

    def _write(self, span: Span) -> None:
        fields: Dict[str, Any] = {
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "start_t": round(span.start_t, 6),
            "duration_s": round(span.duration_s, 6),
        }
        if span.parent_id:
            fields["parent_id"] = span.parent_id
        if span.attrs:
            fields["attrs"] = span.attrs
        self._emit(fields)


# the shared disabled instance — hold this instead of branching on None
NULL_TRACER = Tracer(emit=None, sample_rate=0.0)


# -- Chrome/Perfetto export --------------------------------------------------


def export_chrome_trace(events: List[Dict]) -> Dict:
    """Transform ledger events into Chrome trace-event JSON (the ``{
    "traceEvents": [...] }`` object format both ``chrome://tracing`` and
    Perfetto load).

    Every sampled span becomes one complete ("X") event with the required
    fields (``name``/``ph``/``ts``/``dur``/``pid``/``tid``); trace/span/parent
    ids and attrs ride in ``args``. Traces map to tids (one track per trace)
    so a request's queue→pad→compute children nest under their root visually;
    ``batch_span_id`` links additionally become flow events ("s"/"f") from
    the batch trace's compute span to each member request's compute span."""
    spans = [e for e in events if e.get("event") == TRACE_EVENT]
    trace_events: List[Dict] = []
    if not spans:
        return {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    t0 = min(e.get("start_t", 0.0) for e in spans)
    tids: Dict[str, int] = {}
    by_span_id: Dict[str, Dict] = {}
    for e in spans:
        tid = tids.setdefault(e.get("trace_id", ""), len(tids) + 1)
        if e.get("span_id"):
            by_span_id[e["span_id"]] = e
        args = {
            k: e[k]
            for k in ("trace_id", "span_id", "parent_id")
            if e.get(k) is not None
        }
        args.update(e.get("attrs") or {})
        trace_events.append(
            {
                "name": e.get("name", "span"),
                "cat": "obs",
                "ph": "X",
                "ts": round((e.get("start_t", t0) - t0) * 1e6, 3),
                "dur": round(e.get("duration_s", 0.0) * 1e6, 3),
                "pid": 1,
                "tid": tid,
                "args": args,
            }
        )
    # flow arrows for cross-trace batch links (member compute -> batch compute)
    for e in spans:
        batch_span_id = (e.get("attrs") or {}).get("batch_span_id")
        src = by_span_id.get(batch_span_id) if batch_span_id else None
        if src is None:
            continue
        flow_id = f"{batch_span_id}:{e.get('span_id')}"
        trace_events.append(
            {
                "name": "batch_link",
                "cat": "obs",
                "ph": "s",
                "id": flow_id,
                "ts": round((src.get("start_t", t0) - t0) * 1e6, 3),
                "pid": 1,
                "tid": tids[src.get("trace_id", "")],
            }
        )
        trace_events.append(
            {
                "name": "batch_link",
                "cat": "obs",
                "ph": "f",
                "bp": "e",
                "id": flow_id,
                "ts": round((e.get("start_t", t0) - t0) * 1e6, 3),
                "pid": 1,
                "tid": tids[e.get("trace_id", "")],
            }
        )
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(workdir: str, out_path: str) -> int:
    """Export the last run's sampled spans of every ledger in ``workdir``
    (``telemetry.jsonl`` and ``telemetry-N.jsonl``) to ``out_path`` as
    Chrome trace-event JSON; returns the number of span events written."""
    from tensorflowdistributedlearning_tpu_torch.obs import ledger as ledger_lib

    paths = ledger_lib.ledger_paths(workdir)
    if not paths:
        raise FileNotFoundError(f"no telemetry ledger (telemetry.jsonl / telemetry-N.jsonl) under {workdir}")
    events = [e for p in paths for e in ledger_lib.last_run_events(ledger_lib.read_ledger(p))]
    doc = export_chrome_trace(events)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
