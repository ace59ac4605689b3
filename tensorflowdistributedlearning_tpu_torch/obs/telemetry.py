"""The ``Telemetry`` façade of the trainers and the serve tier (the port's
copy of the JAX package's ``obs/telemetry.py``, same event names, fields
and semantics): a ledger with its ``run_header`` and ``run_end``, a metrics
registry, spans, the request and step tracer, the capacity and cost
meters, the health monitors, the profiler hook and a count of first runs.

One object per run, constructed against the run's workdir. Span accounting
(host wall time, as in the JAX package): ``data_wait`` is the host blocked
on the input iterator, ``step`` the rest of the loop body (the launches of
one train step, and the wait for the device once the launch queue is
full), ``fetch_wait`` the host blocked on a device value (the async loop's
bounded dispatch-ahead and deferred window fetch, ``train/async_loop.py``),
``barrier_wait`` a cross-process sync point. A ``step_window`` event
carries the split, per-step percentiles, throughput and ``mfu``: the
analytic step FLOPs (:meth:`Telemetry.set_step_flops`, JAX's ``6 · params
· global_batch``) over the window's time per step against the card's peak.
The time per step is the window's ``(compute_s + fetch_wait_s) / steps``,
not the mean ``step`` span the JAX package divides by: an eager step span
holds a step's launches, and the wait for the card lands in ``fetch_wait``
(dispatch-ahead) or in the window's read (a ``step`` sample of its own in
the synchronous loop), so the mean span alone would price the launches.

First runs: in the JAX package each jitted function is an XLA executable,
and its recompile detector counts compiles, flagging those after warmup.
Eager PyTorch compiles nothing per shape; the event that compiles in JAX is
a first run (it loads the kernels, settles cuDNN's algorithm choice and
grows the caching allocator): a serving bucket's first run, and the first
``step`` and ``eval`` span of a training run. :class:`FirstRunDetector`
counts those under the JAX event name ``compile`` and field names, so the
run's ``recompiles_post_warmup`` is the number of first runs after the
phase was marked warm.

``NULL_TELEMETRY`` is the disabled instance: no workdir, no ledger, spans
near-free, so callers never branch on None.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from tensorflowdistributedlearning_tpu_torch.obs import capacity as capacity_lib
from tensorflowdistributedlearning_tpu_torch.obs import trace as trace_lib
from tensorflowdistributedlearning_tpu_torch.obs.ledger import RunLedger, per_process_filename
from tensorflowdistributedlearning_tpu_torch.obs.metrics import (
    MetricsRegistry,
    time_summary,
    window_count,
    window_total_s,
)

logger = logging.getLogger(__name__)

COMPILE_EVENT = "compile"

# span names the trainers use (the schema; any other name is allowed)
SPAN_DATA_WAIT = "data_wait"
SPAN_STEP = "step"
SPAN_EVAL = "eval"
SPAN_FETCH_WAIT = "fetch_wait"
SPAN_CHECKPOINT = "checkpoint"
SPAN_BARRIER = "barrier_wait"

# the input prefetcher's ready-queue depth at each take (data/pipeline.py)
PREFETCH_DEPTH_HISTOGRAM = "prefetch/queue_depth"
# the data service's backpressure (data/service.py): reorder-buffer depth at
# each take, one sample per consumer-blocked-on-workers event, per-batch
# worker busy seconds, and the live worker count
DATA_READY_HISTOGRAM = "data_service/ready_depth"
DATA_UNDERRUN_HISTOGRAM = "data_service/underruns"
DATA_WORKER_BUSY_HISTOGRAM = "data_service/worker_busy"
DATA_WORKERS_GAUGE = "data_service/workers"


def run_fingerprint(device=None, process_index: int = 0, process_count: int = 1) -> Dict:
    """What hardware produced this ledger: ``platform`` ``"gpu"`` with the
    card's name on CUDA (``"cpu"`` when ``device`` is the CPU or there is no
    card), the device count, the process and ``torch_version``."""
    import torch

    on_gpu = torch.cuda.is_available() and str(device or "cuda").split(":")[0] == "cuda"
    return {
        "platform": "gpu" if on_gpu else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
        "n_devices": torch.cuda.device_count() if on_gpu else 1,
        "process_index": int(process_index),
        "process_count": int(process_count),
        "torch_version": torch.__version__,
    }


class FirstRunDetector:
    """Counts first runs (see the module docstring); ``on_event`` gets
    ``(duration_s, post_warmup, phase)`` for each."""

    def __init__(self, on_event=None):
        self._on_event = on_event
        self._lock = threading.Lock()
        self.warm = False
        self.warm_phases = set()
        self._seen = set()
        self.compile_count = 0
        self.post_warmup_count = 0
        self.compile_total_s = 0.0

    def mark_warm(self, *phases: str) -> None:
        """Steady state for ``phases`` (none: every phase)."""
        if phases:
            self.warm_phases.update(phases)
        else:
            self.warm = True

    def is_warm(self, phase: str) -> bool:
        return self.warm or phase in self.warm_phases

    def note(self, duration_s: float, phase: Optional[str] = None) -> None:
        """One first run (a serving bucket's; ``phase`` None: warm once the
        whole run was marked warm)."""
        with self._lock:
            post_warmup = self.warm if phase is None else self.is_warm(phase)
            self.compile_count += 1
            self.compile_total_s += float(duration_s)
            if post_warmup:
                self.post_warmup_count += 1
        if self._on_event is not None:
            self._on_event(float(duration_s), post_warmup, phase)

    def first_span(self, phase: str, duration_s: float) -> None:
        """A span of ``phase`` ended: the first one of the run is a first run."""
        if phase in self._seen:
            return
        self._seen.add(phase)
        self.note(duration_s, phase)


# the spans whose first occurrence is a first run
_FIRST_RUN_SPANS = (SPAN_STEP, SPAN_EVAL)


class Telemetry:
    """Per-run telemetry: spans, the JSONL ledger, first-run counting.

    ``process_index`` None (the trainers): this rank's place in the process
    group decides the ledger file (``telemetry.jsonl`` on rank 0,
    ``telemetry-{i}.jsonl`` on rank i) and the header's process count; an
    explicit index (a serve replica's id) leaves the fleet size unwritten.
    ``device``: the card whose allocator the memory events and watermarks
    read (the trainer's, or the served engine's); None reads the current
    one."""

    def __init__(
        self,
        workdir: Optional[str],
        *,
        run_info: Optional[Dict] = None,
        enabled: bool = True,
        memory_every_windows: int = 5,
        trace_sample_rate: float = 0.0,
        health=None,
        process_index: Optional[int] = None,
        device=None,
    ):
        self.enabled = enabled and workdir is not None
        self.workdir = workdir if self.enabled else None
        self.profiler = None
        self._profiled_seen = 0
        # analytic per-step FLOP pricing (set_step_flops): turns the
        # measured step time into the windows' `mfu`
        self.step_flops: Optional[Dict] = None
        self.watermarks = capacity_lib.WatermarkTracker()
        self.device = device
        if device is not None:
            self.watermarks.devices = [device]
        self.cost = capacity_lib.CostMeter()
        self.registry = MetricsRegistry()
        self.health = health
        self._span_stack: List[str] = []
        self._windows = 0
        self._memory_every_windows = max(1, int(memory_every_windows))
        self._closed = False
        self.ledger: Optional[RunLedger] = None
        self.detector: Optional[FirstRunDetector] = None
        # sampled spans persist as buffered `trace` events (no flush per span)
        self.tracer = trace_lib.Tracer(
            emit=self._trace_event if self.enabled else None,
            sample_rate=trace_sample_rate if self.enabled else 0.0,
        )
        if not self.enabled:
            return
        header: Dict = {"schema_version": 1}
        if process_index is None:
            from tensorflowdistributedlearning_tpu_torch.parallel import multihost

            info = multihost.process_info()
            index, count = info["process_index"], info["process_count"]
            header.update(process_index=index, process_count=count)
        else:
            # a serve replica: its id names its ledger, the process is one
            index, count = int(process_index), 1
            header["process_index"] = index
        self.ledger = RunLedger(workdir, filename=per_process_filename(index))
        if os.environ.get("TFDL_SUPERVISED_CHILD"):
            header["supervised"] = True
        try:
            header["fingerprint"] = run_fingerprint(device, *((index, count) if process_index is None else (0, 1)))
        except Exception as e:  # noqa: BLE001 — the probe is best-effort
            header["fingerprint"] = {"error": str(e)[:200]}
        if run_info:
            header.update(run_info)
        self.ledger.event("run_header", **header)
        self.detector = FirstRunDetector(on_event=self._on_first_run)

    # -- spans -------------------------------------------------------------

    @property
    def current_span(self) -> str:
        return self._span_stack[-1] if self._span_stack else ""

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a named host-side phase into ``span/{name}``; also a
        ``torch.profiler`` annotation ``obs/{name}``, and a traced span when
        tracing is on. Nested spans attribute to the innermost name."""
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        self._span_stack.append(name)
        t0 = time.perf_counter()
        try:
            with record_function(f"obs/{name}"):
                if self.tracer.enabled:
                    with self.tracer.span(name):
                        yield
                else:
                    yield
        finally:
            dt = time.perf_counter() - t0
            self.registry.histogram(f"span/{name}").record(dt)
            self._span_stack.pop()
            if name in _FIRST_RUN_SPANS and self.detector is not None:
                self.detector.first_span(name, dt)
            prof = self.profiler
            if prof is not None and prof.capturing and name == SPAN_STEP:
                # a cadence capture counts train steps to stop after its last
                try:
                    prof.note_step(dt)
                except Exception:  # noqa: BLE001 — profiling never kills training
                    logger.warning("profiler note_step failed", exc_info=True)

    def _span_delta(self, name: str) -> List[float]:
        return self.registry.histogram(f"span/{name}").drain()

    def drain_window_samples(self) -> Dict[str, List[float]]:
        """Drain the window's span and queue samples now and hand them to
        the caller: a deferred window (the async loop) snapshots them at its
        boundary and passes them to :meth:`window_event` one window later."""
        samples = {name: self._span_delta(name) for name in (SPAN_DATA_WAIT, SPAN_STEP, SPAN_FETCH_WAIT, SPAN_BARRIER)}
        samples["prefetch_depth"] = self.registry.histogram(PREFETCH_DEPTH_HISTOGRAM).drain()
        samples["data_ready_depth"] = self.registry.histogram(DATA_READY_HISTOGRAM).drain()
        samples["data_underruns"] = self.registry.histogram(DATA_UNDERRUN_HISTOGRAM).drain()
        samples["data_worker_busy"] = self.registry.histogram(DATA_WORKER_BUSY_HISTOGRAM).drain()
        return samples

    # -- profiling / MFU ---------------------------------------------------

    def set_profiler(self, profiler) -> None:
        """Attach a ``ContinuousProfiler``: step spans count into its cadence
        captures, windows run its cadence, ``close()`` finishes a capture."""
        self.profiler = profiler

    def window_profiled(self) -> bool:
        """Whether a capture of the profiler counted a train step since the
        last call: the trainers ask at every window boundary and mark such a
        window dirty, since a capture and its parse (seconds on the H100)
        make it no steady-state window."""
        captured = self.profiler.steps_captured if self.profiler is not None else 0
        seen, self._profiled_seen = self._profiled_seen, captured
        return captured != seen

    def set_step_flops(
        self,
        flops_per_step: float,
        *,
        peak_flops_per_chip: Optional[float] = None,
        n_devices: int = 1,
        collective_bytes_per_step: Optional[float] = None,
    ) -> None:
        """Price a step (``flops_per_step`` for one optimizer step of the
        whole job) so the windows carry ``mfu``; the peak defaults to
        :func:`obs.profiler.resolve_peak_flops` of this run's card and stays
        None off a known card (no ``mfu`` then)."""
        if not self.enabled:
            return
        if peak_flops_per_chip is None:
            from tensorflowdistributedlearning_tpu_torch.obs.profiler import resolve_peak_flops

            peak_flops_per_chip = resolve_peak_flops(device=self.device)
        self.step_flops = {"flops_per_step": float(flops_per_step), "n_devices": int(n_devices)}
        if peak_flops_per_chip:
            self.step_flops["peak_flops_per_chip"] = float(peak_flops_per_chip)
        if collective_bytes_per_step:
            self.step_flops["collective_bytes_per_step"] = float(collective_bytes_per_step)

    def _window_mfu(self, mean_step_s: float) -> Optional[float]:
        sf = self.step_flops
        if not sf or not mean_step_s or mean_step_s <= 0:
            return None
        peak = sf.get("peak_flops_per_chip")
        if not peak:
            return None
        achieved = sf["flops_per_step"] / mean_step_s / sf["n_devices"]
        return round(achieved / peak, 4)

    # -- events ------------------------------------------------------------

    def _event(self, kind: str, /, **fields) -> None:
        if self.ledger is not None:
            self.ledger.event(kind, **fields)

    def _trace_event(self, fields: Dict) -> None:
        if self.ledger is not None:
            self.ledger.event_buffered(trace_lib.TRACE_EVENT, **fields)

    def flush(self) -> None:
        if self.ledger is not None:
            self.ledger.flush()

    def event(self, kind: str, /, **fields) -> None:
        """Append an event under this run's header."""
        self._event(kind, **fields)

    def window_event(
        self,
        step: int,
        *,
        steps: int,
        images_per_sec: Optional[float] = None,
        scalars: Optional[Dict[str, float]] = None,
        dirty: bool = False,
        samples: Optional[Dict[str, List[float]]] = None,
        examples: Optional[int] = None,
        **extra,
    ) -> None:
        """One ``step_window`` event: throughput, the data-wait / step /
        fetch-wait / barrier split, per-step time percentiles, ``mfu``, the
        prefetch and data-service queues, first runs after warmup; then its
        ``cost`` event, a memory event on the memory cadence, the health
        monitors (which may raise ``HealthAbortError``) and the profiler's
        cadence. ``dirty`` marks a window holding a first run, an eval or a
        checkpoint; ``samples`` are the window's own boundary snapshot
        (default: drained now)."""
        if not self.enabled:
            return
        if samples is None:
            samples = self.drain_window_samples()
        wait = samples.get(SPAN_DATA_WAIT, [])
        compute = samples.get(SPAN_STEP, [])
        fetch = samples.get(SPAN_FETCH_WAIT, [])
        barrier = samples.get(SPAN_BARRIER, [])
        depth = samples.get("prefetch_depth", [])
        wait_s, compute_s, fetch_s, barrier_s = (
            window_total_s(wait), window_total_s(compute), window_total_s(fetch), window_total_s(barrier)
        )
        busy = wait_s + compute_s + fetch_s + barrier_s
        fields: Dict = {
            "step": step,
            "steps": steps,
            "data_wait_s": round(wait_s, 6),
            "compute_s": round(compute_s, 6),
            "fetch_wait_s": round(fetch_s, 6),
            "barrier_wait_s": round(barrier_s, 6),
            "data_wait_frac": round(wait_s / busy, 4) if busy else 0.0,
            "dirty": dirty,
            **extra,
        }
        if depth:
            fields["prefetch_queue_depth"] = {"mean": round(sum(depth) / len(depth), 2), "min": int(min(depth))}
        svc_ready = samples.get("data_ready_depth", [])
        svc_under = samples.get("data_underruns", [])
        svc_busy = samples.get("data_worker_busy", [])
        if svc_ready or svc_under or svc_busy:
            svc_fields: Dict = {"underruns": window_count(svc_under)}
            if svc_ready:
                svc_fields["ready_depth"] = {
                    "mean": round(sum(svc_ready) / len(svc_ready), 2), "min": int(min(svc_ready))
                }
            n_workers = self.registry.gauge(DATA_WORKERS_GAUGE).value
            if svc_busy and n_workers and busy > 0:
                svc_fields["worker_util"] = round(min(1.0, window_total_s(svc_busy) / (n_workers * busy)), 3)
            fields["data_service"] = svc_fields
        if compute:
            s = time_summary(compute)
            fields["step_time_ms"] = {
                k[:-2] + "_ms": round(v * 1000, 3) for k, v in s.items() if k.endswith("_s") and k != "total_s"
            }
            mfu = self._window_mfu((compute_s + fetch_s) / steps if steps > 0 else 0.0)
            if mfu is not None:
                fields["mfu"] = mfu
        if images_per_sec is not None:
            fields["images_per_sec"] = round(float(images_per_sec), 2)
        if scalars:
            fields["scalars"] = {k: float(v) for k, v in scalars.items()}
        if self.detector is not None:
            fields["recompiles_post_warmup"] = self.detector.post_warmup_count
        self._event("step_window", **fields)
        cost_fields = self.cost.train_window(compute_s, steps, examples=examples, step=step)
        if cost_fields:
            self._event(capacity_lib.COST_EVENT, **cost_fields)
        self._windows += 1
        if self._windows % self._memory_every_windows == 0:
            self.memory_event(step=step)
        alerts: List[Dict] = []
        try:
            if self.health is not None:
                # after the window is persisted: an alert (and a NaN-guard
                # abort) lands in a ledger that already tells its story
                alerts = self.health.observe_window(self, step, scalars or {}, fields) or []
        finally:
            if self.profiler is not None:
                try:
                    self.profiler.on_window(step=step, windows=self._windows, alerts=alerts)
                except Exception:  # noqa: BLE001 — never kill training
                    logger.warning("profiler window hook failed", exc_info=True)

    def eval_event(self, step: int, metrics: Dict[str, float], duration_s: float, **extra) -> None:
        self._event(
            "eval", step=step, duration_s=round(duration_s, 6), metrics={k: float(v) for k, v in metrics.items()},
            **extra,
        )
        self.sample_watermark(capacity_lib.PHASE_EVAL, step=step)

    def checkpoint_event(self, step: int, **extra) -> None:
        self._event("checkpoint", step=step, **extra)
        self.sample_watermark(capacity_lib.PHASE_CKPT, step=step)

    def memory_event(self, step: Optional[int] = None, **extra) -> None:
        """The device's allocator snapshot (``torch.cuda.memory_stats`` of
        this run's card; empty on the CPU) plus host RSS; ``extra`` rides
        along (the trainers' exact parameter and optimizer-state bytes)."""
        if not self.enabled:
            return
        try:
            devices = capacity_lib.memory_stats(self.watermarks.devices)
        except Exception:  # noqa: BLE001 — a failed probe must not crash
            devices = {}
        fields: Dict = {"devices": devices, **extra}
        rss = _host_rss_bytes()
        if rss is not None:
            fields["host_rss_bytes"] = rss
        if step is not None:
            fields["step"] = step
        self._event("memory", **fields)
        predicted = (extra.get("params_bytes_per_device") or 0) + (extra.get("opt_state_bytes_per_device") or 0)
        if predicted:
            self.watermarks.set_predicted(predicted)
        self.sample_watermark(self._memory_phase(), step=step, stats=devices)

    def _memory_phase(self) -> str:
        """The phase that owns a watermark sampled now: an open eval or
        checkpoint span, else ``step`` once the train step is warm,
        ``compile`` before."""
        span = self.current_span
        if span == SPAN_EVAL:
            return capacity_lib.PHASE_EVAL
        if span == SPAN_CHECKPOINT:
            return capacity_lib.PHASE_CKPT
        if self.detector is not None and self.detector.is_warm(SPAN_STEP):
            return capacity_lib.PHASE_STEP
        return capacity_lib.PHASE_COMPILE

    def sample_watermark(self, phase: str, step: Optional[int] = None, stats: Optional[Dict] = None) -> Optional[Dict]:
        """One allocator query (or the caller's ``stats``) attributed to
        ``phase``; ledgers a ``memory_watermark`` event when the peak
        advanced and feeds the health monitor's headroom check."""
        if not self.enabled:
            return None
        fields = self.watermarks.sample(phase, step=step, stats=stats)
        if fields:
            self._event(capacity_lib.WATERMARK_EVENT, **fields)
        observe = getattr(self.health, "observe_memory", None)
        if observe is not None:
            headroom = self.watermarks.headroom()
            if headroom and headroom.get("bytes_limit"):
                observe(self, step, headroom)
        return fields

    def mark_warm(self, *phases: str) -> None:
        """Steady state reached for ``phases`` (none: all of them): a first
        run of a warm phase from now on is a post-warmup recompile."""
        if self.detector is not None:
            self.detector.mark_warm(*phases)

    def _on_first_run(self, duration_s: float, post_warmup: bool, phase: Optional[str]) -> None:
        self._event(
            COMPILE_EVENT, duration_s=round(duration_s, 6), phase=self.current_span if phase is None else phase,
            post_warmup=post_warmup,
        )
        if post_warmup:
            logger.warning(
                "post-warmup first run #%d (%.3f s): a cold shape paid its first-run cost after warmup",
                self.detector.post_warmup_count, duration_s,
            )

    def close(self, **final_fields) -> None:
        """One ``run_end`` event (with the first-run counts), then close the
        ledger. Idempotent: the trainers close with their final metrics on
        success and with ``interrupted=True`` from their ``finally``. With
        the profiler's cadence armed, ``run_end`` also carries its counters
        (``profiler``: captures ledgered, errors, refused, rate-limited), so
        a capture that failed or was refused shows in the ledger and not
        only in the log."""
        if self._closed:
            return
        self._closed = True
        if not self.enabled:
            return
        prof = self.profiler
        if prof is not None:
            try:
                prof.close()
            except Exception:  # noqa: BLE001
                logger.warning("profiler close failed", exc_info=True)
            if prof.enabled:
                final_fields.setdefault("profiler", {
                    "captures": prof.captures, "errors": prof.errors, "refused": prof.refused,
                    "rate_limited": prof.rate_limited,
                })
        if self.detector is not None:
            final_fields.setdefault("recompiles_post_warmup", self.detector.post_warmup_count)
            final_fields.setdefault("compiles", self.detector.compile_count)
            final_fields.setdefault("compile_total_s", round(self.detector.compile_total_s, 3))
        self._event("run_end", **final_fields)
        if self.ledger is not None:
            self.ledger.close()


def _host_rss_bytes() -> Optional[int]:
    try:
        page = os.sysconf("SC_PAGE_SIZE")
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page
    except (OSError, ValueError, IndexError):
        return None


NULL_TELEMETRY = Telemetry(None, enabled=False)
