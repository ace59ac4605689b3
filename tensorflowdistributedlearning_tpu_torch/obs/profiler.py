"""Timed ``torch.profiler`` captures of a serving replica, parsed into a
roofline and ledgered (the port's copy of the serve half of the JAX
package's ``obs/profiler.py``, same events and fields).

:class:`ContinuousProfiler` takes two kinds of capture:

- **admin** (:meth:`capture_timed`): an explicit N-second capture, the serve
  ``/admin/profile`` endpoint;
- **alert** (:meth:`trigger`): one postmortem capture when the SLO budget
  breaks, rate-limited and stamped with the alert's ``alert_id``.

A capture records the card's kernels through CUPTI whatever host thread
launched them (the batcher worker, not the HTTP thread that asked). It runs
on a thread of its own: the profiler session is entered and left on that
thread, as a context manager (the pattern that kept the device kernels of
every later session on the H100), and a capture asked for while one runs
is refused. Each capture writes the Chrome trace (``trace.json``) and the
kernel breakdown (``ops.json``) into ``{workdir}/profile/capture-{id}/`` and
ledgers ``profile_capture``, then ``op_roofline`` when it holds device
kernels. The roofline classifies each kernel into the JAX package's buckets
(:data:`BUCKET_NEEDLES`): the port's own kernels by the ``tfdl_`` names
of their stated bucket, cuDNN's convolutions as ``conv``, GEMMs as
``matmul``, the rest by kind. Serving has no step FLOP count, so no MFU is
written, as in the JAX package.

Failure stance: a profiler hiccup is logged and counted (``errors``), never
fatal to serving.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from tensorflowdistributedlearning_tpu_torch.obs import trace as trace_lib

logger = logging.getLogger(__name__)

PROFILE_CAPTURE_EVENT = "profile_capture"
OP_ROOFLINE_EVENT = "op_roofline"

# device kernel name (lower-cased) -> the JAX package's op buckets
# (utils/xplane.DEFAULT_GROUPS), first hit in this order wins; "other" else
BUCKET_NEEDLES = {
    "conv": ("tfdl_depthwise", "tfdl_int8_conv", "conv", "fprop", "dgrad", "wgrad"),
    "matmul": ("tfdl_int8_gemm", "tfdl_flash_attention", "gemm", "cutlass", "matmul"),
    "fusion(elementwise/bn)": ("tfdl_bn_act", "tfdl_bias_act", "tfdl_sigmoid_mask", "elementwise", "fusion"),
    "collectives": ("nccl", "all_reduce", "allreduce", "all_gather", "reduce_scatter"),
    "reduce": ("reduce",),
    "copy/transpose": ("memcpy", "memset", "copy", "transpose"),
}
_COMPUTE_BUCKETS = ("conv", "matmul")
_COLLECTIVE_BUCKETS = ("collectives",)

def classify_bucket(name: str) -> str:
    """The bucket of one device kernel name (first needle hit)."""
    lowered = name.lower()
    for bucket, needles in BUCKET_NEEDLES.items():
        if any(n in lowered for n in needles):
            return bucket
    return "other"


def _roofline_class(name: str) -> str:
    bucket = classify_bucket(name)
    if bucket in _COMPUTE_BUCKETS:
        return "compute"
    return "collective" if bucket in _COLLECTIVE_BUCKETS else "hbm"


@dataclasses.dataclass
class OpTime:
    """One kernel's time in a capture (the JAX package's ``xplane.OpTime``)."""

    name: str
    total_ms: float
    occurrences: int
    fraction: float


def device_kernel(evt) -> bool:
    """Whether a profiler event is work on the card: a CUDA event that is
    not a user annotation."""
    return str(getattr(evt, "device_type", "")).endswith("CUDA") and not getattr(evt, "is_user_annotation", False)


def kernel_breakdown(events) -> List[OpTime]:
    """Device kernels of a capture summed by name, longest first."""
    totals: Dict[str, List[float]] = {}
    for evt in events:
        if device_kernel(evt):
            row = totals.setdefault(evt.name, [0.0, 0])
            row[0] += evt.time_range.elapsed_us() / 1e3
            row[1] += 1
    grand = sum(ms for ms, _ in totals.values()) or 1.0
    rows = [OpTime(name, round(ms, 6), int(n), round(ms / grand, 6)) for name, (ms, n) in totals.items()]
    return sorted(rows, key=lambda r: -r.total_ms)


def grouped_breakdown(rows: List[OpTime]) -> Dict[str, float]:
    """Kernel time (ms) per bucket, empty buckets omitted."""
    out = {k: 0.0 for k in BUCKET_NEEDLES}
    out["other"] = 0.0
    for row in rows:
        out[classify_bucket(row.name)] += row.total_ms
    return {k: round(v, 3) for k, v in out.items() if v}


def build_roofline(rows: List[OpTime], *, phase: str = "infer", top: int = 5) -> Dict:
    """One ``op_roofline`` event body: buckets, the compute / HBM /
    collective split and the top kernels with their class."""
    groups = grouped_breakdown(rows)
    total_ms = sum(groups.values())
    compute_ms = sum(groups.get(b, 0.0) for b in _COMPUTE_BUCKETS)
    collective_ms = sum(groups.get(b, 0.0) for b in _COLLECTIVE_BUCKETS)
    hbm_ms = max(0.0, total_ms - compute_ms - collective_ms)
    out: Dict = {
        "phase": phase,
        "total_ms": round(total_ms, 3),
        "buckets": groups,
        "classes": {
            "compute_frac": round(compute_ms / total_ms, 4) if total_ms else 0.0,
            "hbm_frac": round(hbm_ms / total_ms, 4) if total_ms else 0.0,
            "collective_frac": round(collective_ms / total_ms, 4) if total_ms else 0.0,
        },
        "top_ops": [
            {"name": r.name, "total_ms": r.total_ms, "fraction": r.fraction, "class": _roofline_class(r.name)}
            for r in rows[:top]
        ],
    }
    hbm_rows = [r for r in rows if _roofline_class(r.name) == "hbm"]
    if hbm_rows:
        out["top_hbm_op"] = {"name": hbm_rows[0].name, "total_ms": hbm_rows[0].total_ms,
                             "fraction": hbm_rows[0].fraction}
    return out


class ContinuousProfiler:
    """Timed captures of one replica, parsed and ledgered (see the module
    docstring). Without a logdir (telemetry off) it captures nothing."""

    # how long capture_timed waits for the capture thread's session to open
    START_TIMEOUT_S = 60.0
    # at most one postmortem capture per this many seconds
    MIN_TRIGGER_INTERVAL_S = 300.0
    TOP_OPS = 5

    def __init__(self, telemetry):
        self.telemetry = telemetry
        workdir = getattr(telemetry, "workdir", None)
        self.logdir = os.path.join(workdir, "profile") if workdir else None
        self.capturing = False
        self.captures = 0
        self.rate_limited = 0
        self.errors = 0
        self._active: Optional[Dict] = None
        self._lock = threading.Lock()
        self._last_trigger: Optional[float] = None

    def _error(self, what: str, e: BaseException) -> None:
        with self._lock:
            self.errors += 1
        logger.warning("profile capture %s: %s", what, e)

    def capture_timed(
        self, seconds: float = 1.0, *, reason: str = "admin", alert_id: Optional[str] = None, wait: bool = False
    ) -> Optional[Dict]:
        """Start an N-second capture on its own thread; returns ``{capture_id,
        seconds, status}`` once the session is open (``wait``: once it is
        ledgered), or None when a capture is already running, there is no
        logdir, or the session did not open."""
        if self.logdir is None:
            return None
        seconds = max(0.05, float(seconds))
        with self._lock:
            if self._active is not None:
                return None  # the running capture wins
            capture_id = trace_lib.new_id()
            rec: Dict = {
                "capture_id": capture_id,
                "dir": os.path.join(self.logdir, f"capture-{capture_id}"),
                "reason": reason,
                "seconds": seconds,
                "stop": threading.Event(),
                "started": threading.Event(),
            }
            if alert_id is not None:
                rec["alert_id"] = alert_id
            self._active = rec
            self.capturing = True
        thread = threading.Thread(target=self._run, args=(rec,), daemon=True, name="profile-capture")
        rec["thread"] = thread
        thread.start()
        if not rec["started"].wait(self.START_TIMEOUT_S) or rec.get("failed"):
            return None
        if wait:
            thread.join()
        return {"capture_id": capture_id, "seconds": seconds, "status": "complete" if wait else "started"}

    def _run(self, rec: Dict) -> None:
        try:
            self._capture(rec)
        finally:
            rec["started"].set()
            with self._lock:
                if self._active is rec:
                    self._active = None
                    self.capturing = False

    def _capture(self, rec: Dict) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            os.makedirs(rec["dir"], exist_ok=True)
            session = profile(activities=activities)
            session.__enter__()
        except Exception as e:  # noqa: BLE001 — never kill the producer
            rec["failed"] = True
            self._error("failed to start", e)
            return
        t0 = time.perf_counter()
        rec["started"].set()
        try:
            rec["stop"].wait(rec["seconds"])
        finally:
            try:
                session.__exit__(None, None, None)
            except Exception as e:  # noqa: BLE001
                self._error("failed to stop", e)
                return
        window_s = time.perf_counter() - t0
        try:
            rows = kernel_breakdown(session.events())
            with open(os.path.join(rec["dir"], "ops.json"), "w") as f:
                json.dump([dataclasses.asdict(r) for r in rows], f)
            session.export_chrome_trace(os.path.join(rec["dir"], "trace.json"))
            self._ledger_capture(rec, rows, window_s)
            with self._lock:
                self.captures += 1
        except Exception as e:  # noqa: BLE001 — parse and ledger are best-effort
            self._error(f"{rec['capture_id']} not ledgered", e)

    def _ledger_capture(self, rec: Dict, rows: List[OpTime], window_s: float) -> None:
        capture: Dict = {
            "capture_id": rec["capture_id"],
            "reason": rec["reason"],
            "logdir": rec["dir"],
            "window_s": round(window_s, 6),
            "ops": len(rows),
            "skipped_plane_files": 0,
            "seconds": rec["seconds"],
        }
        if "alert_id" in rec:
            capture["alert_id"] = rec["alert_id"]
        self.telemetry.event(PROFILE_CAPTURE_EVENT, **capture)
        if not rows:
            return
        roofline = build_roofline(rows, phase="infer", top=self.TOP_OPS)
        roofline["capture_id"] = rec["capture_id"]
        roofline["reason"] = rec["reason"]
        if "alert_id" in rec:
            roofline["alert_id"] = rec["alert_id"]
        self.telemetry.event(OP_ROOFLINE_EVENT, **roofline)

    def trigger(self, alert: Dict, *, seconds: float = 2.0) -> Optional[Dict]:
        """Postmortem capture for a health alert: at most one per
        ``MIN_TRIGGER_INTERVAL_S``, stamped with the alert's id."""
        now = time.monotonic()
        if self._last_trigger is not None and now - self._last_trigger < self.MIN_TRIGGER_INTERVAL_S:
            self.rate_limited += 1
            return None
        out = self.capture_timed(seconds, reason="alert", alert_id=alert.get("alert_id"))
        if out is not None:
            self._last_trigger = now
        return out

    def close(self) -> None:
        """Stop a capture in flight and wait until it is ledgered."""
        rec = self._active
        if rec is None:
            return
        rec["stop"].set()
        thread = rec.get("thread")
        if thread is not None and thread.is_alive():
            thread.join(timeout=60.0)
