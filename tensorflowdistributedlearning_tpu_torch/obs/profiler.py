"""``torch.profiler`` captures of a trainer or a serving replica, parsed
into a roofline and ledgered (the port's copy of the JAX package's
``obs/profiler.py``, same events and fields).

:class:`ContinuousProfiler` takes three kinds of capture:

- **cadence** (``every_windows`` > 0, ``TrainConfig.profile_every_windows``):
  every N-th log window starts a capture that stops after
  :attr:`~ContinuousProfiler.capture_steps` train steps (counted by
  :meth:`~ContinuousProfiler.note_step` from the telemetry's ``step``
  spans); its roofline has ``phase`` ``"train"`` and the captured steps'
  MFU;
- **admin** (:meth:`~ContinuousProfiler.capture_timed`): an explicit
  N-second capture, the serve ``/admin/profile`` endpoint;
- **alert** (:meth:`~ContinuousProfiler.trigger`): one postmortem capture
  on a ``step_time`` or SLO health alert, rate-limited and stamped with the
  alert's ``alert_id``.

A capture records the card's kernels through CUPTI whatever host thread
launched them (on the CPU, the host ops of its own thread). A timed
capture runs on a thread of its own: the profiler session is entered and
left on that thread (the pattern that kept the device kernels of every
later session on the H100). A stepped capture (cadence, or an alert at a
train window) enters and leaves its session on the train thread and parses
there too: a parse off that thread contends with the train loop for the
interpreter lock, runs longer and spills into the next window, while on
the train thread its cost stays in the window that holds the capture
(:attr:`~ContinuousProfiler.steps_captured` lets the trainers mark that
window dirty). One session
runs in a process at a time (:func:`exclusive_session`): a capture asked
for while another runs, this profiler's or anyone's, is refused and counted
(``refused``). A cadence capture waits for the card to finish the captured
steps before it stops. Each capture writes the Chrome trace
(``trace.json``) and the kernel breakdown (``ops.json``) into
``{workdir}/profile/capture-{id}/`` and ledgers ``profile_capture``, then
``op_roofline`` when it holds device kernels. The roofline classifies each
kernel into the JAX package's buckets (:data:`BUCKET_NEEDLES`): the port's
own kernels by the ``tfdl_`` names of their stated bucket, cuDNN's
convolutions as ``conv``, GEMMs as ``matmul``, the rest by kind.

MFU is JAX's analytic convention: the telemetry's step FLOPs
(``6 · params · global_batch``) over the measured time against the card's
peak (:func:`resolve_peak_flops`); absent without a known peak (the CPU),
never 0/0. A cadence capture's time is the longer of its steps' ``step``
spans and its wall time until the card finished them (an eager step span
holds only the launches).

Failure stance: a profiler hiccup is logged and counted (``errors``),
never fatal to training or serving.
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

# health_alert monitors that trigger a postmortem capture at a train window
TRIGGER_MONITORS = ("step_time", "slo")

# dense bf16 tensor-core peak FLOP/s by card name (lower-cased substring,
# first hit wins): the H100 SXM's 989 TFLOP/s
PEAK_FLOPS_BY_KIND = {"h100": 989e12}

# one torch.profiler session per process
_SESSION = threading.Lock()


def exclusive_session(blocking: bool = False) -> bool:
    """Claim the process's one profiler session (False when another runs
    and ``blocking`` is off); :func:`release_session` gives it back."""
    return _SESSION.acquire(blocking=blocking)


def release_session() -> None:
    _SESSION.release()


def resolve_peak_flops(device_kind: Optional[str] = None, device=None) -> Optional[float]:
    """Peak FLOP/s per card for MFU, or None when the card is not in
    :data:`PEAK_FLOPS_BY_KIND` (and on the CPU): the caller then omits MFU.
    ``TFDL_PEAK_FLOPS`` overrides, as in the JAX package. ``device_kind``
    defaults to ``torch.cuda.get_device_name`` of ``device`` (a CPU
    ``device`` has none)."""
    env = os.environ.get("TFDL_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            logger.warning("ignoring unparseable TFDL_PEAK_FLOPS=%r", env)
    if device_kind is None:
        import torch

        if device is not None and torch.device(device).type != "cuda":
            return None
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(device)
    kind = (device_kind or "").lower()
    for needle, flops in PEAK_FLOPS_BY_KIND.items():
        if needle in kind:
            return flops
    return None

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


def build_roofline(
    rows: List[OpTime], *, phase: str = "infer", top: int = 5, busy_s: Optional[float] = None,
    steps: Optional[int] = None, step_flops: Optional[Dict] = None,
) -> Dict:
    """One ``op_roofline`` event body: buckets, the compute / HBM /
    collective split and the top kernels with their class; with the
    telemetry's ``step_flops`` and the captured ``steps`` and their
    ``busy_s`` (the sum of their ``step`` spans), the achieved FLOP/s, the
    ``mfu`` and the compute-class ``compute_mfu``."""
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
    sf = step_flops or {}
    flops_per_step = sf.get("flops_per_step")
    n_devices = sf.get("n_devices") or 1
    if flops_per_step and steps and busy_s and busy_s > 0:
        achieved = flops_per_step * steps / busy_s / n_devices
        out["analytic_flops_per_step"] = float(flops_per_step)
        out["achieved_flops_per_sec_per_chip"] = round(achieved, 3)
        peak = sf.get("peak_flops_per_chip")
        if peak:
            out["peak_flops_per_chip"] = float(peak)
            out["mfu"] = round(achieved / peak, 4)
            if compute_ms > 0:
                out["compute_mfu"] = round(flops_per_step * steps / (compute_ms / 1e3) / n_devices / peak, 4)
        collective_bytes = sf.get("collective_bytes_per_step")
        if collective_bytes and collective_ms > 0:
            out["achieved_collective_bytes_per_sec"] = round(collective_bytes * steps / (collective_ms / 1e3), 3)
            out["collective_bytes_per_step"] = float(collective_bytes)
    return out


class ContinuousProfiler:
    """Cadence, timed and triggered captures, parsed and ledgered (see the
    module docstring). Without a logdir (telemetry off) it captures
    nothing. ``phase`` names the rooflines of timed and triggered captures
    (``"infer"`` on a server); cadence captures are ``"train"``.
    ``device``: the card a cadence capture waits for before it stops."""

    # how long a capture waits for its thread's session to open
    START_TIMEOUT_S = 60.0
    # a cadence capture whose steps never come stops after this long
    MAX_CAPTURE_S = 600.0
    # at most one postmortem capture per this many seconds
    MIN_TRIGGER_INTERVAL_S = 300.0
    TOP_OPS = 5

    def __init__(self, telemetry, *, every_windows: int = 0, capture_steps: int = 3, phase: str = "infer",
                 device=None):
        self.telemetry = telemetry
        workdir = getattr(telemetry, "workdir", None)
        self.logdir = os.path.join(workdir, "profile") if workdir else None
        self.every_windows = max(0, int(every_windows))
        self.capture_steps = max(1, int(capture_steps))
        self.phase = phase
        self.device = device
        # the flag Telemetry.span reads once per train step
        self.capturing = False
        self.captures = 0
        # train steps counted by stepped captures, over the profiler's life
        self.steps_captured = 0
        self.rate_limited = 0
        self.refused = 0
        self.errors = 0
        self._active: Optional[Dict] = None
        self._lock = threading.Lock()
        self._last_trigger: Optional[float] = None

    @property
    def enabled(self) -> bool:
        """Cadence capture armed."""
        return self.every_windows > 0 and self.logdir is not None

    def _error(self, what: str, e: BaseException) -> None:
        with self._lock:
            self.errors += 1
        logger.warning("profile capture %s: %s", what, e)

    # -- capture lifecycle -------------------------------------------------

    def _begin(self, reason: str, *, step: Optional[int] = None, alert_id: Optional[str] = None,
               seconds: Optional[float] = None) -> Optional[Dict]:
        """Start a capture: timed (``seconds``) on a thread of its own, or
        over the next ``capture_steps`` train steps on the calling (train)
        thread; None when one is running (this profiler's or another session
        of the process), there is no logdir, or the session did not open."""
        if self.logdir is None:
            return None
        with self._lock:
            if self._active is not None or not exclusive_session():
                self.refused += 1
                return None  # the running capture wins
            capture_id = trace_lib.new_id()
            rec: Dict = {
                "capture_id": capture_id,
                "dir": os.path.join(self.logdir, f"capture-{capture_id}"),
                "reason": reason,
                "steps": 0,
                "busy_s": 0.0,
            }
            for key, value in (("step", step), ("alert_id", alert_id), ("seconds", seconds)):
                if value is not None:
                    rec[key] = value
            self._active = rec
            self.capturing = True
        if seconds is None:
            # a session entered on another thread than the one launching
            # the steps slowed an Xception-41 step about 7x on the H100
            if not self._open(rec):
                self._release(rec)
                return None
            return rec
        rec["stop"], rec["started"] = threading.Event(), threading.Event()
        thread = threading.Thread(target=self._run_timed, args=(rec,), daemon=True, name="profile-capture")
        rec["thread"] = thread
        thread.start()
        if not rec["started"].wait(self.START_TIMEOUT_S) or rec.get("failed"):
            return None
        return rec

    def _on_cuda(self) -> bool:
        import torch

        return torch.cuda.is_available() and (self.device is None or torch.device(self.device).type == "cuda")

    def _open(self, rec: Dict) -> bool:
        """Enter the profiler session of ``rec`` on this thread: the card's
        kernels on CUDA (recording every host op as well slowed a train
        step about 10x), the host ops of this thread on the CPU."""
        from torch.profiler import ProfilerActivity, profile

        activity = ProfilerActivity.CUDA if self._on_cuda() else ProfilerActivity.CPU
        try:
            os.makedirs(rec["dir"], exist_ok=True)
            rec["session"] = profile(activities=[activity])
            rec["session"].__enter__()
        except Exception as e:  # noqa: BLE001 — never kill the producer
            self._error("failed to start", e)
            return False
        rec["t0"] = time.perf_counter()
        return True

    def _close(self, rec: Dict) -> bool:
        """Leave ``rec``'s session on this thread; a stepped capture first
        waits for the card to finish its steps, whose device time (not
        their launches' step spans) then prices them."""
        import torch

        if "seconds" not in rec and self._on_cuda():
            torch.cuda.synchronize(self.device)
            rec["busy_s"] = max(rec["busy_s"], time.perf_counter() - rec["t0"])
        rec["window_s"] = time.perf_counter() - rec["t0"]
        try:
            rec["session"].__exit__(None, None, None)
        except Exception as e:  # noqa: BLE001
            self._error("failed to stop", e)
            return False
        return True

    def _release(self, rec: Dict) -> None:
        with self._lock:
            if self._active is rec:
                self._active = None
                self.capturing = False
        release_session()

    def _run_timed(self, rec: Dict) -> None:
        try:
            if not self._open(rec):
                rec["failed"] = True
                return
            rec["started"].set()
            rec["stop"].wait(rec["seconds"])
            if self._close(rec):
                self._parse(rec)
        finally:
            rec["started"].set()
            self._release(rec)

    def _parse(self, rec: Dict) -> None:
        """Write ``ops.json`` and ``trace.json`` and ledger the capture."""
        try:
            session = rec["session"]
            rows = kernel_breakdown(session.events())
            with open(os.path.join(rec["dir"], "ops.json"), "w") as f:
                json.dump([dataclasses.asdict(r) for r in rows], f)
            session.export_chrome_trace(os.path.join(rec["dir"], "trace.json"))
            self._ledger_capture(rec, rows, rec["window_s"])
            with self._lock:
                self.captures += 1
        except Exception as e:  # noqa: BLE001 — parse and ledger are best-effort
            self._error(f"{rec['capture_id']} not ledgered", e)

    def _stop_stepped(self, rec: Dict) -> None:
        """End a stepped capture on the train thread, then parse and ledger
        it there."""
        self.capturing = False
        try:
            if self._close(rec):
                self._parse(rec)
        finally:
            self._release(rec)

    def _ledger_capture(self, rec: Dict, rows: List[OpTime], window_s: float) -> None:
        capture: Dict = {
            "capture_id": rec["capture_id"],
            "reason": rec["reason"],
            "logdir": rec["dir"],
            "window_s": round(window_s, 6),
            "ops": len(rows),
            "skipped_plane_files": 0,
        }
        cadence = "seconds" not in rec
        for key in ("step", "alert_id", "seconds"):
            if key in rec:
                capture[key] = rec[key]
        if cadence:
            capture["steps"] = rec["steps"]
        self.telemetry.event(PROFILE_CAPTURE_EVENT, **capture)
        if not rows:
            return
        if cadence:
            roofline = build_roofline(
                rows, phase="train", top=self.TOP_OPS, busy_s=rec["busy_s"] or None, steps=rec["steps"] or None,
                step_flops=getattr(self.telemetry, "step_flops", None),
            )
        else:
            roofline = build_roofline(rows, phase=self.phase, top=self.TOP_OPS)
        roofline["capture_id"] = rec["capture_id"]
        roofline["reason"] = rec["reason"]
        for key in ("step", "alert_id"):
            if key in rec:
                roofline[key] = rec[key]
        self.telemetry.event(OP_ROOFLINE_EVENT, **roofline)

    def note_step(self, duration_s: float = 0.0) -> None:
        """One train step ended under a stepped capture (its ``step`` span's
        wall time, on the train thread); the capture stops after
        ``capture_steps`` of them."""
        rec = self._active
        if rec is None or "seconds" in rec or rec.get("stopping"):
            return
        rec["steps"] += 1
        self.steps_captured += 1
        rec["busy_s"] += float(duration_s)
        if rec["steps"] >= self.capture_steps:
            rec["stopping"] = True
            self._stop_stepped(rec)

    # -- entry points ------------------------------------------------------

    def on_window(self, *, step: Optional[int] = None, windows: int = 0, alerts: Optional[List[Dict]] = None) -> None:
        """A train window was written: a postmortem capture for an open
        ``step_time`` alert first, then the cadence."""
        for alert in alerts or ():
            if alert.get("monitor") in TRIGGER_MONITORS and not alert.get("resolved"):
                self.trigger(alert, step=step)
                break
        if self.every_windows and windows > 0 and windows % self.every_windows == 0:
            self._begin("cadence", step=step)

    def capture_timed(
        self, seconds: float = 1.0, *, reason: str = "admin", alert_id: Optional[str] = None, wait: bool = False
    ) -> Optional[Dict]:
        """Start an N-second capture; returns ``{capture_id, seconds,
        status}`` once the session is open (``wait``: once it is ledgered),
        or None when it was refused or did not open."""
        seconds = max(0.05, float(seconds))
        rec = self._begin(reason, alert_id=alert_id, seconds=seconds)
        if rec is None:
            return None
        if wait:
            rec["thread"].join()
        return {"capture_id": rec["capture_id"], "seconds": seconds, "status": "complete" if wait else "started"}

    def trigger(self, alert: Dict, *, step: Optional[int] = None, seconds: Optional[float] = None) -> Optional[Dict]:
        """Postmortem capture for a health alert: at most one per
        ``MIN_TRIGGER_INTERVAL_S``, stamped with the alert's id; timed with
        ``seconds`` (a server), else over the next ``capture_steps`` steps."""
        now = time.monotonic()
        if self._last_trigger is not None and now - self._last_trigger < self.MIN_TRIGGER_INTERVAL_S:
            self.rate_limited += 1
            return None
        if seconds is not None:
            out = self.capture_timed(seconds, reason="alert", alert_id=alert.get("alert_id"))
        else:
            rec = self._begin("alert", step=step, alert_id=alert.get("alert_id"))
            out = {"capture_id": rec["capture_id"]} if rec else None
        if out is not None:
            self._last_trigger = now
        return out

    def close(self) -> None:
        """Stop a capture in flight (a stepped one on this thread, which must
        be the train thread) and wait until it is ledgered."""
        rec = self._active
        if rec is None:
            return
        if "seconds" in rec:
            rec["stop"].set()
        elif not rec.get("stopping"):
            rec["stopping"] = True
            self._stop_stepped(rec)
        self.capturing = False
        thread = rec.get("thread")
        if thread is not None and thread.is_alive():
            thread.join(timeout=60.0)
