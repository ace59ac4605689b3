"""Fleet ledgers: every per-process run ledger of a workdir merged into one
cross-process view (counterpart of the JAX package's ``obs/fleet.py``).

One process writes one ledger (``obs.ledger.per_process_filename``: rank 0
``telemetry.jsonl``, rank i > 0 ``telemetry-{i}.jsonl`` beside it). Read
side only:

- :func:`discover_ledgers`: find and parse them all, each scoped to its
  last run, parse errors counted, sorted by process index (the parallelism
  planner reads its measured margin and costs through it);
- :func:`straggler_section`: per-window max/median step-time skew across
  processes, the worst process, and ``straggler_alert`` entries for windows
  past a skew threshold;
- :func:`fleet_section`: the report's merged section (per-process goodput
  splits, serving totals per replica, the straggler analysis, the
  slow-host-vs-slow-network hint) and :func:`render_fleet_section`;
- :func:`fleet_summary`: the same merge for callers outside the report.

``obs.report.build_report`` calls into here: a workdir with several ledgers
gains a ``fleet`` section. The functions compute what JAX's compute on the
same ledgers (``tests/test_torch_fleet_report.py``).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
import statistics
from typing import Dict, List, Optional

from tensorflowdistributedlearning_tpu_torch.obs.ledger import (
    LEDGER_FILENAME,
    last_run_events,
    read_ledger_with_errors,
)

# windows needing at least this much skew before a straggler_alert fires;
# 1.25 = the slowest host runs 25% over the fleet median, which on a
# synchronous SPMD step is 25% of every chip's time burned waiting
DEFAULT_SKEW_THRESHOLD = 1.25

_SECONDARY_LEDGER_RE = re.compile(r"telemetry-(\d+)\.jsonl$")

STRAGGLER_ALERT_EVENT = "straggler_alert"


@dataclasses.dataclass
class ProcessLedger:
    """One process's parsed ledger. ``events`` is scoped to the LAST run
    (what every fleet aggregation reads); ``all_events`` keeps the whole
    appended history for readers with cross-run scope (the report's
    resilience section) — same parsed objects, no second file read."""

    process_index: int
    path: str
    events: List[Dict]
    all_events: List[Dict]
    parse_errors: int

    @property
    def header(self) -> Dict:
        if self.events and self.events[0].get("event") == "run_header":
            return self.events[0]
        return {}


def discover_ledgers(workdir: str) -> List[ProcessLedger]:
    """Every per-process ledger under ``workdir``, sorted by process index.

    ``telemetry.jsonl`` is process 0 (headers that carry an explicit
    ``process_index`` win over the filename); ``telemetry-{i}.jsonl`` is
    process i. Unreadable files are skipped (a dead NFS mount on one host
    must not take down the whole fleet's report); an empty list means the
    workdir holds no ledger at all."""
    ledgers: List[ProcessLedger] = []
    candidates = []
    canonical = os.path.join(workdir, LEDGER_FILENAME)
    if os.path.isfile(canonical):
        candidates.append((0, canonical))
    for path in sorted(glob.glob(os.path.join(workdir, "telemetry-*.jsonl"))):
        m = _SECONDARY_LEDGER_RE.search(os.path.basename(path))
        if m:
            candidates.append((int(m.group(1)), path))
    for index, path in candidates:
        try:
            all_events, errors = read_ledger_with_errors(path)
        except OSError:
            continue
        events = last_run_events(all_events)
        header = (
            events[0]
            if events and events[0].get("event") == "run_header"
            else {}
        )
        ledgers.append(
            ProcessLedger(
                process_index=int(header.get("process_index", index)),
                path=path,
                events=events,
                all_events=all_events,
                parse_errors=errors,
            )
        )
    ledgers.sort(key=lambda led: led.process_index)
    return ledgers


def _windows(ledger: ProcessLedger) -> List[Dict]:
    return [e for e in ledger.events if e.get("event") == "step_window"]


def _weighted_mean_ms(windows: List[Dict]) -> Optional[float]:
    pairs = [
        (e["step_time_ms"]["mean_ms"], float(e.get("steps", 1)))
        for e in windows
        if "step_time_ms" in e
    ]
    total = sum(w for _, w in pairs)
    if not total:
        return None
    return sum(v * w for v, w in pairs) / total


def straggler_section(
    ledgers: List[ProcessLedger],
    *,
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
    max_alerts: int = 20,
) -> Optional[Dict]:
    """Cross-host step-time skew, window by window.

    Windows are aligned by their ``step`` field (every host logs the same
    boundaries — the loop structure is SPMD); for each step present on >= 2
    hosts, skew = max(mean step time) / median(mean step time) over hosts.
    Past ``skew_threshold`` the window contributes a ``straggler_alert``
    naming the worst host. None when fewer than two hosts have comparable
    windows."""
    per_host: Dict[int, Dict[int, float]] = {}
    for led in ledgers:
        by_step = {
            int(e["step"]): e["step_time_ms"]["mean_ms"]
            for e in _windows(led)
            if "step_time_ms" in e and "step" in e
        }
        if by_step:
            per_host[led.process_index] = by_step
    if len(per_host) < 2:
        return None
    shared_steps = sorted(
        set.intersection(*(set(m) for m in per_host.values()))
    )
    if not shared_steps:
        return None
    alerts: List[Dict] = []
    skews: List[float] = []
    worst_counts: Dict[int, int] = {}
    for step in shared_steps:
        values = {proc: per_host[proc][step] for proc in per_host}
        med = statistics.median(values.values())
        if med <= 0:
            continue
        worst_proc = max(values, key=lambda p: values[p])
        skew = values[worst_proc] / med
        skews.append(skew)
        worst_counts[worst_proc] = worst_counts.get(worst_proc, 0) + 1
        if skew > skew_threshold:
            alerts.append(
                {
                    "event": STRAGGLER_ALERT_EVENT,
                    "severity": "warn",
                    "step": step,
                    "skew": round(skew, 3),
                    "worst_process": worst_proc,
                    "worst_ms": round(values[worst_proc], 3),
                    "median_ms": round(med, 3),
                }
            )
    if not skews:
        return None
    # the host named by the section: most-often-slowest among ALERTED windows
    # when any fired (that is the straggler); most-often-slowest overall
    # otherwise (informational — nobody crossed the threshold)
    if alerts:
        attributed: Dict[int, int] = {}
        for a in alerts:
            attributed[a["worst_process"]] = (
                attributed.get(a["worst_process"], 0) + 1
            )
        worst_process = max(attributed, key=lambda p: attributed[p])
    else:
        worst_process = max(worst_counts, key=lambda p: worst_counts[p])
    return {
        "windows_compared": len(skews),
        "skew_threshold": skew_threshold,
        "max_skew": round(max(skews), 3),
        "median_skew": round(statistics.median(skews), 3),
        "worst_process": worst_process,
        "worst_window_counts": {
            str(p): n for p, n in sorted(worst_counts.items())
        },
        "alert_count": len(alerts),
        "alerts": alerts[:max_alerts],
    }


def _process_row(led: ProcessLedger) -> Dict:
    """One per-host summary row of the fleet section."""
    windows = _windows(led)
    header = led.header
    serve_windows = [
        e for e in led.events if e.get("event") == "serve_window"
    ]
    row: Dict = {
        "process_index": led.process_index,
        "ledger": os.path.basename(led.path),
        "parse_errors": led.parse_errors,
        "kind": header.get("kind") or header.get("task") or "unknown",
        "windows": len(windows),
        "last_step": windows[-1].get("step") if windows else None,
        "data_wait_s": round(
            sum(e.get("data_wait_s", 0.0) for e in windows), 3
        ),
        "compute_s": round(sum(e.get("compute_s", 0.0) for e in windows), 3),
        "fetch_wait_s": round(
            sum(e.get("fetch_wait_s", 0.0) for e in windows), 3
        ),
        "barrier_wait_s": round(
            sum(e.get("barrier_wait_s", 0.0) for e in windows), 3
        ),
    }
    mean_ms = _weighted_mean_ms(windows)
    if mean_ms is not None:
        row["step_time_mean_ms"] = round(mean_ms, 3)
    # per-host MFU (steps-weighted over clean windows): a host whose MFU sits
    # below the fleet's is burning its FLOPs somewhere — the roofline capture
    # says where. Absent when the backend has no peak-FLOPs entry (CPU).
    mfu_pairs = [
        (float(e["mfu"]), float(e.get("steps", 1)))
        for e in windows
        if e.get("mfu") is not None and not e.get("dirty")
    ]
    if mfu_pairs:
        total_w = sum(w for _, w in mfu_pairs)
        if total_w:
            row["mfu"] = round(
                sum(v * w for v, w in mfu_pairs) / total_w, 4
            )
    fp = header.get("fingerprint") or {}
    if fp and "error" not in fp:
        row["device_kind"] = fp.get("device_kind")
    # capacity/cost accounting per process (obs/capacity.py): cumulative
    # chip-seconds, per-chip request rate, and the HBM watermark — the
    # per-host halves of the fleet-wide cost/headroom aggregates
    from tensorflowdistributedlearning_tpu_torch.obs import capacity as capacity_lib

    cost = capacity_lib.aggregate_cost_events(led.events)
    if cost:
        cost_row: Dict = {}
        for scope in ("train", "serve"):
            section = cost.get(scope)
            if not section:
                continue
            cost_row["n_chips"] = section.get("n_chips")
            cost_row["chip_seconds_total"] = section.get("chip_seconds_total")
            if scope == "serve" and section.get("rps_per_chip") is not None:
                cost_row["rps_per_chip"] = section["rps_per_chip"]
            if scope == "serve" and section.get("chip_seconds_per_request"):
                cost_row["chip_seconds_per_request"] = section[
                    "chip_seconds_per_request"
                ]
                cost_row["requests"] = section.get("requests")
            if scope == "train" and section.get("chip_seconds_per_step") is not None:
                cost_row["chip_seconds_per_step"] = section[
                    "chip_seconds_per_step"
                ]
        if cost_row:
            row["cost"] = cost_row
    marks = capacity_lib.aggregate_watermark_events(led.events)
    if marks:
        mem_row: Dict = {"peak_bytes": marks["peak_bytes"]}
        if marks.get("headroom_frac") is not None:
            mem_row["headroom_frac"] = marks["headroom_frac"]
        row["memory"] = mem_row
    if serve_windows:
        last = serve_windows[-1]
        serve: Dict = {
            "windows": len(serve_windows),
            "requests": last.get("requests", 0),
            "completed": last.get("completed", 0),
            "rejected_queue_full": last.get("rejected_queue_full", 0),
        }
        if last.get("replica") is not None:
            serve["replica"] = last["replica"]
        # multi-tenant attribution: a model-bound replica stamps its model
        # (and registry version) on every window; a replica mounting several
        # models carries a per-model sub-dict instead
        if last.get("model") is not None:
            serve["model"] = last["model"]
            if last.get("model_version") is not None:
                serve["model_version"] = last["model_version"]
        models = last.get("models")
        if isinstance(models, dict):
            serve["models"] = {
                name: {
                    "version": mrow.get("version"),
                    "requests": mrow.get("requests", 0),
                    "completed": mrow.get("completed", 0),
                    "p99_ms": (
                        (mrow.get("latency_ms") or {}).get("request") or {}
                    ).get("p99_ms"),
                }
                for name, mrow in models.items()
            }
        p99s = [
            e["latency_ms"]["request"]["p99_ms"]
            for e in serve_windows
            if "request" in e.get("latency_ms", {})
        ]
        if p99s:
            serve["request_p99_worst_window_ms"] = round(max(p99s), 3)
        row["serve"] = serve
    return row


def _attribution_hint(
    rows: List[Dict], straggler: Optional[Dict]
) -> Optional[str]:
    """Slow host or slow network? On a synchronous fleet the straggler
    arrives at barriers LAST and so waits least; if the named worst host also
    has the minimum barrier wait, the skew is that host's own step time (slow
    host). Roughly equal barrier waits with high collective time in the
    capture buckets point at the interconnect instead."""
    if not straggler or not straggler["alert_count"]:
        return None
    waits = {
        r["process_index"]: r["barrier_wait_s"]
        for r in rows
        if r.get("windows")
    }
    if len(waits) < 2 or not any(waits.values()):
        return None
    worst = straggler["worst_process"]
    if worst in waits and waits[worst] == min(waits.values()):
        return (
            f"process {worst} waits least at barriers while running the "
            "slowest steps — a slow HOST, not a slow network"
        )
    return (
        "barrier waits do not single out the slow host — check the trace "
        "section's collectives bucket for network time"
    )


def fleet_section(
    workdir: str,
    *,
    ledgers: Optional[List[ProcessLedger]] = None,
    skew_threshold: float = DEFAULT_SKEW_THRESHOLD,
) -> Optional[Dict]:
    """The merged report's ``fleet`` section; None for single-ledger
    workdirs (the overwhelmingly common case costs one glob)."""
    if ledgers is None:
        ledgers = discover_ledgers(workdir)
    if len(ledgers) < 2:
        return None
    rows = [_process_row(led) for led in ledgers]
    section: Dict = {
        "processes": len(ledgers),
        "ledger_parse_errors": sum(led.parse_errors for led in ledgers),
        "per_process": rows,
    }
    # fleet-wide cost/capacity rollup: total chip-seconds across every
    # process, summed per-chip request rate (the Gemma-on-TPU cost-per-qps
    # lens at fleet scale), and the tightest replica's headroom
    chip_s = [r["cost"]["chip_seconds_total"] for r in rows if r.get("cost")]
    rps = [
        r["cost"]["rps_per_chip"]
        for r in rows
        if r.get("cost", {}).get("rps_per_chip") is not None
    ]
    headrooms = [
        r["memory"]["headroom_frac"]
        for r in rows
        if r.get("memory", {}).get("headroom_frac") is not None
    ]
    if chip_s or rps or headrooms:
        rollup: Dict = {}
        if chip_s:
            rollup["chip_seconds_total"] = round(sum(chip_s), 3)
        if rps:
            rollup["rps_per_chip_total"] = round(sum(rps), 3)
        if headrooms:
            rollup["min_headroom_frac"] = min(headrooms)
        # fleet-wide chip-seconds/request: request-count-weighted merge of
        # the replicas' percentiles (worst replica for p99 — the same
        # approximate merge every other cross-window percentile uses)
        per_req = [
            (r["cost"]["chip_seconds_per_request"], r["cost"].get("requests") or 1)
            for r in rows
            if r.get("cost", {}).get("chip_seconds_per_request")
        ]
        if per_req:
            total_w = sum(w for _, w in per_req)
            rollup["chip_seconds_per_request"] = {
                key: round(
                    sum(s[key] * w for s, w in per_req) / total_w, 9
                )
                for key in ("mean", "p50", "p90")
            }
            rollup["chip_seconds_per_request"]["p99_worst_replica"] = round(
                max(
                    s.get("p99_worst_window", s.get("p99", 0.0))
                    for s, _ in per_req
                ),
                9,
            )
        section["capacity"] = rollup
    # fleet MFU rollup: min + median across hosts. A host whose MFU trails
    # the fleet median is a straggler signal ORTHOGONAL to step-time skew —
    # on a synchronous fleet steps finish together, so a slow host shows up
    # as everyone's lower MFU, but a host burning time off the device (input
    # stalls, host-side work) shows a LOWER OWN MFU at the same step time.
    mfus = sorted(
        (r["process_index"], r["mfu"]) for r in rows if r.get("mfu") is not None
    )
    if mfus:
        vals = sorted(v for _, v in mfus)
        mid = len(vals) // 2
        median = (
            vals[mid]
            if len(vals) % 2
            else (vals[mid - 1] + vals[mid]) / 2.0
        )
        worst = min(mfus, key=lambda pair: pair[1])
        section["mfu"] = {
            "hosts": len(mfus),
            "min": round(min(vals), 4),
            "median": round(median, 4),
            "min_process": worst[0],
        }
    # per-model serving rollup across the fleet: replica count, completed
    # totals, worst replica p99 per tenant (both attribution shapes merge —
    # single-model replicas' top-level stamp and multi-mount sub-dicts)
    model_totals: Dict[str, Dict] = {}
    for r in rows:
        sv = r.get("serve")
        if not sv:
            continue
        per = sv.get("models")
        if not per and sv.get("model"):
            per = {
                sv["model"]: {
                    "version": sv.get("model_version"),
                    "requests": sv.get("requests", 0),
                    "completed": sv.get("completed", 0),
                    "p99_ms": sv.get("request_p99_worst_window_ms"),
                }
            }
        if not per:
            continue
        for name, mrow in per.items():
            agg = model_totals.setdefault(
                name,
                {
                    "replicas": 0,
                    "requests": 0,
                    "completed": 0,
                    "worst_p99_ms": None,
                    "versions": {},
                },
            )
            agg["replicas"] += 1
            agg["requests"] += int(mrow.get("requests") or 0)
            agg["completed"] += int(mrow.get("completed") or 0)
            p99 = mrow.get("p99_ms")
            if p99 is not None:
                agg["worst_p99_ms"] = max(
                    agg["worst_p99_ms"] or 0.0, float(p99)
                )
            if mrow.get("version") is not None:
                key = str(mrow["version"])
                agg["versions"][key] = agg["versions"].get(key, 0) + 1
    if model_totals:
        section["models"] = model_totals
    straggler = straggler_section(ledgers, skew_threshold=skew_threshold)
    if straggler:
        section["straggler"] = straggler
        hint = _attribution_hint(rows, straggler)
        if hint:
            section["attribution_hint"] = hint
    return section


def fleet_summary(workdir: str, **kwargs) -> Dict:
    """Standalone merge (``run_suite --aggregate``, ad-hoc tooling): like
    :func:`fleet_section` but meaningful for ANY ledger count — a dict with
    ``processes`` 0 (nothing found), 1, or the full merged section."""
    ledgers = discover_ledgers(workdir)
    if not ledgers:
        return {"processes": 0, "per_process": [], "ledger_parse_errors": 0}
    section = fleet_section(workdir, ledgers=ledgers, **kwargs)
    if section is None:
        section = {
            "processes": 1,
            "ledger_parse_errors": ledgers[0].parse_errors,
            "per_process": [_process_row(ledgers[0])],
        }
    return section


def render_fleet_section(section: Dict) -> List[str]:
    """Text lines for ``obs.report.render_report``."""
    lines = [f"\nfleet: {section['processes']} process ledgers merged"]
    if section.get("ledger_parse_errors"):
        lines.append(
            f"  !! {section['ledger_parse_errors']} unparseable ledger "
            "line(s) dropped across the fleet (torn writes?)"
        )
    for row in section["per_process"]:
        parts = [
            f"  p{row['process_index']} [{row['kind']}]",
            f"{row['windows']} window(s)",
        ]
        if row.get("step_time_mean_ms") is not None:
            parts.append(f"step {row['step_time_mean_ms']:.2f}ms")
        if row.get("mfu") is not None:
            parts.append(f"mfu {row['mfu']:.1%}")
        parts.append(
            f"wait/compute/fetch/barrier "
            f"{row['data_wait_s']:.2f}/{row['compute_s']:.2f}/"
            f"{row['fetch_wait_s']:.2f}/{row['barrier_wait_s']:.2f}s"
        )
        if row.get("serve"):
            sv = row["serve"]
            replica = (
                f" replica {sv['replica']}" if "replica" in sv else ""
            )
            model = f"[{sv['model']}]" if sv.get("model") else ""
            parts.append(
                f"serve{model}{replica}: {sv['completed']}/{sv['requests']} ok"
            )
        if row.get("cost", {}).get("rps_per_chip") is not None:
            parts.append(f"{row['cost']['rps_per_chip']:.1f} rps/chip")
        if row.get("memory", {}).get("headroom_frac") is not None:
            parts.append(
                f"headroom {row['memory']['headroom_frac']:.1%}"
            )
        if row.get("parse_errors"):
            parts.append(f"!! {row['parse_errors']} parse error(s)")
        lines.append("  ".join(parts))
    cap = section.get("capacity")
    if cap:
        parts = []
        if cap.get("chip_seconds_total") is not None:
            parts.append(f"{cap['chip_seconds_total']:.1f} chip-seconds total")
        if cap.get("rps_per_chip_total") is not None:
            parts.append(
                f"{cap['rps_per_chip_total']:.1f} rps/chip fleet-wide"
            )
        if cap.get("min_headroom_frac") is not None:
            parts.append(
                f"min HBM headroom {cap['min_headroom_frac']:.1%}"
            )
        lines.append("  capacity: " + ", ".join(parts))
        pr = cap.get("chip_seconds_per_request")
        if pr:
            lines.append(
                "    chip-ms/request: "
                f"mean {pr['mean'] * 1000:.3f}  p50 {pr['p50'] * 1000:.3f}  "
                f"p90 {pr['p90'] * 1000:.3f}  "
                f"p99(worst replica) {pr['p99_worst_replica'] * 1000:.3f}"
            )
    models = section.get("models")
    if models:
        lines.append("  models:")
        for name, m in models.items():
            line = (
                f"    {name}: {m['replicas']} replica(s), "
                f"{m['completed']}/{m['requests']} ok"
            )
            if m.get("worst_p99_ms") is not None:
                line += f", worst p99 {m['worst_p99_ms']:.1f}ms"
            if m.get("versions"):
                vers = "/".join(sorted(m["versions"]))
                line += f", v{vers}"
                if len(m["versions"]) > 1:
                    line += " (mixed — promotion in flight?)"
            lines.append(line)
    fleet_mfu = section.get("mfu")
    if fleet_mfu:
        line = (
            f"  mfu: min {fleet_mfu['min']:.1%} "
            f"(p{fleet_mfu['min_process']}), "
            f"median {fleet_mfu['median']:.1%} over {fleet_mfu['hosts']} "
            "host(s)"
        )
        if fleet_mfu["min"] < 0.8 * fleet_mfu["median"]:
            line += (
                f" — !! p{fleet_mfu['min_process']} trails the fleet (host-"
                "side stall? capture a roofline with --profile-every-windows)"
            )
        lines.append(line)
    st = section.get("straggler")
    if st:
        lines.append(
            f"  straggler: max skew {st['max_skew']:.2f}x over "
            f"{st['windows_compared']} comparable window(s) "
            f"(threshold {st['skew_threshold']:.2f}x)"
        )
        if st["alert_count"]:
            lines.append(
                f"  !! {st['alert_count']} straggler_alert(s) — worst host: "
                f"process {st['worst_process']}"
            )
            for a in st["alerts"][:3]:
                lines.append(
                    f"     - step {a['step']}: p{a['worst_process']} at "
                    f"{a['worst_ms']:.1f}ms vs median {a['median_ms']:.1f}ms "
                    f"({a['skew']:.2f}x)"
                )
        else:
            lines.append("  no straggler alerts (skew within threshold)")
    if section.get("attribution_hint"):
        lines.append(f"  hint: {section['attribution_hint']}")
    return lines
