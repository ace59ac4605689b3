"""Goodput report: one view over the run ledgers and, when one exists, a
profiler capture (counterpart of the JAX package's ``obs/report.py``).

``build_report(workdir)`` reads ``telemetry.jsonl`` (the last run in the
file) and every ``telemetry-{i}.jsonl`` beside it, and answers: where the
wall time went (data wait, step compute, eval, compile), the throughput
trend, step-time percentiles, first runs after warmup, serving, health,
capacity and cost, the fleet, and which device kernels dominate.

The kernel breakdown reads the port's own captures: the ``ops.json`` that
``obs/profiler.ContinuousProfiler`` writes beside ``trace.json`` in each
``profile/capture-*/`` (JAX's reads an xplane capture through
``utils/xplane.py``, which the port does not carry). Its section has JAX's
keys (``dir``, ``buckets_ms`` through ``profiler.grouped_breakdown``,
``top_ops``, ``skipped_plane_files`` for a torn file, ``note``).

``data_wait``, ``compute`` and ``eval`` are disjoint host spans; ``compile``
overlaps the span it happened in, so it is its own row. Every other section
computes what JAX's computes on the same ledgers, and
:func:`render_report` renders a report dict as JAX's does
(``tests/test_torch_telemetry_report.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from tensorflowdistributedlearning_tpu_torch.obs import capacity as capacity_lib
from tensorflowdistributedlearning_tpu_torch.obs import fleet as fleet_lib


def _weighted(values: List[float], weights: List[float]) -> Optional[float]:
    total = sum(weights)
    if not total:
        return None
    return sum(v * w for v, w in zip(values, weights)) / total


def _trace_section(trace_dir: str, top: int) -> Optional[Dict]:
    """Top-k device kernels and coarse buckets from the profiler captures
    under ``trace_dir`` (every ``ops.json``, summed by kernel name); None
    when there is no capture. A torn ``ops.json`` is skipped and counted;
    a capture that recorded no device kernel (a CPU capture) gives empty
    rows and a note."""
    import glob
    import json

    from tensorflowdistributedlearning_tpu_torch.obs import profiler

    files = sorted(glob.glob(os.path.join(trace_dir, "**", "ops.json"), recursive=True))
    if not files:
        return None
    totals: Dict[str, List[float]] = {}
    skipped = 0
    for path in files:
        try:
            with open(path) as f:
                ops = json.load(f)
            parsed = [(str(op["name"]), float(op["total_ms"]), int(op["occurrences"])) for op in ops]
        except (OSError, ValueError, TypeError, KeyError):
            skipped += 1
            continue
        for name, ms, n in parsed:
            row = totals.setdefault(name, [0.0, 0])
            row[0] += ms
            row[1] += n
    grand = sum(ms for ms, _ in totals.values()) or 1.0
    rows = sorted(
        (profiler.OpTime(name, round(ms, 6), int(n), round(ms / grand, 6)) for name, (ms, n) in totals.items()),
        key=lambda r: -r.total_ms,
    )
    section = {
        "dir": trace_dir,
        "buckets_ms": profiler.grouped_breakdown(rows),
        "top_ops": [dataclasses.asdict(r) for r in rows[:top]],
    }
    if skipped:
        section["skipped_plane_files"] = skipped
    if not rows:
        section["note"] = "no device kernel in these captures (a CPU capture records none)"
    return section


def _serve_section(windows: List[Dict]) -> Dict:
    """Aggregate ``serve_window`` events (serve/server.py) for the report.

    Counters in a window are cumulative since server start, so totals come
    from the last window; latency summaries are per-window (the server drains
    its histograms at each boundary), merged the same approximate way as
    ``step_time_ms``: count-weighted mean/p50/p90, worst-window p99."""
    last = windows[-1]
    totals = {
        k: last.get(k, 0)
        for k in (
            "requests",
            "completed",
            "rejected_queue_full",
            "deadline_exceeded",
            "errors",
            "batches",
            "batched_examples",
        )
    }
    section: Dict = {
        "windows": len(windows),
        **totals,
        "bucket_hits": last.get("bucket_hits", {}),
        "recompiles_post_warmup": last.get("recompiles_post_warmup"),
    }
    if last.get("serving_dtype"):
        section["serving_dtype"] = last["serving_dtype"]
    if last.get("padding_waste"):
        # cumulative like the hits: fraction of compiled batch slots filled
        # with padding, per bucket that saw traffic
        section["padding_waste"] = last["padding_waste"]
    if totals["batches"]:
        section["mean_batch_fill"] = round(
            totals["batched_examples"] / totals["batches"], 2
        )
    if windows[-1].get("slo"):
        section["slo"] = windows[-1]["slo"]
    # capture-tee loss (cumulative, like the other counters): samples the
    # loop WANTED but the bounded queue dropped — visible capture loss is
    # the fix for the shadow tee's original silent-drop gap
    if last.get("tee_dropped"):
        section["tee_dropped"] = last["tee_dropped"]
    if last.get("drift"):
        section["drift"] = last["drift"]
    # multi-tenant replica: per-model counters/latency/SLO ride in the last
    # window's "models" dict (serve/server.py emit_window); a single-tenant
    # model-aware replica stamps "model"/"model_version" at top level
    if last.get("models"):
        section["models"] = last["models"]
    elif last.get("model"):
        section["model"] = last["model"]
        if last.get("model_version") is not None:
            section["model_version"] = last["model_version"]
    latency: Dict = {}
    for name in ("queue_wait", "pad", "compute", "request"):
        per_window = [
            e["latency_ms"][name]
            for e in windows
            if name in e.get("latency_ms", {})
        ]
        if not per_window:
            continue
        weights = [s.get("count", 1.0) for s in per_window]
        latency[name] = {
            "mean": round(
                _weighted([s["mean_ms"] for s in per_window], weights) or 0, 3
            ),
            "p50": round(
                _weighted([s["p50_ms"] for s in per_window], weights) or 0, 3
            ),
            "p90": round(
                _weighted([s["p90_ms"] for s in per_window], weights) or 0, 3
            ),
            "p99_worst_window": round(
                max(s["p99_ms"] for s in per_window), 3
            ),
        }
    if latency:
        section["latency_ms"] = latency
    return section


def silent_mixed_fleet(fleet_state: Optional[Dict]) -> bool:
    """The warning condition the report and ``telemetry-top`` must agree
    on: replicas answering from more than one artifact identity with no
    promotion controller in charge (``fleet_state`` is a router_window
    event's ``fleet`` payload)."""
    fleet_state = fleet_state or {}
    artifacts = fleet_state.get("artifacts") or {}
    if len(artifacts) <= 1 or fleet_state.get("promotion_active"):
        return False
    models = fleet_state.get("models") or {}
    if models:
        # multi-tenant fleet: distinct artifacts per model are the design,
        # not drift — the mix is only "silent" when a single model answers
        # from more than one registry version with no promotion in charge
        return any(
            len(row.get("versions") or {}) > 1 for row in models.values()
        )
    return True


def _serve_fleet_section(events: List[Dict]) -> Optional[Dict]:
    """Aggregate the serving-fleet controller's events (serve/fleet.py +
    serve/router.py + serve/autoscale.py): router traffic counters,
    ``fleet_scale`` autoscale decisions, and replica lifecycle churn. None
    when the run was not a fleet controller."""
    router_windows = [e for e in events if e.get("event") == "router_window"]
    scales = [e for e in events if e.get("event") == "fleet_scale"]
    lifecycle = {
        kind: sum(1 for e in events if e.get("event") == f"replica_{kind}")
        for kind in ("spawn", "ready", "exit", "restart", "drain", "abandoned")
    }
    if not (router_windows or scales or any(lifecycle.values())):
        return None
    section: Dict = {}
    if router_windows:
        last = router_windows[-1]
        section["router"] = {
            "windows": len(router_windows),
            **{
                k: last.get(k, 0)
                for k in (
                    "requests",
                    "routed",
                    "retries",
                    "shed",
                    "no_replica",
                    "replica_failures",
                    "tee_dropped",
                )
            },
            "per_replica_routed": last.get("per_replica_routed", {}),
            "fleet": last.get("fleet", {}),
        }
        # artifact mix (serve/router.py polls each replica's /healthz
        # identity): >1 distinct artifact OUTSIDE an active promotion is a
        # silent mixed fleet — rendered as a warning, not trivia
        fleet_state = last.get("fleet") or {}
        if fleet_state.get("models"):
            # multi-tenant routing: per-model replica sets, backlog, worst
            # p99, version mix, and the router's own per-model counters
            section["router"]["models"] = fleet_state["models"]
        if last.get("fair_share"):
            section["router"]["fair_share"] = last["fair_share"]
        artifacts = fleet_state.get("artifacts") or {}
        if artifacts:
            section["router"]["artifacts"] = artifacts
            section["router"]["mixed_artifacts"] = len(artifacts) > 1
            section["router"]["silent_mixed_fleet"] = silent_mixed_fleet(
                fleet_state
            )
    if scales:
        section["autoscale"] = {
            "decisions": len(scales),
            "scale_up": sum(1 for e in scales if e.get("action") == "scale_up"),
            "scale_down": sum(
                1 for e in scales if e.get("action") == "scale_down"
            ),
            "budget_deferred": sum(
                1 for e in scales if e.get("action") == "budget_deferred"
            ),
            "final_replicas": scales[-1].get("to_replicas"),
            "events": [
                {
                    k: e.get(k)
                    for k in (
                        "action",
                        "model",
                        "from_replicas",
                        "to_replicas",
                        "reason",
                        "mean_queue_depth",
                    )
                    if k != "model" or e.get("model") is not None
                }
                for e in scales[-10:]
            ],
        }
    if any(lifecycle.values()):
        section["replicas"] = dict(lifecycle)
        # spawn -> readiness-line wall time per replica_ready event: the
        # cold-start metric (interpreter boot + artifact load + ladder
        # warmup) the shipped compile cache exists to shrink
        ttrs = [
            float(e["time_to_ready_s"])
            for e in events
            if e.get("event") == "replica_ready"
            and e.get("time_to_ready_s") is not None
        ]
        if ttrs:
            section["replicas"]["time_to_ready_s"] = {
                "count": len(ttrs),
                "mean": round(sum(ttrs) / len(ttrs), 3),
                "max": round(max(ttrs), 3),
                "last": round(ttrs[-1], 3),
            }
    return section


_PROMOTION_KINDS = (
    "promotion_start",
    "phase_advance",
    "shadow_window",
    "promotion_rollback",
    "promotion_complete",
)


def _promotion_section(events: List[Dict]) -> Optional[Dict]:
    """The deployment history (serve/promote.py): every promotion the run's
    controller drove, phase by phase — starts, canary/rollout advances,
    shadow-compare windows, rollbacks (with reasons), completions. None when
    the run never promoted."""
    rows = [e for e in events if e.get("event") in _PROMOTION_KINDS]
    if not rows:
        return None
    shadows = [e for e in rows if e.get("event") == "shadow_window"]
    rollbacks = [e for e in rows if e.get("event") == "promotion_rollback"]
    section: Dict = {
        "events": len(rows),
        "starts": sum(
            1
            for e in rows
            if e.get("event") == "promotion_start" and not e.get("refused")
        ),
        "completed": sum(
            1 for e in rows if e.get("event") == "promotion_complete"
        ),
        "rolled_back": sum(
            1 for e in rollbacks if e.get("status") == "rolled_back"
        ),
        "refused": sum(
            1 for e in rollbacks if e.get("status") == "refused"
        ),
        "aborted": sum(
            1 for e in rollbacks if e.get("status") == "aborted"
        ),
        "shadow_windows": len(shadows),
        "shadow_compared": sum(e.get("compared", 0) for e in shadows),
    }
    history = []
    for e in rows:
        entry = {
            "t": e.get("t"),
            "kind": e.get("event"),
        }
        for k in (
            "phase", "candidate_dir", "dtype", "fingerprint", "replica",
            "replaced", "remaining", "reason", "status", "refused",
            "compared", "min_iou", "mean_disagree", "max_abs_delta",
            "restored", "drained", "abort_reason", "duration_s", "windows",
        ):
            if e.get(k) is not None:
                entry[k] = e[k]
        history.append(entry)
    section["history"] = history
    if rollbacks:
        section["last_rollback"] = {
            k: rollbacks[-1].get(k)
            for k in ("phase", "reason", "status", "restored", "abort_reason")
            if rollbacks[-1].get(k) is not None
        }
    return section


_LOOP_KINDS = (
    "loop_trigger",
    "loop_retrain",
    "loop_promoted",
    "loop_rejected",
)


def _loop_section(ledgers) -> Optional[Dict]:
    """The continuous-learning loop's audit trail (loop/), merged across
    EVERY process ledger in the workdir: capture_window/drift_alert events
    live in the replica ledgers (process >= 1), records_ingest and the
    loop_* cycle events in the flywheel's high-numbered ledger. None when
    nothing loop-related ever ran here."""
    merged: List[Dict] = []
    for led in ledgers:
        merged.extend(
            e
            for e in led.events
            if e.get("event")
            in _LOOP_KINDS + ("capture_window", "records_ingest", "drift_alert")
        )
    if not merged:
        return None
    merged.sort(key=lambda e: e.get("t", 0.0))
    section: Dict = {}

    captures = [e for e in merged if e.get("event") == "capture_window"]
    if captures:
        # totals are cumulative per replica — take each replica's last window
        last_per_replica: Dict = {}
        for e in captures:
            last_per_replica[e.get("replica", 0)] = e
        section["capture"] = {
            "windows": len(captures),
            "replicas": len(last_per_replica),
            "captured": sum(
                e.get("total_captured", 0)
                for e in last_per_replica.values()
            ),
            "dropped": sum(
                e.get("total_dropped", 0) for e in last_per_replica.values()
            ),
            "shards": sum(
                e.get("shards", 0) for e in last_per_replica.values()
            ),
            "evicted": sum(
                e.get("shards_evicted", 0) for e in captures
            ),
            "bytes_on_disk": sum(
                e.get("bytes_on_disk", 0)
                for e in last_per_replica.values()
            ),
        }

    ingests = [e for e in merged if e.get("event") == "records_ingest"]
    if ingests:
        last = ingests[-1]
        section["ingest"] = {
            "runs": len(ingests),
            "records_added": sum(e.get("records_added", 0) for e in ingests),
            "new_shards": sum(e.get("new_shards", 0) for e in ingests),
            "deduped": sum(e.get("deduped", 0) for e in ingests),
            "corrupt": sum(e.get("corrupt", 0) for e in ingests),
            "dataset_version": last.get("version"),
            "records_total": last.get("records_total"),
            "dataset_dir": last.get("dataset_dir"),
        }

    drift_alerts = [e for e in merged if e.get("event") == "drift_alert"]
    fired = [e for e in drift_alerts if not e.get("resolved")]
    if drift_alerts:
        section["drift"] = {
            "alerts": len(fired),
            "resolved": len(drift_alerts) - len(fired),
            "last": {
                k: drift_alerts[-1].get(k)
                for k in (
                    "replica", "score", "threshold", "output", "resolved",
                )
                if drift_alerts[-1].get(k) is not None
            },
        }

    cycles = [e for e in merged if e.get("event") in _LOOP_KINDS]
    if cycles:
        triggers = [e for e in cycles if e.get("event") == "loop_trigger"]
        promoted = [e for e in cycles if e.get("event") == "loop_promoted"]
        rejected = [e for e in cycles if e.get("event") == "loop_rejected"]
        loop: Dict = {
            "triggers": len(triggers),
            "retrains": sum(
                1 for e in cycles if e.get("event") == "loop_retrain"
            ),
            "promoted": len(promoted),
            "rejected": len(rejected),
            "history": [
                {
                    "t": e.get("t"),
                    "kind": e.get("event"),
                    **{
                        k: e.get(k)
                        for k in (
                            "reason", "records_new", "dataset_version",
                            "drift_score", "rc", "duration_s",
                            "candidate_dir", "fingerprint", "error",
                        )
                        if e.get(k) is not None
                    },
                }
                for e in cycles
            ],
        }
        # drift-trigger latency: alert fired -> loop answered
        drift_trigs = [
            e
            for e in triggers
            if e.get("reason") == "drift" and e.get("drift_alert_t")
        ]
        if drift_trigs:
            loop["drift_trigger_latency_s"] = round(
                max(
                    0.0,
                    drift_trigs[-1]["t"] - drift_trigs[-1]["drift_alert_t"],
                ),
                3,
            )
        if promoted:
            last_ok = promoted[-1]
            loop["last_promoted"] = {
                k: last_ok.get(k)
                for k in ("candidate_dir", "fingerprint", "duration_s")
                if last_ok.get(k) is not None
            }
        section["cycles"] = loop

    return section or None


def _health_section(events: List[Dict]) -> Optional[Dict]:
    """Aggregate ``health_alert`` events (obs/health.py) for the last run:
    per-monitor counts, active-vs-resolved state, and the most recent alert's
    details. None when the run never alerted."""
    alerts = [e for e in events if e.get("event") == "health_alert"]
    if not alerts:
        return None
    monitors: Dict[str, Dict] = {}
    for e in alerts:
        name = e.get("monitor", "unknown")
        m = monitors.setdefault(
            name, {"alerts": 0, "resolved": 0, "active": False}
        )
        if e.get("resolved"):
            m["resolved"] += 1
            m["active"] = False
        else:
            m["alerts"] += 1
            m["active"] = True
        m["last"] = {
            k: v for k, v in e.items() if k not in ("event", "t")
        }
    return {
        "alerts": sum(m["alerts"] for m in monitors.values()),
        "monitors": monitors,
        "degraded": sorted(
            name for name, m in monitors.items() if m["active"]
        ),
    }


def _trace_summary(events: List[Dict]) -> Optional[Dict]:
    """Span counts by name for the run's sampled ``trace`` events — enough
    for the report to say tracing was on and what `--export-trace` will
    contain. None when the run recorded no spans."""
    spans = [e for e in events if e.get("event") == "trace"]
    if not spans:
        return None
    by_name: Dict[str, int] = {}
    traces = set()
    for e in spans:
        by_name[e.get("name", "span")] = by_name.get(e.get("name", "span"), 0) + 1
        traces.add(e.get("trace_id"))
    return {"spans": len(spans), "traces": len(traces), "by_name": by_name}


def _resilience_scope(all_events: List[Dict]) -> List[Dict]:
    """The event window the resilience section describes: the last SUPERVISED
    SESSION (from ``supervisor_start``; every relaunch in it writes its own
    ``supervised``-stamped run header, so restarts by construction straddle
    run boundaries and a plain last-run scope would lose them) — unless a
    later STANDALONE run (a run header without the ``supervised`` stamp)
    started after the session, in which case that run is the story and stale
    restarts/aborts must not haunt it. Keying the takeover on the header
    stamp rather than ``supervisor_end`` means even a hard-killed supervisor
    (no end event ever written) cannot haunt later clean runs."""
    last_start = None
    last_header = None
    for i, e in enumerate(all_events):
        kind = e.get("event")
        if kind == "supervisor_start":
            last_start = i
        elif kind == "run_header":
            last_header = i
    if last_start is None:
        return all_events[last_header:] if last_header is not None else all_events
    standalone = [
        i
        for i, e in enumerate(all_events[last_start:], last_start)
        if e.get("event") == "run_header" and not e.get("supervised")
    ]
    if standalone:
        return all_events[standalone[-1]:]
    return all_events[last_start:]


def _resilience_section(all_events: List[Dict]) -> Optional[Dict]:
    """Aggregate resilience events (resilience/) over ``_resilience_scope``.
    None when that window shows a clean, never-preempted history."""
    scope = _resilience_scope(all_events)
    restarts = [e for e in scope if e.get("event") == "restart"]
    preempted = [e for e in scope if e.get("event") == "preempted"]
    resumed = [e for e in scope if e.get("event") == "resumed"]
    # only per-step events: the fresh-init SUMMARY event shares the kind but
    # has no step, and counting it would inflate skipped-checkpoint totals
    corrupt = [
        e
        for e in scope
        if e.get("event") == "checkpoint_corrupt" and "step" in e
    ]
    retries = [e for e in scope if e.get("event") == "checkpoint_retry"]
    aborts = [e for e in scope if e.get("event") == "supervisor_abort"]
    if not (restarts or preempted or resumed or corrupt or retries or aborts):
        return None
    section: Dict = {
        "restarts": len(restarts),
        # goodput lost to restarts: child-death -> relaunch wall time
        # (backoff included), as measured by the supervisor
        "restart_downtime_s": round(
            sum(e.get("downtime_s", 0.0) for e in restarts), 3
        ),
        "preemptions": len(preempted),
        "resumes": len(resumed),
        "corrupt_checkpoints_skipped": len(corrupt),
        "checkpoint_retries": len(retries),
    }
    if restarts:
        section["last_restart"] = {
            k: restarts[-1].get(k) for k in ("attempt", "rc", "reason", "step")
        }
    if resumed:
        section["last_resume_step"] = resumed[-1].get("step")
    if aborts:
        section["aborted"] = aborts[-1].get("reason")
    return section


def _elastic_section(all_events: List[Dict]) -> Optional[Dict]:
    """Aggregate the last elastic session's events (parallel/elastic.py):
    ``elastic_start`` .. ``elastic_end`` brackets with every ``world_resize``
    / ``host_evicted`` / ``data_redeal`` in between — the world-trajectory
    and goodput-lost-to-resizes story. None when the history holds no
    elastic session."""
    starts = [
        i for i, e in enumerate(all_events)
        if e.get("event") == "elastic_start"
    ]
    if not starts:
        return None
    scope = all_events[starts[-1]:]
    start = scope[0]
    resizes = [e for e in scope if e.get("event") == "world_resize"]
    evictions = [e for e in scope if e.get("event") == "host_evicted"]
    redeals = [e for e in scope if e.get("event") == "data_redeal"]
    aborts = [e for e in scope if e.get("event") == "elastic_abort"]
    end = next(
        (e for e in reversed(scope) if e.get("event") == "elastic_end"), None
    )
    hosts = start.get("hosts")
    world = (
        end.get("world_size") if end else
        (resizes[-1].get("new_world") if resizes else hosts)
    )
    section: Dict = {
        "hosts": hosts,
        "min_hosts": start.get("min_hosts"),
        "world_size": world,
        "live": end is None,
        "resizes": len(resizes),
        "evictions": len(evictions),
        "data_redeals": len(redeals),
        # goodput lost to resizes: drain start -> new world spawned, as the
        # coordinator measured it (the same accounting lens as the
        # resilience section's restart downtime)
        "resize_downtime_s": round(
            sum(e.get("downtime_s", 0.0) for e in resizes), 3
        ),
        "resize_events": [
            {
                k: e.get(k)
                for k in (
                    "old_world", "new_world", "reason", "progress_step",
                    "downtime_s", "process_index", "evicted_process",
                    "measured_margin_bytes", "plan_old", "plan_new",
                )
                if e.get(k) is not None
            }
            for e in resizes
        ],
    }
    if end is not None:
        section["ok"] = bool(end.get("ok"))
    if aborts:
        section["aborted"] = aborts[-1].get("reason")
    elif end is not None and end.get("aborted"):
        section["aborted"] = end["aborted"]
    return section


def build_report(
    workdir: str,
    *,
    trace_dir: Optional[str] = None,
    top: int = 10,
    straggler_threshold: float = fleet_lib.DEFAULT_SKEW_THRESHOLD,
) -> Dict:
    """Assemble the goodput report dict for a workdir's last run.

    Multi-host workdirs hold one ledger per process (obs/fleet.py naming
    contract); the report is anchored on process 0's ledger and gains a
    ``fleet`` section merging all of them (per-host goodput splits, straggler
    analysis past ``straggler_threshold`` skew)."""
    ledgers = fleet_lib.discover_ledgers(workdir)
    if not ledgers:
        raise FileNotFoundError(
            f"no telemetry ledger (telemetry.jsonl / telemetry-N.jsonl) "
            f"under {workdir} — pass the run's workdir (the --model-dir a "
            "trainer wrote, or a serve --workdir)"
        )
    # the primary (lowest-index) ledger, parsed once by the discovery: the
    # resilience section reads the WHOLE appended history (it scopes across
    # run boundaries), everything else the last run
    all_events = ledgers[0].all_events
    parse_errors = ledgers[0].parse_errors
    events = ledgers[0].events
    if not events:
        raise ValueError(f"empty telemetry ledger under {workdir}")
    header = events[0] if events[0].get("event") == "run_header" else None
    windows = [e for e in events if e.get("event") == "step_window"]
    clean = [e for e in windows if not e.get("dirty")]
    evals = [e for e in events if e.get("event") == "eval"]
    checkpoints = [e for e in events if e.get("event") == "checkpoint"]
    compiles = [e for e in events if e.get("event") == "compile"]
    # a cache-SERVED compile still stalls the step that triggered it, but it
    # is a load, not a rebuild: counting it as a recompile would page the
    # operator for a shared cache doing its job. The zero-post-warmup
    # contract applies to REAL compiles only.
    cached_compiles = [e for e in compiles if e.get("cache_hit")]
    recompiles = [
        e for e in compiles if e.get("post_warmup") and not e.get("cache_hit")
    ]
    cached_post_warmup = [e for e in cached_compiles if e.get("post_warmup")]
    memories = [e for e in events if e.get("event") == "memory"]
    run_end = next(
        (e for e in reversed(events) if e.get("event") == "run_end"), None
    )

    wall_s = events[-1]["t"] - events[0]["t"] if len(events) > 1 else 0.0
    data_wait_s = sum(e.get("data_wait_s", 0.0) for e in windows)
    compute_s = sum(e.get("compute_s", 0.0) for e in windows)
    fetch_wait_s = sum(e.get("fetch_wait_s", 0.0) for e in windows)
    barrier_wait_s = sum(e.get("barrier_wait_s", 0.0) for e in windows)
    eval_s = sum(e.get("duration_s", 0.0) for e in evals)
    # run_end carries the exact total from the detector (ledger compile lines
    # are thresholded to the non-trivial ones); fall back to summing those
    compile_s = (run_end or {}).get(
        "compile_total_s", sum(e.get("duration_s", 0.0) for e in compiles)
    )
    recompile_s = sum(e.get("duration_s", 0.0) for e in recompiles)

    def frac(x: float) -> Optional[float]:
        return round(x / wall_s, 4) if wall_s > 0 else None

    report: Dict = {
        "workdir": workdir,
        "header": {
            **{
                k: v
                for k, v in (header or {}).items()
                if k not in ("event", "t")
            },
            # always present, normally 0: a crashed writer's torn last line
            # (or a corrupted middle) must be visible, not silently absent
            "ledger_parse_errors": parse_errors,
        },
        "run": {
            # when the run actually happened (first event's clock): registry
            # rows key their run_id off this, so registering a week-old
            # workdir does not stamp it with today's date
            "started_t": round(events[0]["t"], 3) if "t" in events[0] else None,
            "wall_s": round(wall_s, 3),
            "last_step": windows[-1]["step"] if windows else None,
            "windows": len(windows),
            "clean_windows": len(clean),
            # the trainers' finally blocks record exception exits with
            # interrupted=True, so a bare run_end means a clean finish
            "completed": run_end is not None and not run_end.get("interrupted"),
            "final": {
                k: v
                for k, v in (run_end or {}).items()
                if k not in ("event", "t")
            },
        },
        "time_split": {
            "data_wait_s": round(data_wait_s, 3),
            "compute_s": round(compute_s, 3),
            "fetch_wait_s": round(fetch_wait_s, 3),
            "barrier_wait_s": round(barrier_wait_s, 3),
            "eval_s": round(eval_s, 3),
            "compile_s": round(compile_s, 3),
            "data_wait_frac": frac(data_wait_s),
            "compute_frac": frac(compute_s),
            "fetch_wait_frac": frac(fetch_wait_s),
            "barrier_wait_frac": frac(barrier_wait_s),
            "eval_frac": frac(eval_s),
            "compile_frac": frac(compile_s),
        },
        "recompiles": {
            "post_warmup_count": len(recompiles),
            "post_warmup_s": round(recompile_s, 3),
            # post-warmup compiles the persistent cache answered: visible
            # (they still interrupt a step) but not alarms
            "cache_served_post_warmup": len(cached_post_warmup),
            "events": [
                {
                    "t": e["t"],
                    "duration_s": e.get("duration_s"),
                    "phase": e.get("phase", ""),
                }
                for e in recompiles
            ],
        },
        "evals": {
            "count": len(evals),
            "last_metrics": evals[-1].get("metrics") if evals else None,
        },
        "checkpoints": len(checkpoints),
    }

    # persistent compile cache verdicts: run_end carries the detector's
    # exact totals; a run that died early falls back to the ledgered
    # per-compile verdicts (cache-consulted compiles are always ledgered)
    cc_hits = (run_end or {}).get("compile_cache_hits")
    cc_misses = (run_end or {}).get("compile_cache_misses")
    cc_saved = (run_end or {}).get("compile_saved_s")
    if cc_hits is None and cc_misses is None:
        verdicts = [e for e in compiles if e.get("cache_hit") is not None]
        if verdicts:
            cc_hits = sum(1 for e in verdicts if e.get("cache_hit"))
            cc_misses = len(verdicts) - cc_hits
            cc_saved = round(
                sum(e.get("saved_s", 0.0) for e in verdicts
                    if e.get("cache_hit")),
                3,
            )
    if cc_hits is not None:
        total = cc_hits + (cc_misses or 0)
        report["compile_cache"] = {
            "hits": cc_hits,
            "misses": cc_misses or 0,
            "hit_ratio": round(cc_hits / total, 4) if total else None,
            "saved_s": cc_saved,
        }

    fleet = fleet_lib.fleet_section(
        workdir, ledgers=ledgers, skew_threshold=straggler_threshold
    )
    if fleet:
        report["fleet"] = fleet

    resilience = _resilience_section(all_events)
    if resilience:
        report["resilience"] = resilience

    elastic = _elastic_section(all_events)
    if elastic:
        report["elastic"] = elastic

    health = _health_section(events)
    if health:
        report["health"] = health
    traces = _trace_summary(events)
    if traces:
        report["traces"] = traces

    serve_windows = [e for e in events if e.get("event") == "serve_window"]
    if serve_windows:
        report["serve"] = _serve_section(serve_windows)

    serve_fleet = _serve_fleet_section(events)
    if serve_fleet:
        report["serve_fleet"] = serve_fleet

    promotion = _promotion_section(events)
    if promotion:
        report["promotion"] = promotion

    loop = _loop_section(ledgers)
    if loop:
        report["loop"] = loop

    quant_checks = [e for e in events if e.get("event") == "quant_check"]
    if quant_checks:
        report["quant_checks"] = [
            {
                k: e.get(k)
                for k in (
                    "dtype",
                    "passed",
                    "candidate",
                    "outputs",
                    "failures",
                    "fingerprint_match",
                )
            }
            for e in quant_checks
        ]

    depths = [e["prefetch_queue_depth"] for e in windows if "prefetch_queue_depth" in e]
    if depths:
        report["prefetch"] = {
            "windows": len(depths),
            "mean_queue_depth": round(
                sum(d["mean"] for d in depths) / len(depths), 2
            ),
            "min_queue_depth": min(d["min"] for d in depths),
            # windows whose queue touched empty: the loader failed to stay
            # ahead of the device at least once in them
            "underrun_windows": sum(1 for d in depths if d["min"] == 0),
        }
    # dirty windows carry compile/eval/checkpoint stalls whose input-side
    # hiccups are startup noise, not the workers failing to keep pace —
    # excluded exactly as they are from the throughput trend
    svc = [
        e["data_service"]
        for e in windows
        if "data_service" in e and not e.get("dirty")
    ]
    if svc:
        # the input service's own backpressure (data/service.py): reorder-
        # buffer depth behind the prefetcher, consumer-starved takes, and
        # worker utilization — the "is the service keeping up" row
        entry = {
            "windows": len(svc),
            "underruns": sum(int(s.get("underruns", 0)) for s in svc),
        }
        ready = [s["ready_depth"] for s in svc if "ready_depth" in s]
        if ready:
            entry["mean_ready_depth"] = round(
                sum(r["mean"] for r in ready) / len(ready), 2
            )
        utils = [s["worker_util"] for s in svc if "worker_util" in s]
        if utils:
            entry["mean_worker_util"] = round(sum(utils) / len(utils), 3)
        report.setdefault("prefetch", {})["data_service"] = entry

    ips = [
        (e["step"], e["images_per_sec"])
        for e in clean
        if e.get("images_per_sec") is not None
    ]
    if ips:
        vals = [v for _, v in ips]
        report["throughput"] = {
            "unit": "images/sec",
            "first": vals[0],
            "last": vals[-1],
            "best": max(vals),
            "mean": round(sum(vals) / len(vals), 2),
            "trend": ips,
        }
    stw = [e for e in windows if "step_time_ms" in e]
    if stw:
        weights = [float(e.get("steps", 1)) for e in stw]
        report["step_time_ms"] = {
            "mean": round(
                _weighted([e["step_time_ms"]["mean_ms"] for e in stw], weights), 3
            ),
            # per-window percentiles are merged approximately: weighted p50/p90,
            # worst-window p99 (raw samples are not persisted to the ledger)
            "p50": round(
                _weighted([e["step_time_ms"]["p50_ms"] for e in stw], weights), 3
            ),
            "p90": round(
                _weighted([e["step_time_ms"]["p90_ms"] for e in stw], weights), 3
            ),
            "p99_worst_window": round(
                max(e["step_time_ms"]["p99_ms"] for e in stw), 3
            ),
        }
    # MFU: analytic FLOPs (6*params*batch, the planner's model) over measured
    # step time and the device peak — absent (never 0/0) when the backend has
    # no peak-FLOPs entry (CPU) or the trainer never priced the step. Clean
    # windows only: a compile/eval window's step time is not model FLOPs.
    mfu_windows = [e for e in clean if e.get("mfu") is not None]
    if mfu_windows:
        mfu_weights = [float(e.get("steps", 1)) for e in mfu_windows]
        mfu_vals = [float(e["mfu"]) for e in mfu_windows]
        report["mfu"] = {
            "windows": len(mfu_vals),
            "mean": round(_weighted(mfu_vals, mfu_weights) or 0.0, 4),
            "last": mfu_vals[-1],
            "best": max(mfu_vals),
        }
    # continuous profiling (obs/profiler.py): windowed/triggered profiler
    # captures and their per-op roofline classification. Stable --json keys:
    # profiling.{captures,by_reason,rooflines,skipped_plane_files,
    # last_roofline}
    captures = [e for e in events if e.get("event") == "profile_capture"]
    rooflines = [e for e in events if e.get("event") == "op_roofline"]
    if captures or rooflines:
        by_reason: Dict[str, int] = {}
        for e in captures:
            reason = str(e.get("reason") or "unknown")
            by_reason[reason] = by_reason.get(reason, 0) + 1
        prof: Dict = {"captures": len(captures), "by_reason": by_reason}
        skipped_planes = sum(
            int(e.get("skipped_plane_files") or 0) for e in captures
        )
        if skipped_planes:
            prof["skipped_plane_files"] = skipped_planes
        if rooflines:
            prof["rooflines"] = len(rooflines)
            last_rf = rooflines[-1]
            prof["last_roofline"] = {
                k: last_rf.get(k)
                for k in (
                    "capture_id", "reason", "phase", "total_ms", "classes",
                    "top_hbm_op", "mfu", "compute_mfu",
                    "achieved_flops_per_sec_per_chip", "peak_flops_per_chip",
                    "achieved_collective_bytes_per_sec", "alert_id",
                )
                if last_rf.get(k) is not None
            }
        report["profiling"] = prof
    if memories:
        device_peak = 0
        for e in memories:
            for stats in (e.get("devices") or {}).values():
                device_peak = max(
                    device_peak,
                    stats.get("peak_bytes_in_use", stats.get("bytes_in_use", 0)),
                )
        mem: Dict = {"snapshots": len(memories)}
        if device_peak:
            mem["device_peak_bytes"] = device_peak
        rss = [
            e["host_rss_bytes"] for e in memories if "host_rss_bytes" in e
        ]
        if rss:
            mem["host_rss_peak_bytes"] = max(rss)
        # exact per-device state accounting the trainers attach post-init:
        # under weight_update_sharding the opt-state number is ~1/dp of the
        # replicated run's — the saving the mode exists for, made visible
        for key in ("opt_state_bytes_per_device", "params_bytes_per_device"):
            vals = [e[key] for e in memories if key in e]
            if vals:
                mem[key] = vals[-1]
        wus = [
            e["weight_update_sharding"]
            for e in memories
            if "weight_update_sharding" in e
        ]
        if wus:
            mem["weight_update_sharding"] = wus[-1]
        report["memory"] = mem

    # capacity layer (obs/capacity.py): per-phase peak-HBM watermarks with
    # the measured-vs-predicted bytes/chip delta, and chip-seconds cost.
    # Stable --json keys: memory.watermarks.{events,peak_bytes,phases,
    # bytes_limit,headroom_frac,predicted_bytes_per_device,
    # measured_minus_predicted_bytes} and cost.{events,train,serve} (train:
    # n_chips/chip_seconds_total/chip_seconds_per_step/
    # examples_per_chip_second; serve: n_chips/chip_seconds_total/requests/
    # rps_per_chip/duty_cycle/chip_seconds_per_request).
    watermarks = capacity_lib.aggregate_watermark_events(events)
    if watermarks:
        report.setdefault("memory", {})["watermarks"] = watermarks
    cost = capacity_lib.aggregate_cost_events(events)
    if cost:
        report["cost"] = cost

    # parallelism plan (parallel/planner.py, riding the run header): the
    # chosen layout + predicted bytes/chip, closed against the measured
    # watermark peak when the backend ledgered one — the margin the
    # planner's activation model needs, per run. Stable --json keys:
    # plan.{source,layout,predicted,headroom_frac,measured_peak_bytes,
    # measured_minus_predicted_bytes}
    plan = (header or {}).get("plan")
    if plan:
        plan_section: Dict = dict(plan)
        predicted_total = (plan.get("predicted") or {}).get(
            "total_bytes_per_chip"
        )
        measured = (watermarks or {}).get("peak_bytes")
        if predicted_total and measured:
            plan_section["measured_peak_bytes"] = measured
            plan_section["measured_minus_predicted_bytes"] = (
                measured - predicted_total
            )
        report["plan"] = plan_section

    try:
        report["trace"] = _trace_section(trace_dir or workdir, top)
    except (FileNotFoundError, ValueError, OSError):
        report["trace"] = None
    return report


def _fmt_frac(x: Optional[float]) -> str:
    return f"{x:6.1%}" if x is not None else "   n/a"


def render_report(report: Dict) -> str:
    """Human-readable rendering of ``build_report``'s dict."""
    lines: List[str] = []
    fp = (report.get("header") or {}).get("fingerprint") or {}
    run = report["run"]
    lines.append(f"== goodput report: {report['workdir']}")
    parse_errors = (report.get("header") or {}).get("ledger_parse_errors")
    if parse_errors:
        lines.append(
            f"   !! {parse_errors} unparseable ledger line(s) dropped — a "
            "crashed writer's torn tail, or worse; the report understates "
            "the run"
        )
    if fp and "error" not in fp:
        lines.append(
            f"   {fp.get('n_devices', '?')}x {fp.get('device_kind', '?')} "
            f"({fp.get('platform', '?')}), "
            f"{fp.get('process_count', 1)} process(es), "
            f"jax {fp.get('jax_version', '?')}"
        )
    lines.append(
        f"   wall {run['wall_s']:.1f}s, last step {run['last_step']}, "
        f"{run['windows']} windows ({run['clean_windows']} clean), "
        f"run {'completed' if run['completed'] else 'IN PROGRESS / interrupted'}"
    )
    plan = report.get("plan")
    if plan:
        lay = plan.get("layout") or {}
        parts = [f"dp{lay.get('data_parallel', '?')}"]
        for key, tag in (
            ("model_parallel", "tp"),
            ("pipeline_parallel", "pp"),
            ("sequence_parallel", "sp"),
            ("expert_parallel", "ep"),
        ):
            if (lay.get(key) or 1) > 1:
                parts.append(f"{tag}{lay[key]}")
        if lay.get("weight_update_sharding"):
            parts.append("zero1")
        pred = plan.get("predicted") or {}
        line = (
            f"\nparallelism plan ({plan.get('source', '?')}): "
            + "x".join(parts)
        )
        if pred.get("total_bytes_per_chip"):
            line += (
                f" — predicted {pred['total_bytes_per_chip'] / (1 << 20):.1f}"
                " MB/chip"
            )
            detail = [
                f"{tag} {pred[key] / (1 << 20):.1f}"
                for key, tag in (
                    ("params_bytes_per_chip", "params"),
                    ("opt_state_bytes_per_chip", "opt"),
                    ("activation_bytes_per_chip", "act"),
                )
                if pred.get(key) is not None
            ]
            if detail:
                line += f" ({', '.join(detail)})"
        if plan.get("headroom_frac") is not None:
            line += f", headroom {plan['headroom_frac']:.1%}"
        lines.append(line)
        if plan.get("measured_peak_bytes"):
            delta = plan.get("measured_minus_predicted_bytes", 0)
            lines.append(
                f"   measured peak {plan['measured_peak_bytes'] / (1 << 20):.1f}"
                f" MB/chip — {'+' if delta >= 0 else ''}"
                f"{delta / (1 << 20):.1f} MB vs predicted (the margin the "
                "planner's activation model needs)"
            )
        if plan.get("cost_provenance"):
            prov = plan["cost_provenance"]
            mc = plan.get("measured_costs") or {}
            if prov == "measured" and mc.get("flops_per_sec_per_chip"):
                lines.append(
                    f"   cost model: measured "
                    f"({mc['flops_per_sec_per_chip'] / 1e12:.2f} TFLOP/s/chip "
                    f"from {mc.get('captures', 0)} roofline capture(s))"
                )
            else:
                lines.append(f"   cost model: {prov}")
        for warning in plan.get("warnings") or ():
            lines.append(f"   !! {warning}")
    tp = report.get("throughput")
    if tp:
        lines.append(
            f"\nthroughput ({tp['unit']}): first {tp['first']:.1f} -> "
            f"last {tp['last']:.1f} (best {tp['best']:.1f}, mean {tp['mean']:.1f})"
        )
    st = report.get("step_time_ms")
    if st:
        lines.append(
            f"step time (ms): mean {st['mean']:.2f}  p50 {st['p50']:.2f}  "
            f"p90 {st['p90']:.2f}  p99(worst window) {st['p99_worst_window']:.2f}"
        )
    mfu = report.get("mfu")
    if mfu:
        lines.append(
            f"MFU: mean {mfu['mean']:.1%}  best {mfu['best']:.1%}  "
            f"last {mfu['last']:.1%}  over {mfu['windows']} clean window(s) "
            "(analytic 6*params*batch FLOPs vs device peak)"
        )
    ts = report["time_split"]
    lines.append("\nwhere the wall time went:")
    lines.append(
        f"  data-wait    {_fmt_frac(ts['data_wait_frac'])}  {ts['data_wait_s']:9.2f}s"
    )
    lines.append(
        f"  step-compute {_fmt_frac(ts['compute_frac'])}  {ts['compute_s']:9.2f}s"
    )
    if ts.get("fetch_wait_s"):
        lines.append(
            f"  fetch-wait   {_fmt_frac(ts.get('fetch_wait_frac'))}  "
            f"{ts['fetch_wait_s']:9.2f}s  (host blocked on device values — "
            "dispatch-ahead backpressure)"
        )
    if ts.get("barrier_wait_s"):
        lines.append(
            f"  barrier-wait {_fmt_frac(ts.get('barrier_wait_frac'))}  "
            f"{ts['barrier_wait_s']:9.2f}s  (blocked at cross-process sync "
            "points — waiting on slower hosts)"
        )
    lines.append(
        f"  eval         {_fmt_frac(ts['eval_frac'])}  {ts['eval_s']:9.2f}s"
    )
    lines.append(
        f"  compile      {_fmt_frac(ts['compile_frac'])}  {ts['compile_s']:9.2f}s"
        "  (overlaps the span it interrupted)"
    )
    cc = report.get("compile_cache")
    if cc:
        ratio = (
            f"{cc['hit_ratio']:.0%}" if cc.get("hit_ratio") is not None
            else "n/a"
        )
        line = (
            f"compile cache: {cc['hits']} hit(s) / {cc['misses']} miss(es) "
            f"— {ratio} served from cache"
        )
        if cc.get("saved_s") is not None:
            line += f", ~{cc['saved_s']:.2f}s compile time saved"
        lines.append(line)
    rc = report["recompiles"]
    if rc["post_warmup_count"]:
        lines.append(
            f"\n!! {rc['post_warmup_count']} POST-WARMUP RECOMPILE(S) "
            f"({rc['post_warmup_s']:.2f}s lost):"
        )
        for e in rc["events"]:
            lines.append(
                f"   - {e['duration_s']:.2f}s during {e['phase'] or 'unattributed'!r}"
            )
    else:
        lines.append("\nrecompiles after warmup: none")
    if rc.get("cache_served_post_warmup"):
        lines.append(
            f"  ({rc['cache_served_post_warmup']} post-warmup compile(s) "
            "served from the persistent cache — loads, not rebuilds)"
        )
    pf = report.get("prefetch")
    if pf:
        if "mean_queue_depth" in pf:
            line = (
                f"input prefetch: mean queue depth {pf['mean_queue_depth']:.1f} "
                f"(min {pf['min_queue_depth']}) over {pf['windows']} window(s)"
            )
            if pf["underrun_windows"]:
                line += (
                    f" — !! {pf['underrun_windows']} window(s) underran (queue "
                    "hit empty; raise --prefetch-depth or speed the loader up)"
                )
            lines.append(line)
        ds = pf.get("data_service")
        if ds:
            line = f"data service: {ds['underruns']} underrun(s)"
            if "mean_ready_depth" in ds:
                line += f", mean ready depth {ds['mean_ready_depth']:.1f}"
            if "mean_worker_util" in ds:
                line += f", worker util {ds['mean_worker_util']:.0%}"
            line += f" over {ds['windows']} window(s)"
            if ds["underruns"]:
                line += (
                    " — !! consumers outran the workers; raise "
                    "--data-workers"
                )
            lines.append(line)
    ev = report["evals"]
    lines.append(
        f"evals: {ev['count']}"
        + (f", last: {ev['last_metrics']}" if ev["last_metrics"] else "")
    )
    lines.append(f"checkpoints: {report['checkpoints']}")
    fleet = report.get("fleet")
    if fleet:
        lines.extend(fleet_lib.render_fleet_section(fleet))
    res = report.get("resilience")
    if res:
        lines.append(
            f"\nresilience: {res['restarts']} restart(s), "
            f"{res['restart_downtime_s']:.2f}s goodput lost to restarts; "
            f"{res['preemptions']} preemption(s), {res['resumes']} resume(s), "
            f"{res['corrupt_checkpoints_skipped']} corrupt checkpoint(s) "
            f"skipped, {res['checkpoint_retries']} checkpoint retry(ies)"
        )
        lr = res.get("last_restart")
        if lr:
            lines.append(
                f"  last restart: attempt {lr['attempt']}, rc={lr['rc']} "
                f"({lr['reason']}) at step {lr['step']}"
            )
        if res.get("aborted"):
            explanation = {
                "crash-loop": "no step progress between restarts",
                "restart-budget": "the restart budget was exhausted",
                "signaled": "the supervisor itself was signaled to stop",
            }.get(res["aborted"], "see the supervisor_abort ledger event")
            lines.append(
                f"  !! supervisor gave this run up: {res['aborted']} — "
                f"{explanation}"
            )
    ela = report.get("elastic")
    if ela:
        state = "LIVE" if ela.get("live") else (
            "ok" if ela.get("ok") else "failed"
        )
        lines.append(
            f"\nelastic: world {ela['hosts']} -> {ela['world_size']} "
            f"[{state}] — {ela['resizes']} resize(s), "
            f"{ela['evictions']} eviction(s), "
            f"{ela['data_redeals']} data re-deal(s), "
            f"{ela['resize_downtime_s']:.2f}s goodput lost to resizes "
            f"(min_hosts {ela['min_hosts']})"
        )
        for rz in ela.get("resize_events", []):
            plan = ""
            if rz.get("plan_old") or rz.get("plan_new"):
                old_l = (rz.get("plan_old") or {}).get("layout") or {}
                new_l = (rz.get("plan_new") or {}).get("layout") or {}
                if old_l or new_l:
                    plan = (
                        f", plan dp{old_l.get('data_parallel', '?')} -> "
                        f"dp{new_l.get('data_parallel', '?')}"
                    )
            evicted = (
                f", evicted host {rz['evicted_process']}"
                if rz.get("evicted_process") is not None else ""
            )
            lines.append(
                f"   - {rz.get('old_world')} -> {rz.get('new_world')} "
                f"({rz.get('reason')}) at step "
                f"{rz.get('progress_step')}, "
                f"{rz.get('downtime_s', 0.0):.2f}s downtime"
                f"{evicted}{plan}"
            )
        if ela.get("aborted"):
            explanation = {
                "min-hosts": "a resize would have crossed --min-hosts",
                "resize-budget": "the resize budget was exhausted",
                "crash-loop": "no step progress between restarts",
                "restart-budget": "the restart budget was exhausted",
                "signaled": "the coordinator itself was signaled to stop",
            }.get(ela["aborted"], "see the elastic_abort ledger event")
            lines.append(
                f"  !! elastic session aborted: {ela['aborted']} — "
                f"{explanation}"
            )
    hl = report.get("health")
    if hl:
        lines.append(
            f"\n!! health: {hl['alerts']} alert(s)"
            + (
                f" — DEGRADED: {', '.join(hl['degraded'])}"
                if hl["degraded"]
                else " (all resolved)"
            )
        )
        for name, m in sorted(hl["monitors"].items()):
            last = m.get("last", {})
            detail = ", ".join(
                f"{k}={last[k]}"
                for k in (
                    "step", "loss", "median", "mean_ms", "baseline_ms",
                    "window_p99_ms", "p99_target_ms", "violation_frac",
                )
                if k in last
            )
            state = "ACTIVE" if m["active"] else "resolved"
            lines.append(
                f"   - {name}: {m['alerts']} alert(s) [{state}]"
                + (f" — last: {detail}" if detail else "")
            )
    tr_s = report.get("traces")
    if tr_s:
        names = ", ".join(
            f"{n}:{c}" for n, c in sorted(tr_s["by_name"].items())
        )
        lines.append(
            f"tracing: {tr_s['spans']} sampled span(s) across "
            f"{tr_s['traces']} trace(s) ({names}) — export with "
            "`telemetry-report --export-trace out.json`"
        )
    mem = report.get("memory")
    if mem:
        parts = []
        if "snapshots" in mem:
            parts.append(f"{mem['snapshots']} snapshot(s)")
        if "device_peak_bytes" in mem:
            parts.append(f"device peak {mem['device_peak_bytes'] / 2**20:.1f} MiB")
        if "host_rss_peak_bytes" in mem:
            parts.append(f"host RSS peak {mem['host_rss_peak_bytes'] / 2**20:.1f} MiB")
        if "opt_state_bytes_per_device" in mem:
            tag = " (ZeRO-1 sharded)" if mem.get("weight_update_sharding") else ""
            parts.append(
                f"opt state {mem['opt_state_bytes_per_device'] / 2**20:.1f} "
                f"MiB/device{tag}"
            )
        if parts:
            lines.append("memory: " + ", ".join(parts))
        wm = mem.get("watermarks")
        if wm:
            line = f"HBM watermarks: peak {wm['peak_bytes'] / 2**20:.1f} MiB"
            if wm.get("bytes_limit"):
                line += (
                    f" of {wm['bytes_limit'] / 2**20:.1f} MiB limit "
                    f"({wm.get('headroom_frac', 0):.1%} headroom)"
                )
            lines.append(line)
            for phase, row in sorted(wm["phases"].items()):
                at = (
                    f" @ step {row['step']}"
                    if row.get("step") is not None
                    else ""
                )
                lines.append(
                    f"  {phase:<8} {row['peak_bytes'] / 2**20:>9.1f} MiB{at}"
                )
            if wm.get("predicted_bytes_per_device") is not None:
                delta = wm.get("measured_minus_predicted_bytes", 0)
                lines.append(
                    f"  measured vs predicted bytes/chip: "
                    f"{wm['predicted_bytes_per_device'] / 2**20:.1f} MiB "
                    f"predicted (params+opt state), "
                    f"{delta / 2**20:+.1f} MiB residual "
                    "(activations/workspace the planner must margin for)"
                )
    cost = report.get("cost")
    if cost:
        ct = cost.get("train")
        if ct:
            line = (
                f"cost (train): {ct['chip_seconds_total']:.1f} chip-seconds "
                f"on {ct.get('n_chips', '?')} chip(s)"
            )
            if ct.get("chip_seconds_per_step") is not None:
                line += f", {ct['chip_seconds_per_step'] * 1000:.2f} chip-ms/step"
            if ct.get("examples_per_chip_second") is not None:
                line += (
                    f", {ct['examples_per_chip_second']:.1f} "
                    "examples/chip-second"
                )
            lines.append(line)
        cs = cost.get("serve")
        if cs:
            line = (
                f"cost (serve): {cs['chip_seconds_total']:.1f} chip-seconds "
                f"on {cs.get('n_chips', '?')} chip(s)"
            )
            if cs.get("rps_per_chip") is not None:
                line += f", {cs['rps_per_chip']:.1f} requests/sec/chip"
            if cs.get("duty_cycle") is not None:
                line += f", duty cycle {cs['duty_cycle']:.1%}"
            lines.append(line)
            pr = cs.get("chip_seconds_per_request")
            if pr:
                lines.append(
                    "  chip-ms/request: "
                    f"mean {pr['mean'] * 1000:.3f}  "
                    f"p50 {pr['p50'] * 1000:.3f}  "
                    f"p90 {pr['p90'] * 1000:.3f}  "
                    f"p99(worst window) {pr['p99_worst_window'] * 1000:.3f}"
                )
    sv = report.get("serve")
    if sv:
        dtype_tag = (
            f" [{sv['serving_dtype']}]" if sv.get("serving_dtype") else ""
        )
        if sv.get("model"):
            ver = sv.get("model_version")
            dtype_tag += f" [{sv['model']}" + (
                f" v{ver}]" if ver is not None else "]"
            )
        lines.append(
            f"\nserving{dtype_tag} ({sv['windows']} window(s)): "
            f"{sv['requests']} requests, {sv['completed']} completed, "
            f"{sv['rejected_queue_full']} rejected (queue full), "
            f"{sv['deadline_exceeded']} deadline-exceeded, "
            f"{sv['errors']} errors"
        )
        if sv.get("batches"):
            lines.append(
                f"  batches: {sv['batches']} "
                f"(mean fill {sv.get('mean_batch_fill', 0):.1f} examples)"
            )
        for name, m in sorted((sv.get("models") or {}).items()):
            p99 = (
                (m.get("latency_ms") or {}).get("request") or {}
            ).get("p99_ms")
            mline = (
                f"  model {name} v{m.get('version', '?')}: "
                f"{m.get('completed', 0)}/{m.get('requests', 0)} ok"
            )
            if p99 is not None:
                mline += f", window p99 {p99:.1f}ms"
            mslo = m.get("slo")
            if mslo:
                mline += (
                    f", SLO {mslo['p99_target_ms']:.0f}ms "
                    + ("met" if mslo.get("healthy", True) else "BREACHED")
                )
            if m.get("serving_dtype"):
                mline += f" [{m['serving_dtype']}]"
            lines.append(mline)
        if sv.get("bucket_hits"):
            hits = "  ".join(
                f"{b}:{n}" for b, n in sorted(
                    sv["bucket_hits"].items(), key=lambda kv: int(kv[0])
                )
            )
            lines.append(f"  bucket hits: {hits}")
        if sv.get("padding_waste"):
            waste = "  ".join(
                f"{b}:{w:.1%}" for b, w in sorted(
                    sv["padding_waste"].items(), key=lambda kv: int(kv[0])
                )
            )
            lines.append(f"  padding waste (slots padded/compiled): {waste}")
        for name, s in (sv.get("latency_ms") or {}).items():
            lines.append(
                f"  {name.replace('_', '-'):<12} (ms): mean {s['mean']:.2f}  "
                f"p50 {s['p50']:.2f}  p90 {s['p90']:.2f}  "
                f"p99(worst window) {s['p99_worst_window']:.2f}"
            )
        slo = sv.get("slo")
        if slo:
            state = "met" if slo.get("healthy", True) else "BREACHED"
            line = (
                f"  SLO: p99 target {slo['p99_target_ms']:.1f}ms, error "
                f"budget {slo['error_budget']:.1%} — {state}"
            )
            if slo.get("window_p99_ms") is not None:
                line += f" (last window p99 {slo['window_p99_ms']:.1f}ms)"
            lines.append(line)
        if sv.get("tee_dropped"):
            lines.append(
                f"  !! capture tee dropped {sv['tee_dropped']} sample(s) "
                "(bounded queue full) — captured data under-represents the "
                "traffic; slow the sample fraction or raise the queue"
            )
        dr = sv.get("drift")
        if dr:
            state = "ok" if dr.get("healthy", True) else "DRIFTED"
            line = (
                f"  drift monitor [{dr.get('output', '?')}]: {state} "
                f"(threshold {dr.get('threshold', 0):.2f}"
            )
            if dr.get("score") is not None:
                line += f", last score {dr['score']:.3f}"
            lines.append(line + ")")
        rc_s = sv.get("recompiles_post_warmup")
        if rc_s:
            lines.append(
                f"  !! {rc_s} POST-WARMUP RECOMPILE(S) on the request path — "
                "a shape escaped the bucket ladder"
            )
        elif rc_s == 0:
            lines.append("  post-warmup recompiles on the request path: none")
    sf = report.get("serve_fleet")
    if sf:
        rt = sf.get("router")
        if rt:
            lines.append(
                f"\nserving fleet router ({rt['windows']} window(s)): "
                f"{rt['requests']} requests, {rt['routed']} forwards "
                f"({rt['retries']} retries), {rt['shed']} shed (429), "
                f"{rt['no_replica']} no-replica (503), "
                f"{rt['replica_failures']} replica failure(s)"
            )
            if rt.get("tee_dropped"):
                lines.append(
                    f"  !! shadow tee dropped {rt['tee_dropped']} "
                    "request(s) (bounded queue full / canary 429) — the "
                    "shadow compare saw less traffic than the fraction "
                    "promised"
                )
            if rt.get("per_replica_routed"):
                routed = "  ".join(
                    f"r{rid}:{n}" for rid, n in sorted(
                        rt["per_replica_routed"].items(),
                        key=lambda kv: int(kv[0]),
                    )
                )
                lines.append(f"  routed per replica: {routed}")
            fl = rt.get("fleet") or {}
            if fl:
                lines.append(
                    f"  fleet state: {fl.get('status', '?')} — "
                    f"{fl.get('live', 0)} live, "
                    f"{fl.get('starting', 0)} starting, "
                    f"{fl.get('draining', 0)} draining, "
                    f"{fl.get('dead', 0)} dead"
                )
            for name, m in sorted((rt.get("models") or {}).items()):
                mline = (
                    f"  model {name}: {m.get('replicas', 0)} replica(s), "
                    f"{m.get('routed', 0)}/{m.get('requests', 0)} routed, "
                    f"{m.get('shed', 0)} shed "
                    f"({m.get('fair_shed', 0)} fair-shed)"
                )
                if m.get("worst_p99_ms") is not None:
                    mline += f", worst p99 {m['worst_p99_ms']:.1f}ms"
                versions = m.get("versions") or {}
                if versions:
                    mline += ", " + "/".join(
                        f"v{v}:{n}" for v, n in sorted(versions.items())
                    )
                    if len(versions) > 1:
                        mline += " (mixed — promotion in flight?)"
                lines.append(mline)
            fs = rt.get("fair_share")
            if fs and fs.get("admitted_shares"):
                weights = fs.get("weights") or {}
                total_w = sum(weights.values()) or 1.0
                bits = [
                    f"{name} {share:.0%}"
                    + (
                        f" (fair {weights[name] / total_w:.0%})"
                        if name in weights
                        else ""
                    )
                    for name, share in sorted(
                        fs["admitted_shares"].items()
                    )
                ]
                tag = " UNDER PRESSURE" if fs.get("pressured") else ""
                lines.append(
                    f"  admitted shares{tag}: " + ", ".join(bits)
                )
            if rt.get("artifacts"):
                mix = "  ".join(
                    f"{key}:{n}" for key, n in sorted(rt["artifacts"].items())
                )
                lines.append(f"  artifacts served: {mix}")
                if rt.get("silent_mixed_fleet"):
                    lines.append(
                        "  !! MIXED FLEET outside an active promotion — "
                        "replicas are answering from different artifacts "
                        "with no controller in charge; promote or drain "
                        "until the fingerprints converge"
                    )
        sc = sf.get("autoscale")
        if sc:
            counts = (
                f"({sc['scale_up']} up / {sc['scale_down']} down"
                + (
                    f" / {sc['budget_deferred']} budget-deferred"
                    if sc.get("budget_deferred")
                    else ""
                )
                + ")"
            )
            lines.append(
                f"  autoscale: {sc['decisions']} decision(s) {counts}, "
                f"final target {sc['final_replicas']} replica(s)"
            )
            for e in sc["events"][-3:]:
                model_tag = (
                    f"[{e['model']}] " if e.get("model") else ""
                )
                lines.append(
                    f"    - {model_tag}{e['action']}: "
                    f"{e['from_replicas']} -> "
                    f"{e['to_replicas']} ({e['reason']}, mean queue "
                    f"{e['mean_queue_depth']})"
                )
        rl = sf.get("replicas")
        if rl:
            line = (
                f"  replica lifecycle: {rl['spawn']} spawn(s), "
                f"{rl['exit']} unplanned exit(s), {rl['restart']} "
                f"restart(s), {rl['drain']} drain(s)"
            )
            if rl.get("abandoned"):
                line += f", !! {rl['abandoned']} ABANDONED"
            lines.append(line)
            ttr = rl.get("time_to_ready_s")
            if ttr:
                lines.append(
                    f"  replica time-to-ready: mean {ttr['mean']:.2f}s  "
                    f"max {ttr['max']:.2f}s  last {ttr['last']:.2f}s "
                    f"over {ttr['count']} readiness event(s)"
                )
    pm = report.get("promotion")
    if pm:
        verdictbits = []
        if pm["completed"]:
            verdictbits.append(f"{pm['completed']} completed")
        if pm["rolled_back"]:
            verdictbits.append(f"{pm['rolled_back']} ROLLED BACK")
        if pm["refused"]:
            verdictbits.append(f"{pm['refused']} refused at admission")
        if pm["aborted"]:
            verdictbits.append(f"{pm['aborted']} ABORTED mid-rollback")
        lines.append(
            f"\ndeployment history: {pm['starts']} promotion(s) — "
            + (", ".join(verdictbits) if verdictbits else "in progress")
            + f"; {pm['shadow_windows']} shadow window(s), "
            f"{pm['shadow_compared']} request(s) shadow-compared"
        )
        for e in pm["history"]:
            kind = e["kind"]
            if kind == "promotion_start":
                what = "refused at admission" if e.get("refused") else "start"
                lines.append(
                    f"  - {what}: {e.get('candidate_dir', '?')}"
                    + (f" [{e['dtype']}]" if e.get("dtype") else "")
                )
            elif kind == "phase_advance":
                detail = ", ".join(
                    f"{k}={e[k]}"
                    for k in ("replica", "replaced", "remaining", "windows",
                              "compared")
                    if e.get(k) is not None
                )
                lines.append(
                    f"  - phase {e.get('phase')}"
                    + (f" ({detail})" if detail else "")
                )
            elif kind == "shadow_window":
                detail = ", ".join(
                    f"{k}={e[k]}"
                    for k in ("compared", "min_iou", "mean_disagree",
                              "max_abs_delta")
                    if e.get(k) is not None
                )
                lines.append(f"  - shadow window ({detail})")
            elif kind == "promotion_rollback":
                lines.append(
                    f"  - !! {e.get('status', 'rollback').upper()} at "
                    f"{e.get('phase', '?')}: {e.get('reason', '?')}"
                    + (
                        f" — {e['abort_reason']}"
                        if e.get("abort_reason")
                        else ""
                    )
                )
            elif kind == "promotion_complete":
                lines.append(
                    f"  - complete: fleet on {e.get('candidate_dir', '?')}"
                    + (
                        f" in {e['duration_s']}s"
                        if e.get("duration_s") is not None
                        else ""
                    )
                )
    lp = report.get("loop")
    if lp:
        lines.append("\ncontinuous learning loop:")
        cap = lp.get("capture")
        if cap:
            line = (
                f"  capture: {cap['captured']} record(s) across "
                f"{cap['shards']} shard(s) from {cap['replicas']} "
                f"replica(s) ({cap['bytes_on_disk'] / 2**20:.1f} MiB on "
                "disk)"
            )
            if cap.get("evicted"):
                line += f", {cap['evicted']} shard(s) quota-evicted"
            lines.append(line)
            if cap.get("dropped"):
                lines.append(
                    f"  !! capture dropped {cap['dropped']} sample(s) — "
                    "bounded-queue loss, counted not silent"
                )
        ing = lp.get("ingest")
        if ing:
            lines.append(
                f"  ingest: {ing['runs']} pass(es) — "
                f"+{ing['records_added']} record(s) in "
                f"{ing['new_shards']} shard(s) "
                f"({ing['deduped']} duplicate, {ing['corrupt']} corrupt "
                f"skipped); dataset v{ing.get('dataset_version')} holds "
                f"{ing.get('records_total')} record(s)"
            )
        dr = lp.get("drift")
        if dr:
            last = dr.get("last") or {}
            line = f"  drift: {dr['alerts']} alert(s)"
            if dr.get("resolved"):
                line += f", {dr['resolved']} resolved"
            if last.get("score") is not None:
                line += (
                    f" — last score {last['score']:.3f} vs threshold "
                    f"{last.get('threshold', 0):.2f}"
                    f" (replica {last.get('replica', '?')})"
                )
            lines.append(line)
        cy = lp.get("cycles")
        if cy:
            lines.append(
                f"  cycles: {cy['triggers']} trigger(s), "
                f"{cy['retrains']} retrain(s) — {cy['promoted']} "
                f"promoted, {cy['rejected']} rejected"
                + (
                    f"; drift->trigger latency "
                    f"{cy['drift_trigger_latency_s']:.1f}s"
                    if cy.get("drift_trigger_latency_s") is not None
                    else ""
                )
            )
            for e in cy["history"]:
                kind = e["kind"]
                if kind == "loop_trigger":
                    detail = ", ".join(
                        f"{k}={e[k]}"
                        for k in ("records_new", "dataset_version",
                                  "drift_score")
                        if e.get(k) is not None
                    )
                    lines.append(
                        f"    - trigger [{e.get('reason', '?')}]"
                        + (f" ({detail})" if detail else "")
                    )
                elif kind == "loop_retrain":
                    lines.append(
                        f"    - retrain rc={e.get('rc')} in "
                        f"{e.get('duration_s', 0)}s"
                        + (
                            f" -> {e['candidate_dir']}"
                            if e.get("candidate_dir")
                            else ""
                        )
                    )
                elif kind == "loop_promoted":
                    lines.append(
                        "    - PROMOTED: fleet flipped to "
                        f"{e.get('candidate_dir', '?')}"
                    )
                elif kind == "loop_rejected":
                    lines.append(
                        "    - rejected"
                        + (f": {e['error']}" if e.get("error") else
                           f" (rc={e.get('rc')})")
                    )
    for qc in report.get("quant_checks", ()):
        verdict = "PASSED" if qc.get("passed") else "FAILED"
        details = []
        for name, rec in (qc.get("outputs") or {}).items():
            if "max_abs_delta" in rec:
                details.append(f"{name} max|Δ| {rec['max_abs_delta']}")
            if "iou" in rec:
                details.append(f"{name} IoU {rec['iou']}")
            if "disagree" in rec:
                details.append(f"{name} disagree {rec['disagree']}")
        line = (
            f"\nquantize-check [{qc.get('dtype')}] {verdict}"
            + (f": {', '.join(details)}" if details else "")
        )
        lines.append(line)
        for failure in qc.get("failures") or ():
            lines.append(f"  !! {failure}")
    prof = report.get("profiling")
    if prof:
        reasons = ", ".join(
            f"{n} {reason}" for reason, n in sorted(prof["by_reason"].items())
        ) or "none"
        line = (
            f"\ncontinuous profiling: {prof['captures']} capture(s) "
            f"({reasons}), {prof.get('rooflines', 0)} roofline(s)"
        )
        if prof.get("skipped_plane_files"):
            line += (
                f" — !! {prof['skipped_plane_files']} truncated plane "
                "file(s) skipped"
            )
        lines.append(line)
        rf = prof.get("last_roofline")
        if rf:
            cls = rf.get("classes") or {}
            detail = (
                f"  last roofline [{rf.get('reason', '?')}]: "
                f"compute {cls.get('compute_frac', 0):.0%} / "
                f"hbm {cls.get('hbm_frac', 0):.0%} / "
                f"collective {cls.get('collective_frac', 0):.0%}"
            )
            if rf.get("mfu") is not None:
                detail += f", mfu {rf['mfu']:.1%}"
            if rf.get("achieved_flops_per_sec_per_chip"):
                detail += (
                    f" ({rf['achieved_flops_per_sec_per_chip'] / 1e12:.2f} "
                    "TFLOP/s/chip achieved)"
                )
            lines.append(detail)
            hbm_op = rf.get("top_hbm_op")
            if hbm_op:
                lines.append(
                    f"  top HBM-bound op: {hbm_op['name']} "
                    f"({hbm_op['total_ms']:.3f} ms, {hbm_op['fraction']:.1%})"
                )
            if rf.get("alert_id"):
                lines.append(
                    f"  postmortem capture triggered by alert {rf['alert_id']}"
                )
    tr = report.get("trace")
    if tr:
        lines.append(f"\ndevice op breakdown ({tr['dir']}):")
        if tr.get("note"):
            lines.append(f"  ({tr['note']})")
        if tr.get("skipped_plane_files"):
            lines.append(
                f"  !! {tr['skipped_plane_files']} truncated/corrupt plane "
                "file(s) skipped"
            )
        for bucket, ms in tr["buckets_ms"].items():
            lines.append(f"  {bucket:<24} {ms:>10.3f} ms")
        lines.append(f"  top {len(tr['top_ops'])} ops:")
        for op in tr["top_ops"]:
            lines.append(
                f"    {op['total_ms']:>10.3f} ms  x{op['occurrences']:<6} "
                f"{op['fraction']:>6.1%}  {op['name']}"
            )
    else:
        lines.append(
            "\nno xplane trace under the workdir (capture one with "
            "utils.profiling.trace / tools/profile_step.py to get the "
            "per-op device breakdown)"
        )
    return "\n".join(lines)


def report_workdir(
    workdir: str,
    *,
    trace_dir: Optional[str] = None,
    top: int = 10,
    as_json: bool = False,
    straggler_threshold: float = fleet_lib.DEFAULT_SKEW_THRESHOLD,
) -> str:
    """The ``telemetry-report`` CLI body: build + render (or JSON-dump)."""
    import json

    if not os.path.exists(workdir):
        raise FileNotFoundError(f"workdir {workdir} does not exist")
    report = build_report(
        workdir,
        trace_dir=trace_dir,
        top=top,
        straggler_threshold=straggler_threshold,
    )
    if as_json:
        return json.dumps(report)
    return render_report(report)
