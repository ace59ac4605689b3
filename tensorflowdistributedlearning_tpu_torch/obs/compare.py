"""Cross-run registry and run-vs-run deltas (counterpart of the JAX
package's ``obs/compare.py``).

- **Registry**: ``runs.jsonl`` under a registry directory, one summary row
  per run (:func:`run_summary`: config hash, mesh, process count, final eval
  metrics, goodput split, step-time percentiles, serving totals), appended
  by ``telemetry-report WORKDIR --registry-dir D --register``. Rows are
  self-contained, so a comparison outlives the workdir.
- **Compare**: :func:`compare_rows` gives structured deltas with
  noise-aware thresholds: each metric has a direction and a relative (or,
  for fractions, absolute) threshold below which the delta is ``neutral``;
  past it ``regressed`` or ``improved``.

The rows, hashes and deltas are JAX's on the same ledgers
(``tests/test_torch_telemetry_report.py``).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

from tensorflowdistributedlearning_tpu_torch.obs import report as report_lib

REGISTRY_FILENAME = "runs.jsonl"


def _normalized_layout(header: Dict) -> Optional[Dict]:
    """The run's parallelism layout, independent of whether the best-effort
    plan resolved: the plan's layout verbatim when present, else the same
    six fields reconstructed from the train config + mesh (the trainers
    ledger the POST-override config, so the two forms always agree)."""
    plan_layout = (header.get("plan") or {}).get("layout")
    if plan_layout is not None:
        return plan_layout
    tcfg = header.get("train_config") or {}
    mesh = header.get("mesh") or {}
    if not tcfg and not mesh:
        return None
    return {
        "data_parallel": mesh.get("batch"),
        "model_parallel": tcfg.get("model_parallel", 1),
        "pipeline_parallel": tcfg.get("pipeline_parallel", 1),
        "sequence_parallel": tcfg.get("sequence_parallel", 1),
        "expert_parallel": tcfg.get("expert_parallel", 1),
        "weight_update_sharding": tcfg.get("weight_update_sharding", False),
    }


def config_hash(header: Dict) -> Optional[str]:
    """Short stable hash over the run's model+train config (the run header
    carries both as dicts) — two runs compare apples-to-apples iff it
    matches. None when the header has no config (foreign/serve ledgers).

    The parallelism plan's LAYOUT is part of the identity: two runs of the
    same config whose planner chose different layouts (``--parallelism
    auto`` at different world sizes or budgets) are different executions —
    their perf deltas are expected, and must never read as config_match.
    The plan itself is attached best-effort, so when the header carries no
    ``plan`` the layout is reconstructed from the (always-present) train
    config degrees + mesh — a run with a plan and an identical run without
    one hash the same."""
    cfg = {
        k: header.get(k)
        for k in ("model_config", "train_config", "mesh")
        if header.get(k) is not None
    }
    layout = _normalized_layout(header)
    if layout is not None:
        cfg["plan_layout"] = layout
    if not cfg:
        return None
    blob = json.dumps(cfg, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def run_summary(workdir: str) -> Dict:
    """One registry row for the workdir's last run, built from the full
    report (fleet merge included)."""
    report = report_lib.build_report(workdir)
    header = report.get("header") or {}
    run = report["run"]
    # the run's own start clock, NOT registration time: re-registering the
    # same workdir reproduces the same run_id (resolve_run's duplicate-id
    # contract), and old runs keep their real date
    t = run.get("started_t") or time.time()
    row: Dict = {
        "run_id": (
            time.strftime("%Y%m%d-%H%M%S", time.localtime(t))
            + "-"
            + (os.path.basename(os.path.normpath(workdir)) or "run")
        ),
        "t": round(float(t), 3),
        "workdir": os.path.abspath(workdir),
        "kind": header.get("kind") or header.get("task") or "unknown",
        "config_hash": config_hash(header),
        "mesh": header.get("mesh"),
        "process_count": header.get("process_count")
        or (header.get("fingerprint") or {}).get("process_count", 1),
        "steps": run.get("last_step"),
        "wall_s": run.get("wall_s"),
        "completed": run.get("completed"),
        "goodput": report.get("time_split"),
        "recompiles_post_warmup": report["recompiles"]["post_warmup_count"],
        "ledger_parse_errors": header.get("ledger_parse_errors", 0),
    }
    plan = header.get("plan") or {}
    if plan.get("layout"):
        # the layout rides the row so a registry diff names WHICH mesh each
        # run trained under, not just that the hashes differ
        row["plan"] = {
            "source": plan.get("source"),
            "layout": plan["layout"],
            "predicted_total_bytes_per_chip": (
                plan.get("predicted") or {}
            ).get("total_bytes_per_chip"),
        }
    st = report.get("step_time_ms")
    if st:
        row["step_time_ms"] = st
    tp = report.get("throughput")
    if tp:
        row["throughput_mean"] = tp["mean"]
    mfu = report.get("mfu")
    if mfu:
        row["mfu_mean"] = mfu["mean"]
    metrics = report["evals"].get("last_metrics")
    if metrics:
        row["eval_metrics"] = metrics
    sv = report.get("serve")
    if sv:
        serve_row: Dict = {
            "requests": sv.get("requests"),
            "completed": sv.get("completed"),
        }
        req = (sv.get("latency_ms") or {}).get("request")
        if req:
            serve_row["request_p99_ms"] = req["p99_worst_window"]
        row["serve"] = serve_row
    fleet = report.get("fleet")
    if fleet and fleet.get("straggler"):
        row["straggler_max_skew"] = fleet["straggler"]["max_skew"]
    # capacity/cost (obs/capacity.py): the chip-seconds and watermark
    # numbers run-vs-run compares track as first-class perf trajectories
    cost = report.get("cost") or {}
    cost_row: Dict = {}
    train_cost = cost.get("train")
    if train_cost:
        if train_cost.get("chip_seconds_per_step") is not None:
            cost_row["chip_seconds_per_step"] = train_cost[
                "chip_seconds_per_step"
            ]
        if train_cost.get("examples_per_chip_second") is not None:
            cost_row["examples_per_chip_second"] = train_cost[
                "examples_per_chip_second"
            ]
    serve_cost = cost.get("serve")
    if serve_cost:
        if serve_cost.get("rps_per_chip") is not None:
            cost_row["rps_per_chip"] = serve_cost["rps_per_chip"]
        per_req = serve_cost.get("chip_seconds_per_request") or {}
        if per_req.get("p99_worst_window") is not None:
            cost_row["chip_seconds_per_request_p99"] = per_req[
                "p99_worst_window"
            ]
    if cost_row:
        row["cost"] = cost_row
    watermarks = (report.get("memory") or {}).get("watermarks") or {}
    if watermarks.get("peak_bytes"):
        mem_row: Dict = {"peak_bytes": watermarks["peak_bytes"]}
        if watermarks.get("headroom_frac") is not None:
            mem_row["headroom_frac"] = watermarks["headroom_frac"]
        row["memory"] = mem_row
    return row


# -- registry ----------------------------------------------------------------


def register_run(registry_dir: str, workdir: str) -> Dict:
    """Append the workdir's summary row to ``{registry_dir}/runs.jsonl``
    (created on first use) and return it."""
    row = run_summary(workdir)
    os.makedirs(registry_dir, exist_ok=True)
    path = os.path.join(registry_dir, REGISTRY_FILENAME)
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(row, default=str) + "\n")
    return row


def load_registry(registry_dir: str) -> List[Dict]:
    """Every registered row, file order (= registration order). Missing
    registry reads as empty — a first ``--register`` starts the history."""
    path = os.path.join(registry_dir, REGISTRY_FILENAME)
    if not os.path.isfile(path):
        return []
    rows: List[Dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail — same stance as the run ledger
    return rows


def resolve_run(ref: str, registry_dir: Optional[str] = None) -> Dict:
    """A compare operand: a workdir path (summarized fresh) or — with a
    registry — a registered ``run_id`` (most recent row wins on duplicate
    ids, e.g. the same workdir registered twice)."""
    if os.path.isdir(ref):
        return run_summary(ref)
    if registry_dir:
        rows = [r for r in load_registry(registry_dir) if r.get("run_id") == ref]
        if rows:
            return rows[-1]
    raise FileNotFoundError(
        f"run {ref!r} is neither a workdir nor a registered run id"
        + (f" in {registry_dir}" if registry_dir else " (no --registry-dir)")
    )


# -- deltas ------------------------------------------------------------------

# serving p99 noise band (rel): shared with the promotion controller's
# canary-latency gate so "regressed" means the same thing in a run compare
# and in a rollout decision
SERVE_P99_BAND = 0.15

# (metric label, extractor, direction, threshold, threshold kind)
# - "rel": |b-a|/|a| must exceed it to leave neutral
# - "abs": |b-a| must exceed it (fractions and accuracy-like metrics, where
#   a relative threshold on a near-zero baseline is meaningless)
_METRICS = (
    ("step_time_mean_ms", lambda r: (r.get("step_time_ms") or {}).get("mean"),
     "lower", 0.10, "rel"),
    ("step_time_p99_ms",
     lambda r: (r.get("step_time_ms") or {}).get("p99_worst_window"),
     "lower", 0.25, "rel"),
    ("data_wait_frac", lambda r: (r.get("goodput") or {}).get("data_wait_frac"),
     "lower", 0.05, "abs"),
    ("fetch_wait_frac",
     lambda r: (r.get("goodput") or {}).get("fetch_wait_frac"),
     "lower", 0.05, "abs"),
    ("throughput_mean", lambda r: r.get("throughput_mean"),
     "higher", 0.10, "rel"),
    # MFU derives from the same step-time samples as throughput (the FLOP
    # numerator is deterministic for a fixed config) → same 10% noise band
    ("mfu_mean", lambda r: r.get("mfu_mean"), "higher", 0.10, "rel"),
    ("wall_s", lambda r: r.get("wall_s"), "lower", 0.25, "rel"),
    ("recompiles_post_warmup", lambda r: r.get("recompiles_post_warmup"),
     "lower", 0.0, "abs"),
    ("serve_request_p99_ms",
     lambda r: (r.get("serve") or {}).get("request_p99_ms"),
     "lower", SERVE_P99_BAND, "rel"),
    # capacity/cost trajectories (obs/capacity.py): chip-seconds numbers
    # derive from span wall time (same jitter as step time → same 10% band);
    # the per-request p99 inherits the tail-noise band; device peak bytes is
    # near-deterministic for a fixed config, so a 5% move is a real change
    ("chip_seconds_per_step",
     lambda r: (r.get("cost") or {}).get("chip_seconds_per_step"),
     "lower", 0.10, "rel"),
    ("rps_per_chip",
     lambda r: (r.get("cost") or {}).get("rps_per_chip"),
     "higher", 0.10, "rel"),
    ("chip_seconds_per_request_p99",
     lambda r: (r.get("cost") or {}).get("chip_seconds_per_request_p99"),
     "lower", 0.25, "rel"),
    ("hbm_peak_bytes",
     lambda r: (r.get("memory") or {}).get("peak_bytes"),
     "lower", 0.05, "rel"),
)


def _eval_metric_spec(name: str):
    """Direction + threshold for a task eval metric by naming convention:
    loss-like metrics regress UP (rel 5%), accuracy-like metrics (top1, iou,
    ...) regress DOWN (abs 0.005 — half a point)."""
    if "loss" in name:
        return "lower", 0.05, "rel"
    return "higher", 0.005, "abs"


def verdict(a, b, direction: str, threshold: float, kind: str) -> str:
    """Noise-banded A→B verdict: ``neutral`` inside the band, else
    ``regressed``/``improved`` by ``direction``. Public: the promotion
    controller (serve/promote.py) gates canary latency deltas through the
    same bands the run-vs-run compare uses."""
    delta = b - a
    magnitude = abs(delta) if kind == "abs" else (
        abs(delta) / abs(a) if a else float("inf") if delta else 0.0
    )
    if magnitude <= threshold:
        return "neutral"
    worse = delta > 0 if direction == "lower" else delta < 0
    return "regressed" if worse else "improved"


_verdict = verdict  # original private name, kept for callers/tests


def compare_rows(row_a: Dict, row_b: Dict) -> Dict:
    """Structured A→B deltas over every metric both rows carry."""
    deltas: List[Dict] = []

    def add(metric, a, b, direction, threshold, kind):
        if a is None or b is None:
            return
        a, b = float(a), float(b)
        entry = {
            "metric": metric,
            "a": round(a, 4),
            "b": round(b, 4),
            "delta": round(b - a, 4),
            "ratio": round(b / a, 4) if a else None,
            "direction": direction,
            "threshold": threshold,
            "threshold_kind": kind,
            "verdict": _verdict(a, b, direction, threshold, kind),
        }
        deltas.append(entry)

    for metric, extract, direction, threshold, kind in _METRICS:
        add(metric, extract(row_a), extract(row_b), direction, threshold, kind)
    metrics_a = row_a.get("eval_metrics") or {}
    metrics_b = row_b.get("eval_metrics") or {}
    for name in sorted(set(metrics_a) & set(metrics_b)):
        direction, threshold, kind = _eval_metric_spec(name)
        add(f"eval:{name}", metrics_a[name], metrics_b[name],
            direction, threshold, kind)
    return {
        "a": {k: row_a.get(k) for k in ("run_id", "workdir", "kind", "steps")},
        "b": {k: row_b.get(k) for k in ("run_id", "workdir", "kind", "steps")},
        # apples-to-apples flag: perf deltas between different configs/meshes
        # are expected, not regressions
        "config_match": (
            row_a.get("config_hash") is not None
            and row_a.get("config_hash") == row_b.get("config_hash")
        ),
        "deltas": deltas,
        "regressions": sum(
            1 for d in deltas if d["verdict"] == "regressed"
        ),
        "improvements": sum(
            1 for d in deltas if d["verdict"] == "improved"
        ),
    }


def compare_workdirs(
    ref_a: str, ref_b: str, *, registry_dir: Optional[str] = None
) -> Dict:
    """``telemetry-report --compare A B``: each ref a workdir or (with a
    registry) a registered run id."""
    return compare_rows(
        resolve_run(ref_a, registry_dir), resolve_run(ref_b, registry_dir)
    )


def render_compare(result: Dict) -> str:
    """Human-readable rendering of :func:`compare_rows`."""
    a, b = result["a"], result["b"]
    lines = [
        f"== run compare: {a.get('run_id') or a.get('workdir')} -> "
        f"{b.get('run_id') or b.get('workdir')}",
        "   configs "
        + ("match" if result["config_match"]
           else "DIFFER (deltas are cross-config)"),
    ]
    marks = {"regressed": "!!", "improved": "++", "neutral": "  "}
    for d in result["deltas"]:
        arrow = "<=" if d["direction"] == "lower" else ">="
        ratio = f" ({d['ratio']:.3f}x)" if d["ratio"] is not None else ""
        noise = (
            f"{d['threshold']:.0%}"
            if d["threshold_kind"] == "rel"
            else f"{d['threshold']:g}"
        )
        lines.append(
            f" {marks[d['verdict']]} {d['metric']:<24} "
            f"{d['a']:>10.3f} -> {d['b']:>10.3f}{ratio}  "
            f"[{d['verdict']}; good is {arrow}, noise band {noise}]"
        )
    lines.append(
        f"   {result['regressions']} regression(s), "
        f"{result['improvements']} improvement(s), "
        f"{len(result['deltas']) - result['regressions'] - result['improvements']} neutral"
    )
    return "\n".join(lines)
