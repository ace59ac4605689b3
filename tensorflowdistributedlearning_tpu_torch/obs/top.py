"""``telemetry-top``: the live console over a workdir's merged run ledgers
(counterpart of the JAX package's ``obs/top.py``).

It tails the per-process ledgers the report merges (``obs/fleet.py``) and
renders one compact frame:

    python -m tensorflowdistributedlearning_tpu_torch telemetry-top WORKDIR
    python -m tensorflowdistributedlearning_tpu_torch telemetry-top WORKDIR --once

Per process: goodput split and step time (training), requests, backlog and
p99 (serving), device-memory headroom and cost rates (``obs/capacity.py``
events), health and straggler flags. ``--once`` prints one frame and exits
0. An empty workdir renders "no ledgers yet". Each rebuild re-parses the
ledgers; the refresh loop stats the files first and reuses the previous
frame when nothing changed. Frames are JAX's on the same ledgers
(``tests/test_torch_telemetry_report.py``).
"""

from __future__ import annotations

import glob
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from tensorflowdistributedlearning_tpu_torch.obs import capacity as capacity_lib
from tensorflowdistributedlearning_tpu_torch.obs import fleet as fleet_lib
from tensorflowdistributedlearning_tpu_torch.obs.profiler import OP_ROOFLINE_EVENT

# ANSI: clear screen + home; plain strings so tests can strip them trivially
_CLEAR = "\x1b[2J\x1b[H"


def _last(events: List[Dict], kind: str) -> Optional[Dict]:
    for e in reversed(events):
        if e.get("event") == kind:
            return e
    return None


def _fmt_bytes(n: float) -> str:
    if n >= 2**30:
        return f"{n / 2**30:.2f}GiB"
    return f"{n / 2**20:.1f}MiB"


def _fmt_age(seconds: float) -> str:
    if seconds < 120:
        return f"{seconds:.0f}s"
    if seconds < 7200:
        return f"{seconds / 60:.0f}m"
    return f"{seconds / 3600:.1f}h"


def _process_status(led: fleet_lib.ProcessLedger, now: float) -> Dict:
    """One frame row from one process ledger's last run."""
    events = led.events
    header = led.header
    row: Dict = {
        "process_index": led.process_index,
        "kind": header.get("kind") or header.get("task") or "unknown",
        "parse_errors": led.parse_errors,
    }
    if events:
        row["last_event_age_s"] = max(0.0, now - events[-1].get("t", now))
    run_end = _last(events, "run_end")
    row["live"] = run_end is None
    window = _last(events, "step_window")
    if window is not None:
        row["step"] = window.get("step")
        st = window.get("step_time_ms") or {}
        if st.get("mean_ms") is not None:
            row["step_time_mean_ms"] = st["mean_ms"]
        busy = sum(
            window.get(k, 0.0)
            for k in (
                "data_wait_s",
                "compute_s",
                "fetch_wait_s",
                "barrier_wait_s",
            )
        )
        if busy:
            row["goodput"] = {
                "compute_frac": round(window.get("compute_s", 0.0) / busy, 3),
                "data_wait_frac": round(
                    window.get("data_wait_s", 0.0) / busy, 3
                ),
            }
        if window.get("images_per_sec") is not None:
            row["images_per_sec"] = window["images_per_sec"]
        if window.get("mfu") is not None:
            row["mfu"] = window["mfu"]
        if window.get("recompiles_post_warmup"):
            row["recompiles_post_warmup"] = window["recompiles_post_warmup"]
        svc = window.get("data_service")
        if svc is not None:
            # the input service's live backpressure (data/service.py):
            # reorder-buffer depth, consumer-starved takes, worker busy
            # fraction — "is the input side keeping up", right now
            srow: Dict = {"underruns": int(svc.get("underruns", 0))}
            ready = svc.get("ready_depth") or {}
            if ready.get("mean") is not None:
                srow["ready_depth_mean"] = ready["mean"]
            if ready.get("min") is not None:
                srow["ready_depth_min"] = ready["min"]
            if svc.get("worker_util") is not None:
                srow["worker_util"] = svc["worker_util"]
            row["data_service"] = srow
    serve = _last(events, "serve_window")
    if serve is not None:
        srow: Dict = {
            "requests": serve.get("requests", 0),
            "completed": serve.get("completed", 0),
            "backlog": serve.get("queue_depth", 0),
        }
        if serve.get("replica") is not None:
            srow["replica"] = serve["replica"]
        if serve.get("model"):
            srow["model"] = serve["model"]
        elif serve.get("models"):
            # multi-tenant replica: name the mounted tenants compactly
            srow["models"] = sorted(serve["models"])
        req = (serve.get("latency_ms") or {}).get("request") or {}
        if req.get("p99_ms") is not None:
            srow["p99_ms"] = req["p99_ms"]
        slo = serve.get("slo")
        if slo is not None:
            srow["slo_healthy"] = bool(slo.get("healthy", True))
        if serve.get("tee_dropped"):
            srow["tee_dropped"] = serve["tee_dropped"]
        drift = serve.get("drift")
        if drift is not None:
            srow["drift_healthy"] = bool(drift.get("healthy", True))
        row["serve"] = srow
    cap = _last(events, "capture_window")
    if cap is not None:
        # the loop's raw-material gauge: live capture volume and loss
        row["capture"] = {
            "captured": cap.get("total_captured", 0),
            "dropped": cap.get("total_dropped", 0),
            "shards": cap.get("shards", 0),
            "bytes_on_disk": cap.get("bytes_on_disk", 0),
        }
    loop_retrain = _last(events, "loop_retrain")
    loop_trigger = _last(events, "loop_trigger")
    if loop_trigger is not None or loop_retrain is not None:
        lrow: Dict = {}
        if loop_trigger is not None:
            lrow["last_trigger"] = loop_trigger.get("reason")
        if loop_retrain is not None:
            lrow["last_retrain_rc"] = loop_retrain.get("rc")
            promoted = _last(events, "loop_promoted")
            rejected = _last(events, "loop_rejected")
            if promoted is not None or rejected is not None:
                p_t = (promoted or {}).get("t", -1.0)
                r_t = (rejected or {}).get("t", -1.0)
                lrow["last_verdict"] = (
                    "promoted" if p_t >= r_t else "rejected"
                )
        row["loop"] = lrow
    ready = _last(events, "replica_ready")
    if ready is not None and ready.get("time_to_ready_s") is not None:
        # the controller's newest replica cold-start: spawn -> readiness line
        row["last_replica_ready"] = {
            "replica": ready.get("replica"),
            "time_to_ready_s": ready["time_to_ready_s"],
        }
    router = _last(events, "router_window")
    if router is not None:
        fleet_state = router.get("fleet") or {}
        row["router"] = {
            "requests": router.get("requests", 0),
            "shed": router.get("shed", 0),
            "backlog": fleet_state.get("queue_depth_total", 0),
            "live": fleet_state.get("live", 0),
            "status": fleet_state.get("status", "?"),
        }
        models = fleet_state.get("models") or {}
        if models:
            row["router"]["models"] = {
                name: {
                    "replicas": m.get("replicas", 0),
                    "shed": m.get("shed", 0),
                    **(
                        {"worst_p99_ms": m["worst_p99_ms"]}
                        if m.get("worst_p99_ms") is not None
                        else {}
                    ),
                }
                for name, m in models.items()
            }
        artifacts = fleet_state.get("artifacts") or {}
        if artifacts:
            from tensorflowdistributedlearning_tpu_torch.obs import (
                report as report_lib,
            )

            row["router"]["artifacts"] = artifacts
            # one definition of "silently mixed" for report AND top
            row["router"]["mixed"] = report_lib.silent_mixed_fleet(
                fleet_state
            )
    marks = capacity_lib.aggregate_watermark_events(events)
    if marks:
        mem: Dict = {"peak_bytes": marks["peak_bytes"]}
        if marks.get("headroom_frac") is not None:
            mem["headroom_frac"] = marks["headroom_frac"]
        row["memory"] = mem
    cost = capacity_lib.aggregate_cost_events(events)
    if cost:
        crow: Dict = {}
        train = cost.get("train") or {}
        if train.get("chip_seconds_per_step") is not None:
            crow["chip_seconds_per_step"] = train["chip_seconds_per_step"]
        if train.get("examples_per_chip_second") is not None:
            crow["examples_per_chip_second"] = train[
                "examples_per_chip_second"
            ]
        serve_cost = cost.get("serve") or {}
        if serve_cost.get("rps_per_chip") is not None:
            crow["rps_per_chip"] = serve_cost["rps_per_chip"]
        if serve_cost.get("chip_seconds_total") is not None:
            crow["chip_seconds_total"] = serve_cost["chip_seconds_total"]
        elif train.get("chip_seconds_total") is not None:
            crow["chip_seconds_total"] = train["chip_seconds_total"]
        if crow:
            row["cost"] = crow
    # last ledgered roofline (obs/profiler.py): the live "where do the FLOPs
    # go" row — roofline class split, top HBM-bound op, collective share.
    # Workdirs without captures simply have no "roofline" key (rendered "-").
    roofline = _last(events, OP_ROOFLINE_EVENT)
    if roofline is not None:
        cls = roofline.get("classes") or {}
        rrow: Dict = {
            "reason": roofline.get("reason"),
            "compute_frac": cls.get("compute_frac"),
            "hbm_frac": cls.get("hbm_frac"),
            "collective_frac": cls.get("collective_frac"),
        }
        if roofline.get("mfu") is not None:
            rrow["mfu"] = roofline["mfu"]
        hbm_op = roofline.get("top_hbm_op")
        if hbm_op:
            rrow["top_hbm_op"] = hbm_op.get("name")
        row["roofline"] = rrow
    alerts = [e for e in events if e.get("event") == "health_alert"]
    if alerts:
        active: Dict[str, bool] = {}
        for a in alerts:
            active[a.get("monitor", "unknown")] = not a.get("resolved")
        degraded = sorted(m for m, live in active.items() if live)
        row["health"] = {"alerts": len(alerts), "degraded": degraded}
    return row


def build_frame(workdir: str, *, now: Optional[float] = None) -> Dict:
    """One console frame as data (the ``--once``/test contract; rendering is
    presentation only). Never raises on empty/foreign workdirs — a frame with
    ``processes == 0`` means nothing is writing ledgers yet."""
    now = now if now is not None else time.time()
    try:
        ledgers = fleet_lib.discover_ledgers(workdir)
    except OSError:
        ledgers = []
    frame: Dict = {
        "workdir": workdir,
        "t": now,
        "processes": len(ledgers),
        "rows": [_process_status(led, now) for led in ledgers],
    }
    if len(ledgers) >= 2:
        straggler = fleet_lib.straggler_section(ledgers)
        if straggler:
            frame["straggler"] = {
                "max_skew": straggler["max_skew"],
                "alert_count": straggler["alert_count"],
                "worst_process": straggler["worst_process"],
            }
    if ledgers:
        # elastic session status (parallel/elastic.py): the coordinator
        # appends to the canonical (process-0) ledger, so its whole history
        # carries the elastic_start/world_resize/elastic_end brackets
        from tensorflowdistributedlearning_tpu_torch.obs import report as report_lib

        elastic = report_lib._elastic_section(ledgers[0].all_events)
        if elastic:
            frame["elastic"] = {
                k: elastic.get(k)
                for k in (
                    "hosts", "min_hosts", "world_size", "live", "resizes",
                    "evictions", "resize_downtime_s", "aborted",
                )
            }
    return frame


def render_frame(frame: Dict) -> str:
    lines: List[str] = [
        f"telemetry-top — {frame['workdir']} — "
        f"{time.strftime('%H:%M:%S', time.localtime(frame['t']))}"
    ]
    if not frame["processes"]:
        lines.append(
            "  no ledgers yet (telemetry.jsonl / telemetry-N.jsonl absent) — "
            "is the run pointed at this workdir?"
        )
        return "\n".join(lines)
    ela = frame.get("elastic")
    if ela:
        state = "LIVE" if ela.get("live") else "ended"
        line = (
            f"elastic: world {ela['world_size']}/{ela['hosts']} [{state}] — "
            f"{ela['resizes']} resize(s), {ela['evictions']} eviction(s), "
            f"{(ela.get('resize_downtime_s') or 0.0):.1f}s resize downtime"
        )
        if ela.get("aborted"):
            line += f"  !! ABORTED ({ela['aborted']})"
        lines.append(line)
    for row in frame["rows"]:
        state = "live" if row.get("live") else "ended"
        age = row.get("last_event_age_s")
        if age is not None:
            state += f", last event {_fmt_age(age)} ago"
        lines.append(f"p{row['process_index']} [{row['kind']}] ({state})")
        if "step" in row:
            bits = [f"  step {row['step']}"]
            if row.get("step_time_mean_ms") is not None:
                bits.append(f"{row['step_time_mean_ms']:.1f}ms/step")
            gp = row.get("goodput")
            if gp:
                bits.append(
                    f"compute {gp['compute_frac']:.0%} / "
                    f"data-wait {gp['data_wait_frac']:.0%}"
                )
            if row.get("images_per_sec") is not None:
                bits.append(f"{row['images_per_sec']:.1f} img/s")
            lines.append("  ".join(bits))
        if "step" in row or row.get("roofline"):
            # the live MFU/roofline row: "-" where no pricing/capture exists
            # (CPU backend without flop counters, workdir with no captures)
            rf = row.get("roofline") or {}
            mfu = row.get("mfu", rf.get("mfu"))
            bits = [
                "  mfu "
                + (f"{mfu:.1%}" if mfu is not None else "-")
            ]
            if rf.get("compute_frac") is not None:
                bits.append(
                    f"roofline compute {rf['compute_frac']:.0%} / "
                    f"hbm {rf['hbm_frac']:.0%} / "
                    f"coll {rf['collective_frac']:.0%}"
                )
            else:
                bits.append("roofline -")
            bits.append(
                f"top-hbm {rf['top_hbm_op']}"
                if rf.get("top_hbm_op")
                else "top-hbm -"
            )
            lines.append("  ".join(bits))
        ds = row.get("data_service")
        if ds:
            bits = ["  data-svc:"]
            if ds.get("ready_depth_mean") is not None:
                bits.append(f"ready {ds['ready_depth_mean']:.1f}")
            if ds.get("worker_util") is not None:
                bits.append(f"workers {ds['worker_util']:.0%} busy")
            bits.append(f"{ds['underruns']} underrun(s)")
            if ds["underruns"]:
                bits.append("!! STARVED")
            lines.append("  ".join(bits))
        sv = row.get("serve")
        if sv:
            model_tag = ""
            if sv.get("model"):
                model_tag = f" [{sv['model']}]"
            elif sv.get("models"):
                model_tag = f" [{'+'.join(sv['models'])}]"
            bits = [
                f"  serve"
                + (f" r{sv['replica']}" if "replica" in sv else "")
                + model_tag
                + f": {sv['completed']}/{sv['requests']} ok",
                f"backlog {sv['backlog']}",
            ]
            if sv.get("p99_ms") is not None:
                bits.append(f"p99 {sv['p99_ms']:.1f}ms")
            if sv.get("slo_healthy") is False:
                bits.append("!! SLO BREACHED")
            if sv.get("tee_dropped"):
                bits.append(f"!! tee dropped {sv['tee_dropped']}")
            if sv.get("drift_healthy") is False:
                bits.append("!! DRIFTED")
            lines.append("  ".join(bits))
        cap = row.get("capture")
        if cap:
            line = (
                f"  capture: {cap['captured']} rec in {cap['shards']} "
                f"shard(s) ({_fmt_bytes(cap['bytes_on_disk'])})"
            )
            if cap.get("dropped"):
                line += f"  !! {cap['dropped']} dropped"
            lines.append(line)
        lp = row.get("loop")
        if lp:
            line = "  loop:"
            if lp.get("last_trigger"):
                line += f" trigger {lp['last_trigger']}"
            if lp.get("last_verdict"):
                line += f", last cycle {lp['last_verdict'].upper()}"
            elif lp.get("last_retrain_rc") is not None:
                line += f", retrain rc={lp['last_retrain_rc']}"
            lines.append(line)
        rt = row.get("router")
        if rt:
            line = (
                f"  router: {rt['requests']} req, {rt['shed']} shed, "
                f"backlog {rt['backlog']}, {rt['live']} live "
                f"[{rt['status']}]"
            )
            if rt.get("mixed"):
                line += "  !! MIXED ARTIFACTS (no promotion active)"
            rr = row.get("last_replica_ready")
            if rr:
                line += (
                    f", last ready r{rr.get('replica', '?')} in "
                    f"{rr['time_to_ready_s']:.1f}s"
                )
            lines.append(line)
            for name, m in sorted((rt.get("models") or {}).items()):
                mline = (
                    f"    {name}: {m['replicas']} replica(s), "
                    f"{m['shed']} shed"
                )
                if m.get("worst_p99_ms") is not None:
                    mline += f", p99 {m['worst_p99_ms']:.1f}ms"
                lines.append(mline)
        mem = row.get("memory")
        if mem:
            line = f"  hbm peak {_fmt_bytes(mem['peak_bytes'])}"
            if mem.get("headroom_frac") is not None:
                line += f", headroom {mem['headroom_frac']:.1%}"
                if mem["headroom_frac"] < 0.1:
                    line += "  !! LOW"
            lines.append(line)
        cost = row.get("cost")
        if cost:
            bits = ["  cost:"]
            if cost.get("chip_seconds_per_step") is not None:
                bits.append(
                    f"{cost['chip_seconds_per_step'] * 1000:.2f} chip-ms/step"
                )
            if cost.get("examples_per_chip_second") is not None:
                bits.append(
                    f"{cost['examples_per_chip_second']:.1f} ex/chip-s"
                )
            if cost.get("rps_per_chip") is not None:
                bits.append(f"{cost['rps_per_chip']:.1f} rps/chip")
            if cost.get("chip_seconds_total") is not None:
                bits.append(
                    f"{cost['chip_seconds_total']:.1f} chip-s total"
                )
            lines.append("  ".join(bits))
        hl = row.get("health")
        if hl:
            if hl["degraded"]:
                lines.append(
                    f"  !! health degraded: {', '.join(hl['degraded'])} "
                    f"({hl['alerts']} alert(s))"
                )
            else:
                lines.append(
                    f"  health: {hl['alerts']} alert(s), all resolved"
                )
        if row.get("recompiles_post_warmup"):
            lines.append(
                f"  !! {row['recompiles_post_warmup']} post-warmup "
                "recompile(s)"
            )
        if row.get("parse_errors"):
            lines.append(
                f"  !! {row['parse_errors']} unparseable ledger line(s)"
            )
    st = frame.get("straggler")
    if st:
        flag = (
            f" — !! {st['alert_count']} alert(s), worst p{st['worst_process']}"
            if st["alert_count"]
            else ""
        )
        lines.append(f"straggler skew: {st['max_skew']:.2f}x{flag}")
    return "\n".join(lines)


def _ledger_signature(workdir: str) -> Tuple:
    """(path, size, mtime) of every ledger file — the cheap change detector
    the refresh loop uses to skip full re-parses of an unchanged fleet."""
    sig = []
    for path in sorted(glob.glob(os.path.join(workdir, "telemetry*.jsonl"))):
        try:
            st = os.stat(path)
            sig.append((path, st.st_size, st.st_mtime_ns))
        except OSError:
            continue
    return tuple(sig)


def top(
    workdir: str,
    *,
    interval_s: float = 2.0,
    once: bool = False,
    iterations: Optional[int] = None,
    out=None,
) -> int:
    """The ``telemetry-top`` loop: render a frame every ``interval_s``
    seconds until interrupted. ``once`` prints a single frame (scripting /
    CI smoke); ``iterations`` bounds the loop for tests. Exit code 0 always —
    an empty workdir is an honest frame, not an error (a run that has not
    started yet is the normal first thing an operator watches)."""
    out = out if out is not None else sys.stdout
    count = 0
    last_sig: Optional[Tuple] = None
    frame: Dict = {}
    try:
        while True:
            sig = _ledger_signature(workdir)
            if frame and sig == last_sig:
                # nothing wrote since the last frame: refresh the clock and
                # ages only — an idle fleet costs one stat sweep per interval
                now = time.time()
                elapsed = now - frame["t"]
                frame["t"] = now
                for row in frame["rows"]:
                    if "last_event_age_s" in row:
                        row["last_event_age_s"] += elapsed
            else:
                frame = build_frame(workdir)
                last_sig = sig
            text = render_frame(frame)
            if once or iterations is not None:
                print(text, file=out, flush=True)
            else:
                print(_CLEAR + text, file=out, flush=True)
            count += 1
            if once or (iterations is not None and count >= iterations):
                return 0
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0
