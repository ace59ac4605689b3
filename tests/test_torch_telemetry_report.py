"""The port's telemetry readers (``obs/report.py``, ``obs/compare.py``,
``obs/top.py`` and the ``telemetry-report`` / ``telemetry-top`` commands)
against the JAX package's, on the CPU, on the same directories.

Ledgers:

- written by the port: a two-fold ``Trainer.train`` of the tiny segmenter
  with a cadence profile capture each window (its ``ops.json`` files are
  the port's trace section: empty on the CPU, where ``torch.profiler``
  records no device kernel), a ``fit`` of the tiny ViT, and the serve
  tier's workdir after ``tests/test_torch_serve_obs.py``'s request script;
- written by the JAX package's ``RunLedger`` / ``Telemetry``: the event
  kinds the port does not emit yet (elastic resizes, the serve fleet's
  router, autoscaler and replica lifecycle, a promotion with its shadow
  window and rollback, a supervised run's restarts, the continuous-learning
  loop), as the JAX package's own tests write them.

Held, exactly: ``build_report`` as JSON (but the trace section, which JAX
reads from an xplane capture and the port from its ``ops.json``),
``render_report``'s text for the same report dict (the port's trace
section included), ``config_hash``, ``run_summary``, the registry's rows,
``compare_workdirs`` and ``render_compare``, ``build_frame`` and
``render_frame`` at a fixed clock, and each command's stdout, stderr and
exit code, including rc 2 on a missing or empty workdir. Multi-process
ledgers: ``tests/test_torch_fleet_report.py``.
"""

from __future__ import annotations

import json
import os
import time

import pytest

from tensorflowdistributedlearning_tpu import cli as jcli
from tensorflowdistributedlearning_tpu.obs import compare as jcompare
from tensorflowdistributedlearning_tpu.obs import report as jreport
from tensorflowdistributedlearning_tpu.obs import top as jtop
from tensorflowdistributedlearning_tpu.obs.ledger import RunLedger as JRunLedger
from tensorflowdistributedlearning_tpu.obs.telemetry import Telemetry as JTelemetry
from tensorflowdistributedlearning_tpu_torch import __main__ as tcli
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.obs import compare as tcompare
from tensorflowdistributedlearning_tpu_torch.obs import report as treport
from tensorflowdistributedlearning_tpu_torch.obs import top as ttop
from tensorflowdistributedlearning_tpu_torch.train import fit as tfit
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tests import test_torch_dp_worker as worker
from tests.conftest import make_salt_dataset
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_serve_obs import _torch_pkg, run_script, weights  # noqa: F401 (fixture)

NOW = 1_760_000_000.0
TINY = dict(n_blocks=(1, 1, 1), input_shape=(32, 32), base_depth=16, width_multiplier=0.125, use_pallas_depthwise=True)
LOOP = dict(checkpoint_every_steps=2, eval_every_steps=4, save_best=2, train_log_every_steps=2,
            trace_sample_rate=1.0, seed=0)


def jax_written_ledgers(root) -> dict:
    """Workdirs of events the port does not emit yet, written by the JAX
    package's ledger, with the fields its emitters and tests give them."""
    dirs = {}

    dirs["elastic"] = d = os.path.join(root, "elastic")
    led = JRunLedger(d)
    led.event("elastic_start", hosts=3, min_hosts=1)
    led.event("run_header", process_index=0)
    led.event("world_resize", old_world=3, new_world=2, reason="host_death", progress_step=7, downtime_s=4.5,
              plan_old={"layout": {"data_parallel": 3}}, plan_new={"layout": {"data_parallel": 2}})
    led.event("host_evicted", process_index=1, skew=1.8, world_size=2, step=20)
    led.event("world_resize", old_world=2, new_world=1, reason="straggler_evicted", evicted_process=1,
              progress_step=20, downtime_s=2.5)
    led.event("data_redeal", step=20, old_process_count=2, new_process_count=1)
    led.event("elastic_end", ok=True, world_size=1, resizes=2, restarts=0, evictions=1, resize_downtime_s=7.0)
    led.close()

    dirs["fleet"] = d = os.path.join(root, "fleet")
    tel = JTelemetry(d, run_info={"kind": "serve-fleet"})
    tel.event("replica_spawn", replica=1, pid=1)
    tel.event("replica_ready", replica=1, endpoint="http://x:1")
    tel.event("fleet_scale", action="scale_up", from_replicas=1, to_replicas=2, reason="queue_depth",
              mean_queue_depth=7.5, shed_delta=0, slo_degraded_replicas=0, sustain=3)
    tel.event("replica_exit", replica=2, rc=137, restarts=0)
    tel.event("replica_restart", replica=2, attempt=1, backoff_s=0.5)
    tel.event("router_window", requests=100, routed=104, retries=4, shed=2, no_replica=0, replica_failures=1,
              per_replica_routed={"1": 60, "2": 40},
              fleet={"status": "ok", "live": 2, "starting": 0, "draining": 0, "dead": 0,
                     "artifacts": {"float32:aaaaaaaa": 1, "int8:bbbbbbbb": 1}, "promotion_active": False})
    tel.event("promotion_start", candidate_dir="/v2", dtype="float32", fingerprint="f" * 16, replicas=3)
    tel.event("phase_advance", phase="canary", replica=4)
    tel.event("shadow_window", replica=4, window=1, compared=12, max_abs_delta=0.01, mean_disagree=0.0,
              min_iou=0.99)
    tel.event("phase_advance", phase="shadow_complete", replica=4, windows=1, compared=12)
    tel.event("phase_advance", phase="rollout", replaced=1, remaining=1)
    tel.event("promotion_rollback", phase="rollout", reason="latency: fleet p99 regressed", status="rolled_back",
              restored=2, drained=2)
    tel.close()
    # a replica's ledger beside the controller's: capture, drift, the loop
    led = JRunLedger(d, filename="telemetry-1.jsonl")
    led.event("run_header", process_index=1, kind="serve", replica=1)
    led.event("capture_window", replica=1, total_captured=40, total_dropped=1, shards=2, shards_evicted=0,
              bytes_on_disk=4096)
    led.event("drift_alert", score=0.7, threshold=0.3, alert_id="a1", replica=1)
    led.event("records_ingest", records_added=40, new_shards=2, deduped=1, corrupt=0, version=1, records_total=40,
              dataset_dir="/d")
    led.event("loop_trigger", reason="drift", drift_alert_t=time.time() - 1.0, records_since=40)
    led.event("loop_retrain", rc=0, artifact="/a2")
    led.event("loop_promoted", fingerprint="f" * 16, version=1)
    led.event("run_end", kind="serve")
    led.close()

    dirs["resilience"] = d = os.path.join(root, "resilience")
    led = JRunLedger(d)
    led.event("supervisor_start", max_restarts=3)
    led.event("run_header", kind="train", supervised=True)
    led.event("checkpoint", step=5)
    led.event("preempted", step=5, reason="signal:SIGTERM")
    led.event("restart", attempt=1, rc=75, reason="preempted", step=5, prev_step=None, backoff_s=0.5,
              downtime_s=0.6)
    led.event("run_header", kind="train", supervised=True)
    led.event("resumed", step=5)
    led.event("checkpoint_retry", step=6, attempt=1, error="EIO")
    led.event("step_window", step=8, steps=3, data_wait_s=0.01, compute_s=0.3, fetch_wait_s=0.0,
              step_time_ms={"count": 3, "mean_ms": 100.0, "p50_ms": 99.0, "p90_ms": 110.0, "p99_ms": 120.0,
                            "max_ms": 130.0},
              data_service={"underruns": 2, "ready_depth": {"mean": 1.5, "min": 0}, "worker_util": 0.83})
    led.event("run_end", steps=8)
    led.event("supervisor_end", ok=True, restarts=1)
    led.close()
    return dirs


@pytest.fixture(scope="module")
def workdirs(tmp_path_factory, weights):  # noqa: F811 (the serve fixture)
    root = tmp_path_factory.mktemp("readers")
    data, _, ids = make_salt_dataset(root / "salt", n_images=16, shape=(32, 32))
    Trainer(str(root / "train"), data, device="cpu",
            train_config=TrainConfig(**LOOP, n_folds=2, eval_throttle_secs=0, profile_every_windows=1),
            **TINY).train(ids, batch_size=4, steps=4)
    fcfg = ModelConfig(**worker.VIT_TINY)
    tfit.ClassifierTrainer(str(root / "fit"), None, fcfg, TrainConfig(**dict(worker.VIT_ADAMW, **LOOP)),
                           device="cpu").fit(batch_size=8, steps=4)
    served = run_script(_torch_pkg(weights), str(root / "serve"))
    dirs = {"train": str(root / "train"), "fit": str(root / "fit"), "serve": served["workdir"]}
    dirs.update(jax_written_ledgers(str(root / "jax")))
    empty = root / "empty"
    empty.mkdir()
    dirs["empty"] = str(empty)
    return dirs


PORT_DIRS = ("train", "fit", "serve")
ALL_DIRS = PORT_DIRS + ("elastic", "fleet", "resilience")


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def test_the_train_workdir_holds_port_captures(workdirs):
    """The port's ledgers carry what the readers read, and each cadence
    capture left an ``ops.json`` (empty on the CPU) beside its trace."""
    captures = [os.path.join(dp, f) for dp, _, fs in os.walk(workdirs["train"]) for f in fs if f == "ops.json"]
    assert captures
    for path in captures:
        assert os.path.isfile(os.path.join(os.path.dirname(path), "trace.json"))
        with open(path) as f:
            assert json.load(f) == []
    section = treport.build_report(workdirs["train"])["trace"]
    assert section["dir"] == workdirs["train"] and section["buckets_ms"] == {} and section["top_ops"] == []
    assert "no device kernel" in section["note"]


@pytest.mark.parametrize("name", ALL_DIRS)
def test_build_report_equals_jax(workdirs, name):
    want = jreport.build_report(workdirs[name])
    got = treport.build_report(workdirs[name])
    want.pop("trace")
    got.pop("trace")
    assert _dump(got) == _dump(want)
    if name == "fleet":
        assert {"serve_fleet", "promotion", "loop"} <= set(got)
    if name in ("elastic", "resilience"):
        assert name in got


@pytest.mark.parametrize("name", ALL_DIRS)
def test_render_report_equals_jax(workdirs, name):
    """One report dict, the port's trace section included, rendered by both."""
    report = treport.build_report(workdirs[name])
    assert treport.render_report(report) == jreport.render_report(report)


def test_trace_section_reads_ops_json_files(workdirs, tmp_path):
    """Two captures' kernels summed by name, fractions of the total, JAX's
    keys; a torn ``ops.json`` is counted as a skipped file; the rendering is
    JAX's for the same dict."""
    for i, ops in enumerate([
        [{"name": "tfdl_int8_conv_tc_kernel", "total_ms": 3.0, "occurrences": 9, "fraction": 0.75},
         {"name": "void at::elementwise_kernel", "total_ms": 1.0, "occurrences": 4, "fraction": 0.25}],
        [{"name": "tfdl_int8_conv_tc_kernel", "total_ms": 1.0, "occurrences": 3, "fraction": 1.0}],
    ]):
        d = tmp_path / f"capture-{i}"
        d.mkdir()
        (d / "ops.json").write_text(json.dumps(ops))
    (tmp_path / "capture-torn").mkdir()
    (tmp_path / "capture-torn" / "ops.json").write_text('[{"name": "x", "total_')
    section = treport._trace_section(str(tmp_path), top=1)
    assert section["dir"] == str(tmp_path) and section["skipped_plane_files"] == 1
    assert section["top_ops"] == [{"name": "tfdl_int8_conv_tc_kernel", "total_ms": 4.0, "occurrences": 12,
                                   "fraction": 0.8}]
    assert sum(section["buckets_ms"].values()) == pytest.approx(5.0)
    assert "note" not in section
    report = dict(treport.build_report(workdirs["fit"]), trace=section)
    assert treport.render_report(report) == jreport.render_report(report)
    assert "tfdl_int8_conv_tc_kernel" in treport.render_report(report)
    assert treport._trace_section(str(tmp_path / "capture-torn" / "none"), top=1) is None


@pytest.mark.parametrize("name", ALL_DIRS)
def test_run_summary_and_config_hash_equal_jax(workdirs, name, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    want, got = jcompare.run_summary(workdirs[name]), tcompare.run_summary(workdirs[name])
    assert _dump(got) == _dump(want)
    header = next(e for e in treport_events(workdirs[name]) if e.get("event") == "run_header")
    assert tcompare.config_hash(header) == jcompare.config_hash(header)


def treport_events(workdir):
    from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger

    return read_ledger(workdir)


def test_registry_rows_and_compare_equal_jax(workdirs, tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    for pkg in ("jax", "port"):
        reg = str(tmp_path / pkg)
        lib = jcompare if pkg == "jax" else tcompare
        for name in ("train", "fit"):
            lib.register_run(reg, workdirs[name])
    want, got = jcompare.load_registry(str(tmp_path / "jax")), tcompare.load_registry(str(tmp_path / "port"))
    assert _dump(got) == _dump(want) and len(got) == 2
    for a, b in (("train", "fit"), ("fit", "fit"), ("serve", "train")):
        w = jcompare.compare_workdirs(workdirs[a], workdirs[b])
        g = tcompare.compare_workdirs(workdirs[a], workdirs[b])
        assert _dump(g) == _dump(w)
        assert tcompare.render_compare(g) == jcompare.render_compare(w)
    run_id = got[0]["run_id"]
    w = jcompare.compare_workdirs(run_id, workdirs["fit"], registry_dir=str(tmp_path / "jax"))
    g = tcompare.compare_workdirs(run_id, workdirs["fit"], registry_dir=str(tmp_path / "port"))
    assert _dump(g) == _dump(w)
    assert _dump(tcompare.compare_rows(got[0], got[1])) == _dump(jcompare.compare_rows(want[0], want[1]))


@pytest.mark.parametrize("name", ALL_DIRS + ("empty",))
def test_top_frame_equals_jax(workdirs, name):
    want = jtop.build_frame(workdirs[name], now=NOW)
    got = ttop.build_frame(workdirs[name], now=NOW)
    assert _dump(got) == _dump(want)
    assert ttop.render_frame(got) == jtop.render_frame(want)


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _same_cli(argv, capsys):
    want = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv, capsys)
    assert got == want
    return got


@pytest.mark.parametrize("name", ALL_DIRS)
def test_report_command_equals_jax(workdirs, name, tmp_path, capsys, monkeypatch):
    """Text and ``--json`` (the trace directory an empty one, which both
    read as no capture), ``--straggler-threshold``, ``--export-trace``,
    ``--register`` with and without ``--registry-dir``."""
    monkeypatch.setattr(time, "time", lambda: NOW)
    wd, nothing = workdirs[name], workdirs["empty"]
    for extra in ([], ["--json"], ["--straggler-threshold", "1.1", "--top", "3"]):
        rc, out, _ = _same_cli(["telemetry-report", wd, "--trace-dir", nothing, *extra], capsys)
        assert rc == 0 and out
    for pkg in ("jax", "port"):
        main = jcli.main if pkg == "jax" else tcli.main
        rc, out, _ = _run(main, ["telemetry-report", wd, "--export-trace", str(tmp_path / f"{pkg}.json")], capsys)
        assert rc == 0 and json.loads(out)["written"] == str(tmp_path / f"{pkg}.json")
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        assert json.load(g) == json.load(f)
    assert _same_cli(["telemetry-report", wd, "--register"], capsys)[0] == 2
    rows = [_run(m, ["telemetry-report", wd, "--register", "--registry-dir", str(tmp_path / k)], capsys)
            for m, k in ((jcli.main, "rj"), (tcli.main, "rt"))]
    assert rows[0] == rows[1] and rows[0][0] == 0


def test_report_command_compare_and_failures_equal_jax(workdirs, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    for extra in ([], ["--json"]):
        rc, out, _ = _same_cli(["telemetry-report", "--compare", workdirs["train"], workdirs["fit"], *extra], capsys)
        assert rc == 0 and out
    assert _same_cli(["telemetry-report"], capsys)[0] == 2
    assert _same_cli(["telemetry-report", workdirs["empty"]], capsys)[0] == 2
    assert _same_cli(["telemetry-report", str(tmp_path / "missing")], capsys)[0] == 2
    assert _same_cli(["telemetry-report", workdirs["empty"], "--export-trace", str(tmp_path / "t.json")],
                     capsys)[0] == 2
    assert _same_cli(["telemetry-report", "--compare", "nope-a", "nope-b"], capsys)[0] in (1, 2)
    # a ledger with no run in it: a ValueError, rc 1
    (tmp_path / "blank").mkdir()
    (tmp_path / "blank" / "telemetry.jsonl").write_text("")
    assert _same_cli(["telemetry-report", str(tmp_path / "blank")], capsys)[0] == 1


@pytest.mark.parametrize("name", ALL_DIRS + ("empty",))
def test_top_command_once_equals_jax(workdirs, name, capsys, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    rc, out, _ = _same_cli(["telemetry-top", workdirs[name], "--once"], capsys)
    assert rc == 0 and out
