"""The port's serve tier on the CPU, beyond the script run against JAX: the
SLO budget behind ``/healthz``, ``/admin/profile``, cold buckets after a
budgeted warmup, the drift monitor, ``stamp_drift_baseline`` at the train
and fit exports, and the ``serve`` command with a registry, a SIGTERM drain
and an injected request fault. Ledgers are read after ``shutdown()``."""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu_torch import __main__ as cli
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.obs import health as health_lib
from tensorflowdistributedlearning_tpu_torch.obs import profiler as profiler_lib
from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger
from tensorflowdistributedlearning_tpu_torch.obs.telemetry import Telemetry
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine, MicroBatcher, ServingServer
from tensorflowdistributedlearning_tpu_torch.serve import quant_check
from tensorflowdistributedlearning_tpu_torch.serve.registry import ModelEntry, write_registry
from tensorflowdistributedlearning_tpu_torch.train import serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=8, input_shape=(17, 17))
SHAPE = (17, 17, 2)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _posts(url, payload, n):
    """n POSTs on one HTTP/1.1 connection, then a GET on it: the server
    answers a connection's requests in order and accounts a request's
    latency after answering it, so when the GET answers, all n are in the
    SLO window."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    body = json.dumps(payload).encode()
    statuses = []
    try:
        for _ in range(n):
            conn.request("POST", "/v1/predict", body=body, headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            r.read()
            statuses.append(r.status)
        conn.request("GET", "/healthz")
        conn.getresponse().read()
    finally:
        conn.close()
    return statuses


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, *SHAPE)).astype(np.float32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The tiny segmenter's float32 and bfloat16 serving artifacts."""
    cfg = ModelConfig(**KW, use_pallas_depthwise=True)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(5))
    root = tmp_path_factory.mktemp("art")
    out = {}
    for spec in ("float32", "bfloat16"):
        out[spec] = str(root / spec)
        serving.export_serving_artifact(model, cfg, out[spec], serving_dtype=spec)
    return out


def _echo(x):
    """A closure engine's forward: the row sums (the server's own logic is
    under test, not the model)."""
    return {"sum": torch.as_tensor(np.asarray(x)).sum(dim=(1, 2, 3))}


def _serve(artifact, workdir=None, **kw):
    """A server with telemetry under ``workdir`` (none without), over the
    artifact, or over ``_echo`` when ``artifact`` is None."""
    tel = Telemetry(workdir, trace_sample_rate=1.0, run_info={"kind": "serve"}, device="cpu") if workdir else None
    reg, tracer = (tel.registry, tel.tracer) if tel else (None, None)
    if artifact is None:
        engine = InferenceEngine(_echo, SHAPE, buckets=(1, 4), registry=reg, tracer=tracer)
    else:
        engine = InferenceEngine.from_artifact(artifact, device="cpu", buckets=(1, 4), registry=reg, tracer=tracer)
    engine.warmup(telemetry=tel, budget=kw.pop("budget", None))
    return ServingServer(engine, MicroBatcher(engine, max_wait_ms=0), telemetry=tel, window_secs=0, **kw).start()


def test_slo_breach_degrades_healthz_then_recovers(tmp_path):
    server = _serve(None, str(tmp_path), slo_p99_ms=60_000)
    url = server.url
    try:
        x = {"instances": _x(1).tolist()}
        assert _posts(url, x, 20) == [200] * 20
        server.emit_window()
        assert _get(url + "/healthz")[1]["status"] == "ok"
        server.slo.p99_target_ms = 1e-3  # the same traffic now breaks the budget
        assert _posts(url, x, 20) == [200] * 20
        fields = server.emit_window()
        status, body = _get(url + "/healthz")
        assert status == 200 and body["status"] == "degraded" and body["ok"] is False
        assert fields["slo"]["healthy"] is False
        server.slo.p99_target_ms = 60_000
        assert _posts(url, x, 20) == [200] * 20
        server.emit_window()
        assert _get(url + "/healthz")[1]["status"] == "ok"
    finally:
        server.shutdown()
    events = read_ledger(str(tmp_path))
    alerts = [e for e in events if e["event"] == "health_alert"]
    assert [a.get("resolved", False) for a in alerts] == [False, True]
    assert alerts[0]["monitor"] == "slo" and alerts[0]["window_violations"] == 20
    # one postmortem capture, linked to the breach's alert id
    captures = [e for e in events if e["event"] == "profile_capture"]
    assert len(captures) == 1 and captures[0]["reason"] == "alert"
    assert captures[0]["alert_id"] == alerts[0]["alert_id"]
    assert server.profiler.errors == 0
    assert events[-1]["event"] == "run_end" and events[-1]["completed"] == 60
    assert len([e for e in events if e["event"] == "trace" and e["name"] == "request"]) == 60


def test_admin_profile_answers_202_409_and_503(tmp_path):
    bare = _serve(None)
    try:
        status, body = _get(bare.url + "/admin/profile?seconds=1")
        assert status == 503 and body["error"]["code"] == "profiling_unavailable"
    finally:
        bare.shutdown()
    server = _serve(None, str(tmp_path))
    try:
        assert _get(server.url + "/admin/profile?seconds=x")[0] == 400
        assert _get(server.url + "/admin/profile?seconds=61")[0] == 400
        status, body = _get(server.url + "/admin/profile?seconds=30")
        assert status == 202 and body["status"] == "started" and body["replica"] == 0
        status, again = _get(server.url + "/admin/profile?seconds=1")
        assert status == 409 and again["error"]["code"] == "capture_in_flight"
        _post(server.url + "/v1/predict", {"instances": _x(2).tolist()})
    finally:
        server.shutdown()  # stops the capture in flight and ledgers it
    captures = [e for e in read_ledger(str(tmp_path)) if e["event"] == "profile_capture"]
    assert len(captures) == 1 and captures[0]["capture_id"] == body["capture_id"]
    assert captures[0]["reason"] == "admin" and captures[0]["window_s"] < 30
    assert os.path.exists(os.path.join(captures[0]["logdir"], "trace.json"))
    assert json.load(open(os.path.join(captures[0]["logdir"], "ops.json"))) == []  # no card, no kernels


def test_profiler_ledgers_a_roofline_of_the_kernels(tmp_path, monkeypatch):
    tel = Telemetry(str(tmp_path), device="cpu")
    prof = profiler_lib.ContinuousProfiler(tel)
    rows = [profiler_lib.OpTime("void tfdl_bn_act_rows_kernel", 2.0, 4, 0.5),
            profiler_lib.OpTime("void tfdl_depthwise_tiled_kernel<float>", 2.0, 3, 0.5)]
    monkeypatch.setattr(profiler_lib, "kernel_breakdown", lambda events: rows)
    out = prof.capture_timed(0.05, wait=True)
    assert out["status"] == "complete" and prof.captures == 1 and prof.errors == 0
    assert prof.trigger({"alert_id": "a1"}, seconds=0.05) is not None
    assert prof.trigger({"alert_id": "a2"}, seconds=0.05) is None and prof.rate_limited == 1
    prof.close()
    tel.close()
    events = read_ledger(str(tmp_path))
    roofs = [e for e in events if e["event"] == "op_roofline"]
    assert roofs[0]["buckets"] == {"conv": 2.0, "fusion(elementwise/bn)": 2.0} and roofs[0]["phase"] == "infer"
    assert roofs[0]["classes"]["compute_frac"] == 0.5 and "mfu" not in roofs[0]
    assert [e.get("alert_id") for e in events if e["event"] == "profile_capture"] == [None, "a1"]


def test_budgeted_warmup_counts_cold_first_runs_as_jax_names_them(artifacts, tmp_path):
    from tensorflowdistributedlearning_tpu import obs as jobs
    from tensorflowdistributedlearning_tpu.serve import InferenceEngine as JEngine

    server = _serve(artifacts["float32"], str(tmp_path), budget=1)
    try:
        assert _post(server.url + "/v1/predict", {"instances": _x(3).tolist()})[0] == 200
        assert _post(server.url + "/v1/predict", {"instances": _x(4).tolist()})[0] == 200
        fields = server.emit_window()
        assert fields["recompiles_post_warmup"] == 1
        assert server.engine.registry.counter("serve/cold_bucket_hits/4").value == 1
    finally:
        server.shutdown()
    events = read_ledger(str(tmp_path))
    warm = [e for e in events if e["event"] == "serve_warmup"][0]
    compiles = [e for e in events if e["event"] == "compile"]
    assert warm["cold_buckets"] == ["4"] and warm["prewarm_budget"] == 1 and list(warm["buckets"]) == ["1"]
    assert [c["post_warmup"] for c in compiles] == [False, True]
    assert events[-1]["recompiles_post_warmup"] == 1 and events[-1]["compiles"] == 2
    jtel = jobs.Telemetry(str(tmp_path / "jax"), run_info={"kind": "serve"})
    try:
        jeng = JEngine(lambda x: {"y": np.asarray(x).sum(axis=(1, 2, 3))}, SHAPE, buckets=(1, 4))
        jeng.warmup(telemetry=jtel, budget=1)
    finally:
        jtel.close()
    jwarm = [e for e in read_ledger(str(tmp_path / "jax")) if e["event"] == "serve_warmup"][0]
    assert set(jwarm) - {"serving_dtype", "compute_dtype"} == set(warm) - {"serving_dtype", "compute_dtype"}
    assert (jwarm["cold_buckets"], jwarm["prewarm_budget"]) == (warm["cold_buckets"], warm["prewarm_budget"])


def test_drift_monitor_alerts_on_a_shifted_class_mix(tmp_path):
    tel = Telemetry(str(tmp_path), device="cpu")

    def classify(x):
        return {"class": torch.as_tensor(np.asarray(x)[:, 0] > 0).to(torch.int32) * 2}

    engine = InferenceEngine(classify, (1,), buckets=(1, 4), registry=tel.registry)
    engine.warmup(telemetry=tel)
    drift = health_lib.DriftMonitor({"outputs": {"class": {"kind": "integer", "hist": {"0": 0.5, "1": 0.5}}}},
                                    threshold=0.3, min_requests=4, sustain_windows=1)
    server = ServingServer(engine, MicroBatcher(engine, max_wait_ms=0), telemetry=tel, window_secs=0,
                           drift_monitor=drift).start()
    try:
        for _ in range(3):
            _post(server.url + "/v1/predict", {"instances": [[1.0], [2.0]]})
        fields = server.emit_window()
    finally:
        server.shutdown()
    assert fields["drift"]["healthy"] is False and fields["drift"]["score"] == 1.0
    alerts = [e for e in read_ledger(str(tmp_path)) if e["event"] == "drift_alert"]
    assert len(alerts) == 1 and alerts[0]["output"] == "class" and alerts[0]["alert_id"]


def test_stamped_baseline_summarises_the_served_outputs(artifacts, tmp_path):
    import shutil

    art = str(tmp_path / "art")
    shutil.copytree(artifacts["float32"], art)
    baseline = quant_check.stamp_drift_baseline(art, batch_size=4, seed=3, device="cpu")
    assert serving.read_manifest(art)["drift_baseline"] == baseline
    batch = quant_check.pinned_eval_batch(serving.read_manifest(art), 4, 3)
    out = {k: v.numpy() for k, v in serving.load_serving_artifact(art, "cpu")(batch).items()}
    assert baseline == quant_check.summarize_output_distribution(out, batch=4, seed=3)
    assert set(baseline["outputs"]) == {"probabilities", "mask"}
    assert baseline["outputs"]["mask"]["kind"] == "float"  # a segmenter has no class histogram
    with pytest.raises(ValueError, match="no integer output histogram"):
        health_lib.DriftMonitor(baseline)


def test_train_and_fit_exports_stamp_the_baseline(artifacts, tmp_path, monkeypatch, caplog):
    import shutil

    from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
    from tensorflowdistributedlearning_tpu_torch.train import fit as fit_lib
    from tensorflowdistributedlearning_tpu_torch.train import trainer as trainer_lib

    art = str(tmp_path / "fold0" / "export" / "serving")
    shutil.copytree(artifacts["float32"], art)

    class FakeTrainer:
        params = 1

        def __init__(self, *a, **k):
            pass

        def train(self, ids, batch_size, steps):
            return [{"metrics/mean_iou": 0.5}]

        def export_serving(self, fold, serving_dtype):
            return os.path.join(art, "manifest.json")

    monkeypatch.setattr(trainer_lib, "Trainer", FakeTrainer)
    monkeypatch.setattr(pipeline_lib, "discover_ids", lambda d: ["a", "b"])
    assert cli.main(["train", "--data-dir", "D", "--model-dir", str(tmp_path), "--device", "cpu",
                     "--export-serving"]) == 0
    assert "drift_baseline" in serving.read_manifest(art)
    fitted = str(tmp_path / "fitted")
    shutil.copytree(artifacts["bfloat16"], fitted)
    result = argparse.Namespace(steps=1, n_params=1, final_metrics={}, serving_artifact=fitted)
    monkeypatch.setattr(fit_lib, "fit_preset", lambda *a, **k: result)
    assert cli.main(["fit", "--preset", "p", "--model-dir", str(tmp_path), "--device", "cpu",
                     "--export-serving"]) == 0
    assert "drift_baseline" in serving.read_manifest(fitted)
    # a fault of the artifact's files is logged and the export survives
    os.remove(os.path.join(fitted, "manifest.json"))
    cli._stamp_baseline(fitted, "cpu")
    assert "drift-baseline stamp failed" in caplog.text
    # any other failure is not hidden behind the warning
    monkeypatch.setattr(quant_check, "stamp_drift_baseline", lambda *a, **k: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        cli._stamp_baseline(art, "cpu")


def test_serve_flags_have_the_jax_defaults():
    from tensorflowdistributedlearning_tpu import cli as jcli

    def serve_action(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {a.dest: a.default for a in sub.choices["serve"]._actions}

    port, jax_ = serve_action(cli.build_parser()), serve_action(jcli.build_parser())
    flags = ("registry", "model", "model_version", "prewarm_buckets", "visible_devices", "workdir", "window_secs",
             "trace_sample_rate", "slo_p99_ms", "slo_error_budget", "replica_id", "inject_fault", "seed",
             "capture_dir", "capture_fraction", "capture_quota_mb", "capture_records_per_shard", "drift_threshold",
             "drift_min_requests", "drift_sustain_windows", "default_deadline_ms", "max_wait_ms", "queue_size")
    assert {f: port[f] for f in flags} == {f: jax_[f] for f in flags}


def _spawn(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen([sys.executable, "-m", "tensorflowdistributedlearning_tpu_torch", "serve", "--port", "0",
                             "--device", "cpu", *args], cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_serve_command_registry_drain_and_request_fault(artifacts, tmp_path):
    """Two ``serve`` processes at once: a two-model registry with tracing
    and a cold bucket, drained by SIGTERM; and one artifact under
    ``--inject-fault sigkill@2``, which answers two requests and dies."""
    reg = tmp_path / "fleet"
    reg.mkdir()
    write_registry(str(reg), [ModelEntry(name="seg", artifact_dir=artifacts["float32"], version=3),
                              ModelEntry(name="seg16", artifact_dir=artifacts["bfloat16"], prewarm_budget=1)])
    work = tmp_path / "work"
    drained = _spawn(["--registry", str(reg / "registry.json"), "--workdir", str(work), "--buckets", "1", "4",
                      "--trace-sample-rate", "1.0", "--window-secs", "0", "--slo-p99-ms", "60000"], str(tmp_path))
    killed = _spawn(["--artifact-dir", artifacts["float32"], "--workdir", str(tmp_path / "killed"),
                     "--buckets", "1", "--inject-fault", "sigkill@2"], str(tmp_path))
    try:
        ready = json.loads(drained.stdout.readline())
        assert ready["models"] == {"seg": 3, "seg16": 1} and set(ready["warmup_s"]) == {"seg/1", "seg/4", "seg16/1"}
        for name, n in (("seg", 2), ("seg16", 3), ("seg16", 1)):
            assert _post(ready["serving"] + "/v1/predict", {"instances": _x(n).tolist(), "model": name})[0] == 200
        drained.send_signal(signal.SIGTERM)
        assert drained.wait(60) == 0
        kready = json.loads(killed.stdout.readline())
        url = kready["serving"] + "/v1/predict"
        assert [_post(url, {"instances": _x(1).tolist()})[0] for _ in range(2)] == [200, 200]
        assert killed.wait(60) == -signal.SIGKILL
    finally:
        for p in (drained, killed):
            if p.poll() is None:
                p.kill()
    events = read_ledger(str(work))
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_header" and kinds[-1] == "run_end" and "trace" in kinds
    windows = [e for e in events if e["event"] == "serve_window"]
    assert len(windows) == 1 and windows[-1]["final"]
    final = windows[-1]
    assert final["models"]["seg"]["completed"] == 1 and final["models"]["seg16"]["completed"] == 2
    assert final["models"]["seg16"]["version"] == 1 and final["recompiles_post_warmup"] == 1
    assert events[-1]["recompiles_post_warmup"] == 1 and events[0]["models"] == {"seg": 3, "seg16": 1}
    assert events[0]["fingerprint"]["platform"] == "cpu" and "torch_version" in events[0]["fingerprint"]
    kevents = read_ledger(str(tmp_path / "killed"))
    assert "serve_start" in [e["event"] for e in kevents] and "run_end" not in [e["event"] for e in kevents]


def test_telemetry_span_and_disabled_instance(tmp_path):
    from tensorflowdistributedlearning_tpu_torch.obs.telemetry import NULL_TELEMETRY

    tel = Telemetry(str(tmp_path), trace_sample_rate=1.0, device="cpu", run_info={"kind": "serve"})
    with tel.span("outer"):
        assert tel.current_span == "outer"
        with tel.span("inner"):
            assert tel.current_span == "inner"
    assert tel.registry.histogram("span/inner").lifetime_count == 1 and tel.current_span == ""
    tel.close(kind="serve")
    tel.close()  # idempotent
    events = read_ledger(str(tmp_path))
    header, traces, end = events[0], [e for e in events if e["event"] == "trace"], events[-1]
    assert header["process_count"] == 1 and header["fingerprint"]["platform"] == "cpu" and header["kind"] == "serve"
    assert [t["name"] for t in traces] == ["inner", "outer"] and traces[0]["parent_id"] == traces[1]["span_id"]
    assert end["event"] == "run_end" and end["compiles"] == 0 and [e["event"] for e in events].count("run_end") == 1
    assert not NULL_TELEMETRY.enabled and NULL_TELEMETRY.ledger is None and not NULL_TELEMETRY.tracer.enabled
    with NULL_TELEMETRY.span("x"):
        pass
