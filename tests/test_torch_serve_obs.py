"""The port's serve tier observability against the JAX package's, on the CPU.

One fixed request script, made from a seed with numpy, goes through the JAX
package's ``ServingServer`` and the port's, each serving the same tiny
segmenter (the JAX variables carried across by ``utils/convert.py``) as two
tenants, with tracing at rate 1.0, an SLO, the capture tee and windows
emitted by hand (``window_secs=0``). Ledgers are read only after
``shutdown()``. Then the JAX package's readers (``obs.report.build_report``,
``obs.trace.export_chrome_trace``) read the port's ledger.
"""

from __future__ import annotations

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tensorflowdistributedlearning_tpu import obs as jobs
from tensorflowdistributedlearning_tpu.config import ModelConfig as JCfg
from tensorflowdistributedlearning_tpu.loop import capture as jcapture
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.obs import ledger as jledger
from tensorflowdistributedlearning_tpu.obs import report as jreport
from tensorflowdistributedlearning_tpu.obs import trace as jtrace
from tensorflowdistributedlearning_tpu.obs.metrics import MetricsRegistry as JRegistry
from tensorflowdistributedlearning_tpu.serve import InferenceEngine as JEngine
from tensorflowdistributedlearning_tpu.serve import MicroBatcher as JBatcher
from tensorflowdistributedlearning_tpu.serve import ServingServer as JServer
from tensorflowdistributedlearning_tpu.train.step import SegmentationTask as JTask
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.loop import capture as tcapture
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.obs import ledger as tledger
from tensorflowdistributedlearning_tpu_torch.obs.metrics import MetricsRegistry as TRegistry
from tensorflowdistributedlearning_tpu_torch.obs.telemetry import Telemetry as TTelemetry
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine as TEngine
from tensorflowdistributedlearning_tpu_torch.serve import MicroBatcher as TBatcher
from tensorflowdistributedlearning_tpu_torch.serve import ServingServer as TServer
from tensorflowdistributedlearning_tpu_torch.train import serving
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax

KW = dict(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=8, input_shape=(17, 17))
SHAPE = (17, 17, 2)
BUCKETS = (1, 4)
SEED = 14
# the script: (tenant, n) answered requests, in order
ANSWERED = [("seg", 1), ("seg", 3), ("seg16", 2), ("seg", 4), ("seg", 1), ("seg16", 1), ("seg", 2)]
COUNTERS = ("requests", "completed", "rejected_queue_full", "deadline_exceeded", "errors", "batches",
            "batched_examples")


def _post(url, payload, headers=None, raw=None):
    body = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def weights():
    """The tiny segmenter's variables, drawn with numpy from SEED into the
    shapes flax's init gives (running the init itself takes tens of seconds
    on the CPU): kernels at 1/sqrt(fan-in), BN scales near 1, variances in
    [0.5, 1.5]."""
    jm = jbuild(JCfg(**KW))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(SEED), jnp.zeros((1, *SHAPE)), train=False))
    rng = np.random.default_rng(SEED)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            a = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(a.astype(leaf.dtype))

    return jm, jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_pkg(weights):
    jm, v = weights
    task = JTask()
    fn = jax.jit(lambda x: task.predictions(jm.apply(v, x, train=False)))
    return types.SimpleNamespace(
        Telemetry=lambda wd, **kw: jobs.Telemetry(wd, **kw), Engine=JEngine, Batcher=JBatcher, Server=JServer,
        Registry=JRegistry, Capture=jcapture.TrafficCapture, serve_fn=lambda: fn, read=jledger.read_ledger,
    )


def _torch_pkg(weights):
    _, v = weights
    cfg = ModelConfig(**KW, use_pallas_depthwise=True)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(v["params"], v["batch_stats"], cfg))
    fn = serving.make_serving_fn(model.eval(), "cpu")
    return types.SimpleNamespace(
        Telemetry=lambda wd, **kw: TTelemetry(wd, device="cpu", **kw), Engine=TEngine, Batcher=TBatcher,
        Server=TServer, Registry=TRegistry, Capture=tcapture.TrafficCapture, serve_fn=lambda: fn,
        read=tledger.read_ledger,
    )


def _gate(engine):
    """Hold the engine's worker in its next forward until released."""
    entered, release = threading.Event(), threading.Event()
    fn = engine.serve_fn

    def gated(x):
        entered.set()
        release.wait(30)
        return fn(x)

    engine.serve_fn = gated
    return entered, release, lambda: setattr(engine, "serve_fn", fn)


def run_script(pkg, root):
    """Drive one package's server through the fixed script; returns what
    the client saw and the server's final window."""
    workdir, capdir = os.path.join(root, "work"), os.path.join(root, "capture")
    rng = np.random.default_rng(SEED)
    xs = [rng.normal(size=(n, *SHAPE)).astype(np.float32) for _, n in ANSWERED]
    tel = pkg.Telemetry(workdir, trace_sample_rate=1.0, run_info={"kind": "serve"}, process_index=0)
    engines = {name: pkg.Engine(pkg.serve_fn(), SHAPE, buckets=BUCKETS,
                                registry=tel.registry if name == "seg" else pkg.Registry(), tracer=tel.tracer)
               for name in ("seg", "seg16")}
    for e in engines.values():
        e.warmup(telemetry=tel, mark_warm=False)
    tel.mark_warm()
    capture = pkg.Capture(capdir, records_per_shard=4)
    server = pkg.Server(engines["seg"], pkg.Batcher(engines["seg"], max_wait_ms=0), telemetry=tel, window_secs=0,
                        slo_p99_ms=60_000, model="seg", registry_version=1, capture=capture)
    server.add_model("seg16", engines["seg16"], pkg.Batcher(engines["seg16"], max_wait_ms=0, max_queue=1),
                     version=2, slo_p99_ms=60_000)
    server.start()
    url = server.url + "/v1/predict"
    seen = {"answers": [], "statuses": {}}
    try:
        for i, ((name, _), x) in enumerate(zip(ANSWERED, xs)):
            status, headers, body = _post(url, {"instances": x.tolist(), "model": name},
                                          headers={"x-request-id": f"req-{i}"})
            seen["answers"].append((status, headers.get("x-request-id"), body))
            if i == 2:
                server.emit_window()
        seen["statuses"]["413"] = _post(url, {"instances": np.zeros((5, *SHAPE)).tolist()})
        seen["statuses"]["400"] = _post(url, None, raw=b"{not json")
        seen["statuses"]["404"] = _post(url, {"instances": xs[0].tolist(), "model": "nope"})
        seen["statuses"]["504"] = _post(url, {"instances": xs[0].tolist(), "deadline_ms": 1e-6})
        # a full queue: the tenant's worker held, one request queued, the next shed
        entered, release, restore = _gate(engines["seg16"])
        held = threading.Thread(target=lambda: _post(url, {"instances": xs[0].tolist(), "model": "seg16"}))
        held.start()
        assert entered.wait(30)
        queued = threading.Thread(target=lambda: _post(url, {"instances": xs[0].tolist(), "model": "seg16"}))
        queued.start()
        deadline = time.monotonic() + 30
        while engines["seg16"].registry.gauge("serve/queue_depth").value != 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        seen["statuses"]["429"] = _post(url, {"instances": xs[0].tolist(), "model": "seg16"})
        release.set()
        held.join(30)
        queued.join(30)
        restore()
        seen["metrics"] = json.loads(_get(server.url + "/metrics")[1])
        seen["prometheus"] = _get(server.url + "/metrics?format=prometheus")[1]
        seen["prometheus_accept"] = _get(server.url + "/metrics", headers={"Accept": "text/plain"})[1]
        seen["healthz"] = json.loads(_get(server.url + "/healthz")[1])
    finally:
        server.shutdown()
    seen["events"] = pkg.read(workdir)
    seen["workdir"], seen["capdir"], seen["xs"] = workdir, capdir, xs
    seen["final"] = [e for e in seen["events"] if e.get("event") == "serve_window"][-1]
    return seen


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    return {
        "jax": run_script(_jax_pkg(weights), str(tmp_path_factory.mktemp("jax"))),
        "torch": run_script(_torch_pkg(weights), str(tmp_path_factory.mktemp("torch"))),
    }


def _kinds(events):
    out = {}
    for e in events:
        keys = set(e) - {"t"}
        if e["event"] == "run_header":
            keys |= {f"fingerprint.{k}" for k in e.get("fingerprint", {})}
        out.setdefault(e["event"], set()).update(keys)
    return out


def test_ledgers_hold_the_same_event_kinds_and_fields(runs):
    jk, tk = _kinds(runs["jax"]["events"]), _kinds(runs["torch"]["events"])
    assert set(jk) == set(tk)
    assert {"run_header", "serve_warmup", "compile", "serve_start", "trace", "serve_window", "cost",
            "capture_window", "run_end"} <= set(tk)
    for kind in jk:
        want = jk[kind] - {"fingerprint.jax_version"} | ({"fingerprint.torch_version"} if kind == "run_header" else set())
        assert tk[kind] == want, kind


def test_final_window_counters_are_equal_and_match_the_script(runs):
    jf, tf = runs["jax"]["final"], runs["torch"]["final"]
    assert jf.get("final") and tf.get("final")
    assert {k: tf[k] for k in COUNTERS} == {k: jf[k] for k in COUNTERS}
    for name in ("seg", "seg16"):
        assert {k: tf["models"][name][k] for k in COUNTERS} == {k: jf["models"][name][k] for k in COUNTERS}
    answered = [n for _, n in ANSWERED]
    seg16 = [n for name, n in ANSWERED if name == "seg16"] + [1, 1]  # + the held and the queued request
    assert tf["models"]["seg16"]["completed"] == len(seg16) and tf["models"]["seg16"]["rejected_queue_full"] == 1
    assert tf["completed"] == len(answered) + 2
    assert tf["batched_examples"] == sum(answered) + 2
    assert tf["deadline_exceeded"] == 1 and tf["requests"] == len(answered) + 3
    assert tf["recompiles_post_warmup"] == 0


def test_answers_statuses_and_request_ids(runs):
    t = runs["torch"]
    for i, (status, rid, body) in enumerate(t["answers"]):
        assert status == 200 and rid == f"req-{i}" and body["n"] == ANSWERED[i][1]
    for code, (status, headers, body) in t["statuses"].items():
        assert status == int(code)
        assert headers.get("x-request-id") == body["error"]["request_id"]
    assert t["statuses"]["429"][1]["Retry-After"]
    assert t["healthz"]["status"] == "ok" and t["healthz"]["models"] == {
        "seg": {"version": 1, "status": "ok"}, "seg16": {"version": 2, "status": "ok"}}
    # the port answers as JAX does, to float tolerance
    for (_, _, jb), (_, _, tb) in zip(runs["jax"]["answers"], t["answers"]):
        np.testing.assert_allclose(tb["predictions"]["probabilities"], jb["predictions"]["probabilities"], atol=1e-5)


def _prom_names(text):
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}


def test_prometheus_bodies_name_the_same_metrics_with_the_json_values(runs):
    t = runs["torch"]
    assert _prom_names(t["prometheus"]) == _prom_names(runs["jax"]["prometheus"])
    assert t["prometheus_accept"].split("tfdl_serve_uptime_s")[0] == t["prometheus"].split("tfdl_serve_uptime_s")[0]
    values = {}
    for line in t["prometheus"].splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            values[name] = float(value)
    for name, value in t["metrics"]["registry"]["counters"].items():
        assert values["tfdl_" + name.replace("/", "_") + "_total"] == value
    for name, row in t["metrics"]["models"].items():
        for metric in ("requests", "completed", "rejected_queue_full"):
            assert values[f'tfdl_serve_model_{metric}_total{{model="{name}",version="{row["version"]}"}}'] == row[metric]


def test_jax_report_reads_the_port_ledger(runs):
    t = runs["torch"]
    report = jreport.build_report(t["workdir"])
    serve = report["serve"]
    assert {k: serve[k] for k in COUNTERS} == {k: t["final"][k] for k in COUNTERS}
    assert serve["recompiles_post_warmup"] == 0 and set(serve["models"]) == {"seg", "seg16"}
    assert set(serve["latency_ms"]) == {"queue_wait", "pad", "compute", "request"}
    jserve = jreport.build_report(runs["jax"]["workdir"])["serve"]
    assert set(serve) == set(jserve)


def test_jax_chrome_export_links_each_request_to_its_batch(runs):
    t = runs["torch"]
    events = t["events"]
    doc = jtrace.export_chrome_trace(events)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s["args"]["trace_id"], []).append(s)
    batch_compute = {s["args"]["span_id"] for s in spans if s["name"] == "compute"
                     and any(p["name"] == "batch" and p["args"]["span_id"] == s["args"].get("parent_id")
                             for p in by_trace[s["args"]["trace_id"]])}
    flows = {e["id"] for e in doc["traceEvents"] if e["ph"] == "s"}
    for i in range(len(ANSWERED)):
        mine = by_trace[f"req-{i}"]
        root = [s for s in mine if s["name"] == "request"]
        assert len(root) == 1 and root[0]["args"]["status"] == 200
        children = {s["name"]: s for s in mine if s["args"].get("parent_id") == root[0]["args"]["span_id"]}
        assert set(children) == {"queue_wait", "pad", "compute"}
        link = children["compute"]["args"]["batch_span_id"]
        assert link in batch_compute and f"{link}:{children['compute']['args']['span_id']}" in flows
    # the port's own export of the same workdir agrees, and its writer
    from tensorflowdistributedlearning_tpu_torch.obs import trace as ttrace

    assert ttrace.export_chrome_trace(events) == doc
    out = os.path.join(os.path.dirname(t["workdir"]), "trace.json")
    assert ttrace.write_chrome_trace(t["workdir"], out) == len(spans)
    with open(out) as f:
        assert json.load(f) == doc


def test_capture_shards_read_back_through_jax_records(runs):
    """The primary model's answered examples (the shed, expired and foreign
    ones are not captured) come back bit for bit through the JAX package's
    record reader, labelled as JAX's capture labels a segmenter's outputs."""
    import io

    from PIL import Image

    from tensorflowdistributedlearning_tpu.data import records as jrecords

    t = runs["torch"]
    want = [jcapture.to_uint8_image(im) for (name, _), x in zip(ANSWERED, t["xs"]) if name == "seg" for im in x]
    label = int(jcapture._label_array({"probabilities": np.zeros((1, 17, 17, 1), np.float32)}, 1)[0])
    paths = sorted(os.path.join(t["capdir"], p) for p in os.listdir(t["capdir"]) if p.endswith(".tfrecord"))
    got = [jrecords.decode_classification_record(payload) for p in paths for payload in jrecords.read_records(p)]
    assert [lab for lab, _ in got] == [label] * len(want)
    assert len(got) == len(want)
    for (_, blob), w in zip(got, want):
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob))), w)
    cap = [e for e in t["events"] if e["event"] == "capture_window"]
    assert cap[-1]["total_captured"] == len(want) and cap[-1]["final"]


def test_jax_telemetry_report_command_renders_the_port_workdir(runs, capsys, tmp_path):
    from tensorflowdistributedlearning_tpu import cli as jcli

    workdir = runs["torch"]["workdir"]
    assert jcli.main(["telemetry-report", workdir, "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["serve"]["completed"] == runs["torch"]["final"]["completed"]
    assert jcli.main(["telemetry-report", workdir]) == 0
    assert "serv" in capsys.readouterr().out.lower()
    out = str(tmp_path / "spans.json")
    assert jcli.main(["telemetry-report", workdir, "--export-trace", out]) == 0
    with open(out) as f:
        assert any(e["name"] == "request" for e in json.load(f)["traceEvents"])
