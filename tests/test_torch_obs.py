"""The port's ``obs/`` modules, ``resilience/faults.py`` and
``serve/registry.py`` against the JAX package's copies: the same inputs
(made from a seed with numpy, stats functions and clocks injected) give the
same events, verdicts and numbers."""

from __future__ import annotations

import json
import os
import re
import signal
import threading

import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.obs import capacity as jcap
from tensorflowdistributedlearning_tpu.obs import health as jhealth
from tensorflowdistributedlearning_tpu.obs import ledger as jledger
from tensorflowdistributedlearning_tpu.obs import metrics as jmetrics
from tensorflowdistributedlearning_tpu.obs import profiler as jprofiler
from tensorflowdistributedlearning_tpu.obs import trace as jtrace
from tensorflowdistributedlearning_tpu.resilience import faults as jfaults
from tensorflowdistributedlearning_tpu.serve import registry as jreg
from tensorflowdistributedlearning_tpu_torch.obs import capacity as tcap
from tensorflowdistributedlearning_tpu_torch.obs import health as thealth
from tensorflowdistributedlearning_tpu_torch.obs import ledger as tledger
from tensorflowdistributedlearning_tpu_torch.obs import metrics as tmetrics
from tensorflowdistributedlearning_tpu_torch.obs import profiler as tprofiler
from tensorflowdistributedlearning_tpu_torch.obs import trace as ttrace
from tensorflowdistributedlearning_tpu_torch.resilience import faults as tfaults
from tensorflowdistributedlearning_tpu_torch.serve import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9


def _close(a, b):
    """Equal structures, floats within TOL."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return a is not None and b is not None and abs(a - b) <= TOL
    return a == b


# -- metrics -----------------------------------------------------------------------------------------


def _fill(mod, rng):
    reg = mod.MetricsRegistry()
    for i in range(40):
        reg.counter(f"serve/c{i % 3}").inc(int(rng[i] * 10) + 1)
        reg.histogram(f"serve/h{i % 2}").record(float(rng[i]))
    reg.gauge("serve/queue_depth").set(7)
    reg.gauge("serve/unset")
    return reg


def test_registry_prometheus_snapshot_and_drain_match_jax():
    rng = np.random.default_rng(0).uniform(0, 0.1, 64)
    j, t = _fill(jmetrics, rng), _fill(tmetrics, rng)
    assert t.render_prometheus() == j.render_prometheus()
    assert _close(t.snapshot(), j.snapshot())
    jw, tw = j.histogram("serve/h0").drain(), t.histogram("serve/h0").drain()
    assert list(tw) == list(jw) and tw.count == jw.count and abs(tw.total_s - jw.total_s) <= TOL
    assert tmetrics.window_count(tw) == jmetrics.window_count(jw) == 20
    # drained, but the lifetime series Prometheus scrapes survive
    assert t.render_prometheus() == j.render_prometheus()
    h = tmetrics.TimeHistogram("x", max_samples=4)
    for s in range(10):
        h.record(s)
    assert h.samples == [6, 7, 8, 9] and h.samples_since(8) == [8, 9] and h.summary()["count"] == 10.0


# -- ledger ------------------------------------------------------------------------------------------


def test_ledger_round_trip_and_readers_match_jax(tmp_path):
    led = tledger.RunLedger(str(tmp_path))
    led.event("run_header", schema_version=1)
    led.event("serve_window", requests=np.int64(3), latency=np.float32(0.5))
    led.event_buffered("trace", name="request")
    led.event("run_header", schema_version=1)
    led.event("run_end", kind="serve")
    led.close()
    with open(led.path, "a") as f:
        f.write('{"event": "torn"')
    got, errors = tledger.read_ledger_with_errors(str(tmp_path))
    assert (got, errors) == jledger.read_ledger_with_errors(str(tmp_path)) and errors == 1
    assert [e["event"] for e in tledger.last_run_events(got)] == ["run_header", "run_end"]
    assert tledger.last_run_events(got) == jledger.last_run_events(got)
    assert got[1]["requests"] == 3 and got[1]["latency"] == 0.5
    for i in range(4):
        assert tledger.per_process_filename(i) == jledger.per_process_filename(i)
    open(tmp_path / "telemetry-2.jsonl", "w").close()
    open(tmp_path / "telemetry-x.jsonl", "w").close()
    assert [os.path.basename(p) for p in tledger.ledger_paths(str(tmp_path))] == ["telemetry.jsonl",
                                                                                  "telemetry-2.jsonl"]


def test_unwritable_workdir_degrades_to_a_warning(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    led = tledger.RunLedger(str(blocker / "sub"))
    assert not led.enabled
    led.event("x")  # no raise


def test_sigterm_flush_chains_with_the_server_drain(monkeypatch, tmp_path):
    """The ledger's flusher runs the handler it replaced; a handler installed
    after it (the server's drain) flushes, runs the handler the flusher
    replaced and skips the flusher's re-raise."""
    from tensorflowdistributedlearning_tpu_torch.serve import server as tserver

    calls = []
    saved = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(tledger, "_CHAINED_SIGTERM", lambda s, f: calls.append("earlier"))
    monkeypatch.setattr(tledger, "flush_all_ledgers", lambda blocking=True: calls.append(("flush", blocking)))
    try:
        tledger.sigterm_flush(signal.SIGTERM, None)
        assert calls == [("flush", False), "earlier"]
        calls.clear()
        signal.signal(signal.SIGTERM, tledger.sigterm_flush)
        drained = threading.Event()
        fake = type("S", (), {"shutdown": lambda self: drained.set()})()
        tserver.ServingServer.install_signal_handlers(fake, (signal.SIGTERM,))
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert drained.wait(5) and calls == [("flush", False), "earlier"]
    finally:
        signal.signal(signal.SIGTERM, saved)


def test_a_handler_set_before_the_first_ledger_still_runs_under_the_server(monkeypatch):
    """An embedding's SIGTERM handler, the ledger's flusher in front of it,
    then the server's drain in front of both: one SIGTERM drains, flushes and
    runs the embedding's handler once."""
    from tensorflowdistributedlearning_tpu_torch.serve import server as tserver

    calls = []
    saved = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(tledger, "_EXIT_HOOKS_INSTALLED", False)
    monkeypatch.setattr(tledger, "_CHAINED_SIGTERM", None)
    monkeypatch.setattr(tledger.atexit, "register", lambda fn: None)
    monkeypatch.setattr(tledger, "flush_all_ledgers", lambda blocking=True: calls.append(("flush", blocking)))
    try:
        signal.signal(signal.SIGTERM, lambda s, f: calls.append("embedding"))
        tledger._install_exit_hooks()
        assert signal.getsignal(signal.SIGTERM) is tledger.sigterm_flush
        drained = threading.Event()
        fake = type("S", (), {"shutdown": lambda self: drained.set()})()
        tserver.ServingServer.install_signal_handlers(fake, (signal.SIGTERM,))
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert drained.wait(5) and calls == [("flush", False), "embedding"]
    finally:
        signal.signal(signal.SIGTERM, saved)


# -- trace -------------------------------------------------------------------------------------------


def test_tracer_sampling_parenting_and_chrome_export_match_jax():
    for mod in (jtrace, ttrace):
        assert not mod.NULL_TRACER.enabled
        with pytest.raises(ValueError):
            mod.Tracer(emit=list.append, sample_rate=1.5)
    out = []
    tr = ttrace.Tracer(emit=out.append, sample_rate=1.0)
    with tr.span("request", trace_id="r1") as root:
        with tr.span("child", attrs={"k": 1}) as child:
            pass
        tr.emit("queue_wait", trace_id="r1", parent_id=root.span_id, start_t=1.0, duration_s=0.5)
    assert child.parent_id == root.span_id and child.trace_id == "r1" and root.children == [child]
    assert [e["name"] for e in out] == ["child", "queue_wait", "request"]
    off = ttrace.Tracer(emit=out.append, sample_rate=1.0)
    with off.span("request", sampled=False):
        with off.span("inner"):
            pass
    assert len(out) == 3  # an unsampled trace persists as a unit: nothing
    events = [{"event": "trace", **e} for e in out] + [{"event": "serve_window"}]
    assert ttrace.export_chrome_trace(events) == jtrace.export_chrome_trace(events)
    assert ttrace.export_chrome_trace([]) == jtrace.export_chrome_trace([])


# -- capacity ----------------------------------------------------------------------------------------


def _stats(peak, limit=None, in_use=None):
    s = {"peak_bytes_in_use": peak, "bytes_in_use": in_use or peak}
    if limit is not None:
        s["bytes_limit"] = limit
    return {"dev0": s}


def test_watermark_tracker_matches_jax_on_a_stats_sequence():
    rng = np.random.default_rng(1)
    peaks = np.cumsum(rng.integers(0, 3, 24)) * 1000 + 5000
    seq = [(_stats(int(p), limit=200_000, in_use=int(p) - 100), ph)
           for p, ph in zip(peaks, np.resize(["compile", "infer", "eval"], 24))]
    state = {}
    j = jcap.WatermarkTracker(stats_fn=lambda: state["s"])
    t = tcap.WatermarkTracker(stats_fn=lambda: state["s"])
    for stats, phase in seq:
        state["s"] = stats
        assert _close(t.sample(str(phase)), j.sample(str(phase)))
        assert _close(t.headroom(), j.headroom())
    assert _close(t.snapshot(), j.snapshot())
    assert tcap.WatermarkTracker(stats_fn=dict).sample("infer") is None
    assert tcap.memory_stats() == {}  # no CUDA context on the CPU: inert


def test_cost_meter_matches_jax_with_the_same_clock(monkeypatch):
    clock = {"t": 100.0}
    monkeypatch.setattr(jcap.time, "monotonic", lambda: clock["t"])
    rng = np.random.default_rng(2)
    j, t = jcap.CostMeter(n_chips=1), tcap.CostMeter(n_chips=1)
    assert j.serve_window() is None and t.serve_window() is None
    windows = []
    for w in range(3):
        for _ in range(int(rng.integers(1, 6))):
            dt, sizes = float(rng.uniform(1e-3, 5e-2)), [int(n) for n in rng.integers(1, 9, rng.integers(1, 5))]
            j.add_batch(dt, sizes)
            t.add_batch(dt, sizes)
        clock["t"] += float(rng.uniform(0.5, 2.0))
        jw, tw = j.serve_window(), t.serve_window()
        assert _close(tw, jw)
        windows.append({"event": "cost", **tw})
        assert _close(t.snapshot(), {k: v for k, v in j.snapshot().items()})
    assert _close(tcap.aggregate_cost_events(windows), jcap.aggregate_cost_events(windows))
    marks = [{"event": "memory_watermark", "phase": "infer", "peak_bytes": 10, "bytes_limit": 100, "step": 3},
             {"event": "memory_watermark", "phase": "compile", "peak_bytes": 30, "headroom_frac": 0.7}]
    assert tcap.aggregate_watermark_events(marks) == jcap.aggregate_watermark_events(marks)
    assert tcap.aggregate_cost_events([]) is None and tcap.CostMeter().n_chips == 1


def test_cost_and_watermarks_count_the_engines_cards_only(monkeypatch):
    """A meter counts the distinct CUDA cards of the engines it is given, not
    the cards the process sees; a CPU engine is one wall-clock chip with no
    device stats."""
    meter = tcap.CostMeter()
    meter.set_devices(["cuda:1", torch.device("cuda", 1), "cuda:3"])
    assert meter.n_chips == 2 and tcap.cuda_indices(["cuda:1", "cpu", None, "cuda:3", "cuda:1"]) == [1, 3]
    meter.set_devices([torch.device("cpu")])
    assert meter.n_chips == 1 and tcap.memory_stats(["cpu"]) == {}
    calls = []
    tracker = tcap.WatermarkTracker()
    tracker.devices = ["cuda:1"]
    monkeypatch.setattr(tcap, "memory_stats", lambda devices=None: calls.append(devices) or _stats(10, limit=100))
    assert tracker.sample("infer")["peak_bytes"] == 10 and calls == [["cuda:1"]]


# -- health ------------------------------------------------------------------------------------------


def test_slo_tracker_verdicts_match_jax():
    rng = np.random.default_rng(3)
    j, t = jhealth.SloTracker(50.0, error_budget=0.05), thealth.SloTracker(50.0, error_budget=0.05)
    for window in range(8):
        n = int(rng.integers(5, 40))
        slow = window in (2, 3, 6)
        for lat in rng.uniform(0.001, 0.12 if slow else 0.045, n):
            j.observe(lat)
            t.observe(lat)
        if window == 5:
            j.observe_violation()
            t.observe_violation()
        jv, tv = j.evaluate(), t.evaluate()
        assert _close(tv, jv) and t.healthy == j.healthy
        assert _close(t.snapshot(), j.snapshot())
    with pytest.raises(ValueError):
        thealth.SloTracker(0)


def test_headroom_monitor_matches_jax():
    j, t = jhealth.HeadroomMonitor(), thealth.HeadroomMonitor()
    for peak, limit, stl in [(10, 100, None), (97, 100, None), (98, 100, 3), (50, 100, None), (50, 100, 20),
                             (0, 100, None), (50, None, None), (60, 100, 400)]:
        assert _close(t.check(7, peak, limit, samples_to_limit=stl), j.check(7, peak, limit, samples_to_limit=stl))
        assert t.degraded == j.degraded and t.last == j.last


def test_drift_monitor_matches_jax():
    baseline = {"outputs": {"probabilities": {"kind": "float", "mean": 0.1, "std": 0.2},
                            "class": {"kind": "integer", "n": 10, "hist": {"0": 0.5, "1": 0.3, "2": 0.2}}}}
    rng = np.random.default_rng(4)
    j = jhealth.DriftMonitor(baseline, threshold=0.3, min_requests=8, sustain_windows=2)
    t = thealth.DriftMonitor(baseline, threshold=0.3, min_requests=8, sustain_windows=2)
    for window in range(7):
        p = [0.05, 0.05, 0.9] if window in (2, 3, 4) else [0.5, 0.3, 0.2]
        for _ in range(int(rng.integers(1, 5))):
            cls = rng.choice(3, size=int(rng.integers(1, 6)), p=p).astype(np.int32)
            j.observe({"class": cls})
            t.observe({"class": cls})
        assert _close(t.evaluate(), j.evaluate()) and _close(t.snapshot(), j.snapshot())
    for mod in (jhealth, thealth):
        with pytest.raises(ValueError, match="no integer output histogram"):
            mod.DriftMonitor({"outputs": {"mask": {"kind": "float", "mean": 0.0, "std": 1.0}}})


# -- faults ------------------------------------------------------------------------------------------

SPECS = ["raise@12", "sigterm@12", "sigterm@5-20", "io-data@3", "io-data@3x2", "io-read@2", "io-ckpt@1",
         "sigkill@30", "sigkill-step@6", "nan-loss@2", "raise@0-1000", "sigkill@2-9x3"]


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_specs_parse_equal(seed):
    for spec in SPECS:
        j, t = jfaults.parse_fault_spec(spec, seed), tfaults.parse_fault_spec(spec, seed)
        assert (t.kind, t.at, t.count, t.site) == (j.kind, j.at, j.count, j.site)
    for bad in ("boom@1", "raise@", "raise@5-2", "io-data@1x0", "sigkill"):
        with pytest.raises(ValueError):
            jfaults.parse_fault_spec(bad)
        with pytest.raises(ValueError):
            tfaults.parse_fault_spec(bad)


def _fires(mod, spec, seed, kills):
    inj = mod.FaultInjector(mod.parse_fault_spec(spec, seed))
    fired = []
    for i in range(1, 40):
        for site in (mod.SITE_STEP, mod.SITE_DATA, mod.SITE_IO, mod.SITE_CHECKPOINT, mod.SITE_REQUEST):
            n = len(kills)
            try:
                inj.fire(site, i)
            except (mod.InjectedFault, mod.TransientInjectedIOError):
                fired.append((site, i))
            if len(kills) > n:
                fired.append((site, i, kills[-1]))
        if inj.poisoned(mod.SITE_LOSS, i):
            fired.append(("loss", i))
    return fired


def test_faults_fire_at_the_same_indices_under_the_same_seed(monkeypatch):
    kills = []
    for mod in (jfaults, tfaults):
        monkeypatch.setattr(mod.os, "kill", lambda pid, sig: kills.append(int(sig)))
    for spec in SPECS:
        for seed in (0, 3):
            assert _fires(tfaults, spec, seed, kills) == _fires(jfaults, spec, seed, kills), spec
    assert tfaults.install(None) is None and tfaults.installed() is None
    tfaults.fire(tfaults.SITE_REQUEST)  # free when nothing is installed
    n = len(kills)
    inj = tfaults.install("sigkill@2")
    try:
        tfaults.fire(tfaults.SITE_REQUEST)
        assert len(kills) == n
        tfaults.fire(tfaults.SITE_REQUEST)
        assert kills[n:] == [int(signal.SIGKILL)] and inj.fired == 1
    finally:
        tfaults.uninstall()


# -- registry ----------------------------------------------------------------------------------------

VALID = [
    {"schema_version": 1, "models": [{"name": "seg", "artifact_dir": "/a"}]},
    {"schema_version": 1, "models": [
        {"name": "seg", "artifact_dir": "/a", "version": 3, "buckets": [16, 1, 4, 4], "prewarm_budget": 2,
         "slo_p99_ms": 40, "slo_error_budget": 0.02, "weight": 2.5, "replicas": 2, "min_replicas": 1,
         "max_replicas": 4, "chips_per_replica": 1, "device_slots": ["0", "1"]},
        {"name": "seg16", "artifact_dir": "/b", "version": 1}]},
]
INVALID = [
    [], {"schema_version": 2, "models": [{"name": "a", "artifact_dir": "/a"}]},
    {"schema_version": 1, "models": []}, {"schema_version": 1, "models": [{"name": "a"}]},
    {"schema_version": 1, "models": [{"artifact_dir": "/a"}]}, {"schema_version": 1, "extra": 1, "models": []},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a", "prewarm_budgit": 1}]},
    {"schema_version": 1, "models": [{"name": "a/b", "artifact_dir": "/a"}]},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a", "version": 0}]},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a", "version": True}]},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a", "buckets": [0]}]},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a", "buckets": 4}]},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a", "slo_p99_ms": -1}]},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a", "max_replicas": 0}]},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a", "device_slots": [""]}]},
    {"schema_version": 1, "models": [{"name": "a", "artifact_dir": "/a"}, {"name": "a", "artifact_dir": "/b"}]},
]


def _read(mod, path):
    try:
        reg = mod.read_registry(os.path.dirname(path), path=path)
    except mod.RegistryError as e:
        return "error", str(e)
    return "ok", reg.to_json(), [(e.name, e.version, e.buckets, e.prewarm_budget, e.device_slot(3))
                                 for e in reg.models.values()]


def test_registry_documents_read_the_same(tmp_path):
    docs = VALID + INVALID
    for i, doc in enumerate(docs):
        path = tmp_path / f"r{i}.json"
        path.write_text(json.dumps(doc))
        t, j = _read(treg, str(path)), _read(jreg, str(path))
        assert t == j, doc
        assert t[0] == ("ok" if i < len(VALID) else "error")
    (tmp_path / "bad.json").write_text("{not json")
    assert _read(treg, str(tmp_path / "bad.json"))[0] == "error"
    implicit = treg.read_registry(str(tmp_path / "none"), default_artifact_dir="/art")
    assert implicit.implicit and implicit.names() == [treg.DEFAULT_MODEL] == [jreg.DEFAULT_MODEL]
    reg = treg.write_registry(str(tmp_path), [treg.ModelEntry(name="m", artifact_dir="/x")])
    assert reg.path == treg.registry_path(str(tmp_path))
    assert jreg.read_registry(str(tmp_path)).to_json() == reg.to_json()
    reg.set_version("m", "/y")
    assert treg.read_registry(str(tmp_path)).entry("m").version == 2
    with pytest.raises(treg.RegistryError):
        reg.set_version("m", "/z", version=1)


# -- profiler buckets --------------------------------------------------------------------------------


# the stated bucket of every kernel of csrc/ (its __global__ symbol): the
# depthwise convolutions and the int8 conv routes are convolutions, the int8
# GEMM and attention (QK^T and PV products) matrix products, BN + act, bias +
# act and sigmoid + mask one elementwise pass over the activations
KERNEL_BUCKETS = {
    "tfdl_depthwise_kernel": "conv",
    "tfdl_depthwise_tiled_kernel": "conv",
    "tfdl_depthwise_dw_partial_kernel": "conv",
    "tfdl_depthwise_dw_sum_kernel": "conv",
    "tfdl_depthwise_dw_band_kernel": "conv",
    "tfdl_depthwise_dw_band_sum_kernel": "conv",
    "tfdl_int8_conv_kernel": "conv",
    "tfdl_int8_conv_tc_kernel": "conv",
    "tfdl_int8_gemm_kernel": "matmul",
    "tfdl_flash_attention_kernel": "matmul",
    "tfdl_flash_attention_f32_kernel": "matmul",
    "tfdl_flash_attention_tc_kernel": "matmul",
    "tfdl_bn_act_kernel": "fusion(elementwise/bn)",
    "tfdl_bn_act_unfolded_kernel": "fusion(elementwise/bn)",
    "tfdl_bn_act_rows_kernel": "fusion(elementwise/bn)",
    "tfdl_bn_act_rows_unfolded_kernel": "fusion(elementwise/bn)",
    "tfdl_bn_act_rows_bf16_kernel": "fusion(elementwise/bn)",
    "tfdl_bias_act_kernel": "fusion(elementwise/bn)",
    "tfdl_bias_act_vec_kernel": "fusion(elementwise/bn)",
    "tfdl_sigmoid_mask_kernel": "fusion(elementwise/bn)",
    "tfdl_sigmoid_mask_vec_kernel": "fusion(elementwise/bn)",
}



def test_every_kernel_has_a_stated_bucket():
    """Each ``__global__`` of csrc/ has a stated bucket (KERNEL_BUCKETS), and
    the profiler's classify_bucket puts its name alone into that bucket; cuDNN convolutions and GEMMs fall in the
    compute buckets, elementwise and copies in the HBM ones."""
    csrc = os.path.join(REPO, "tensorflowdistributedlearning_tpu_torch", "csrc")
    kernels = set()
    for name in os.listdir(csrc):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as f:
                kernels |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(tfdl_\w+)\s*\(", f.read()))
    assert kernels and kernels == set(KERNEL_BUCKETS)
    for name, bucket in KERNEL_BUCKETS.items():
        assert bucket in tprofiler.BUCKET_NEEDLES and bucket in jprofiler.xplane.DEFAULT_GROUPS
        assert tprofiler.classify_bucket(f"void {name}<float, 3>(float const*, int)") == bucket
    library = {
        "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_tilesize128x128x16": "conv",
        "void cudnn::cnn::conv2d_grouped_direct_kernel<float>": "conv",
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x64x8_stage": "matmul",
        "void at::native::vectorized_elementwise_kernel<4, at::native::sigmoid_kernel_cuda>": "fusion(elementwise/bn)",
        "void at::native::reduce_kernel<512, 1>": "reduce",
        "Memcpy HtoD (Pageable -> Device)": "copy/transpose",
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL": "collectives",
        "void nchwToNhwcKernel<float>": "other",
    }
    for name, bucket in library.items():
        assert tprofiler.classify_bucket(name) == bucket, name


def test_roofline_fields_match_jax():
    names = ["void tfdl_depthwise_tiled_kernel<float>", "sm80_xmma_gemm_f32", "void tfdl_bn_act_rows_kernel",
             "Memcpy DtoH (Device -> Pageable)"]
    ms = [3.0, 2.0, 4.0, 1.0]
    rows = [tprofiler.OpTime(n, m, 2, m / 10) for n, m in zip(names, ms)]
    rows.sort(key=lambda r: -r.total_ms)
    out = tprofiler.build_roofline(rows, phase="infer", top=3)
    jrows = [jprofiler.xplane.OpTime(r.name, r.total_ms, r.occurrences, r.fraction) for r in rows]
    jout = jprofiler.build_roofline(jrows, phase="infer", top=3)
    assert set(out) == set(jout) and [set(r) for r in out["top_ops"]] == [set(r) for r in jout["top_ops"]]
    assert out["buckets"] == {"conv": 3.0, "matmul": 2.0, "fusion(elementwise/bn)": 4.0, "copy/transpose": 1.0}
    assert out["classes"] == {"compute_frac": 0.5, "hbm_frac": 0.5, "collective_frac": 0.0}
    assert out["top_hbm_op"]["name"] == "void tfdl_bn_act_rows_kernel" and out["total_ms"] == 10.0


def test_isolation_check_walks_the_new_modules():
    """``tests/test_torch_isolation.py`` parametrises over every file of the
    package: the serve tier's new modules are among them."""
    from tests.test_torch_isolation import _python_files

    files = {os.path.relpath(p, REPO) for p in _python_files()}
    pkg = "tensorflowdistributedlearning_tpu_torch"
    for mod in ("obs/ledger.py", "obs/trace.py", "obs/capacity.py", "obs/health.py", "obs/telemetry.py",
                "obs/profiler.py", "obs/metrics.py", "loop/capture.py", "resilience/faults.py", "serve/registry.py"):
        assert f"{pkg}/{mod}" in files
