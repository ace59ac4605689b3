"""The port's serve path on the CPU: serving closure, artifact, bucketed
engine, micro-batcher, HTTP server and CLI, at a tiny model size."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu_torch import __main__ as cli
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.serve import (
    DeadlineExceededError,
    InferenceEngine,
    MicroBatcher,
    QueueFullError,
    RequestTooLargeError,
    ServerClosedError,
    ServingServer,
    bind_ephemeral,
)
from tensorflowdistributedlearning_tpu_torch.train import serving
from tensorflowdistributedlearning_tpu_torch.utils.devices import resolve_device

TINY = ModelConfig(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=8, input_shape=(17, 17),
                   use_pallas_depthwise=True)


@pytest.fixture(scope="module")
def model():
    return build_model(TINY, "cpu", generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    d = tmp_path_factory.mktemp("artifact")
    serving.export_serving_artifact(model, TINY, str(d))
    return str(d)


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 17, 17, 2)).astype(np.float32)


def _echo_engine(buckets=(1, 4, 16), calls=None, delay=0.0):
    """Engine over a closure that returns its input's row sums."""

    def serve(x):
        if calls is not None:
            calls.append(np.array(x, copy=True))
        if delay:
            time.sleep(delay)
        x = torch.as_tensor(np.asarray(x))
        return {"sum": x.sum(dim=(1, 2, 3)), "x": x}

    return InferenceEngine(serve, (2, 3, 1), buckets=buckets)


# -- serving closure and artifact ------------------------------------------------------


def test_serving_fn_outputs_and_head(model):
    serve = serving.make_serving_fn(model, "cpu")
    out = serve(_x(3))
    assert set(out) == {"probabilities", "mask"}
    p, m = out["probabilities"], out["mask"]
    assert p.shape == m.shape == (3, 17, 17, 1) and p.dtype == m.dtype == torch.float32
    assert torch.equal(m, (p > 0.5).float())
    with torch.inference_mode():
        want = torch.sigmoid(model(torch.from_numpy(_x(3))))
    assert torch.equal(p, want)


def test_serving_fn_honours_nchw(model):
    nhwc = serving.make_serving_fn(model, "cpu")(_x(2))
    nchw = serving.make_serving_fn(model, "cpu", data_format="NCHW")(_x(2).transpose(0, 3, 1, 2))
    assert nchw["probabilities"].shape == (2, 1, 17, 17)
    assert torch.equal(nchw["probabilities"], nhwc["probabilities"].permute(0, 3, 1, 2))
    with pytest.raises(ValueError, match="data format"):
        serving.make_serving_fn(model, "cpu", data_format="HWCN")


def test_artifact_manifest_keys(artifact):
    m = serving.read_manifest(artifact)
    assert m["input_shape"] == [None, 17, 17, 2]
    assert m["input_dtype"] == "float32"
    assert m["outputs"] == {
        "probabilities": {"shape": [None, 17, 17, 1], "dtype": "float32"},
        "mask": {"shape": [None, 17, 17, 1], "dtype": "float32"},
    }
    assert m["platforms"] == ["cuda"] and m["backbone"] == "resnet" and m["data_format"] == "NHWC"
    assert serving.load_config(artifact) == TINY


def test_artifact_round_trip_is_exact(model, artifact):
    loaded = serving.load_serving_artifact(artifact, "cpu")
    direct = serving.make_serving_fn(model, "cpu")
    x = _x(4, seed=1)
    for k in ("probabilities", "mask"):
        assert torch.equal(loaded(x)[k], direct(x)[k])


def test_artifact_of_another_format_is_refused(artifact, tmp_path):
    m = serving.read_manifest(artifact)
    m["format"] = "jax.export serialized StableHLO"
    (tmp_path / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="format"):
        serving.load_serving_artifact(str(tmp_path), "cpu")


# -- device resolution: CUDA by default, never a silent CPU fallback ----------------------


@pytest.mark.parametrize(
    "entry",
    [
        lambda art, m: resolve_device(None),
        lambda art, m: build_model(TINY),
        lambda art, m: serving.make_serving_fn(m),
        lambda art, m: serving.load_serving_artifact(art),
        lambda art, m: InferenceEngine.from_artifact(art),
        lambda art, m: resolve_device("cuda"),
    ],
    ids=["resolve_device", "build_model", "make_serving_fn", "load_serving_artifact", "engine", "explicit_cuda"],
)
def test_entry_points_raise_without_cuda(entry, artifact, model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(artifact, model)


# -- engine --------------------------------------------------------------------------------


def test_engine_padding_leaves_real_rows_unchanged(artifact):
    engine = InferenceEngine.from_artifact(artifact, device="cpu", buckets=(1, 4, 16))
    x = _x(3, seed=2)
    padded = engine.infer(x)
    alone = [engine.infer(x[i:i + 1]) for i in range(3)]
    assert padded["probabilities"].shape == (3, 17, 17, 1)
    for i in range(3):
        np.testing.assert_allclose(padded["probabilities"][i], alone[i]["probabilities"][0], atol=1e-6, rtol=0)
    assert engine.bucket_hits == {1: 3, 4: 1, 16: 0}
    assert engine.padding_waste == {1: 0.0, 4: 0.25}


def test_engine_pads_with_zeros_and_slices():
    calls = []
    engine = _echo_engine(calls=calls)
    x = np.arange(2 * 6, dtype=np.float32).reshape(2, 2, 3, 1)
    out = engine.infer(x)
    assert calls[-1].shape == (4, 2, 3, 1) and not calls[-1][2:].any()
    np.testing.assert_array_equal(out["x"], x)
    engine.infer(np.ones((1, 2, 3, 1), np.float32))
    engine.infer(x[:1])
    assert not calls[-1][1:].any()


def test_engine_rejects_too_large_and_malformed():
    engine = _echo_engine()
    with pytest.raises(RequestTooLargeError):
        engine.infer(np.zeros((17, 2, 3, 1), np.float32))
    with pytest.raises(ValueError, match="shape"):
        engine.infer(np.zeros((1, 3, 3, 1), np.float32))
    with pytest.raises(ValueError, match="empty"):
        engine.select_bucket(0)
    assert [engine.select_bucket(n) for n in (1, 2, 4, 5, 16)] == [1, 4, 4, 16, 16]


def test_engine_warmup_runs_every_bucket():
    calls = []
    engine = _echo_engine(buckets=(4, 1, 16), calls=calls)
    timings = engine.warmup()
    assert sorted(timings) == [1, 4, 16] and engine.warmed
    assert [c.shape[0] for c in calls] == [1, 4, 16]
    assert sum(engine.bucket_hits.values()) == 0


# -- batcher -------------------------------------------------------------------------------


def test_batcher_coalesces_concurrent_requests():
    calls = []
    engine = _echo_engine(calls=calls)
    batcher = MicroBatcher(engine, max_wait_ms=500)
    try:
        reqs = [batcher.submit(np.full((1, 2, 3, 1), i, np.float32)) for i in range(3)]
        results = [r.result(timeout=10) for r in reqs]
    finally:
        batcher.close()
    assert len(calls) == 1 and calls[0].shape[0] == 4  # 3 requests, one bucket-4 batch
    for i, res in enumerate(results):
        assert res["sum"].tolist() == [6.0 * i]
    assert engine.registry.counter("serve/batches").value == 1
    assert engine.registry.counter("serve/completed").value == 3


def test_batcher_sheds_when_the_queue_is_full():
    engine = _echo_engine(delay=0.3)
    batcher = MicroBatcher(engine, max_wait_ms=0, max_queue=2, max_batch_size=1)
    try:
        first = batcher.submit(np.zeros((1, 2, 3, 1), np.float32))
        deadline = time.monotonic() + 10
        while engine.registry.gauge("serve/queue_depth").value != 0 and time.monotonic() < deadline:
            time.sleep(0.005)  # until the worker has taken the first; two more fill the queue
        queued = [batcher.submit(np.zeros((1, 2, 3, 1), np.float32)) for _ in range(2)]
        with pytest.raises(QueueFullError):
            batcher.submit(np.zeros((1, 2, 3, 1), np.float32))
        assert engine.registry.counter("serve/rejected_queue_full").value == 1
        for r in [first, *queued]:
            r.result(timeout=10)
    finally:
        batcher.close()


def test_batcher_deadline_and_drain():
    engine = _echo_engine(delay=0.2)
    batcher = MicroBatcher(engine, max_wait_ms=0, max_batch_size=1)
    first = batcher.submit(np.zeros((1, 2, 3, 1), np.float32))
    late = batcher.submit(np.zeros((1, 2, 3, 1), np.float32), deadline_ms=1)
    kept = batcher.submit(np.zeros((1, 2, 3, 1), np.float32))
    batcher.close(drain=True)
    first.result(timeout=10)
    kept.result(timeout=10)
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=10)
    with pytest.raises(ServerClosedError):
        batcher.submit(np.zeros((1, 2, 3, 1), np.float32))
    assert not batcher._worker.is_alive()


def test_batcher_rejects_oversize_at_submit():
    batcher = MicroBatcher(_echo_engine(), max_batch_size=4)
    try:
        with pytest.raises(RequestTooLargeError):
            batcher.submit(np.zeros((5, 2, 3, 1), np.float32))
        r = batcher.submit(np.zeros((2, 3, 1), np.float32))  # a bare example
        assert r.result(timeout=10)["sum"].shape == (1,)
    finally:
        batcher.close()


# -- HTTP ----------------------------------------------------------------------------------


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json", **(headers or {})}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


@pytest.fixture(scope="module")
def server(artifact):
    engine = InferenceEngine.from_artifact(artifact, device="cpu", buckets=(1, 4))
    engine.warmup()
    batcher = MicroBatcher(engine, max_wait_ms=2)
    srv = ServingServer(engine, batcher, sock=bind_ephemeral("127.0.0.1", 0)).start()
    yield srv
    srv.shutdown()


def test_http_predict_round_trip(server, model):
    x = _x(3, seed=4)
    status, headers, body = _post(server.url + "/v1/predict", {"instances": x.tolist()}, {"x-request-id": "abc"})
    assert status == 200 and body["n"] == 3 and headers.get("x-request-id") == "abc"
    p = np.asarray(body["predictions"]["probabilities"], np.float32)
    m = np.asarray(body["predictions"]["mask"], np.float32)
    assert p.shape == m.shape == (3, 17, 17, 1)
    np.testing.assert_array_equal(m, (p > 0.5).astype(np.float32))
    want = serving.make_serving_fn(model, "cpu")(x)["probabilities"].numpy()
    np.testing.assert_allclose(p, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "payload,status,code",
    [
        ({"instances": np.zeros((5, 17, 17, 2)).tolist()}, 413, "request_too_large"),
        ({"instances": np.zeros((1, 5, 5, 2)).tolist()}, 400, "bad_request"),
        ({"nothing": 1}, 400, "bad_request"),
        ({"instances": [[1, 2], [3]]}, 400, "bad_request"),
        ({"instances": np.zeros((1, 17, 17, 2)).tolist(), "deadline_ms": "soon"}, 400, "bad_request"),
    ],
    ids=["413", "wrong_shape", "no_instances", "ragged", "bad_deadline"],
)
def test_http_structured_errors(server, payload, status, code):
    got, headers, body = _post(server.url + "/v1/predict", payload)
    assert got == status
    assert body["error"]["code"] == code and body["error"]["request_id"] == headers.get("x-request-id")


def test_http_healthz_metrics_and_404(server):
    with urllib.request.urlopen(server.url + "/healthz", timeout=10) as r:
        health = json.loads(r.read())
    assert health["ok"] is True and health["status"] == "ok" and health["buckets"] == [1, 4]
    _post(server.url + "/v1/predict", {"instances": _x(1).tolist()})
    with urllib.request.urlopen(server.url + "/metrics", timeout=10) as r:
        metrics = json.loads(r.read())
    assert metrics["buckets"]["1"] >= 1 and metrics["registry"]["counters"]["serve/completed"] >= 1
    assert "serve/request" in metrics["registry"]["histograms"]
    status, _, body = _post(server.url + "/v2/other", {})
    assert status == 404 and body["error"]["code"] == "not_found"


def test_http_429_carries_retry_after():
    engine = _echo_engine(delay=1.0)
    batcher = MicroBatcher(engine, max_wait_ms=0, max_queue=1, max_batch_size=1)
    srv = ServingServer(engine, batcher).start()
    url = srv.url + "/v1/predict"
    try:
        one = {"instances": np.zeros((1, 2, 3, 1)).tolist()}
        results = []
        threads = [threading.Thread(target=lambda: results.append(_post(url, one))) for _ in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        shed = [r for r in results if r[0] == 429]
        assert shed and all(r[2]["error"]["code"] == "queue_full" for r in shed)
        assert all(int(r[1]["Retry-After"]) >= 1 for r in shed)
        assert any(r[0] == 200 for r in results)
    finally:
        srv.shutdown()


def test_shutdown_drains_and_then_refuses():
    engine = _echo_engine(delay=0.2)
    batcher = MicroBatcher(engine, max_wait_ms=0, max_batch_size=1)
    srv = ServingServer(engine, batcher).start()
    url = srv.url + "/v1/predict"
    results = []
    t = threading.Thread(target=lambda: results.append(_post(url, {"instances": np.zeros((1, 2, 3, 1)).tolist()})))
    t.start()
    time.sleep(0.05)
    srv.shutdown()
    t.join(timeout=30)
    assert results and results[0][0] == 200  # accepted before the drain: answered
    assert srv.draining and srv.health_status == "draining"
    with pytest.raises(ServerClosedError):
        batcher.submit(np.zeros((1, 2, 3, 1), np.float32))


# -- CLI -----------------------------------------------------------------------------------


def test_cli_convert_writes_a_servable_artifact(tmp_path):
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from tensorflowdistributedlearning_tpu.config import ModelConfig as JCfg
    from tensorflowdistributedlearning_tpu.models import build_model as jbuild

    kw = dict(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=8, input_shape=(17, 17))
    jm = jbuild(JCfg(**kw))
    v = jm.init(jax.random.key(1), jnp.zeros((1, 17, 17, 2)), train=False)
    np.savez(tmp_path / "vars.npz", **{k: np.asarray(a) for k, a in flatten_dict(dict(v), sep="/").items()})
    cfg = ModelConfig(**kw, use_pallas_depthwise=True)
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    out = tmp_path / "art"
    rc = cli.main(["convert", "--params", str(tmp_path / "vars.npz"), "--config", str(tmp_path / "cfg.json"),
                   "--out", str(out)])
    assert rc == 0
    x = _x(2, seed=5)
    got = serving.load_serving_artifact(str(out), "cpu")(x)["probabilities"].numpy()
    logits = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, 1.0 / (1.0 + np.exp(-logits)), atol=1e-5)


def test_cli_parser_serve_flags():
    args = cli.build_parser().parse_args(
        ["serve", "--artifact-dir", "A", "--port", "0", "--buckets", "1", "8", "--max-wait-ms", "2",
         "--queue-size", "7", "--device", "cpu"]
    )
    assert (args.artifact_dir, args.port, args.buckets, args.max_wait_ms, args.queue_size, args.device) == (
        "A", 0, [1, 8], 2.0, 7, "cpu"
    )
    assert args.fn is cli.cmd_serve
