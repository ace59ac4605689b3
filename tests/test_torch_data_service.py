"""The port's streaming data service (``data/service.py``), its checkpoint
sidecar (``train/checkpoint.py``) and ``Trainer.train``'s service-fed fold
stream, against the JAX package's, on the CPU.

Bit for bit: ``epoch_shard_assignment``; the service's batches over record
shards and over in-memory arrays with 1, 2 and 3 workers, from batch 0 and
from a resume point; the sidecar's JSON and its mismatch errors; the
batches the default ``Trainer.train`` hands its step, for 3 steps and after
a resume from the sidecar. The threads stop on ``close()``, on an abandoned
generator and on a worker's error.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.data import service as jsvc
from tensorflowdistributedlearning_tpu.train import checkpoint as jckpt
from tensorflowdistributedlearning_tpu.train import trainer as jtrainer
from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import records as trec
from tensorflowdistributedlearning_tpu_torch.data import service as tsvc
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tests.conftest import make_salt_dataset
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


HW = 12


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """40 records of 12x12 RGB, 5 classes, in 3 shards."""
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, (HW, HW, 3), dtype=np.uint8) for _ in range(40)]
    labels = list(rng.integers(0, 5, 40))
    return trec.write_classification_shards(str(tmp_path_factory.mktemp("shards")), images, labels, shards=3)


def _source(lib, paths, index=0, count=1, num_classes=5):
    return lib.ClassificationRecordSource(paths, image_shape=(HW, HW), channels=3, num_classes=num_classes,
                                          process_index=index, process_count=count)


def _arrays():
    rng = np.random.default_rng(0)
    return {"images": rng.normal(size=(10, 8, 8, 1)).astype(np.float32),
            "masks": (rng.uniform(size=(10, 8, 8, 1)) > 0.5).astype(np.float32)}


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


def test_epoch_shard_assignment_matches_jax(shards):
    paths = [f"s{i:02d}" for i in range(7)]
    for seed in (0, 7, 123):
        for epoch in range(4):
            for count in (1, 2, 3, 7):
                for index in range(count):
                    kw = dict(seed=seed, epoch=epoch, process_index=index, process_count=count)
                    assert tsvc.epoch_shard_assignment(paths, **kw) == jsvc.epoch_shard_assignment(paths, **kw)
    with pytest.raises(ValueError, match="bad process slot"):
        tsvc.epoch_shard_assignment(paths, seed=0, epoch=0, process_index=2, process_count=2)


@pytest.mark.parametrize("workers", [1, 2, 3])
@pytest.mark.parametrize("start", [0, 4])
def test_record_service_batches_match_jax(shards, workers, start):
    want = list(jsvc.StreamingDataService(_source(jsvc, shards), batch_size=8, seed=7, workers=2,
                                          start_batch=start).batches(steps=9))
    got = list(tsvc.StreamingDataService(_source(tsvc, shards), batch_size=8, seed=7, workers=workers,
                                         start_batch=start).batches(steps=9))
    _same(got, want)


def test_record_service_two_process_slots_match_jax(shards):
    for index in range(2):
        want = list(jsvc.StreamingDataService(_source(jsvc, shards, index, 2), batch_size=5, seed=3,
                                              workers=1).batches(steps=6))
        got = list(tsvc.StreamingDataService(_source(tsvc, shards, index, 2), batch_size=5, seed=3,
                                             workers=2).batches(steps=6))
        _same(got, want)
    sizes = [_source(tsvc, shards, p, 2).epoch_size(3, 0) for p in range(2)]
    assert sum(sizes) == 40 and all(sizes)
    with pytest.raises(ValueError, match="every process needs at least one"):
        _source(tsvc, shards[:1], 0, 2)


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_array_service_batches_match_jax(workers):
    want = list(jsvc.StreamingDataService(jsvc.ArrayBatchSource(_arrays()), batch_size=4, seed=3,
                                          workers=1, start_batch=2).batches(steps=7))
    got = list(tsvc.StreamingDataService(tsvc.ArrayBatchSource(_arrays()), batch_size=4, seed=3,
                                         workers=workers, start_batch=2).batches(steps=7))
    _same(got, want)


def test_sidecar_json_and_mismatch_errors_match_jax(shards):
    kw = dict(batch_size=8, seed=7, workers=1, start_batch=4)
    state = tsvc.StreamingDataService(_source(tsvc, shards), **kw).state(4)
    want = jsvc.StreamingDataService(_source(jsvc, shards), **kw).state(4)
    assert json.dumps(state.to_json()) == json.dumps(want.to_json())
    assert tsvc.DataServiceState.from_json(json.loads(json.dumps(state.to_json()))) == state
    tsvc.StreamingDataService(_source(tsvc, shards), resume_state=state.to_json(), **kw).close()
    for change in (dict(seed=8), dict(batch_size=16), dict(start_batch=5), dict(paths=shards[:-1])):
        paths = change.pop("paths", shards)
        args = dict(kw, **change)
        errors = []
        for lib in (tsvc, jsvc):
            with pytest.raises(ValueError, match="resume state mismatch") as e:
                lib.StreamingDataService(_source(lib, paths), resume_state=state.to_json(), **args)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_a_world_resize_re_deals_as_in_jax(shards):
    state = tsvc.StreamingDataService(_source(tsvc, shards), batch_size=8, seed=7, start_batch=4).state(4)
    redeals = []
    for lib in (tsvc, jsvc):
        service = lib.StreamingDataService(_source(lib, shards, 1, 3), batch_size=8, seed=7, start_batch=4,
                                           resume_state=state.to_json())
        redeals.append(service.redeal)
        service.close()
    assert redeals[0] == redeals[1] == {"old_process_count": 1, "new_process_count": 3, "batch_index": 4}


def test_a_registry_is_refused_until_the_telemetry_is_ported(shards):
    """Once refused (queue A 13), a ``registry`` now takes the service's
    queues under the JAX package's names, as JAX's does on the same
    shards: the workers gauge, one ready-depth sample per take and one
    busy-time sample per batch (their values are timings and depths, the
    same in kind), and at most one underrun per take after the first."""
    from tensorflowdistributedlearning_tpu.obs import metrics as jmetrics
    from tensorflowdistributedlearning_tpu.obs import telemetry as jtm
    from tensorflowdistributedlearning_tpu_torch.obs import metrics as tmetrics
    from tensorflowdistributedlearning_tpu_torch.obs import telemetry as ttm

    seen = []
    for lib, metrics, tm in ((tsvc, tmetrics, ttm), (jsvc, jmetrics, jtm)):
        registry = metrics.MetricsRegistry()
        batches = list(lib.StreamingDataService(_source(lib, shards), batch_size=8, seed=7, workers=2,
                                                registry=registry).batches(steps=6))
        hists = {name: registry.histogram(name).drain() for name in (
            tm.DATA_READY_HISTOGRAM, tm.DATA_UNDERRUN_HISTOGRAM, tm.DATA_WORKER_BUSY_HISTOGRAM)}
        under = hists[tm.DATA_UNDERRUN_HISTOGRAM]
        assert metrics.window_count(under) <= 5 and set(under) <= {1.0}
        assert all(v >= 0 for v in hists[tm.DATA_READY_HISTOGRAM] + hists[tm.DATA_WORKER_BUSY_HISTOGRAM])
        seen.append(([b["labels"].tolist() for b in batches], registry.gauge(tm.DATA_WORKERS_GAUGE).value,
                     metrics.window_count(hists[tm.DATA_READY_HISTOGRAM]),
                     metrics.window_count(hists[tm.DATA_WORKER_BUSY_HISTOGRAM]),
                     sorted(registry.snapshot().get("histograms", {}))))
    assert ttm.DATA_READY_HISTOGRAM == jtm.DATA_READY_HISTOGRAM == "data_service/ready_depth"
    assert seen[0] == seen[1] and seen[0][1:4] == (2, 6, 6)


def test_worker_error_reaches_the_consumer(shards):
    service = tsvc.StreamingDataService(_source(tsvc, shards, num_classes=2), batch_size=8, seed=7, workers=2)
    with pytest.raises(ValueError, match="label out of range"):
        list(service.batches(steps=4))
    _joined()


def _joined():
    """Wait up to 5 s for every service worker thread of the process to end."""
    deadline = time.time() + 5
    while any(t.name.startswith("data-service-") for t in threading.enumerate()):
        assert time.time() < deadline, "service workers leaked"
        time.sleep(0.02)


def test_close_ends_a_waiting_consumer_and_abandoning_releases_workers(shards):
    service = tsvc.StreamingDataService(_source(tsvc, shards), batch_size=8, seed=7, workers=1)
    stream = service.batches(steps=1000)
    next(stream)
    t = threading.Thread(target=lambda: [None for _ in stream], daemon=True)
    t.start()
    time.sleep(0.2)
    service.close()
    t.join(timeout=5)
    assert not t.is_alive(), "consumer still blocked after close()"
    other = tsvc.StreamingDataService(_source(tsvc, shards), batch_size=8, seed=7, workers=3)
    stream = other.batches(steps=50)
    next(stream)
    stream.close()
    _joined()
    with pytest.raises(RuntimeError, match="single-shot"):
        other.batches()


def test_sidecar_files_match_jax_and_tolerate_garbage(tmp_path):
    state = {"seed": 1, "batch_index": 4, "epoch": 0, "batch_size": 8}
    port = CheckpointManager(str(tmp_path / "port"))
    jax_ckpt = jckpt.CheckpointManager(str(tmp_path / "jax"))
    try:
        for m in (port, jax_ckpt):
            m.save_data_state(4, state)
            m.save_data_state(6, state)
        files = sorted(os.listdir(tmp_path / "port" / "checkpoints"))
        jfiles = sorted(f for f in os.listdir(tmp_path / "jax" / "checkpoints") if f.startswith("data_state"))
        # no checkpoint kept: the older sidecar was pruned
        assert files == jfiles == ["data_state-6.json"]
        assert (tmp_path / "port" / "checkpoints" / files[0]).read_bytes() == \
            (tmp_path / "jax" / "checkpoints" / files[0]).read_bytes()
        assert port.restore_data_state(6) == jax_ckpt.restore_data_state(6) == {"step": 6, **state}
        assert port.restore_data_state(9) is None
        for step, text in ((8, json.dumps([1, 2, 3])), (10, "{not json")):
            open(port._data_state_path(step), "w").write(text)
            assert port.restore_data_state(step) is None
    finally:
        jax_ckpt.close()


# -- Trainer.train's fold stream ---------------------------------------------------

TINY = dict(n_blocks=(1, 1, 1), input_shape=(32, 32), base_depth=8, width_multiplier=0.125)


def _recording(monkeypatch, lib, sink):
    real = lib.StreamingDataService.batches

    def batches(self, steps=None):
        for b in real(self, steps):
            sink.append({k: v.copy() for k, v in b.items()})
            yield b

    monkeypatch.setattr(lib.StreamingDataService, "batches", batches)


@pytest.fixture(scope="module")
def fold_streams(tmp_path_factory):
    """The batches both default trainers hand their steps: 3 steps per fold
    (a checkpoint and its sidecar at 2 and 3), then a resume to 5 steps."""
    data, _, ids = make_salt_dataset(tmp_path_factory.mktemp("salt"), n_images=16, shape=(32, 32))
    common = dict(n_folds=2, seed=0, checkpoint_every_steps=2, eval_throttle_secs=0, save_best=2)
    assert TrainConfig().data_service_workers == jconfig.TrainConfig().data_service_workers == 2
    got, want = {}, {}
    mp = pytest.MonkeyPatch()
    try:
        for sink, lib, make in (
            (got, tsvc, lambda d: Trainer(d, data, train_config=TrainConfig(**common), device="cpu", **TINY)),
            (want, jsvc, lambda d: jtrainer.Trainer(d, data, train_config=jconfig.TrainConfig(
                **common, n_devices=1, telemetry=False), **TINY)),
        ):
            model_dir = str(tmp_path_factory.mktemp("model"))
            for phase, steps in (("first", 3), ("resumed", 5)):
                sink[phase] = []
                _recording(mp, lib, sink[phase])
                make(model_dir).train(ids, batch_size=4, steps=steps)
                mp.undo()
            sink["sidecar"] = json.load(open(os.path.join(model_dir, "fold1", "checkpoints", "data_state-5.json")))
    finally:
        mp.undo()
    return got, want


def test_default_trainer_feeds_jaxs_fold_batches(fold_streams):
    got, want = fold_streams
    assert len(got["first"]) == 2 * 3 and len(got["resumed"]) == 2 * 2
    _same(got["first"], want["first"])
    assert sorted(got["first"][0]) == ["images", "masks"] and got["first"][0]["images"].shape == (4, 32, 32, 1)


def test_resumed_folds_replay_jaxs_remaining_stream(fold_streams):
    got, want = fold_streams
    _same(got["resumed"], want["resumed"])
    assert got["sidecar"] == want["sidecar"]
    assert got["sidecar"]["batch_index"] == 5 and got["sidecar"]["process_count"] == 1


def test_data_workers_zero_keeps_the_in_line_stream(tmp_path, monkeypatch):
    data, _, ids = make_salt_dataset(tmp_path, n_images=8, shape=(32, 32))
    monkeypatch.setattr(tsvc, "StreamingDataService", None)  # any use would raise
    tcfg = TrainConfig(n_folds=2, seed=0, checkpoint_every_steps=2, eval_throttle_secs=0, data_service_workers=0)
    Trainer(str(tmp_path / "m"), data, train_config=tcfg, device="cpu", **TINY).train(ids, batch_size=4, steps=2)
    assert not [f for f in os.listdir(tmp_path / "m" / "fold0" / "checkpoints") if f.startswith("data_state")]
