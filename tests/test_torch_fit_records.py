"""The port's ``fit`` on record shards and ImageFolder splits (``train/fit.py``
with ``data/records.py``, ``data/service.py`` and ``data/imagefolder.py``)
against the JAX package's, on the CPU, with the tiny ViT of
``tests/test_torch_fit.py`` (16x16x3, 10 classes, no augmentation).

- The train stream: the batches the default ``fit`` (the data service, 2
  workers) hands its step are JAX's, bit for bit, for 3 steps and after a
  resume from the sidecar; a resumed run is the uninterrupted run bit for
  bit (parameters and EMA); the sidecars are JAX's, and the final eval
  loss (AdamW from JAX's init, as in ``tests/test_torch_fit.py``) is
  within 1e-5 of JAX's.
- The holdout: ``eval_holdout_fraction`` takes JAX's shards.
- ``_evaluate_records`` on weights carried across by ``utils/convert``
  (``from_flax``) gives JAX's metrics within 1e-5, over an eval set whose
  last batch is padding (``valid = 0`` rows counted out).
- The legacy stream refuses a service sidecar; the ``fit`` command trains
  from records and from an ImageFolder split.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

import tensorflowdistributedlearning_tpu.models.vit as jvit
from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.data import service as jsvc
from tensorflowdistributedlearning_tpu.train import fit as jfit
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import imagefolder as timf
from tensorflowdistributedlearning_tpu_torch.data import records as trec
from tensorflowdistributedlearning_tpu_torch.data import service as tsvc
from tensorflowdistributedlearning_tpu_torch.train import fit as tfit
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY = worker.VIT_TINY
ADAMW = worker.VIT_ADAMW
N_RECORDS = 60
N_SHARDS = 8


def _class_images(n, hw, num_classes, seed):
    """Class-conditional images: brightness ~ (k + 0.5) / K, noise 40."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    images = [np.clip(rng.normal((k + 0.5) / num_classes * 255, 40, (hw, hw, 3)), 0, 255).astype(np.uint8)
              for k in labels]
    return images, [int(k) for k in labels]


@pytest.fixture(scope="module")
def records_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("records"))
    images, labels = _class_images(N_RECORDS, 16, 10, 5)
    trec.write_classification_shards(root, images, labels, shards=N_SHARDS)
    return root


def _recording(mp, lib, sink):
    real = lib.StreamingDataService.batches

    def batches(self, steps=None):
        for b in real(self, steps):
            sink.append({k: v.copy() for k, v in b.items()})
            yield b

    mp.setattr(lib.StreamingDataService, "batches", batches)


@pytest.fixture(scope="module")
def fitted(records_dir, tmp_path_factory):
    """JAX's fit and the port's from JAX's init on the records with a 0.25
    holdout: 3 steps at batch 8 (checkpoints at 2 and 3), then a resume to
    5; the service batches each handed its step."""
    root = tmp_path_factory.mktemp("fit")
    common = dict(ADAMW, checkpoint_every_steps=2, n_devices=1, seed=3, eval_holdout_fraction=0.25)
    mp = pytest.MonkeyPatch()
    mp.setattr(jvit, "_fused_platform_ok", lambda: True)
    streams = {"jax": {}, "port": {}}
    try:
        make_jax = lambda: jfit.ClassifierTrainer(  # noqa: E731
            str(root / "jax"), records_dir, jconfig.ModelConfig(**TINY), jconfig.TrainConfig(**common, telemetry=False))
        jt = make_jax()
        init = jax.device_get(jt._host_template().params)
        cfg = ModelConfig(**TINY)

        def make_port():
            pt = tfit.ClassifierTrainer(str(root / "port"), records_dir, cfg, TrainConfig(**common), device="cpu")
            pt._init_state = lambda: pt._counted(create_train_state(
                cfg, pt.train_config, "cpu", state_dict=from_flax(init, {}, cfg)))
            return pt

        results = {}
        for name, lib, make in (("jax", jsvc, make_jax), ("port", tsvc, make_port)):
            for phase, steps in (("first", 3), ("resumed", 5)):
                streams[name][phase] = []
                inner = pytest.MonkeyPatch()
                _recording(inner, lib, streams[name][phase])
                try:
                    results[name, phase] = make().fit(batch_size=8, steps=steps)
                finally:
                    inner.undo()
    finally:
        mp.undo()
    return dict(root=root, streams=streams, results=results, cfg=cfg, common=common)


def test_default_fit_feeds_jaxs_record_batches(fitted):
    s = fitted["streams"]
    assert len(s["port"]["first"]) == 3 and len(s["port"]["resumed"]) == 2
    for phase in ("first", "resumed"):
        for a, b in zip(s["port"][phase], s["jax"][phase], strict=True):
            assert sorted(a) == sorted(b) == ["images", "labels", "valid"]
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (phase, k)


def test_fit_writes_jaxs_sidecars_and_metrics(fitted):
    root = fitted["root"]
    for step in (4, 5):
        got = json.load(open(root / "port" / "checkpoints" / f"data_state-{step}.json"))
        assert got == json.load(open(root / "jax" / "checkpoints" / f"data_state-{step}.json"))
    assert json.load(open(root / "port" / "checkpoints" / "data_state-5.json"))["batch_index"] == 5
    r = fitted["results"]
    for phase in ("first", "resumed"):
        got, want = r["port", phase].final_metrics, r["jax", phase].final_metrics
        assert sorted(got) == sorted(want)
        assert abs(got["loss"] - want["loss"]) <= 1e-5, (got, want)


def test_holdout_takes_jaxs_shards(records_dir, tmp_path):
    for frac in (0.1, 0.25, 0.5):
        tcfg = dict(ADAMW, eval_holdout_fraction=frac)
        jt = jfit.ClassifierTrainer(str(tmp_path / "j"), records_dir, jconfig.ModelConfig(**TINY),
                                    jconfig.TrainConfig(**tcfg, telemetry=False))
        pt = tfit.ClassifierTrainer(str(tmp_path / "p"), records_dir, ModelConfig(**TINY), TrainConfig(**tcfg),
                                    device="cpu")
        for split, host_shard in (("train", False), ("train", True), ("val", True)):
            got = pt._open_records(split, host_shard=host_shard).paths
            assert got == jt._open_records(split, host_shard=host_shard).paths
        assert len(pt._open_records("val").paths) == max(1, int(np.ceil(frac * N_SHARDS)))
    pt = tfit.ClassifierTrainer(str(tmp_path / "p"), records_dir, ModelConfig(**TINY),
                                TrainConfig(**dict(ADAMW, eval_holdout_fraction=0.95)), device="cpu")
    with pytest.raises(ValueError, match="leaving none to train on"):
        pt.fit(batch_size=8, steps=1)


def test_evaluate_records_matches_jax_on_carried_weights(fitted, records_dir, tmp_path):
    """14 held-out records at batch 8: the second batch holds 6 valid rows
    and two wrapped pad rows."""
    tcfg = dict(fitted["common"], eval_holdout_fraction=0.25)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvit, "_fused_platform_ok", lambda: True)
        jt = jfit.ClassifierTrainer(str(tmp_path / "j"), records_dir, jconfig.ModelConfig(**TINY),
                                    jconfig.TrainConfig(**tcfg, telemetry=False))
        jstate = jt._init_state()
        ds = jt._open_records("val")
        want = jt._evaluate_records(jstate.replace(opt_state=None), ds, 8)
        params = jax.device_get(jstate.params)
    cfg = fitted["cfg"]
    pt = tfit.ClassifierTrainer(str(tmp_path / "p"), records_dir, cfg, TrainConfig(**tcfg), device="cpu")
    state = create_train_state(cfg, pt.train_config, "cpu", state_dict=from_flax(params, {}, cfg))
    pds = pt._open_records("val")
    assert pds.paths == ds.paths and trec.count_records(pds.paths) == 14
    batches = list(pds.batches(8, repeat=False, pad_to_batches=2))
    assert [float(b["valid"].sum()) for b in batches] == [8.0, 6.0]
    got = pt._evaluate_records(state, pds, 8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - float(want[k])) <= 1e-5, (k, got[k], want[k])


def test_record_fit_resumes_to_the_uninterrupted_run(records_dir, tmp_path):
    cfg = ModelConfig(**TINY)
    tcfg = TrainConfig(**dict(ADAMW, augmentation="flip_crop"), checkpoint_every_steps=2, ema_decay=0.9,
                       eval_holdout_fraction=0.25)
    whole = tfit.ClassifierTrainer(str(tmp_path / "whole"), records_dir, cfg, tcfg, device="cpu")
    whole.fit(batch_size=8, steps=4)
    for steps in (2, 4):
        tfit.ClassifierTrainer(str(tmp_path / "part"), records_dir, cfg, tcfg, device="cpu").fit(batch_size=8,
                                                                                                steps=steps)
    a = whole._checkpointer().restore_latest(whole._template_state())
    b = tfit.ClassifierTrainer(str(tmp_path / "part"), records_dir, cfg, tcfg, device="cpu")
    b = b._checkpointer().restore_latest(b._template_state())
    for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for n in a.ema:
        assert torch.equal(a.ema[n], b.ema[n]), n
    assert sorted(f for f in os.listdir(tmp_path / "part" / "checkpoints") if f.startswith("data_state")) == \
        ["data_state-2.json", "data_state-4.json"]
    # the legacy stream refuses a checkpoint the service wrote
    legacy = tfit.ClassifierTrainer(str(tmp_path / "part"), records_dir, cfg,
                                    dataclasses.replace(tcfg, data_service_workers=0), device="cpu")
    with pytest.raises(ValueError, match="data-service resume sidecar"):
        legacy.fit(batch_size=8, steps=6)


def test_legacy_record_stream_is_jaxs(records_dir, tmp_path):
    """data_service_workers=0: this rank's shards through
    ClassificationRecords, the resume step folded into the seed."""
    tcfg = dict(ADAMW, seed=3, data_service_workers=0)
    jt = jfit.ClassifierTrainer(str(tmp_path / "j"), records_dir, jconfig.ModelConfig(**TINY),
                                jconfig.TrainConfig(**tcfg, telemetry=False))
    pt = tfit.ClassifierTrainer(str(tmp_path / "p"), records_dir, ModelConfig(**TINY), TrainConfig(**tcfg),
                                device="cpu")
    got, service = pt._train_stream(8, 3, start_step=2)
    assert service is None
    for a, b in zip(got, jt._train_stream(8, 3, start_step=2), strict=True):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.fixture
def folder(tmp_path):
    root = tmp_path / "folder"
    timf.write_synthetic_imagefolder(str(root / "train"), 4, 6, (16, 16), seed=0)
    timf.write_synthetic_imagefolder(str(root / "val"), 4, 3, (16, 16), seed=1)
    return str(root)


def test_imagefolder_fit_streams_are_jaxs(folder, tmp_path):
    tcfg = dict(ADAMW, seed=3)
    cfg = dict(TINY, num_classes=4)
    jt = jfit.ClassifierTrainer(str(tmp_path / "j"), folder, jconfig.ModelConfig(**cfg),
                                jconfig.TrainConfig(**tcfg, telemetry=False))
    pt = tfit.ClassifierTrainer(str(tmp_path / "p"), folder, ModelConfig(**cfg), TrainConfig(**tcfg), device="cpu")
    got, service = pt._train_stream(8, 4, start_step=1)
    assert service is None
    for a, b in zip(got, jt._train_stream(8, 4, start_step=1), strict=True):
        assert sorted(a) == sorted(b) == ["images", "labels"]
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    res = pt.fit(batch_size=8, steps=2)
    assert res.steps == 2 and all(np.isfinite(v) for v in res.final_metrics.values())


@pytest.fixture
def tiny_preset(monkeypatch):
    preset = tconfigs.Preset(model=ModelConfig(**TINY), train=TrainConfig(**ADAMW, checkpoint_every_steps=2),
                             global_batch=8, description="tiny ViT for the CPU tests")
    monkeypatch.setitem(tconfigs.PRESETS, "tiny_vit_cpu", preset)
    return "tiny_vit_cpu"


def _fit_command(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli_main(["fit", *args, "--device", "cpu"]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_fit_command_reads_records_and_an_imagefolder(tiny_preset, records_dir, folder, tmp_path, monkeypatch):
    seen = []
    real = tfit.ClassifierTrainer.__init__

    def recording(self, *args, **kwargs):
        real(self, *args, **kwargs)
        seen.append(self.train_config)

    monkeypatch.setattr(tfit.ClassifierTrainer, "__init__", recording)
    summary = _fit_command(["--preset", tiny_preset, "--model-dir", str(tmp_path / "r"), "--data-dir", records_dir,
                            "--steps", "2", "--batch-size", "8", "--eval-holdout-fraction", "0.25",
                            "--data-workers", "3"])
    assert summary["steps"] == 2 and sorted(summary["final_metrics"]) == ["loss", "metrics/top1", "metrics/top5"]
    assert (seen[-1].eval_holdout_fraction, seen[-1].data_service_workers) == (0.25, 3)
    assert os.path.exists(tmp_path / "r" / "checkpoints" / "data_state-2.json")
    summary = _fit_command(["--preset", tiny_preset, "--model-dir", str(tmp_path / "f"), "--data-dir", folder,
                            "--steps", "2", "--batch-size", "8"])
    assert summary["steps"] == 2 and seen[-1].data_service_workers == 2
    assert not os.path.exists(tmp_path / "f" / "checkpoints" / "data_state-2.json")
