"""The port's ``ClassifierTrainer`` and ``fit`` command (``train/fit.py``,
``__main__.py``) against the JAX package's, on the CPU.

A tiny ViT (16x16x3 input, patch 4, embed 32, 2 heads of 16, 2 layers, 10
classes, fused attention) trains on the index-keyed synthetic stream, which
is a verbatim copy in both packages, so one seed gives both the same
batches. Tolerances, stated where used:

- ``fit`` against JAX's ``fit`` (3 AdamW steps from one flax init, no
  augmentation: the two packages cannot draw the same augmentations): the
  same checkpoint steps, eval steps and best step; the final loss 1e-5;
  final parameters within 0.01·lr per step in the mean over all entries and
  2·lr per step for every entry. The ViT has no sort and no BatchNorm, so
  a step from equal parameters agrees to float32 noise (mean 4e-3·lr over
  one step, ``tests/test_torch_vit_train_step.py``); the segmenter's
  multi-step bound is 0.05·lr per step; every-entry 2·lr per step is
  Adam's own (an entry whose gradient is at the noise floor moves
  ``lr·sign(g)`` either way);
- resume: bit for bit the uninterrupted run (one process, one device, the
  same batches and augmentation draws);
- two gloo ranks' first step against the single-process step on the whole
  batch: loss 1e-6; each averaged gradient leaf ``1e-5·max|g_leaf| +
  1e-7`` (the mean of two half-batch sums against one whole-batch sum);
  parameters as one Adam step from equal parameters (mean 0.05·lr, every
  entry 2·lr).
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
from tensorflowdistributedlearning_tpu.train import fit as jfit
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tensorflowdistributedlearning_tpu_torch.train import fit as tfit
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY = worker.VIT_TINY
ADAMW = worker.VIT_ADAMW
LR = ADAMW["lr"]


def _steps(path):
    return sorted(int(d) for d in os.listdir(path) if d.isdigit()) if os.path.isdir(path) else []


def _files(model_dir):
    return {k: _steps(os.path.join(model_dir, *sub)) for k, sub in
            (("checkpoints", ("checkpoints",)), ("best", ("export", "best")))}


def _record_evals(monkeypatch, cls, sink):
    real = cls._evaluate

    def recording(self, state, batch_size, *args, **kwargs):
        out = real(self, state, batch_size, *args, **kwargs)
        sink.append(kwargs.get("step_no", getattr(state, "step", None)))
        return out

    monkeypatch.setattr(cls, "_evaluate", recording)


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    """JAX's ClassifierTrainer.fit and the port's from JAX's initial
    parameters: 3 steps at batch 8, checkpoints every 2 steps."""
    root = tmp_path_factory.mktemp("fit")
    mp = pytest.MonkeyPatch()
    mp.setattr(jvit, "_fused_platform_ok", lambda: True)
    try:
        common = dict(ADAMW, checkpoint_every_steps=2, n_devices=1, seed=3, ema_decay=0.5)
        jt = jfit.ClassifierTrainer(str(root / "jax"), None, jconfig.ModelConfig(**TINY),
                                    jconfig.TrainConfig(**common, telemetry=False))
        init = jax.device_get(jt._host_template().params)
        cfg = ModelConfig(**TINY)
        pt = tfit.ClassifierTrainer(str(root / "port"), None, cfg, TrainConfig(**common), device="cpu")
        mp.setattr(pt, "_init_state", lambda: pt._counted(create_train_state(
            cfg, pt.train_config, "cpu", state_dict=from_flax(init, {}, cfg))))
        jevals, tevals = [], []
        _record_evals(mp, jfit.ClassifierTrainer, jevals)
        _record_evals(mp, tfit.ClassifierTrainer, tevals)
        jres = jt.fit(batch_size=8, steps=3)
        kernels.reset_launch_counts()
        tres = pt.fit(batch_size=8, steps=3)
        launches = kernels.launch_counts()
        jbest = jt._checkpointer().best_step()
        jlatest = jax.device_get(jt._checkpointer().restore_latest(jt._host_template()))
    finally:
        mp.undo()
    return dict(jt=jt, pt=pt, jres=jres, tres=tres, jevals=jevals, tevals=tevals, jbest=jbest, jlatest=jlatest,
                launches=launches, cfg=cfg)


def test_fit_checkpoints_evals_and_best_match_jax(jax_and_port):
    r = jax_and_port
    assert _files(r["pt"].model_dir) == _files(r["jt"].model_dir) == {"checkpoints": [2, 3], "best": [2, 3]}
    assert [int(s) for s in r["tevals"]] == [int(s) for s in r["jevals"]] == [2, 3]
    assert r["pt"]._checkpointer().best_step() == r["jbest"]
    assert r["tres"].steps == r["jres"].steps == 3
    assert r["tres"].n_params == r["jres"].n_params
    assert sorted(r["tres"].final_metrics) == sorted(r["jres"].final_metrics) == ["loss", "metrics/top1",
                                                                                 "metrics/top5"]
    assert abs(r["tres"].final_metrics["loss"] - r["jres"].final_metrics["loss"]) <= 1e-5
    assert sum(r["launches"].values()) == 0  # CPU tensors: the plain versions


def test_fit_final_parameters_and_ema_match_jax(jax_and_port):
    r = jax_and_port
    pt = r["pt"]
    state = pt._checkpointer().restore_latest(pt._template_state())
    want = from_flax(r["jlatest"].params, {}, r["cfg"])
    drift = torch.cat([(p.detach() - want[n]).abs().flatten() for n, p in state.model.named_parameters()])
    assert float(drift.mean()) <= 0.01 * LR * 3 and float(drift.max()) <= 2 * LR * 3
    from tensorflowdistributedlearning_tpu.train.step import find_ema_params

    want_ema = from_flax(find_ema_params(r["jlatest"].opt_state), {}, r["cfg"])
    ema = torch.cat([(state.ema[n] - want_ema[n]).abs().flatten() for n in want_ema])
    assert float(ema.mean()) <= 0.01 * LR * 3 and float(ema.max()) <= 2 * LR * 3


def test_best_export_holds_the_ema_and_serves(jax_and_port):
    pt = jax_and_port["pt"]
    ckpt = pt._checkpointer()
    best = ckpt.best_step()
    payload = torch.load(os.path.join(pt.model_dir, "export", "best", str(best), "state.pt"), weights_only=True)
    latest = ckpt.restore_latest(pt._template_state())
    if best == latest.step:
        for name, e in latest.ema.items():
            assert torch.equal(payload["model"][name], e)
    images = tsyn.synthetic_classification_batch(np.random.default_rng(0), 4, (16, 16), 3, 10)["images"]
    for spec in ("float32", "bfloat16", "int8", "int8-compute"):
        out = pt.serving_fn(spec)(images)
        assert out["probabilities"].shape == (4, 10) and out["probabilities"].dtype == torch.float32
        assert out["class"].dtype == torch.int32
        assert torch.equal(out["class"], out["probabilities"].argmax(-1).to(torch.int32))
    manifest = pt.export_serving()
    from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine

    engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device="cpu", buckets=(4,))
    served = engine.infer(images)
    np.testing.assert_allclose(served["probabilities"], pt.serving_fn()(images)["probabilities"].numpy(), atol=1e-6)
    assert json.load(open(manifest))["task"] == "classification"


def test_restore_for_serving_draws_no_weights(jax_and_port, monkeypatch):
    from tensorflowdistributedlearning_tpu_torch import models

    def refuse(*args, **kwargs):
        raise AssertionError("the restore drew an init")

    monkeypatch.setattr(models, "init_vit_weights", refuse)
    monkeypatch.setattr(models, "init_weights", refuse)
    pt = jax_and_port["pt"]
    assert pt._restore_best_host().step == pt._checkpointer().best_step()
    pt.serving_fn()


def test_resume_is_the_uninterrupted_run_bit_for_bit(tmp_path):
    cfg = ModelConfig(**TINY)
    tcfg = TrainConfig(**dict(ADAMW, augmentation="cutmix"), checkpoint_every_steps=2, ema_decay=0.9)
    whole = tfit.ClassifierTrainer(str(tmp_path / "whole"), None, cfg, tcfg, device="cpu")
    res_whole = whole.fit(batch_size=8, steps=5)
    part = tfit.ClassifierTrainer(str(tmp_path / "part"), None, cfg, tcfg, device="cpu")
    assert part.fit(batch_size=8, steps=2).steps == 2
    res = tfit.ClassifierTrainer(str(tmp_path / "part"), None, cfg, tcfg, device="cpu").fit(batch_size=8, steps=5)
    assert res.steps == 5 and res.final_metrics == res_whole.final_metrics
    a = whole._checkpointer().restore_latest(whole._template_state())
    b = part._checkpointer().restore_latest(part._template_state())
    for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for n in a.ema:
        assert torch.equal(a.ema[n], b.ema[n]), n
    # a run already at its steps evaluates and trains nothing
    kernels.reset_launch_counts()
    again = tfit.ClassifierTrainer(str(tmp_path / "part"), None, cfg, tcfg, device="cpu").fit(batch_size=8, steps=5)
    assert again.steps == 5 and again.final_metrics == res.final_metrics
    assert _files(str(tmp_path / "part"))["checkpoints"] == [2, 4, 5]


# -- refusals -------------------------------------------------------------------------


def test_data_the_port_cannot_read_yet_is_refused(tmp_path):
    """Record shards and ImageFolder splits are read since the records slice
    (queue A 4, and the data half of queue A 11); data that neither package
    can train on raises the JAX package's error: a record shard with no
    record, an ImageFolder split with no image."""
    cfg = ModelConfig(**TINY)
    records = tmp_path / "records"
    records.mkdir()
    (records / "train-00000-of-00001.tfrecord").write_bytes(b"")
    with pytest.raises(ValueError, match="zero records"):
        tfit.ClassifierTrainer(str(tmp_path / "m1"), str(records), cfg, device="cpu").fit(batch_size=8, steps=1)
    with pytest.raises(ValueError, match="zero records"):
        jfit.ClassifierTrainer(str(tmp_path / "j1"), str(records), jconfig.ModelConfig(**TINY),
                               jconfig.TrainConfig(telemetry=False)).fit(batch_size=8, steps=1)
    folder = tmp_path / "folder"
    (folder / "train" / "class000").mkdir(parents=True)
    with pytest.raises(ValueError, match="No .png/.jpg/.jpeg files"):
        tfit.ClassifierTrainer(str(tmp_path / "m2"), str(folder), cfg, device="cpu").fit(batch_size=8, steps=1)
    # a directory with neither trains on the synthetic stream, as JAX does
    empty = tmp_path / "empty"
    empty.mkdir()
    res = tfit.ClassifierTrainer(str(tmp_path / "m3"), str(empty), cfg, TrainConfig(**ADAMW),
                                 device="cpu").fit(batch_size=4, steps=1)
    assert res.steps == 1


@pytest.mark.parametrize("preset, match", [("vit_s16_moe_imagenet", "queue A 12"), ("cifar10_smoke", "queue A 4"),
                                           ("resnet50_imagenet", "queue A 4"), ("resnet50_bf16_8k", "queue A 12"),
                                           ("xception41_imagenet", "queue A 11")])
def test_presets_the_port_does_not_train_are_refused(tmp_path, monkeypatch, preset, match):
    """Every preset trains now, each refused until the queue item ``match``
    names: ``vit_s16_moe_imagenet`` (queue A 12.3) with every expert local,
    ``resnet50_bf16_8k`` (queue A 12.1) through ``fit_preset`` with
    ``weight_update_sharding`` on (one process: every leaf whole, the
    memory event says so), the ResNet classifier presets (queue A 4) and
    ``xception41_imagenet`` (queue A 11): ``cifar10_smoke`` as it is, the
    others (accepted at full size) at a CPU's size: the convolutional ones
    at 1/16 width on 32x32 inputs, the MoE ViT at 2 layers (one MoE, 8
    experts) 96 wide on 32x32 inputs (4 tokens of 6 heads of 16)."""
    full = tconfigs.get_preset(preset)
    tfit.require_supported_training(full.model, full.train)
    if preset in ("resnet50_imagenet", "xception41_imagenet", "resnet50_bf16_8k"):
        small = dataclasses.replace(full.model, width_multiplier=0.0625, input_shape=(32, 32))
        monkeypatch.setitem(tconfigs.PRESETS, preset, dataclasses.replace(full, model=small))
    if preset == "vit_s16_moe_imagenet":
        assert match in "queue A 12.3" and full.model.moe_experts == 8
        small = dataclasses.replace(full.model, embed_dim=96, vit_layers=2, input_shape=(32, 32))
        monkeypatch.setitem(tconfigs.PRESETS, preset, dataclasses.replace(full, model=small))
    res = tfit.fit_preset(preset, str(tmp_path), steps=1, batch_size=8, device="cpu")
    assert res.steps == 1 and all(np.isfinite(v) for v in res.final_metrics.values())
    if preset == "resnet50_bf16_8k":
        with open(tmp_path / "telemetry.jsonl") as f:
            memory = [e for e in map(json.loads, f) if e["event"] == "memory" and "weight_update_sharding" in e]
        assert memory and all(e["weight_update_sharding"] for e in memory)


def test_other_refusals(tmp_path):
    cfg = ModelConfig(**TINY)
    with pytest.raises(ValueError, match="num_classes is None"):
        tfit.ClassifierTrainer(str(tmp_path), None, ModelConfig(), device="cpu")
    with pytest.raises(ValueError, match="NCHW"):
        tfit.ClassifierTrainer(str(tmp_path), None, cfg, TrainConfig(data_format="NCHW"), device="cpu").fit(8, 1)
    with pytest.raises(ValueError, match="segmentation config"):
        tfit.fit_preset("tgs_salt", str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="explicit --lr"):
        tfit.fit_preset("vit_s16_imagenet", str(tmp_path), optimizer="sgd", device="cpu")
    # the sequence axis (queue A 12.4) is taken: one process cannot lay out
    # two sequence positions, and says so with JAX's make_mesh text
    with pytest.raises(ValueError, match=r"1 devices not divisible by model_parallel\*sequence_parallel=2"):
        tfit.ClassifierTrainer(str(tmp_path), None, cfg, TrainConfig(sequence_parallel=2), device="cpu")
    # remat, once refused here, trains (queue A 4): one step of the remat ViT
    remat = tfit.ClassifierTrainer(str(tmp_path / "remat"), None, dataclasses.replace(cfg, remat=True),
                                   TrainConfig(**ADAMW), device="cpu").fit(batch_size=4, steps=1)
    assert remat.steps == 1
    with pytest.raises(AttributeError, match="fit"):
        tfit.ClassifierTrainer(str(tmp_path), None, cfg, device="cpu").params
    with pytest.raises(RuntimeError, match="fit\\(\\) first"):
        tfit.ClassifierTrainer(str(tmp_path / "never"), None, cfg, device="cpu").serving_fn()


def test_without_cuda_fit_raises_rather_than_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfit.ClassifierTrainer(str(tmp_path), None, ModelConfig(**TINY))


# -- the fit command --------------------------------------------------------------------


@pytest.fixture
def tiny_preset(monkeypatch):
    preset = tconfigs.Preset(model=ModelConfig(**TINY, dtype="bfloat16"),
                             train=TrainConfig(**dict(ADAMW, augmentation="flip_crop"), checkpoint_every_steps=2),
                             global_batch=8, description="tiny ViT for the CPU tests")
    monkeypatch.setitem(tconfigs.PRESETS, "tiny_vit_cpu", preset)
    return "tiny_vit_cpu"


def test_fit_command_prints_the_summary(tmp_path, tiny_preset):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main(["fit", "--preset", tiny_preset, "--model-dir", str(tmp_path), "--steps", "3",
                         "--batch-size", "4", "--eval-every", "1", "--lr", "5e-4", "--augmentation", "mixup",
                         "--ema-decay", "0.9", "--grad-clip", "0.5", "--device", "cpu", "--export-serving",
                         "--serving-dtype", "int8-compute"])
    assert code == 0
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    assert sorted(summary) == ["final_metrics", "n_params", "preset", "serving_artifact", "steps"]
    assert summary["preset"] == tiny_preset and summary["steps"] == 3
    assert summary["n_params"] == sum(p.numel() for p in tfit.ClassifierTrainer(
        str(tmp_path / "x"), None, ModelConfig(**TINY), device="cpu")._template_state().model.parameters())
    assert sorted(summary["final_metrics"]) == ["loss", "metrics/top1", "metrics/top5"]
    assert summary["serving_artifact"] == os.path.join(str(tmp_path), "export", "serving-int8-compute")
    manifest = json.load(open(os.path.join(summary["serving_artifact"], "manifest.json")))
    assert manifest["quantization"]["compute_dtype"] == "int8"
    assert _files(str(tmp_path))["best"] == [1, 2, 3]


def test_fit_command_needs_cuda_unless_asked_for_the_cpu(tmp_path, tiny_preset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["fit", "--preset", tiny_preset, "--model-dir", str(tmp_path), "--steps", "1"])


def test_fit_preset_applies_overrides_and_keeps_the_rest(tmp_path, tiny_preset, monkeypatch):
    seen = {}
    real = tfit.ClassifierTrainer.__init__

    def spy(self, model_dir, data_dir, model_config, train_config=None, device=None, plan=None):
        seen["tcfg"] = train_config
        real(self, model_dir, data_dir, model_config, train_config, device, plan)

    monkeypatch.setattr(tfit.ClassifierTrainer, "__init__", spy)
    tfit.fit_preset(tiny_preset, str(tmp_path), steps=1, batch_size=4, device="cpu", lr=2e-3, ema_decay=None)
    assert seen["tcfg"] == dataclasses.replace(tconfigs.PRESETS[tiny_preset].train, lr=2e-3)


# -- data parallel ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fit_ranks(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("fit-dp"))
    cfg = ModelConfig(**TINY)
    init = create_train_state(cfg, TrainConfig(**ADAMW), "cpu", generator=torch.Generator().manual_seed(4))
    torch.save({"state_dict": init.model.state_dict(), "step": 0}, os.path.join(directory, "fit_init.pt"))
    batch = tsyn.synthetic_classification_batch(np.random.default_rng(9), 8, (16, 16), 3, 10)
    np.savez(os.path.join(directory, "fit_batch.npz"), **batch)
    out = worker.launch("fit", 2, directory)
    single = create_train_state(cfg, TrainConfig(**ADAMW), "cpu", state_dict=init.model.state_dict())
    single, metrics = tstep.make_train_step(tstep.ClassificationTask(label_smoothing=0.1))(
        single, {k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(ranks=out, single=single, metrics=tstep.compute_metrics(metrics), directory=directory)


def test_two_ranks_first_step_is_the_whole_batch_step(fit_ranks):
    single = fit_ranks["single"]
    r0, r1 = fit_ranks["ranks"]
    for name, p in single.model.named_parameters():
        g = p.grad
        for r in (r0, r1):
            err = float((r["grads"][name] - g).abs().max())
            assert err <= 1e-5 * float(g.abs().max()) + 1e-7, (name, err)
    drift = torch.cat([(r0["params"][n] - p.detach()).abs().flatten() for n, p in single.model.named_parameters()])
    assert float(drift.mean()) <= 0.05 * LR and float(drift.max()) <= 2 * LR
    for n in r0["params"]:
        assert torch.equal(r0["params"][n], r1["params"][n]), n
    assert r0["metrics"] == r1["metrics"]
    assert abs(r0["metrics"]["loss"] - fit_ranks["metrics"]["loss"]) <= 1e-6
    assert r0["metrics"]["metrics/top1"] == fit_ranks["metrics"]["metrics/top1"]


def test_fit_under_two_ranks(fit_ranks):
    r0, r1 = fit_ranks["ranks"]
    assert r0["fit"] == r1["fit"] and sorted(r0["fit"]) == ["loss", "metrics/top1", "metrics/top5"]
    assert _files(os.path.join(fit_ranks["directory"], "fit-model")) == {"checkpoints": [2, 3], "best": [2, 3]}
    assert not [d for d in os.listdir(os.path.join(fit_ranks["directory"], "fit-model", "checkpoints"))
                if d.startswith(".tmp")]
    for r in (r0, r1):
        assert "single-process" in r["serving"]
