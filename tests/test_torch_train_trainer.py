"""The port's K-fold trainer end to end on the CPU, on a tiny TGS-layout
dataset: every fold trains, checkpoints on its cadence, evaluates, exports
its best state; a re-run is a no-op resume; a shorter run resumes to a
longer one; an unreadable checkpoint falls back; the best fold exports a
serving artifact the serve engine loads; and the ``train`` command line does
all of it and prints one JSON line. The fold manifests are the JAX
package's, byte for byte.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.data import folds as jfolds
from tensorflowdistributedlearning_tpu.data import pipeline as jpipe
from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main
from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager, CheckpointStructureError
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer, augment_seed
from tests import test_torch_dp_worker as torch_dp_worker
from tests.conftest import make_salt_dataset
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_blocks=(1, 1, 1), input_shape=(32, 32), base_depth=16, width_multiplier=0.125, use_pallas_depthwise=True)


def _trainer(model_dir, data, **tcfg):
    cfg = dict(n_folds=2, seed=0, checkpoint_every_steps=2, eval_throttle_secs=0, save_best=2)
    cfg.update(tcfg)
    return Trainer(model_dir, data, train_config=TrainConfig(**cfg), device="cpu", **TINY)


def _steps(path):
    return sorted(int(d) for d in os.listdir(path) if d.isdigit())


@pytest.fixture(scope="module")
def salt(tmp_path_factory):
    data, _, ids = make_salt_dataset(tmp_path_factory.mktemp("salt"), n_images=16, shape=(32, 32))
    return data, ids


@pytest.fixture(scope="module")
def trained(salt, tmp_path_factory):
    data, ids = salt
    model_dir = str(tmp_path_factory.mktemp("model"))
    trainer = _trainer(model_dir, data)
    tk.reset_launch_counts()
    results = trainer.train(ids, batch_size=4, steps=4)
    return dict(trainer=trainer, results=results, model_dir=model_dir, data=data, ids=ids)


def test_every_fold_trains_checkpoints_and_exports(trained):
    results, model_dir = trained["results"], trained["model_dir"]
    assert len(results) == 2
    for fold, metrics in enumerate(results):
        assert set(metrics) == {"metrics/mean_iou", "metrics/mean_acc", "loss"}
        assert all(np.isfinite(v) for v in metrics.values())
        fold_dir = os.path.join(model_dir, f"fold{fold}")
        assert _steps(os.path.join(fold_dir, "checkpoints")) == [2, 4]
        best = _steps(os.path.join(fold_dir, "export", "best"))
        assert 1 <= len(best) <= 2 and set(best) <= {2, 4}
        with open(os.path.join(fold_dir, "export", "best", str(best[0]), "metrics.json")) as f:
            assert "metrics/mean_iou" in json.load(f)
    assert trained["trainer"].params == sum(
        p.numel() for p in create_train_state(trained["trainer"].model_config, TrainConfig(), "cpu").model.parameters()
    )
    assert tk.launch_counts() == {k: 0 for k in tk.LAUNCHES}  # CPU: the plain arms only


def test_fold_manifests_are_the_jax_packages(trained):
    data, ids = trained["data"], trained["ids"]
    with open(os.path.join(trained["model_dir"], "folds.json")) as f:
        ours = json.load(f)
    masks = jpipe.InMemoryDataset.from_directory(data, ids=ids).masks
    y = jfolds.coverage_to_class(jpipe.mask_coverage(masks))
    assert ours == jfolds.build_fold_manifests(ids, list(y), 2, 0)


def test_rerun_is_a_noop_resume(trained):
    model_dir = trained["model_dir"]
    before = {f: _steps(os.path.join(model_dir, f"fold{f}", "checkpoints")) for f in (0, 1)}
    mtimes = os.path.getmtime(os.path.join(model_dir, "fold0", "checkpoints", "4", "state.pt"))
    again = _trainer(model_dir, trained["data"]).train(trained["ids"], batch_size=4, steps=4)
    assert again == trained["results"]  # the same final state, evaluated again
    assert {f: _steps(os.path.join(model_dir, f"fold{f}", "checkpoints")) for f in (0, 1)} == before
    assert os.path.getmtime(os.path.join(model_dir, "fold0", "checkpoints", "4", "state.pt")) == mtimes


def test_shorter_run_resumes_to_longer(salt, tmp_path):
    data, ids = salt
    model_dir = str(tmp_path / "m")
    _trainer(model_dir, data, n_folds=2).train(ids, batch_size=4, steps=2)
    assert _steps(os.path.join(model_dir, "fold0", "checkpoints")) == [2]
    trainer = _trainer(model_dir, data, n_folds=2)
    trainer.train(ids, batch_size=4, steps=4)
    assert _steps(os.path.join(model_dir, "fold0", "checkpoints")) == [2, 4]
    state = CheckpointManager(os.path.join(model_dir, "fold0")).restore_latest(trainer._init_state())
    assert state.step == 4


def test_unreadable_checkpoint_falls_back_and_config_change_raises(trained, tmp_path):
    import shutil

    fold_dir = str(tmp_path / "fold0")
    shutil.copytree(os.path.join(trained["model_dir"], "fold0"), fold_dir)
    with open(os.path.join(fold_dir, "checkpoints", "4", "state.pt"), "wb") as f:
        f.write(b"truncated")
    trainer = trained["trainer"]
    ckpt = CheckpointManager(fold_dir)
    assert ckpt.restore_latest(trainer._init_state()).step == 2
    assert _steps(os.path.join(fold_dir, "checkpoints")) == [2]  # the unreadable step is gone
    sgd = create_train_state(trainer.model_config, TrainConfig(optimizer="sgd"), "cpu")
    with pytest.raises(CheckpointStructureError, match="configuration changed"):
        ckpt.restore_latest(sgd)


def test_export_serving_loads_in_the_engine(trained, tmp_path):
    trainer = trained["trainer"]
    manifest = trainer.export_serving(0, str(tmp_path / "art"))
    engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device="cpu", buckets=(1, 4))
    x = np.random.default_rng(0).normal(size=(3, 32, 32, 2)).astype(np.float32)
    got = engine.infer(x)
    best = trainer.restore_fold(0).model.eval()
    with torch.no_grad():
        want = torch.sigmoid(best(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got["probabilities"], want, atol=1e-6, rtol=0)
    with open(manifest) as f:
        assert json.load(f)["fold"] == 0


def test_augment_seed_is_a_function_of_fold_and_step():
    assert augment_seed(42, 0, 7) == augment_seed(42, 0, 7)
    assert len({augment_seed(42, f, s) for f in range(3) for s in range(50)}) == 150
    assert 0 <= augment_seed(42, 1, 1) < 2 ** 63


def test_trainer_rejects_what_the_slice_does_not_run(salt, tmp_path):
    data, _ = salt
    with pytest.raises(NotImplementedError, match="ROADMAP|queue"):
        _trainer(str(tmp_path), data, pipeline_parallel=2, pipeline_microbatches=2)
    # the sequence axis (queue A 12.4) is taken; one process cannot lay out
    # two sequence positions
    with pytest.raises(ValueError, match=r"not divisible by model_parallel\*sequence_parallel=2"):
        _trainer(str(tmp_path), data, sequence_parallel=2)
    # the expert axis (queue A 12.3) takes the MoE ViT only: JAX's fit text
    with pytest.raises(ValueError, match=r"expert_parallel=2 requires moe_experts=2 .*got moe_experts=0"):
        _trainer(str(tmp_path), data, expert_parallel=2)
    # model_parallel, refused here until tensor parallelism was ported (queue
    # A 12.2), is taken; one process cannot lay out two model positions
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        _trainer(str(tmp_path), data, model_parallel=2)
    # grad_accum_steps and lars, once refused here, are taken (queue A 4),
    # and ZeRO-1's weight_update_sharding (queue A 12.1)
    for kw in (dict(grad_accum_steps=2), dict(optimizer="lars"), dict(weight_update_sharding=True)):
        taken = _trainer(str(tmp_path), data, **kw).train_config
        assert all(getattr(taken, k) == v for k, v in kw.items())
    # the data-parallel knobs are taken; n_devices must be the world size
    _trainer(str(tmp_path), data, sync_batch_norm=True, n_devices=1)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        _trainer(str(tmp_path), data, n_devices=2)
    with pytest.raises(ValueError, match="NCHW"):
        _trainer(str(tmp_path), data, data_format="NCHW").train(["im00"], batch_size=2, steps=1)


def test_train_cli_end_to_end(salt, tmp_path, capsys):
    data, _ = salt
    model_dir = str(tmp_path / "cli")
    args = ["train", "--data-dir", data, "--model-dir", model_dir, "--batch-size", "4", "--steps", "2",
            "--n-fold", "2", "--input-shape", "32", "32", "--n-blocks", "1", "1", "1", "--base-depth", "8",
            "--checkpoint-every", "2", "--eval-throttle-secs", "0", "--use-pallas-depthwise"]
    # the command at this module's one torch thread, so that the in-process
    # re-run below evaluates the same final state to the same bits
    proc = subprocess.run(
        [sys.executable, "-m", "tensorflowdistributedlearning_tpu_torch", *args, "--device", "cpu",
         "--export-serving"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert len(out["folds"]) == 2 and out["n_params"] > 0
    assert os.path.isfile(os.path.join(out["serving_artifact"], "manifest.json"))
    for fold in (0, 1):
        assert _steps(os.path.join(model_dir, f"fold{fold}", "checkpoints")) == [2]
        assert _steps(os.path.join(model_dir, f"fold{fold}", "export", "best")) == [2]
    # a re-run is a no-op: the same metrics, no new checkpoint
    assert cli_main([*args, "--device", "cpu"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["folds"] == out["folds"]
    assert _steps(os.path.join(model_dir, "fold0", "checkpoints")) == [2]
    # without --device the command wants CUDA, and raises without it
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main(args)


@pytest.fixture(scope="module")
def trained_ema(salt, tmp_path_factory):
    """2 folds x 4 steps with an EMA of decay 0.5, then fold 0's best
    exports removed, so its restore falls back to the latest checkpoint."""
    import shutil

    data, ids = salt
    model_dir = str(tmp_path_factory.mktemp("model_ema"))
    trainer = _trainer(model_dir, data, ema_decay=0.5)
    trainer.train(ids, batch_size=4, steps=4)
    shutil.rmtree(os.path.join(model_dir, "fold0", "export", "best"))
    return trainer, model_dir


def _forward_probs(trainer, weights, x):
    """Eval-mode probabilities of the fold model holding ``weights`` (a full
    ``state_dict``: parameters and BN statistics)."""
    model = trainer._init_state().model
    model.load_state_dict(weights, strict=True)
    with torch.no_grad():
        return torch.sigmoid(model.eval()(torch.from_numpy(x))).numpy()


def test_served_fold_is_its_ema_after_a_restore_fallback(trained_ema, tmp_path):
    """The JAX package swaps the EMA in after the restore even when it fell
    back to a periodic checkpoint (``train/trainer.py:959-961`` there), and
    ``export_serving`` goes through ``serving_fn`` (``:1023``); the port
    serves and exports the same eval view."""
    trainer, model_dir = trained_ema
    ckpt = CheckpointManager(os.path.join(model_dir, "fold0"))
    assert ckpt.best_step() is None and ckpt.latest_step() == 4
    state = ckpt.restore_latest(trainer._init_state())
    live = {k: v.clone() for k, v in state.model.state_dict().items()}
    ema = {**live, **{k: v.clone() for k, v in state.ema.items()}}
    x = np.random.default_rng(3).normal(size=(3, 32, 32, 2)).astype(np.float32)
    want, live_probs = _forward_probs(trainer, ema, x), _forward_probs(trainer, live, x)
    assert np.abs(want - live_probs).max() > 1e-3  # the two views are apart

    served = trainer.serving_fn(0)(x)["probabilities"].cpu().numpy()
    np.testing.assert_allclose(served, want, atol=1e-6, rtol=0)
    manifest = trainer.export_serving(0, str(tmp_path / "art"))
    engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device="cpu", buckets=(4,))
    np.testing.assert_allclose(engine.infer(x)["probabilities"], want, atol=1e-6, rtol=0)


def test_served_fold_with_a_best_export_is_that_export(trained_ema):
    """With a best export present nothing changes: the export already holds
    the EMA view, and the restored state's EMA is set to it."""
    trainer, model_dir = trained_ema
    ckpt = CheckpointManager(os.path.join(model_dir, "fold1"))
    step = ckpt.best_step()
    assert step is not None
    payload = torch.load(os.path.join(model_dir, "fold1", "export", "best", str(step), "state.pt"), weights_only=True)
    x = np.random.default_rng(4).normal(size=(2, 32, 32, 2)).astype(np.float32)
    want = _forward_probs(trainer, payload["model"], x)
    served = trainer.serving_fn(1)(x)["probabilities"].cpu().numpy()
    np.testing.assert_allclose(served, want, atol=1e-6, rtol=0)
    restored = trainer.restore_fold(1)
    for name, p in restored.model.named_parameters():
        assert torch.equal(restored.ema[name], p.detach())


def test_trainer_trains_data_parallel_over_two_gloo_ranks(tmp_path):
    # two CPU ranks train the tiny model, 2 folds x 4 steps at global batch 4
    # (tests/test_torch_dp_worker.py, mode "trainer")
    make_salt_dataset(tmp_path, n_images=16, shape=(32, 32))
    rank0, rank1 = torch_dp_worker.launch("trainer", 2, str(tmp_path))
    assert len(rank0["results"]) == 2
    assert rank0["results"] == rank1["results"]
    assert all(np.isfinite(v) for fold in rank0["results"] for v in fold.values())
    model_dir = str(tmp_path / "model")
    for fold in (0, 1):
        assert _steps(os.path.join(model_dir, f"fold{fold}", "checkpoints")) == [2, 4]
        assert _steps(os.path.join(model_dir, f"fold{fold}", "export", "best"))
    # rank 0 alone writes under model_dir, but for each rank's own run
    # ledger (rank 1: telemetry-1.jsonl, as every JAX process writes its
    # own); the re-run is a no-op resume that only appends to the ledgers
    renamed = {os.path.relpath(path, model_dir) for event, path in rank0["first_writes"] if event == "os.rename"}
    assert {os.path.join(f"fold{f}", "checkpoints", f".tmp-{s}") for f in (0, 1) for s in (2, 4)} <= {
        p.rsplit("-", 1)[0] for p in renamed}

    def ledger(name):
        return ("open", os.path.join(model_dir, name))

    assert set(rank1["first_writes"]) == set(rank1["rerun_writes"]) == {ledger("telemetry-1.jsonl")}
    assert set(rank0["rerun_writes"]) == {ledger("telemetry.jsonl")}
    assert ledger("telemetry.jsonl") in rank0["first_writes"]
    assert rank0["rerun"] == rank0["results"] and rank1["rerun"] == rank1["results"]
    for out in (rank0, rank1):
        assert out["n_devices"].startswith("ValueError") and "torchrun --nproc-per-node 3" in out["n_devices"]
        assert out["predict"] == "RuntimeError: serving/predict restore runs single-process; load this " \
            "model_dir from a single-process session"
        assert out["batch"].startswith("ValueError: Global batch size 3 must be divisible by the process count 2")
