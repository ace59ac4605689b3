"""The port's fold × TTA ensemble prediction against the JAX package's, on
the CPU at a tiny size.

The TTA transforms, the run-length encoding and the submission CSV are held
bit for bit (byte for byte) against JAX's. ``_predict_one`` and the two-fold
``Trainer.predict`` are held to JAX's within 1e-5 on the probabilities
(eval-mode forwards of one set of flax weights, carried over with
``utils.convert.from_flax``; the two packages sum in another order), with
the masks equal wherever the mean is more than 1e-5 from the threshold. The
JAX side runs its own ``Trainer.predict`` and ``_predict_one`` on a
one-device mesh, with its fold restore handed the same weights. Fold 0
predicts from a best export; fold 1 only has a periodic checkpoint whose
EMA differs from its live parameters, so both packages must take the EMA
after a restore fallback. Then the port's own contract (shapes, range, TTA
against none, NCHW, an untrained fold) and the ``predict`` command, from
checkpoints and from an exported artifact.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.data import augment as jaugment
from tensorflowdistributedlearning_tpu.data import kaggle as jkaggle
from tensorflowdistributedlearning_tpu.data import pipeline as jpipe
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.parallel import replicate
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train import trainer as jtrainer
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import augment as taugment
from tensorflowdistributedlearning_tpu_torch.data import kaggle as tkaggle
from tensorflowdistributedlearning_tpu_torch.data import pipeline as tpipe
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests.conftest import make_salt_dataset
from tests.test_torch_train_trainer import TINY
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


SHAPE = TINY["input_shape"]
N_TEST = 6
BATCH = 4  # 6 test images: one full batch and one with two pad rows
TOL = 1e-5


def _flax_variables(jm, seed):
    """numpy-seeded params and BN statistics in the flax tree of ``jm``."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False), jax.random.key(0),
                            jnp.zeros((1, *SHAPE, 2)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if shape[2] != 1 else int(np.prod(shape[:2]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(fill, shapes["params"]),
            jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"]))


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    """Two folds of one tiny model in both packages. Fold 0: weights from
    seed 1, EMA equal to them, a best export. Fold 1: weights from seed 2,
    EMA from seed 3 (parameters only), a periodic checkpoint only."""
    _, test, _ = make_salt_dataset(tmp_path_factory.mktemp("salt"), n_images=3, n_test=N_TEST, shape=SHAPE)
    jcfg = jconfig.ModelConfig(**TINY)
    cfg = ModelConfig(**TINY)
    jm = jbuild(jcfg)
    jt = jtrainer.Trainer(str(tmp_path_factory.mktemp("jax_model")), "",
                          train_config=jconfig.TrainConfig(n_folds=2, seed=0, n_devices=1), **TINY)
    variables = {0: _flax_variables(jm, 1), 1: _flax_variables(jm, 2)}
    emas = {0: variables[0][0], 1: _flax_variables(jm, 3)[0]}

    model_dir = str(tmp_path_factory.mktemp("model"))
    tcfg = TrainConfig(n_folds=2, seed=0, ema_decay=0.5)
    trainer = Trainer(model_dir, "", train_config=tcfg, device="cpu", **TINY)
    jstates = {}
    for fold, (params, stats) in variables.items():
        state = create_train_state(cfg, tcfg, "cpu", state_dict=from_flax(params, stats, cfg), step=4)
        ema = from_flax(emas[fold], stats, cfg)
        with torch.no_grad():
            for name, e in state.ema.items():
                e.copy_(ema[name])
        ckpt = CheckpointManager(os.path.join(model_dir, f"fold{fold}"), save_every_steps=4)
        if fold == 0:
            ckpt.export_best(state, {"metrics/mean_iou": 0.5})
        else:
            ckpt.save(state)
        jstates[fold] = replicate(
            JTrainState(step=jnp.asarray(4, jnp.int32), params=params, batch_stats=stats,
                        opt_state=(jstep.EmaTrackerState(ema=emas[fold]),), apply_fn=jm.apply, tx=None),
            jt.mesh,
        )
    jt._restore_fold_or_raise = lambda fold, template: jstates[fold]
    return dict(trainer=trainer, jax=jt, jstates=jstates, test=test, model_dir=model_dir, tcfg=tcfg)


# -- TTA, RLE and the submission CSV: bit for bit ----------------------------------------


@pytest.mark.parametrize("transformation", jaugment.TTA_TRANSFORMS)
@pytest.mark.parametrize("shape", [(2, 8, 8, 2), (3, 5, 7, 1)], ids=["square", "non-square"])
def test_tta_transform_and_inverse_are_jaxs(transformation, shape):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = taugment.tta_transform(torch.from_numpy(x), transformation)
    want = np.asarray(jaugment.tta_transform(jnp.asarray(x), transformation))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    back = taugment.tta_inverse(got, transformation)
    assert np.array_equal(back.numpy(), np.asarray(jaugment.tta_inverse(jnp.asarray(want), transformation)))
    assert np.array_equal(back.numpy(), x)


def test_tta_transforms_are_jaxs_and_unknown_names_raise():
    assert taugment.TTA_TRANSFORMS == jaugment.TTA_TRANSFORMS
    with pytest.raises(ValueError, match="Unknown transformation"):
        taugment.tta_transform(torch.zeros(1, 2, 2, 1), "rotate")
    with pytest.raises(ValueError, match="Unknown transformation"):
        taugment.tta_inverse(torch.zeros(1, 2, 2, 1), "flip")


def _masks(kind, shape=(11, 9)):
    rng = np.random.default_rng(5)
    if kind == "empty":
        return np.zeros(shape, np.float32)
    if kind == "full":
        return np.ones(shape, np.float32)
    return (rng.uniform(size=shape) > 0.6).astype(np.float32)


@pytest.mark.parametrize("kind", ["empty", "full", "random"])
def test_rle_encode_and_decode_are_jaxs(kind):
    mask = _masks(kind)
    rle = tkaggle.rle_encode(mask)
    assert rle == jkaggle.rle_encode(mask)
    assert (rle == "") == (kind == "empty")
    decoded = tkaggle.rle_decode(rle, mask.shape)
    assert decoded.dtype == np.uint8 and np.array_equal(decoded, jkaggle.rle_decode(rle, mask.shape))
    assert np.array_equal(decoded, mask.astype(np.uint8))


def test_write_submission_is_jaxs_byte_for_byte(tmp_path):
    masks = np.stack([_masks(k) for k in ("empty", "full", "random")])[..., None]
    ids = ["a0", "b1", "c2"]
    tkaggle.write_submission(str(tmp_path / "port.csv"), ids, masks)
    jkaggle.write_submission(str(tmp_path / "jax.csv"), ids, masks)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


# -- one member and the ensemble against JAX ----------------------------------------------


@pytest.mark.parametrize("transformation", jaugment.TTA_TRANSFORMS)
def test_predict_one_matches_jax(ensemble, transformation):
    trainer, jt = ensemble["trainer"], ensemble["jax"]
    state = trainer.restore_fold(1)
    with state.eval_params() as model:
        got = trainer._predict_one(model, tpipe.InMemoryDataset.from_directory(ensemble["test"], with_masks=False),
                                   BATCH, transformation)
    jstate = jstep.with_ema_params(ensemble["jstates"][1])
    want = jt._predict_one(jstate, jpipe.InMemoryDataset.from_directory(ensemble["test"], with_masks=False),
                           BATCH, transformation)
    assert got.shape == want.shape == (N_TEST, *SHAPE, 1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_two_fold_ensemble_matches_jax_and_takes_each_folds_ema(ensemble):
    trainer, jt = ensemble["trainer"], ensemble["jax"]
    got = trainer.predict(ensemble["test"], batch_size=BATCH)
    want = jt.predict(ensemble["test"], batch_size=BATCH)
    assert got["ids"] == want["ids"] == [f"t{i}" for i in range(N_TEST)]
    assert got["probabilities"].dtype == np.float32
    np.testing.assert_allclose(got["probabilities"], want["probabilities"], atol=TOL, rtol=0)
    away = np.abs(want["probabilities"] - 0.5) > TOL
    np.testing.assert_array_equal(got["masks"][away], want["masks"][away])

    # fold 1's EMA moves the ensemble: its live weights give another answer
    jstates = ensemble["jstates"]
    no_ema = {0: jstates[0], 1: jstates[1].replace(opt_state=())}
    jt._restore_fold_or_raise = lambda fold, template: no_ema[fold]
    try:
        without = jt.predict(ensemble["test"], batch_size=BATCH)
    finally:
        jt._restore_fold_or_raise = lambda fold, template: jstates[fold]
    assert np.abs(without["probabilities"] - got["probabilities"]).max() > 1e-3


# -- the port's own contract ---------------------------------------------------------------


def test_predict_shapes_range_and_tta(ensemble):
    trainer = ensemble["trainer"]
    tk.reset_launch_counts()
    tta = trainer.predict(ensemble["test"], batch_size=BATCH, tta=True)
    assert tk.launch_counts() == {k: 0 for k in tk.LAUNCHES}  # CPU: the plain arms only
    assert tta["probabilities"].shape == tta["masks"].shape == (N_TEST, *SHAPE, 1)
    assert np.all(tta["probabilities"] >= 0) and np.all(tta["probabilities"] <= 1)
    assert set(np.unique(tta["masks"])) <= {0.0, 1.0}
    np.testing.assert_array_equal(tta["masks"], (tta["probabilities"] > 0.5).astype(np.float32))
    plain = trainer.predict(ensemble["test"], batch_size=BATCH, tta=False)
    assert plain["probabilities"].shape == tta["probabilities"].shape
    assert not np.allclose(plain["probabilities"], tta["probabilities"])
    # one fold alone is that fold's member average, batch size aside
    one = trainer.predict(ensemble["test"], batch_size=N_TEST, tta=False, folds=[0])
    state = trainer.restore_fold(0)
    with state.eval_params() as model:
        member = trainer._predict_one(model, tpipe.InMemoryDataset.from_directory(ensemble["test"], with_masks=False),
                                      2, "none")
    np.testing.assert_allclose(one["probabilities"], member, atol=1e-6, rtol=0)


def test_predict_honours_nchw_and_refuses_an_untrained_fold(ensemble):
    import dataclasses

    tcfg = dataclasses.replace(ensemble["tcfg"], data_format="NCHW")
    nchw = Trainer(ensemble["model_dir"], "", train_config=tcfg, device="cpu", **TINY)
    pred = nchw.predict(ensemble["test"], batch_size=BATCH, tta=False)
    assert pred["probabilities"].shape == pred["masks"].shape == (N_TEST, 1, *SHAPE)
    nhwc = ensemble["trainer"].predict(ensemble["test"], batch_size=BATCH, tta=False)
    np.testing.assert_array_equal(pred["probabilities"], np.transpose(nhwc["probabilities"], (0, 3, 1, 2)))
    with pytest.raises(RuntimeError, match="no trained checkpoint"):
        ensemble["trainer"].predict(ensemble["test"], batch_size=BATCH, folds=[7])


# -- the predict command -------------------------------------------------------------------

# what the command line can express: ModelConfig's defaults but these
CLI_MODEL = dict(input_shape=SHAPE, n_blocks=(1, 1, 1), base_depth=8, use_pallas_depthwise=True)
CLI_ARGS = ["--input-shape", "32", "32", "--n-blocks", "1", "1", "1", "--base-depth", "8", "--use-pallas-depthwise",
            "--n-fold", "2", "--batch-size", str(BATCH)]


@pytest.fixture(scope="module")
def cli_model(ensemble, tmp_path_factory):
    """Two folds of a model the command line can rebuild, each a periodic
    checkpoint of seeded random weights."""
    model_dir = str(tmp_path_factory.mktemp("cli_model"))
    cfg = ModelConfig(**CLI_MODEL)
    for fold in (0, 1):
        state = create_train_state(cfg, TrainConfig(), "cpu", generator=torch.Generator().manual_seed(fold), step=2)
        CheckpointManager(os.path.join(model_dir, f"fold{fold}"), save_every_steps=2).save(state)
    trainer = Trainer(model_dir, "", train_config=TrainConfig(n_folds=2), device="cpu", **CLI_MODEL)
    return trainer, model_dir, ensemble["test"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_predict_command_from_checkpoints(cli_model, tmp_path, capsys):
    trainer, model_dir, test = cli_model
    out, csv = str(tmp_path / "pred.npz"), str(tmp_path / "sub.csv")
    args = ["predict", "--model-dir", model_dir, "--test-dir", test, *CLI_ARGS]
    assert cli_main([*args, "--device", "cpu", "--output", out, "--submission", csv]) == 0
    assert _last_json(capsys) == {"written": out, "n": N_TEST}
    want = trainer.predict(test, batch_size=BATCH)
    saved = np.load(out)
    assert list(saved["ids"]) == want["ids"]
    np.testing.assert_array_equal(saved["probabilities"], want["probabilities"])
    np.testing.assert_array_equal(saved["masks"], want["masks"])
    tkaggle.write_submission(str(tmp_path / "want.csv"), want["ids"], want["masks"])
    assert (tmp_path / "sub.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()

    assert cli_main([*args, "--device", "cpu", "--no-tta"]) == 0
    summary = _last_json(capsys)
    plain = trainer.predict(test, batch_size=BATCH, tta=False)
    assert summary == {"n": N_TEST, "mean_mask_coverage": float(plain["masks"].mean())}
    # without --device the command wants CUDA, and raises without it
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main(args)


def test_predict_command_from_an_artifact(cli_model, tmp_path, capsys):
    # the engine's bucket and the trainer's batch convolve different row
    # counts: at one thread their probabilities part by more than 1e-6, so
    # this test takes torch's default count
    with worker.torch_threads(worker.DEFAULT_TORCH_THREADS):
        _predict_command_from_an_artifact(cli_model, tmp_path, capsys)


def _predict_command_from_an_artifact(cli_model, tmp_path, capsys):
    trainer, model_dir, test = cli_model
    artifact = os.path.dirname(trainer.export_serving(0, str(tmp_path / "art")))
    out, csv = str(tmp_path / "pred.npz"), str(tmp_path / "sub.csv")
    args = ["predict", "--model-dir", "ignored", "--test-dir", test, "--artifact-dir", artifact, "--device", "cpu"]
    assert cli_main([*args, "--output", out, "--submission", csv]) == 0
    assert _last_json(capsys) == {"written": out, "n": N_TEST}
    ds = tpipe.InMemoryDataset.from_directory(test, with_masks=False)
    images = taugment.add_laplace_channel(torch.from_numpy(ds.images)).numpy()
    want = InferenceEngine.from_artifact(artifact, device="cpu").infer(images)
    saved = np.load(out)
    assert list(saved["ids"]) == ds.ids
    for key in ("probabilities", "mask"):
        np.testing.assert_array_equal(saved[key], want[key])
    tkaggle.write_submission(str(tmp_path / "want.csv"), ds.ids, want["mask"])
    assert (tmp_path / "sub.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
    # the eval view of fold 0 under the identity transform, through the engine
    state = trainer.restore_fold(0)
    with state.eval_params() as model:
        member = trainer._predict_one(model, ds, BATCH, "none")
    np.testing.assert_allclose(saved["probabilities"], member, atol=1e-6, rtol=0)

    assert cli_main(args) == 0
    summary = _last_json(capsys)
    assert summary["n"] == N_TEST and summary["outputs"]["probabilities"] == [N_TEST, *SHAPE, 1]
    assert summary["mean_mask_coverage"] == float(want["mask"].mean())
    assert sum(summary["bucket_hits"].values()) == 1
