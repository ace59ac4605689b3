"""The port's TGS-salt training script and its pieces on the CPU:
``data/kaggle.py``'s CSV readers and ``load_tgs_training_set`` against the
JAX package's, ``examples/train_tgs_salt.py`` end to end at a tiny width,
and the fold restore that draws no weights (``Trainer.restore_fold``).

The dataset is ``tests/conftest.py:make_salt_dataset`` plus a written
``train.csv``. Ids, classes and error messages must equal JAX's; the
restore's predictions must equal, bit for bit, those of the restore into a
freshly drawn state that it replaced.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu.data import kaggle as jkaggle
from tensorflowdistributedlearning_tpu_torch import models
from tensorflowdistributedlearning_tpu_torch.config import TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import kaggle as tkaggle
from tensorflowdistributedlearning_tpu_torch.examples import train_tgs_salt
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tests.conftest import make_salt_dataset
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


MODEL = dict(input_shape=(32, 32), n_blocks=(1, 1, 1), base_depth=8)


def _write_csv(path, rows, header=("id", "rle_mask")):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


@pytest.fixture(scope="module")
def tgs_root(tmp_path_factory):
    """A Kaggle competition layout: ``train/{images,masks}``, ``test/images``
    and a ``train.csv`` listing every train id (shuffled, with empty rle
    cells and a blank line)."""
    root = tmp_path_factory.mktemp("tgs")
    data, test, ids = make_salt_dataset(root, n_images=16, n_test=6)
    os.rename(data, os.path.join(str(root), "train"))
    rows = [(i, "1 3" if n % 2 else "") for n, i in enumerate(reversed(ids))]
    _write_csv(os.path.join(str(root), "train.csv"), rows[:8] + [()] + rows[8:])
    _write_csv(os.path.join(str(root), "depths.csv"), [(i, str(100 + n)) for n, i in enumerate(ids)] + [("nodepth", "")],
               header=("id", "z"))
    return str(root), ids


def test_csv_readers_match_jax(tgs_root):
    root, _ = tgs_root
    for name in ("train.csv", "depths.csv"):
        path = os.path.join(root, name)
        assert tkaggle.read_two_column_csv(path) == jkaggle.read_two_column_csv(path)
    depths = tkaggle.load_depths(os.path.join(root, "depths.csv"))
    assert depths == jkaggle.load_depths(os.path.join(root, "depths.csv")) and "nodepth" not in depths


@pytest.mark.parametrize("with_csv", [True, False], ids=["train_csv", "images_dir"])
def test_training_set_matches_jax(tgs_root, with_csv):
    root, ids = tgs_root
    train_csv = os.path.join(root, "train.csv") if with_csv else None
    got_ids, got_classes = tkaggle.load_tgs_training_set(os.path.join(root, "train"), train_csv)
    want_ids, want_classes = jkaggle.load_tgs_training_set(os.path.join(root, "train"), train_csv)
    assert got_ids == want_ids == sorted(ids)
    np.testing.assert_array_equal(got_classes, want_classes)
    assert got_classes.dtype == want_classes.dtype and set(got_classes.tolist()) > {0}


def test_training_set_errors_match_jax(tgs_root, tmp_path):
    root, ids = tgs_root
    bad = str(tmp_path / "train.csv")
    _write_csv(bad, [(ids[0], ""), ("missing_a", ""), ("missing_b", "")])
    with pytest.raises(FileNotFoundError) as got:
        tkaggle.load_tgs_training_set(os.path.join(root, "train"), bad)
    with pytest.raises(FileNotFoundError) as want:
        jkaggle.load_tgs_training_set(os.path.join(root, "train"), bad)
    assert str(got.value) == str(want.value) and "2 ids" in str(got.value)
    (tmp_path / "empty" / "images").mkdir(parents=True)
    for fn in (tkaggle.load_tgs_training_set, jkaggle.load_tgs_training_set):
        with pytest.raises(ValueError, match="No examples found under .*empty/images"):
            fn(str(tmp_path / "empty"))


# -- the training script and the draw-free restore ---------------------------------


@pytest.fixture(scope="module")
def driven(tgs_root, tmp_path_factory):
    root, _ = tgs_root
    model_dir = str(tmp_path_factory.mktemp("script-model"))
    submission = os.path.join(model_dir, "sub.csv")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = train_tgs_salt.main(["--data-root", root, "--model-dir", model_dir, "--batch-size", "4", "--steps",
                                    "2", "--n-fold", "2", "--input-shape", "32", "32", "--n-blocks", "1", "1", "1",
                                    "--base-depth", "8", "--device", "cpu", "--submission", submission])
    lines = [json.loads(line) for line in out.getvalue().strip().splitlines()]
    return dict(code=code, lines=lines, model_dir=model_dir, submission=submission, root=root)


def _trainer(model_dir):
    return Trainer(model_dir, "", train_config=TrainConfig(n_folds=2), device="cpu", **MODEL)


def test_training_script_trains_every_fold_and_writes_the_submission(driven):
    assert driven["code"] == 0
    summary, sub = driven["lines"]
    assert len(summary["folds"]) == 2 and summary["n_params"] > 0
    assert all(np.isfinite(v) for fold in summary["folds"] for v in fold.values())
    for fold in range(2):
        # the step and, beside it, the data service's resume sidecar (as the JAX package writes it)
        assert sorted(os.listdir(os.path.join(driven["model_dir"], f"fold{fold}", "checkpoints"))) == \
            ["2", "data_state-2.json"]
    assert sub == {"submission": driven["submission"], "n": 6}
    with open(driven["submission"]) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["id", "rle_mask"] and len(rows) == 7


def test_training_script_defaults_are_the_notebooks():
    args = train_tgs_salt.build_parser().parse_args(["--data-root", "r", "--model-dir", "m"])
    assert (args.batch_size, args.steps, args.n_fold, args.lr, args.seed) == (64, 10_000, 5, 0.001, 42)
    assert (tuple(args.input_shape), tuple(args.n_blocks), args.base_depth, args.device) == ((101, 101), (3, 4, 6),
                                                                                           256, None)


def _drawn_restore(trainer, fold):
    """The earlier restore: a freshly initialised state, then the best
    export (or the latest checkpoint) loaded over it."""
    return trainer._checkpointer(fold).restore_best_or_raise(trainer._init_state())


def test_restore_draws_no_weights_and_predicts_bit_for_bit_as_before(driven, monkeypatch):
    test_dir = os.path.join(driven["root"], "test")
    trainer = _trainer(driven["model_dir"])
    with monkeypatch.context() as m:
        m.setattr(trainer, "restore_fold", lambda fold: _drawn_restore(trainer, fold))
        before = trainer.predict(test_dir, batch_size=4)

    def refuse(*args, **kwargs):
        raise AssertionError("the restore drew an init")

    monkeypatch.setattr(models, "init_weights", refuse)
    after = _trainer(driven["model_dir"]).predict(test_dir, batch_size=4)
    assert after["ids"] == before["ids"]
    for key in ("probabilities", "masks"):
        assert after[key].dtype == before[key].dtype and np.array_equal(after[key], before[key]), key


def test_restore_falls_back_to_the_periodic_checkpoint(driven, tmp_path, monkeypatch):
    model_dir = str(tmp_path / "model")
    shutil.copytree(driven["model_dir"], model_dir)
    shutil.rmtree(os.path.join(model_dir, "fold1", "export", "best"))
    drawn = _drawn_restore(_trainer(model_dir), 1)
    monkeypatch.setattr(models, "init_weights", lambda *a, **k: (_ for _ in ()).throw(AssertionError("drew")))
    trainer = _trainer(model_dir)
    state = trainer.restore_fold(1)
    assert state.step == drawn.step == 2
    for (name, a), b in zip(state.model.state_dict().items(), drawn.model.state_dict().values()):
        assert torch.equal(a, b), name
    for p, q in zip(state.model.parameters(), drawn.model.parameters()):
        sa, sb = state.optimizer.state[p], drawn.optimizer.state[q]
        assert sorted(sa) == sorted(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert trainer.params == sum(p.numel() for p in state.model.parameters())
    with pytest.raises(RuntimeError, match="train fold 5 first"):
        trainer.restore_fold(5)
