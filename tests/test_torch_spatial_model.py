"""The port's networks, steps and trainers under sequence parallelism
(``models.set_spatial``, ``TrainConfig.sequence_parallel``) against its
plain ones and the JAX package's, on the CPU.

- The parameter tree of every H-sharded network is the plain one's (names,
  shapes), so the same ``from_flax`` weights load into both.
- 2 gloo ranks at (dp, sp) = (1, 2) and 4 at (2, 2)
  (``tests/test_torch_dp_worker.py`` mode ``sp``, one launch each, started
  before the JAX references are computed so the two overlap):
  - the eval-mode forwards of the narrow ResNet and Xception-41 segmenters
    and classifiers and the tiny ViT on row blocks are the plain forwards
    and JAX's spatial forwards (``shard_map`` over a (1, 1, 2) mesh) of the
    same weights, within 2e-4;
  - one plain-SGD step at lr 1 of the narrow segmenter under a smooth loss
    (the update is the gradient) at (1, 2) is JAX's ``make_train_step(
    spatial=True)`` on ``make_mesh(2, sequence_parallel=2)`` and the
    one-rank step, and at (2, 2) the port's (2, 1) step (the mean of the
    two data indices' one-rank gradients): loss within 1e-5, every
    gradient leaf within 1e-4·max|g| + 1e-6, BN statistics within 1e-5;
  - two Adam steps under ZeRO-1 at (2, 2) are bit for bit the replicated
    sequence-parallel steps;
  - ``Trainer.train`` at (1, 2) takes the plain ``Trainer``'s first step
    (its first window's loss), and its ``predict`` (2 folds x 4 TTA
    transforms, on both ranks) is the plain ``predict`` of the same
    checkpoints within 1e-5; ``fit`` of the tiny ViT at (1, 2) ends where
    the plain ``fit`` does.
- ``--sequence-parallel`` reaches ``TrainConfig`` from the ``train`` and
  ``fit`` commands.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.ops import losses as jlosses
from tensorflowdistributedlearning_tpu.parallel import make_mesh, replicate
from tensorflowdistributedlearning_tpu.parallel.mesh import SEQUENCE_AXIS, shard_batch_spatial
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import pipeline as pipeline_lib
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.models import build_model, empty_model
from tensorflowdistributedlearning_tpu_torch.obs.ledger import read_ledger
from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.conftest import make_salt_dataset


MODELS = worker.SP_MODELS
SEG_BATCH = 4


class _JaxBce(jstep.SegmentationTask):
    def loss(self, logits, batch):
        return jlosses.sigmoid_cross_entropy(logits, batch["labels"])


def _jcfg(kw):
    return jconfig.ModelConfig(**{k: v for k, v in kw.items() if k != "use_pallas_depthwise"})


def _variables(jm, cfg, seed):
    """numpy-seeded flax params and BN statistics of ``jm`` (no init run)."""
    h, w = cfg.input_shape
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False), jax.random.key(0),
                            jnp.zeros((1, h, w, cfg.input_channels)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            depthwise = leaf.ndim == 4 and leaf.shape[2] == 1
            fan_in = int(np.prod(leaf.shape[:2] if depthwise else leaf.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v.get("batch_stats", {})


def _images(name, seed):
    cfg = ModelConfig(**MODELS[name])
    h, w = cfg.input_shape
    return np.random.default_rng(seed).normal(size=(2, h, w, cfg.input_channels)).astype(np.float32)


def _jax_forward(name, params, stats, images):
    """JAX's spatial forward of ``name`` on a (1, 1, 2) mesh, eval mode."""
    jcfg = _jcfg(MODELS[name])
    jm = jbuild(jcfg, bn_axis_name=SEQUENCE_AXIS, spatial_axis_name=SEQUENCE_AXIS)
    mesh = make_mesh(2, sequence_parallel=2)
    variables = {"params": params, "batch_stats": stats} if stats else {"params": params}

    def fwd(v, im):
        return jax.lax.pmean(jm.apply(v, im, train=False), SEQUENCE_AXIS)

    f = jax.jit(jax.shard_map(fwd, mesh=mesh, in_specs=(P(), P(None, SEQUENCE_AXIS, None, None)), out_specs=P()))
    return np.asarray(f(variables, images))


def _seg_batch():
    b = tsyn.synthetic_segmentation_batch(np.random.default_rng(3), SEG_BATCH, (32, 32))
    return {"images": b["images"], "labels": b["labels"]}


def _jax_step(params, stats, batch):
    """JAX's sequence-parallel step at (1, 2): plain SGD at lr 1 under
    sigmoid cross entropy; loss, gradient (the update) and new state in the
    port's names."""
    jcfg = _jcfg(worker.SP_SEG)
    jm = jbuild(jcfg, bn_axis_name=SEQUENCE_AXIS, spatial_axis_name=SEQUENCE_AXIS)
    tx = jstep.make_optimizer(jconfig.TrainConfig(**worker.TP_SGD))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
                        apply_fn=jm.apply, tx=tx)
    mesh = make_mesh(2, sequence_parallel=2)
    step = jstep.make_train_step(mesh, _JaxBce(), donate=False, spatial=True)
    new, metrics = step(replicate(state, mesh), shard_batch_spatial(batch, mesh))
    cfg = ModelConfig(**worker.SP_SEG)
    p0, p1 = from_flax(params, stats, cfg), from_flax(*jax.device_get((new.params, new.batch_stats)), cfg)
    names = dict(build_model(cfg, "cpu").named_parameters())
    return {"loss": jstep.compute_metrics(jax.device_get(metrics))["loss"], "grads": {k: p0[k] - p1[k] for k in names},
            "state": p1}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    variables = {}
    for i, (name, kw) in enumerate(MODELS.items()):
        jcfg = _jcfg(kw)
        variables[name] = _variables(jbuild(jcfg), jcfg, i)
    init = {name: from_flax(*variables[name], ModelConfig(**kw)) for name, kw in MODELS.items()}
    init["step"] = {"state_dict": init["resnet_seg"], "step": 0}
    batches = {f"{name}_images": _images(name, i) for i, name in enumerate(MODELS)}
    seg = _seg_batch()
    batches.update(seg_images=seg["images"], seg_labels=seg["labels"])
    started = {}
    for world in (2, 4):
        d = str(tmp_path_factory.mktemp(f"sp{world}"))
        torch.save(init, os.path.join(d, "sp_init.pt"))
        np.savez(os.path.join(d, "sp_batches.npz"), **batches)
        if world == 2:
            make_salt_dataset(d, n_images=12, n_test=4, shape=(32, 32))
        started[world] = (d, worker.start("sp", world, d))
    jax_fwd = {name: _jax_forward(name, *variables[name], batches[f"{name}_images"]) for name in MODELS}
    jax_step = _jax_step(*variables["resnet_seg"], seg)
    out = {"init": init, "batches": batches, "jax_forward": jax_fwd, "jax_step": jax_step}
    for world, (d, launch) in started.items():
        out[world] = dict(dir=d, ranks=worker.finish(launch, timeout=300))
    return out


def _hold_step(got, want, what):
    """Loss within 1e-5; every gradient leaf within 1e-4·max|g| + 1e-6
    with max|g| over the whole gradient; BN statistics within 1e-5."""
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5, rtol=0, err_msg=what)
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        gap = float((got["grads"][k] - g).abs().max())
        assert gap <= 1e-4 * gmax + 1e-6, (what, k, gap)
    stats = [k for k in want["state"] if "running" in k]
    assert stats
    for k in stats:
        assert float((got["state"][k] - want["state"][k]).abs().max()) <= 1e-5, (what, k)


@pytest.mark.parametrize("name", list(MODELS))
def test_parameter_trees_are_the_plain_ones(name):
    cfg = ModelConfig(**MODELS[name])
    plain = {k: tuple(v.shape) for k, v in build_model(cfg, "cpu").state_dict().items()}
    sharded = build_model(cfg, "cpu", spatial=True)
    assert {k: tuple(v.shape) for k, v in sharded.state_dict().items()} == plain
    assert sharded.spatial and not build_model(cfg, "cpu").spatial
    jcfg = _jcfg(MODELS[name])
    empty_model(cfg, "cpu", spatial=True).load_state_dict(from_flax(*_variables(jbuild(jcfg), jcfg, 0), cfg))


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_lay_out_as_jax_mesh(runs, world):
    """Rank r is data index r // 2 and sequence index r % 2: JAX's
    (dp, 1, sp) device order."""
    images, labels = (torch.from_numpy(runs["batches"][f"seg_{k}"]) for k in ("images", "labels"))
    rows = SEG_BATCH // (world // 2)
    for r, out in enumerate(runs[world]["ranks"]):
        assert out["layout"] == (world // 2, 2, r // 2, r % 2, 2)
        # shard_batch_spatial: the data index's rows, the sequence index's H block of the images only
        d, s, h = r // 2, r % 2, images.shape[1] // 2
        assert torch.equal(out["placed"]["images"], images[d * rows:(d + 1) * rows, s * h:(s + 1) * h])
        assert torch.equal(out["placed"]["labels"], labels[d * rows:(d + 1) * rows])


@pytest.mark.parametrize("name", list(MODELS))
def test_spatial_forward_is_the_plain_forward_and_jax_s(runs, name):
    cfg = ModelConfig(**MODELS[name])
    model = empty_model(cfg, "cpu")
    model.load_state_dict(runs["init"][name])
    with torch.no_grad():
        plain = model(torch.from_numpy(runs["batches"][f"{name}_images"])).numpy()
    for out in runs[2]["ranks"]:
        got = out["forward"][name].numpy()
        np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, runs["jax_forward"][name], rtol=2e-4, atol=2e-4)


def test_sequence_parallel_step_is_jax_s_and_the_one_rank_step(runs):
    ranks = runs[2]["ranks"]
    for out in ranks:
        _hold_step(out["step"], runs["jax_step"], "jax")
        _hold_step(out["step"], ranks[0]["plain_share"], "one rank")
    for k, v in ranks[0]["step"]["state"].items():
        assert torch.equal(v, ranks[1]["step"]["state"][k]), k


def test_two_by_two_step_is_the_two_data_positions_step(runs):
    """(2, 2) against the port's (2, 1) step: the mean of the data
    indices' one-rank gradients and BN statistics (per-tower BatchNorm)."""
    ranks = runs[4]["ranks"]
    shares = [ranks[0]["plain_share"], ranks[2]["plain_share"]]
    want = {"loss": sum(s["loss"] for s in shares) / 2,
            "grads": {k: (shares[0]["grads"][k] + shares[1]["grads"][k]) / 2 for k in shares[0]["grads"]},
            "state": {k: (shares[0]["state"][k] + shares[1]["state"][k]) / 2 for k in shares[0]["state"]}}
    for out in ranks:
        _hold_step(out["step"], want, "(2, 1)")


def test_zero1_beside_the_sequence_axis_is_bit_for_bit(runs):
    for out in runs[4]["ranks"]:
        assert out["zero_sharded"] and not out["replicated_sharded"]
        rep, zero = out["adam"]["replicated"], out["adam"]["zero"]
        for k, v in rep["model"].items():
            assert torch.equal(v, zero["model"][k]), k
        for i, slots in rep["optimizer"]["state"].items():
            for key, v in slots.items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(zero["optimizer"]["state"][i][key])), (i, key)


def test_trainer_trains_and_predicts_sequence_parallel(runs, tmp_path):
    d = runs[2]["dir"]
    data = os.path.join(d, "data")
    model = dict(worker.SP_SEG)
    plain = Trainer(str(tmp_path / "plain"), data, train_config=TrainConfig(**worker.SP_TRAINER), device="cpu", **model)
    plain.train(pipeline_lib.discover_ids(data), batch_size=4, steps=1)
    want = [e for e in read_ledger(str(tmp_path / "plain")) if e["event"] == "step_window"]
    got = [e for e in read_ledger(os.path.join(d, "sp-model")) if e["event"] == "step_window"]
    assert [(w["fold"], w["step"]) for w in got] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    for g, w in zip((got[0], got[2]), want):
        assert g["scalars"]["loss"] == pytest.approx(w["scalars"]["loss"], rel=1e-4)
    ranks = runs[2]["ranks"]
    for out in ranks:
        assert set(out["train"][0]) >= {"loss", "metrics/mean_iou"}
        assert all(np.isfinite(v) for r in out["train"] for v in r.values())
    on_sp_model = Trainer(os.path.join(d, "sp-model"), data, train_config=TrainConfig(**worker.SP_TRAINER),
                          device="cpu", **model)
    whole = on_sp_model.predict(os.path.join(d, "test"), batch_size=4)
    for out in ranks:
        assert out["predict"]["ids"] == whole["ids"]
        np.testing.assert_allclose(out["predict"]["probabilities"], whole["probabilities"], rtol=0, atol=1e-5)


def test_vit_fits_sequence_parallel(runs, tmp_path):
    kw = {k: v for k, v in worker.SP_FIT.items() if k != "sequence_parallel"}
    plain = ClassifierTrainer(str(tmp_path), None, ModelConfig(**worker.VIT_TINY), TrainConfig(**kw),
                              device="cpu").fit(batch_size=8, steps=2).final_metrics
    for out in runs[2]["ranks"]:
        assert set(out["fit"]) == set(plain)
        for k, v in plain.items():
            assert out["fit"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


@pytest.mark.parametrize("command", ["train", "fit"])
def test_sequence_parallel_flag_reaches_the_trainers(command, tmp_path):
    """``--sequence-parallel 2`` reaches ``TrainConfig.sequence_parallel``:
    one process cannot lay out two sequence positions, and says so with
    JAX's ``make_mesh`` text."""
    from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main

    if command == "train":
        data, _, _ = make_salt_dataset(tmp_path, n_images=4, n_test=0, shape=(32, 32))
        args = ["train", "--data-dir", data, "--model-dir", str(tmp_path / "m"), "--input-shape", "32", "32",
                "--n-blocks", "1", "1", "1", "--base-depth", "8"]
    else:
        args = ["fit", "--preset", "vit_s16_imagenet", "--model-dir", str(tmp_path / "m")]
    with pytest.raises(ValueError, match=r"1 devices not divisible by model_parallel\*sequence_parallel=2"):
        cli_main([*args, "--sequence-parallel", "2", "--device", "cpu"])
    # JAX's validate_spatial_config text for a height the degree does not admit
    if command == "train":
        bad, match = [a if a != "32" else "40" for a in args] + ["--sequence-parallel", "2"], r"\(e\.g\. 48\)"
    else:
        bad, match = args + ["--sequence-parallel", "3"], r"\(e\.g\. 240\)"
    with pytest.raises(ValueError, match=match):
        cli_main([*bad, "--device", "cpu"])
