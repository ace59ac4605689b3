"""The port's pipeline parallelism (``parallel/pipeline.py``,
``train/pipeline_step.py``, ``TrainConfig.pipeline_parallel``) against the
JAX package's ``parallel/pipeline.py`` and ``train/pipeline_step.py``, on
the CPU.

Offline, one process: the stage functions (the ViT's grouped blocks over
``stack_vit_block_params``, the Xception-41 middle flow over its stacked
trees) against JAX's; the one-rank schedule (``local_stages``) against the
plain step; JAX's ``ValueError`` texts; the ``fit`` flags.

2 and 4 gloo ranks (``tests/test_torch_dp_worker.py`` mode ``pp``, one
launch each, shared by the tests; every collective under the group's 60 s
timeout):

- the runner over all W ranks as one stage group (K = 2 and 4) on a toy
  stage against JAX's ``make_pipeline_fn`` on a K-device mesh: the output
  and the gradients of the stacked parameters and the input (each rank's
  nonzero only in its slot, summed over the group), and
  ``pipeline_apply_aux``'s per-stage means;
- at ``pipeline_parallel`` 2, ``(1, 2)`` and ``(2, 2)``: one plain-SGD
  step at lr 1 (the update is the gradient) of the ViT against JAX's
  ``make_train_step_pipeline`` on ``make_mesh(dp·2, model_parallel=2)``,
  loss within 1e-5 and every gradient leaf within 1e-4·max|g_leaf| + 1e-6
  (the port's train-step bounds); at ``(1, 2)`` the one-rank schedule bit
  for bit; the Xception-41 classifier's step on JAX's tiled-pair
  construction (each microbatch one pair, so per-microbatch BN is the
  whole batch's), in float64 as ``tests/test_torch_xception.py`` holds its
  batch-statistics gradients, without dropout against JAX's pipeline step
  at ``(2, 2)`` (loss 1e-5 relative, the same leaf bound, running
  statistics 1e-5; JAX's float64 step takes ~20 s to trace and compile per
  mesh) and with it against the port's plain data-parallel step at the
  same dp at both layouts (the same masks); both eval steps with ``valid`` weights, the Xception one on
  seeded BN statistics (after a step from flax's initial statistics both
  packages' eval losses are NaN);
- ``fit`` at ``pipeline_parallel`` 2 on both narrow models: a resumed
  pipelined run is bit for bit the uninterrupted one, and its checkpoint
  restores into a plain ``fit`` and ``serving_fn``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import os
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.models import resnet as jresnet
from tensorflowdistributedlearning_tpu.models import vit as jvit
from tensorflowdistributedlearning_tpu.models import xception as jxception
from tensorflowdistributedlearning_tpu.ops import losses as jlosses
from tensorflowdistributedlearning_tpu.parallel import make_mesh, replicate, shard_batch
from tensorflowdistributedlearning_tpu.parallel import pipeline as jpp
from tensorflowdistributedlearning_tpu.parallel.mesh import MODEL_AXIS
from tensorflowdistributedlearning_tpu.train import pipeline_step as jps
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch import __main__ as cli
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig, require_supported_training
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.models import vit as tvit
from tensorflowdistributedlearning_tpu_torch.models import xception as txc
from tensorflowdistributedlearning_tpu_torch.parallel import pipeline as tpp
from tensorflowdistributedlearning_tpu_torch.train import pipeline_step as tps
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state, template_train_state
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, params_from_flax
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_tensor_parallel import _fill


PP, M = worker.PP, worker.PP_M
WORLDS = [2, 4]


# -- the JAX side ------------------------------------------------------------------


def jax_toy_stage(p, x):
    y = jax.lax.conv_general_dilated(x, p["w"], (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jax.nn.relu(y + p["b"])


def _toy(world):
    rng = np.random.default_rng(40 + world)
    return {"w": rng.normal(0, 0.3, (world, 3, 3, 4, 4)).astype(np.float32),
            "b": rng.normal(0, 0.1, (world, 4)).astype(np.float32),
            "x": rng.normal(0, 1, (6, 2, 8, 8, 4)).astype(np.float32),
            "w_out": rng.normal(0, 1, (6, 2, 8, 8, 4)).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def _models():
    """The ViT of JAX's pipeline tests from flax's init, and the Xception-41
    classifier of JAX's tiled-pair test with every leaf (BN statistics
    included) drawn from a numpy seed."""
    vit = jconfig.ModelConfig(**worker.PP_VIT)
    jm = jbuild(vit)
    v = jm.init(jax.random.PRNGKey(1), np.zeros((1, 16, 16, 3), np.float32), train=False)
    xc = jconfig.ModelConfig(**worker.PP_XC)
    xm = jbuild(xc)
    params, stats = _fill(xm, (1, 64, 64, 3), seed=3)
    return {
        "vit": dict(jm=jm, cfg=vit, tcfg=ModelConfig(**worker.PP_VIT), params=jax.device_get(v["params"]), stats={}),
        "xc": dict(jm=xm, cfg=xc, tcfg=ModelConfig(**worker.PP_XC), params=params, stats=stats),
    }


def _jax_state(name, params=None, stats=None):
    m = _models()[name]
    params = m["params"] if params is None else params
    stats = m["stats"] if stats is None else stats
    tx = jstep.make_optimizer(jconfig.TrainConfig(**worker.TP_SGD))
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
                       apply_fn=m["jm"].apply, tx=tx)


def _tiled_pairs(dp, seed=7):
    """JAX's construction: each data position's 8 rows are one distinct
    pair of images tiled 4x, so each of the 4 microbatches is the pair."""
    rng = np.random.default_rng(seed)
    uniq = rng.normal(0, 1, (2 * dp, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 4, 2 * dp).astype(np.int32)
    images = np.concatenate([np.tile(uniq[2 * d:2 * d + 2], (4, 1, 1, 1)) for d in range(dp)])
    return images, np.concatenate([np.tile(labels[2 * d:2 * d + 2], 4) for d in range(dp)])


def _batches():
    rng = np.random.default_rng(11)
    out = {"vit_images": rng.normal(0, 1, (16, 16, 16, 3)).astype(np.float32),
           "vit_labels": rng.integers(0, 4, 16).astype(np.int32),
           "vit_eval_images": rng.normal(0, 1, (16, 16, 16, 3)).astype(np.float32),
           "vit_eval_labels": rng.integers(0, 4, 16).astype(np.int32),
           "vit_eval_valid": np.array([1, 1, 1, 0] * 4, np.float32)}
    for world in WORLDS:
        images, labels = _tiled_pairs(world // PP)
        out[f"xc{world}_images"], out[f"xc{world}_labels"] = images, labels
        out[f"xc{world}_eval_images"] = rng.normal(0, 1, images.shape).astype(np.float32)
        out[f"xc{world}_eval_labels"] = rng.integers(0, 4, len(labels)).astype(np.int32)
        out[f"xc{world}_eval_valid"] = np.tile(np.array([1, 0, 1, 1], np.float32), len(labels) // 4)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches' ranks, and the JAX references, computed while the
    ranks run."""
    init = {name: {"state_dict": from_flax(m["params"], m["stats"], m["tcfg"]), "step": 0}
            for name, m in _models().items()}
    batches = _batches()
    out = {"batches": batches}
    started = []
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"pp{world}"))
        torch.save(init, os.path.join(d, "pp_init.pt"))
        np.savez(os.path.join(d, "pp_batches.npz"), **batches)
        np.savez(os.path.join(d, "pp_toy.npz"), **_toy(world))
        out[world] = dict(dir=d)
        started.append(worker.start("pp", world, d))
    try:
        out["jax"] = _references(batches)
    finally:
        for world, launched in zip(WORLDS, started):
            out[world]["ranks"] = worker.finish(launched)
    return out


def _rows(batches, prefix):
    return {k: batches[f"{prefix}_{k}"] for k in ("images", "labels", "valid") if f"{prefix}_{k}" in batches}


def _jnp64():
    jnp64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    jnp64.float32 = jnp.float64
    return jnp64


def _jax_toy(world):
    """JAX's ``make_pipeline_fn`` on a ``world``-stage mesh: the output, the
    gradients of the stacked parameters and the input, and each stage's
    ``pipeline_apply_aux`` mean."""
    toy = _toy(world)
    jmesh = make_mesh(world, model_parallel=world)
    run = jpp.make_pipeline_fn(jax_toy_stage, jmesh)
    stacked = {"w": jnp.asarray(toy["w"]), "b": jnp.asarray(toy["b"])}
    x = jnp.asarray(toy["x"])
    gp, gx = jax.grad(lambda p, x: jnp.sum(jnp.asarray(toy["w_out"]) * run(p, x)), argnums=(0, 1))(stacked, x)

    def body(shard, x):
        def stage(p, h):
            y = jax_toy_stage(p, h)
            return y, jnp.mean(y, axis=(0, 1, 2))
        return jpp.pipeline_apply_aux(stage, jax.tree_util.tree_map(lambda a: a[0], shard), x)

    _, aux = jax.jit(jax.shard_map(body, mesh=jmesh, in_specs=(jpp.stage_in_spec(), P()),
                                   out_specs=(P(), P(MODEL_AXIS))))(stacked, x)
    return {"out": np.asarray(run(stacked, x)), "grad_w": np.asarray(gp["w"]), "grad_b": np.asarray(gp["b"]),
            "grad_x": np.asarray(gx), "aux": np.asarray(aux).reshape(world, -1)}


def _jax_eval(name, world, batch):
    m = _models()[name]
    jmesh = make_mesh(world, model_parallel=PP)
    jps._make_eval_step_pipeline_xception_cached.cache_clear()
    try:
        with mock.patch.object(jxception, "XceptionExitHead",
                               functools.partial(jxception.XceptionExitHead, keep_prob=1.0)):
            step = jps.make_eval_step_pipeline(jmesh, jstep.ClassificationTask(), m["cfg"], M)
            return jstep.compute_metrics(step(replicate(_jax_state(name), jmesh), shard_batch(batch, jmesh)))
    finally:
        jps._make_eval_step_pipeline_xception_cached.cache_clear()


def _jax_xception_step_f64(world, batch):
    """JAX's Xception pipeline step in float64 (``jax.enable_x64``, the
    modules' float32 read as float64), the exit head's dropout off."""
    m = _models()["xc"]
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    jnp64 = _jnp64()
    batch = dict(batch, images=batch["images"].astype(np.float64))
    no_dropout = functools.partial(jxception.XceptionExitHead, keep_prob=1.0)
    jps._make_train_step_pipeline_xception_cached.cache_clear()
    try:
        with jax.enable_x64(True), mock.patch.object(jxception, "jnp", jnp64), \
                mock.patch.object(jresnet, "jnp", jnp64), mock.patch.object(jlosses, "jnp", jnp64), \
                mock.patch.object(jxception, "XceptionExitHead", no_dropout):
            return _jax_step("xc", world, batch, lambda mesh: jps.make_train_step_pipeline(
                mesh, jstep.ClassificationTask(), m["cfg"], M, donate=False, seed=3),
                params=f64(m["params"]), stats=f64(m["stats"]))
    finally:
        jps._make_train_step_pipeline_xception_cached.cache_clear()


# the float64 Xception step costs JAX ~20 s of tracing and compiling per
# mesh: it is held at (2, 2), where the data group's mean joins the stage sum
XC_JAX_WORLDS = (4,)


def _references(batches):
    refs = {}
    for world in WORLDS:
        refs[("toy", world)] = _jax_toy(world)
        refs[("vit", world)] = _jax_step("vit", world, _rows(batches, "vit"), lambda mesh: jps.make_train_step_pipeline(
            mesh, jstep.ClassificationTask(), _models()["vit"]["cfg"], M, donate=False))
        refs[("vit_eval", world)] = _jax_eval("vit", world, _rows(batches, "vit_eval"))
        refs[("xc_eval", world)] = _jax_eval("xc", world, _rows(batches, f"xc{world}_eval"))
    for world in XC_JAX_WORLDS:
        refs[("xc", world)] = _jax_xception_step_f64(world, _rows(batches, f"xc{world}"))
    return refs


def _jax_step(name, world, batch, make_step, params=None, stats=None):
    """One plain-SGD step at lr 1 of JAX's on a (world / 2, 2) mesh: the
    loss, the gradient (the update, differenced in float64, then mapped to
    the port's names in float32: a relative 6e-8) and the state."""
    m = _models()[name]
    jmesh = make_mesh(world, model_parallel=PP)
    state = replicate(_jax_state(name, params, stats), jmesh)
    before = jax.device_get(state)
    new, metrics = make_step(jmesh)(state, shard_batch(batch, jmesh))
    after = jax.device_get(new)
    f32 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    diff = jax.tree_util.tree_map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
                                  before.params, after.params)
    return {"loss": jstep.compute_metrics(metrics)["loss"], "grads": params_from_flax(diff, m["tcfg"]),
            "state": from_flax(f32(after.params), f32(after.batch_stats), m["tcfg"])}


def _hold(got, want, what, stats_tol=1e-5, rel_loss=False):
    """Loss within 1e-5 (relative with ``rel_loss``); every gradient leaf
    within 1e-4·max|g_leaf| + 1e-6; BN running statistics within
    ``stats_tol``."""
    gap = abs(got["loss"] - want["loss"])
    assert gap <= 1e-5 * (max(1.0, abs(want["loss"])) if rel_loss else 1.0), (what, got["loss"], want["loss"])
    for k, g in want["grads"].items():
        mine = got["grads"][k].double()
        g = g.double()
        bound = 1e-4 * float(g.abs().max()) + 1e-6
        assert float((mine - g).abs().max()) <= bound, (what, k, float((mine - g).abs().max()), bound)
    stats = [k for k in want["state"] if "running" in k]
    for k in stats:
        assert float((got["state"][k].double() - want["state"][k].double()).abs().max()) <= stats_tol, (what, k)


# -- offline ---------------------------------------------------------------------


def test_bubble_fraction_is_jax_docstring_formula():
    assert tpp.bubble_fraction(2, 4) == 1 / 5
    assert tpp.bubble_fraction(4, 8) == 3 / 11


def test_vit_stacking_and_grouped_stage_match_jax():
    """``stack_vit_block_params`` is JAX's stacking leaf by leaf (the port's
    names), and ``grouped_pipeline_stage_fn`` on a stage's slot is JAX's
    on the same tokens."""
    m = _models()["vit"]
    params = {k: v for k, v in from_flax(m["params"], {}, m["tcfg"]).items()}
    stacked = tvit.stack_vit_block_params(params, 4, n_stages=2)
    jstacked = jvit.stack_vit_block_params(m["params"], 4, n_stages=2)
    block = {f"block1.{k}": v for k, v in tvit.block_params(params, 1).items()}
    assert set(block) == {k for k in params if k.startswith("block1.")}
    # slot (k, g) is block 2k+g+1, as in JAX's stacking (its leaves through the port's names)
    one_block = dataclasses.replace(m["tcfg"], vit_layers=1)
    for k in range(2):
        for g in range(2):
            slot = {"block1": jax.tree_util.tree_map(lambda a: np.asarray(a[k][g]), jstacked)}
            rest = {key: v for key, v in m["params"].items() if not key.startswith("block")}
            want = params_from_flax({**rest, **slot}, one_block)
            for name, leaf in stacked.items():
                assert torch.equal(leaf[k, g], params[f"block{2 * k + g + 1}.{name}"])
                assert torch.equal(leaf[k, g], want[f"block1.{name}"])
    with pytest.raises(ValueError) as got:
        tvit.stack_vit_block_params(params, 4, n_stages=3)
    with pytest.raises(ValueError) as want:
        jvit.stack_vit_block_params(m["params"], 4, n_stages=3)
    assert str(got.value) == str(want.value)
    tokens = np.random.default_rng(9).normal(0, 1, (2, 16, 32)).astype(np.float32)
    stage = tvit.grouped_pipeline_stage_fn(m["tcfg"], 2)
    jstage = jvit.grouped_pipeline_stage_fn(m["cfg"], 2)
    for k in range(2):
        got = stage({n: v[k] for n, v in stacked.items()}, torch.from_numpy(tokens))
        want = np.asarray(jstage(jax.tree_util.tree_map(lambda a: a[k], jstacked), jnp.asarray(tokens)))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=0)


def test_xception_middle_flow_views_and_stacks_match_jax():
    """The entry flow, the stacked middle units through the grouped train
    stage (per-microbatch statistics, JAX's emitted running-stat updates)
    and the exit head of the canonical model against JAX's modules on the
    same tree, float32 within 1e-5·max(1, max|out|), statistics 1e-5."""
    m = _models()["xc"]
    cfg = m["tcfg"]
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(from_flax(m["params"], m["stats"], cfg))
    model.keep_prob = 1.0
    model.train()
    x = np.random.default_rng(5).normal(0, 1, (4, 64, 64, 3)).astype(np.float32)
    bp, bs = m["params"]["backbone"], m["stats"]["backbone"]
    entry_keys = ("conv1_1", "conv1_2", "entry_block1_unit1", "entry_block2_unit1", "entry_block3_unit1")
    jfeats, _ = jxception.XceptionEntryFlow(m["cfg"]).apply(
        {"params": {k: bp[k] for k in entry_keys}, "batch_stats": {k: bs[k] for k in entry_keys}}, jnp.asarray(x),
        True, mutable=["batch_stats"])
    feats = txc.XceptionEntryFlow(model)(torch.from_numpy(x))
    jfeats = np.asarray(jfeats)
    np.testing.assert_allclose(feats.detach().numpy(), jfeats, atol=1e-5 * max(1.0, float(np.abs(jfeats).max())))
    # the middle flow: stage 1 of 2 (units 5-8) on the entry's output
    stacked = txc.stack_middle_unit_tree({n: t for n, t in model.backbone.named_buffers()}, 2)
    jst = jxception.stack_middle_unit_tree(bs, 2)
    assert set(stacked) == {"separable_conv1.depthwise_bn.running_mean", "separable_conv1.depthwise_bn.running_var",
                            "separable_conv1.pointwise_bn.running_mean", "separable_conv1.pointwise_bn.running_var",
                            "separable_conv2.depthwise_bn.running_mean", "separable_conv2.depthwise_bn.running_var",
                            "separable_conv2.pointwise_bn.running_mean", "separable_conv2.pointwise_bn.running_var",
                            "separable_conv3.depthwise_bn.running_mean", "separable_conv3.depthwise_bn.running_var",
                            "separable_conv3.pointwise_bn.running_mean", "separable_conv3.pointwise_bn.running_var"}
    np.testing.assert_array_equal(stacked["separable_conv2.pointwise_bn.running_var"].numpy(),
                                  np.asarray(jst["separable_conv2"]["pointwise_bn"]["var"]))
    unstacked = txc.unstack_middle_unit_tree(stacked)
    for n, t in model.backbone.named_buffers():
        if n.startswith(txc.MIDDLE_FLOW_PREFIX):
            assert torch.equal(unstacked[n], t)
    # train-mode BN over 4 units amplifies float32 rounding (the Xception
    # tests' finding): the train stage is held in float64 on both sides, on
    # the same input
    units = [worker._float64(copy.deepcopy(u)) for u in txc.middle_units(model)[4:]]
    held = [b.clone() for u in units for b in u.buffers()]
    with mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
        y, new = txc.grouped_middle_stage_fn(cfg, 4, train=True)(units, torch.from_numpy(jfeats).double())
    assert all(torch.equal(a, b) for a, b in zip(held, [b for u in units for b in u.buffers()]))  # restored
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    with jax.enable_x64(True), mock.patch.object(jxception, "jnp", _jnp64()):
        jy, jnew = jxception.grouped_middle_stage_fn(m["cfg"], 4, True)(
            (jax.tree_util.tree_map(lambda a: a[1], f64(jxception.stack_middle_unit_tree(bp, 2))),
             jax.tree_util.tree_map(lambda a: a[1], f64(jst))), jnp.asarray(jfeats.astype(np.float64)))
        jy, jnew = np.asarray(jy), jax.device_get(jnew)
    assert jy.dtype == np.float64 and y.dtype == torch.float64
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=1e-5 * max(1.0, float(np.abs(jy).max())), rtol=0)
    jy = jy.astype(np.float32)
    probe = txc.middle_unit_module(cfg)
    names = [n for n, mod in probe.named_modules() if isinstance(mod, txc.BatchNorm)]
    assert len(new) == 2 * len(names) * 4
    for i in range(4):
        for j, n in enumerate(names):
            path = n.split(".")
            leaf = jnew
            for part in path:
                leaf = leaf[part]
            np.testing.assert_allclose(new[2 * (i * len(names) + j)].numpy(), np.asarray(leaf["mean"][i]), atol=1e-5)
            np.testing.assert_allclose(new[2 * (i * len(names) + j) + 1].numpy(), np.asarray(leaf["var"][i]),
                                       atol=1e-5)
    # the exit head on the middle flow's output
    exit_keys = ("exit_block1_unit1", "exit_block2_unit1")
    jlogits, _ = jxception.XceptionExitHead(m["cfg"], keep_prob=1.0).apply(
        {"params": {**{k: bp[k] for k in exit_keys}, "logits": m["params"]["logits"]},
         "batch_stats": {k: bs[k] for k in exit_keys}}, jnp.asarray(jy), True, mutable=["batch_stats"])
    head = txc.XceptionExitHead(model)
    assert head.keep_prob == 1.0 and txc.XceptionExitHead(build_model(cfg, "cpu")).keep_prob == txc.DEFAULT_KEEP_PROB
    logits = head(torch.from_numpy(jy))
    jlogits = np.asarray(jlogits)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=1e-5 * max(1.0, float(np.abs(jlogits).max())))
    # the views' names are the canonical model's
    own = dict(model.named_parameters())
    assert all(p is own[f"backbone.{n}"] for n, p in txc.XceptionEntryFlow(model).named_parameters())
    assert all(p is own[n if n.startswith("logits") else f"backbone.{n}"]
               for n, p in txc.XceptionExitHead(model).named_parameters())


@pytest.mark.parametrize("name", ["vit", "xc"])
def test_one_rank_schedule_is_the_plain_step_where_microbatches_share_statistics(name):
    """The one-rank schedule (``local_stages=2``) against the plain
    one-process step from the same state: the ViT on any batch, the
    Xception classifier on one pair tiled 4x (its dropout off); loss within
    1e-5 and every gradient leaf within 1e-4·max|g_leaf| + 1e-6."""
    m = _models()[name]
    cfg = m["tcfg"]
    init = from_flax(m["params"], m["stats"], cfg)
    task = tstep.ClassificationTask()
    if name == "vit":
        b = _batches()
        batch = {"images": torch.from_numpy(b["vit_images"][:8]), "labels": torch.from_numpy(b["vit_labels"][:8])}
    else:
        images, labels = _tiled_pairs(1)
        batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for what, make in (("plain", lambda: tstep.make_train_step(task)),
                           ("pipe", lambda: tps.make_train_step_pipeline(task, cfg, M, local_stages=2))):
            state = create_train_state(cfg, TrainConfig(**worker.TP_SGD), "cpu", state_dict=init)
            if name == "xc":
                worker._float64(state.model).keep_prob = 1.0
            with mock.patch.object(torch.Tensor, "float", torch.Tensor.double) if name == "xc" else \
                    contextlib.nullcontext():
                state, metrics = make()(state, {k: v.double() if name == "xc" and k == "images" else v
                                                for k, v in batch.items()})
            out[what] = {"loss": tstep.compute_metrics(metrics)["loss"],
                         "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()},
                         "state": {k: v.clone() for k, v in state.model.state_dict().items()}}
    finally:
        torch.set_num_threads(threads)
    _hold(out["pipe"], out["plain"], f"{name} one-rank schedule", rel_loss=True)


def test_jax_value_error_texts():
    resnet = dict(num_classes=4, input_shape=(16, 16), input_channels=3, n_blocks=(1, 1, 1), output_stride=None)
    vit, xc = worker.PP_VIT, worker.PP_XC
    for kw, k, mb in ((resnet, 2, 2), (dict(vit, vit_layers=6), 4, 4), (xc, 3, 6),
                      (dict(xc, num_classes=None, output_stride=16), 4, 4), (vit, 4, 2), (xc, 4, 2)):
        with pytest.raises(ValueError) as want:
            jps.validate_pipeline_config(jconfig.ModelConfig(**kw), k, mb)
        with pytest.raises(ValueError) as got:
            tps.validate_pipeline_config(ModelConfig(**kw), k, mb)
        assert str(got.value) == str(want.value)
    stub = types.SimpleNamespace(backbone="vit", moe_experts=2, num_classes=4, vit_layers=4)
    with pytest.raises(ValueError) as want:
        jps.validate_pipeline_config(stub, 2, 2)
    with pytest.raises(ValueError) as got:
        tps.validate_pipeline_config(stub, 2, 2)
    assert str(got.value) == str(want.value)
    for kw in (dict(pipeline_parallel=4, pipeline_microbatches=2), dict(pipeline_parallel=2, model_parallel=2),
               dict(pipeline_parallel=2, grad_accum_steps=2), dict(pipeline_microbatches=2)):
        with pytest.raises(ValueError) as want:
            jconfig.TrainConfig(**kw)
        with pytest.raises(ValueError) as got:
            TrainConfig(**kw)
        assert str(got.value) == str(want.value)
    # require_supported_training gives validate's text; auto (queue A 12.5)
    # and the sequence axis (queue A 12.4) are taken; the expert axis (queue
    # A 12.3) is taken by the MoE ViT only, with JAX's texts for a dense ViT
    # and for the pipeline beside it
    with pytest.raises(ValueError, match="does not support backbone='resnet'"):
        require_supported_training(ModelConfig(**resnet), TrainConfig(pipeline_parallel=2))
    require_supported_training(ModelConfig(**vit), TrainConfig(pipeline_parallel=2, pipeline_microbatches=4))
    require_supported_training(ModelConfig(**vit), TrainConfig(parallelism="auto"))
    require_supported_training(ModelConfig(**vit), TrainConfig(sequence_parallel=2))
    with pytest.raises(ValueError, match=r"expert_parallel=2 requires moe_experts=2 .*got moe_experts=0"):
        require_supported_training(ModelConfig(**vit), TrainConfig(expert_parallel=2))
    require_supported_training(ModelConfig(**dict(vit, moe_experts=2)), TrainConfig(expert_parallel=2))
    with pytest.raises(ValueError) as want:
        jconfig.TrainConfig(expert_parallel=2, pipeline_parallel=2)
    with pytest.raises(ValueError) as got:
        TrainConfig(expert_parallel=2, pipeline_parallel=2)
    assert str(got.value) == str(want.value)
    # the runner's local batch: the text of JAX's traced step
    jmesh = make_mesh(2, model_parallel=2)
    bad = {"images": np.zeros((6, 16, 16, 3), np.float32), "labels": np.zeros((6,), np.int32)}
    with pytest.raises(ValueError) as want:
        jps.make_train_step_pipeline(jmesh, jstep.ClassificationTask(), jconfig.ModelConfig(**vit), 4,
                                     donate=False)(replicate(_jax_state("vit"), jmesh), shard_batch(bad, jmesh))
    state = create_train_state(ModelConfig(**vit), TrainConfig(**worker.TP_SGD), "cpu",
                               generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as got:
        tps.make_train_step_pipeline(tstep.ClassificationTask(), ModelConfig(**vit), 4, local_stages=2)(
            state, {k: torch.from_numpy(v) for k, v in bad.items()})
    assert str(got.value) == str(want.value) == "local batch 6 not divisible into 4 microbatches"


def test_trainer_refuses_the_pipeline_naming_fit(tmp_path):
    with pytest.raises(NotImplementedError, match="ClassifierTrainer.fit .* is the pipeline's only entry point"):
        Trainer(str(tmp_path), str(tmp_path), train_config=TrainConfig(pipeline_parallel=2), device="cpu",
                n_blocks=(1, 1, 1), input_shape=(33, 33), base_depth=8)


def test_fit_command_takes_the_pipeline_flags(tmp_path, monkeypatch):
    seen = {}

    def fake(preset, model_dir, **kw):
        seen.update(kw, preset=preset)
        from tensorflowdistributedlearning_tpu_torch.train.fit import FitResult

        return FitResult({"loss": 0.0}, 1, 0)

    monkeypatch.setattr("tensorflowdistributedlearning_tpu_torch.train.fit.fit_preset", fake)
    assert cli.main(["fit", "--preset", "vit_s16_imagenet", "--model-dir", str(tmp_path), "--device", "cpu",
                     "--pipeline-parallel", "2", "--pipeline-microbatches", "4"]) == 0
    assert seen["pipeline_parallel"] == 2 and seen["pipeline_microbatches"] == 4
    args = cli.build_parser().parse_args(["fit", "--preset", "p", "--model-dir", "m"])
    assert args.pipeline_parallel is None and args.pipeline_microbatches is None


# -- W gloo ranks ----------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_runner_matches_jax_make_pipeline_fn(runs, world):
    want = runs["jax"][("toy", world)]
    for r, o in enumerate(runs[world]["ranks"]):
        assert o["runner_layout"] == (1, world, world, 1)
        assert o["runner_own_slot_only"]
        got = o["runner"]
        np.testing.assert_allclose(got["out"].numpy(), want["out"], atol=1e-5, rtol=1e-5)
        for key in ("grad_w", "grad_b"):
            np.testing.assert_allclose(got[key].numpy(), want[key], atol=2e-4, rtol=2e-4)
        if r == 0:
            np.testing.assert_allclose(got["grad_x"].numpy(), want["grad_x"], atol=2e-4, rtol=2e-4)
        else:
            assert got["grad_x"] is None
        np.testing.assert_allclose(o["runner_aux"].numpy(), want["aux"][r], atol=1e-5, rtol=1e-5)
        assert o["runner_stage_count"] == (
            f"1 pipeline stages on a model axis of size {world}; the stage count must equal the mesh's model-axis "
            "size")


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_lay_out_as_jax_pipeline_mesh(runs, world):
    assert [o["layout"] for o in runs[world]["ranks"]] == [
        (world // PP, PP, r // PP, r % PP, PP) for r in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_vit_pipeline_step_matches_jax(runs, world):
    want = runs["jax"][("vit", world)]
    for r, o in enumerate(runs[world]["ranks"]):
        _hold(o["vit"], want, f"vit pipeline step, rank {r} of {world}")
    r0 = runs[world]["ranks"][0]
    if world == PP:
        one = r0["vit_one_rank"]
        assert one["loss"] == r0["vit"]["loss"]
        assert all(torch.equal(one["grads"][k], r0["vit"]["grads"][k]) for k in one["grads"])
        assert all(torch.equal(one["state"][k], r0["vit"]["state"][k]) for k in one["state"])
    # every rank ends with the same state
    for o in runs[world]["ranks"][1:]:
        assert all(torch.equal(o["vit"]["state"][k], v) for k, v in r0["vit"]["state"].items())


@pytest.mark.parametrize("world", XC_JAX_WORLDS)
def test_xception_pipeline_step_matches_jax_in_float64(runs, world):
    want = runs["jax"][("xc", world)]
    for r, o in enumerate(runs[world]["ranks"]):
        assert all(g.dtype == torch.float64 for g in o["xc"]["grads"].values())
        _hold(o["xc"], want, f"xception pipeline step, rank {r} of {world}", rel_loss=True)


@pytest.mark.parametrize("world", WORLDS)
def test_xception_pipeline_step_is_the_plain_step_with_the_same_dropout_masks(runs, world):
    """On the tiled pairs the pipeline's per-microbatch BatchNorm is the
    whole local batch's, so with the dropout on the pipelined step is the
    plain data-parallel step at the same dp: the exit head's masks are
    keyed alike."""
    for r, o in enumerate(runs[world]["ranks"]):
        _hold(o["xc_dropout"], o["xc_plain"], f"xception dropout step, rank {r} of {world}", rel_loss=True)
        assert abs(o["xc_dropout"]["loss"] - o["xc"]["loss"]) > 1e-3  # the masks drew something


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["vit", "xc"])
def test_eval_steps_match_jax_with_valid_weights(runs, world, name):
    want = runs["jax"][(f"{name}_eval", world)]
    assert np.isfinite(want["loss"])
    for o in runs[world]["ranks"]:
        got = o[f"{name}_eval"]
        assert sorted(got) == sorted(want)
        assert got["metrics/top1"] == pytest.approx(want["metrics/top1"], abs=1e-6)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


def _final_state(model_dir, cfg, tcfg):
    return CheckpointManager(model_dir).restore_latest(template_train_state(cfg, tcfg, "cpu")).state_dict()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["vit", "xc"])
def test_pipelined_fit_resumes_bit_for_bit_and_restores_plain(runs, world, name, tmp_path):
    cfg = ModelConfig(**dict(worker.VIT_TINY, vit_layers=2)) if name == "vit" else worker.zero_fit_model()
    ranks = runs[world]["ranks"]
    fit = ranks[0]["fit_runs"]
    assert fit[f"{name}_resumed_4"] == fit[f"{name}_straight_4"]
    assert all(np.isfinite(v) for v in fit[f"{name}_straight_4"].values())
    assert all(o["fit_runs"] == fit for o in ranks)
    d = runs[world]["dir"]
    plain = TrainConfig(**{k: v for k, v in worker.PP_FIT.items() if not k.startswith("pipeline")})
    a = _final_state(os.path.join(d, f"pp-fit-{name}-resumed"), cfg, plain)
    b = _final_state(os.path.join(d, f"pp-fit-{name}-straight"), cfg, plain)
    assert a["step"] == b["step"] == 4
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert all(torch.equal(a["ema"][k], b["ema"][k]) for k in a["ema"])
    # the pipelined checkpoint is the plain strategy's: serving and a plain fit go on from it
    trainer = ClassifierTrainer(os.path.join(d, f"pp-fit-{name}-straight"), None, cfg, plain, device="cpu")
    out = trainer.serving_fn()(np.zeros((2,) + cfg.input_shape + (3,), np.float32))
    assert np.asarray(out["probabilities"]).shape == (2, cfg.num_classes)
    assert ranks[0]["fit_batch_error"] == "per-replica batch 6 not divisible into 4 pipeline microbatches"
    if world == PP:  # (one layout suffices: the checkpoint format does not depend on it)
        import shutil

        plain_dir = str(tmp_path / "plain")
        shutil.copytree(os.path.join(d, f"pp-fit-{name}-straight"), plain_dir)
        result = ClassifierTrainer(plain_dir, None, cfg, plain, device="cpu").fit(batch_size=8, steps=5)
        assert result.steps == 5 and np.isfinite(result.final_metrics["loss"])
