"""The port's train step against the JAX package's, on the CPU.

Both packages start from one JAX ``TrainState`` (numpy-seeded params and BN
statistics, carried over by ``utils.convert.from_flax_train_state``) and take
the same batches. The JAX side runs its own ``make_train_step`` on a
one-device mesh; the port runs its single-device step with
``use_pallas_depthwise=True`` (on the CPU the depthwise autograd Function's
plain arms). The first step is held under the Lovász objective; the
multi-step SGD and Adam trajectories under sigmoid cross entropy (see
``_JaxBceTask``). Tolerances, stated where used: loss 1e-5; gradients per leaf
``1e-4·max|g| + 1e-6`` with ``max|g|`` over the whole gradient (a leaf
whose gradient is a small residual of cancelling sums, such as a bias in
front of a training-mode BatchNorm, carries f32 rounding of 1e-3 of its own
size: the same gap appears between the port's two depthwise routes and JAX,
and with the Lovász loss replaced by a fixed cotangent); parameters after 1 Nesterov-SGD step 1e-3·lr (a thousandth of a
unit-gradient update), after 3 steps 0.2·lr per step; after 3 Adam steps 0.05·lr per
step in the mean over all parameters, and Adam's own bound 2·lr per step for
every entry (the first updates are ~lr·sign(g), so a gradient entry below the
two packages' f32 noise floor flips sign and moves a parameter by up to
2·lr: about a tenth of the tiny model's entries do); BN running statistics
1e-5 after one step, 1e-3 after three (they follow the drifting
activations); lr schedules 1e-12 relative against the
JAX host mirror, and 1e-6 relative + 1e-9 absolute against optax's float32
schedules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.ops import losses as jlosses
from tensorflowdistributedlearning_tpu.parallel import make_mesh, replicate, shard_batch
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.models.layers import DepthwiseConv2D
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk
from tensorflowdistributedlearning_tpu_torch.ops import losses as tlosses
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, from_flax_train_state
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY = dict(n_blocks=(1, 1, 1), input_shape=(33, 33), base_depth=16, width_multiplier=0.125)


# Multi-step trajectories are compared under a smooth objective. The Lovász
# hinge's gradient is piecewise constant in the logits: once the two
# packages' logits differ by an ulp, pixels whose errors lie an ulp apart
# sort in another order and the gradient moves by percents, so a trajectory
# comparison would measure that, not the optimizer and the schedule.
class _JaxBceTask(jstep.SegmentationTask):
    def loss(self, logits, batch):
        return jlosses.sigmoid_cross_entropy(logits, batch["labels"])


class _PortBceTask(tstep.SegmentationTask):
    def loss(self, logits, batch):
        return tlosses.sigmoid_cross_entropy(logits, batch["labels"])


def _flax_variables(jm, seed=0):
    """numpy-seeded params and BN statistics in the flax tree of ``jm``
    (shapes from ``eval_shape``; no flax init is run)."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False), jax.random.key(0), jnp.zeros((1, 33, 33, 2)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if shape[2] != 1 else int(np.prod(shape[:2]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)  # biases, BN bias, running means

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(fill, shapes["batch_stats"])
    return params, stats


def _batches(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = tsyn.synthetic_segmentation_batch(rng, 4, (33, 33))
        b["images"] = b["images"] + rng.normal(0, 0.3, b["images"].shape).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg = jconfig.ModelConfig(**TINY, use_pallas_depthwise=True)
    jm = jbuild(jcfg)
    params, stats = _flax_variables(jm)
    return dict(jm=jm, params=params, stats=stats, mesh=make_mesh(1), cfg=ModelConfig(**TINY, use_pallas_depthwise=True))


def _jax_state(setup, tcfg_kwargs):
    tx = jstep.make_optimizer(jconfig.TrainConfig(**tcfg_kwargs))
    state = JTrainState(
        step=jnp.zeros((), jnp.int32), params=setup["params"], batch_stats=setup["stats"],
        opt_state=tx.init(setup["params"]), apply_fn=setup["jm"].apply, tx=tx,
    )
    return replicate(state, setup["mesh"])


def _port_state(setup, jstate, tcfg_kwargs):
    state_dict, step = from_flax_train_state(jax.device_get(jstate), setup["cfg"])
    return create_train_state(setup["cfg"], TrainConfig(**tcfg_kwargs), "cpu", state_dict=state_dict, step=step)


def _torch_batch(b):
    return {"images": torch.from_numpy(b["images"]), "labels": torch.from_numpy(b["labels"])}


def _assert_params_close(setup, jstate, tstate, atol, rtol, stats_atol=1e-5):
    jstate = jax.device_get(jstate)
    want = from_flax(jstate.params, jstate.batch_stats, setup["cfg"])
    got = tstate.model.state_dict()
    for name, w in want.items():
        g = got[name]
        if "running" in name:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=stats_atol, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=atol, rtol=rtol, err_msg=name)


def test_train_step_loss_and_gradients_match_jax(setup):
    kw = dict(lr=1e-3)
    jstate = _jax_state(setup, kw)
    batch = _batches(1)[0]
    jm = setup["jm"]

    def loss_fn(params, batch_stats, images, labels):
        logits, _ = jm.apply({"params": params, "batch_stats": batch_stats}, images, train=True,
                             mutable=["batch_stats"])
        return jstep.SegmentationTask().loss(logits, {"labels": labels})

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        setup["params"], setup["stats"], jnp.asarray(batch["images"]), jnp.asarray(batch["labels"]))
    # the JAX train step on the one-device mesh computes the same loss
    step = jstep.make_train_step(setup["mesh"], jstep.SegmentationTask(), donate=False)
    _, jmetrics = step(jstate, shard_batch(batch, setup["mesh"]))
    jstep_loss = jstep.compute_metrics(jmetrics)["loss"]
    np.testing.assert_allclose(float(jloss), jstep_loss, rtol=1e-6)

    tstate = _port_state(setup, jstate, kw)
    loss, _ = tstep.forward_backward(tstate, tstep.SegmentationTask(), _torch_batch(batch))
    np.testing.assert_allclose(float(loss), jstep_loss, atol=1e-5, rtol=0)
    want = from_flax(jax.device_get(jgrads), setup["stats"], setup["cfg"])
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values() if w.dtype == torch.float32)
    n_leaves = 0
    for name, p in tstate.model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        tol = 1e-4 * scale + 1e-6
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)
        n_leaves += 1
    assert n_leaves == len(jax.tree_util.tree_leaves(jgrads))
    assert tk.launch_counts()["depthwise_conv2d_dw"] == 0  # CPU: the plain arms


@pytest.mark.parametrize("n_steps", [1, 3])
def test_sgd_steps_match_jax(setup, n_steps):
    # lr decays fast so a schedule read one update early or late shows
    kw = dict(optimizer="sgd", lr=1e-2, lr_decay_steps=2, sgd_momentum=0.9)
    jstate = _jax_state(setup, kw)
    tstate = _port_state(setup, jstate, kw)
    jtrain = jstep.make_train_step(setup["mesh"], _JaxBceTask(), donate=False)
    ttrain = tstep.make_train_step(_PortBceTask())
    for i, b in enumerate(_batches(n_steps)):
        jstate, jm = jtrain(jstate, shard_batch(b, setup["mesh"]))
        tstate, tm = ttrain(tstate, _torch_batch(b))
        jv, tv = jstep.compute_metrics(jm), tstep.compute_metrics(tm)
        # the first loss from one state 1e-5; later ones after the states drifted 1e-3
        np.testing.assert_allclose(tv["loss"], jv["loss"], atol=1e-5 if i == 0 else 1e-3, rtol=0)
        assert set(tv) == set(jv)
    assert tstate.step == int(jstate.step) == n_steps
    # one step from one state: 1e-3·lr. Three: the first step's 1e-6
    # parameter gap grows through the ReLU/max-pool kinks (gradients from
    # identical parameters agree to 1e-5 of their scale), held to 0.2·lr per step
    _assert_params_close(setup, jstate, tstate, atol=1e-3 * kw["lr"] if n_steps == 1 else 0.2 * kw["lr"] * n_steps,
                         rtol=0, stats_atol=1e-5 if n_steps == 1 else 1e-3)


def test_adam_steps_match_jax(setup):
    lr = 1e-3
    kw = dict(optimizer="adam", lr=lr, lr_decay_steps=2)
    jstate = _jax_state(setup, kw)
    tstate = _port_state(setup, jstate, kw)
    jtrain = jstep.make_train_step(setup["mesh"], _JaxBceTask(), donate=False)
    ttrain = tstep.make_train_step(_PortBceTask())
    for k, b in enumerate(_batches(3), start=1):
        jstate, _ = jtrain(jstate, shard_batch(b, setup["mesh"]))
        tstate, _ = ttrain(tstate, _torch_batch(b))
        host = jax.device_get(jstate)
        want = from_flax(host.params, host.batch_stats, setup["cfg"])
        drift = torch.cat([(p.detach() - want[n]).abs().flatten() for n, p in tstate.model.named_parameters()])
        assert float(drift.mean()) <= 0.05 * lr * k, (k, float(drift.mean()))
        assert float(drift.max()) <= 2 * lr * k + 1e-6, (k, float(drift.max()))
    for name, p in tstate.model.named_buffers():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-3, rtol=1e-5, err_msg=name)


# -- schedules and optimizer plumbing ------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(lr=0.01, lr_decay_steps=7, lr_decay_rate=0.3), dict(lr_schedule="cosine", lr_decay_steps=50),
     dict(lr_schedule="cosine", lr_decay_steps=50, lr_warmup_steps=5)],
)
def test_lr_schedules_match_jax(kw):
    ours = tstep.make_host_lr_schedule(TrainConfig(**kw))
    theirs = jstep.make_host_lr_schedule(jconfig.TrainConfig(**kw))
    optax_sched = jstep.make_lr_schedule(jconfig.TrainConfig(**kw))
    for step in (0, 1, 2, 3, 5, 6, 10, 49, 50, 51, 10_000):
        np.testing.assert_allclose(ours(step), theirs(step), rtol=1e-12, atol=0)
        np.testing.assert_allclose(ours(step), float(optax_sched(step)), rtol=1e-6, atol=1e-9)
    assert tstep.make_lr_schedule(TrainConfig(**kw))(3) == ours(3)


def test_kernel_decay_mask_matches_jax_kernels(setup):
    jmask = jstep.kernel_decay_mask(setup["params"])
    model = create_train_state(setup["cfg"], TrainConfig(), "cpu").model
    mask = tstep.kernel_decay_mask(model)
    assert sum(mask.values()) == sum(bool(v) for v in jax.tree_util.tree_leaves(jmask))
    for name, decayed in mask.items():
        module = model.get_submodule(name.rsplit(".", 1)[0])
        assert decayed == (name.endswith(".weight") and isinstance(module, (torch.nn.Conv2d, DepthwiseConv2D)))


def test_adamw_and_sgd_decay_only_kernels():
    cfg = ModelConfig(**TINY)
    for opt, cls in (("adam", torch.optim.AdamW), ("sgd", torch.optim.SGD)):
        state = create_train_state(cfg, TrainConfig(optimizer=opt, weight_decay=1e-3), "cpu")
        assert isinstance(state.optimizer, cls)
        decayed, plain = state.optimizer.param_groups
        assert decayed["weight_decay"] == 1e-3 and plain["weight_decay"] == 0.0
        assert all(p.dim() == 4 or p.dim() == 3 for p in decayed["params"])
    # lars, once refused here (queue A 4): optax.lars' masks, the kernels
    # decayed and trust-scaled, the rest neither
    state = create_train_state(cfg, TrainConfig(optimizer="lars", weight_decay=1e-3), "cpu")
    assert isinstance(state.optimizer, tstep.Lars)
    masked, plain = state.optimizer.param_groups
    assert masked["masked"] and not plain["masked"] and masked["weight_decay"] == 1e-3
    assert all(p.dim() == 4 or p.dim() == 3 for p in masked["params"])
    assert all(p.dim() == 1 for p in plain["params"])


def test_clip_by_global_norm_matches_optax():
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        tstep.clip_by_global_norm(params, max_norm)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_ema_tracks_parameters_and_is_the_eval_view():
    cfg = ModelConfig(**TINY)
    state = create_train_state(cfg, TrainConfig(ema_decay=0.5, lr=0.1), "cpu")
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    b = _torch_batch(_batches(1)[0])
    tstep.make_train_step(tstep.SegmentationTask())(state, b)
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema[n], 0.5 * before[n] + 0.5 * p.detach())
    live = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    with state.eval_params() as model:
        for n, p in model.named_parameters():
            torch.testing.assert_close(p.detach(), state.ema[n])
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), live[n])


def test_l2_penalty_and_metric_deltas():
    model = create_train_state(ModelConfig(**TINY), TrainConfig(), "cpu").model
    mask = tstep.kernel_decay_mask(model)
    want = sum(0.5 * float((p.detach() ** 2).sum()) for n, p in model.named_parameters() if mask[n])
    np.testing.assert_allclose(float(tstep._l2_penalty(model).detach()), want, rtol=1e-5)
    scores = {"metrics/mean_iou": torch.tensor([1.0, 0.0, 0.5])}
    deltas = tstep._metric_deltas(scores, torch.tensor([0.2, 0.4, 9.0]), torch.tensor([1.0, 1.0, 0.0]))
    out = tstep.compute_metrics(deltas)
    np.testing.assert_allclose([out["metrics/mean_iou"], out["loss"]], [0.5, 0.3], rtol=1e-6)
    merged = tstep.merge_metrics(deltas, deltas)
    assert float(merged["loss"].count) == 4.0


def test_eval_and_predict_steps_match_jax(setup):
    # eval mode (BN on the running statistics) from one state and one batch
    # whose last example is padding (valid 0): metrics 1e-5, probabilities
    # 1e-5, masks equal away from |p - 0.5| < 1e-5
    jstate = _jax_state(setup, dict())
    tstate = _port_state(setup, jstate, dict())
    b = dict(_batches(1, seed=11)[0], valid=np.array([1, 1, 1, 0], np.float32))
    jmetrics = jstep.compute_metrics(jstep.make_eval_step(setup["mesh"], jstep.SegmentationTask())(
        jstate, shard_batch(b, setup["mesh"])))
    tbatch = dict(_torch_batch(b), valid=torch.from_numpy(b["valid"]))
    tmetrics = tstep.compute_metrics(tstep.make_eval_step(tstep.SegmentationTask())(tstate.model, tbatch))
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(tmetrics[k], jmetrics[k], atol=1e-5, rtol=0, err_msg=k)
    jpred = jax.device_get(jstep.make_predict_step(setup["mesh"], jstep.SegmentationTask())(
        jstate, shard_batch({"images": b["images"]}, setup["mesh"])))
    tpred = tstep.make_predict_step(tstep.SegmentationTask())(tstate.model, tbatch)
    assert not tstate.model.training
    np.testing.assert_allclose(tpred["probabilities"].numpy(), jpred["probabilities"], atol=1e-5, rtol=0)
    away = np.abs(np.asarray(jpred["probabilities"]) - 0.5) >= 1e-5
    np.testing.assert_array_equal(tpred["mask"].numpy()[away], np.asarray(jpred["mask"], np.float32)[away])


def test_from_flax_train_state_carries_the_step(setup):
    jstate = jax.device_get(_jax_state(setup, dict())).replace(step=np.int32(7))
    state_dict, step = from_flax_train_state(jstate, setup["cfg"])
    assert step == 7
    port = create_train_state(setup["cfg"], TrainConfig(), "cpu", state_dict=state_dict, step=step)
    assert port.step == 7
    broken = jstate.replace(params={**jstate.params, "extra": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}})
    with pytest.raises(ValueError, match="does not use"):
        from_flax_train_state(broken, setup["cfg"])
