"""LARS, gradient accumulation and ``remat`` in the port against the JAX
package, on the CPU.

Tolerances, stated where used:

- LARS: three updates of the port's :class:`train.step.Lars` against
  ``optax.lars`` as the JAX package chains it (masked decay, masked trust
  ratio, the lr schedule, Nesterov momentum), from one state with the same
  gradients: every parameter within 1e-6·max|p_leaf| (float32 norms summed
  in another order);
- ``grad_accum_steps`` = 2 against JAX's accumulated step on one device:
  loss 1e-5; the accumulated gradient within 1e-4·max|g| + 1e-6 per leaf,
  ``max|g|`` over the whole gradient as in ``tests/test_torch_train_step.py``
  (a leaf that is a residual of cancelling sums, a bias in front of a
  training-mode BatchNorm, carries float32 rounding of 1e-3 of its own
  size); BN running statistics 1e-5. Over 2 gloo ranks against JAX's step
  on a 2-device mesh: loss 1e-5, BN statistics 1e-5, parameters after one
  Nesterov-SGD step 1e-3·lr plus the largest gap between the two
  packages' single-device gradients on one chunk's rows moved by that
  update (the bounds of ``tests/test_torch_parallel.py``: on a few rows a
  ReLU or max-pool kink where their float32 roundings branch apart moves a
  stem gradient), and two all-reduces a step (gradient, BN statistics),
  not one per chunk;
- ``remat`` against no ``remat``: bit for bit on the CPU, running
  statistics moved once;
- the momentum carried over by ``load_optax_state``: the third step after
  two JAX steps within 1e-6·max|p_leaf| of JAX's third step.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.parallel import make_mesh, replicate, shard_batch
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig, require_supported_training
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state, template_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import (
    from_flax,
    from_flax_train_state,
    load_optax_state,
    params_from_flax,
)
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train_step import _flax_variables, _JaxBceTask


CLASSIFIER = dict(num_classes=10, input_shape=(32, 32), input_channels=3, output_stride=None,
                  width_multiplier=0.125, n_blocks=(1, 1, 1, 1), block_layout="classic", stem_space_to_depth=True)
SEG = {k: v for k, v in worker.TINY.items()}
LARS = dict(optimizer="lars", lr=0.5, lr_decay_steps=2, weight_decay=1e-3, sgd_momentum=0.9)


def _classifier_variables(seed=0):
    jm = jbuild(jconfig.ModelConfig(**CLASSIFIER))
    rng = np.random.default_rng(seed)
    v = jm.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)), train=False)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
                                    v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    return jm, params, stats


def _jax_state(jm, params, stats, tcfg_kwargs):
    tx = jstep.make_optimizer(jconfig.TrainConfig(**tcfg_kwargs))
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), apply_fn=jm.apply, tx=tx)


def _random_grads(params, seed):
    rng = np.random.default_rng(seed)
    grads = jax.tree_util.tree_map(lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), params)
    # a leaf with no gradient: the trust ratio is 1 there (optax's zero-norm rule)
    grads["backbone"]["conv1_2"]["conv"]["kernel"] = np.zeros_like(grads["backbone"]["conv1_2"]["conv"]["kernel"])
    return grads


def _assert_params_close(tstate, jparams, cfg, rel=1e-6):
    want = params_from_flax(jax.device_get(jparams), cfg)
    for name, p in tstate.model.named_parameters():
        w = want[name]
        err = float((p.detach() - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-12, (name, err, float(w.abs().max()))


def _apply_port(tstate, grads, cfg):
    g = params_from_flax(grads, cfg)
    for name, p in tstate.model.named_parameters():
        p.grad = g[name].clone()
    tstate.apply_gradients()


def test_lars_matches_optax_lars():
    jm, params, stats = _classifier_variables()
    cfg = ModelConfig(**CLASSIFIER)
    jstate = _jax_state(jm, params, stats, LARS)
    tstate = create_train_state(cfg, TrainConfig(**LARS), "cpu", state_dict=from_flax(params, stats, cfg))
    assert isinstance(tstate.optimizer, tstep.Lars)
    for k in range(3):
        grads = _random_grads(params, seed=10 + k)
        jstate = jstate.apply_gradients(jax.tree_util.tree_map(jnp.asarray, grads), stats)
        _apply_port(tstate, grads, cfg)
        _assert_params_close(tstate, jstate.params, cfg)
    assert tstate.step == int(jstate.step) == 3


def test_lars_trust_ratio_and_masks():
    """A masked kernel moves by about trust_coefficient·lr·|p| (its update
    rescaled to the parameter's norm); an unmasked bias by lr·g; a kernel
    with a zero gradient keeps ratio 1 and does not move."""
    model = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3, bias=True))
    opt = tstep.Lars([{"params": [model[0].weight], "masked": True}, {"params": [model[0].bias], "masked": False}],
                     lr=0.1, momentum=0.0)
    w0, b0 = model[0].weight.detach().clone(), model[0].bias.detach().clone()
    model[0].weight.grad = torch.full_like(w0, 5.0)
    model[0].bias.grad = torch.full_like(b0, 2.0)
    opt.step()
    dw = model[0].weight.detach() - w0  # 1e-4 of |w|: the subtraction keeps 3-4 digits
    np.testing.assert_allclose(float(dw.norm()), 0.1 * 1e-3 * float(w0.norm()), rtol=1e-3)
    np.testing.assert_allclose((model[0].bias.detach() - b0).numpy(), -0.2 * np.ones(3), rtol=1e-6)
    model[0].weight.grad = torch.zeros_like(w0)
    before = model[0].weight.detach().clone()
    opt.step()
    assert torch.equal(model[0].weight.detach(), before)


@pytest.mark.parametrize("optimizer", ["sgd", "lars"])
def test_momentum_carries_over_from_optax(optimizer):
    """Two JAX steps, then ``from_flax_train_state`` and ``load_optax_state``
    (the optax ``TraceState``: SGD's momentum buffer, LARS's trace of
    lr-scaled updates): the port's third step is JAX's third step."""
    kw = dict(LARS, optimizer=optimizer, lr=0.05 if optimizer == "sgd" else 0.5)
    jm, params, stats = _classifier_variables(seed=1)
    cfg = ModelConfig(**CLASSIFIER)
    jstate = _jax_state(jm, params, stats, kw)
    for k in range(2):
        jstate = jstate.apply_gradients(jax.tree_util.tree_map(jnp.asarray, _random_grads(params, 20 + k)), stats)
    host = jax.device_get(jstate)
    state_dict, step = from_flax_train_state(host, cfg)
    tstate = create_train_state(cfg, TrainConfig(**kw), "cpu", state_dict=state_dict, step=step)
    load_optax_state(tstate, host.opt_state, cfg)
    grads = _random_grads(params, 22)
    jstate = jstate.apply_gradients(jax.tree_util.tree_map(jnp.asarray, grads), stats)
    _apply_port(tstate, grads, cfg)
    _assert_params_close(tstate, jstate.params, cfg)
    adam = create_train_state(cfg, TrainConfig(optimizer="adam"), "cpu", state_dict=state_dict, step=step)
    with pytest.raises(ValueError, match="momentum trace"):
        load_optax_state(adam, host.opt_state, cfg)


def test_lars_state_restores_into_a_template():
    """``fit``'s draw-free restore with LARS: the template's optimizer takes
    the saved traces strictly."""
    cfg = ModelConfig(**CLASSIFIER)
    state = create_train_state(cfg, TrainConfig(**LARS), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32))
    tstep.make_train_step(tstep.ClassificationTask())(state, {"images": x, "labels": torch.arange(4)})
    template = template_train_state(cfg, TrainConfig(**LARS), "cpu")
    template.load_state_dict(state.state_dict())
    for p, q in zip(state.model.parameters(), template.model.parameters()):
        assert torch.equal(state.optimizer.state[p]["trace"], template.optimizer.state[q]["trace"])
    with pytest.raises(KeyError, match="Lars"):
        create_train_state(cfg, TrainConfig(optimizer="sgd"), "cpu").load_state_dict(state.state_dict())


# -- gradient accumulation ------------------------------------------------------------------


@pytest.fixture(scope="module")
def seg():
    jcfg = jconfig.ModelConfig(**SEG)
    jm = jbuild(jcfg)
    params, stats = _flax_variables(jm)
    return dict(jm=jm, params=params, stats=stats, cfg=ModelConfig(**SEG))


def _global_batch(n=8, seed=3):
    rng = np.random.default_rng(seed)
    b = tsyn.synthetic_segmentation_batch(rng, n, (33, 33))
    b["images"] = b["images"] + rng.normal(0, 0.3, b["images"].shape).astype(np.float32)
    return b


def test_accumulated_step_matches_jax(seg):
    """SGD at lr 1 without momentum, so JAX's update is its accumulated
    gradient; the port's stays in its flat buffer after the update."""
    kw = dict(optimizer="sgd", lr=1.0, sgd_momentum=0.0, grad_accum_steps=2)
    mesh = make_mesh(1)
    jstate = replicate(_jax_state(seg["jm"], seg["params"], seg["stats"], kw), mesh)
    batch = _global_batch(4)
    jtrain = jstep.make_train_step(mesh, jstep.SegmentationTask(), donate=False, accum=2)
    new, jmetrics = jtrain(jstate, shard_batch(batch, mesh))
    new = jax.device_get(new)
    jgrads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), seg["params"], new.params)
    cfg = seg["cfg"]
    tstate = create_train_state(cfg, TrainConfig(**kw), "cpu", state_dict=from_flax(seg["params"], seg["stats"], cfg))
    train = tstep.make_train_step(tstep.SegmentationTask(), accum=2)
    tstate, tmetrics = train(tstate, {k: torch.from_numpy(batch[k]) for k in ("images", "labels")})
    jv, tv = jstep.compute_metrics(jmetrics), tstep.compute_metrics(tmetrics)
    assert set(jv) == set(tv)
    assert abs(tv["loss"] - jv["loss"]) <= 1e-5, (tv["loss"], jv["loss"])
    want = params_from_flax(jgrads, cfg)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in tstate.model.named_parameters():
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-4 * scale + 1e-6, (name, err, scale)
    stats = from_flax(new.params, new.batch_stats, cfg)
    for name, t in tstate.model.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(t.numpy(), stats[name].numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


def test_accumulation_runs_chunks_in_order_and_refuses_ragged_batches(seg):
    """Two chunks against two sequential single-chunk forward/backwards:
    the same BN running statistics (the chunks move them in order) and the
    mean of the chunk gradients, summed as a + g / accum."""
    cfg = seg["cfg"]
    init = from_flax(seg["params"], seg["stats"], cfg)
    batch = {k: torch.from_numpy(v) for k, v in _global_batch(4).items() if k in ("images", "labels")}
    a = create_train_state(cfg, TrainConfig(optimizer="sgd", lr=0.0), "cpu", state_dict=init)
    tstep.make_train_step(tstep.SegmentationTask(), accum=2)(a, batch)
    b = create_train_state(cfg, TrainConfig(optimizer="sgd", lr=0.0), "cpu", state_dict=init)
    total = None
    for chunk in tstep.split_batch(batch, 2):
        tstep.forward_backward(b, tstep.SegmentationTask(), chunk)
        g = [p.grad / 2 for p in b.model.parameters()]
        total = g if total is None else [t + x for t, x in zip(total, g)]
    for p, t in zip(a.model.parameters(), total):
        assert torch.equal(p.grad, t)
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    with pytest.raises(ValueError, match="divisible by grad_accum_steps"):
        tstep.make_train_step(tstep.SegmentationTask(), accum=3)(a, batch)


def test_accumulated_step_over_two_gloo_ranks_matches_jax(seg, tmp_path):
    cfg = seg["cfg"]
    init = {"state_dict": from_flax(seg["params"], seg["stats"], cfg), "step": 0}
    torch.save(init, tmp_path / "init.pt")
    batch = _global_batch(8)
    np.savez(tmp_path / "batches.npz", images=batch["images"][None], labels=batch["labels"][None])
    out = worker.launch("accum", 2, str(tmp_path))
    assert all(o["all_reduces"] == 2 for o in out)
    for name, t in out[0]["state"].items():
        assert torch.equal(t, out[1]["state"][name]), name
    mesh = make_mesh(2)
    jkw = dict(worker.SGD, grad_accum_steps=2)
    jstate = replicate(_jax_state(seg["jm"], seg["params"], seg["stats"], jkw), mesh)
    jtrain = jstep.make_train_step(mesh, _JaxBceTask(), donate=False, accum=2)
    new, jmetrics = jtrain(jstate, shard_batch(batch, mesh))
    new = jax.device_get(new)
    assert abs(out[0]["loss"] - jstep.compute_metrics(jmetrics)["loss"]) <= 1e-5
    want = from_flax(new.params, new.batch_stats, cfg)
    gaps = _chunk_gaps(seg, batch, world=2, accum=2)
    lr = worker.SGD["lr"]
    step = lr * (1 + worker.SGD["sgd_momentum"])
    for name, w in want.items():
        err = float((out[0]["state"][name] - w).abs().max())
        bound = 1e-5 if "running" in name else 1e-3 * lr + step * gaps[name]
        assert err <= bound, (name, err, bound)


def _chunk_gaps(seg, batch, world, accum):
    """Per parameter, the largest gap between the two packages'
    single-device gradients (sigmoid cross entropy) on one chunk's rows."""
    cfg, jm, stats = seg["cfg"], seg["jm"], seg["stats"]

    def jax_loss(p, x, y):
        logits, _ = jm.apply({"params": p, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
        return _JaxBceTask().loss(logits, {"labels": y})

    jax_grad = jax.jit(jax.grad(jax_loss))
    init = from_flax(seg["params"], stats, cfg)
    state = create_train_state(cfg, TrainConfig(**worker.SGD), "cpu", state_dict=init)
    n = batch["images"].shape[0] // (world * accum)
    gaps = {}
    for c in range(world * accum):
        rows = slice(c * n, (c + 1) * n)
        state.model.load_state_dict(init)
        tstep.forward_backward(state, worker._bce_task(), {k: torch.from_numpy(batch[k][rows]) for k in ("images", "labels")})
        want = params_from_flax(jax.device_get(jax_grad(seg["params"], batch["images"][rows], batch["labels"][rows])), cfg)
        for name, p in state.model.named_parameters():
            gaps[name] = max(gaps.get(name, 0.0), float((p.grad - want[name]).abs().max()))
    return gaps


# -- remat --------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["segmenter", "classifier_bf16"])
def test_remat_step_is_bit_for_bit_the_plain_step(kind):
    """A train step with ``remat`` against one without, from one state: the
    same metrics, parameters, optimizer state and running statistics, bit
    for bit (the recompute leaves the running statistics alone)."""
    if kind == "segmenter":
        cfg, task, batch = ModelConfig(**SEG), tstep.SegmentationTask(), _global_batch(4)
        batch = {k: torch.from_numpy(batch[k]) for k in ("images", "labels")}
    else:
        cfg, task = ModelConfig(**CLASSIFIER, dtype="bfloat16"), tstep.ClassificationTask()
        rng = np.random.default_rng(2)
        batch = {"images": torch.from_numpy(rng.normal(size=(4, 32, 32, 3)).astype(np.float32)),
                 "labels": torch.from_numpy(rng.integers(0, 10, 4))}
    init = build_model(cfg, "cpu").state_dict()
    outs = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        state = create_train_state(c, TrainConfig(**LARS, grad_accum_steps=2), "cpu", state_dict=init)
        state, metrics = tstep.make_train_step(task, accum=2)(state, batch)
        outs.append((tstep.compute_metrics(metrics), state.model.state_dict(),
                     [state.optimizer.state[p]["trace"] for p in state.model.parameters()]))
    assert outs[0][0] == outs[1][0]
    for name, t in outs[0][1].items():
        assert torch.equal(t, outs[1][1][name]), name
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))


def test_remat_moves_running_statistics_once():
    cfg = ModelConfig(**SEG, remat=True)
    model = build_model(cfg, "cpu").train()
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 33, 33, 2)).astype(np.float32))
    model(x).sum().backward()  # the backward recomputes every unit
    after_backward = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    plain = build_model(dataclasses.replace(cfg, remat=False), "cpu").train()
    plain(x)
    assert any(not torch.equal(before[k], after_backward[k]) for k in before)
    for k, v in plain.state_dict().items():
        if "running" in k:
            assert torch.equal(v, after_backward[k]), k


def test_large_batch_preset_trains_but_for_zero1():
    """``resnet50_bf16_8k``: remat, LARS, bf16 and, since queue A 12.1, its
    ZeRO-1 weight-update sharding are ported: the preset is accepted as it
    is, and its state over two ranks is a ZeRO-1 state (the model at 1/16
    width: LARS over this rank's slices, whose norms it reduces, and about
    half the replicated optimizer bytes)."""
    from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
    from tensorflowdistributedlearning_tpu_torch.parallel import zero
    from tensorflowdistributedlearning_tpu_torch.train.step import Lars, optimizer_slot_bytes

    preset = tconfigs.get_preset("resnet50_bf16_8k")
    assert preset.train.weight_update_sharding
    require_supported_training(preset.model, preset.train)
    small = dataclasses.replace(preset.model, width_multiplier=0.0625, input_shape=(32, 32))
    replicated = create_train_state(small, preset.train, "cpu", generator=torch.Generator().manual_seed(0))
    whole = optimizer_slot_bytes(replicated.optimizer)
    state = zero.shard_state(replicated, preset.train, world=2, rank=1)
    assert isinstance(state.optimizer, Lars) and state.zero is not None
    assert state.optimizer.sharded == {id(state.zero.leaves[n]) for n in state.zero.sharded}
    assert whole / 2 <= optimizer_slot_bytes(state.optimizer) < 0.55 * whole


def test_fit_preset_with_lars_and_accumulation(tmp_path, monkeypatch):
    """``fit_preset`` with ``--optimizer lars --grad-accum 2`` on a narrow
    ResNet-50 classic preset: trains, checkpoints and evaluates."""
    from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
    from tensorflowdistributedlearning_tpu_torch.train import fit as tfit

    full = tconfigs.get_preset("resnet50_classic_imagenet")
    small = dataclasses.replace(full.model, width_multiplier=0.0625, input_shape=(32, 32), remat=True)
    monkeypatch.setitem(tconfigs.PRESETS, "resnet50_classic_imagenet", dataclasses.replace(full, model=small))
    res = tfit.fit_preset("resnet50_classic_imagenet", str(tmp_path), steps=2, batch_size=8, device="cpu",
                          optimizer="lars", lr=0.5, grad_accum_steps=2)
    assert res.steps == 2 and all(np.isfinite(v) for v in res.final_metrics.values())
    assert sorted(res.final_metrics) == ["loss", "metrics/top1", "metrics/top5"]
