"""The port's ZeRO-1 (``parallel/zero.py``, ``TrainConfig.weight_update_sharding``)
against its own replicated step and the JAX package's ``parallel/zero.py``,
on the CPU.

- The spec rule: the shard dimension of a leaf, over a few dozen shapes at
  dp 2, 4 and 8, is JAX's ``weight_update_spec_for_degrees``; on the
  narrow segmenter and ViT every rank's slice of every parameter holds
  the elements of JAX's shard of the flax leaf (the rule reads flax's
  order).
- Per-rank bytes: the memory event's ``opt_state_bytes_per_device`` is
  JAX's ``tree_bytes_per_device(opt_state)`` for the clip -> AdamW -> EMA
  chain, replicated and at each dp, apart from the scalar counters (optax
  keeps an int32 ``count`` per counting transform, torch's Adam a float32
  ``step`` per parameter).
- W = 2 and W = 4 gloo ranks (``tests/test_torch_dp_worker.py`` mode
  ``zero``, one launch each, shared by the tests of that W): under the
  Adam chain and Nesterov SGD the ZeRO step is bit for bit the replicated
  data-parallel step after each of 3 steps, slots and EMA included; LARS,
  whose norms sum the slices' squares over the ranks in another order, is
  within 1e-6·lr of the replicated step taken from the same state, at
  each of 3 steps (held step by step: over a trajectory the tiny
  network's per-rank BatchNorm on 2 to 4 rows amplifies that rounding
  chaotically, as ``tests/test_torch_parallel.py`` notes for rounding-level
  changes); the SGD step with sync BN is within the bounds that file states
  for the replicated step (loss 1e-5, parameters 1e-3·lr, BN statistics
  1e-5) of JAX's ``make_train_step(weight_update_sharding=True)`` on a
  W-device mesh; a ZeRO checkpoint at W = 2 restores bit for bit into one
  replicated process, which restores bit for bit into W = 4 shards; a
  resumed 2 + 2-step ZeRO ``fit`` of the narrow Xception-41 classifier is
  bit for bit 4 uninterrupted steps, dropout masks included, and the ranks
  draw their own masks; every rank's memory event reports its shard bytes.
"""

from __future__ import annotations

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.parallel import make_mesh, shard_batch
from tensorflowdistributedlearning_tpu.parallel import mesh as jmesh
from tensorflowdistributedlearning_tpu.parallel import zero as jzero
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu.train.state import tree_bytes_per_device
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.parallel import zero
from tensorflowdistributedlearning_tpu_torch.parallel.mesh import largest_divisible_dim
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.train.trainer import state_bytes
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, params_from_flax
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_parallel import JTINY, LR, _global_batches, _max_diff
from tests.test_torch_train_step import _flax_variables, _JaxBceTask


VIT = dict(backbone="vit", num_classes=4, input_shape=(16, 16), input_channels=3, patch_size=4, embed_dim=32,
           vit_layers=2, num_heads=4, output_stride=None)
FULL_CHAIN = worker.ZERO_CONFIGS["adam"]
# LARS against its replicated twin from the same state: the step moves
# only by the rounding of the norms' sums
LARS_STEP = 1e-6 * worker.ZERO_CONFIGS["lars"]["lr"]

SHAPES = [(), (1,), (7,), (8,), (12,), (16,), (64,), (3, 5), (16, 8), (4, 16), (8, 8), (6, 4), (2, 3),
          (3, 3, 8, 16), (3, 3, 16, 16), (1, 1, 64, 256), (3, 3, 1, 32), (7, 7, 3, 64), (3, 3, 2, 24),
          (5, 5, 1, 7), (1024, 10), (10, 1024), (64, 3, 4), (2, 2, 2, 2), (9, 12, 6)]


# -- the spec rule -------------------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)) or "scalar")
def test_spec_rule_is_jax_at_tp_1(shape, dp):
    want = jzero.weight_update_spec_for_degrees(shape, dp=dp)
    got = zero.weight_update_spec_for_degrees(shape, dp=dp)
    if got is None:
        assert want == P() or all(s is None for s in want)
    else:
        assert list(want).index(jmesh.BATCH_AXIS) == got
        assert [i for i, s in enumerate(want) if s is not None] == [got]
    assert largest_divisible_dim(shape, dp) == jmesh.largest_divisible_dim(shape, dp)


def test_spec_rule_refuses_tensor_parallel_and_keeps_dp_1_whole():
    """dp 1 keeps a leaf whole at any tp; since the tensor-parallel rule
    was ported, tp > 1 is JAX's composition (the batch axis beside the
    model axis, or stacked onto it), no longer refused; the parity sweep
    is ``tests/test_torch_tensor_parallel.py``."""
    assert zero.weight_update_spec_for_degrees((16, 8), dp=1) is None
    assert zero.weight_update_spec_for_degrees((16, 8), dp=1, tp=2) is None
    assert jzero.weight_update_spec_for_degrees((16, 8), dp=2, tp=2) == P(jmesh.BATCH_AXIS, jmesh.MODEL_AXIS)
    assert zero.weight_update_spec_for_degrees((16, 8), dp=2, tp=2) == 0
    assert jzero.weight_update_spec_for_degrees((3, 8), dp=2, tp=2) == P(None, (jmesh.MODEL_AXIS, jmesh.BATCH_AXIS))
    assert zero.weight_update_spec_for_degrees((3, 8), dp=2, tp=2) == 1


def _fill(jm, shape, fill):
    """flax ``params`` of ``jm`` (shapes from ``eval_shape``, no init run),
    each leaf filled by ``fill(shape)``."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False), jax.random.key(0), jnp.zeros(shape))
    return jax.tree.map(lambda leaf: fill(leaf.shape), shapes["params"])


@functools.lru_cache(maxsize=None)
def _models():
    return {
        "segmenter": (ModelConfig(**worker.TINY), jbuild(jconfig.ModelConfig(**JTINY, use_pallas_depthwise=True)),
                      (1, 33, 33, 2)),
        "vit": (ModelConfig(**VIT), jbuild(jconfig.ModelConfig(**VIT)), (1, 16, 16, 3)),
    }


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("name", ["segmenter", "vit"])
def test_every_rank_holds_the_elements_of_jax_shard(name, dp):
    cfg, jm, shape = _models()[name]
    counter = [0]

    def unique(s):
        n = int(np.prod(s))
        counter[0] += n
        return np.arange(counter[0] - n, counter[0], dtype=np.float32).reshape(s)

    flax = _fill(jm, shape, unique)
    port = params_from_flax(flax, cfg)
    starts = {}
    for leaf in jax.tree.leaves(flax):
        starts[int(leaf.reshape(-1)[0]) if leaf.size else -1] = leaf
    template = create_train_state(cfg, TrainConfig(), "cpu", state_dict=None,
                                  generator=torch.Generator().manual_seed(0))
    layouts = [zero.ZeroLayout(template.model, dp, r) for r in range(dp)]
    n_sharded = 0
    for pname, t in port.items():
        leaf = starts[int(t.min())]
        spec = jzero.weight_update_spec_for_degrees(leaf.shape, dp=dp)
        dim = list(spec).index(jmesh.BATCH_AXIS) if jmesh.BATCH_AXIS in tuple(spec) else None
        assert (dim is None) == (layouts[0].dims[pname] is None), pname
        n_sharded += dim is not None
        for r, layout in enumerate(layouts):
            mine = np.sort(layout.slice(pname, t).reshape(-1).numpy())
            if dim is None:
                want = leaf.reshape(-1)
            else:
                k = leaf.shape[dim] // dp
                want = np.take(leaf, np.arange(r * k, (r + 1) * k), axis=dim).reshape(-1)
            np.testing.assert_array_equal(mine, np.sort(want), err_msg=f"{pname} rank {r}")
    assert n_sharded > 0.8 * len(port)


# -- per-rank bytes against tree_bytes_per_device --------------------------------


def _jax_opt_bytes(jm, shape, dp):
    """JAX's per-device opt-state bytes of the full chain, and the bytes
    of its scalar leaves (the counters)."""
    params = _fill(jm, shape, lambda s: np.zeros(s, np.float32))
    tx = jstep.make_optimizer(jconfig.TrainConfig(**FULL_CHAIN))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={}, opt_state=tx.init(params),
                        apply_fn=jm.apply, tx=tx)
    if dp > 1:
        state = jzero.shard_state_weight_update(state, make_mesh(dp))
    scalars = sum(np.dtype(x.dtype).itemsize for x in jax.tree.leaves(state.opt_state) if not jnp.shape(x))
    return tree_bytes_per_device(state.opt_state), scalars


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["segmenter", "vit"])
def test_opt_state_bytes_per_device_are_jax(name, dp):
    cfg, jm, shape = _models()[name]
    want, jax_scalars = _jax_opt_bytes(jm, shape, dp)
    tcfg = TrainConfig(**FULL_CHAIN, weight_update_sharding=dp > 1)
    got = set()
    for r in range(dp):
        state = create_train_state(cfg, tcfg, "cpu", generator=torch.Generator().manual_seed(0))
        if dp > 1:
            zero.shard_state(state, tcfg, world=dp, rank=r)
        n_params = len(list(state.model.parameters()))
        event = state_bytes(state, tcfg.weight_update_sharding)
        assert event["weight_update_sharding"] == (dp > 1)
        assert event["params_bytes_per_device"] == sum(p.numel() * 4 for p in state.model.parameters())
        # the counters: torch's Adam keeps a float32 step per parameter,
        # optax one int32 count in scale_by_adam and one in the schedule
        assert 0 < jax_scalars <= 16
        got.add(event["opt_state_bytes_per_device"] - 4 * n_params)
    assert got == {want - jax_scalars}


def test_slots_exist_sharded_before_the_first_update():
    cfg = ModelConfig(**worker.TINY)
    for opt in (FULL_CHAIN, worker.SGD, worker.ZERO_CONFIGS["lars"]):
        tcfg = TrainConfig(**opt, weight_update_sharding=True)
        state = zero.shard_state(create_train_state(cfg, tcfg, "cpu", generator=torch.Generator().manual_seed(0)),
                                 tcfg, world=2, rank=1)
        held = sum(v.numel() * v.element_size() for slots in state.optimizer.state.values()
                   for v in slots.values())
        event = state_bytes(state, True)["opt_state_bytes_per_device"]
        ema = sum(e.numel() * 4 for e in state.ema.values()) if state.ema is not None else 0
        assert held + ema == event > 0, opt
        for name, leaf in state.zero.leaves.items():
            for v in state.optimizer.state[leaf].values():
                if v.dim():
                    assert v.shape == leaf.shape, name


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_load_optax_state_fills_this_ranks_slices(opt):
    """``load_optax_state`` into a ZeRO-1 state: every rank's slots and EMA
    are its slices of what the replicated state takes from the same optax
    state (moments after one update from numpy-seeded gradients)."""
    from tensorflowdistributedlearning_tpu_torch.utils.convert import load_optax_state

    cfg, jm, shape = _models()["segmenter"]
    kw = dict(FULL_CHAIN) if opt == "adam" else dict(worker.SGD, ema_decay=0.9)
    params, stats = _flax_variables(jm)
    tx = jstep.make_optimizer(jconfig.TrainConfig(**kw))
    rng = np.random.default_rng(4)
    grads = jax.tree.map(lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), params)
    _, opt_state = tx.update(grads, tx.init(params), params)
    tcfg = TrainConfig(**kw, weight_update_sharding=True)
    state_dict = from_flax(params, stats, cfg)
    rep = create_train_state(cfg, tcfg, "cpu", state_dict=state_dict)
    load_optax_state(rep, opt_state, cfg)
    named = dict(rep.model.named_parameters())
    for r in range(2):
        state = zero.shard_state(create_train_state(cfg, tcfg, "cpu", state_dict=state_dict), tcfg, world=2, rank=r)
        load_optax_state(state, opt_state, cfg)
        for name, leaf in state.zero.leaves.items():
            want = rep.optimizer.state[named[name]]
            got = state.optimizer.state[leaf]
            assert set(got) == set(want), name
            for key, v in want.items():
                assert torch.equal(got[key], state.zero.slice(name, v) if v.dim() else v), (name, key)
            assert torch.equal(state.ema[name], state.zero.slice(name, rep.ema[name])), name


# -- W gloo ranks -----------------------------------------------------------------


def _jax_zero_sync_step(params, stats, world, first):
    jm = jbuild(jconfig.ModelConfig(**JTINY, use_pallas_depthwise=True), bn_axis_name=jmesh.BATCH_AXIS)
    tx = jstep.make_optimizer(jconfig.TrainConfig(**worker.SGD))
    m = make_mesh(world)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
                        apply_fn=jm.apply, tx=tx)
    state = jzero.shard_state_weight_update(state, m)
    train = jstep.make_train_step(m, _JaxBceTask(), donate=False, weight_update_sharding=True)
    state, metrics = train(state, shard_batch(first, m))
    host = jax.device_get(state)
    return {"state": from_flax(host.params, host.batch_stats, ModelConfig(**worker.TINY)),
            "loss": jstep.compute_metrics(metrics)["loss"]}


def _launch(world, directory, init, batches):
    torch.save(init, f"{directory}/init.pt")
    np.savez(f"{directory}/batches.npz", **batches)
    return worker.launch("zero", world, directory)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """W = 2, the parent's replicated restore of its checkpoint (saved again
    for W = 4), then W = 4."""
    cfg = ModelConfig(**worker.TINY)
    params, stats = _flax_variables(jbuild(jconfig.ModelConfig(**JTINY, use_pallas_depthwise=True)))
    init = {"state_dict": from_flax(params, stats, cfg), "step": 0}
    batches = _global_batches()
    first = {k: batches[k][0] for k in batches}
    out = {}
    d2 = str(tmp_path_factory.mktemp("zero2"))
    out[2] = dict(ranks=_launch(2, d2, init, batches), dir=d2)
    rep = create_train_state(cfg, TrainConfig(**FULL_CHAIN), "cpu", state_dict=init["state_dict"])
    restored = CheckpointManager(os.path.join(d2, "ckpt")).restore_latest(rep)
    out["replicated"] = {"whole": worker._whole(restored), "model": worker._snapshot(restored)}
    d4 = str(tmp_path_factory.mktemp("zero4"))
    CheckpointManager(os.path.join(d4, "whole"), save_every_steps=1).save(restored)
    out[4] = dict(ranks=_launch(4, d4, init, batches), dir=d4)
    for w in (2, 4):
        out[w]["jax"] = _jax_zero_sync_step(params, stats, w, first)
    return out


def _same(a, b) -> bool:
    """Nested dicts/lists of tensors and plain values, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_zero_step_is_the_replicated_step_bit_for_bit(runs, opt, world):
    for r, out in enumerate(runs[world]["ranks"]):
        run = out[opt]
        for k, (rep, z) in enumerate(zip(run["rep"], run["zero"])):
            assert _same(z, rep), (r, k)
            assert run["losses"][k][0] == run["losses"][k][1]
        assert _same(run["zero_whole"], run["rep_whole"]), r


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_hold_one_state_and_their_own_slices(runs, world):
    ranks = runs[world]["ranks"]
    first = ranks[0]
    for out in ranks[1:]:
        for opt in worker.ZERO_CONFIGS:
            assert _same(out[opt]["zero"], first[opt]["zero"]), opt
            assert _same(out[opt]["zero_whole"], first[opt]["zero_whole"]), opt
    # each rank's slots are its slices of the whole slots
    template = create_train_state(ModelConfig(**worker.TINY), TrainConfig(**FULL_CHAIN), "cpu",
                                  generator=torch.Generator().manual_seed(0))
    names = [n for g in template.optimizer.param_groups for p in g["params"]
             for n, q in template.model.named_parameters() if q is p]
    whole = first["adam"]["zero_whole"]["optimizer"]["state"]
    for r, out in enumerate(ranks):
        layout = zero.ZeroLayout(template.model, world, r)
        assert layout.dims == out["adam"]["dims"]
        for i, slots in out["adam"]["slots"].items():
            want = [layout.slice(names[i], v) if v.dim() else v for v in whole[i].values()
                    if isinstance(v, torch.Tensor)]
            assert len(slots) == len(want) and all(torch.equal(a, b) for a, b in zip(slots, want)), (r, names[i])


@pytest.mark.parametrize("world", [2, 4])
def test_zero_lars_is_within_its_bound_of_the_replicated_step(runs, world):
    run = runs[world]["ranks"][0]["lars"]
    gaps = [_max_diff(z, rep, stats=False) for z, rep in zip(run["zero"], run["rep"])]
    assert max(gaps) <= LARS_STEP, gaps
    # the statistics and the loss see the same parameters before each step
    assert all(_max_diff(z, rep, stats=True) == 0.0 for z, rep in zip(run["zero"], run["rep"]))
    assert all(a == b for a, b in run["losses"])


@pytest.mark.parametrize("world", [2, 4])
def test_zero_step_matches_jax_zero_step(runs, world):
    got, want = runs[world]["ranks"][0]["sgd"], runs[world]["jax"]
    np.testing.assert_allclose(got["losses"][0][1], want["loss"], atol=1e-5, rtol=0)
    assert _max_diff(got["zero"][0], want["state"], stats=False) <= 1e-3 * LR
    assert _max_diff(got["zero"][0], want["state"], stats=True) <= 1e-5


@pytest.mark.parametrize("world", [2, 4])
def test_eval_params_gathers_the_ema(runs, world):
    for out in runs[world]["ranks"]:
        run = out["adam"]
        assert _same(run["eval_params"], run["rep_whole"]["ema"])
        assert _same(run["after_eval_params"], run["zero"][-1])


def test_checkpoints_do_not_depend_on_the_layout(runs):
    # ZeRO at W = 2 -> one replicated process -> ZeRO at W = 4, bit for bit
    w2 = runs[2]["ranks"][0]["adam"]
    assert all(out["adam"]["saved"] for out in runs[2]["ranks"])
    assert _same(runs["replicated"]["whole"], w2["rep_whole"])
    assert _same(runs["replicated"]["model"], w2["rep"][-1])
    template = create_train_state(ModelConfig(**worker.TINY), TrainConfig(**FULL_CHAIN), "cpu",
                                  generator=torch.Generator().manual_seed(0))
    names = [n for g in template.optimizer.param_groups for p in g["params"]
             for n, q in template.model.named_parameters() if q is p]
    whole = runs["replicated"]["whole"]
    for r, out in enumerate(runs[4]["ranks"]):
        restored = out["adam"]["restored"]
        assert _same(restored["whole"], whole), r
        assert _same(restored["model"], runs["replicated"]["model"]), r
        layout = zero.ZeroLayout(template.model, 4, r)
        for name, e in restored["ema"].items():
            assert torch.equal(e, layout.slice(name, whole["ema"][name])), name
        for i, slots in restored["slots"].items():
            for key, v in slots.items():
                w = whole["optimizer"]["state"][i][key]
                assert torch.equal(v, layout.slice(names[i], w) if w.dim() else w), (names[i], key)


def _ckpt(directory, step):
    return torch.load(os.path.join(directory, "checkpoints", str(step), "state.pt"), weights_only=False)


@pytest.mark.parametrize("world", [2, 4])
def test_resumed_zero_fit_is_the_uninterrupted_fit(runs, world):
    d = runs[world]["dir"]
    resumed, straight = _ckpt(os.path.join(d, "fit-resumed"), 4), _ckpt(os.path.join(d, "fit-straight"), 4)
    assert resumed["step"] == straight["step"] == 4
    assert _same(resumed, straight)
    for out in runs[world]["ranks"]:
        fit = out["fit"]
        assert fit["resumed_4"] == fit["straight_4"]
        assert len(fit["resumed_masks"]) == len(fit["straight_masks"]) == 4
        assert _same(fit["resumed_masks"], fit["straight_masks"])


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_draw_their_own_dropout_masks(runs, world):
    masks = [out["fit"]["straight_masks"] for out in runs[world]["ranks"]]
    for step in range(4):
        drawn = [m[step] for m in masks]
        assert len({tuple(m.reshape(-1).tolist()) for m in drawn}) == world, step
        # keep_prob 0.5 of the features the ReLU left nonzero
        assert all(0.3 < float(m[0].sum() / m[1].sum()) < 0.7 for m in drawn)


@pytest.mark.parametrize("world", [2, 4])
def test_memory_event_of_each_rank(runs, world):
    out0 = runs[world]["ranks"][0]
    cfg = ModelConfig(**out0["fit_config"])
    tcfg = TrainConfig(**worker.ZERO_FIT)
    d = os.path.join(runs[world]["dir"], "fit-straight")
    for r in range(world):
        path = os.path.join(d, "telemetry.jsonl" if r == 0 else f"telemetry-{r}.jsonl")
        with open(path) as f:
            events = [json.loads(line) for line in f if line.strip()]
        memory = [e for e in events if e["event"] == "memory" and "opt_state_bytes_per_device" in e]
        assert memory, r
        state = zero.shard_state(create_train_state(cfg, tcfg, "cpu", generator=torch.Generator().manual_seed(0)),
                                 tcfg, world=world, rank=r)
        want = state_bytes(state, True)
        for e in memory:
            assert {k: e[k] for k in want} == want, r
        # ~1/W of the replicated figure: only the whole tail stays
        replicated = state_bytes(create_train_state(cfg, tcfg, "cpu", generator=torch.Generator().manual_seed(0)))
        tail = sum(p.numel() * 4 * 3 for n, p in state.zero.params.items() if state.zero.dims[n] is None)
        assert want["opt_state_bytes_per_device"] * world <= replicated["opt_state_bytes_per_device"] + \
            world * tail + 4 * world * len(state.zero.params)
