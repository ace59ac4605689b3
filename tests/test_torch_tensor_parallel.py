"""The port's tensor parallelism (``parallel/tensor.py``, its composition
with ZeRO-1 in ``parallel/zero.py``, ``TrainConfig.model_parallel``)
against the JAX package's ``parallel/tensor.py`` and ``parallel/zero.py``,
on the CPU.

- The rules: the tensor-parallel spec of a leaf is JAX's
  ``tensor_parallel_spec_for_shape`` at tp 2 and 4, and the ZeRO-1 spec
  composed with it (the batch axis's dimension, stacked onto the model
  axis's where nothing else divides) is JAX's
  ``weight_update_spec_for_degrees`` at dp 2 and 4.
- The layout: at (dp, tp) = (1, 2) and (2, 2), with and without ZeRO-1,
  every rank's slice of every parameter, BN statistic and optimizer slot
  of the narrow segmenter and ResNet classifier holds the elements of
  JAX's shard on that rank's device (``devices_indices_map``, no step
  run); ``utils.convert.from_flax_tensor_parallel`` carries a JAX state
  placed for tensor parallelism to the same slices.
- 2 and 4 gloo ranks at tp = 2 (``tests/test_torch_dp_worker.py`` mode
  ``tp``, one launch each, shared by the tests): the sliced forward is
  JAX's forward of the placed state; the ``Trainer`` step (per-tower BN)
  is JAX's ``make_train_step(auto_model=True)`` and ``fit``'s step
  (global-batch BN) JAX's ``make_train_step_gspmd``, with and without
  ZeRO-1, under a smooth loss and one plain-SGD step at lr 1 (the update
  is the gradient): loss within 1e-5, every gradient leaf within
  1e-4·max|g| + 1e-6 with max|g| over the whole gradient (the bound of
  ``tests/test_torch_train_step.py``, which says why), BN statistics
  within 1e-5; two Adam steps under ZeRO-1 are bit for bit the
  tensor-parallel steps; a checkpoint written at (1, 2) restores bit for
  bit into one replicated process and from there into (2, 2) slices, and
  the (2, 2) one into one process; ``Trainer.train`` trains both layouts;
  a resumed tensor-parallel ZeRO-1 ``fit`` is bit for bit the
  uninterrupted one; every rank's memory event is JAX's
  ``tree_bytes_per_device`` of its placed state.
- The refusals: JAX's ``ValueError`` texts for tensor parallelism with the
  sequence axis, the pipeline and accumulation, and for the segmenter's
  pipeline; Xception-41's tensor parallelism, which stays refused, names
  queue A 12.2.
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
from jax.sharding import NamedSharding, PartitionSpec as P

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.parallel import make_mesh, replicate, shard_batch
from tensorflowdistributedlearning_tpu.parallel import tensor as jtensor
from tensorflowdistributedlearning_tpu.parallel import zero as jzero
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu.train.state import tree_bytes_per_device
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig, require_supported_training
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.parallel import tensor, zero
from tensorflowdistributedlearning_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.train.trainer import state_bytes
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, from_flax_tensor_parallel
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.conftest import make_salt_dataset
from tests.test_torch_parallel import JTINY, _global_batches
from tests.test_torch_train_step import _flax_variables, _JaxBceTask
from tests.test_torch_zero1 import SHAPES, _same


TP = worker.TP
JSEG = dict(JTINY, use_pallas_depthwise=True)
INPUTS = {"seg": (1, 33, 33, 2), "cls": (1, 32, 32, 3)}
LAYOUTS = [(1, 2), (2, 2)]


def _ids(s):
    return "x".join(map(str, s)) or "scalar"


# -- the rules ---------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_tensor_parallel_rule_is_jax(shape, tp):
    want = tuple(jtensor.tensor_parallel_spec_for_shape(shape, tp))
    assert tensor.tensor_parallel_spec_for_shape(shape, tp) == want
    assert tensor.model_dim(shape, tp) == (len(want) - 1 if want else None)


@pytest.mark.parametrize("dp, tp", [(2, 2), (4, 2), (2, 4), (4, 4)])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_zero_rule_composed_with_tensor_parallelism_is_jax(shape, dp, tp):
    want = tuple(jzero.weight_update_spec_for_degrees(shape, dp=dp, tp=tp))
    batch = zero.weight_update_spec_for_degrees(shape, dp=dp, tp=tp)
    model = tensor.model_dim(shape, tp)
    got = [None] * len(shape)
    if model is not None:
        got[model] = "model"
    if batch is not None:
        got[batch] = ("model", "batch") if batch == model else "batch"
    if not want:
        assert got == [None] * len(shape)
    else:
        assert tuple(got) == want + (None,) * (len(shape) - len(want))


# -- the layout, offline --------------------------------------------------------


def _fill(jm, shape, seed=0):
    """numpy-seeded flax params and batch stats of ``jm`` (no init run):
    every entry distinct, so a slice names its elements."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False), jax.random.key(0), jnp.zeros(shape))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            depthwise = leaf.ndim == 4 and leaf.shape[2] == 1
            fan_in = int(np.prod(leaf.shape[:2] if depthwise else leaf.shape[:-1]))
            return rng.normal(0, np.sqrt(2.0 / fan_in), leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(fill, shapes["params"]),
            jax.tree_util.tree_map_with_path(fill, shapes.get("batch_stats", {})))


@functools.lru_cache(maxsize=None)
def _models():
    """The narrow segmenter with the data-parallel tests' weights
    (``_flax_variables``) and the narrow ResNet classifier."""
    out = {}
    for name, jkw, kw in (("seg", JSEG, worker.TINY), ("cls", worker.TP_CLS, worker.TP_CLS)):
        jm = jbuild(jconfig.ModelConfig(**jkw))
        params, stats = _flax_variables(jm) if name == "seg" else _fill(jm, INPUTS[name])
        out[name] = dict(jm=jm, params=params, stats=stats, cfg=ModelConfig(**kw))
    return out


def _jax_state(name, tcfg_kwargs, mesh=None, zero_sharded=False):
    m = _models()[name]
    tx = jstep.make_optimizer(jconfig.TrainConfig(**tcfg_kwargs))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=m["params"], batch_stats=m["stats"],
                        opt_state=tx.init(m["params"]), apply_fn=m["jm"].apply, tx=tx)
    if mesh is None:
        return state
    if zero_sharded:
        return jzero.shard_state_weight_update(state, mesh, tensor_parallel=True)
    return jtensor.shard_state_tensor_parallel(state, mesh)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _by_first(tree):
    """``{first element: leaf}``: the leaf a port tensor came from."""
    return {float(np.asarray(leaf).reshape(-1)[0]): np.asarray(leaf) for leaf in _flat(tree).values()}


@pytest.mark.parametrize("with_zero", [False, True], ids=["tp", "zero"])
@pytest.mark.parametrize("dp, tp", LAYOUTS)
@pytest.mark.parametrize("name", ["seg", "cls"])
def test_every_rank_holds_the_elements_of_jax_shard(name, dp, tp, with_zero):
    m = _models()[name]
    whole = from_flax(m["params"], m["stats"], m["cfg"])
    leaves = {**_by_first(m["params"]), **_by_first(m["stats"])}
    jmesh = make_mesh(dp * tp, model_parallel=tp)
    devices = list(jmesh.devices.reshape(-1))
    template = build_model(m["cfg"], "cpu", generator=torch.Generator().manual_seed(0))
    n_model = n_data = 0
    for d in range(dp):
        for r in range(tp):
            model = build_model(m["cfg"], "cpu", generator=torch.Generator().manual_seed(0))
            model.load_state_dict(whole)
            layout = tensor.layout_for(template, tp, r)
            tensor.shard_model(model, layout)
            zl = zero.ZeroLayout(model, dp, d, tp=layout) if with_zero else None
            sliced = model.state_dict()
            device = devices[d * tp + r]
            for pname, t in whole.items():
                leaf = leaves[float(t.reshape(-1)[0])]
                spec = tuple(jtensor.tensor_parallel_spec_for_shape(leaf.shape, tp))
                mine = sliced[pname]
                if zl is not None and pname in zl.dims:
                    spec = tuple(jzero.weight_update_spec_for_degrees(leaf.shape, dp=dp, tp=tp))
                    mine = zl.slice(pname, mine)
                    n_data += zl.dims[pname] is not None
                n_model += layout.dims[pname] is not None
                index = NamedSharding(jmesh, P(*spec)).devices_indices_map(leaf.shape)[device]
                np.testing.assert_array_equal(np.sort(mine.reshape(-1).numpy()), np.sort(leaf[index].reshape(-1)),
                                              err_msg=f"{pname} at ({d}, {r})")
    assert n_model > 0.8 * len(whole) * dp * tp
    assert (n_data > 0) == (with_zero and dp > 1)


@pytest.mark.parametrize("name", ["seg", "cls"])
def test_convert_carries_a_jax_tensor_parallel_state_to_each_rank(name):
    m = _models()[name]
    jmesh = make_mesh(2, model_parallel=2)
    placed = _jax_state(name, worker.TP_SGD, jmesh)
    whole = from_flax(m["params"], m["stats"], m["cfg"])
    template = build_model(m["cfg"], "cpu", generator=torch.Generator().manual_seed(0))
    for r in range(2):
        got, step = from_flax_tensor_parallel(placed, m["cfg"], 2, r)
        assert step == 0
        want = tensor.layout_for(template, 2, r).slice_state_dict(whole)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # the leaves JAX placed are sharded on the model axis where the port slices
    conv = placed.params["backbone"]["conv1_1"]["conv"]["kernel"]
    assert conv.sharding.spec == P(None, None, None, "model")


# -- W gloo ranks ---------------------------------------------------------------


def _cls_batch(n=8, seed=11):
    b = tsyn.synthetic_classification_batch(np.random.default_rng(seed), n, (32, 32), 3, 10)
    return {"images": b["images"], "labels": b["labels"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """W = 2 (a (1, 2) grid), the parent's replicated restore of its
    checkpoint (saved again for W = 4), then W = 4 (a (2, 2) grid)."""
    ms = _models()
    init = {k: {"state_dict": from_flax(m["params"], m["stats"], m["cfg"]), "step": 0} for k, m in ms.items()}
    seg = {k: v[0] for k, v in _global_batches().items()}
    cls = _cls_batch()
    batches = {"seg_images": seg["images"], "seg_labels": seg["labels"], "cls_images": cls["images"],
               "cls_labels": cls["labels"]}
    out = {"batches": batches}
    adam = TrainConfig(**worker.TP_ADAM)
    for world in (2, 4):
        d = str(tmp_path_factory.mktemp(f"tp{world}"))
        torch.save(init, os.path.join(d, "tp_init.pt"))
        np.savez(os.path.join(d, "tp_batches.npz"), **batches)
        make_salt_dataset(d, n_images=16, shape=(32, 32))
        if world == 4:
            CheckpointManager(os.path.join(d, "tp-whole"), save_every_steps=1).save(out["replicated"])
        out[world] = dict(ranks=worker.launch("tp", world, d), dir=d)
        restored = CheckpointManager(os.path.join(d, "tp-ckpt")).restore_latest(
            create_train_state(ms["cls"]["cfg"], adam, "cpu", state_dict=init["cls"]["state_dict"]))
        out[f"replicated_{world}"] = restored.state_dict()
        if world == 2:
            out["replicated"] = restored
    return out


def _max_gap(a, b, keys):
    return max(float((a[k] - b[k]).abs().max()) for k in keys)


def _hold_step(got, want, what, per_leaf=False, slack=None):
    """Loss within 1e-5; every gradient leaf within 1e-4·max|g| + 1e-6
    (max over the leaf with ``per_leaf``, else over the whole gradient),
    plus the leaf's ``slack``; BN statistics within 1e-5."""
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5, rtol=0, err_msg=what)
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        gap = float((got["grads"][k] - g).abs().max())
        scale = float(g.abs().max()) if per_leaf else gmax
        bound = 1e-4 * scale + 1e-6 + (slack[k] if slack else 0.0)
        assert gap <= bound, (what, k, gap, bound)
    stats = [k for k in want["state"] if "running" in k]
    assert stats and _max_gap(got["state"], want["state"], stats) <= 1e-5, what


def _jax_step(name, world, make_step, batch, zero_sharded=False, tp=TP):
    """One plain-SGD step at lr 1 of JAX's on a (world / tp, tp) mesh (at
    tp 1 the replicated data-parallel state): the loss, the gradient (the
    update) and the state, in the port's names."""
    m = _models()[name]
    jmesh = make_mesh(world, model_parallel=tp)
    if tp == 1:
        state = replicate(_jax_state(name, worker.TP_SGD), jmesh)
    else:
        state = _jax_state(name, worker.TP_SGD, jmesh, zero_sharded)
    before = jax.device_get(state)
    new, metrics = make_step(jmesh)(state, shard_batch(batch, jmesh))
    after = jax.device_get(new)
    p0 = from_flax(before.params, before.batch_stats, m["cfg"])
    p1 = from_flax(after.params, after.batch_stats, m["cfg"])
    names = dict(build_model(m["cfg"], "cpu", generator=torch.Generator().manual_seed(0)).named_parameters())
    return {"loss": jstep.compute_metrics(metrics)["loss"], "grads": {k: p0[k] - p1[k] for k in names}, "state": p1}


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_lay_out_as_jax_mesh(runs, world):
    assert [o["layout"] for o in runs[world]["ranks"]] == [(world // TP, TP, r // TP, r % TP) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_tensor_parallel_forward_matches_jax(runs, world):
    m = _models()["seg"]
    jmesh = make_mesh(TP, model_parallel=TP)
    placed = _jax_state("seg", worker.TP_SGD, jmesh)
    images = jnp.asarray(runs["batches"]["seg_images"])
    variables = {"params": placed.params, "batch_stats": placed.batch_stats}
    want_eval = np.asarray(jax.jit(lambda v, x: m["jm"].apply(v, x, train=False))(variables, images))
    want_train, mutated = jax.jit(lambda v, x: m["jm"].apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, images)
    stats = from_flax(m["params"], jax.device_get(mutated["batch_stats"]), m["cfg"])
    scale = float(np.abs(want_eval).max())
    for out in runs[world]["ranks"]:
        np.testing.assert_allclose(out["logits_eval"].numpy(), want_eval, atol=1e-5 * scale, rtol=0)
        np.testing.assert_allclose(out["logits_train"].numpy(), np.asarray(want_train),
                                   atol=1e-5 * float(np.abs(want_train).max()), rtol=0)
        keys = [k for k in stats if "running" in k]
        assert _max_gap(out["stats_after_forward"], stats, keys) <= 1e-5


def _batch(runs, prefix):
    return {k[len(prefix) + 1:]: v for k, v in runs["batches"].items() if k.startswith(prefix + "_")}


def _port_one_rank(name, batch, towers, task):
    """The port's step of one process without tensor parallelism, from the
    same state, over ``towers`` row blocks each with its own BatchNorm
    statistics (the per-tower data-parallel step; one tower is the
    global-batch step): the mean loss, gradient and BN statistics."""
    from tensorflowdistributedlearning_tpu_torch.train import step as tstep

    m = _models()[name]
    init = from_flax(m["params"], m["stats"], m["cfg"])
    n = len(batch["labels"]) // towers
    losses, grads, states = [], [], []
    # one torch thread, as each gloo rank runs (restored after: the
    # process's other tests keep theirs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t in range(towers):
            state = create_train_state(m["cfg"], TrainConfig(**worker.TP_SGD), "cpu", state_dict=init)
            rows = {k: torch.from_numpy(v[t * n:(t + 1) * n]) for k, v in batch.items()}
            state, metrics = tstep.make_train_step(task)(state, rows)
            losses.append(tstep.compute_metrics(metrics)["loss"])
            grads.append({k: p.grad.clone() for k, p in state.model.named_parameters()})
            states.append(state.model.state_dict())
    finally:
        torch.set_num_threads(threads)
    return {"loss": sum(losses) / towers, "grads": {k: sum(g[k] for g in grads) / towers for k in grads[0]},
            "state": {k: sum(s[k] for s in states) / towers for k in states[0]}}


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_step_is_the_one_rank_per_tower_step(runs, world):
    want = _port_one_rank("seg", _batch(runs, "seg"), world // TP, worker._bce_task())
    for r, out in enumerate(runs[world]["ranks"]):
        _hold_step(out["trainer"], want, f"trainer step, rank {r} of {world}", per_leaf=True)


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_step_matches_jax_auto_model_step(runs, world):
    """Each leaf within the bound plus what the two packages' per-tower
    steps without tensor parallelism already differ by on these rows (as
    ``tests/test_torch_parallel.py`` holds the data-parallel step: a kink
    of ReLU or max-pool where the packages' float32 roundings take
    different branches moves a stem gradient by up to 1e-3). JAX's hybrid
    step (``auto_model=True``) does not compile on a mesh whose batch axis
    is 1 (an XLA partitioner check fails), so at (1, 2) the reference is
    JAX's whole-step tensor-parallel step, whose one tower is then the
    global batch."""
    seg = _batch(runs, "seg")
    if world == TP:
        def make(mesh):
            return jtensor.make_train_step_gspmd(mesh, _JaxBceTask(), donate=False)
    else:
        def make(mesh):
            return jstep.make_train_step(mesh, _JaxBceTask(), donate=False, auto_model=True)
    want = _jax_step("seg", world, make, seg)
    dp = world // TP
    plain = _jax_step("seg", dp, lambda mesh: jstep.make_train_step(mesh, _JaxBceTask(), donate=False), seg, tp=1)
    port = _port_one_rank("seg", seg, dp, worker._bce_task())
    slack = {k: float((port["grads"][k] - g).abs().max()) for k, g in plain["grads"].items()}
    for r, out in enumerate(runs[world]["ranks"]):
        _hold_step(out["trainer"], want, f"trainer step, rank {r} of {world}", slack=slack)


@pytest.mark.parametrize("world", [2, 4])
def test_fit_step_is_the_one_rank_global_batch_step(runs, world):
    from tensorflowdistributedlearning_tpu_torch.train import step as tstep

    want = _port_one_rank("cls", _batch(runs, "cls"), 1, tstep.ClassificationTask())
    for r, out in enumerate(runs[world]["ranks"]):
        for name in ("fit", "fit_zero"):
            _hold_step(out[name], want, f"{name} step, rank {r} of {world}", per_leaf=True)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("with_zero", [False, True], ids=["tp", "zero"])
def test_fit_step_matches_jax_gspmd_step(runs, with_zero, world):
    want = _jax_step("cls", world, lambda mesh: jtensor.make_train_step_gspmd(
        mesh, jstep.ClassificationTask(), donate=False, weight_update_sharding=with_zero), _batch(runs, "cls"),
        with_zero)
    for r, out in enumerate(runs[world]["ranks"]):
        _hold_step(out["fit_zero" if with_zero else "fit"], want, f"fit step, rank {r} of {world}")


def test_the_two_batch_norm_semantics_part_at_two_data_positions(runs):
    """``Trainer``'s per-tower statistics and ``fit``'s global ones part
    at dp = 2, in JAX's two steps and the port's one-rank steps alike, so
    the step tests above tell them apart."""
    seg = _batch(runs, "seg")
    tower = _jax_step("seg", 4, lambda mesh: jstep.make_train_step(mesh, _JaxBceTask(), donate=False,
                                                                    auto_model=True), seg)
    whole = _jax_step("seg", 4, lambda mesh: jtensor.make_train_step_gspmd(mesh, _JaxBceTask(), donate=False),
                      seg)
    port_whole = _port_one_rank("seg", seg, 1, worker._bce_task())
    for a, b in ((tower, whole), (runs[4]["ranks"][0]["trainer"], port_whole)):
        assert abs(a["loss"] - b["loss"]) > 1e-3


@pytest.mark.parametrize("world", [2, 4])
def test_zero_tp_adam_steps_are_the_tp_steps_bit_for_bit(runs, world):
    for r, out in enumerate(runs[world]["ranks"]):
        run = out["adam"]
        assert _same(run["zero"], run["tp"]), r
        assert run["zero_loss"] == run["tp_loss"]
    first = runs[world]["ranks"][0]["adam"]["tp"]
    for out in runs[world]["ranks"][1:]:
        assert _same(out["adam"]["tp"], first)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_of_a_model_group_agree_and_hold_their_slices(runs, world):
    ranks = runs[world]["ranks"]
    template = build_model(ModelConfig(**worker.TINY), "cpu", generator=torch.Generator().manual_seed(0))
    whole = ranks[0]["stats_after_forward"]
    for r, out in enumerate(ranks):
        assert torch.equal(out["logits_eval"], ranks[0]["logits_eval"]), r
        layout = tensor.layout_for(template, TP, r % TP)
        init = torch.load(os.path.join(runs[world]["dir"], "tp_init.pt"), weights_only=False)["seg"]["state_dict"]
        for k, v in out["slices"].items():
            assert torch.equal(v, layout.slice(k, init[k])), (r, k)
        assert _same(out["stats_after_forward"], whole), r


def test_checkpoints_do_not_depend_on_the_layout(runs):
    # (1, 2) -> one replicated process -> (2, 2), and (2, 2) -> one process
    for world in (2, 4):
        assert all(o["saved"] for o in runs[world]["ranks"])
        for out in runs[world]["ranks"]:
            assert _same(runs[f"replicated_{world}"], out["adam"]["zero"])
    whole = runs["replicated_2"]
    cfg = ModelConfig(**worker.TP_CLS)
    template = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    for r, out in enumerate(runs[4]["ranks"]):
        assert _same(out["restored"]["whole"], whole), r
        layout = tensor.layout_for(template, TP, r % TP)
        for k, v in out["restored"]["slices"].items():
            assert torch.equal(v, layout.slice(k, whole["model"][k])), (r, k)


def _ckpt(directory, step):
    return torch.load(os.path.join(directory, "checkpoints", str(step), "state.pt"), weights_only=False)


@pytest.mark.parametrize("world", [2, 4])
def test_resumed_tensor_parallel_fit_is_the_uninterrupted_fit(runs, world):
    d = runs[world]["dir"]
    resumed, straight = _ckpt(os.path.join(d, "tp-fit-resumed"), 4), _ckpt(os.path.join(d, "tp-fit-straight"), 4)
    assert resumed["step"] == straight["step"] == 4
    assert _same(resumed, straight)
    for out in runs[world]["ranks"]:
        assert out["fit_runs"]["resumed_4"] == out["fit_runs"]["straight_4"]
        assert all(np.isfinite(v) for v in out["fit_runs"]["straight_4"].values())


@pytest.mark.parametrize("world", [2, 4])
def test_memory_event_is_jax_tree_bytes_per_device(runs, world):
    jmesh = make_mesh(world, model_parallel=TP)
    placed = _jax_state("cls", {k: v for k, v in worker.TP_FIT.items() if k in (
        "optimizer", "lr", "ema_decay", "grad_clip_norm")}, jmesh, zero_sharded=True)
    jax_scalars = sum(np.dtype(x.dtype).itemsize for x in jax.tree.leaves(placed.opt_state) if not jnp.shape(x))
    want_params = tree_bytes_per_device(placed.params)
    want_opt = tree_bytes_per_device(placed.opt_state) - jax_scalars
    d = os.path.join(runs[world]["dir"], "tp-fit-straight")
    n_params = len(list(build_model(ModelConfig(**worker.TP_CLS), "cpu").parameters()))
    for r in range(world):
        with open(os.path.join(d, "telemetry.jsonl" if r == 0 else f"telemetry-{r}.jsonl")) as f:
            events = [json.loads(line) for line in f if line.strip()]
        memory = [e for e in events if e["event"] == "memory" and "opt_state_bytes_per_device" in e]
        assert memory, r
        for e in memory:
            assert e["params_bytes_per_device"] == want_params, r
            # torch's Adam keeps a float32 step per parameter, optax int32 counts
            assert e["opt_state_bytes_per_device"] - 4 * n_params == want_opt, r
            assert e["weight_update_sharding"] is True


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_trains_tensor_parallel(runs, world):
    ranks = runs[world]["ranks"]
    n_params = sum(p.numel() for p in build_model(
        ModelConfig(**dict(worker.TINY, input_shape=(32, 32))), "cpu").parameters())
    for out in ranks:
        assert out["trainer_results"] == ranks[0]["trainer_results"]
        assert len(out["trainer_results"]) == 2
        assert all(np.isfinite(v) for m in out["trainer_results"] for v in m.values())
        assert out["trainer_params"] == n_params
    d = os.path.join(runs[world]["dir"], "tp-trainer")
    with open(os.path.join(d, "telemetry.jsonl")) as f:
        header = json.loads(f.readline())
    assert header["mesh"] == {"batch": world // TP, "model": TP, "sequence": 1}
    state = _ckpt(os.path.join(d, "fold0"), 2)
    assert set(state["model"]) == set(build_model(ModelConfig(**dict(worker.TINY, input_shape=(32, 32))),
                                                  "cpu").state_dict())


def test_state_bytes_of_the_sliced_state_are_the_rule_s(tmp_path):
    """Offline, per rank of (1, 2): the slices' bytes are the rule's."""
    cfg = ModelConfig(**worker.TINY)
    tcfg = TrainConfig(**worker.TP_ADAM)
    whole = create_train_state(cfg, tcfg, "cpu", generator=torch.Generator().manual_seed(0))
    full = state_bytes(whole)
    dims = tensor.tensor_parallel_specs(whole.model, 2)
    named = dict(whole.model.named_parameters())
    sliced_params = sum(named[n].numel() * 4 // (2 if dims[n] is not None else 1) for n in named)
    for r in range(2):
        state = create_train_state(cfg, tcfg, "cpu", generator=torch.Generator().manual_seed(0))
        tensor.shard_state_tensor_parallel(state, tcfg, 2, r)
        got = state_bytes(state)
        assert got["params_bytes_per_device"] == sliced_params < full["params_bytes_per_device"]
        # slots (two moments, a step each) and the EMA follow the parameters
        assert got["opt_state_bytes_per_device"] == 3 * sliced_params + 4 * len(named)
        assert state.param_count() == whole.param_count()
    # LARS's trust ratio reads the whole leaf: its sliced leaves are known
    lars = TrainConfig(optimizer="lars", lr=0.5, weight_decay=1e-4)
    state = tensor.shard_state_tensor_parallel(
        create_train_state(cfg, lars, "cpu", generator=torch.Generator().manual_seed(0)), lars, 2, 0)
    assert state.optimizer.model_sharded == {id(p) for n, p in state.model.named_parameters() if dims[n] is not None}


# -- the refusals ---------------------------------------------------------------


def test_jax_value_errors_and_the_axes_that_stay_refused():
    for kw in (dict(model_parallel=2, sequence_parallel=2), dict(model_parallel=2, pipeline_parallel=2),
               dict(model_parallel=2, grad_accum_steps=2)):
        with pytest.raises(ValueError) as want:
            jconfig.TrainConfig(**kw)
        with pytest.raises(ValueError) as got:
            TrainConfig(**kw)
        assert str(got.value) == str(want.value)
    seg = ModelConfig(**worker.TINY)
    require_supported_training(seg, TrainConfig(model_parallel=2))
    require_supported_training(ModelConfig(**worker.TP_CLS), TrainConfig(model_parallel=2, weight_update_sharding=True))
    # the planner (queue A 12.5) is taken: the trainers take 'auto' resolved
    require_supported_training(seg, TrainConfig(parallelism="auto"))
    # the sequence axis (queue A 12.4) is taken: 33 x 33 gets JAX's
    # validate_spatial_config text at degree 2
    with pytest.raises(ValueError, match=r"divisible by stride\*sequence_parallel = 8\*2 = 16, got 33"):
        require_supported_training(seg, TrainConfig(sequence_parallel=2))
    # the expert axis (queue A 12.3) takes the MoE ViT only: JAX's fit text
    # for any other model, and JAX's combination text beside tensor parallelism
    with pytest.raises(ValueError, match=r"expert_parallel=2 requires moe_experts=2"):
        require_supported_training(seg, TrainConfig(expert_parallel=2))
    with pytest.raises(ValueError) as want:
        jconfig.TrainConfig(expert_parallel=2, model_parallel=2)
    with pytest.raises(ValueError) as got:
        TrainConfig(expert_parallel=2, model_parallel=2)
    assert str(got.value) == str(want.value)
    from tensorflowdistributedlearning_tpu_torch.parallel import mesh as tmesh

    assert tmesh.model_parallel_degree() == 1 and tmesh.expert_parallel_degree() == 1
    # the pipeline is fit's, for the ViT and Xception-41 classifiers: the
    # ResNet segmenter keeps JAX's refusal, its text
    from tensorflowdistributedlearning_tpu.train import pipeline_step as jpipeline_step

    with pytest.raises(ValueError) as want:
        jpipeline_step.validate_pipeline_config(jconfig.ModelConfig(**JSEG), 2, 2)
    with pytest.raises(ValueError) as got:
        require_supported_training(seg, TrainConfig(pipeline_parallel=2, pipeline_microbatches=2))
    assert str(got.value) == str(want.value)
    assert "does not support backbone='resnet'" in str(got.value)
    # the ViT's tensor parallelism is taken; Xception-41's stays refused
    # (JAX's own step cannot train it), naming queue A 12.2
    require_supported_training(ModelConfig(**worker.VIT_TINY), TrainConfig(model_parallel=2))
    with pytest.raises(NotImplementedError, match="queue A 12.2"):
        require_supported_training(worker.zero_fit_model(), TrainConfig(model_parallel=2))
    # one process cannot lay out two model positions: JAX's make_mesh text
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        create_train_state(seg, TrainConfig(model_parallel=2), "cpu", generator=torch.Generator().manual_seed(0))


def test_xception_classifier_under_tensor_parallelism_fails_in_jax_and_is_refused_here():
    """JAX's ``make_train_step_gspmd`` applies the model with no ``rngs``,
    so the Xception-41 classifier's training-mode dropout raises flax's
    ``InvalidRngError`` there: JAX's ``fit`` cannot train it
    tensor-parallel. The port refuses it before a step, naming A 12.2 (its
    keyless dropout would raise too: ``layers.dropout_generator``)."""
    import dataclasses

    from flax.errors import InvalidRngError
    from tensorflowdistributedlearning_tpu import configs as jconfigs

    model = dataclasses.replace(jconfigs.get_preset("xception41_imagenet").model, width_multiplier=0.0625,
                                input_shape=(16, 16), num_classes=10, dtype="float32")
    jm = jbuild(model)
    params, stats = _fill(jm, (1, 16, 16, 3))
    tx = jstep.make_optimizer(jconfig.TrainConfig())
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
                        apply_fn=jm.apply, tx=tx)
    jmesh = make_mesh(2, model_parallel=2)
    step = jtensor.make_train_step_gspmd(jmesh, jstep.ClassificationTask(), donate=False)
    batch = {"images": np.zeros((2, 16, 16, 3), np.float32), "labels": np.zeros((2,), np.int32)}
    with pytest.raises(InvalidRngError, match="dropout"):
        step(jtensor.shard_state_tensor_parallel(state, jmesh), jtensor.place_batch_gspmd(batch, jmesh))
    with pytest.raises(NotImplementedError, match="queue A 12.2"):
        require_supported_training(worker.zero_fit_model(), TrainConfig(model_parallel=2))


def test_place_batch_gspmd_takes_this_data_positions_rows():
    """One process is data position 0 of 1: the whole global batch, on the
    device asked for (JAX's ``place_batch_gspmd`` shards it over ``batch``)."""
    batch = _cls_batch(4)
    placed = tensor.place_batch_gspmd(batch, "cpu")
    assert set(placed) == set(batch)
    for k, v in batch.items():
        assert placed[k].device.type == "cpu" and np.array_equal(placed[k].numpy(), v)


@pytest.mark.parametrize("command", ["train", "fit"])
def test_model_parallel_flag_reaches_the_trainers(command, tmp_path):
    """``--model-parallel 2`` on the ``train`` and ``fit`` commands reaches
    ``TrainConfig.model_parallel``: one process cannot lay out two model
    positions, and says so with JAX's ``make_mesh`` text, the ViT preset
    too (its tensor parallelism is ported)."""
    from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main

    if command == "train":
        data, _, _ = make_salt_dataset(tmp_path, n_images=4, n_test=0, shape=(32, 32))
        args = ["train", "--data-dir", data, "--model-dir", str(tmp_path / "m"), "--input-shape", "32", "32",
                "--n-blocks", "1", "1", "1", "--base-depth", "8"]
    else:
        args = ["fit", "--preset", "cifar10_smoke", "--model-dir", str(tmp_path / "m")]
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel"):
        cli_main([*args, "--model-parallel", "2", "--device", "cpu"])
    if command == "fit":
        with pytest.raises(ValueError, match="1 devices not divisible by model_parallel"):
            cli_main(["fit", "--preset", "vit_s16_imagenet", "--model-dir", str(tmp_path / "v"), "--model-parallel",
                      "2", "--device", "cpu"])
