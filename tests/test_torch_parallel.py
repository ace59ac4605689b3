"""The port's data-parallel step against the JAX package's, on the CPU.

The helpers (batch splits, eval step counts, round-robin ids, the rows of a
rank) are held against the JAX package's on the same arguments. Then W = 2
and W = 4 gloo ranks (``tests/test_torch_dp_worker.py``, one launch each, shared
by the tests of that W) take their rows of the same global batches of 8
from one numpy-seeded state carried over by ``from_flax_train_state``, and
the parent holds what they wrote against JAX's ``make_train_step`` on a
W-device mesh and against the port's single-device step on the whole
batch. Bounds, as the JAX package's own tests state them: replicas bitwise
equal; loss 1e-5; parameters after one Nesterov-SGD step 1e-3·lr and BN
statistics 1e-5 against JAX (under sigmoid cross entropy, the smooth
objective ``tests/test_torch_train_step.py`` holds SGD steps under); under ``sync_batch_norm``
parameters 1e-4 and statistics 1e-5 against the whole-batch step (the JAX
package's sync-BN oracle bounds); per-rank BN's statistics more than 1e-4
from the whole batch's; eval metrics over an uneven split 1e-6 of the
single-process pass (sums in another order).
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.data import pipeline as jpipe
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.parallel import make_mesh, replicate, shard_batch
from tensorflowdistributedlearning_tpu.parallel import mesh as jmesh
from tensorflowdistributedlearning_tpu.parallel import multihost as jmultihost
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import augment as taugment
from tensorflowdistributedlearning_tpu_torch.data import pipeline as tpipe
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, split_moments
from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh, multihost
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train_step import _flax_variables, _JaxBceTask


GLOBAL_BATCH, STEPS, EVAL_N, EVAL_BATCH = 8, 3, 9, 4
LR = worker.SGD["lr"]
JTINY = {k: v for k, v in worker.TINY.items() if k != "use_pallas_depthwise"}


# -- the helpers against JAX's -------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_batch_split_and_eval_steps_match_jax(monkeypatch, p):
    monkeypatch.setattr(jmultihost.jax, "process_count", lambda: p)
    monkeypatch.setattr(multihost, "process_count", lambda: p)
    for g in (8, 9, 12, 64):
        try:
            want = jmultihost.per_process_batch_size(g)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                multihost.per_process_batch_size(g)
        else:
            assert multihost.per_process_batch_size(g) == want
    for n in (0, 1, 7, 9, 32, 33):
        for b in (1, 2, 4, 5):
            assert multihost.eval_num_batches(n, b) == jmultihost.eval_num_batches(n, b), (n, b)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_host_shard_is_jax_round_robin(monkeypatch, p):
    ids = [f"im{i:02d}" for i in range(11)]
    monkeypatch.setattr(jpipe.jax, "process_count", lambda: p)
    monkeypatch.setattr(multihost, "process_count", lambda: p)
    for r in range(p):
        monkeypatch.setattr(jpipe.jax, "process_index", lambda: r)
        monkeypatch.setattr(multihost, "process_index", lambda: r)
        assert tpipe.host_shard(ids) == jpipe.host_shard(ids)
    monkeypatch.undo()
    assert tpipe.host_shard(ids) == ids


@pytest.mark.parametrize("world", [2, 4, 8])
def test_shard_rows_are_the_rows_shard_batch_gives_each_device(world):
    placed = shard_batch({"x": np.arange(GLOBAL_BATCH)}, make_mesh(world))["x"]
    devices = list(make_mesh(world).devices.flat)
    for shard in placed.addressable_shards:
        r = devices.index(shard.device)
        want = np.arange(GLOBAL_BATCH)[mesh.shard_rows(GLOBAL_BATCH, r, world)]
        np.testing.assert_array_equal(np.asarray(shard.data), want)


def test_local_batch_size_error_matches_jax():
    with pytest.raises(ValueError) as want:
        jmesh.local_batch_size(GLOBAL_BATCH, make_mesh(3))
    with pytest.raises(ValueError, match=str(want.value)):
        mesh.local_batch_size(GLOBAL_BATCH, 3)
    assert mesh.local_batch_size(GLOBAL_BATCH) == GLOBAL_BATCH and mesh.data_parallel_degree() == 1


@pytest.mark.parametrize("sync", [False, True])
def test_split_moments_of_one_block_is_batch_norm_bit_for_bit(sync):
    """``split_moments(1)``, the emulation's statistics, is training-mode
    BatchNorm: output and running statistics to the bit (with no group,
    ``sync`` reduces over nothing). The gradients are held to 1e-6 of their
    scale: the moments reach the input through one chunk view there, so
    autograd adds the input's three gradient terms in another grouping."""
    gen = torch.Generator().manual_seed(3)
    x = 2 * torch.randn(8, 5, 5, 6, generator=gen) + 0.5
    scale, shift = torch.rand(6, generator=gen) + 0.5, torch.randn(6, generator=gen)
    plain_moments = BatchNorm._moments
    got = []
    for split in (False, True):
        bn = BatchNorm(6, sync=sync).train()
        with torch.no_grad():
            bn.weight.copy_(scale)
            bn.bias.copy_(shift)
        xi = x.clone().requires_grad_()
        with split_moments(1) if split else contextlib.nullcontext():
            y = bn(xi, act="relu")
        y.square().sum().backward()
        got.append(((y.detach(), bn.running_mean, bn.running_var), (xi.grad, bn.weight.grad, bn.bias.grad)))
        assert BatchNorm._moments is plain_moments
    (plain, plain_grads), (split, split_grads) = got
    for a, b in zip(plain, split):
        assert torch.equal(a, b)
    for a, b in zip(plain_grads, split_grads):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6 * a.abs().max().item())


def test_eval_batches_forced_steps_match_jax():
    rng = np.random.default_rng(0)
    images, masks = rng.normal(size=(5, 4, 4, 1)).astype(np.float32), (rng.uniform(size=(5, 4, 4, 1)) > 0.5)
    ids = [str(i) for i in range(5)]
    jds = jpipe.InMemoryDataset(images, masks.astype(np.float32), ids)
    tds = tpipe.InMemoryDataset(images, masks.astype(np.float32), ids)
    for n_batches in (None, 2, 4):
        want = list(jpipe.eval_batches(jds, 2, num_batches=n_batches))
        got = list(tpipe.eval_batches(tds, 2, num_batches=n_batches))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_without_a_group_everything_is_one_process(monkeypatch):
    for var in worker_env_vars():
        monkeypatch.delenv(var, raising=False)
    multihost.initialize()
    assert not collectives.is_initialized()
    assert multihost.process_info() == {"process_index": 0, "process_count": 1, "local_device_count": 1,
                                        "global_device_count": 1}
    assert multihost.all_processes_max_batches(5, 2) == 3 and multihost.broadcast_object("x") == "x"
    x = torch.arange(3.0, requires_grad=True)
    assert collectives.pmean(x) is x
    t = torch.arange(4.0)
    collectives.psum_(t)
    collectives.pmean_([t])
    collectives.broadcast_(t)
    assert torch.equal(t, torch.arange(4.0))
    assert multihost.backend_for("cpu") == "gloo" and multihost.backend_for(None) == "nccl"


def worker_env_vars():
    return ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def test_explicit_group_arguments_must_come_together_and_failures_raise(tmp_path):
    with pytest.raises(ValueError, match="together"):
        multihost.initialize("localhost:1234", None, 0, backend="gloo")
    # NCCL asked for where there is no card: raises, no quiet swap to gloo
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="gloo"):
            multihost.initialize(f"file://{tmp_path}/store", 1, 0)
    assert not collectives.is_initialized()


def test_world_of_one_step_is_the_single_device_step(tmp_path):
    # a group of one rank: the mean over one rank divides by 1, so three
    # data-parallel steps are bit for bit three single-device steps
    cfg = ModelConfig(**worker.TINY)
    batches = _global_batches()
    init = create_train_state(cfg, TrainConfig(**worker.SGD), "cpu", generator=torch.Generator().manual_seed(0))
    state_dict = {k: v.clone() for k, v in init.model.state_dict().items()}
    plain = create_train_state(cfg, TrainConfig(**worker.SGD), "cpu", state_dict=state_dict)
    multihost.initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo", timeout=60)
    try:
        assert multihost.process_info()["process_count"] == 1
        dp = create_train_state(cfg, TrainConfig(**worker.SGD, sync_batch_norm=True), "cpu", state_dict=state_dict)
        task = worker._bce_task()
        steps = (tstep.make_train_step(task, data_parallel=True), tstep.make_train_step(task))
        for k in range(STEPS):
            batch = _torch_rows({n: batches[n][k] for n in batches}, slice(None))
            _, m_dp = steps[0](dp, batch)
            _, m_plain = steps[1](plain, batch)
            assert tstep.compute_metrics(m_dp) == tstep.compute_metrics(m_plain)
    finally:
        multihost.shutdown()
    assert not collectives.is_initialized()
    for (name, a), b in zip(dp.model.state_dict().items(), plain.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_flat_grad_buffer_holds_every_gradient():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    flat = collectives.flat_grad_buffer(model.parameters())
    assert flat.numel() == sum(p.numel() for p in model.parameters())
    model(torch.ones(5, 3)).sum().backward()
    assert float(flat.abs().sum()) > 0
    for p in model.parameters():
        assert p.grad.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="one dtype"):
        collectives.flat_grad_buffer([torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(2).double())])


# -- W gloo ranks against the JAX step ----------------------------------------


def _global_batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(STEPS):
        b = tsyn.synthetic_segmentation_batch(rng, GLOBAL_BATCH, (33, 33))
        b["images"] = b["images"] + rng.normal(0, 0.3, b["images"].shape).astype(np.float32)
        out.append(b)
    return {k: np.stack([b[k] for b in out]) for k in ("images", "labels")}


def _jax_step(params, stats, world, sync):
    jm = jbuild(jconfig.ModelConfig(**JTINY, use_pallas_depthwise=True),
                bn_axis_name=jmesh.BATCH_AXIS if sync else None)
    tx = jstep.make_optimizer(jconfig.TrainConfig(**worker.SGD))
    m = make_mesh(world)
    state = replicate(JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                  opt_state=tx.init(params), apply_fn=jm.apply, tx=tx), m)
    return state, jstep.make_train_step(m, _JaxBceTask(), donate=False), m


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"W{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    directory = str(tmp_path_factory.mktemp(f"dp{world}"))
    cfg = ModelConfig(**worker.TINY)
    params, stats = _flax_variables(jbuild(jconfig.ModelConfig(**JTINY, use_pallas_depthwise=True)))
    init = {"state_dict": from_flax(params, stats, cfg), "step": 0}
    torch.save(init, f"{directory}/init.pt")
    batches = _global_batches()
    np.savez(f"{directory}/batches.npz", **batches)
    rng = np.random.default_rng(9)
    ev = dict(images=rng.normal(size=(EVAL_N, 33, 33, 1)).astype(np.float32),
              masks=(rng.uniform(size=(EVAL_N, 33, 33, 1)) > 0.6).astype(np.float32), batch=EVAL_BATCH)
    np.savez(f"{directory}/eval.npz", **ev)
    out = worker.launch("step", world, directory)
    first = {k: batches[k][0] for k in batches}
    jax_out = {}
    for sync in (False, True):
        jstate, jtrain, m = _jax_step(params, stats, world, sync)
        jstate, jm = jtrain(jstate, shard_batch(first, m))
        host = jax.device_get(jstate)
        jax_out[sync] = dict(state=from_flax(host.params, host.batch_stats, cfg),
                             loss=jstep.compute_metrics(jm)["loss"])
    whole = create_train_state(cfg, TrainConfig(**worker.SGD), "cpu", state_dict=init["state_dict"])
    whole, wm = tstep.make_train_step(worker._bce_task())(whole, _torch_rows(first, slice(None)))
    whole_out = dict(state={k: v.detach().clone() for k, v in whole.model.state_dict().items()},
                     loss=tstep.compute_metrics(wm)["loss"])
    emulated, gaps = _emulate(cfg, init["state_dict"], params, stats, first, world)
    split = create_train_state(cfg, TrainConfig(**worker.SGD), "cpu", state_dict=init["state_dict"])
    with split_moments(world):
        tstep.make_train_step(worker._bce_task())(split, _torch_rows(first, slice(None)))
    split = {k: v.detach().clone() for k, v in split.model.state_dict().items()}
    return dict(world=world, out=out, init=init, jax=jax_out, whole=whole_out, emulated=emulated, gaps=gaps,
                split=split, ev=ev, cfg=cfg)


def _torch_rows(batch, rows):
    return {k: torch.from_numpy(batch[k][rows]) for k in ("images", "labels")}


def _emulate(cfg, state_dict, params, stats, batch, world):
    """The data-parallel step's semantics in one process: the port's
    single-device forward and backward on each rank's rows, gradients
    averaged, one update, BN statistics averaged. Also, per parameter, the
    largest gap between the two packages' single-device gradients on one
    rank's rows."""
    jm = jbuild(jconfig.ModelConfig(**JTINY, use_pallas_depthwise=True))

    def jax_loss(p, x, y):
        logits, _ = jm.apply({"params": p, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
        return _JaxBceTask().loss(logits, {"labels": y})

    jax_grad = jax.jit(jax.grad(jax_loss))
    state = create_train_state(cfg, TrainConfig(**worker.SGD), "cpu", state_dict=state_dict)
    grads, running, gaps = {}, {}, {}
    for r in range(world):
        state.model.load_state_dict(state_dict)
        rows = mesh.shard_rows(GLOBAL_BATCH, r, world)
        tstep.forward_backward(state, worker._bce_task(), _torch_rows(batch, rows))
        want = from_flax(jax.device_get(jax_grad(params, batch["images"][rows], batch["labels"][rows])), stats, cfg)
        for n, p in state.model.named_parameters():
            grads[n] = grads.get(n, 0) + p.grad
            gaps[n] = max(gaps.get(n, 0.0), float((p.grad - want[n]).abs().max()))
        for n, b in state.model.named_buffers():
            running[n] = running.get(n, 0) + b
    state.model.load_state_dict(state_dict)
    for n, p in state.model.named_parameters():
        p.grad = grads[n] / world
    state.apply_gradients()
    with torch.no_grad():
        for n, b in state.model.named_buffers():
            b.copy_(running[n] / world)
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}, gaps


def _max_diff(a, b, stats: bool):
    return max(float((a[k] - b[k]).abs().max()) for k in b if ("running" in k) == stats)


def test_ranks_stay_bitwise_equal(ranks):
    first = ranks["out"][0]
    keys = [k for k in first if k.startswith(("per_rank_", "sync_")) and isinstance(first[k], dict)]
    assert sorted(keys) == sorted(f"{n}_{s}" for n in ("per_rank", "sync") for s in (1, STEPS))
    for other in ranks["out"][1:]:
        for k in keys:
            for name, t in first[k].items():
                assert torch.equal(t, other[k][name]), (k, name)
        assert other["per_rank_losses"] == first["per_rank_losses"]
        assert other["eval"] == first["eval"]


def test_replicate_copies_rank0_state(ranks):
    want = ranks["init"]["state_dict"]
    for out in ranks["out"]:
        for name, t in out["replicated"].items():
            assert torch.equal(t, want[name]), name


def test_gradients_are_one_flat_buffer_on_every_rank(ranks):
    assert all(out["per_rank_flat"] and out["sync_flat"] for out in ranks["out"])


def test_per_rank_bn_step_is_the_mean_of_the_shards_steps(ranks):
    # gradients and statistics averaged, one update: only the order of the
    # ranks' sum differs from the emulation
    got, want = ranks["out"][0]["per_rank_1"], ranks["emulated"]
    assert _max_diff(got, want, stats=False) <= 1e-6
    assert _max_diff(got, want, stats=True) <= 1e-6


def test_per_rank_bn_step_matches_jax(ranks):
    got, want = ranks["out"][0], ranks["jax"][False]
    np.testing.assert_allclose(got["per_rank_losses"][0], want["loss"], atol=1e-5, rtol=0)
    assert _max_diff(got["per_rank_1"], want["state"], stats=True) <= 1e-5
    # 1e-3·lr, plus what the two packages' single-device gradients on one
    # rank's rows already differ by, moved by the first Nesterov update
    # lr·(1 + momentum)·g: on a few rows a kink (ReLU, max-pool) where the
    # packages' f32 roundings take different branches moves a stem
    # gradient by up to 1e-3, with or without data parallelism
    step = LR * (1 + worker.SGD["sgd_momentum"])
    for name, gap in ranks["gaps"].items():
        err = float((got["per_rank_1"][name] - want["state"][name]).abs().max())
        assert err <= 1e-3 * LR + step * gap, (name, err, gap)


def test_sync_bn_step_matches_jax_and_the_whole_batch(ranks):
    got, want, whole = ranks["out"][0], ranks["jax"][True], ranks["whole"]
    np.testing.assert_allclose(got["sync_losses"][0], want["loss"], atol=1e-5, rtol=0)
    assert _max_diff(got["sync_1"], want["state"], stats=False) <= 1e-3 * LR
    assert _max_diff(got["sync_1"], want["state"], stats=True) <= 1e-5
    np.testing.assert_allclose(got["sync_losses"][0], whole["loss"], atol=1e-5, rtol=0)
    assert _max_diff(got["sync_1"], whole["state"], stats=False) <= 1e-4
    assert _max_diff(got["sync_1"], whole["state"], stats=True) <= 1e-5


def test_sync_bn_step_is_the_whole_batch_step_with_the_ranks_statistics(ranks):
    # the whole-batch step with the statistics formed from the ranks' blocks:
    # the same forward up to the order of a sum of W terms, so the update
    # agrees to f32 rounding. (Against the plain whole-batch step the stem's
    # gradients move by up to 1% at this width: a rounding-level change of
    # the statistics takes a ReLU or max-pool kink the other way.)
    got, want = ranks["out"][0]["sync_1"], ranks["split"]
    assert _max_diff(got, want, stats=False) <= 1e-6
    assert _max_diff(got, want, stats=True) <= 1e-6


def test_per_rank_bn_is_not_the_whole_batch(ranks):
    # negative control: without sync the statistics are the shards' means
    assert _max_diff(ranks["out"][0]["per_rank_1"], ranks["whole"]["state"], stats=True) > 1e-4


def test_uneven_eval_gives_the_single_process_metrics(ranks):
    world, ev = ranks["world"], ranks["ev"]
    ids = [str(i) for i in range(EVAL_N)]
    model = create_train_state(ranks["cfg"], TrainConfig(**worker.SGD), "cpu",
                               state_dict=ranks["out"][0][f"sync_{STEPS}"]).model
    acc = None
    eval_step = tstep.make_eval_step(tstep.SegmentationTask())
    dataset = tpipe.InMemoryDataset(ev["images"], ev["masks"], ids)
    for raw in tpipe.eval_batches(dataset, EVAL_BATCH):
        batch = taugment.prepare_eval_batch(torch.from_numpy(raw["images"]), torch.from_numpy(raw["masks"]))
        batch["valid"] = torch.from_numpy(raw["valid"])
        acc = tstep.merge_metrics(acc, eval_step(model, batch))
    want = tstep.compute_metrics(acc)
    for r, out in enumerate(ranks["out"]):
        assert out["eval_shard"] == ids[r::world]
        largest_shard = -(-EVAL_N // world)
        assert out["eval_steps"] == -(-largest_shard // (EVAL_BATCH // world))
        for k in want:
            np.testing.assert_allclose(out["eval"][k], want[k], atol=1e-6, rtol=0, err_msg=k)


def test_collectives_across_ranks(ranks):
    w = ranks["world"]
    for r, out in enumerate(ranks["out"]):
        c = out["collectives"]
        a, b = c["psum"]
        assert torch.equal(a, torch.tensor([float(sum(range(1, w + 1))), 2.0 * sum(range(w))]))
        assert torch.equal(b, torch.full((2, 3), float(sum(range(w)))))
        assert torch.allclose(c["pmean"], torch.tensor([sum(range(w)) / w, 1.0]), atol=0)
        assert torch.equal(c["pmax"], torch.tensor([float(w - 1), 0.0]))
        assert torch.equal(c["broadcast"], torch.zeros(3))
        x_mean = torch.tensor([sum(1.0 + s for s in range(w)) / w, sum(2.0 * s for s in range(w)) / w])
        torch.testing.assert_close(c["pmean_y"], x_mean, atol=1e-7, rtol=0)
        # d/dx_r of sum_s <pmean(x), w_s> / ... : the mean of the ranks' cotangents
        torch.testing.assert_close(c["pmean_grad"], torch.tensor([sum(s + 1.0 for s in range(w)) / w, 3.0]),
                                   atol=1e-7, rtol=0)
        assert c["max_batches"] == -(-(3 * (w - 1) + 1) // 2)
        assert c["object"] == {"rank": 0}
        assert c["info"] == {"process_index": r, "process_count": w, "local_device_count": 1,
                             "global_device_count": w}
