"""Tensor parallelism of the ViT (``parallel/tensor.py``'s forms for
``models/vit.py``'s LayerNorm, patch conv, position table and Switch-MoE
layer) against the JAX package's ``parallel/tensor.py``, on the CPU, with
the JAX package's tiny ViT (``tests/test_vit.py``) and its MoE twin.

- The layout, offline: at (dp, tp) = (1, 2) and (2, 2), with and without
  ZeRO-1, every rank's slice of every leaf holds the elements of JAX's
  shard on that rank's device (``devices_indices_map``).
- 2 and 4 gloo ranks at tp = 2 (``tests/test_torch_dp_worker.py`` mode
  ``vtp``, one launch each): a LayerNorm alone is the whole LayerNorm
  (output within 1e-6, gradients within 1e-6 of the largest), and the
  output local statistics would give is not; the sliced forward is the
  one-rank forward and flax's (1e-5 of the largest logit); ``fit``'s step
  (one plain-SGD step at lr 1, so the update is the gradient) is the
  port's one-rank step and JAX's ``make_train_step_gspmd`` at the
  train-step bounds (loss 1e-5, every leaf 1e-4·max|g| + 1e-6), the dense
  ViT with and without ZeRO-1, the MoE ViT without at (1, 2) (at (2, 2)
  ``fit_preset`` refuses it, given or planned, naming queue A 12.2), and
  the bf16 ViT within one bf16 step and 2e-2·max|g_leaf|; ``fit_preset`` with
  ``parallelism='auto'`` and ``model_parallel`` 2 trains, writes a whole
  checkpoint (the one-rank model's keys and shapes), JAX's three-key
  ``mesh`` and the planner's ``plan``, JAX's own header plan for that
  layout, and memory events whose bytes are the plan's prediction.
"""

from __future__ import annotations

import dataclasses
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
from tensorflowdistributedlearning_tpu.parallel import make_mesh
from tensorflowdistributedlearning_tpu.parallel import planner as jplanner
from tensorflowdistributedlearning_tpu.parallel import tensor as jtensor
from tensorflowdistributedlearning_tpu.parallel import zero as jzero
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig, require_supported_training
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.models.vit import LayerNorm
from tensorflowdistributedlearning_tpu_torch.parallel import planner, tensor, zero
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_tensor_parallel import _by_first, _fill
from tests.test_torch_zero1 import _same

TP = worker.TP
LAYOUTS = [(1, 2), (2, 2)]
STEPS = ("vit", "vit_zero", "moe")


@functools.lru_cache(maxsize=None)
def _models():
    """flax parameters (numpy-seeded, every entry distinct) of the tiny ViT
    and its MoE twin, with their port configs."""
    out = {}
    for name, kw in (("vit", worker.VTP_VIT), ("moe", worker.VTP_MOE)):
        jm = jbuild(jconfig.ModelConfig(**kw))
        params, _ = _fill(jm, (1, 16, 16, 3), seed=3)
        out[name] = dict(jm=jm, params=params, cfg=ModelConfig(**kw))
    return out


def test_require_supported_training_takes_the_vit_at_model_parallel_2():
    for kw in (worker.VTP_VIT, worker.VTP_MOE):
        require_supported_training(ModelConfig(**kw), TrainConfig(model_parallel=2))
        require_supported_training(ModelConfig(**kw), TrainConfig(model_parallel=2, weight_update_sharding=True))
        require_supported_training(ModelConfig(**kw), TrainConfig(model_parallel=2), n_devices=2)
    require_supported_training(ModelConfig(**worker.VTP_VIT), TrainConfig(model_parallel=2), n_devices=4)
    require_supported_training(ModelConfig(**worker.VTP_MOE), TrainConfig(), n_devices=4)
    with pytest.raises(NotImplementedError, match="queue A 12.2"):
        require_supported_training(ModelConfig(**worker.VTP_MOE), TrainConfig(model_parallel=2), n_devices=4)


@pytest.mark.parametrize("with_zero", [False, True], ids=["tp", "zero"])
@pytest.mark.parametrize("dp, tp", LAYOUTS)
@pytest.mark.parametrize("name", ["vit", "moe"])
def test_every_rank_holds_the_elements_of_jax_shard(name, dp, tp, with_zero):
    m = _models()[name]
    whole = from_flax(m["params"], {}, m["cfg"])
    leaves = _by_first(m["params"])
    jmesh = make_mesh(dp * tp, model_parallel=tp)
    devices = list(jmesh.devices.reshape(-1))
    template = build_model(m["cfg"], "cpu", generator=torch.Generator().manual_seed(0))
    n_model = 0
    for d in range(dp):
        for r in range(tp):
            model = build_model(m["cfg"], "cpu", generator=torch.Generator().manual_seed(0))
            model.load_state_dict(whole)
            layout = tensor.layout_for(template, tp, r)
            tensor.shard_model(model, layout)
            zl = zero.ZeroLayout(model, dp, d, tp=layout) if with_zero else None
            sliced = model.state_dict()
            for pname, t in whole.items():
                leaf = leaves[float(t.reshape(-1)[0])]
                spec = tuple(jtensor.tensor_parallel_spec_for_shape(leaf.shape, tp))
                mine = sliced[pname]
                if zl is not None and pname in zl.dims:
                    spec = tuple(jzero.weight_update_spec_for_degrees(leaf.shape, dp=dp, tp=tp))
                    mine = zl.slice(pname, mine)
                n_model += layout.dims[pname] is not None
                index = NamedSharding(jmesh, P(*spec)).devices_indices_map(leaf.shape)[devices[d * tp + r]]
                np.testing.assert_array_equal(np.sort(mine.reshape(-1).numpy()), np.sort(leaf[index].reshape(-1)),
                                              err_msg=f"{pname} at ({d}, {r})")
    # every leaf of the tiny ViT divides at tp 2 (its 4 classes too)
    assert n_model == len(whole) * dp * tp


# -- W gloo ranks ---------------------------------------------------------------


def _batch(n=8, seed=21):
    b = tsyn.synthetic_classification_batch(np.random.default_rng(seed), n, (16, 16), 3, 4)
    return {"images": b["images"], "labels": b["labels"]}


def _ln_inputs():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 5, 32)) * rng.uniform(0.5, 3.0, size=(1, 1, 32)) + 1.5).astype(np.float32)
    return {"ln_x": x, "ln_cotangent": rng.normal(size=x.shape).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, size=32).astype(np.float32),
            "bias": rng.normal(0, 0.1, size=32).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ms = _models()
    ln = _ln_inputs()
    init = {k: {"state_dict": from_flax(m["params"], {}, m["cfg"]), "step": 0} for k, m in ms.items()}
    init["ln"] = {"weight": torch.from_numpy(ln["weight"]), "bias": torch.from_numpy(ln["bias"])}
    batch = _batch()
    out = {"batch": batch, "ln": ln}
    for world in (2, 4):
        d = str(tmp_path_factory.mktemp(f"vtp{world}"))
        torch.save(init, os.path.join(d, "vtp_init.pt"))
        np.savez(os.path.join(d, "vtp_batch.npz"), ln_x=ln["ln_x"], ln_cotangent=ln["ln_cotangent"], **batch)
        out[world] = dict(ranks=worker.launch("vtp", world, d), dir=d)
    return out


def _whole_layer_norm(ln):
    """The unsharded LayerNorm's output and gradients on the same inputs."""
    layer = LayerNorm(32)
    layer.load_state_dict({"weight": torch.from_numpy(ln["weight"]), "bias": torch.from_numpy(ln["bias"])})
    x = torch.from_numpy(ln["ln_x"]).requires_grad_()
    y = layer(x)
    (y * torch.from_numpy(ln["ln_cotangent"])).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": layer.weight.grad, "dbias": layer.bias.grad}


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_lay_out_as_jax_mesh(runs, world):
    assert [o["layout"] for o in runs[world]["ranks"]] == [(world // TP, TP, r // TP, r % TP) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_layer_norm_takes_the_whole_row_statistics(runs, world):
    """The sharded LayerNorm is the whole one (1e-6), and flax's; the
    mistake of taking the statistics of the rank's own channels moves the
    output by far more than the bound, so this check fails it."""
    ln = runs["ln"]
    want = _whole_layer_norm(ln)
    import flax.linen as fnn

    flax_y = fnn.LayerNorm().apply({"params": {"scale": ln["weight"], "bias": ln["bias"]}}, ln["ln_x"])
    np.testing.assert_allclose(want["y"].numpy(), np.asarray(flax_y), atol=1e-5, rtol=0)
    for r, out in enumerate(runs[world]["ranks"]):
        got = out["ln"]
        for key in ("y", "dx", "dweight", "dbias"):
            scale = float(want[key].abs().max())
            gap = float((got[key] - want[key]).abs().max())
            assert gap <= 1e-6 * max(scale, 1.0), (r, key, gap)
        mistake = float((got["local_statistics"] - want["y"]).abs().max())
        assert mistake > 1e-2, (r, mistake)


def _flax_logits(name, images):
    m = _models()[name]
    return np.asarray(m["jm"].apply({"params": m["params"]}, jnp.asarray(images), train=False))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["vit", "moe"])
def test_tensor_parallel_forward_is_the_one_rank_and_flax_forward(runs, world, name):
    m = _models()[name]
    model = build_model(m["cfg"], "cpu")
    model.load_state_dict(from_flax(m["params"], {}, m["cfg"]))
    images = runs["batch"]["images"]
    with torch.no_grad():
        plain = model.eval()(torch.from_numpy(images)).numpy()
    flax_logits = _flax_logits(name, images)
    scale = float(np.abs(plain).max())
    np.testing.assert_allclose(plain, flax_logits, atol=1e-5 * scale, rtol=0)
    for out in runs[world]["ranks"]:
        np.testing.assert_allclose(out[name]["logits"].numpy(), plain, atol=1e-5 * scale, rtol=0)


def _hold_step(got, want, what):
    """Loss within 1e-5; every gradient leaf within 1e-4·max|g| + 1e-6 with
    max|g| over the whole gradient (the bound of
    ``tests/test_torch_tensor_parallel.py``)."""
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5, rtol=0, err_msg=what)
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    assert set(got["grads"]) == set(want["grads"]), what
    for k, g in want["grads"].items():
        gap = float((got["grads"][k] - g).abs().max())
        assert gap <= 1e-4 * gmax + 1e-6, (what, k, gap, gmax)


@functools.lru_cache(maxsize=None)
def _port_one_rank(name, dtype="float32"):
    """The port's one-process step without tensor parallelism on the whole
    batch, one plain-SGD step at lr 1, at one torch thread as each rank
    runs."""
    m = _models()[name]
    cfg = dataclasses.replace(m["cfg"], dtype=dtype)
    with worker.torch_threads(1):
        state = create_train_state(cfg, TrainConfig(**worker.TP_SGD), "cpu",
                                   state_dict=from_flax(m["params"], {}, m["cfg"]))
        state, metrics = tensor.make_train_step_gspmd(tstep.ClassificationTask())(
            state, {k: torch.from_numpy(v) for k, v in _batch().items()})
    return {"loss": tstep.compute_metrics(metrics)["loss"],
            "grads": {k: p.grad.clone() for k, p in state.model.named_parameters()}}


def _jax_step(name, world, with_zero):
    """JAX's ``make_train_step_gspmd`` on a (world / tp, tp) mesh, one
    plain-SGD step at lr 1: the loss and the gradient (the update), in the
    port's names."""
    m = _models()[name]
    tx = jstep.make_optimizer(jconfig.TrainConfig(**worker.TP_SGD))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=m["params"], batch_stats={},
                        opt_state=tx.init(m["params"]), apply_fn=m["jm"].apply, tx=tx)
    jmesh = make_mesh(world, model_parallel=TP)
    if with_zero:
        state = jzero.shard_state_weight_update(state, jmesh, tensor_parallel=True)
    else:
        state = jtensor.shard_state_tensor_parallel(state, jmesh)
    step = jtensor.make_train_step_gspmd(jmesh, jstep.ClassificationTask(), donate=False,
                                         weight_update_sharding=with_zero)
    before = jax.device_get(state.params)
    new, metrics = step(state, jtensor.place_batch_gspmd(_batch(), jmesh))
    p0 = from_flax(before, {}, m["cfg"])
    p1 = from_flax(jax.device_get(new.params), {}, m["cfg"])
    return {"loss": jstep.compute_metrics(metrics)["loss"], "grads": {k: p0[k] - p1[k] for k in p0}}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", STEPS)
def _refused(out):
    """The MoE ViT beside data parallelism: ``fit_preset`` refuses it, with
    the layout given and planned, naming queue A 12.2."""
    for how in ("explicit", "auto"):
        assert "queue A 12.2" in (out["refused"][how] or ""), (how, out["refused"])
        assert "Switch-MoE ViT beside data parallelism" in out["refused"][how]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", STEPS)
def test_fit_step_is_the_one_rank_step(runs, world, name):
    """The step is the one-rank step on the global batch. At (2, 2) the MoE
    ViT is refused (JAX's step routes the global batch as one pool, the
    port's each data index's rows; ROADMAP.md, standing findings)."""
    want = _port_one_rank("moe" if name == "moe" else "vit")
    for r, out in enumerate(runs[world]["ranks"]):
        if name == "moe" and world > TP:
            _refused(out[name])
            continue
        _hold_step(out[name], want, f"{name} step, rank {r} of {world}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", STEPS)
def test_fit_step_matches_jax_gspmd_step(runs, world, name):
    """Against JAX's whole-step tensor-parallel step; the MoE ViT at dp = 1,
    where it trains (above)."""
    want = _jax_step("moe" if name == "moe" else "vit", world, name == "vit_zero")
    for r, out in enumerate(runs[world]["ranks"]):
        if name == "moe" and world > TP:
            _refused(out[name])
            continue
        _hold_step(out[name], want, f"{name} step, rank {r} of {world}")


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_step_is_the_one_rank_bf16_step(runs, world):
    """bf16 compute (the chip's arm; its gathers travel as bytes and its
    cotangent sums in float32 under gloo): the loss within one bf16 step,
    every leaf within 2e-2 of its largest one-rank gradient."""
    want = _port_one_rank("vit", "bfloat16")
    for r, out in enumerate(runs[world]["ranks"]):
        got = out["vit_bf16"]
        assert abs(got["loss"] - want["loss"]) <= 2.0 ** -8 * abs(want["loss"]), (r, got["loss"], want["loss"])
        for k, g in want["grads"].items():
            gap = float((got["grads"][k] - g).abs().max())
            assert gap <= 2e-2 * float(g.abs().max()) + 1e-6, (r, k, gap)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_of_a_model_group_agree_and_hold_half_of_each_leaf(runs, world):
    ranks = runs[world]["ranks"]
    whole = {k: tuple(v.shape) for k, v in from_flax(_models()["vit"]["params"], {}, _models()["vit"]["cfg"]).items()}
    for r, out in enumerate(ranks):
        for name in STEPS if world == TP else ("vit", "vit_zero"):
            assert _same(out[name]["state"], ranks[0][name]["state"]), (r, name)
        for k, shape in out["vit"]["slices"].items():
            assert np.prod(shape) * TP == np.prod(whole[k]), (r, k)


def _ledger(d, rank=0):
    name = "telemetry.jsonl" if rank == 0 else f"telemetry-{rank}.jsonl"
    with open(os.path.join(d, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("world", [2, 4])
def test_fit_preset_trains_at_model_parallel_2_with_a_whole_checkpoint(runs, world):
    d = os.path.join(runs[world]["dir"], "vtp-fit")
    cfg = ModelConfig(**worker.VTP_VIT)
    template = build_model(cfg, "cpu").state_dict()
    for out in runs[world]["ranks"]:
        assert all(np.isfinite(v) for v in out["fit"]["metrics"].values())
        assert out["fit"]["n_params"] == sum(t.numel() for t in build_model(cfg, "cpu").parameters())
    state = torch.load(os.path.join(d, "checkpoints", "2", "state.pt"), weights_only=False)
    assert {k: tuple(v.shape) for k, v in state["model"].items()} == {k: tuple(v.shape) for k, v in template.items()}
    header = _ledger(d)[0]
    assert header["mesh"] == {"batch": world // TP, "model": TP, "sequence": 1}
    plan = header["plan"]
    assert plan["source"] == "auto" and plan["layout"]["model_parallel"] == TP
    assert plan["layout"]["data_parallel"] == world // TP


@pytest.mark.parametrize("world", [2, 4])
def test_header_plan_is_jax_and_memory_events_are_its_prediction(runs, world):
    """The header's plan equals JAX's planner's for the same layout on the
    same topology (JAX's CPU devices; the port's gloo ranks are one host's
    local devices); each rank's memory event holds the predicted parameter
    bytes, and the predicted optimizer bytes once torch's per-parameter
    float32 Adam steps are swapped for optax's two int32 counts."""
    d = os.path.join(runs[world]["dir"], "vtp-fit")
    header = _ledger(d)[0]
    preset = worker.vtp_preset()
    tcfg = dataclasses.replace(preset.train, parallelism="auto", model_parallel=TP, n_devices=world)
    want = jplanner.plan(
        jconfig.ModelConfig(**worker.VTP_VIT),
        jconfig.TrainConfig(**worker.VTP_FIT, parallelism="auto", model_parallel=TP, n_devices=world),
        preset.global_batch,
        topology=jplanner.Topology(n_devices=world, local_device_count=world), pinned={"model_parallel": TP},
        source="auto")
    assert header["plan"] == json.loads(json.dumps(want.header()))
    predicted = header["plan"]["predicted"]
    n_leaves = len(build_model(ModelConfig(**worker.VTP_VIT), "cpu").state_dict())
    for r in range(world):
        memory = [e for e in _ledger(d, r) if e["event"] == "memory" and "opt_state_bytes_per_device" in e]
        assert memory, r
        for e in memory:
            assert e["params_bytes_per_device"] == predicted["params_bytes_per_chip"], r
            assert e["opt_state_bytes_per_device"] - 4 * n_leaves + 2 * 4 == predicted["opt_state_bytes_per_chip"], r
    # and the port's planner gives the same plan offline
    got = planner.plan(ModelConfig(**worker.VTP_VIT), tcfg, preset.global_batch,
                       topology=planner.Topology(n_devices=world, local_device_count=world),
                       pinned={"model_parallel": TP}, source="auto")
    assert json.loads(json.dumps(got.header())) == header["plan"]
