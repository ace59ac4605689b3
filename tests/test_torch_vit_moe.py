"""The Switch-MoE ViT of the port (``models/vit.MoEMlp``, ``parallel/expert.py``,
``TrainConfig.expert_parallel``) against the JAX package's, on the CPU.

The model is JAX's ``MOE_CFG_KW`` (``tests/test_expert.py``: 16x16x3,
patch 4, embed 32, 4 heads, 4 layers of which ``block2`` and ``block4`` are
MoE, 4 experts at capacity factor 2.0, float32), from one set of
numpy-perturbed flax variables (``utils.convert.from_flax``).

- logits against flax within 1e-5, and ``from_flax`` on the full
  ``vit_s16_moe_imagenet`` tree from ``jax.eval_shape`` (71 694 184
  parameters);
- one train step against JAX's ``make_train_step`` on a one-device mesh:
  the loss with the load-balancing losses in it within 1e-5, each gradient
  leaf within ``1e-4·max|g_leaf| + 1e-6``; with ``grad_accum_steps`` 2 (a
  plain-SGD step at lr 1, whose update is the gradient) the new parameters
  within the same bound;
- the decay mask equal to JAX's ``kernel_decay_mask``; ``remat`` bit for
  bit; ``fit`` with every expert local (each load-balancing value in
  [0.99, E), JAX's own test's bound: ``E · Σ f_e P_e`` is 1 at a uniform
  split and is not bounded below by 1 (0.99899 measured here); the
  fractions summing to 1);
- 2 and 4 gloo ranks of ``tests/test_torch_dp_worker.py`` mode ``ep`` at
  ``expert_parallel`` 2 (``(1, 2)`` and ``(2, 2)``), one launch each, run
  while the references are computed: one plain-SGD step at lr 1 against
  the port's dense step on each data slot's rows (averaged over the
  slots) and against JAX's expert-parallel step on ``make_mesh(W,
  model_parallel=2)``, both within the leaf bound; ZeRO-1 bit for bit the
  replicated step; accumulation against the dense accumulation per slot;
  the eval step; a resumed expert-parallel fit (with and without ZeRO-1)
  bit for bit the uninterrupted one, its checkpoint served by the plain
  model;
- every serving spec's closure of a tiny MoE ViT against JAX's, at the
  bounds of ``tests/test_torch_vit_serve.py`` (float32 compute: the
  routing is float32 in both packages), and the engine's zero padding:
  padding rows take capacity slots, so a bucket's answer is the closure's
  on the padded batch, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import tensorflowdistributedlearning_tpu.models.vit as jvit
from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu import configs as jconfigs
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.ops import quant_kernels as jqk
from tensorflowdistributedlearning_tpu.parallel import make_mesh, replicate, shard_batch
from tensorflowdistributedlearning_tpu.parallel.mesh import MODEL_AXIS
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig, require_supported
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.models import build_model, model_for
from tensorflowdistributedlearning_tpu_torch.models import vit as tvit
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer
from tensorflowdistributedlearning_tpu_torch.train.serving import export_serving_artifact
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, kernel_leaves, params_from_flax
from tests import test_torch_dp_worker as worker
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests import test_torch_vit_serve as vserve
from tests.test_expert import MOE_CFG_KW
from tests.test_torch_vit import tiny_vit_pair


BATCH = 8
WORLDS = (2, 4)
MOE_PRESET_PARAMS = 71_694_184
SGD = worker.TP_SGD  # one plain-SGD step at lr 1: the update is the gradient


def _leaf_bound(got, want, what):
    """Every leaf of ``got`` within ``1e-4·max|want_leaf| + 1e-6``."""
    assert set(got) == set(want), what
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-6, (what, name, err, float(w.abs().max()))


def _pair(seed=0, **over):
    kw = dict(MOE_CFG_KW, **over)
    jm = jbuild(jconfig.ModelConfig(**kw))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
                                    v["params"])
    cfg = ModelConfig(**kw)
    return jm, params, cfg, from_flax(params, {}, cfg)


def _batch(n, seed=5, classes=4):
    return tsyn.synthetic_classification_batch(np.random.default_rng(seed), n, (16, 16), 3, classes)


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_state(jm, params, tcfg_kwargs, apply_fn=None):
    tx = jstep.make_optimizer(jconfig.TrainConfig(**tcfg_kwargs))
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={}, opt_state=tx.init(params),
                       apply_fn=apply_fn or jm.apply, tx=tx)


# -- the model -----------------------------------------------------------------------


def test_moe_vit_is_supported_and_every_other_block_is_moe():
    require_supported(tconfigs.get_preset("vit_s16_moe_imagenet").model)
    model = build_model(ModelConfig(**MOE_CFG_KW), "cpu")
    moe = [n for n, m in model.named_modules() if isinstance(m, tvit.MoEMlp)]
    assert moe == ["block2.moe", "block4.moe"]
    assert not hasattr(model.block2, "mlp_in") and hasattr(model.block1, "mlp_in")
    assert [n for n, _ in model.block2.moe.named_parameters()] == ["router", "w_in", "b_in", "w_out", "b_out"]
    assert not any(isinstance(m, torch.nn.Linear) for m in model.block2.moe.modules())


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_flax(seed):
    jm, params, cfg, state = _pair(seed)
    x = np.random.default_rng(seed + 7).normal(size=(6, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    model = build_model(cfg, "cpu")
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # eval mode records nothing; a training forward records each MoE layer's loss and fractions
    assert tvit.pop_aux_losses(model) == []
    model.train()
    model(torch.from_numpy(x))
    layers = tvit.moe_layers(model)
    assert all(abs(float(m.expert_fraction.sum()) - 1.0) <= 1e-6 for m in layers)
    assert len(tvit.pop_aux_losses(model)) == 2 and tvit.pop_aux_losses(model) == []


def test_moe_layers_follow_flax_collection_order():
    cfg = ModelConfig(**dict(MOE_CFG_KW, vit_layers=12))
    with torch.device("meta"):
        model = model_for(cfg)
    names = {id(m): n for n, m in model.named_modules()}
    assert [names[id(m)] for m in tvit.moe_layers(model)] == [f"block{i}.moe" for i in (10, 12, 2, 4, 6, 8)]


def test_full_preset_tree_maps_strictly():
    """The full vit_s16_moe_imagenet tree, shapes from ``jax.eval_shape``:
    zeros carry the shapes through ``from_flax``; the MoE leaves are not
    kernels (int8 storage keeps them float)."""
    jcfg = jconfigs.get_preset("vit_s16_moe_imagenet").model
    tcfg = tconfigs.get_preset("vit_s16_moe_imagenet").model
    x = jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a: jbuild(jcfg).init(jax.random.key(0), a, train=False), x)["params"]
    flat = {"/".join(k): np.broadcast_to(np.float32(0), v.shape) for k, v in flatten_dict(shapes).items()}
    assert sum(int(np.prod(v.shape)) for v in flat.values()) == MOE_PRESET_PARAMS
    with torch.device("meta"):
        template = model_for(tcfg)
    assert sum(p.numel() for p in template.parameters()) == MOE_PRESET_PARAMS
    state = from_flax(flat, {}, tcfg)
    assert set(state) == set(template.state_dict())
    assert tuple(state["block2.moe.w_in"].shape) == (8, 384, 1536)
    assert len(kernel_leaves(tcfg)) == 6 * 4 + 6 * 2 + 2


def test_init_follows_flax_initializers():
    cfg = ModelConfig(**dict(MOE_CFG_KW, embed_dim=64, moe_experts=8))
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    moe = model.block2.moe
    for w, fan_in in ((moe.w_in, 64), (moe.w_out, 256)):  # lecun normal over each expert's fan-in
        assert abs(w.std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
        assert w.abs().max().item() <= 2 * fan_in ** -0.5 / 0.87962566103423978 + 1e-6
    assert abs(moe.router.std().item() - 0.02) < 0.004
    assert not moe.b_in.any() and not moe.b_out.any()


def test_decay_mask_equals_jax():
    _, params, cfg, _ = _pair()
    jmask = jstep.kernel_decay_mask(params)
    as_arrays = jax.tree.map(lambda p, m: np.full(np.shape(p), float(m), np.float32), params, jmask)
    want = params_from_flax(as_arrays, cfg)
    got = tstep.kernel_decay_mask(build_model(cfg, "cpu"))
    assert set(got) == set(want)
    for name, m in got.items():
        assert bool(want[name].all()) == m and bool(want[name].any()) == m, name
    assert got["block2.moe.router"] and got["block2.moe.w_in"] and not got["block2.moe.b_out"]


def test_remat_is_bit_for_bit():
    cfg = ModelConfig(**MOE_CFG_KW)
    models = [build_model(c, "cpu", generator=torch.Generator().manual_seed(0)).train()
              for c in (dataclasses.replace(cfg, remat=True), cfg)]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32))
    for m in models:
        loss = m(x).float().square().mean()
        for aux in tvit.pop_aux_losses(m):
            loss = loss + aux
        loss.backward()
    for (name, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(a.grad, b.grad), name


# -- one train step against JAX's ----------------------------------------------------------


def _jax_loss_and_grads(jm, params, batch):
    task = jstep.ClassificationTask()

    def loss_fn(p):
        logits, mutated = jm.apply({"params": p}, jnp.asarray(batch["images"]), train=True, mutable=["aux_loss"])
        loss = task.loss(logits, {"labels": jnp.asarray(batch["labels"])})
        return loss + sum(jax.tree.leaves(mutated["aux_loss"]))

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def test_train_step_matches_jax():
    jm, params, cfg, state = _pair()
    batch = _batch(BATCH)
    adam = dict(optimizer="adam", lr=1e-3, weight_decay=0.1)
    mesh = make_mesh(1)
    _, jmetrics = jstep.make_train_step(mesh, jstep.ClassificationTask(), donate=False)(
        replicate(_jax_state(jm, params, adam), mesh), shard_batch(batch, mesh))
    jloss, jgrads = _jax_loss_and_grads(jm, params, batch)
    tstate = create_train_state(cfg, TrainConfig(**adam), "cpu", state_dict=state)
    loss, _ = tstep.forward_backward(tstate, tstep.ClassificationTask(), _torch(batch))
    plain = jstep.ClassificationTask().loss(jm.apply({"params": params}, jnp.asarray(batch["images"])),
                                           {"labels": jnp.asarray(batch["labels"])})
    for ref in (float(jloss), jstep.compute_metrics(jmetrics)["loss"]):
        assert abs(float(loss) - ref) <= 1e-5, (float(loss), ref)
    assert float(jloss) - float(plain) >= 2 * 0.01 * (1 - 1e-5)  # two MoE layers' aux, each >= 0.01·1
    _leaf_bound({n: p.grad for n, p in tstate.model.named_parameters()}, from_flax(jax.device_get(jgrads), {}, cfg),
                "one step")


def test_accumulated_step_matches_jax():
    jm, params, cfg, state = _pair(seed=2)
    batch = _batch(BATCH, seed=6)
    mesh = make_mesh(1)
    jnew, jmetrics = jstep.make_train_step(mesh, jstep.ClassificationTask(), donate=False, accum=2)(
        replicate(_jax_state(jm, params, SGD), mesh), shard_batch(batch, mesh))
    tstate = create_train_state(cfg, TrainConfig(**SGD, grad_accum_steps=2), "cpu", state_dict=state)
    tstate, tmetrics = tstep.make_train_step(tstep.ClassificationTask(), accum=2)(tstate, _torch(batch))
    want = from_flax(jax.device_get(jnew.params), {}, cfg)
    got = {n: p.detach() for n, p in tstate.model.named_parameters()}
    grads = {n: state[n] - w for n, w in want.items()}
    _leaf_bound({n: state[n] - g for n, g in got.items()}, grads, "accumulated step")
    assert abs(tstep.compute_metrics(tmetrics)["loss"] - jstep.compute_metrics(jmetrics)["loss"]) <= 1e-5


def test_fit_with_every_expert_local(tmp_path):
    cfg = ModelConfig(**MOE_CFG_KW)
    tcfg = TrainConfig(optimizer="adam", lr=1e-3, seed=0, checkpoint_every_steps=4, augmentation="none")
    trainer = ClassifierTrainer(str(tmp_path), None, cfg, tcfg, device="cpu")
    result = trainer.fit(batch_size=16, steps=4)
    assert result.steps == 4 and all(np.isfinite(v) for v in result.final_metrics.values())
    best = trainer._restore_best_host()
    best.model.train()
    best.model(_torch(_batch(32, seed=9))["images"])
    layers = tvit.moe_layers(best.model)
    aux = tvit.pop_aux_losses(best.model)
    assert len(aux) == 2
    for m, a in zip(layers, aux):
        balance = float(a.detach()) / cfg.moe_aux_weight
        assert 0.99 <= balance < cfg.moe_experts
        assert abs(float(m.expert_fraction.sum()) - 1.0) <= 1e-6 and m.expert_fraction.shape == (4,)
    # the exported artifact serves through the plain model
    serve = trainer.serving_fn()
    assert serve(_batch(3, seed=4)["images"])["probabilities"].shape == (3, 4)


def test_expert_parallel_flags():
    """``fit --expert-parallel`` reaches the config; a degree that is not
    ``moe_experts`` is refused with the JAX ``fit``'s text; the axes that
    stay refused name their queue items."""
    from tensorflowdistributedlearning_tpu_torch import __main__ as cli

    args = cli.build_parser().parse_args(["fit", "--preset", "vit_s16_moe_imagenet", "--model-dir", "m",
                                          "--expert-parallel", "8"])
    assert args.expert_parallel == 8
    assert cli.build_parser().parse_args(["fit", "--preset", "p", "--model-dir", "m"]).expert_parallel is None
    from tensorflowdistributedlearning_tpu_torch.config import require_supported_training

    with pytest.raises(ValueError, match=r"expert_parallel=2 requires moe_experts=2 \(one expert per shard\); got "
                                         r"moe_experts=4"):
        require_supported_training(ModelConfig(**MOE_CFG_KW), TrainConfig(expert_parallel=2))
    with pytest.raises(ValueError, match="pipeline_parallel and moe_experts cannot combine"):
        require_supported_training(ModelConfig(**MOE_CFG_KW), TrainConfig(pipeline_parallel=2))
    require_supported_training(ModelConfig(**dict(MOE_CFG_KW, moe_experts=2)), TrainConfig(expert_parallel=2))


# -- expert parallelism over gloo ranks -----------------------------------------------------------


def _ep_batch(world):
    return _batch(4 * (world // worker.EP), seed=20 + world)


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """Both launches' ranks, and the references, computed while the ranks run."""
    assert worker.EP_VIT == dict(MOE_CFG_KW, moe_experts=worker.EP)
    jm, params, cfg, state = _pair(seed=3, moe_experts=worker.EP)
    out = {"params": params, "cfg": cfg, "state": state, "jm": jm}
    started = []
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"ep{world}"))
        torch.save({"state_dict": state, "step": 0}, os.path.join(d, "ep_init.pt"))
        np.savez(os.path.join(d, "ep_batch.npz"), **_ep_batch(world))
        out[world] = dict(dir=d)
        started.append(worker.start("ep", world, d))
    try:
        for world in WORLDS:
            out[world].update(_references(jm, params, cfg, state, world))
    finally:
        for world, launched in zip(WORLDS, started):
            out[world]["ranks"] = worker.finish(launched)
    return out


def _references(jm, params, cfg, state, world):
    """The dense one-rank steps on each data slot's rows, averaged (plain
    and accumulated), and JAX's expert-parallel step on a (dp, 2) mesh."""
    batch = _ep_batch(world)
    dp = world // worker.EP
    local = len(batch["labels"]) // dp
    refs = {}
    for name, accum in (("dense", 1), ("dense_accum", 2)):
        grads = []
        for d in range(dp):
            rows = {k: torch.from_numpy(v[d * local:(d + 1) * local]) for k, v in batch.items()}
            s = create_train_state(cfg, TrainConfig(**SGD, grad_accum_steps=accum), "cpu", state_dict=state)
            s, _ = tstep.make_train_step(tstep.ClassificationTask(), accum=accum)(s, rows)
            grads.append({n: state[n] - p.detach() for n, p in s.model.named_parameters()})
        refs[name] = {n: sum(g[n] for g in grads) / dp for n in grads[0]}
    mesh = make_mesh(world, model_parallel=worker.EP)
    ep_model = jbuild(jconfig.ModelConfig(**worker.EP_VIT), expert_axis_name=MODEL_AXIS)
    jnew, jmetrics = jstep.make_train_step(mesh, jstep.ClassificationTask(), donate=False)(
        replicate(_jax_state(jm, params, SGD, apply_fn=ep_model.apply), mesh), shard_batch(batch, mesh))
    refs["jax"] = {n: state[n] - w for n, w in from_flax(jax.device_get(jnew.params), {}, cfg).items()}
    refs["jax_loss"] = jstep.compute_metrics(jmetrics)["loss"]
    return refs


def _grads(ep_runs, params):
    state = ep_runs["state"]
    return {n: state[n] - params[n] for n in state}


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_step_is_the_dense_step_per_data_slot(ep_runs, world):
    run = ep_runs[world]
    ranks = run["ranks"]
    dp = world // worker.EP
    for r, o in enumerate(ranks):
        assert o["layout"] == [dp, worker.EP, r // worker.EP, r % worker.EP, worker.EP]
        assert o["ep_groups"] == ["True"]
        # the ranks end the step with one state
        for name in ("ep", "ep_zero", "ep_accum"):
            assert all(torch.equal(o[name]["params"][k], ranks[0][name]["params"][k]) for k in o[name]["params"])
    got = _grads(ep_runs, ranks[0]["ep"]["params"])
    _leaf_bound(got, run["dense"], f"EP step at {world} ranks against the dense step per slot")
    _leaf_bound(got, run["jax"], f"EP step at {world} ranks against JAX's")
    assert abs(ranks[0]["ep"]["metrics"]["loss"] - run["jax_loss"]) <= 1e-5
    _leaf_bound(_grads(ep_runs, ranks[0]["ep_accum"]["params"]), run["dense_accum"],
                f"accumulated EP step at {world} ranks")
    # ZeRO-1 over the data group (dp > 1) is bit for bit the replicated step
    assert ranks[0]["ep_zero_zero"] == (dp > 1)
    zero, plain = ranks[0]["ep_zero"]["params"], ranks[0]["ep"]["params"]
    assert all(torch.equal(zero[k], plain[k]) for k in plain)
    for o in ranks:
        assert all(abs(float(f.sum()) - 1.0) <= 1e-6 for f in o["ep"]["fractions"])
        assert np.isfinite(o["eval"]["loss"]) and o["eval"] == ranks[0]["eval"]


@pytest.mark.parametrize("world", WORLDS)
def test_expert_parallel_fit_resumes_bit_for_bit(ep_runs, world, tmp_path):
    run = ep_runs[world]
    fit = run["ranks"][0]["fit_runs"]
    for zero in (False, True):
        assert fit[f"{zero}_resumed_4"] == fit[f"{zero}_straight_4"]
        assert all(np.isfinite(v) for v in fit[f"{zero}_straight_4"].values())
    assert all(o["fit_runs"] == fit for o in run["ranks"])
    # the checkpoint is the plain strategy's: a one-process trainer serves it
    trainer = ClassifierTrainer(os.path.join(run["dir"], "ep-fit-True-straight"), None, ep_runs["cfg"],
                                TrainConfig(**{k: v for k, v in worker.EP_FIT.items() if k != "expert_parallel"}),
                                device="cpu")
    assert trainer._restore_best_host().step == 4
    assert trainer.serving_fn()(_batch(2, seed=1)["images"])["class"].shape == (2,)


# -- serving -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_pair():
    return tiny_vit_pair("float32", True, batch=6, moe_experts=4, moe_capacity_factor=2.0)


@pytest.fixture(autouse=True)
def jax_kernels_open(monkeypatch):
    monkeypatch.setattr(jvit, "_fused_platform_ok", lambda: True)
    monkeypatch.setattr(jqk, "int8_matmul", functools.partial(jqk.int8_matmul, interpret=True))


@pytest.mark.parametrize("spec", vserve.SPECS)
def test_serving_closure_matches_jax(moe_pair, spec):
    x = moe_pair["x"]
    want = vserve._jax_closure(moe_pair, spec, x)
    got = {k: v.numpy() for k, v in vserve._port_closure(moe_pair, spec)(x).items()}
    tol_max, tol_mean = vserve.TOLS[("float32", "int8-compute" if spec == "int8-compute" else "float")]
    d = np.abs(got["probabilities"] - want["probabilities"])
    assert d.max() <= tol_max, (d.max(), tol_max)
    if tol_mean is not None:
        assert d.mean() <= tol_mean, (d.mean(), tol_mean)
    top2 = np.sort(want["probabilities"], axis=-1)[:, -2:]
    separated = top2[:, 1] - top2[:, 0] > 2 * tol_max
    np.testing.assert_array_equal(got["class"][separated], want["class"][separated])
    # the MoE leaves stay float under every spec: the int8 paths take kernels and Dense layers only
    model = vserve._port_model(moe_pair, spec)
    assert model.block2.moe.w_in.dtype == torch.float32 and isinstance(model.block2.moe, tvit.MoEMlp)


def test_engine_pads_a_bucket_into_the_routing_pool(moe_pair, tmp_path):
    """The engine zero-pads 5 instances to bucket 8, as JAX's does; the pad
    rows join the routing pool and take capacity slots, so the answer is
    the closure's on the padded batch (the first 5 rows)."""
    model = build_model(moe_pair["cfg"], "cpu")
    model.load_state_dict(moe_pair["state"], strict=True)
    manifest = export_serving_artifact(model, moe_pair["cfg"], str(tmp_path / "art"))
    engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device="cpu", buckets=(8,))
    x = moe_pair["x"][:5]
    padded = np.concatenate([x, np.zeros((3,) + x.shape[1:], np.float32)])
    want = vserve._port_closure(moe_pair, "float32")(padded)
    got = engine.infer(x)
    np.testing.assert_array_equal(got["probabilities"], want["probabilities"][:5].numpy())
    np.testing.assert_array_equal(got["class"], want["class"][:5].numpy())
