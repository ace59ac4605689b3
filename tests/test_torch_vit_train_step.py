"""One ViT training step of the port against the JAX package's, on the CPU.

A tiny ViT (16x16x3 input, patch 4: 16 tokens; embed 32, 2 heads of 16, 2
layers, 10 classes, fused attention) starts in both packages from one set
of numpy-perturbed flax variables (``utils.convert.from_flax``) and takes
the same numpy-seeded batch under the ViT preset's optimizer: AdamW with
weight decay 0.1 on the kernels, global-norm clip 1.0, label smoothing 0.1.
JAX's fused attention is forced open (``vit._fused_platform_ok``), so its
gradients come from the Pallas kernel's custom VJP (``_flash_bwd``) in the
interpreter; the port's from ``flash_attention``'s ``autograd.Function``.

Tolerances, stated where used:

- float32 compute: loss 1e-5; each gradient leaf within
  ``1e-4·max|g_leaf| + 1e-6`` (float32 sums in another order);
- bfloat16 compute: the loss within 2e-2 of JAX's (relative), and each
  leaf of the port's gradient within ``2e-2·max|g_leaf|`` of the JAX
  package's float32-compute gradient from the same variables (the ViT's
  bf16 bound, ``tests/test_torch_vit.py``: both packages round every Dense,
  LayerNorm and gelu output to bf16, at different places inside each op).
  Against JAX's own bf16 gradient each leaf is held to 2e-2·max|g_leaf|
  plus JAX's distance from its float32 gradient on that leaf: XLA reduces
  the bias gradients in bf16, which puts JAX's up to 3.6e-2 of the leaf's
  largest value from float32 (measured), where the port's stay within
  1.4e-2;
- parameters after one AdamW step: Adam's first update is about
  ``lr·sign(g)``, so an entry whose gradient lies below the two packages'
  float32 noise may move the other way: mean over all entries 0.05·lr,
  every entry 2·lr (``tests/test_torch_train_step.py``'s Adam bounds);
- a third step after two JAX steps carried across with their optax
  moments and EMA (``load_optax_state``): mean over all entries 0.02·lr,
  every entry 1·lr. The moments' two steps of history agree exactly; the
  third gradient's float32 noise still moves ``m / sqrt(v)`` where the
  gradient history is itself at the noise floor (measured: mean 8.2e-3·lr,
  max 0.38·lr, about 5 % of the entries above 0.01·lr); restarted moments
  put the whole update about ``lr·sign(g)`` off, so their drift is
  asserted to be far larger.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorflowdistributedlearning_tpu.models.vit as jvit
from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.parallel import make_mesh, replicate, shard_batch
from tensorflowdistributedlearning_tpu.train import step as jstep
from tensorflowdistributedlearning_tpu.train.state import TrainState as JTrainState
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.data import synthetic as tsyn
from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train.state import create_train_state
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, from_flax_train_state, load_optax_state
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY = dict(backbone="vit", num_classes=10, input_shape=(16, 16), input_channels=3, patch_size=4, embed_dim=32,
            num_heads=2, vit_layers=2, output_stride=None, use_fused_attention=True)
LR = 1e-3
ADAMW = dict(optimizer="adam", lr=LR, weight_decay=0.1, grad_clip_norm=1.0, label_smoothing=0.1,
             lr_schedule="cosine", lr_warmup_steps=1, lr_decay_steps=10)
BATCH = 8


@pytest.fixture(autouse=True)
def fused_jax(monkeypatch):
    monkeypatch.setattr(jvit, "_fused_platform_ok", lambda: True)


def _setup(dtype, seed=0):
    jm = jbuild(jconfig.ModelConfig(**TINY, dtype=dtype))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 16, 16, 3)).astype(np.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
                                    v["params"])
    return jm, params, ModelConfig(**TINY, dtype=dtype)


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return [tsyn.synthetic_classification_batch(rng, BATCH, (16, 16), 3, 10) for _ in range(n)]


def _jax_state(jm, params, tcfg_kwargs):
    tx = jstep.make_optimizer(jconfig.TrainConfig(**tcfg_kwargs))
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params), apply_fn=jm.apply, tx=tx)


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_loss_and_grads(jm, params, batch):
    task = jstep.ClassificationTask(label_smoothing=0.1)

    def loss_fn(p, images, labels):
        return task.loss(jm.apply({"params": p}, images, train=True), {"labels": labels})

    return jax.jit(jax.value_and_grad(loss_fn))(params, jnp.asarray(batch["images"]), jnp.asarray(batch["labels"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_gradients_match_jax(dtype):
    jm, params, cfg = _setup(dtype)
    batch = _batches(1)[0]
    jloss, jgrads = _jax_loss_and_grads(jm, params, batch)
    mesh = make_mesh(1)
    _, jmetrics = jstep.make_train_step(mesh, jstep.ClassificationTask(label_smoothing=0.1), donate=False)(
        replicate(_jax_state(jm, params, ADAMW), mesh), shard_batch(batch, mesh))
    step_loss = jstep.compute_metrics(jmetrics)["loss"]
    tstate = create_train_state(cfg, TrainConfig(**ADAMW), "cpu", state_dict=from_flax(params, {}, cfg))
    kernels.reset_launch_counts()
    loss, _ = tstep.forward_backward(tstate, tstep.ClassificationTask(label_smoothing=0.1), _torch(batch))
    assert sum(kernels.launch_counts().values()) == 0
    want = from_flax(jax.device_get(jgrads), {}, cfg)
    for ref in (float(jloss), step_loss):
        assert abs(float(loss) - ref) <= (1e-5 if dtype == "float32" else 2e-2 * abs(ref)), (float(loss), ref)
    truth = want
    if dtype == "bfloat16":  # the float32-compute gradient from the same variables
        jm32, _, _ = _setup("float32")
        truth = from_flax(jax.device_get(_jax_loss_and_grads(jm32, params, batch)[1]), {}, cfg)
    n = 0
    for name, p in tstate.model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        scale = float(truth[name].abs().max())
        err = float((p.grad - truth[name]).abs().max())
        if dtype == "float32":
            assert err <= 1e-4 * scale + 1e-6, (name, err, scale)
        else:
            assert err <= 2e-2 * scale, (name, err, scale)
            jax_err = float((want[name] - truth[name]).abs().max())
            err = float((p.grad - want[name]).abs().max())
            assert err <= 2e-2 * scale + jax_err, (name, err, scale, jax_err)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads))


def test_one_adamw_step_matches_jax():
    jm, params, cfg = _setup("float32", seed=1)
    mesh = make_mesh(1)
    jstate = replicate(_jax_state(jm, params, ADAMW), mesh)
    jtrain = jstep.make_train_step(mesh, jstep.ClassificationTask(label_smoothing=0.1), donate=False)
    state_dict, step = from_flax_train_state(jax.device_get(jstate), cfg)
    tstate = create_train_state(cfg, TrainConfig(**ADAMW), "cpu", state_dict=state_dict, step=step)
    ttrain = tstep.make_train_step(tstep.ClassificationTask(label_smoothing=0.1))
    batch = _batches(1, seed=6)[0]
    jstate, jm_metrics = jtrain(jstate, shard_batch(batch, mesh))
    tstate, tm_metrics = ttrain(tstate, _torch(batch))
    jv, tv = jstep.compute_metrics(jm_metrics), tstep.compute_metrics(tm_metrics)
    assert set(jv) == set(tv) == {"loss", "metrics/top1", "metrics/top5"}
    assert abs(tv["loss"] - jv["loss"]) <= 1e-5 and tv["metrics/top1"] == jv["metrics/top1"]
    want = from_flax(jax.device_get(jstate).params, {}, cfg)
    drift = torch.cat([(p.detach() - want[n]).abs().flatten() for n, p in tstate.model.named_parameters()])
    assert float(drift.mean()) <= 0.05 * LR and float(drift.max()) <= 2 * LR
    assert tstate.step == int(jstate.step) == 1


def test_a_step_after_carried_optax_moments_matches_jax():
    """Two JAX steps, then the state with its AdamW moments and EMA carried
    into the port: the third step agrees far more tightly than one from
    restarted moments would."""
    kw = dict(ADAMW, ema_decay=0.5)
    jm, params, cfg = _setup("float32", seed=2)
    mesh = make_mesh(1)
    jstate = replicate(_jax_state(jm, params, kw), mesh)
    jtrain = jstep.make_train_step(mesh, jstep.ClassificationTask(label_smoothing=0.1), donate=False)
    b1, b2, b3 = _batches(3, seed=7)
    for b in (b1, b2):
        jstate, _ = jtrain(jstate, shard_batch(b, mesh))
    host = jax.device_get(jstate)
    ttrain = tstep.make_train_step(tstep.ClassificationTask(label_smoothing=0.1))
    drifts = {}
    for carry in (True, False):
        state_dict, step = from_flax_train_state(host, cfg)
        tstate = create_train_state(cfg, TrainConfig(**kw), "cpu", state_dict=state_dict, step=step)
        if carry:
            load_optax_state(tstate, host.opt_state, cfg)
        tstate, _ = ttrain(tstate, _torch(b3))
        drifts[carry] = tstate
    jstate, _ = jtrain(jstate, shard_batch(b3, mesh))
    host = jax.device_get(jstate)
    want = from_flax(host.params, {}, cfg)
    want_ema = from_flax(jstep.find_ema_params(host.opt_state), {}, cfg)

    def drift(state, ref, ema=False):
        src = state.ema if ema else dict(state.model.named_parameters())
        return torch.cat([(src[n].detach() - ref[n]).abs().flatten() for n in ref])

    carried = drift(drifts[True], want)
    assert float(carried.mean()) <= 0.02 * LR and float(carried.max()) <= LR
    ema = drift(drifts[True], want_ema, ema=True)
    assert float(ema.mean()) <= 0.02 * LR and float(ema.max()) <= LR
    assert float(drift(drifts[False], want).mean()) > 10 * float(carried.mean())
    assert drifts[True].step == 3


def test_load_optax_state_is_strict():
    jm, params, cfg = _setup("float32")
    host = _jax_state(jm, params, ADAMW)
    with pytest.raises(ValueError, match="EMA"):
        load_optax_state(create_train_state(cfg, TrainConfig(**ADAMW, ema_decay=0.9), "cpu",
                                            state_dict=from_flax(params, {}, cfg)), host.opt_state, cfg)
    with pytest.raises(ValueError, match="not Adam"):
        load_optax_state(create_train_state(cfg, TrainConfig(optimizer="sgd"), "cpu",
                                            state_dict=from_flax(params, {}, cfg)), host.opt_state, cfg)
    sgd = _jax_state(jm, params, dict(optimizer="sgd"))
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        load_optax_state(create_train_state(cfg, TrainConfig(**ADAMW), "cpu", state_dict=from_flax(params, {}, cfg)),
                         sgd.opt_state, cfg)


def test_vit_kernels_are_decayed_as_jax_masks_them():
    jm, params, cfg = _setup("float32")
    jmask = {"/".join(str(getattr(k, "key", k)) for k in path): bool(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jstep.kernel_decay_mask(params))[0]}
    model = create_train_state(cfg, TrainConfig(**ADAMW), "cpu", state_dict=from_flax(params, {}, cfg)).model
    mask = tstep.kernel_decay_mask(model)
    decayed = {n for n, m in mask.items() if m}
    want = {n for n, w in from_flax(params, {}, cfg).items()
            if any(jmask[p] for p in jmask if p.endswith("kernel") and _port_name(p) == n)}
    assert decayed == want and len(decayed) == sum(jmask.values())
    assert "pos_embedding" not in decayed and "patch_embed.weight" in decayed


def _port_name(flax_path: str) -> str:
    return flax_path.replace("/kernel", ".weight").replace("/", ".")
