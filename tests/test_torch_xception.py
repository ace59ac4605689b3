"""The port's Xception-41 (``models/xception.py``) against the JAX package's
flax modules, on the CPU.

Weights come from the flax model's ``init`` (perturbed, with random BN
statistics so BN is no identity) and cross over through ``from_flax``; the
inputs are made with numpy from a seed. Both packages run at
``width_multiplier`` 0.125 on 33x33x2 (segmenter; 34x34 with the
space-to-depth stem, which needs even sides) and 64x64x3 (classifier)
inputs, and with ``keep_prob=1.0`` (a module attribute in each) so the
classifier's dropout draws nothing. Tolerances, stated where used:

- float32 outputs: 1e-5·max(1, max|out|) (float32 rounding of the same
  graph in two frameworks);
- bf16 outputs: within 2e-2·max|out| of flax's float32 outputs plus flax's
  own bf16-vs-float32 distance (the two round every op's output to bf16,
  at different places inside each op);
- one training step on batch statistics (sigmoid or softmax cross
  entropy): the loss within 1e-5 (relative), the new running statistics
  within 1e-5;
- its gradients, leaf by leaf, within 1e-4·max|g_leaf| + 1e-6: in float32
  with the BatchNorm statistics fixed to the running ones (flax's
  ``train=False`` forward; the port's training forward with
  ``BatchNorm._moments`` giving the running moments), and on batch
  statistics in float64 (both packages' graphs computed in float64: JAX
  under ``jax.enable_x64`` with the modules' float32 compute dtype read
  as float64, the port with every layer's compute dtype float64). On batch
  statistics BatchNorm at these widths amplifies float32 rounding into
  the gradients, so float32 is no witness there. Readings on the CPU, the
  worst leaf's distance from JAX's float64 gradient in units of the
  tolerance: the port in float64 8.8e-4 (segmenter) and 5.1e-4
  (classifier); in float32 the port 0.26 and 807, JAX 0.42 and 1768.
"""

from __future__ import annotations

import dataclasses
import os
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import resnet as jresnet
from tensorflowdistributedlearning_tpu.models import xception as jxception
from tensorflowdistributedlearning_tpu.ops import losses as jlosses
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.models import empty_model, model_for
from tensorflowdistributedlearning_tpu_torch.models import xception as txception
from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, dropout_key
from tensorflowdistributedlearning_tpu_torch.ops import losses as tlosses
from tensorflowdistributedlearning_tpu_torch.train.state import template_train_state
from tensorflowdistributedlearning_tpu_torch.train.step import dropout_seed
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, kernel_leaves, params_from_flax
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


SEG = dict(backbone="xception", width_multiplier=0.125, base_depth=16, input_shape=(33, 33),
           use_pallas_depthwise=True)
CLS = dict(backbone="xception", width_multiplier=0.125, num_classes=10, input_shape=(64, 64), input_channels=3)

# (name, config kwargs): the segmenter at output strides 8, 16 and None, the
# space-to-depth stem, and the classifier
VARIANTS = {
    "seg_os8": dict(SEG, output_stride=8),
    "seg_os16": dict(SEG, output_stride=16),
    "seg_os_none": dict(SEG, output_stride=None),
    "seg_os8_s2d": dict(SEG, output_stride=8, input_shape=(34, 34), stem_space_to_depth=True),
    "cls": CLS,
    "cls_s2d": dict(CLS, stem_space_to_depth=True),
}


def _flax(kw):
    cfg = jconfig.ModelConfig(**kw)
    if cfg.num_classes is None:
        return jxception.XceptionSegmentation(cfg)
    return jxception.Xception41(cfg, keep_prob=1.0)


def _port(kw, state=None):
    cfg = ModelConfig(**kw)
    with torch.device("cpu"):
        model = model_for(cfg)
    if isinstance(model, txception.Xception41):
        model.keep_prob = 1.0
    if state is not None:
        model.load_state_dict(state)
    return cfg, model.eval()


def _variables(kw, seed=0):
    jm = _flax(kw)
    rng = np.random.default_rng(seed)
    h, w = kw["input_shape"]
    x = rng.normal(size=(2, h, w, kw.get("input_channels", 2))).astype(np.float32)
    v = jm.init(jax.random.key(seed), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), v["params"])
    stats = unflatten_dict({
        k: (rng.uniform(0.5, 1.5, a.shape) if k[-1] == "var" else rng.normal(0, 0.2, a.shape)).astype(np.float32)
        for k, a in flatten_dict(v["batch_stats"]).items()
    })
    return jm, params, stats, x


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    kw = VARIANTS[request.param]
    jm, params, stats, x = _variables(kw)
    v = {"params": params, "batch_stats": stats}
    j16 = _flax(dict(kw, dtype="bfloat16"))
    return dict(name=request.param, kw=kw, params=params, stats=stats, x=x,
                want32=np.asarray(jm.apply(v, jnp.asarray(x), train=False)),
                want16=np.asarray(j16.apply(v, jnp.asarray(x), train=False)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_forward_matches_flax(variant, dtype):
    kw = dict(variant["kw"], dtype=dtype)
    cfg, model = _port(kw, from_flax(variant["params"], variant["stats"], ModelConfig(**kw)))
    with torch.inference_mode():
        got = model(torch.from_numpy(variant["x"])).numpy()
    want = variant["want32"]
    assert got.dtype == np.float32 and got.shape == want.shape and want.std() > 0.05
    err = float(np.abs(got - want).max())
    if dtype == "float32":
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err
    else:
        jax_gap = float(np.abs(variant["want16"] - want).max())
        assert err <= 2e-2 * float(np.abs(want).max()) + jax_gap, (err, jax_gap)


def test_every_flax_leaf_maps_onto_one_port_tensor(variant):
    cfg = ModelConfig(**variant["kw"])
    state = from_flax(variant["params"], variant["stats"], cfg)
    _, model = _port(variant["kw"])
    assert set(state) == set(model.state_dict())
    assert len(state) == len(flatten_dict(variant["params"])) + len(flatten_dict(variant["stats"]))
    # the grouped depthwise filters: flax [3, 3, 1, C] -> [C, 1, 3, 3]
    flat = flatten_dict(variant["params"], sep="/")
    leaf = "backbone/entry_block1_unit1/separable_conv1/depthwise/kernel"
    got = state["backbone.entry_block1_unit1.separable_conv1.depthwise.weight"].numpy()
    assert flat[leaf].shape[2] == 1 and np.array_equal(got, flat[leaf].transpose(3, 2, 0, 1))
    leaves = kernel_leaves(cfg)
    assert leaves["backbone.entry_block1_unit1.separable_conv1.depthwise.weight"] == (leaf, 0)
    assert all(v[0] in flat for v in leaves.values())


def _losses(cfg, x):
    """(flax loss, port loss) of random labels: sigmoid cross entropy for
    the segmenter, softmax cross entropy for the classifier."""
    rng = np.random.default_rng(3)
    if cfg.num_classes is None:
        labels = (rng.uniform(size=x.shape[:3] + (1,)) < 0.4).astype(np.float32)
        return (lambda logits: jlosses.sigmoid_cross_entropy(logits, jnp.asarray(labels)),
                lambda logits: tlosses.sigmoid_cross_entropy(logits, torch.from_numpy(labels)))
    onehot = np.eye(cfg.num_classes, dtype=np.float32)[rng.integers(0, cfg.num_classes, size=x.shape[0])]
    return (lambda logits: jnp.mean(-jnp.sum(jax.nn.log_softmax(logits) * onehot, axis=-1)),
            lambda logits: torch.mean(-torch.sum(torch.log_softmax(logits, -1) * torch.from_numpy(onehot), dim=-1)))


def _running_moments(bn, xf):
    """``BatchNorm._moments`` with the statistics fixed: ``E[x]`` and
    ``E[x²]`` of the running mean and variance."""
    return bn.running_mean, bn.running_var + bn.running_mean * bn.running_mean


@pytest.mark.parametrize("name", ["seg_os8", "cls"])
def test_one_train_step_matches_flax(name):
    kw = VARIANTS[name]
    cfg = ModelConfig(**kw)
    jm, params, stats, x = _variables(kw, seed=1)
    if cfg.num_classes:
        # its exit flow runs at 2x2: batch statistics over 2 images would
        # turn rounding into the loss's fifth digit
        x = np.random.default_rng(5).normal(size=(16,) + x.shape[1:]).astype(np.float32)
    jloss, tloss = _losses(cfg, x)

    def batch_stats_loss(p):
        logits, new = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jloss(logits), new["batch_stats"]

    def fixed_stats_loss(p):
        return jloss(jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=False))

    want_loss, new_stats = jax.jit(batch_stats_loss)(params)
    want_grads = params_from_flax(jax.device_get(jax.jit(jax.grad(fixed_stats_loss))(params)), cfg)
    _, model = _port(kw, from_flax(params, stats, cfg))
    model.train()
    with torch.no_grad():
        loss = float(tloss(model(torch.from_numpy(x))))
    assert abs(loss - float(want_loss)) <= 1e-5 * abs(float(want_loss)), (loss, float(want_loss))
    want_state = from_flax(params, jax.device_get(new_stats), cfg)
    for k, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_state[k].numpy(), rtol=0, atol=1e-5, err_msg=k)

    _, model = _port(kw, from_flax(params, stats, cfg))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.frozen_stats = True
    model.train()
    with mock.patch.object(BatchNorm, "_moments", _running_moments):
        tloss(model(torch.from_numpy(x))).backward()
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for k, p in named.items():
        g, want = p.grad.numpy(), want_grads[k].numpy()
        assert float(np.abs(g - want).max()) <= 1e-4 * float(np.abs(want).max()) + 1e-6, k


@pytest.mark.parametrize("name", ["seg_os8", "cls"])
def test_batch_statistics_gradients_match_flax_in_float64(name):
    """One step's gradients on batch statistics (the training path), both
    graphs in float64, leaf by leaf within 1e-4·max|g_leaf| + 1e-6. The
    segmenter's ASPP takes the grouped conv in both (flax's ``nn.Conv``,
    the port's ``F.conv2d``): the depthwise kernels and their plain
    versions compute in float32."""
    kw = VARIANTS[name]
    if "use_pallas_depthwise" in kw:
        kw = dict(kw, use_pallas_depthwise=False)
    cfg = ModelConfig(**kw)
    jm, params, stats, x = _variables(kw, seed=1)
    if cfg.num_classes:
        x = np.random.default_rng(5).normal(size=(16,) + x.shape[1:]).astype(np.float32)
    jloss, tloss = _losses(cfg, x)
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    p64, s64 = f64(params), f64(stats)
    # the flax modules name their compute dtype jnp.float32: read it as float64
    jnp64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    jnp64.float32 = jnp.float64

    def batch_stats_loss(p):
        logits, _ = jm.apply({"params": p, "batch_stats": s64}, jnp.asarray(x.astype(np.float64)), train=True,
                             mutable=["batch_stats"])
        return jloss(logits)

    with jax.enable_x64(True), mock.patch.object(jxception, "jnp", jnp64), \
            mock.patch.object(jresnet, "jnp", jnp64), mock.patch.object(jlosses, "jnp", jnp64):
        grads = jax.device_get(jax.jit(jax.grad(batch_stats_loss))(p64))
    assert all(a.dtype == np.float64 for a in jax.tree_util.tree_leaves(grads))
    # mapped through float32 (a relative 6e-8, far inside the tolerance)
    want_grads = {k: v.numpy().astype(np.float64) for k, v in params_from_flax(grads, cfg).items()}

    _, model = _port(kw, from_flax(params, stats, cfg))
    model.double().train()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    # one thread: at the default threads, the float64 convolutions' OpenMP
    # loops took 85.9 s on a loaded CPU box (ten busy processes, eight
    # cores) against 0.35 s idle
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
            loss = tloss(model(torch.from_numpy(x).double()))
            assert loss.dtype == torch.float64
            loss.backward()
    finally:
        torch.set_num_threads(threads)
    named = dict(model.named_parameters())
    assert set(named) == set(want_grads)
    for k, p in named.items():
        g, want = p.grad.numpy(), want_grads[k]
        assert g.dtype == np.float64
        assert float(np.abs(g - want).max()) <= 1e-4 * float(np.abs(want).max()) + 1e-6, k


def test_dropout_keeps_half_the_features_at_keep_prob_half():
    """The classifier's pre-logits dropout at ``DEFAULT_KEEP_PROB`` (0.5):
    flax's rule (kept values scaled by 1/keep_prob, the rest 0), drawn from
    the generator of the ``dropout_key`` in force (the module keeps no
    stream), only in training mode; a training draw without a key raises."""
    cfg = ModelConfig(**CLS)
    with torch.device("cpu"):
        model = model_for(cfg)
    assert model.keep_prob == txception.DEFAULT_KEEP_PROB == jxception.DEFAULT_KEEP_PROB == 0.5
    x = torch.ones(64, 4096)
    model.train()
    with dropout_key(11):
        y = model._dropout(x)
        assert not torch.equal(model._dropout(x), y)  # the key's stream moves on
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    model2 = model_for(cfg).train()
    with dropout_key(11):
        assert torch.equal(model2._dropout(x), y)  # same key, same mask
    with dropout_key(12):
        assert not torch.equal(model2._dropout(x), y)
    with pytest.raises(RuntimeError, match="dropout_key"):
        model._dropout(x)
    model.eval()
    assert torch.equal(model._dropout(x), x)


_PLAIN_DROPOUT = txception.Xception41._dropout


def _narrow_classifier():
    return ModelConfig(**dict(CLS, width_multiplier=0.0625, input_shape=(32, 32)))


@pytest.fixture
def one_thread():
    """One intra-op torch thread for the duration: the narrow classifier's
    multithreaded CPU backward crashes in a process that has run XLA:CPU
    (it does not without JAX)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fit_masks(monkeypatch, model_dir, stops, seed=42):
    """``ClassifierTrainer.fit`` of the narrow classifier to each of
    ``stops`` in turn (a resume between them), recording every training
    mask; returns the masks and the last checkpoint."""
    from tensorflowdistributedlearning_tpu_torch.train.fit import ClassifierTrainer

    masks = []

    def recording(self, x):
        y = _PLAIN_DROPOUT(self, x)
        if self.training:
            masks.append(torch.stack([y != 0, x != 0]))
        return y

    monkeypatch.setattr(txception.Xception41, "_dropout", recording)
    tcfg = TrainConfig(optimizer="adam", lr=1e-3, ema_decay=0.9, augmentation="none", checkpoint_every_steps=1,
                       seed=seed, telemetry=False)
    for stop in stops:
        ClassifierTrainer(model_dir, None, _narrow_classifier(), tcfg, device="cpu").fit(batch_size=4, steps=stop)
    state = torch.load(os.path.join(model_dir, "checkpoints", str(stops[-1]), "state.pt"), weights_only=True)
    return masks, state


def test_resumed_fit_continues_the_dropout_stream(monkeypatch, tmp_path, one_thread):
    """C 3: the masks are keyed by (seed, step, rank, chunk), not drawn from
    a stream the module owns, so a 1 + 1-step resumed ``fit`` draws and
    trains what 2 uninterrupted steps do, bit for bit."""
    resumed, end_resumed = _fit_masks(monkeypatch, str(tmp_path / "a"), (1, 2))
    straight, end_straight = _fit_masks(monkeypatch, str(tmp_path / "b"), (2,))
    assert len(resumed) == len(straight) == 2
    assert all(torch.equal(a, b) for a, b in zip(resumed, straight))
    assert not torch.equal(straight[0][0], straight[1][0])  # each step its own mask
    assert end_resumed["step"] == end_straight["step"] == 2
    for part in ("model", "ema"):
        for k, v in end_straight[part].items():
            assert torch.equal(end_resumed[part][k], v), (part, k)


def test_train_config_seed_reaches_the_masks(monkeypatch, tmp_path, one_thread):
    a, _ = _fit_masks(monkeypatch, str(tmp_path / "a"), (1,), seed=1)
    b, _ = _fit_masks(monkeypatch, str(tmp_path / "b"), (1,), seed=2)
    assert not torch.equal(a[0][0], b[0][0])
    assert float(a[0][0].sum()) > 0
    for chunk in range(2):
        assert dropout_seed(1, 0, 0, chunk) != dropout_seed(2, 0, 0, chunk)
    seeds = {dropout_seed(1, step, rank, chunk) for step in range(3) for rank in range(2) for chunk in range(2)}
    assert len(seeds) == 12


def test_meta_build_and_template_state_draw_nothing(monkeypatch):
    """``empty_model`` and ``template_train_state`` build both Xception
    models on ``meta`` and allocate them without an init draw."""
    draws = []
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", lambda *a, **k: draws.append(a))
    for kw in (VARIANTS["seg_os8"], CLS):
        cfg = ModelConfig(**kw)
        with torch.device("meta"):
            meta = model_for(cfg)
        assert all(p.is_meta for p in meta.parameters())
        model = empty_model(cfg, "cpu")
        assert not model.training and all(p.device.type == "cpu" for p in model.parameters())
        assert sum(p.numel() for p in model.parameters()) == sum(p.numel() for p in meta.parameters())
        state = template_train_state(cfg, TrainConfig(), "cpu")
        assert state.step == 0
    assert draws == []


def test_init_draws_the_jax_package_initializers():
    """Depthwise filters truncated normal 0.33, pointwise 0.06, the other
    convs He, BN scale 1 / bias 0, as flax's initializers."""
    from tensorflowdistributedlearning_tpu_torch.models import build_model

    cfg = ModelConfig(**dict(VARIANTS["seg_os8"], width_multiplier=0.25))
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    unit = model.backbone.middle_block1_unit1.separable_conv2
    dw, pw = unit.depthwise.weight, unit.pointwise.weight
    assert abs(float(dw.std()) - 0.33 * 0.8796) < 0.03 and float(dw.abs().max()) <= 0.66 + 1e-6
    assert abs(float(pw.std()) - 0.06 * 0.8796) < 0.005 and float(pw.abs().max()) <= 0.12 + 1e-6
    sc = model.backbone.entry_block2_unit1.shortcut.weight
    assert abs(float(sc.std()) - (2.0 / sc.shape[1]) ** 0.5) < 0.2 * (2.0 / sc.shape[1]) ** 0.5
    assert torch.equal(unit.depthwise_bn.weight, torch.ones_like(unit.depthwise_bn.weight))
    assert dataclasses.replace(cfg).backbone == "xception"
