"""The port's ResNet classifier (``models/resnet.ResNetClassifier``) against
the JAX package's, on the CPU.

Weights come from the JAX model's ``init`` (perturbed, with random BN
statistics so BN is no identity) and cross over through ``from_flax``; the
inputs are made with numpy from a seed. Variants: the ``classic`` ladder
(ResNet-50's layout), the reference's wide layout, basic-block units, and
the space-to-depth stem, each in float32 and bfloat16 compute, at 1/8
width on 32x32x3 inputs. Tolerances, stated where used:

- float32 logits: 1e-5·max(1, max|logit|) (float32 rounding of the same
  graph in two frameworks);
- bf16 logits: within 2e-2·max|logit| of JAX's float32 logits plus JAX's
  own bf16-vs-float32 distance (the two round every op's output to bf16,
  at different places inside each op);
- the space-to-depth stem against the plain 3x3 stride-2 stem on the same
  canonical filter: 1e-5 (one function, another summation order);
- the serving closures of ``resnet50_classic_imagenet``'s model (2 units a
  stage, 1/4 width, 32x32) under the float32 and bfloat16 specs against
  JAX's, with running statistics set to the batch's own and logits of std
  3 (so no softmax saturates): logits, centred per row, within 1e-4 of
  their std under the bfloat16 spec (the same ops, rounded at the same
  places), within 2e-2 plus JAX's own bf16-vs-float32 distance under the
  float32 spec (bf16 compute, as the bf16 logits above).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu import configs as jconfigs
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.models import layers as jlayers
from tensorflowdistributedlearning_tpu.models import resnet as jresnet
from tensorflowdistributedlearning_tpu.train import quantize as jquantize
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, require_supported_training
from tensorflowdistributedlearning_tpu_torch.models import build_model, layers as tlayers, model_for
from tensorflowdistributedlearning_tpu_torch.models import resnet as tresnet
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
from tensorflowdistributedlearning_tpu_torch.train import quantize
from tensorflowdistributedlearning_tpu_torch.train import step as tstep
from tensorflowdistributedlearning_tpu_torch.train import serving
from tensorflowdistributedlearning_tpu_torch.train.serving import export_serving_artifact, load_serving_artifact
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, kernel_leaves
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


BASE = dict(num_classes=10, input_shape=(32, 32), input_channels=3, output_stride=None, width_multiplier=0.125)
VARIANTS = {
    "classic": dict(BASE, n_blocks=(1, 1, 1, 1), block_layout="classic"),
    "wide": dict(BASE, n_blocks=(1, 1, 1)),
    "basic": dict(BASE, n_blocks=(1, 1, 1), block_type="basic_block"),
    "s2d": dict(BASE, n_blocks=(1, 1, 1, 1), block_layout="classic", stem_space_to_depth=True),
}


def _variables(kw, seed=0):
    """JAX classifier, perturbed params, random BN statistics, input batch."""
    jm = jbuild(jconfig.ModelConfig(**kw))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
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
    j16 = jbuild(jconfig.ModelConfig(**kw, dtype="bfloat16"))
    return dict(name=request.param, kw=kw, params=params, stats=stats, x=x,
                want32=np.asarray(jm.apply(v, jnp.asarray(x), train=False)),
                want16=np.asarray(j16.apply(v, jnp.asarray(x), train=False)))


def _port(variant, dtype):
    cfg = ModelConfig(**variant["kw"], dtype=dtype)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(variant["params"], variant["stats"], cfg))
    return cfg, model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_logits_match_jax(variant, dtype):
    _, model = _port(variant, dtype)
    assert isinstance(model, tresnet.ResNetClassifier)
    with torch.inference_mode():
        got = model(torch.from_numpy(variant["x"]))
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    want = variant["want32"]
    assert want.std() > 0.1
    err = float(np.abs(got.numpy() - want).max())
    if dtype == "float32":
        assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err
    else:
        jax_gap = float(np.abs(variant["want16"] - want).max())
        assert err <= 2e-2 * float(np.abs(want).max()) + jax_gap, (err, jax_gap)


def test_state_dict_maps_one_to_one_onto_flax(variant):
    cfg, model = _port(variant, "float32")
    state = from_flax(variant["params"], variant["stats"], cfg)
    assert set(state) == set(model.state_dict())
    assert len(state) == len(flatten_dict(variant["params"])) + len(flatten_dict(variant["stats"]))
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves(variant["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    leaves = kernel_leaves(cfg)
    assert leaves["logits.weight"] == ("logits/kernel", 0)
    assert leaves["backbone.conv1_1.conv.weight"] == ("backbone/conv1_1/conv/kernel", 0)
    # the optimizers' decay and trust-ratio mask covers every flax kernel: the
    # stem (space-to-depth or not), the shortcut convs and the Dense logits
    mask = tstep.kernel_decay_mask(model)
    assert {n for n, m in mask.items() if m} == set(leaves)
    assert sum(1 for k in flatten_dict(variant["params"]) if k[-1] == "kernel") == len(leaves)


def test_space_to_depth_stem_is_the_plain_stem():
    """One canonical filter, two computations: the stem conv as a 2x2 conv
    on the space-to-depth input equals the 3x3 stride-2 SAME conv, in both
    packages."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 12, 3)).astype(np.float32)
    kernel = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
    jout = np.asarray(jlayers.SpaceToDepthConv(8).apply({"params": {"kernel": kernel}}, jnp.asarray(x)))
    jplain = np.asarray(jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(kernel), (2, 2), "SAME",
                                                     dimension_numbers=("NHWC", "HWIO", "NHWC")))
    np.testing.assert_allclose(jout, jplain, atol=1e-5)
    conv = tlayers.SpaceToDepthConv(3, 8)
    plain = tlayers.Conv2dSame(3, 8, 3, stride=2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        plain.weight.copy_(conv.weight)
        got = conv(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), plain(torch.from_numpy(x)).numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jout, atol=1e-5)
    np.testing.assert_allclose(tlayers.space_to_depth(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.space_to_depth(jnp.asarray(x))), rtol=0, atol=0)


def test_space_to_depth_model_equals_the_plain_stem_model():
    cfg = ModelConfig(**VARIANTS["s2d"])
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(4))
    plain = build_model(dataclasses.replace(cfg, stem_space_to_depth=False), "cpu")
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_allclose(model(x).numpy(), plain(x).numpy(), atol=1e-5)


def test_odd_sides_raise_as_in_jax():
    with pytest.raises(ValueError, match="even input dims"):
        jconfig.ModelConfig(**dict(VARIANTS["s2d"], input_shape=(33, 32)))
    with pytest.raises(ValueError, match="even input dims"):
        ModelConfig(**dict(VARIANTS["s2d"], input_shape=(33, 32)))
    with pytest.raises(ValueError, match="divisible by 2"):
        jlayers.space_to_depth(jnp.zeros((1, 5, 4, 3)))
    with pytest.raises(ValueError, match="divisible by 2"):
        tlayers.space_to_depth(torch.zeros(1, 5, 4, 3))
    with pytest.raises(ValueError, match="3x3 stride-2 rate-1"):
        tlayers.ConvBN(3, 8, 1, stride=2, space_to_depth=True)


def test_classic_block_specs_match_jax():
    for n in ((3, 4, 6, 3), (1, 1, 1, 1)):
        for wm in (1.0, 0.125):
            ours = tresnet.classic_block_specs(n, wm)
            theirs = jresnet.classic_block_specs(n, wm)
            assert [(b.name, [dataclasses.asdict(u) for u in b.units]) for b in ours] == [
                (b.name, [dataclasses.asdict(u) for u in b.units]) for b in theirs]
    with pytest.raises(ValueError, match="length 4"):
        tresnet.classic_block_specs((3, 4, 6))


@pytest.mark.parametrize("preset, n_params", [("resnet50_classic_imagenet", (25_500_000, 25_800_000)),
                                              ("resnet50_imagenet", None), ("cifar10_smoke", None)])
def test_full_preset_matches_jax_parameter_count(preset, n_params):
    """The presets' full trees, shapes from ``jax.eval_shape`` and the port's
    template on the meta device; ResNet-50 (classic) is the 25.6M-parameter
    model (25 688 488 with the v2 pre-activation BNs)."""
    jcfg, tcfg = jconfigs.get_preset(preset).model, tconfigs.get_preset(preset).model
    h, w = tcfg.input_shape
    shapes = jax.eval_shape(lambda a: jbuild(jcfg).init(jax.random.key(0), a, train=False),
                            jax.ShapeDtypeStruct((1, h, w, tcfg.input_channels), jnp.float32))
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        template = model_for(tcfg)
    assert sum(p.numel() for p in template.parameters()) == n_jax
    if n_params is not None:
        assert n_params[0] < n_jax < n_params[1]
    flat = {"/".join(k): np.broadcast_to(np.float32(0), v.shape) for k, v in flatten_dict(shapes["params"]).items()}
    stats = {"/".join(k): np.broadcast_to(np.float32(0), v.shape)
             for k, v in flatten_dict(shapes["batch_stats"]).items()}
    assert set(from_flax(flat, stats, tcfg)) == set(template.state_dict())
    require_supported_training(tcfg, tconfigs.get_preset(preset).train)


def test_init_follows_flax_initializers():
    """He (fan_in, truncated normal) for the Dense logits and the
    space-to-depth stem's canonical filter, as JAX's ``conv_kernel_init``."""
    cfg = ModelConfig(**dict(VARIANTS["s2d"], width_multiplier=0.5))
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    for w, fan_in in ((model.logits.weight, model.logits.weight.shape[1]), (model.backbone.conv1_1.conv.weight, 27)):
        std = (2.0 / fan_in) ** 0.5
        assert abs(w.std().item() - std) < 0.25 * std
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert not model.logits.bias.any()


@pytest.mark.parametrize("name", ["classic", "s2d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classifier_serves_through_the_engine(name, dtype, tmp_path):
    """A bf16-compute classifier exported and served under the float32 and
    bfloat16 specs (``{"probabilities", "class"}``); its int8-compute
    artifact serves through the engine too, ``logits`` an int8 Dense, the
    engine's answers those of the loaded closure (its parity with JAX's
    closure: ``test_classifier_serving_spec_matches_jax``)."""
    cfg = ModelConfig(**VARIANTS[name], dtype="bfloat16")
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(5))
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.inference_mode():
        direct = tstep.ClassificationTask().predictions(model(torch.from_numpy(x)))["probabilities"].numpy()
    manifest = export_serving_artifact(model, cfg, str(tmp_path / dtype), serving_dtype=dtype)
    engine = InferenceEngine.from_artifact(os.path.dirname(manifest), device="cpu", buckets=(1, 4))
    out = engine.infer(x)
    assert out["probabilities"].shape == (2, 10) and out["class"].dtype == np.int32
    np.testing.assert_array_equal(out["class"], out["probabilities"].argmax(-1))
    tol = 1e-6 if dtype == "float32" else 2e-2
    assert np.abs(out["probabilities"] - direct).max() <= tol
    serve = load_serving_artifact(os.path.dirname(manifest), device="cpu")
    np.testing.assert_allclose(serve(x)["probabilities"].numpy(), out["probabilities"], atol=1e-6)
    qdir = str(tmp_path / f"{dtype}-int8-compute")
    export_serving_artifact(model, cfg, qdir, serving_dtype="int8-compute")
    qengine = InferenceEngine.from_artifact(qdir, device="cpu", buckets=(1, 4))
    qserve = load_serving_artifact(qdir, device="cpu")
    assert type(serving.load_model(qdir, "cpu").logits).__name__ == "QuantLinear"
    qout = qengine.infer(x)
    np.testing.assert_allclose(qout["probabilities"], qserve(x)["probabilities"].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(qout["class"], qserve(x)["class"].numpy())


def _logit_gap(p: np.ndarray, q: np.ndarray) -> float:
    """Two softmaxes compared as their logits: ``log p - log q`` centred per
    row, its largest magnitude over the std of ``log q``."""
    logq = np.log(q.astype(np.float64))
    d = np.log(p.astype(np.float64)) - logq
    d -= d.mean(axis=-1, keepdims=True)
    return float(np.abs(d).max() / logq.std())


@pytest.fixture(scope="module")
def served_resnet50():
    """``resnet50_classic_imagenet``'s model at 2 units a stage, 1/4 width,
    32x32: running statistics set to the batch statistics of 32 images (one
    training-mode forward, the 0.99 decay inverted) and the logits Dense
    scaled to logits of std 3."""
    shape = dict(n_blocks=(2, 2, 2, 2), width_multiplier=0.25, input_shape=(32, 32))
    jcfg = dataclasses.replace(jconfigs.get_preset("resnet50_classic_imagenet").model, **shape)
    tcfg = dataclasses.replace(tconfigs.get_preset("resnet50_classic_imagenet").model, **shape)
    jm = jbuild(jcfg)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    v = jax.device_get(jm.init(jax.random.key(3), jnp.asarray(x), train=False))
    calib = jnp.asarray(rng.normal(size=(32, 32, 32, 3)).astype(np.float32))
    _, moved = jm.apply(v, calib, train=True, mutable=["batch_stats"])
    stats = jax.tree_util.tree_map(lambda new, old: ((np.asarray(new) - 0.99 * old) / 0.01).astype(np.float32),
                                   jax.device_get(moved["batch_stats"]), v["batch_stats"])
    params = v["params"]
    logits = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False))
    params["logits"]["kernel"] = params["logits"]["kernel"] * np.float32(3.0 / logits.std())
    return dict(jm=jm, params=params, stats=stats, x=x, cfg=tcfg, state=from_flax(params, stats, tcfg))


def _jax_served(pair, spec):
    qp, qs, _ = jquantize.quantize_state(pair["params"], pair["stats"], spec)
    act = jquantize.compute_dtype(spec)
    variables = {"params": jquantize.dequantize_pytree(qp, act), "batch_stats": jquantize.dequantize_pytree(qs, act)}
    logits = pair["jm"].apply(variables, jnp.asarray(pair["x"]).astype(act), train=False)
    return np.asarray(jax.nn.softmax(logits.astype(jnp.float32)))


def _port_served(pair, spec):
    qstate, section = quantize.quantize_state(pair["state"], spec, pair["cfg"])
    model = serving.serving_model(pair["cfg"], qstate, section, "cpu")
    serve = serving.make_serving_fn(model, "cpu", act_dtype=quantize.compute_dtype(spec))
    return serve(pair["x"])["probabilities"].float().numpy()


@pytest.mark.parametrize("spec", ["float32", "bfloat16"])
def test_classifier_serving_spec_matches_jax(served_resnet50, spec):
    """JAX's bfloat16 spec lies 1.13 of the logits' std from its float32
    spec here (bf16 BN statistics, BN in bf16 arithmetic), so a served
    bf16 ResNet is far from float32 by the spec's own semantics. The port
    serves the bfloat16 spec as JAX does, within 1e-4 of the logits' std
    (5.3e-7 read; the same ops rounded at the same places). Under the
    float32 spec the model computes in bf16 with float32 BN, which the
    port folds and JAX does not: a float32 ulp can move a bf16 rounding,
    and depth amplifies it (0.040 read), so it is held within 2e-2 plus
    JAX's own distance between its bf16- and float32-compute models
    (0.68 read)."""
    want = _jax_served(served_resnet50, spec)
    got = _port_served(served_resnet50, spec)
    assert want.max(-1).mean() < 0.9  # no saturated softmax
    gap = _logit_gap(got, want)
    if spec == "bfloat16":
        assert gap <= 1e-4, gap
    else:
        j32 = jbuild(dataclasses.replace(served_resnet50["jm"].config, dtype="float32"))
        variables = {"params": served_resnet50["params"], "batch_stats": served_resnet50["stats"]}
        truth = np.asarray(jax.nn.softmax(j32.apply(variables, jnp.asarray(served_resnet50["x"]), train=False)))
        jax_gap = _logit_gap(want, truth)
        assert gap <= 2e-2 + jax_gap, (gap, jax_gap)


def test_int8_storage_serves_the_classifier(tmp_path):
    cfg = ModelConfig(**VARIANTS["classic"])
    model = build_model(cfg, "cpu")
    manifest = export_serving_artifact(model, cfg, str(tmp_path / "q"), serving_dtype="int8")
    out = load_serving_artifact(os.path.dirname(manifest), device="cpu")(np.zeros((2, 32, 32, 3), np.float32))
    assert out["probabilities"].shape == (2, 10) and bool(torch.isfinite(out["probabilities"]).all())


def test_bf16_segmenter_int8_compute_is_refused():
    """No longer refused: the bf16-compute segmenter's int8-compute closure
    against JAX's (``int8_conv2d`` interpreted), probabilities within the
    max 1e-4 and mean 1e-5 (``tests/test_torch_int8_models.py`` holds it
    layer by layer)."""
    import functools

    from tensorflowdistributedlearning_tpu.ops import quant_kernels as jqk
    from tensorflowdistributedlearning_tpu.train.step import SegmentationTask

    kw = dict(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=16, input_shape=(33, 33), dtype="bfloat16")
    jm = jbuild(jconfig.ModelConfig(**kw))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 33, 33, 2)).astype(np.float32)
    v = jax.device_get(jax.jit(lambda a: jm.init(jax.random.key(0), a, train=False))(jnp.asarray(x)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
                                    v["params"])
    stats = unflatten_dict({
        k: (rng.uniform(0.5, 1.5, a.shape) if k[-1] == "var" else rng.normal(0, 0.2, a.shape)).astype(np.float32)
        for k, a in flatten_dict(v["batch_stats"]).items()
    })
    qp, qs, _ = jquantize.quantize_state(params, stats, "int8-compute")
    act = jquantize.compute_dtype("int8-compute")
    variables = {"params": jquantize.dequantize_pytree(qp, act), "batch_stats": jquantize.dequantize_pytree(qs, act)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqk, "int8_conv2d", functools.partial(jqk.int8_conv2d, interpret=True))
        with jqk.int8_intercept(qp, act):
            logits = jm.apply(variables, jnp.asarray(x).astype(act), train=False)
    want = np.asarray(jquantize.cast_outputs_float32(SegmentationTask().serve_predictions(logits))["probabilities"])
    cfg = ModelConfig(**kw, use_pallas_depthwise=True)
    qstate, section = quantize.quantize_state(from_flax(params, stats, cfg), "int8-compute", cfg)
    model = serving.serving_model(cfg, qstate, section, "cpu")
    got = serving.make_serving_fn(model, "cpu", act_dtype=quantize.compute_dtype("int8-compute"))(x)["probabilities"].numpy()
    d = np.abs(got - want)
    assert d.max() <= 1e-4 and d.mean() <= 1e-5, (d.max(), d.mean())
    assert want.std() > 0.02
