"""``int8-compute`` serving of the ResNet classifier, the bf16-compute ResNet
segmenter and both Xception-41 models, the port against the JAX package,
on the CPU.

The oracle is JAX's serving closure under ``int8_intercept``, run op by op
(not under ``jax.jit``, whose excess precision may keep bf16 intermediates
in float32), with ``int8_conv2d`` and ``int8_matmul`` run as the
interpreted Pallas kernels (the real integer bodies), as
``tests/test_torch_quant_serve.py`` runs the segmenter. One JAX forward per
model records every routed layer's input and output and every module's
output dtype. Models, each at a narrow size with perturbed weights:

- ``resnet50_classic_imagenet``'s model with and without the space-to-depth
  stem, and ``xception41_imagenet``'s: 1/8 width, one unit a stage (the
  ResNet), 32x32x3, 10 classes; running statistics calibrated to the batch
  statistics of 32 images and the logits Dense scaled to logits of std 3,
  so no softmax saturates;
- ``tgs_salt_bf16``'s model and the Xception-41 segmenter: 1/8 width,
  33x33x2, random running statistics.

What each model is held to:

(a) the port swaps exactly the layers JAX's interceptor routes, ``logits``
    (``QuantLinear``) included, and leaves the rest: strided convs and
    shortcuts, Xception's grouped depthwise convs, the space-to-depth stem;
(b) each routed layer, fed its JAX input, within 1 bf16 ulp of the
    interpreted JAX kernel, through the port's plain int8 arm (the swapped
    module on a CPU tensor);
(c) every module's output dtype is flax's;
(d) served outputs: the segmenters' probabilities within the bounds of
    ``tests/test_torch_quant_serve.py``'s int8-compute segmenter,
    max 1e-4 and mean 1e-5 (read: 5.4e-7 / 2.0e-8 for the Xception
    segmenter, 1.2e-7 / 5.2e-9 for the bf16 ResNet segmenter once the port
    resizes bf16 as JAX does); the classifiers' softmaxes
    compared as logits (``log p`` centred per row) within 1e-4 of the
    logits' std, the bfloat16 spec's bound in
    ``test_torch_resnet_classifier.py`` (read: 0.0, the same bits; JAX's own
    bfloat16 spec lies 0.42-0.88 of the std away, so the bound sees the
    int8 path). No one-ulp witness was needed.

Then the full-depth layer counts the card's smoke asserts, JAX's counted
with ``jax.eval_shape`` (no compute), and the engine and command-line round
trips of an ``int8-compute`` artifact on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn
from flax.traverse_util import flatten_dict, unflatten_dict

import chip_smoke
from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu import configs as jconfigs
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.ops import quant_kernels as jqk
from tensorflowdistributedlearning_tpu.train import quantize as jq
from tensorflowdistributedlearning_tpu.train.step import ClassificationTask as JCls
from tensorflowdistributedlearning_tpu.train.step import SegmentationTask as JSeg
from tensorflowdistributedlearning_tpu_torch import __main__ as cli
from tensorflowdistributedlearning_tpu_torch import configs as tconfigs
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.models import build_model, model_for
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk
from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
from tensorflowdistributedlearning_tpu_torch.train import quantize as tq
from tensorflowdistributedlearning_tpu_torch.train import serving
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, kernel_leaves
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_quant_kernels import jax_int8_eligible, ulps
from tests.test_torch_serve_health import _post, _spawn

SPEC = "int8-compute"
TOL_PROB_MAX, TOL_PROB_MEAN = 1e-4, 1e-5
TOL_LOGIT_GAP = 1e-4

CLS = dict(num_classes=10, input_shape=(32, 32), input_channels=3, output_stride=None, dtype="bfloat16",
           width_multiplier=0.125)
FAMILIES = {
    "resnet50_classic": dict(CLS, n_blocks=(1, 1, 1, 1), block_layout="classic"),
    "resnet50_classic_s2d": dict(CLS, n_blocks=(1, 1, 1, 1), block_layout="classic", stem_space_to_depth=True),
    "tgs_salt_bf16": dict(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=16, input_shape=(33, 33),
                          dtype="bfloat16"),
    "xception41_segmenter": dict(backbone="xception", width_multiplier=0.125, input_shape=(33, 33)),
    "xception41_imagenet": dict(CLS, backbone="xception"),
}

# full-depth presets and the model the card's smoke serves for each
FULL_DEPTH = {
    "resnet50_classic_imagenet": tconfigs.get_preset("resnet50_classic_imagenet").model,
    "tgs_salt_bf16": tconfigs.get_preset("tgs_salt_bf16").model,
    "xception41_imagenet": tconfigs.get_preset("xception41_imagenet").model,
    "xception41_segmenter": ModelConfig(backbone="xception", output_stride=8, use_pallas_depthwise=True),
}


def _routed(mod) -> bool:
    """``make_int8_interceptor``'s rule: an eligible ``nn.Conv`` or any
    ``nn.Dense`` (every kernel leaf holds a record under int8-compute)."""
    return isinstance(mod, jnn.Dense) or jax_int8_eligible(mod)


def _calibrated_stats(jm, params, stats, x, rng):
    """Running statistics set to the batch statistics of 32 images (one
    training-mode forward, the 0.99 decay inverted)."""
    h, w, c = x.shape[1:]
    calib = jnp.asarray(rng.normal(size=(32, h, w, c)).astype(np.float32))
    fwd = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"],
                                        rngs={"dropout": jax.random.key(1)})[1])
    moved = jax.device_get(fwd({"params": params, "batch_stats": stats}, calib))
    return jax.tree_util.tree_map(lambda new, old: ((np.asarray(new) - 0.99 * old) / 0.01).astype(np.float32),
                                  moved["batch_stats"], stats)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """The JAX model with perturbed weights, its int8-compute closure run
    once (routed layers' inputs and outputs, module output dtypes, served
    outputs), and the port's served model on the same weights."""
    kw = FAMILIES[request.param]
    jm = jbuild(jconfig.ModelConfig(**kw))
    rng = np.random.default_rng(0)
    h, w = kw["input_shape"]
    x = rng.normal(size=(2, h, w, kw.get("input_channels", 2))).astype(np.float32)
    v = jax.device_get(jax.jit(lambda a: jm.init(jax.random.key(0), a, train=False))(jnp.asarray(x)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
                                    v["params"])
    classifier = kw.get("num_classes") is not None
    if classifier:
        stats = _calibrated_stats(jm, params, v["batch_stats"], x, rng)
        logits = np.asarray(jax.jit(lambda a: jm.apply({"params": params, "batch_stats": stats}, a,
                                                        train=False))(jnp.asarray(x)))
        params["logits"]["kernel"] = params["logits"]["kernel"] * np.float32(3.0 / logits.std())
    else:
        stats = unflatten_dict({
            k: (rng.uniform(0.5, 1.5, a.shape) if k[-1] == "var" else rng.normal(0, 0.2, a.shape)).astype(
                np.float32)
            for k, a in flatten_dict(v["batch_stats"]).items()
        })

    routed = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        mod = context.module
        if context.method_name == "__call__" and args and _routed(mod):
            routed.append((".".join(mod.path), args[0], out))
        return out

    qp, qs, _ = jq.quantize_state(params, stats, SPEC)
    act = jq.compute_dtype(SPEC)
    variables = {"params": jq.dequantize_pytree(qp, act), "batch_stats": jq.dequantize_pytree(qs, act)}
    with contextlib.ExitStack() as stack:
        stack.enter_context(pytest.MonkeyPatch.context()).setattr(
            jqk, "int8_conv2d", functools.partial(jqk.int8_conv2d, interpret=True))
        stack.enter_context(pytest.MonkeyPatch.context()).setattr(
            jqk, "int8_matmul", functools.partial(jqk.int8_matmul, interpret=True))
        stack.enter_context(jnn.intercept_methods(capture))  # entered first: flax calls it before the int8 one
        stack.enter_context(jqk.int8_intercept(qp, act))
        logits, inter = jm.apply(variables, jnp.asarray(x).astype(act), train=False, capture_intermediates=True)
    task = JCls() if classifier else JSeg()
    want = {k: np.asarray(a) for k, a in jq.cast_outputs_float32(task.serve_predictions(logits)).items()}
    jax_dtypes = {}
    for path, val in flatten_dict(inter["intermediates"]).items():
        out = val[0]
        leaves = out if isinstance(out, tuple) else (out,)
        if path[:-1] and all(hasattr(a, "dtype") for a in leaves):
            jax_dtypes[".".join(path[:-1])] = tuple(str(a.dtype) for a in leaves)

    cfg = ModelConfig(**kw, use_pallas_depthwise=True)
    qstate, section = tq.quantize_state(from_flax(params, stats, cfg), SPEC, cfg)
    model = serving.serving_model(cfg, qstate, section, "cpu")
    return dict(name=request.param, kw=kw, cfg=cfg, x=x, classifier=classifier, routed=routed, want=want,
                jax_logits=np.asarray(jnp.asarray(logits, jnp.float32)), jax_dtypes=jax_dtypes, model=model)


def _logit_gap(p: np.ndarray, q: np.ndarray) -> float:
    """Two softmaxes compared as their logits: ``log p - log q`` centred per
    row, its largest magnitude over the std of ``log q``."""
    logq = np.log(q.astype(np.float64))
    d = np.log(p.astype(np.float64)) - logq
    d -= d.mean(axis=-1, keepdims=True)
    return float(np.abs(d).max() / logq.std())


def test_swapped_layers_are_the_interceptors(family):
    """(a) The port's ``QuantConv2d`` / ``QuantLinear`` layers are the
    layers JAX's interceptor routes, each once."""
    quant = {n: type(m) for n, m in family["model"].named_modules() if isinstance(m, (qk.QuantConv2d, qk.QuantLinear))}
    names = [name for name, _, _ in family["routed"]]
    assert len(names) == len(set(names)) == len(quant)
    assert set(names) == set(quant)
    if family["classifier"]:
        assert quant["logits"] is qk.QuantLinear
    else:
        assert qk.QuantLinear not in quant.values()
    for n, m in family["model"].named_modules():
        if n.endswith("depthwise"):  # grouped: dequantized float path, as in JAX
            assert not isinstance(m, qk.QuantConv2d), n
    if family["kw"].get("stem_space_to_depth"):
        assert not any(n.startswith("backbone.conv1_1") for n in quant)


def test_each_routed_layer_within_one_bf16_ulp(family):
    """(b) Each routed layer's JAX input through the port's swapped module
    (the plain int8 arm on a CPU tensor): 1 bf16 ulp of the interpreted
    JAX kernel's output."""
    modules = dict(family["model"].named_modules())
    for name, xj, want in family["routed"]:
        xt = torch.from_numpy(np.asarray(jnp.asarray(xj, jnp.float32))).to(
            torch.bfloat16 if xj.dtype == jnp.bfloat16 else torch.float32)
        with torch.inference_mode():
            got = modules[name](xt)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, name
        assert ulps(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), "bfloat16") <= 1, name


def test_dtype_flow_matches_flax(family):
    """(c) Every module's output dtype, flax's captured intermediates
    against the port's forward hooks: bf16 out of each int8 layer, into
    layers that compute in the model's dtype (the port's BatchNorm module
    ends in its activation; flax's does not, and both keep the dtype)."""
    model = family["model"]
    port_dtypes = {}

    def record(name, out):
        leaves = out if isinstance(out, tuple) else (out,)
        if all(torch.is_tensor(a) for a in leaves):
            port_dtypes[name] = tuple(str(a.dtype).replace("torch.", "") for a in leaves)

    handles = [m.register_forward_hook(lambda mod, a, out, name=n: record(name, out))
               for n, m in model.named_modules() if n]
    try:
        with torch.inference_mode():
            model(torch.from_numpy(family["x"]).to(torch.bfloat16))
    finally:
        for h in handles:
            h.remove()
    jax_dtypes = family["jax_dtypes"]
    common = sorted(set(jax_dtypes) & set(port_dtypes))
    assert len(common) >= 0.9 * len(jax_dtypes), sorted(set(jax_dtypes) - set(port_dtypes))
    assert {n: jax_dtypes[n] for n in common} == {n: port_dtypes[n] for n in common}
    for name, _, _ in family["routed"]:
        assert port_dtypes[name] == ("bfloat16",), name
    if family["classifier"]:
        assert port_dtypes["logits"] == ("bfloat16",)


def test_served_outputs_match_jax(family):
    """(d) The served answers: segmenter probabilities within max 1e-4 and
    mean 1e-5, classifier logits (from the softmax) within 1e-4 of their
    std; masks and classes equal where the probabilities are clear of the
    decision."""
    serve = serving.make_serving_fn(family["model"], "cpu", act_dtype=tq.compute_dtype(SPEC))
    got = {k: v.numpy() for k, v in serve(family["x"]).items()}
    want = family["want"]
    assert got["probabilities"].dtype == np.float32
    assert got["probabilities"].shape == want["probabilities"].shape
    if family["classifier"]:
        assert want["probabilities"].max(-1).mean() < 0.9  # no saturated softmax
        gap = _logit_gap(got["probabilities"], want["probabilities"])
        assert gap <= TOL_LOGIT_GAP, gap
        np.testing.assert_array_equal(got["class"], want["class"])
    else:
        d = np.abs(got["probabilities"] - want["probabilities"])
        assert d.max() <= TOL_PROB_MAX and d.mean() <= TOL_PROB_MEAN, (d.max(), d.mean())
        assert want["probabilities"].std() > 0.02
        away = np.abs(want["probabilities"] - 0.5) > TOL_PROB_MAX
        np.testing.assert_array_equal(got["mask"][away], want["mask"][away])


@pytest.mark.parametrize("shape,out_hw", [((2, 5, 5, 16), (9, 9)), ((2, 13, 13, 4), (101, 101)),
                                          ((2, 1, 1, 8), (3, 3)), ((1, 7, 9, 3), (26, 33)),
                                          ((1, 9, 7, 3), (33, 26)), ((1, 4, 12, 2), (13, 17))])
def test_bf16_upsample_is_jaxs_bit_for_bit(shape, out_hw):
    """A bf16 tensor upsampled as JAX's ``models.layers.upsample`` resizes
    it (bf16 weights, rows then columns, each sum rounded to bf16): the
    same bits. The bf16 segmenter's decoder input depends on it (with the
    float32 resize the port had, 146 of its 2400 elements differed here)."""
    from tensorflowdistributedlearning_tpu.models.layers import upsample as jupsample
    from tensorflowdistributedlearning_tpu_torch.models.layers import upsample

    xb = jnp.asarray(np.random.default_rng(1).normal(size=shape).astype(np.float32) * 10, jnp.bfloat16)
    want = np.asarray(jupsample(xb, out_hw).astype(jnp.float32))
    got = upsample(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16), out_hw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def _jax_routed_count(cfg: ModelConfig) -> int:
    """Layers JAX's interceptor routes in the full-depth model, counted at
    trace time under ``jax.eval_shape`` (nothing computed)."""
    jcfg = jconfig.ModelConfig(**{k: tuple(a) if isinstance(a, list) else a
                                  for k, a in json.loads(cfg.to_json()).items()})
    jm = jbuild(jcfg)
    h, w = jcfg.input_shape
    x = jax.ShapeDtypeStruct((1, h, w, jcfg.input_channels), jnp.float32)
    variables = jax.eval_shape(lambda a: jm.init(jax.random.key(0), a, train=False), x)
    count = [0]

    def intercept(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and _routed(context.module):
            count[0] += 1
        return next_fun(*args, **kwargs)

    with jnn.intercept_methods(intercept):
        jax.eval_shape(lambda v, a: jm.apply(v, a, train=False), variables, x)
    return count[0]


@pytest.mark.parametrize("preset", sorted(FULL_DEPTH))
def test_full_depth_counts_equal_jax_and_the_smoke(preset):
    """The full-depth model's int8 layers: the port's rule
    (``quant_kernels.int8_targets`` over every kernel leaf, on the meta
    device) equals JAX's interceptor count, and both equal what
    ``chip_smoke.INT8_LAYERS`` asserts on the card."""
    cfg = FULL_DEPTH[preset]
    with torch.device("meta"):
        model = model_for(cfg)
    targets = qk.int8_targets(model, kernel_leaves(cfg))
    n_linear = sum(isinstance(child, torch.nn.Linear) for _, _, child in targets.values())
    assert (len(targets) - n_linear, n_linear) == chip_smoke.INT8_LAYERS[preset]
    assert len(targets) == _jax_routed_count(cfg)


def test_int8_compute_refuses_no_preset():
    """Every preset's model quantizes and loads under ``int8-compute`` (the
    tensors on the meta device: nothing computed but the records' shapes)."""
    for name in sorted(tconfigs.PRESETS):
        cfg = tconfigs.get_preset(name).model
        if cfg.backbone == "vit" or name in FULL_DEPTH:
            continue
        with torch.device("meta"):
            model = model_for(cfg)
        n = len(qk.int8_targets(model, kernel_leaves(cfg)))
        assert n > 0, name
    small = dataclasses.replace(FULL_DEPTH["resnet50_classic_imagenet"], n_blocks=(1, 1, 1, 1),
                                width_multiplier=0.0625, input_shape=(32, 32))
    model = build_model(small, "cpu", generator=torch.Generator().manual_seed(0))
    qstate, section = tq.quantize_state(model.state_dict(), SPEC, small)
    assert section["compute_dtype"] == "int8"
    served = serving.serving_model(small, qstate, section, "cpu")
    assert isinstance(served.logits, qk.QuantLinear)


@pytest.mark.parametrize("name", ["resnet50_classic_s2d", "xception41_imagenet"])
def test_engine_serves_the_int8_artifact(name, tmp_path):
    """export -> engine: buckets pad with zero rows (the same activation
    scales), the answers equal the loaded closure's, no CPU launch."""
    cfg = ModelConfig(**FAMILIES[name])
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(3))
    manifest = serving.export_serving_artifact(model, cfg, str(tmp_path / "a"), serving_dtype=SPEC)
    art = os.path.dirname(manifest)
    assert serving.serving_spec(serving.read_manifest(art)) == SPEC
    engine = InferenceEngine.from_artifact(art, device="cpu", buckets=(1, 4))
    engine.warmup()
    x = np.random.default_rng(3).normal(size=(3, 32, 32, 3)).astype(np.float32)
    out = engine.infer(x)
    direct = serving.load_serving_artifact(art, "cpu")(x)
    np.testing.assert_allclose(out["probabilities"], direct["probabilities"].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out["class"], direct["class"].numpy())
    tk.reset_launch_counts()
    engine.infer(x[:1])
    assert sum(tk.launch_counts().values()) == 0


def _write_vars(params, stats, path):
    flat = {f"params/{'/'.join(k)}": a for k, a in flatten_dict(params).items()}
    flat.update({f"batch_stats/{'/'.join(k)}": a for k, a in flatten_dict(stats).items()})
    np.savez(path, **flat)


def test_cli_convert_then_serve_int8_compute(tmp_path, capsys):
    """``convert --serving-dtype int8-compute`` of the bf16 ResNet
    segmenter's flax weights, then ``serve`` on the CPU answers a request
    with what the loaded artifact computes."""
    kw = FAMILIES["tgs_salt_bf16"]
    jm = jbuild(jconfig.ModelConfig(**kw))
    v = jax.device_get(jax.jit(lambda a: jm.init(jax.random.key(4), a, train=False))(jnp.zeros((1, 33, 33, 2))))
    _write_vars(v["params"], v["batch_stats"], tmp_path / "vars.npz")
    cfg = ModelConfig(**kw)
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    art = str(tmp_path / "art")
    assert cli.main(["convert", "--params", str(tmp_path / "vars.npz"), "--config", str(tmp_path / "cfg.json"),
                     "--out", art, "--serving-dtype", SPEC]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["serving_dtype"] == SPEC
    m = serving.read_manifest(art)
    assert serving.serving_spec(m) == SPEC and m["quantization"]["compute_dtype"] == "int8"
    x = np.random.default_rng(4).normal(size=(2, 33, 33, 2)).astype(np.float32)
    proc = _spawn(["--artifact-dir", art, "--workdir", str(tmp_path / "w"), "--buckets", "1", "2"], str(tmp_path))
    try:
        ready = json.loads(proc.stdout.readline())
        status, answer = _post(ready["serving"] + "/v1/predict", {"instances": x.tolist()})
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert status == 200 and answer["n"] == 2
    want = serving.load_serving_artifact(art, "cpu")(x)
    np.testing.assert_allclose(np.asarray(answer["predictions"]["probabilities"], np.float32),
                               want["probabilities"].numpy(), atol=1e-6, rtol=0)


def test_cli_fit_exports_int8_compute(tmp_path, capsys, monkeypatch):
    """``fit --export-serving --serving-dtype int8-compute`` of a narrow
    ``xception41_imagenet`` writes an artifact that serves through the
    engine."""
    preset = tconfigs.get_preset("xception41_imagenet")
    tiny = dataclasses.replace(preset, model=dataclasses.replace(preset.model, width_multiplier=0.0625,
                                                                 input_shape=(32, 32), num_classes=10),
                               global_batch=8)
    monkeypatch.setitem(tconfigs.PRESETS, "xception41_tiny", tiny)
    rc = cli.main(["fit", "--preset", "xception41_tiny", "--model-dir", str(tmp_path / "m"), "--steps", "2",
                   "--batch-size", "8", "--device", "cpu", "--export-serving", "--serving-dtype", SPEC])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    art = out["serving_artifact"]
    assert art.endswith("serving-int8-compute")
    assert serving.serving_spec(serving.read_manifest(art)) == SPEC
    engine = InferenceEngine.from_artifact(art, device="cpu", buckets=(1, 2))
    res = engine.infer(np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32))
    assert res["probabilities"].shape == (2, 10) and np.isfinite(res["probabilities"]).all()
