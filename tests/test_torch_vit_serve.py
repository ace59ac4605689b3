"""Serving the ViT classifier in the port against the JAX package, on the
CPU: quantization of the ViT state, the manifest, every serving spec's
closure, the engine, and ``convert`` followed by ``serve`` over HTTP.

The model is the tiny ViT of ``tests/test_torch_vit.py`` (32x32x3, patch 8,
embed 32, 2 heads, 2 layers, 10 classes), with the preset's flags
(``use_fused_attention``) in bfloat16 and in float32 compute. The JAX
closures are built as ``ClassifierTrainer.serving_fn`` builds them
(``train/fit.py:1046-1065``: ``quantize_state``, ``dequantize_pytree`` to
the spec's activation dtype, the forward, under ``int8_intercept`` for
``int8-compute``, then ``serve_predictions`` and ``cast_outputs_float32``),
run op by op, with the fused attention path forced open and ``int8_matmul``
run as the interpreted kernel (its real integer body). Tolerances on the
served probabilities (max |d| / mean |d|):

- float32 compute under ``float32``, ``bfloat16``, ``int8``: 1e-6 / -
  (measured 1.2e-7; the specs differ only in the stored weights);
- bfloat16 compute under the same specs: 3e-3 / 5e-4 (measured 8.2e-4 /
  1.3e-4 at probabilities up to 0.31): bf16 activations round at other
  places inside each op in the two frameworks (see test_torch_vit.py);
- ``int8-compute`` (logits and probabilities in bf16): 8e-3 / 1.5e-3
  (measured 3.9e-3 / 5.4e-4, two bf16 steps at 0.3): an ulp of difference
  in a Dense input can move its per-tensor quantization by one step. Given
  JAX's own input, each of the 9 ``int8_matmul`` calls is bit-identical.

``class`` equals JAX's on every row whose top two probabilities lie
further apart than the bound, and always equals the row's argmax.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn
from flax.traverse_util import flatten_dict

import tensorflowdistributedlearning_tpu.models.vit as jvit
from tensorflowdistributedlearning_tpu.ops import quant_kernels as jqk
from tensorflowdistributedlearning_tpu.train import quantize as jq
from tensorflowdistributedlearning_tpu.train import serving as jserving
from tensorflowdistributedlearning_tpu.train.step import ClassificationTask as JTask
from tensorflowdistributedlearning_tpu_torch import __main__ as cli
from tensorflowdistributedlearning_tpu_torch.models import vit as tvit
from tensorflowdistributedlearning_tpu_torch.ops import kernels
from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
from tensorflowdistributedlearning_tpu_torch.train import quantize as tq
from tensorflowdistributedlearning_tpu_torch.train import serving
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax, kernel_leaves
from tests.test_torch_vit import tiny_vit_pair
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


SPECS = ("float32", "bfloat16", "int8", "int8-compute")
TOLS = {  # (compute dtype, spec class) -> (max, mean)
    ("float32", "float"): (1e-6, None),
    ("bfloat16", "float"): (3e-3, 5e-4),
    ("float32", "int8-compute"): (8e-3, 1.5e-3),
    ("bfloat16", "int8-compute"): (8e-3, 1.5e-3),
}
DENSE_PER_BLOCK = 4


@pytest.fixture(scope="module")
def pairs():
    return {dtype: tiny_vit_pair(dtype, True, batch=6) for dtype in ("float32", "bfloat16")}


@pytest.fixture(autouse=True)
def jax_kernels_open(monkeypatch):
    monkeypatch.setattr(jvit, "_fused_platform_ok", lambda: True)
    monkeypatch.setattr(jqk, "int8_matmul", functools.partial(jqk.int8_matmul, interpret=True))


def _jax_outputs(pair, spec, x, capture=None):
    qp, _, _ = jq.quantize_state(pair["params"], None, spec)
    act = jq.compute_dtype(spec)
    with contextlib.ExitStack() as stack:
        if capture is not None:  # entered first: flax calls it before the int8 one
            stack.enter_context(jnn.intercept_methods(capture))
        if spec == "int8-compute":
            stack.enter_context(jqk.int8_intercept(qp, act))
        logits = pair["jm"].apply({"params": jq.dequantize_pytree(qp, act)}, jnp.asarray(x).astype(act), train=False)
    return jq.cast_outputs_float32(JTask().serve_predictions(logits))


def _jax_closure(pair, spec, x, capture=None):
    return {k: np.asarray(v) for k, v in _jax_outputs(pair, spec, x, capture).items()}


def _port_model(pair, spec):
    qstate, section = tq.quantize_state(pair["state"], spec, pair["cfg"])
    return serving.serving_model(pair["cfg"], qstate, section, "cpu")


def _port_closure(pair, spec, **kw):
    return serving.make_serving_fn(_port_model(pair, spec), "cpu", act_dtype=tq.compute_dtype(spec), **kw)


# -- quantization --------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["bfloat16", "int8", "int8-compute"])
def test_quantize_state_is_bitwise_quantize_pytree(pairs, spec):
    pair = pairs["float32"]
    qp, _, _ = jq.quantize_state(pair["params"], None, spec)
    qstate, _ = tq.quantize_state(pair["state"], spec, pair["cfg"])
    leaves = kernel_leaves(pair["cfg"]) if spec != "bfloat16" else {}
    flat = {"/".join(k): v for k, v in flatten_dict(qp, is_leaf=lambda _, node: jq._is_quant_record(node)).items()}
    for name, (path, axis) in leaves.items():
        rec, want = qstate[name], flat[path]
        assert axis == 0  # conv OIHW and Dense [out, in]: flax's HWIO and [in, out] transposed
        layout = (3, 2, 0, 1) if want["q"].ndim == 4 else (1, 0)
        np.testing.assert_array_equal(rec["q"].numpy(), want["q"].transpose(layout))
        np.testing.assert_array_equal(rec["scale"].numpy(), want["scale"])
    n_records = sum(tq.is_record(v) for v in qstate.values())
    assert n_records == len(leaves) == (0 if spec == "bfloat16" else 2 * DENSE_PER_BLOCK + 2)
    # every other leaf (pos_embedding, LayerNorm) is bf16, equal to JAX's
    assert all(v.dtype == torch.bfloat16 for v in qstate.values() if not tq.is_record(v))
    bf16_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jq.dequantize_pytree(qp, jnp.bfloat16))
    want = from_flax(bf16_tree, {}, pair["cfg"])
    got = tq.dequantize(qstate)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name].float(), want[name]), name


@pytest.mark.parametrize("spec", SPECS)
def test_manifest_section_equals_jax(pairs, spec):
    pair = pairs["bfloat16"]
    _, _, want = jq.quantize_state(pair["params"], None, spec)
    _, got = tq.quantize_state(pair["state"], spec, pair["cfg"])
    assert got.pop("source_fingerprint").startswith("sha256:")
    want.pop("source_fingerprint")
    assert got == want


# -- the serving closures ------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_closure_matches_jax(pairs, dtype, spec):
    pair = pairs[dtype]
    x = pair["x"]
    want = _jax_closure(pair, spec, x)
    got = {k: v.numpy() for k, v in _port_closure(pair, spec)(x).items()}
    assert set(got) == set(want) == {"probabilities", "class"}
    assert got["probabilities"].dtype == np.float32 and got["probabilities"].shape == (6, 10)
    assert got["class"].dtype == want["class"].dtype == np.int32 and got["class"].shape == (6,)
    tol_max, tol_mean = TOLS[(dtype, "int8-compute" if spec == "int8-compute" else "float")]
    d = np.abs(got["probabilities"] - want["probabilities"])
    assert d.max() <= tol_max, (d.max(), tol_max)
    if tol_mean is not None:
        assert d.mean() <= tol_mean, (d.mean(), tol_mean)
    p = got["probabilities"]
    np.testing.assert_array_equal(p[np.arange(6), got["class"]], p.max(-1))
    top2 = np.sort(want["probabilities"], axis=-1)[:, -2:]
    separated = top2[:, 1] - top2[:, 0] > 2 * tol_max
    np.testing.assert_array_equal(got["class"][separated], want["class"][separated])


def test_int8_compute_dense_calls_are_bitwise_given_jax_inputs(pairs):
    """Each intercepted Dense's JAX input, through the port's QuantLinear of
    the same path, gives JAX's interpreted int8_matmul output bit for bit."""
    pair = pairs["bfloat16"]
    seen = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, jnn.Dense) and context.method_name == "__call__":
            seen.append((".".join(context.module.path), np.array(args[0].astype(jnp.float32)),
                         args[0].dtype, np.asarray(out.astype(jnp.float32)), out.dtype))
        return out

    _jax_closure(pair, "int8-compute", pair["x"], capture=capture)
    model = _port_model(pair, "int8-compute")
    modules = dict(model.named_modules())
    assert len(seen) == 2 * DENSE_PER_BLOCK + 1
    for path, x, xdt, want, odt in seen:
        layer = modules[path]
        assert isinstance(layer, qk.QuantLinear), path
        xin = torch.from_numpy(x).to(torch.bfloat16 if xdt == jnp.bfloat16 else torch.float32)
        got = layer(xin)
        assert got.dtype == torch.bfloat16 and odt == jnp.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=path)


def test_int8_compute_swaps_every_dense_and_keeps_the_patch_conv(pairs):
    pair = pairs["bfloat16"]
    model = _port_model(pair, "int8-compute")
    quant = [n for n, m in model.named_modules() if isinstance(m, qk.QuantLinear)]
    assert len(quant) == 2 * DENSE_PER_BLOCK + 1 and "logits" in quant
    assert isinstance(model.patch_embed, tvit.PatchEmbed)  # stride 16: the dequantized path, as in JAX
    assert not any(isinstance(m, tvit.Dense) for m in model.modules())
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits = model(torch.from_numpy(pair["x"]).to(torch.bfloat16))
    assert logits.dtype == torch.bfloat16  # the logits Dense goes through int8_matmul, out bf16
    assert sum(kernels.launch_counts().values()) == 0  # CPU tensors take the plain versions


# -- artifacts, engine, HTTP -------------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts(pairs, tmp_path_factory):
    pair = pairs["bfloat16"]
    model = _port_model(pair, "float32")
    root = tmp_path_factory.mktemp("vit-artifacts")
    out = {}
    for spec in SPECS:
        out[spec] = str(root / spec)
        serving.export_serving_artifact(model, pair["cfg"], out[spec], serving_dtype=spec)
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_classification_manifest_keys(pairs, artifacts, spec):
    pair = pairs["bfloat16"]
    manifest = serving.read_manifest(artifacts[spec])
    assert manifest["task"] == "classification" and manifest["num_classes"] == 10
    assert manifest["backbone"] == "vit" and manifest["data_format"] == "NHWC"
    assert manifest["input_shape"] == [None, 32, 32, 3] and manifest["input_dtype"] == "float32"
    assert manifest["outputs"] == {"probabilities": {"shape": [None, 10], "dtype": "float32"},
                                   "class": {"shape": [None], "dtype": "int32"}}
    assert serving.serving_spec(manifest) == spec
    # the JAX closure's output signature, as its exporter records it (batch aside)
    sig = jserving._output_signature(jax.eval_shape(functools.partial(_jax_outputs, pair, spec),
                                                    jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32)))
    assert {k: {"shape": [None] + v["shape"][1:], "dtype": v["dtype"]} for k, v in sig.items()} == manifest["outputs"]


@pytest.mark.parametrize("spec", SPECS)
def test_artifact_serves_what_the_closure_serves(pairs, artifacts, spec):
    pair = pairs["bfloat16"]
    served = serving.load_serving_artifact(artifacts[spec], "cpu")(pair["x"])
    direct = _port_closure(pair, spec)(pair["x"])
    for k in direct:
        assert torch.equal(served[k], direct[k]), k


def test_nchw_boundary_transposes_the_input_only(pairs):
    pair = pairs["float32"]
    nhwc = _port_closure(pair, "float32")(pair["x"])
    nchw = _port_closure(pair, "float32", data_format="NCHW")(pair["x"].transpose(0, 3, 1, 2))
    assert nchw["probabilities"].shape == (6, 10)
    for k in nhwc:
        assert torch.equal(nhwc[k], nchw[k])


def test_engine_pads_and_slices_classifier_outputs(artifacts, pairs):
    pair = pairs["bfloat16"]
    engine = InferenceEngine.from_artifact(artifacts["int8-compute"], device="cpu", buckets=(1, 4, 16))
    x = pair["x"][:3]
    out = engine.infer(x)
    assert out["probabilities"].shape == (3, 10) and out["probabilities"].dtype == np.float32
    assert out["class"].shape == (3,) and out["class"].dtype == np.int32
    assert engine.bucket_hits[4] == 1
    padded = np.concatenate([x, np.zeros((1, 32, 32, 3), np.float32)])
    whole = serving.load_serving_artifact(artifacts["int8-compute"], "cpu")(padded)
    np.testing.assert_array_equal(out["probabilities"], whole["probabilities"][:3].numpy())
    np.testing.assert_array_equal(out["class"], whole["class"][:3].numpy())
    assert json.loads(json.dumps({k: v.tolist() for k, v in out.items()}))["class"] == out["class"].tolist()


def test_cli_convert_then_serve_over_http(pairs, tmp_path):
    pair = pairs["bfloat16"]
    np.savez(tmp_path / "vars.npz", **{f"params/{'/'.join(k)}": v for k, v in flatten_dict(pair["params"]).items()})
    (tmp_path / "cfg.json").write_text(pair["cfg"].to_json())
    art = str(tmp_path / "art")
    rc = cli.main(["convert", "--params", str(tmp_path / "vars.npz"), "--config", str(tmp_path / "cfg.json"),
                   "--out", art, "--serving-dtype", "int8-compute"])
    assert rc == 0
    assert serving.read_manifest(art)["task"] == "classification"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflowdistributedlearning_tpu_torch", "serve", "--artifact-dir", art,
         "--port", "0", "--buckets", "1", "4", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=root, env=env,
    )
    try:
        ready = json.loads(proc.stdout.readline())
        body = json.dumps({"instances": pair["x"][:3].tolist()}).encode()
        req = urllib.request.Request(ready["serving"] + "/v1/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    assert answer["n"] == 3
    want = serving.load_serving_artifact(art, "cpu")(np.concatenate([pair["x"][:3], np.zeros((1, 32, 32, 3), np.float32)]))
    np.testing.assert_array_equal(np.asarray(answer["predictions"]["probabilities"], np.float32),
                                  want["probabilities"][:3].numpy())
    assert answer["predictions"]["class"] == want["class"][:3].tolist()


def test_cli_convert_takes_a_preset(tmp_path):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["convert", "--params", "p.npz", "--preset", "vit_s16_imagenet"])  # no --out
    args = cli.build_parser().parse_args(
        ["convert", "--params", "p.npz", "--preset", "vit_s16_imagenet", "--out", str(tmp_path)])
    assert args.preset == "vit_s16_imagenet" and args.config is None
    assert cli.main(["convert", "--params", "p.npz", "--out", str(tmp_path)]) == 2  # neither --config nor --preset
