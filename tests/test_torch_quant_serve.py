"""The port's quantized serving against the JAX package's, on the CPU, at a
tiny model size (one unit per block, an eighth of the widths, odd 33x33
input).

The JAX closures are built from the package's own functions
(``quantize_state``, ``dequantize_pytree``, ``int8_intercept``,
``serve_predictions``) on the same weights and batch, and run op by op (not
under ``jax.jit``): XLA's jit may keep bf16 intermediates in f32
(``xla_allow_excess_precision``), so the reference is the program as
written, the order and roundings the port repeats. Tolerances on the served
probabilities:

- ``float32``, ``bfloat16``, ``int8``: 1e-5;
- ``int8-compute`` against the JAX closure with its ``int8_conv2d`` run as
  the interpreted kernel (the real integer body): max 1e-4, mean 1e-5
  (measured here: max 2.4e-7; a tenth of the int8-compute budget would be
  0.025 / 0.005); layer by layer, each intercepted conv's JAX input through
  the port's plain int8 conv: 1 bf16 ulp.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn
from flax.traverse_util import flatten_dict, unflatten_dict

from tensorflowdistributedlearning_tpu import config as jconfig
from tensorflowdistributedlearning_tpu.models import build_model as jbuild
from tensorflowdistributedlearning_tpu.ops import quant_kernels as jqk
from tensorflowdistributedlearning_tpu.serve import quant_check as jqc
from tensorflowdistributedlearning_tpu.train import quantize as jq
from tensorflowdistributedlearning_tpu.train import serving as jserving
from tensorflowdistributedlearning_tpu.train.step import SegmentationTask as JTask
from tensorflowdistributedlearning_tpu_torch import __main__ as cli
from tensorflowdistributedlearning_tpu_torch.config import ModelConfig, TrainConfig
from tensorflowdistributedlearning_tpu_torch.models import build_model
from tensorflowdistributedlearning_tpu_torch.ops import kernels as tk
from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels as qk
from tensorflowdistributedlearning_tpu_torch.serve import InferenceEngine
from tensorflowdistributedlearning_tpu_torch.serve import quant_check as tqc
from tensorflowdistributedlearning_tpu_torch.train import quantize as tq
from tensorflowdistributedlearning_tpu_torch.train import serving
from tensorflowdistributedlearning_tpu_torch.train.trainer import Trainer
from tensorflowdistributedlearning_tpu_torch.utils.convert import from_flax
from tests.conftest import make_salt_dataset
from tests.test_torch_dp_worker import one_torch_thread  # noqa: F401 (autouse)


TINY = dict(n_blocks=(1, 1, 1), width_multiplier=0.125, base_depth=16, input_shape=(33, 33))
SPECS = ("float32", "bfloat16", "int8", "int8-compute")
TOL_CLOSE = 1e-5
TOL_INT8_COMPUTE_MAX, TOL_INT8_COMPUTE_MEAN = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pair():
    """JAX model with perturbed params and random BN statistics, the same
    weights in the port, and an input batch."""
    jm = jbuild(jconfig.ModelConfig(**TINY))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 33, 33, 2)).astype(np.float32)
    v = jm.init(jax.random.key(0), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), v["params"]
    )
    stats = unflatten_dict({
        k: (rng.uniform(0.5, 1.5, a.shape) if k[-1] == "var" else rng.normal(0, 0.2, a.shape)).astype(np.float32)
        for k, a in flatten_dict(v["batch_stats"]).items()
    })
    cfg = ModelConfig(**TINY, use_pallas_depthwise=True)
    return dict(jm=jm, params=params, stats=stats, x=x, cfg=cfg, state=from_flax(params, stats, cfg))


def _jax_closure(pair, spec, x, capture=None):
    """The JAX serving closure of ``Trainer.serving_fn``, op by op; with
    ``capture`` a flax interceptor sees every call before the int8 one."""
    qp, qs, _ = jq.quantize_state(pair["params"], pair["stats"], spec)
    act = jq.compute_dtype(spec)
    variables = {"params": jq.dequantize_pytree(qp, act), "batch_stats": jq.dequantize_pytree(qs, act)}
    with contextlib.ExitStack() as stack:
        if capture is not None:  # entered first: flax calls it before the int8 one
            stack.enter_context(jnn.intercept_methods(capture))
        if spec == "int8-compute":
            stack.enter_context(jqk.int8_intercept(qp, act))
        logits = pair["jm"].apply(variables, jnp.asarray(x).astype(act), train=False)
    out = jq.cast_outputs_float32(JTask().serve_predictions(logits))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_closure(pair, spec, device="cpu"):
    qstate, section = tq.quantize_state(pair["state"], spec, pair["cfg"])
    model = serving.serving_model(pair["cfg"], qstate, section, device)
    return serving.make_serving_fn(model, device, act_dtype=tq.compute_dtype(spec)), model


@pytest.fixture
def interpreted_int8_conv(monkeypatch):
    """Point the JAX interceptor's ``int8_conv2d`` at the interpreted kernel."""
    monkeypatch.setattr(jqk, "int8_conv2d", functools.partial(jqk.int8_conv2d, interpret=True))


# -- the manifest section ------------------------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_manifest_section_equals_jax(pair, spec):
    _, _, want = jq.quantize_state(pair["params"], pair["stats"], spec)
    _, got = tq.quantize_state(pair["state"], spec, pair["cfg"])
    assert got.pop("source_fingerprint").startswith("sha256:")
    want.pop("source_fingerprint")
    assert got == want
    if spec.startswith("int8"):
        assert len(got["scales"]) == len(flatten_dict(pair["params"])) - len(
            [k for k in flatten_dict(pair["params"]) if k[-1] != "kernel"]
        )


def test_fingerprint_is_the_weights_identity(pair):
    a = tq.fingerprint(pair["state"])
    assert a == tq.fingerprint(dict(pair["state"])) and len(a) == len("sha256:") + 64
    moved = dict(pair["state"])
    key = next(iter(moved))
    moved[key] = moved[key] + 1e-3
    assert tq.fingerprint(moved) != a


def _corrupt_sections():
    good = {"dtype": "int8", "compute_dtype": "int8", "scheme": "per-channel-symmetric",
            "scales": {"a/kernel": {"shape": [4], "axis": -1, "scale_min": 0.01, "scale_max": 0.02}}}

    def with_(**kw):
        s = json.loads(json.dumps(good))
        for k, v in kw.items():
            if k == "meta":
                s["scales"]["a/kernel"].update(v)
            else:
                s[k] = v
        return s

    return {
        "not-a-dict": [1, 2],
        "bad-dtype": with_(dtype="int4"),
        "bad-compute": with_(compute_dtype="float32"),
        "f32-computes-int8": {"dtype": "float32", "compute_dtype": "int8"},
        "no-scales": with_(scales={}),
        "scale-not-dict": with_(scales={"a/kernel": 3}),
        "bad-shape": with_(meta={"shape": [0]}),
        "zero-scale": with_(meta={"scale_min": 0.0}),
        "nan-scale": with_(meta={"scale_max": float("nan")}),
        "min-above-max": with_(meta={"scale_min": 0.5}),
        "scales-on-bf16": {"dtype": "bfloat16", "scales": good["scales"]},
    }, good


@pytest.mark.parametrize("name", sorted(_corrupt_sections()[0]))
def test_validate_quantization_rejects_what_jax_rejects(name):
    section = _corrupt_sections()[0][name]
    with pytest.raises(ValueError):
        jq.validate_quantization(section)
    with pytest.raises(ValueError):
        tq.validate_quantization(section)


def test_read_manifest_validates_and_defaults(pair, tmp_path):
    model = build_model(pair["cfg"], "cpu")
    model.load_state_dict(pair["state"])
    serving.export_serving_artifact(model, pair["cfg"], str(tmp_path), serving_dtype="int8")
    path = tmp_path / serving.MANIFEST_NAME
    m = json.loads(path.read_text())
    del m["quantization"]["compute_dtype"]
    path.write_text(json.dumps(m))
    assert serving.read_manifest(str(tmp_path))["quantization"]["compute_dtype"] == "bfloat16"
    m["quantization"]["scales"] = {}
    path.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="scales"):
        serving.read_manifest(str(tmp_path))


def test_int8_artifact_bytes_at_rest(tmp_path):
    cfg = ModelConfig(n_blocks=(1, 1, 1), width_multiplier=0.25, base_depth=32, input_shape=(33, 33))
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(1))
    sizes = {}
    for spec in ("float32", "int8-compute"):
        d = tmp_path / spec
        serving.export_serving_artifact(model, cfg, str(d), serving_dtype=spec)
        sizes[spec] = os.path.getsize(d / serving.WEIGHTS_NAME)
        state = torch.load(d / serving.WEIGHTS_NAME, weights_only=True)
        if spec != "float32":
            recs = [v for v in state.values() if tq.is_record(v)]
            assert recs and all(r["q"].dtype == torch.int8 for r in recs)
            assert all(v.dtype == torch.bfloat16 for v in state.values() if not tq.is_record(v))
    assert sizes["int8-compute"] <= 0.3 * sizes["float32"], sizes


# -- the serving closures against JAX's ---------------------------------------------


@pytest.mark.parametrize("spec", ["float32", "bfloat16", "int8"])
def test_serving_closure_matches_jax(pair, spec):
    want = _jax_closure(pair, spec, pair["x"])
    serve, _ = _port_closure(pair, spec)
    got = {k: v.numpy() for k, v in serve(pair["x"]).items()}
    assert got["probabilities"].dtype == np.float32 and got["mask"].dtype == np.float32
    assert np.abs(got["probabilities"] - want["probabilities"]).max() <= TOL_CLOSE
    assert 0.02 < want["probabilities"].std()  # random BN statistics keep it meaningful
    away = np.abs(want["probabilities"] - 0.5) > TOL_CLOSE
    np.testing.assert_array_equal(got["mask"][away], want["mask"][away])


def test_int8_compute_closure_matches_jax(pair, interpreted_int8_conv):
    want = _jax_closure(pair, "int8-compute", pair["x"])
    serve, model = _port_closure(pair, "int8-compute")
    assert sum(isinstance(m, qk.QuantConv2d) for m in model.modules()) > 0
    got = serve(pair["x"])["probabilities"].numpy()
    d = np.abs(got - want["probabilities"])
    assert d.max() <= TOL_INT8_COMPUTE_MAX and d.mean() <= TOL_INT8_COMPUTE_MEAN, (d.max(), d.mean())
    # and the quantized path is another function than the float32 one
    f32 = _jax_closure(pair, "float32", pair["x"])["probabilities"]
    assert np.abs(got - f32).max() > 10 * TOL_INT8_COMPUTE_MAX


def test_int8_compute_layer_by_layer(pair, interpreted_int8_conv):
    """Each conv the JAX interceptor takes, fed its own JAX input, through
    the port's plain int8 conv and the port's records: 1 bf16 ulp of the
    interpreted JAX kernel."""
    from tests.test_torch_quant_kernels import jax_int8_eligible, ulps

    seen = []

    def capture(next_fun, args, kwargs, context):
        mod = context.module
        if context.method_name == "__call__" and jax_int8_eligible(mod):
            seen.append((".".join(mod.path), args[0], mod.padding))
        return next_fun(*args, **kwargs)

    _jax_closure(pair, "int8-compute", pair["x"], capture=capture)
    qp, _, _ = jq.quantize_state(pair["params"], pair["stats"], "int8-compute")
    qstate, _ = tq.quantize_state(pair["state"], "int8-compute", pair["cfg"])
    _, model = _port_closure(pair, "int8-compute")
    swapped = {n for n, m in model.named_modules() if isinstance(m, qk.QuantConv2d)}
    assert {name for name, _, _ in seen} == swapped and len(seen) == len(swapped)
    for name, xj, padding in seen:
        node = qp
        for part in name.split("."):
            node = node[part]
        rec, bias = node["kernel"], node.get("bias")
        want = jqk.int8_conv2d(xj, rec["q"], rec["scale"], padding=padding, bias=bias, out_dtype=jnp.bfloat16)
        prec = qstate[f"{name}.weight"]
        xt = torch.from_numpy(np.asarray(jnp.asarray(xj, jnp.float32))).to(
            torch.bfloat16 if xj.dtype == jnp.bfloat16 else torch.float32
        )
        tb = None if bias is None else qstate[f"{name}.bias"].float()
        got = qk.int8_conv2d_ohwi_plain(xt, prec["q"].permute(0, 2, 3, 1).contiguous(), prec["scale"],
                                        qk._conv_pads(padding, *rec["q"].shape[:2]), bias=tb,
                                        out_dtype=torch.bfloat16)
        assert ulps(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), "bfloat16") <= 1, name


def test_int8_compute_dtype_flow_matches_flax(pair):
    """Every module's output dtype, flax's (captured intermediates) against
    the port's (forward hooks): bf16 out of each int8 conv, the bf16
    residual stream, f32 out of every BatchNorm."""
    qp, qs, _ = jq.quantize_state(pair["params"], pair["stats"], "int8-compute")
    act = jq.compute_dtype("int8-compute")
    variables = {"params": jq.dequantize_pytree(qp, act), "batch_stats": jq.dequantize_pytree(qs, act)}
    with jqk.int8_intercept(qp, act):
        _, inter = pair["jm"].apply(variables, jnp.asarray(pair["x"]).astype(act), train=False,
                                    capture_intermediates=True)
    jax_dtypes = {}
    for path, val in flatten_dict(inter["intermediates"]).items():
        out = val[0]
        leaves = out if isinstance(out, tuple) else (out,)
        if all(hasattr(v, "dtype") for v in leaves):
            jax_dtypes[".".join(path[:-1])] = tuple(str(v.dtype) for v in leaves)
    _, model = _port_closure(pair, "int8-compute")
    port_dtypes = {}

    def record(name, out):
        leaves = out if isinstance(out, tuple) else (out,)
        if all(torch.is_tensor(v) for v in leaves):
            port_dtypes[name] = tuple(str(v.dtype).replace("torch.", "") for v in leaves)

    handles = [m.register_forward_hook(lambda mod, a, out, name=n: record(name, out))
               for n, m in model.named_modules() if n]
    with torch.inference_mode():
        model(torch.from_numpy(pair["x"]).to(torch.bfloat16))
    for h in handles:
        h.remove()
    # the port's BatchNorm module ends in its activation; flax's BN does not,
    # but both leave float32
    common = sorted(set(jax_dtypes) & set(port_dtypes))
    assert len(common) >= 40
    assert {n: jax_dtypes[n] for n in common} == {n: port_dtypes[n] for n in common}
    # a unit whose shortcut and conv3 are int8 convs returns a bf16 stream;
    # (this tiny model's block1_unit1 strides its shortcut: float32 there)
    assert port_dtypes["backbone.block2_unit1"] == ("bfloat16", "bfloat16")
    assert port_dtypes["backbone.block1_unit1"] == ("float32", "bfloat16")
    assert port_dtypes["backbone.block2_unit1.preact"] == ("float32",)


# -- quantize-check ---------------------------------------------------------------------


def test_output_delta_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(4, 5, 5, 1)).astype(np.float32)
    b = (a + rng.normal(0, 1e-3, a.shape)).astype(np.float32)
    cases = [
        (a, b),
        ((a > 0.5).astype(np.float32), (b > 0.5).astype(np.float32)),
        (np.zeros((3, 2), np.float32), np.zeros((3, 2), np.float32)),
        (rng.integers(0, 5, 10), rng.integers(0, 5, 10)),
        (a, a[:2]),
    ]
    for ref, cand in cases:
        assert tqc.output_delta("o", ref, cand) == jqc.output_delta("o", ref, cand)
    assert tqc.DEFAULT_THRESHOLDS == jqc.DEFAULT_THRESHOLDS
    for q in (None, {"dtype": "int8", "compute_dtype": "int8"}, {"dtype": "int8"}, {"dtype": "bfloat16"}):
        assert tqc.budget_key(q) == jqc.budget_key(q)
    manifest = {"input_shape": [None, 7, 5, 2]}
    np.testing.assert_array_equal(tqc.pinned_eval_batch(manifest, 3, 4), jqc.pinned_eval_batch(manifest, 3, 4))
    outs = {"p": a, "c": rng.integers(0, 3, 9)}
    assert (tqc.summarize_output_distribution(outs, batch=4, seed=1)
            == jqc.summarize_output_distribution(outs, batch=4, seed=1))


def test_write_drift_baseline_writes_what_jax_writes(tmp_path):
    baseline = jqc.summarize_output_distribution({"p": np.linspace(0, 1, 12, dtype=np.float32)}, batch=3, seed=0)
    manifest = {"input_shape": [None, 4, 4, 2], "quantization": {"dtype": "float32"}, "extra": [1, 2]}
    written = {}
    for name, write in (("jax", jqc.write_drift_baseline), ("port", tqc.write_drift_baseline)):
        d = tmp_path / name
        d.mkdir()
        (d / serving.MANIFEST_NAME).write_text(json.dumps(manifest))
        write(str(d), baseline)
        written[name] = (d / serving.MANIFEST_NAME).read_bytes()
        assert sorted(p.name for p in d.iterdir()) == [serving.MANIFEST_NAME]  # no temporary file left
    assert written["port"] == written["jax"]
    assert json.loads(written["port"]) == {**manifest, "drift_baseline": baseline}


@pytest.mark.parametrize("case", ["pass", "fail", "override", "fingerprint", "fingerprint-allowed"])
def test_run_quant_check_record_equals_jax(case, monkeypatch):
    """Both packages' ``run_quant_check`` over the same manifests and the
    same output arrays (their artifact loaders stubbed) give one record."""
    rng = np.random.default_rng(5)
    ref = rng.uniform(size=(2, 4, 4, 1)).astype(np.float32)
    step = 0.3 if case == "fail" else 1e-3
    cand = np.clip(ref + rng.normal(0, step, ref.shape), 0, 1).astype(np.float32)
    outs = {"ref": {"probabilities": ref, "mask": (ref > 0.5).astype(np.float32)},
            "cand": {"probabilities": cand, "mask": (cand > 0.5).astype(np.float32)}}
    fps = {"ref": "sha256:a", "cand": "sha256:b" if case.startswith("fingerprint") else "sha256:a"}
    manifests = {
        d: {"input_shape": [None, 4, 4, 2], "quantization": {"dtype": "int8", "compute_dtype": "int8",
                                                             "source_fingerprint": fps[d]}}
        for d in ("ref", "cand")
    }
    monkeypatch.setattr(jserving, "read_manifest", lambda d: manifests[d])
    monkeypatch.setattr(jserving, "load_serving_artifact", lambda d: lambda x: outs[d])
    monkeypatch.setattr(serving, "read_manifest", lambda d: manifests[d])
    monkeypatch.setattr(serving, "load_serving_artifact",
                        lambda d, device=None: lambda x: {k: torch.from_numpy(v) for k, v in outs[d].items()})
    kwargs = dict(batch_size=2, seed=1, allow_fingerprint_mismatch=case == "fingerprint-allowed",
                  thresholds={"max_abs_delta": 1e-4, "min_iou": None} if case == "override" else None)
    want = jqc.run_quant_check("ref", "cand", **kwargs)
    got = tqc.run_quant_check("ref", "cand", device="cpu", **kwargs)
    assert got == want
    assert got["passed"] == (case in ("pass", "fingerprint-allowed"))


# -- the engine, the trainer and the command line ------------------------------------------


def test_engine_serves_int8_compute_and_padding_keeps_real_rows(pair, tmp_path):
    model = build_model(pair["cfg"], "cpu")
    model.load_state_dict(pair["state"])
    serving.export_serving_artifact(model, pair["cfg"], str(tmp_path), serving_dtype="int8-compute")
    engine = InferenceEngine.from_artifact(str(tmp_path), device="cpu", buckets=(1, 4, 16))
    engine.warmup()
    x = pair["x"]
    padded = engine.infer(x)  # padded to bucket 4 with zero rows: the same activation scales
    serve = serving.load_serving_artifact(str(tmp_path), "cpu")
    direct = serve(x)
    # the CPU's f32 convs block by batch size, so the float layers may round
    # in another order (test_torch_serve.py's padding test holds 1e-6 too)
    np.testing.assert_allclose(padded["probabilities"], direct["probabilities"].numpy(), atol=1e-6, rtol=0)
    assert padded["probabilities"].dtype == np.float32 and engine.input_dtype == np.float32
    tk.reset_launch_counts()
    engine.infer(x[:1])
    assert sum(tk.launch_counts().values()) == 0  # CPU tensors launch no kernel


def test_trainer_exports_and_serves_every_spec(tmp_path):
    data, _, ids = make_salt_dataset(tmp_path / "salt", n_images=12, shape=(32, 32))
    trainer = Trainer(str(tmp_path / "m"), data, device="cpu",
                      train_config=TrainConfig(n_folds=2, seed=0, checkpoint_every_steps=2, eval_throttle_secs=0),
                      n_blocks=(1, 1, 1), input_shape=(32, 32), base_depth=16, width_multiplier=0.125,
                      use_pallas_depthwise=True)
    trainer.train(ids, batch_size=4, steps=2)
    x = np.random.default_rng(9).normal(size=(2, 32, 32, 2)).astype(np.float32)
    for spec in SPECS:
        manifest = trainer.export_serving(0, serving_dtype=spec)
        art = os.path.dirname(manifest)
        assert os.path.basename(art) == ("serving" if spec == "float32" else f"serving-{spec}")
        m = serving.read_manifest(art)
        assert serving.serving_spec(m) == spec and m["fold"] == 0
        serve = trainer.serving_fn(0, serving_dtype=spec)
        assert serve.quantization == m["quantization"]
        loaded = serving.load_serving_artifact(art, "cpu")(x)["probabilities"]
        assert torch.equal(serve(x)["probabilities"], loaded)
    with pytest.raises(ValueError, match="spec"):
        trainer.export_serving(0, serving_dtype="int4")


def test_cli_convert_int8_compute_then_quantize_check(pair, tmp_path, capsys):
    flat = {f"params/{'/'.join(k)}": v for k, v in flatten_dict(pair["params"]).items()}
    flat.update({f"batch_stats/{'/'.join(k)}": v for k, v in flatten_dict(pair["stats"]).items()})
    np.savez(tmp_path / "vars.npz", **flat)
    (tmp_path / "cfg.json").write_text(pair["cfg"].to_json())
    arts = {}
    for spec in ("float32", "int8-compute"):
        arts[spec] = str(tmp_path / spec)
        assert cli.main(["convert", "--params", str(tmp_path / "vars.npz"), "--config", str(tmp_path / "cfg.json"),
                         "--out", arts[spec], "--serving-dtype", spec]) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["serving_dtype"] == spec
    base = ["quantize-check", "--reference-dir", arts["float32"], "--candidate-dir", arts["int8-compute"],
            "--batch-size", "2", "--device", "cpu"]
    rc = cli.main(base)
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["dtype"] == "int8-compute" and record["fingerprint_match"] is True
    assert rc == (0 if record["passed"] else 1)
    assert set(record["outputs"]) == {"probabilities", "mask"} and record["batch"] == [2, 33, 33, 2]
    assert cli.main(base + ["--max-abs-delta", "1e-9"]) == 1
    assert any("max|delta|" in f for f in json.loads(capsys.readouterr().out.strip())["failures"])
    assert cli.main(base + ["--max-abs-delta", "1", "--mean-abs-delta", "1", "--min-iou", "0",
                            "--max-disagree", "1"]) == 0
    capsys.readouterr()


def test_cli_train_exports_the_requested_spec(tmp_path, capsys):
    data, _, _ = make_salt_dataset(tmp_path / "salt", n_images=12, shape=(32, 32))
    rc = cli.main(["train", "--data-dir", data, "--model-dir", str(tmp_path / "m"), "--batch-size", "4",
                   "--steps", "2", "--n-fold", "2", "--input-shape", "32", "32", "--n-blocks", "1", "1", "1",
                   "--base-depth", "8", "--checkpoint-every", "2", "--eval-throttle-secs", "0",
                   "--use-pallas-depthwise", "--device", "cpu", "--export-serving", "--serving-dtype",
                   "int8-compute"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["serving_dtype"] == "int8-compute" and out["serving_artifact"].endswith("serving-int8-compute")
    assert serving.serving_spec(serving.read_manifest(out["serving_artifact"])) == "int8-compute"
