"""quantize-check: the accuracy gate between a float32 artifact and its
quantized sibling (counterpart of the JAX package's
``serve/quant_check.py``).

Both artifacts run over one pinned eval batch (standard-normal values shaped
from the manifest's input signature and a seed: the same bytes every run);
the check fails when an output's delta passes the candidate precision's
budget, or when the two manifests' source fingerprints differ (the pair
does not derive from one set of weights). Deltas per output: max/mean
absolute delta for floats, IoU and disagreement for binary masks,
disagreement for integer outputs.

The JAX package also writes each verdict to its run ledger as a
``quant_check`` event; the port's telemetry ledger is not ported yet, so
:func:`run_quant_check` returns the record and the CLI prints it.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

from tensorflowdistributedlearning_tpu_torch.train import quantize
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike

logger = logging.getLogger(__name__)

# Per-precision accuracy budgets, in output units (probabilities/masks in
# [0,1]). bf16 keeps ~3 significant digits — rounding alone cannot move a
# probability by 0.05 unless the model amplifies it, which is exactly what
# the gate exists to catch. int8 weight-quantization error is larger and
# model-dependent; the defaults are the loosest budget a production gate
# should bless. float32 candidates must be bit-exact up to run-to-run fusion
# jitter. All overridable per-run (CLI flags / thresholds=).
DEFAULT_THRESHOLDS: Dict[str, Dict[str, float]] = {
    "float32": {
        "max_abs_delta": 1e-5,
        "mean_abs_delta": 1e-6,
        "min_iou": 1.0,
        "max_disagree": 0.0,
    },
    "bfloat16": {
        "max_abs_delta": 0.05,
        "mean_abs_delta": 0.01,
        "min_iou": 0.98,
        "max_disagree": 0.02,
    },
    "int8": {
        "max_abs_delta": 0.15,
        "mean_abs_delta": 0.03,
        "min_iou": 0.95,
        "max_disagree": 0.05,
    },
    # int8-COMPUTE adds dynamic per-tensor activation quantization on top of
    # int8 weight storage: each quantized layer's inputs round to 8 bits, so
    # the error budget is wider than weight-only int8. The comparison is
    # still against the F32 REFERENCE artifact — not the dequantize-f32
    # int8-store sibling — so kernel-arithmetic drift is caught at
    # admission, on the same path that serves (the candidate's own traced
    # graph, which also stamps the drift baseline).
    "int8-compute": {
        "max_abs_delta": 0.25,
        "mean_abs_delta": 0.05,
        "min_iou": 0.92,
        "max_disagree": 0.08,
    },
}


def budget_key(quantization: Optional[Dict]) -> str:
    """Which DEFAULT_THRESHOLDS budget a manifest ``quantization`` section
    gates under: the storage dtype, except int8 storage with int8 compute
    gates under the wider ``int8-compute`` budget. The ONE place the
    (dtype, compute_dtype) pair maps to a budget name — bench_serve's gate
    table and the sentinel replay key off the same answer. The map itself is
    :func:`train.quantize.spec_of`: budgets are named by serving spec."""
    return quantize.spec_of(quantization)


def pinned_eval_batch(manifest: Dict, batch_size: int, seed: int = 0) -> np.ndarray:
    """The deterministic probe batch both artifacts are compared on:
    standard-normal values (the models' inputs are normalized images) shaped
    from the manifest's input signature. A fixed-batch artifact pins the
    batch dimension itself; polymorphic ones take ``batch_size``."""
    shape = list(manifest["input_shape"])
    if shape[0] is not None:
        batch_size = int(shape[0])
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch_size, *shape[1:])).astype(np.float32)


def _is_binary(a: np.ndarray) -> bool:
    return a.size > 0 and bool(np.isin(np.unique(a), (0, 1)).all())


def summarize_output_distribution(
    outputs: Dict[str, np.ndarray], *, batch: int, seed: int
) -> Dict:
    """Per-output distribution summary over the pinned eval batch — the
    canonical ``drift_baseline`` the DriftMonitor (obs/health.py) compares
    live serving outputs against. Integer outputs (argmax class ids) keep a
    normalized histogram; float outputs keep mean/std. Persisted into the
    artifact manifest at export and promotion time so drift detection never
    re-runs eval."""
    summary: Dict = {"batch": int(batch), "seed": int(seed), "outputs": {}}
    for name in sorted(outputs):
        arr = np.asarray(outputs[name])
        if np.issubdtype(arr.dtype, np.integer):
            vals, counts = np.unique(arr, return_counts=True)
            summary["outputs"][name] = {
                "kind": "integer",
                "n": int(arr.size),
                "hist": {
                    str(int(v)): round(float(c) / arr.size, 6)
                    for v, c in zip(vals, counts)
                },
            }
        else:
            a = arr.astype(np.float64)
            summary["outputs"][name] = {
                "kind": "float",
                "mean": round(float(a.mean()), 6) if a.size else 0.0,
                "std": round(float(a.std()), 6) if a.size else 0.0,
            }
    return summary


def write_drift_baseline(artifact_dir: str, baseline: Dict) -> None:
    """Install ``drift_baseline`` into an artifact's manifest atomically.
    Extra manifest keys ride along untouched (train/serving.py validates
    only what it knows), so an already-promoted artifact can be stamped
    in place."""
    import json
    import os

    from tensorflowdistributedlearning_tpu_torch.train import serving as serving_lib

    path = os.path.join(artifact_dir, serving_lib.MANIFEST_NAME)
    with open(path, encoding="utf-8") as f:
        manifest = json.load(f)
    manifest["drift_baseline"] = baseline
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def stamp_drift_baseline(artifact_dir: str, *, batch_size: int = 32, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Compute and persist an artifact's own output-distribution baseline
    (the export-time path): its serving closure on ``device`` (CUDA when
    None) over the pinned eval batch, summarised and written into the
    manifest."""
    from tensorflowdistributedlearning_tpu_torch.train import serving as serving_lib

    manifest = serving_lib.read_manifest(artifact_dir)
    batch = pinned_eval_batch(manifest, batch_size, seed)
    fn = serving_lib.load_serving_artifact(artifact_dir, device)
    out = {k: v.detach().cpu().numpy() for k, v in fn(batch).items()}
    baseline = summarize_output_distribution(out, batch=batch.shape[0], seed=seed)
    write_drift_baseline(artifact_dir, baseline)
    return baseline


def output_delta(name: str, ref: np.ndarray, cand: np.ndarray) -> Dict:
    """Delta record for one output; the applicable threshold keys depend on
    which of the three output kinds this is. Public: the promotion
    controller's shadow compare (serve/router.py) reuses exactly this math
    on live traffic — the canary's answer plays ``cand`` against the serving
    replica's ``ref``."""
    if ref.shape != cand.shape:
        return {"error": f"shape mismatch: {ref.shape} vs {cand.shape}"}
    if np.issubdtype(ref.dtype, np.integer) or np.issubdtype(
        cand.dtype, np.integer
    ):
        return {
            "kind": "integer",
            "disagree": round(float(np.mean(ref != cand)), 6),
        }
    ref64 = ref.astype(np.float64)
    cand64 = cand.astype(np.float64)
    delta = np.abs(ref64 - cand64)
    rec = {
        "kind": "float",
        "max_abs_delta": round(float(delta.max()), 6) if delta.size else 0.0,
        "mean_abs_delta": round(float(delta.mean()), 6) if delta.size else 0.0,
    }
    if _is_binary(ref64) and _is_binary(cand64):
        rec["kind"] = "binary"
        inter = float(np.sum((ref64 > 0.5) & (cand64 > 0.5)))
        union = float(np.sum((ref64 > 0.5) | (cand64 > 0.5)))
        rec["iou"] = round(inter / union, 6) if union else 1.0
    return rec


def compare_outputs(ref_out: Dict[str, np.ndarray], cand_out: Dict[str, np.ndarray], limits: Dict[str, float]):
    """``(outputs, failures)``: each output's delta record and every budget
    it passes, as ``run_quant_check`` gates them."""
    failures = []
    outputs: Dict[str, Dict] = {}
    if set(ref_out) != set(cand_out):
        failures.append(
            f"output names differ: {sorted(ref_out)} vs {sorted(cand_out)}"
        )
    for name in sorted(set(ref_out) & set(cand_out)):
        rec = output_delta(
            name, np.asarray(ref_out[name]), np.asarray(cand_out[name])
        )
        outputs[name] = rec
        if "error" in rec:
            failures.append(f"{name}: {rec['error']}")
            continue
        if rec["kind"] == "integer":
            if rec["disagree"] > limits["max_disagree"]:
                failures.append(
                    f"{name}: disagreement {rec['disagree']} > "
                    f"{limits['max_disagree']}"
                )
            continue
        if rec["kind"] == "binary":
            # a binary mask's max|delta| is 1.0 the moment ANY pixel
            # flips near the decision threshold, so the float budgets
            # would fail every quantized segmentation artifact; masks
            # gate on IoU and the disagreement fraction (which IS the
            # mean |delta| of a {0,1} pair)
            if rec["mean_abs_delta"] > limits["max_disagree"]:
                failures.append(
                    f"{name}: mask disagreement {rec['mean_abs_delta']} "
                    f"> {limits['max_disagree']}"
                )
            if rec["iou"] < limits["min_iou"]:
                failures.append(
                    f"{name}: IoU {rec['iou']} < {limits['min_iou']}"
                )
            continue
        if rec["max_abs_delta"] > limits["max_abs_delta"]:
            failures.append(
                f"{name}: max|delta| {rec['max_abs_delta']} > "
                f"{limits['max_abs_delta']}"
            )
        if rec["mean_abs_delta"] > limits["mean_abs_delta"]:
            failures.append(
                f"{name}: mean|delta| {rec['mean_abs_delta']} > "
                f"{limits['mean_abs_delta']}"
            )
    return outputs, failures


def run_quant_check(
    reference_dir: str,
    candidate_dir: str,
    *,
    batch_size: int = 16,
    seed: int = 0,
    thresholds: Optional[Dict[str, float]] = None,
    allow_fingerprint_mismatch: bool = False,
    device: DeviceLike = None,
) -> Dict:
    """Compare two exported artifacts over the pinned eval batch on
    ``device`` (CUDA when None). Returns the verdict record: per-output
    deltas, the thresholds applied, the failure list, ``passed``, and the
    candidate's output distribution over the batch. The candidate's budget
    comes from its manifest via :func:`budget_key`."""
    from tensorflowdistributedlearning_tpu_torch.train import serving as serving_lib

    ref_manifest = serving_lib.read_manifest(reference_dir)
    cand_manifest = serving_lib.read_manifest(candidate_dir)
    dtype = budget_key(cand_manifest.get("quantization"))
    limits = dict(DEFAULT_THRESHOLDS.get(dtype, DEFAULT_THRESHOLDS["int8"]))
    if thresholds:
        limits.update({k: v for k, v in thresholds.items() if v is not None})

    failures = []
    ref_fp = (ref_manifest.get("quantization") or {}).get("source_fingerprint")
    cand_fp = (cand_manifest.get("quantization") or {}).get(
        "source_fingerprint"
    )
    if ref_fp and cand_fp and ref_fp != cand_fp:
        msg = (
            "source fingerprint mismatch — the artifacts derive from "
            "different checkpoints, the comparison is meaningless"
        )
        if allow_fingerprint_mismatch:
            logger.warning("quantize-check: %s (allowed by flag)", msg)
        else:
            failures.append(msg)

    batch = pinned_eval_batch(cand_manifest, batch_size, seed)
    outputs: Dict[str, Dict] = {}
    candidate_summary: Optional[Dict] = None
    if not failures:  # a wrong pairing makes the numerics noise; skip them
        ref_fn = serving_lib.load_serving_artifact(reference_dir, device)
        cand_fn = serving_lib.load_serving_artifact(candidate_dir, device)
        ref_out = {k: v.cpu().numpy() for k, v in ref_fn(batch).items()}
        cand_out = {k: v.cpu().numpy() for k, v in cand_fn(batch).items()}
        outputs, numeric = compare_outputs(ref_out, cand_out, limits)
        failures += numeric
        candidate_summary = summarize_output_distribution(
            cand_out, batch=batch.shape[0], seed=seed
        )

    result = {
        "reference": reference_dir,
        "candidate": candidate_dir,
        "dtype": dtype,
        "batch": list(batch.shape),
        "seed": seed,
        "thresholds": limits,
        "outputs": outputs,
        "fingerprint_match": (
            None if not (ref_fp and cand_fp) else ref_fp == cand_fp
        ),
        "failures": failures,
        "passed": not failures,
    }
    if candidate_summary is not None:
        result["candidate_summary"] = candidate_summary
    return result
