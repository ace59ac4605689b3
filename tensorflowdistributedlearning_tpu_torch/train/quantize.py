"""Post-training quantization for serving export (counterpart of the JAX
package's ``train/quantize.py``).

Serving specs, as in the JAX package:

- ``float32``: the model as trained, bit for bit;
- ``bfloat16``: every float tensor stored in bf16; the model computes in
  its ``ModelConfig.dtype``, so bf16 weights are promoted (or, in a bf16
  ViT, used as they are), except in BatchNorm, which computes flax's way
  with bf16 statistics;
- ``int8``: conv, depthwise and Dense filters (flax's ``kernel`` leaves)
  stored as int8 with per-output-channel symmetric scales, everything else
  in bf16; the filters are dequantized to bf16 (``q * scale`` in bf16) at
  load;
- ``int8-compute``: the same bytes as ``int8``; at load every eligible conv
  becomes an int8-arithmetic :class:`ops.quant_kernels.QuantConv2d` and
  every Dense a :class:`ops.quant_kernels.QuantLinear`.

:func:`quantize_state` works on the port's ``state_dict``. Its manifest
``quantization`` section keys the int8 ``scales`` by flax path, so it equals
the JAX package's section key for key (only ``source_fingerprint`` differs:
it hashes the port's own float32 ``state_dict``).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig

SERVING_DTYPES = ("float32", "bfloat16", "int8")
SERVING_SPECS = SERVING_DTYPES + ("int8-compute",)

# manifest compute_dtype per storage dtype when the spec doesn't say
# otherwise
_DEFAULT_COMPUTE = {
    "float32": "float32",
    "bfloat16": "bfloat16",
    "int8": "bfloat16",  # dequantize at load: int8 bytes, bf16 weights
}
_INT8_AXIS = -1  # the manifest names flax's axis: output channels, last


def check_serving_dtype(serving_dtype: str) -> str:
    if serving_dtype not in SERVING_DTYPES:
        raise ValueError(f"serving_dtype {serving_dtype!r} not in {SERVING_DTYPES}")
    return serving_dtype


def check_serving_spec(spec: str) -> str:
    if spec not in SERVING_SPECS:
        raise ValueError(f"serving spec {spec!r} not in {SERVING_SPECS}")
    return spec


def parse_serving_spec(spec: str) -> Tuple[str, str]:
    """``(storage_dtype, compute_dtype)`` of a serving spec:
    ``"int8-compute"`` -> ``("int8", "int8")``."""
    check_serving_spec(spec)
    if spec == "int8-compute":
        return "int8", "int8"
    return spec, _DEFAULT_COMPUTE[spec]


def spec_of(quantization: Mapping[str, Any] | None) -> str:
    """The serving spec a manifest ``quantization`` section declares, the
    inverse of :func:`parse_serving_spec`: the storage dtype, except int8
    storage with int8 compute is ``"int8-compute"``; no section is
    ``"float32"``."""
    q = quantization or {}
    dtype = q.get("dtype", "float32")
    if dtype == "int8" and q.get("compute_dtype") == "int8":
        return "int8-compute"
    return dtype


def default_compute_dtype(storage_dtype: str) -> str:
    """What a manifest without a ``compute_dtype`` field means."""
    check_serving_dtype(storage_dtype)
    return _DEFAULT_COMPUTE[storage_dtype]


def compute_dtype(serving_spec: str) -> torch.dtype:
    """The activation dtype of a spec's serving closure: the images enter
    the model in it (float32 for ``float32``, bf16 for every other spec)."""
    check_serving_spec(serving_spec)
    return torch.float32 if serving_spec == "float32" else torch.bfloat16


def fingerprint(state: Mapping[str, torch.Tensor]) -> str:
    """sha256 over (name, dtype, shape, bytes) of every tensor of a float32
    ``state_dict``, in name order, in the JAX package's ``sha256:`` format:
    the identity of the weights an artifact was derived from."""
    h = hashlib.sha256()
    for name in sorted(state):
        arr = state[name].detach().cpu().numpy()
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return "sha256:" + h.hexdigest()


def _quantize_leaf_int8(arr: np.ndarray) -> Dict[str, Any]:
    """Per-channel symmetric int8 over the last axis: scale = max|w|/127,
    q = round(w/scale) in [-127, 127]. All-zero channels keep scale 1.0 so
    dequantization never divides by (or multiplies garbage with) zero."""
    a = np.asarray(arr, np.float32)
    max_abs = np.max(np.abs(a), axis=tuple(range(a.ndim - 1)))
    scale = np.where(max_abs > 0, max_abs / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale}


def quantize_leaf_int8(weight: torch.Tensor, axis: int) -> Dict[str, torch.Tensor]:
    """``{"q" int8, "scale" f32, "axis"}`` of a filter in the port's
    layout, per output channel ``axis``: :func:`_quantize_leaf_int8` on the
    filter with that axis moved last (max and division are elementwise, so
    the values are those of the flax-layout filter), ``q`` moved back."""
    a = np.moveaxis(weight.detach().cpu().float().numpy(), axis, -1)
    rec = _quantize_leaf_int8(a)
    return {"q": torch.from_numpy(np.ascontiguousarray(np.moveaxis(rec["q"], -1, axis))),
            "scale": torch.from_numpy(rec["scale"]), "axis": axis}


def quantize_state(state: Mapping[str, torch.Tensor], serving_spec: str, config: ModelConfig):
    """``(qstate, section)`` for export. ``float32`` returns the state
    untouched; ``bfloat16`` casts every float tensor; ``int8`` and
    ``int8-compute`` (identical bytes) replace each filter by a ``{"q",
    "scale"}`` record and cast the rest to bf16. ``section`` is the manifest
    ``quantization`` dict."""
    from tensorflowdistributedlearning_tpu_torch.utils.convert import kernel_leaves

    storage, compute = parse_serving_spec(serving_spec)
    section: Dict[str, Any] = {
        "dtype": storage,
        "compute_dtype": compute,
        "source_fingerprint": fingerprint(state),
    }
    if storage == "float32":
        return dict(state), section
    leaves = kernel_leaves(config) if storage == "int8" else {}
    scales: Dict[str, Dict] = {}
    qstate: Dict[str, Any] = {}
    for name, t in state.items():
        if not t.is_floating_point():
            qstate[name] = t
        elif name in leaves:
            path, axis = leaves[name]
            rec = quantize_leaf_int8(t, axis)
            scales[path] = {
                "shape": list(rec["scale"].shape),
                "axis": _INT8_AXIS,
                "scale_min": float(rec["scale"].min()),
                "scale_max": float(rec["scale"].max()),
            }
            qstate[name] = rec
        else:
            qstate[name] = t.detach().cpu().to(torch.bfloat16)
    if storage == "int8":
        section["scheme"] = "per-channel-symmetric"
        section["scales"] = scales
    return qstate, section


def is_record(v) -> bool:
    return isinstance(v, Mapping) and "q" in v and "scale" in v and "axis" in v


def dequantize(qstate: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A tensor state from :func:`quantize_state`'s output: each record
    becomes ``q.bf16 * scale.bf16`` multiplied in bf16 (as
    ``dequantize_pytree``); other tensors pass through."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in qstate.items():
        if is_record(v):
            shape = [1] * v["q"].dim()
            shape[v["axis"]] = -1
            out[name] = v["q"].to(torch.bfloat16) * v["scale"].to(torch.bfloat16).view(shape)
        else:
            out[name] = v
    return out


def cast_outputs_float32(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Serving boundary contract: float outputs leave as float32 whatever
    the internal compute dtype; other outputs pass through."""
    return {k: v.float() if v.is_floating_point() and v.dtype != torch.float32 else v for k, v in out.items()}


def validate_quantization(section) -> Dict:
    """Manifest ``quantization`` section validation — the corrupt-artifact
    gate ``read_manifest`` applies. Raises ``ValueError`` with a pointed
    message; returns the section for chaining."""
    if not isinstance(section, dict):
        raise ValueError(
            f"manifest quantization section must be a dict, got "
            f"{type(section).__name__}"
        )
    dtype = section.get("dtype")
    if dtype not in SERVING_DTYPES:
        raise ValueError(
            f"manifest quantization.dtype {dtype!r} not in {SERVING_DTYPES}"
        )
    compute = section.get("compute_dtype")
    if compute is not None:
        # storage and compute are separate axes, but not every pairing is a
        # thing that can be exported: f32/bf16 storage computes in its own
        # dtype; int8 storage computes bf16 (dequantize-in-graph) or int8
        # (quant kernels). Anything else is a corrupt or forged manifest.
        allowed = ("bfloat16", "int8") if dtype == "int8" else (dtype,)
        if compute not in allowed:
            raise ValueError(
                f"manifest quantization.compute_dtype {compute!r} invalid "
                f"for storage dtype {dtype!r} (allowed: {allowed})"
            )
    scales = section.get("scales")
    if dtype == "int8":
        if not isinstance(scales, dict) or not scales:
            raise ValueError(
                "int8 manifest must carry non-empty quantization.scales "
                "metadata — an int8 recipe that quantized zero tensors is a "
                "broken export, not a precision"
            )
        for name, meta in scales.items():
            if not isinstance(meta, dict):
                raise ValueError(
                    f"quantization.scales[{name!r}] must be a dict"
                )
            shape = meta.get("shape")
            if not (
                isinstance(shape, list)
                and all(isinstance(d, int) and d > 0 for d in shape)
            ):
                raise ValueError(
                    f"quantization.scales[{name!r}].shape corrupt: {shape!r}"
                )
            for key in ("scale_min", "scale_max"):
                v = meta.get(key)
                if not isinstance(v, (int, float)) or not np.isfinite(v) or v <= 0:
                    raise ValueError(
                        f"quantization.scales[{name!r}].{key} corrupt: {v!r} "
                        "(scales are strictly positive finite floats)"
                    )
            if meta["scale_min"] > meta["scale_max"]:
                raise ValueError(
                    f"quantization.scales[{name!r}] corrupt: scale_min "
                    f"{meta['scale_min']} > scale_max {meta['scale_max']}"
                )
    elif scales:
        raise ValueError(
            f"quantization.scales present on a {dtype} manifest — only int8 "
            "artifacts carry scale metadata"
        )
    return section
