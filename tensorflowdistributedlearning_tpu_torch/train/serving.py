"""The serving closure and standalone serving artifacts (counterpart of the
JAX package's ``Trainer.serving_fn`` at ``train/trainer.py:929-996``,
``ClassifierTrainer.serving_fn`` / ``export_serving`` at
``train/fit.py:1016-1102``, and of ``train/serving.py``).

The task follows the config: a model with ``num_classes`` (the ViT or the
ResNet classifier) serves ``{"probabilities" [B, num_classes] float32, "class" [B]
int32}`` and its manifest carries the JAX classifier's metadata keys
(``task``, ``num_classes``, ``backbone``); the segmenter serves
``{"probabilities", "mask"}`` and its manifest is what it was.

An artifact directory holds:

    {dir}/manifest.json   the JAX package's manifest keys: input_shape (null
                          batch), input_dtype, outputs, format, platforms,
                          backbone, data_format, and the ``quantization``
                          section of ``train/quantize.py``
    {dir}/config.json     the ModelConfig
    {dir}/weights.pt      torch.save of the serving spec's state: the float32
                          ``state_dict``; bf16 tensors (``bfloat16``); or
                          ``{"q" int8, "scale" f32}`` records for the filters
                          and bf16 for the rest (``int8``, ``int8-compute``)

Where the JAX artifact is serialized StableHLO with the weights baked in,
the port's is weights plus config: loading rebuilds the model from the
port's own code, per spec (:func:`serving_model`). The wire contract is the
same for every spec: float32 in, float32 out.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.train import quantize
from tensorflowdistributedlearning_tpu_torch.train.step import task_for
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike, resolve_device

MANIFEST_NAME = "manifest.json"
CONFIG_NAME = "config.json"
WEIGHTS_NAME = "weights.pt"
ARTIFACT_FORMAT = "torch state_dict + ModelConfig JSON"


def serving_model(config: ModelConfig, qstate: Mapping[str, Any], section: Mapping[str, Any],
                  device: DeviceLike = None) -> nn.Module:
    """The eval-mode model that serves ``qstate`` (``quantize_state``'s
    output) under its section's spec, on ``device`` (allocated without an
    init draw, then loaded strictly):

    - ``float32``: the state as it is;
    - other specs: BatchNorm parameters and statistics stay bf16 (flax's
      BN arithmetic with bf16 statistics); every conv and depthwise filter
      and bias holds its bf16 (int8: dequantized ``q * scale`` in bf16)
      value in float32, the promotion flax applies at each call;
    - ``int8-compute`` (``compute_dtype`` int8): then every eligible conv
      becomes an int8-arithmetic ``QuantConv2d`` and every Dense a
      ``QuantLinear`` from its record, returning bf16.

    The ViT has no BatchNorm: its parameters hold their bf16 (int8:
    dequantized) values in float32, which is what flax computes with once
    it promotes or casts them at each call."""
    from tensorflowdistributedlearning_tpu_torch.models import empty_model
    from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm
    from tensorflowdistributedlearning_tpu_torch.ops import quant_kernels

    model = empty_model(config, device)
    dense = quantize.dequantize(qstate)
    if section.get("dtype", "float32") != "float32":
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.to(torch.bfloat16)
    model.load_state_dict(dense, strict=True)
    if section.get("compute_dtype") == "int8":
        records = {k: v for k, v in qstate.items() if quantize.is_record(v)}
        quant_kernels.swap_int8_layers(model, records, dense)
    return model.eval()


def make_serving_fn(
    model: nn.Module,
    device: DeviceLike = None,
    *,
    data_format: str = "NHWC",
    task=None,
    act_dtype: torch.dtype = torch.float32,
) -> Callable:
    """``serve(images) -> outputs`` for the preprocessed batch: the task's
    serving head (``task_for(model.config)`` when ``task`` is None). The
    segmenter answers ``{"probabilities", "mask"}`` through the fused
    sigmoid-mask kernel, the classifier ``{"probabilities", "class"}``.
    ``images`` is a numpy array or a tensor, NHWC — or NCHW with
    ``data_format="NCHW"``, in which case per-pixel outputs come back
    ``[B, 1, H, W]``. The images enter the model in ``act_dtype``
    (``quantize.compute_dtype`` of the spec). Float outputs are float32
    tensors on ``device``; ``class`` stays int32."""
    if data_format not in ("NHWC", "NCHW"):
        raise ValueError(f"Unknown data format {data_format}. Has to be either NCHW or NHWC")
    device = resolve_device(device)
    model = model.to(device).eval()
    task = task or task_for(model.config)
    nchw = data_format == "NCHW"

    def serve(images) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
            x = x.to(device=device, dtype=torch.float32)
            if nchw:
                x = x.permute(0, 2, 3, 1)
            logits = model(x.to(act_dtype).contiguous())
            out = quantize.cast_outputs_float32(task.serve_predictions(logits))
            if nchw:
                out = {k: v.permute(0, 3, 1, 2) if v.dim() == 4 else v for k, v in out.items()}
            return out

    return serve


def _output_signature(config: ModelConfig, data_format: str) -> Dict[str, Dict]:
    if config.num_classes is not None:
        return {
            "probabilities": {"shape": [None, config.num_classes], "dtype": "float32"},
            "class": {"shape": [None], "dtype": "int32"},
        }
    h, w = config.input_shape
    shape = [None, 1, h, w] if data_format == "NCHW" else [None, h, w, 1]
    return {name: {"shape": shape, "dtype": "float32"} for name in ("probabilities", "mask")}


def export_serving_artifact(
    model: nn.Module,
    config: ModelConfig,
    directory: str,
    *,
    data_format: str = "NHWC",
    metadata: Optional[Dict] = None,
    serving_dtype: str = "float32",
) -> str:
    """Write the serving artifact of ``model``'s float32 weights under the
    spec ``serving_dtype`` into ``directory``; returns the manifest path."""
    if data_format not in ("NHWC", "NCHW"):
        raise ValueError(f"Unknown data format {data_format}. Has to be either NCHW or NHWC")
    h, w = config.input_shape
    c = config.input_channels
    os.makedirs(directory, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    qstate, section = quantize.quantize_state(state, serving_dtype, config)
    torch.save(qstate, os.path.join(directory, WEIGHTS_NAME))
    with open(os.path.join(directory, CONFIG_NAME), "w") as f:
        f.write(config.to_json())
    manifest = {
        "input_shape": [None, c, h, w] if data_format == "NCHW" else [None, h, w, c],
        "input_dtype": "float32",
        "outputs": _output_signature(config, data_format),
        "format": ARTIFACT_FORMAT,
        "platforms": ["cuda"],
        **({"task": "classification", "num_classes": config.num_classes} if config.num_classes is not None else {}),
        "backbone": config.backbone,
        "data_format": data_format,
        "quantization": section,
        **(metadata or {}),
    }
    path = os.path.join(directory, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def read_manifest(directory: str) -> Dict:
    """Read and validate an artifact manifest, applying the JAX package's
    legacy defaults: no ``input_dtype`` means float32, no ``quantization``
    section an unquantized float32 model, a section without
    ``compute_dtype`` the storage dtype's own arithmetic. Corrupt
    quantization metadata raises ``ValueError``."""
    with open(os.path.join(directory, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    manifest.setdefault("input_dtype", "float32")
    manifest.setdefault("data_format", "NHWC")
    if "quantization" in manifest:
        quantize.validate_quantization(manifest["quantization"])
        q = manifest["quantization"]
        if "compute_dtype" not in q and q.get("dtype") in quantize.SERVING_DTYPES:
            q["compute_dtype"] = quantize.default_compute_dtype(q["dtype"])
    return manifest


def serving_spec(manifest: Mapping[str, Any]) -> str:
    """The serving spec a (read) manifest declares
    (:func:`quantize.spec_of`)."""
    return quantize.spec_of(manifest.get("quantization"))


def load_config(directory: str) -> ModelConfig:
    with open(os.path.join(directory, CONFIG_NAME)) as f:
        return ModelConfig.from_json(f.read())


def load_model(directory: str, device: DeviceLike = None) -> nn.Module:
    """Rebuild the artifact's model on ``device`` with its weights (strict),
    under the manifest's serving spec (:func:`serving_model`)."""
    manifest = read_manifest(directory)
    section = manifest.get("quantization") or {"dtype": "float32", "compute_dtype": "float32"}
    state = torch.load(os.path.join(directory, WEIGHTS_NAME), map_location="cpu", weights_only=True)
    return serving_model(load_config(directory), state, section, device)


def load_serving_artifact(directory: str, device: DeviceLike = None) -> Callable:
    """``serve(images) -> outputs`` for an exported artifact, on ``device``
    (CUDA when None; raises without it)."""
    manifest = read_manifest(directory)
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise ValueError(
            f"{directory}: artifact format {manifest.get('format')!r} is not "
            f"the port's ({ARTIFACT_FORMAT!r})"
        )
    if manifest["input_dtype"] != "float32":
        raise NotImplementedError(f"input_dtype {manifest['input_dtype']!r}: float32 only in this slice")
    device = resolve_device(device)
    return make_serving_fn(
        load_model(directory, device), device, data_format=manifest["data_format"],
        act_dtype=quantize.compute_dtype(serving_spec(manifest)),
    )
