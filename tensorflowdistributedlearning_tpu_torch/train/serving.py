"""The serving closure and standalone serving artifacts (counterpart of the
JAX package's ``Trainer.serving_fn`` at ``train/trainer.py:929-996`` and of
``train/serving.py``).

An artifact directory holds:

    {dir}/manifest.json   the JAX package's manifest keys: input_shape (null
                          batch), input_dtype, outputs, format, platforms,
                          backbone, data_format
    {dir}/config.json     the ModelConfig
    {dir}/weights.pt      torch.save of the model's state_dict

Where the JAX artifact is serialized StableHLO with the weights baked in,
the port's is weights plus config: loading rebuilds the model from the
port's own code.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.train.step import SegmentationTask
from tensorflowdistributedlearning_tpu_torch.utils.devices import DeviceLike, resolve_device

MANIFEST_NAME = "manifest.json"
CONFIG_NAME = "config.json"
WEIGHTS_NAME = "weights.pt"
ARTIFACT_FORMAT = "torch state_dict + ModelConfig JSON"


def make_serving_fn(
    model: nn.Module,
    device: DeviceLike = None,
    *,
    data_format: str = "NHWC",
    task: Optional[SegmentationTask] = None,
) -> Callable:
    """``serve(images) -> {"probabilities", "mask"}`` for the preprocessed
    batch (normalized + Laplacian channel). ``images`` is a numpy array or a
    tensor, NHWC — or NCHW with ``data_format="NCHW"``, in which case the
    outputs come back ``[B, 1, H, W]``. Outputs are float32 tensors on
    ``device``; the head is the fused sigmoid-mask kernel."""
    if data_format not in ("NHWC", "NCHW"):
        raise ValueError(f"Unknown data format {data_format}. Has to be either NCHW or NHWC")
    device = resolve_device(device)
    model = model.to(device).eval()
    task = task or SegmentationTask()
    nchw = data_format == "NCHW"

    def serve(images) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
            x = x.to(device=device, dtype=torch.float32)
            if nchw:
                x = x.permute(0, 2, 3, 1)
            logits = model(x.contiguous())
            out = task.serve_predictions(logits)
            out = {k: v.float() for k, v in out.items()}
            if nchw:
                out = {k: v.permute(0, 3, 1, 2) for k, v in out.items()}
            return out

    return serve


def _output_signature(config: ModelConfig, data_format: str) -> Dict[str, Dict]:
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
) -> str:
    """Write ``model``'s serving artifact into ``directory``; returns the
    manifest path."""
    if data_format not in ("NHWC", "NCHW"):
        raise ValueError(f"Unknown data format {data_format}. Has to be either NCHW or NHWC")
    h, w = config.input_shape
    c = config.input_channels
    os.makedirs(directory, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(directory, WEIGHTS_NAME))
    with open(os.path.join(directory, CONFIG_NAME), "w") as f:
        f.write(config.to_json())
    manifest = {
        "input_shape": [None, c, h, w] if data_format == "NCHW" else [None, h, w, c],
        "input_dtype": "float32",
        "outputs": _output_signature(config, data_format),
        "format": ARTIFACT_FORMAT,
        "platforms": ["cuda"],
        "backbone": config.backbone,
        "data_format": data_format,
        **(metadata or {}),
    }
    path = os.path.join(directory, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2)
    return path


def read_manifest(directory: str) -> Dict:
    """Read an artifact manifest, applying the JAX package's legacy default
    (no ``input_dtype`` means float32)."""
    with open(os.path.join(directory, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    manifest.setdefault("input_dtype", "float32")
    manifest.setdefault("data_format", "NHWC")
    return manifest


def load_config(directory: str) -> ModelConfig:
    with open(os.path.join(directory, CONFIG_NAME)) as f:
        return ModelConfig.from_json(f.read())


def load_model(directory: str, device: DeviceLike = None) -> nn.Module:
    """Rebuild the artifact's model on ``device`` with its weights (strict)."""
    from tensorflowdistributedlearning_tpu_torch.models import build_model

    device = resolve_device(device)
    model = build_model(load_config(directory), device)
    state = torch.load(os.path.join(directory, WEIGHTS_NAME), map_location=device, weights_only=True)
    model.load_state_dict(state, strict=True)
    return model.eval()


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
    return make_serving_fn(load_model(directory, device), device, data_format=manifest["data_format"])
