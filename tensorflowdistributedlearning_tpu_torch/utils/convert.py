"""Carry trained weights across from the JAX package.

:func:`from_flax` maps a flax ``params`` / ``batch_stats`` pair onto the
port's ``state_dict`` by name (the port's modules mirror the flax tree):

- conv kernels HWIO -> OIHW, conv biases as they are;
- depthwise kernels ``[kh, kw, 1, C]`` -> the kernel's ``[kh, kw, C]``;
- BN ``scale``/``bias`` -> ``weight``/``bias`` and batch stats
  ``mean``/``var`` -> ``running_mean``/``running_var``.

Strict both ways: a flax leaf the port does not use, a port tensor left
unfilled, or a shape that disagrees raises. Inputs are nested dicts of numpy
arrays or flat ``"a/b/c"``-keyed mappings (what :func:`load_flax_npz` reads
from an ``.npz`` that holds ``flatten_dict({"params": ..., "batch_stats":
...}, sep="/")``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.config import ModelConfig
from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, DepthwiseConv2D
from tensorflowdistributedlearning_tpu_torch.models.resnet import ResNetSegmentation


def flatten(tree) -> Dict[str, np.ndarray]:
    """Nested mapping (or a flat one with ``"/"``-joined or tuple keys) ->
    ``{"a/b/c": array}``."""
    out: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                key = "/".join(k) if isinstance(k, tuple) else str(k)
                walk(f"{prefix}/{key}" if prefix else key, v)
        else:
            out[prefix] = np.asarray(node)

    walk("", tree)
    return out


def load_flax_npz(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Read an ``.npz`` of ``"params/..."`` and ``"batch_stats/..."`` keys;
    returns the two flat mappings with those prefixes stripped."""
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    with np.load(path) as data:
        for key in data.files:
            head, _, rest = key.partition("/")
            if head == "params":
                params[rest] = data[key]
            elif head == "batch_stats":
                stats[rest] = data[key]
            else:
                raise ValueError(f"{path}: key {key!r} is neither params/... nor batch_stats/...")
    return params, stats


def _sources(module: nn.Module, path: str):
    """``(port tensor name, collection, flax leaf path, transform)`` for the
    tensors ``module`` owns directly."""
    if isinstance(module, nn.Conv2d):
        yield "weight", "params", f"{path}/kernel", lambda a: a.transpose(3, 2, 0, 1)
        if module.bias is not None:
            yield "bias", "params", f"{path}/bias", None
    elif isinstance(module, DepthwiseConv2D):
        yield "weight", "params", f"{path}/kernel", lambda a: _squeeze_depthwise(a, path)
        yield "bias", "params", f"{path}/bias", None
    elif isinstance(module, BatchNorm):
        if module.weight is not None:
            yield "weight", "params", f"{path}/scale", None
        yield "bias", "params", f"{path}/bias", None
        yield "running_mean", "batch_stats", f"{path}/mean", None
        yield "running_var", "batch_stats", f"{path}/var", None


def _squeeze_depthwise(a: np.ndarray, path: str) -> np.ndarray:
    if a.ndim != 4 or a.shape[2] != 1:
        raise ValueError(f"{path}/kernel: expected a depthwise [kh, kw, 1, C] kernel, got {a.shape}")
    return a[:, :, 0, :]


def from_flax(params, batch_stats, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU float32 tensors) for the flax
    ``params``/``batch_stats`` of ``build_model(config)``."""
    flat = {"params": flatten(params), "batch_stats": flatten(batch_stats)}
    used = {"params": set(), "batch_stats": set()}
    with torch.device("meta"):
        template = ResNetSegmentation(config)
    expected = template.state_dict()
    state: Dict[str, torch.Tensor] = {}
    for mod_path, module in template.named_modules():
        flax_path = mod_path.replace(".", "/")
        prefix = f"{mod_path}." if mod_path else ""
        for name, coll, leaf, transform in _sources(module, flax_path):
            key = prefix + name
            if leaf not in flat[coll]:
                raise KeyError(f"flax {coll} has no {leaf!r} for port tensor {key!r}")
            arr = flat[coll][leaf]
            if transform is not None:
                arr = transform(arr)
            if tuple(arr.shape) != tuple(expected[key].shape):
                raise ValueError(
                    f"{coll}/{leaf} -> {key}: shape {tuple(arr.shape)} != port {tuple(expected[key].shape)}"
                )
            state[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
            used[coll].add(leaf)
    for coll in ("params", "batch_stats"):
        unused = sorted(set(flat[coll]) - used[coll])
        if unused:
            raise ValueError(f"flax {coll} leaves the port does not use: {unused[:10]}")
    missing = sorted(set(expected) - set(state))
    if missing:
        raise ValueError(f"port tensors left unfilled: {missing[:10]}")
    return state
