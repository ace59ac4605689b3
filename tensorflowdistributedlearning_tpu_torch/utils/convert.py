"""Carry trained weights across from the JAX package.

:func:`from_flax` maps a flax ``params`` / ``batch_stats`` pair onto the
port's ``state_dict`` by name (the port's modules mirror the flax tree):

- conv kernels HWIO -> OIHW, conv biases as they are;
- depthwise kernels ``[kh, kw, 1, C]`` -> the kernel's ``[kh, kw, C]``;
- BN ``scale``/``bias`` -> ``weight``/``bias`` and batch stats
  ``mean``/``var`` -> ``running_mean``/``running_var``;
- for the ViT: Dense ``kernel [in, out]`` -> ``weight [out, in]``, LayerNorm
  ``scale``/``bias`` -> ``weight``/``bias``, ``pos_embedding`` as it is,
  the patch conv as any conv; its ``batch_stats`` are empty; an MoE
  layer's ``blockN/moe/{router, w_in, b_in, w_out, b_out}`` as they are
  (the port keeps flax's leaves and shapes);
- for the ResNet classifier: ``backbone/...`` as the segmenter's (basic
  blocks' ``preact``, ``shortcut``, ``conv1``, ``conv2`` included), the
  space-to-depth stem's canonical ``conv/kernel`` [3, 3, C, F] as any conv
  filter, and the Dense ``logits``.

Strict both ways: a flax leaf the port does not use, a port tensor left
unfilled, or a shape that disagrees raises. :func:`from_flax_train_state`
carries a whole JAX ``TrainState`` across (params, batch_stats and the
step), and :func:`load_optax_state` its optax Adam moments or SGD / LARS
momentum trace and parameter EMA, so both packages can train on from one
state, mid-trajectory too; :func:`from_flax_tensor_parallel` cuts such a
state, placed by the JAX package for tensor parallelism, to one rank's
channel slices. Inputs are nested dicts of numpy
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
from tensorflowdistributedlearning_tpu_torch.models import model_for
from tensorflowdistributedlearning_tpu_torch.models import vit
from tensorflowdistributedlearning_tpu_torch.models.layers import BatchNorm, DepthwiseConv2D


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
    elif isinstance(module, nn.Linear):
        yield "weight", "params", f"{path}/kernel", lambda a: a.T
        yield "bias", "params", f"{path}/bias", None
    elif isinstance(module, vit.LayerNorm):
        yield "weight", "params", f"{path}/scale", None
        yield "bias", "params", f"{path}/bias", None
    elif isinstance(module, vit.ViTClassifier):
        yield "pos_embedding", "params", "pos_embedding", None
    elif isinstance(module, vit.MoEMlp):
        for name in ("router", "w_in", "b_in", "w_out", "b_out"):
            yield name, "params", f"{path}/{name}", None
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


def _template(config: ModelConfig) -> nn.Module:
    with torch.device("meta"):
        return model_for(config)


def kernel_leaves(config: ModelConfig) -> Dict[str, Tuple[str, int]]:
    """``{port tensor: (flax params path, output-channel axis)}`` of every
    conv, depthwise and Dense filter of ``build_model(config)``: the leaves
    flax names ``kernel`` (``backbone.conv1_2.conv.weight`` ->
    ``backbone/conv1_2/conv/kernel``). The output channels are axis 0 of an
    OIHW conv filter and of a Dense ``[out, in]`` weight, and the last axis
    of a ``[kh, kw, C]`` depthwise one."""
    out: Dict[str, Tuple[str, int]] = {}
    for mod_path, module in _template(config).named_modules():
        for name, coll, leaf, _ in _sources(module, mod_path.replace(".", "/")):
            if coll == "params" and leaf.endswith("/kernel"):
                out[f"{mod_path}.{name}"] = (leaf, 0 if isinstance(module, (nn.Conv2d, nn.Linear)) else -1)
    return out


def from_flax(params, batch_stats, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU float32 tensors) for the flax
    ``params``/``batch_stats`` of ``build_model(config)``."""
    return _convert({"params": flatten(params), "batch_stats": flatten(batch_stats or {})}, config)


def params_from_flax(tree, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """``{port parameter name: tensor}`` for a tree shaped like flax's
    ``params`` (an optax slot: Adam's ``mu``/``nu``, a momentum
    ``trace``, an EMA), strictly, without the BN statistics."""
    return _convert({"params": flatten(tree)}, config)


def _convert(flat: Dict[str, Dict[str, np.ndarray]], config: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port tensors of ``flat``'s collections (``params`` and, when
    given, ``batch_stats``), strictly both ways."""
    used = {coll: set() for coll in flat}
    template = _template(config)
    expected = template.state_dict()
    if "batch_stats" not in flat:
        params = {name for name, _ in template.named_parameters()}
        expected = {k: v for k, v in expected.items() if k in params}
    state: Dict[str, torch.Tensor] = {}
    for mod_path, module in template.named_modules():
        flax_path = mod_path.replace(".", "/")
        prefix = f"{mod_path}." if mod_path else ""
        for name, coll, leaf, transform in _sources(module, flax_path):
            if coll not in flat:
                continue
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
    for coll in flat:
        unused = sorted(set(flat[coll]) - used[coll])
        if unused:
            raise ValueError(f"flax {coll} leaves the port does not use: {unused[:10]}")
    missing = sorted(set(expected) - set(state))
    if missing:
        raise ValueError(f"port tensors left unfilled: {missing[:10]}")
    return state


def from_flax_train_state(train_state, config: ModelConfig) -> Tuple[Dict[str, torch.Tensor], int]:
    """``(state_dict, step)`` of a JAX ``TrainState`` (anything with
    ``params``, ``batch_stats`` and ``step``; the ViT's ``batch_stats`` is
    empty): pass them to ``train.state.create_train_state(...,
    state_dict=, step=)``, then :func:`load_optax_state` to carry the
    optimizer's moments and the EMA across as well (without it a state with
    ``step > 0`` restarts its moments from zero)."""
    step = int(np.asarray(train_state.step))
    return from_flax(train_state.params, train_state.batch_stats, config), step


def _optax_nodes(node):
    """Every node of an optax state tree (namedtuples and tuples walked)."""
    yield node
    if isinstance(node, tuple):
        for child in node:
            yield from _optax_nodes(child)


def load_optax_state(state, opt_state, config: ModelConfig) -> None:
    """Carry an optax state into the port's ``TrainState`` ``state`` (in
    place), strictly. Its one optimizer slot:

    - a ``ScaleByAdamState`` (``mu``, ``nu``, ``count``) becomes
      ``torch.optim.Adam``/``AdamW``'s ``exp_avg``, ``exp_avg_sq`` and
      ``step`` of every parameter (both count the updates taken, so the
      bias corrections agree);
    - a ``TraceState`` (``trace``, the momentum of ``sgd`` and ``lars``)
      becomes ``torch.optim.SGD``'s ``momentum_buffer`` (optax's trace of
      the gradients, which SGD's buffer is) or :class:`train.step.Lars`'s
      ``trace`` (the trace of the lr-scaled updates, as optax keeps it);

    and an ``EmaTrackerState``'s ``ema`` the state's EMA; a ZeRO-1 state
    takes this rank's slices of each. Raises when the
    chain holds no such slot or more than one, when the port runs another
    optimizer, or when the two disagree on whether an EMA is tracked."""
    from tensorflowdistributedlearning_tpu_torch.train.step import Lars

    nodes = list(_optax_nodes(opt_state))
    adam = [n for n in nodes if all(hasattr(n, a) for a in ("mu", "nu", "count"))]
    traces = [n for n in nodes if type(n).__name__ == "TraceState"]
    emas = [n for n in nodes if type(n).__name__ == "EmaTrackerState"]
    if len(adam) + len(traces) != 1:
        raise ValueError(
            f"expected one ScaleByAdamState or TraceState in the optax state, found {len(adam)} and {len(traces)}"
        )
    port = type(state.optimizer).__name__
    if adam and not isinstance(state.optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        raise ValueError(f"the port's optimizer is {port}, not Adam/AdamW as the optax state's ScaleByAdamState")
    if traces and not isinstance(state.optimizer, (torch.optim.SGD, Lars)):
        raise ValueError(
            f"the optax state holds a momentum trace (the TraceState of sgd or lars), not the ScaleByAdamState "
            f"that the port's {port} takes"
        )
    if (state.ema is None) != (not emas):
        raise ValueError("the optax state and the port's state disagree on whether a parameter EMA is tracked")
    # the optimizer's leaves: the parameters, or under ZeRO-1 this rank's
    # slices of them (``parallel/zero.py``), whose slots are the same slices
    zero = state.zero
    leaves = zero.leaves if zero is not None else dict(state.model.named_parameters())

    def share(name: str, whole: torch.Tensor) -> torch.Tensor:
        whole = whole.to(leaves[name].device)
        return whole if zero is None else zero.slice(name, whole).clone()

    if adam:
        mu = params_from_flax(adam[0].mu, config)
        nu = params_from_flax(adam[0].nu, config)
        count = float(np.asarray(adam[0].count))
        for name, p in leaves.items():
            state.optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": share(name, mu[name]),
                "exp_avg_sq": share(name, nu[name]),
            }
    else:
        trace = params_from_flax(traces[0].trace, config)
        key = "trace" if isinstance(state.optimizer, Lars) else "momentum_buffer"
        for name, p in leaves.items():
            state.optimizer.state[p] = {key: share(name, trace[name])}
    if emas:
        ema = params_from_flax(emas[0].ema, config)
        with torch.no_grad():
            for name, e in state.ema.items():
                e.copy_(share(name, ema[name]))


def from_flax_tensor_parallel(train_state, config: ModelConfig, tp: int, model_index: int) -> Tuple[
        Dict[str, torch.Tensor], int]:
    """``(state_dict, step)`` of model index ``model_index`` of ``tp``: a
    JAX ``TrainState`` placed for tensor parallelism (its leaves global
    arrays, which ``np.asarray`` reads whole, or host arrays) carried
    across (:func:`from_flax_train_state`) and cut to that rank's channel
    slices (``parallel/tensor.py``), the elements of JAX's shard on each
    device of that model index."""
    from tensorflowdistributedlearning_tpu_torch.parallel import tensor as tensor_lib

    state_dict, step = from_flax_train_state(train_state, config)
    layout = tensor_lib.TensorParallelLayout(tensor_lib.tensor_parallel_specs(_template(config), tp), tp, model_index)
    return {k: v.clone() for k, v in layout.slice_state_dict(state_dict).items()}, step
