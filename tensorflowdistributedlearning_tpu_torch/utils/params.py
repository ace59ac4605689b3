"""Parameter counting (counterpart of the JAX package's
``utils/params.py``)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaves(tree: Any):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def count_params(params: Any) -> int:
    """Total number of scalar parameters in ``params``: a module's
    parameters, or the leaves with a ``shape`` of a nest of dicts, lists
    and tuples (tensors, arrays, the planner's abstract leaves)."""
    return int(sum(int(np.prod(tuple(x.shape), dtype=np.int64)) for x in _leaves(params)))
