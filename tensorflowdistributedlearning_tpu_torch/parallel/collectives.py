"""Collectives of the data-parallel step (counterpart of the JAX package's
``parallel/collectives.py``).

The JAX package reduces over a named mesh axis with ``lax.psum`` /
``lax.pmean`` inside ``shard_map``; here a rank is a process that owns one
device, and the same reductions are explicit ``torch.distributed``
all-reduces over the default process group. Every function is a no-op when
no group is initialized (one process), so the single-device step pays
nothing.

ZeRO-1's parameter gather is :func:`all_gather` of one flat buffer.

A list of tensors is reduced as one collective: the tensors of one dtype are
packed into a flat buffer, all-reduced and copied back. The trainer keeps its
gradients in such a buffer from the start (:func:`flat_grad_buffer`), so a
step all-reduces its gradient once, not once per parameter.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import torch
import torch.distributed as dist

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def is_initialized() -> bool:
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The ranks of the default group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def collective_device() -> torch.device:
    """Where a tensor made for a collective lives: the current CUDA device
    under NCCL (which reduces only CUDA tensors), the CPU otherwise."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _as_list(tensors: Tensors) -> List[torch.Tensor]:
    return [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)


def _reduce_(tensors: Tensors, op) -> None:
    """All-reduce ``tensors`` in place with ``op``, one collective per
    (dtype, device) group."""
    tensors = _as_list(tensors)
    if len(tensors) == 1 and tensors[0].is_contiguous():
        dist.all_reduce(tensors[0], op=op)
        return
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=op)
        offset = 0
        for t in group:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def psum_(tensors: Tensors) -> None:
    """Sum ``tensors`` over every rank, in place (the metric reduction,
    ``lax.psum``)."""
    if is_initialized():
        _reduce_(tensors, dist.ReduceOp.SUM)


def pmean_(tensors: Tensors) -> None:
    """Mean of ``tensors`` over every rank, in place (the gradient and
    BN-statistics reduction, ``lax.pmean``): a sum, then a divide by the
    world size."""
    if not is_initialized():
        return
    tensors = _as_list(tensors)
    _reduce_(tensors, dist.ReduceOp.SUM)
    w = float(world_size())
    for t in tensors:
        t.div_(w)


def pmax_(tensors: Tensors) -> None:
    """Elementwise maximum of ``tensors`` over every rank, in place."""
    if is_initialized():
        _reduce_(tensors, dist.ReduceOp.MAX)


def broadcast_(tensors: Tensors, src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s values, in place, one
    collective per dtype. Tensors the backend cannot carry (a CPU tensor
    under NCCL, e.g. an optimizer's step count) are staged through
    :func:`collective_device`."""
    if not is_initialized():
        return
    device = collective_device()
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in _as_list(tensors):
        groups.setdefault(t.dtype, []).append(t)
    for dtype, group in groups.items():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in group])
        dist.broadcast(flat, src=src)
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset : offset + t.numel()].view(t.shape))
                offset += t.numel()


def all_gather(flat: torch.Tensor) -> torch.Tensor:
    """Every rank's ``flat`` (one dimension, the same size on every rank) as
    the rows of a ``[world, n]`` tensor on ``flat``'s device, one
    collective (ZeRO-1's parameter gather). Under a backend that cannot
    carry ``flat`` where it lies (gloo, for ranks that share a card) the
    collective runs on :func:`collective_device` and the result is copied
    back."""
    if not is_initialized():
        return flat.reshape(1, -1)
    device = collective_device()
    send = flat if flat.device == device else flat.to(device)
    out = torch.empty((world_size(), flat.numel()), dtype=flat.dtype, device=device)
    dist.all_gather(list(out.unbind(0)), send)
    return out if out.device == flat.device else out.to(flat.device)


class _PMean(torch.autograd.Function):
    """y = (1/W) Σ_s x_s on every rank. Each rank's loss reads y, and the
    step's objective is the mean of the ranks' losses, so the cotangent of
    x_r is (1/W) Σ_s dL_s/dy: the backward is the same mean."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        pmean_(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.contiguous().clone()
        pmean_(g)
        return g


def pmean(x: torch.Tensor) -> torch.Tensor:
    """Differentiable mean of ``x`` over every rank (synchronized BatchNorm's
    statistics): ``x`` itself without a group."""
    return _PMean.apply(x) if is_initialized() else x


def flat_grad_buffer(params: Sequence[torch.nn.Parameter]) -> torch.Tensor:
    """One zeroed buffer for the gradients of ``params`` (one dtype and
    device), with every ``.grad`` set to a view of it. Backward accumulates
    into the views in place, so the buffer holds the step's whole gradient
    for one all-reduce; zero it (do not set ``.grad`` to None) between
    steps."""
    params = list(params)
    dtypes = {(p.dtype, p.device) for p in params}
    if len(dtypes) != 1:
        raise ValueError(f"a flat gradient buffer needs one dtype and device, got {sorted(map(str, dtypes))}")
    flat = torch.zeros(sum(p.numel() for p in params), dtype=params[0].dtype, device=params[0].device)
    offset = 0
    for p in params:
        p.grad = flat[offset : offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat
