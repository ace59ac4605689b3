"""Collectives of the data- and tensor-parallel steps (counterpart of the
JAX package's ``parallel/collectives.py``).

The JAX package reduces over a named mesh axis with ``lax.psum`` /
``lax.pmean`` inside ``shard_map``; here a rank is a process that owns one
device, and the same reductions are explicit ``torch.distributed``
collectives over a group: ``group=None`` is the default group (every
rank), and a mesh axis is one of ``parallel/mesh.py``'s groups. Every
function is a no-op when no process group is initialized (one process) or
the group holds one rank, so the single-device step pays nothing.

ZeRO-1's parameter gather is :func:`all_gather` of one flat buffer. The
pipeline's activations and their cotangents move between neighbouring
stages by :func:`send` and :func:`recv` (point to point, staged through
the host under gloo like :func:`all_gather`). The
tensor-parallel layers (``parallel/tensor.py``) go through three
differentiable collectives over the model group: :func:`gather_channels`
(the all-gather of a layer's output channels; backward, this rank's slice
of the cotangent), :func:`mark_replicated` (identity; backward, the sum of
the group's cotangents) and :func:`slice_channels` (this rank's channels of
a replicated input; backward, the all-gather of the cotangent). Under gloo
a collective of a CUDA tensor is staged through the host, as
:func:`all_gather` does. Expert parallelism (``parallel/expert.py``)
moves its dispatch buffers with :func:`all_to_all`, whose backward is the
same all-to-all of the cotangent.

The sequence axis (``parallel/spatial.py``, ``parallel/ring_attention.py``)
adds four differentiable collectives whose backward is the transpose of
the forward map, as JAX's autodiff transposes ``ppermute``,
``all_gather`` and ``psum_scatter``: :func:`shift` (each rank's tensor to
the rank ``offset`` after it in the group, as an open chain whose ends
receive zeros or as a ring; backward, the opposite shift),
:func:`all_gather_dim` (the group's blocks concatenated along one
dimension; backward, the sum of every rank's cotangent, this rank's block
of it), :func:`reduce_scatter` (the sum over the group, this rank's block;
backward, the all-gather of the cotangent) and :func:`ring_all_gather`
(the all-gather as n - 1 ring shifts). A shift posts its send and its
receive together (``dist.batch_isend_irecv``), so a ring of them cannot
deadlock; at degree 2 the next and the previous rank are one rank.

A list of tensors is reduced as one collective: the tensors of one dtype are
packed into a flat buffer, all-reduced and copied back. The trainer keeps its
gradients in such a buffer from the start (:func:`flat_grad_buffer`), so a
step all-reduces its gradient once, not once per parameter.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def is_initialized() -> bool:
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """The ranks of ``group`` (default: the default group; 1 without one)."""
    return dist.get_world_size(group) if is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def _active(group) -> bool:
    """Whether a collective over ``group`` has anything to do."""
    return is_initialized() and dist.get_world_size(group) > 1


def collective_device() -> torch.device:
    """Where a tensor made for a collective lives: the current CUDA device
    under NCCL (which reduces only CUDA tensors), the CPU otherwise."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _as_list(tensors: Tensors) -> List[torch.Tensor]:
    return [tensors] if isinstance(tensors, torch.Tensor) else list(tensors)


def _gloo() -> bool:
    return is_initialized() and dist.get_backend() == "gloo"


def _reduce_(tensors: Tensors, op, group=None) -> None:
    """All-reduce ``tensors`` in place with ``op`` over ``group``, one
    collective per (dtype, device) group. Under gloo a bfloat16 group is
    reduced in float32 and rounded back once (gloo reduces no bfloat16 on
    every build)."""
    tensors = _as_list(tensors)
    if _gloo() and any(t.dtype == torch.bfloat16 for t in tensors):
        wide = [t.float() if t.dtype == torch.bfloat16 else t for t in tensors]
        _reduce_(wide, op, group)
        for t, f in zip(tensors, wide):
            if f is not t:
                t.copy_(f)
        return
    if len(tensors) == 1 and tensors[0].is_contiguous():
        dist.all_reduce(tensors[0], op=op, group=group)
        return
    by_kind: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for members in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in members])
        dist.all_reduce(flat, op=op, group=group)
        offset = 0
        for t in members:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def psum_(tensors: Tensors, group=None) -> None:
    """Sum ``tensors`` over the ranks of ``group``, in place (the metric
    reduction, ``lax.psum``)."""
    if _active(group):
        _reduce_(tensors, dist.ReduceOp.SUM, group)


def pmean_(tensors: Tensors, group=None) -> None:
    """Mean of ``tensors`` over the ranks of ``group``, in place (the
    gradient and BN-statistics reduction, ``lax.pmean``): a sum, then a
    divide by the group's size."""
    if not _active(group):
        return
    tensors = _as_list(tensors)
    _reduce_(tensors, dist.ReduceOp.SUM, group)
    w = float(world_size(group))
    for t in tensors:
        t.div_(w)


def pmax_(tensors: Tensors, group=None) -> None:
    """Elementwise maximum of ``tensors`` over the ranks of ``group``, in
    place."""
    if _active(group):
        _reduce_(tensors, dist.ReduceOp.MAX, group)


def broadcast_(tensors: Tensors, src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` with global rank ``src``'s values (a member of
    ``group``), in place, one collective per dtype. Tensors the backend
    cannot carry (a CPU tensor under NCCL, e.g. an optimizer's step count)
    are staged through :func:`collective_device`."""
    if not _active(group):
        return
    device = collective_device()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in _as_list(tensors):
        by_dtype.setdefault(t.dtype, []).append(t)
    for members in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in members])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        with torch.no_grad():
            for t in members:
                t.copy_(flat[offset : offset + t.numel()].view(t.shape))
                offset += t.numel()


def all_gather(flat: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``flat`` (one dimension, the same size on every rank of
    ``group``) as the rows of a ``[ranks, n]`` tensor on ``flat``'s device,
    in the group's rank order, one collective (ZeRO-1's parameter gather).
    Under a backend that cannot carry ``flat`` where it lies (gloo, for
    ranks that share a card) the collective runs on
    :func:`collective_device` and the result is copied back."""
    if not _active(group):
        return flat.reshape(1, -1)
    if flat.dtype == torch.bfloat16 and _gloo():
        # the bytes travel (a copy carries no arithmetic; gloo moves no
        # bfloat16 on every build)
        return _gather_rows(flat.contiguous().view(torch.uint8), group).view(torch.bfloat16)
    return _gather_rows(flat, group)


def _gather_rows(flat: torch.Tensor, group) -> torch.Tensor:
    device = collective_device()
    send = flat if flat.device == device else flat.to(device)
    out = torch.empty((world_size(group), flat.numel()), dtype=flat.dtype, device=device)
    dist.all_gather(list(out.unbind(0)), send.contiguous(), group=group)
    return out if out.device == flat.device else out.to(flat.device)


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Send ``t`` to global rank ``dst`` (a member of ``group``); returns
    when the backend has taken it. Under a backend that cannot carry ``t``
    where it lies (gloo, for ranks that share a card) it goes through
    :func:`collective_device`."""
    device = collective_device()
    dist.send(t.detach().to(device).contiguous(), dst, group=group)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device holding what global
    rank ``src`` (a member of ``group``) sent with :func:`send`."""
    device = collective_device()
    out = torch.empty(like.shape, dtype=like.dtype, device=device)
    dist.recv(out, src, group=group)
    return out if out.device == like.device else out.to(like.device)


def gather_blocks(items: Sequence[Tuple[torch.Tensor, int]], group=None) -> List[torch.Tensor]:
    """The whole tensors of ``(this rank's block, its dimension)`` pairs:
    block r of each from rank r of ``group``, one all-gather per (dtype,
    device). Every rank of the group calls it with the same shapes in the
    same order."""
    n = world_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(items)
    by_kind: Dict[tuple, List[int]] = {}
    for i, (t, _) in enumerate(items):
        by_kind.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_kind.values():
        blocks = all_gather(torch.cat([items[i][0].reshape(-1) for i in idx]), group)
        offset = 0
        for i in idx:
            t, dim = items[i]
            k = t.shape[dim]
            shape = list(t.shape)
            shape[dim] = k * n
            whole = torch.empty(shape, dtype=t.dtype, device=t.device)
            for r in range(n):
                whole.narrow(dim, r * k, k).copy_(blocks[r, offset:offset + t.numel()].view(t.shape))
            out[i] = whole
            offset += t.numel()
    return out


def _all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated on the last dimension,
    in the group's rank order."""
    n = world_size(group)
    blocks = all_gather(x.reshape(-1), group).view((n,) + tuple(x.shape))
    return blocks.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (n * x.shape[-1],))


def _own_block(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the last dimension of ``x`` (the group's size
    blocks, in its rank order), contiguous."""
    k = x.shape[-1] // world_size(group)
    return x.narrow(-1, dist.get_rank(group) * k, k).contiguous()


class _GatherChannels(torch.autograd.Function):
    """y = the concatenation of the group's x on the last dimension. Every
    rank's loss reads the whole y the same way, so the cotangent of x is
    this rank's block of the cotangent of y."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _own_block(g, ctx.group), None


def _all_to_all_single(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of axis 0 of ``x`` (the group's size equal blocks) sent to
    rank j of ``group``; the blocks received, in the group's rank order, on
    axis 0. Under a backend that cannot carry ``x`` where it lies it runs
    on :func:`collective_device`. The blocks travel as bytes (a copy
    carries no arithmetic, and gloo moves no bf16)."""
    device = collective_device()
    send = x.detach().to(device).contiguous().view(torch.uint8)
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    out = out.view(x.dtype)
    return out if out.device == x.device else out.to(x.device)


class _AllToAll(torch.autograd.Function):
    """y = the all-to-all of x over axis 0 (``lax.all_to_all(x, split_axis=0,
    concat_axis=0)``): block j of this rank's x becomes block r of rank j's
    y. The blocks are equal, so the map is a permutation of the group's
    blocks, and its transpose, the cotangent of x, is the same all-to-all
    of the cotangent of y."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _all_to_all_single(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_to_all_single(g, ctx.group), None


class _MarkReplicated(torch.autograd.Function):
    """y = x, where x is the same on every rank of the group and each
    rank's y feeds its own output channels: the cotangent of x is the sum
    of the ranks' cotangents of y."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        psum_(g, ctx.group)
        return g, None


class _SliceChannels(torch.autograd.Function):
    """y = this rank's block of the last dimension of x (x the same on
    every rank of the group): the cotangent of x is the concatenation of
    the ranks' cotangents of y."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return _own_block(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_gather_last(g.contiguous(), ctx.group), None


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather of the last dimension over ``group``."""
    return _GatherChannels.apply(x, group) if _active(group) else x


def mark_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums the cotangent over ``group``."""
    return _MarkReplicated.apply(x, group) if _active(group) else x


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-to-all of axis 0 over ``group`` (its size must
    divide axis 0): ``x`` itself without a group."""
    if not _active(group):
        return x
    if x.shape[0] % world_size(group):
        raise ValueError(f"all_to_all: axis 0 of {tuple(x.shape)} does not split over {world_size(group)} ranks")
    return _AllToAll.apply(x, group)


def slice_channels(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the last dimension, whose backward all-gathers
    the cotangent over ``group``."""
    return _SliceChannels.apply(x, group) if _active(group) else x


class _PMean(torch.autograd.Function):
    """y = (1/W) Σ_s x_s on every rank of the group. Each rank's loss reads
    y, and the step's objective is the mean of the ranks' losses, so the
    cotangent of x_r is (1/W) Σ_s dL_s/dy: the backward is the same mean."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        pmean_(y, group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        pmean_(g, ctx.group)
        return g, None


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable mean of ``x`` over the ranks of ``group``
    (synchronized BatchNorm's statistics): ``x`` itself without a group."""
    return _PMean.apply(x, group) if _active(group) else x


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


# -- the sequence axis: ring shifts and blockwise gathers ---------------------


def _global_rank(group, r: int) -> int:
    """The global rank of rank ``r`` of ``group`` (None: the default group)."""
    return r if group is None else dist.get_global_rank(group, r)


def _p2p(x: torch.Tensor, dst: Optional[int], src: Optional[int], group) -> Optional[torch.Tensor]:
    """Send ``x`` to rank ``dst`` of ``group`` and receive a tensor of its
    shape and dtype from rank ``src``, both posted before either is waited
    on (None: no such half). The payload travels as bytes through
    :func:`collective_device` (a copy carries no arithmetic, and gloo moves
    no bf16). Returns what was received on ``x``'s device, or None."""
    device = collective_device()
    ops, out = [], None
    nbytes = x.numel() * x.element_size()
    if src is not None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=device)
        ops.append(dist.P2POp(dist.irecv, out, _global_rank(group, src), group))
    if dst is not None:
        payload = x.detach().to(device).contiguous().reshape(-1).view(torch.uint8)
        ops.append(dist.P2POp(dist.isend, payload, _global_rank(group, dst), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if out is None:
        return None
    out = out.view(x.dtype).view(x.shape)
    return out if out.device == x.device else out.to(x.device)


def _shift_value(x: torch.Tensor, offset: int, ring: bool, group) -> torch.Tensor:
    """Rank r's result: rank ``r - offset``'s ``x`` (modulo the group's
    size on a ring; zeros where the open chain has no such rank)."""
    n, r = world_size(group), dist.get_rank(group)
    dst, src = r + offset, r - offset
    if ring:
        dst, src = dst % n, src % n
    else:
        dst = dst if 0 <= dst < n else None
        src = src if 0 <= src < n else None
    got = _p2p(x, dst, src, group)
    return torch.zeros_like(x) if got is None else got


class _Shift(torch.autograd.Function):
    """y_r = x_{r - offset} (ring: modulo n; open chain: 0 off its ends).
    The map moves blocks between ranks, so its transpose moves the
    cotangents back: the same shift by ``-offset``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, offset: int, ring: bool) -> torch.Tensor:
        ctx.group, ctx.offset, ctx.ring = group, offset, ring
        return _shift_value(x, offset, ring, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _shift_value(g.contiguous(), -ctx.offset, ctx.ring, ctx.group), None, None, None


def shift(x: torch.Tensor, group=None, *, offset: int = 1, ring: bool = False) -> torch.Tensor:
    """Differentiable shift over ``group``: rank r receives rank ``r -
    offset``'s ``x`` (``lax.ppermute`` with the pairs ``(i, i + offset)``).
    ``ring`` wraps around; the open chain gives the ranks with no sender
    zeros (the halo exchange's boundary). Without a group the ring is the
    identity and the open chain zeros."""
    if not _active(group):
        return x if ring else torch.zeros_like(x)
    return _Shift.apply(x, group, int(offset), bool(ring))


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in its rank order."""
    n = world_size(group)
    # as bytes: a gather carries no arithmetic, and gloo moves no bf16
    raw = all_gather(x.contiguous().reshape(-1).view(torch.uint8), group)
    blocks = raw.view(x.dtype).view((n,) + tuple(x.shape))
    shape = list(x.shape)
    shape[dim] *= n
    return blocks.movedim(0, dim).reshape(shape)


def _sum_own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the group's ``x``
    (one all-reduce through :func:`collective_device`, then the block)."""
    device = collective_device()
    # a 16-bit sum is taken in float32 and rounded once
    wide = torch.float32 if x.element_size() < 4 and x.is_floating_point() else x.dtype
    total = x.detach().to(device=device, dtype=wide).contiguous().clone()
    dist.all_reduce(total, group=group)
    k = x.shape[dim] // world_size(group)
    own = total.narrow(dim, dist.get_rank(group) * k, k).contiguous()
    return own.to(device=x.device, dtype=x.dtype)


class _AllGatherDim(torch.autograd.Function):
    """y = the group's x concatenated along ``dim``, on every rank. Each
    rank's y feeds its own loss, so the cotangent of x_r is the sum over
    the ranks of their cotangents' block r (``lax.all_gather``'s
    transpose, ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _sum_own_block(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """y_r = block r along ``dim`` of the sum of the group's x
    (``lax.psum_scatter(tiled=True)``): the cotangent of every x_s is the
    concatenation of the ranks' cotangents of y."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        ctx.group, ctx.dim = group, dim
        return _sum_own_block(x, group, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _gather_dim(g, ctx.group, ctx.dim), None, None


def all_gather_dim(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable tiled all-gather of ``x`` along ``dim`` over
    ``group`` (``lax.all_gather(axis=dim, tiled=True)``); ``x`` itself
    without a group."""
    if not _active(group):
        return x
    return _AllGatherDim.apply(x, group, dim % x.dim())


def reduce_scatter(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable ``psum_scatter``: the sum over ``group``, this rank's
    block of ``dim`` (whose size must divide by the group's); ``x`` itself
    without a group."""
    if not _active(group):
        return x
    if x.shape[dim] % world_size(group):
        raise ValueError(
            f"reduce_scatter: dimension {dim} of {tuple(x.shape)} does not split over {world_size(group)} ranks"
        )
    return _ReduceScatter.apply(x, group, dim % x.dim())


def ring_all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The all-gather of ``x`` along ``dim`` as n - 1 ring shifts (each
    rank's block hops one rank at a time): block s of the result is rank
    s's ``x``. Differentiable through :func:`shift`."""
    n = world_size(group) if _active(group) else 1
    if n == 1:
        return x
    idx = dist.get_rank(group)
    blocks: List[Optional[torch.Tensor]] = [None] * n
    blocks[idx] = block = x
    for hop in range(n - 1):
        block = shift(block, group, offset=1, ring=True)
        # the block received at hop i left rank (idx - 1 - i) mod n
        blocks[(idx - 1 - hop) % n] = block
    return torch.cat(blocks, dim=dim)
