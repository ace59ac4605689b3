"""Ring attention: exact blockwise attention over the sequence group
(counterpart of the JAX package's ``parallel/ring_attention.py``; Liu et
al., "Ring Attention with Blockwise Transformers for Near-Infinite
Context", arXiv:2310.01889).

Each rank of the sequence group holds one block of the tokens' Q, K and V
``[B, S/n, H, D]``. The K/V blocks travel around the ring one hop per step
(``collectives.shift`` with ``ring=True``) while a float32 online softmax
accumulates this rank's exact attention output. It is plain tensor ops and
the differentiable shift, so autograd records the same graph on every rank
and its backward runs the reverse rotations in one order, as JAX's
autodiff through ``ppermute`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh

# -inf would turn a row whose every key is masked into nan (exp(-inf -
# -inf)); a row with no visible key returns zeros in both formulations
_MASK_VALUE = -1e30


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain full-sequence softmax attention, the oracle of
    :func:`ring_attention`: ``[B, S, H, D]`` in, float32 math, the input's
    dtype out. ``kv_mask`` ([B, S] bool, True = a real key) drops padding
    keys; ``segment_ids`` ([B, S] int) lets a query see only the keys of its
    own segment; both compose with ``causal``. A query row with no visible
    key returns zeros."""
    orig = q.dtype
    q, k, v = (t.float() for t in (q, k, v))
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    b, s_q, s_k = scores.shape[0], scores.shape[-2], scores.shape[-1]
    visible = torch.ones((b, s_q, s_k), dtype=torch.bool, device=q.device)
    if causal:
        visible = visible & torch.tril(torch.ones((s_q, s_k), dtype=torch.bool, device=q.device))[None]
    if kv_mask is not None:
        visible = visible & kv_mask[:, None, :]
    if segment_ids is not None:
        visible = visible & (segment_ids[:, :, None] == segment_ids[:, None, :])
    scores = torch.where(visible[:, None], scores, torch.full((), _MASK_VALUE, device=q.device))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    if kv_mask is not None or segment_ids is not None:
        out = torch.where(visible.any(dim=-1)[:, :, None, None], out, torch.zeros((), device=q.device))
    return out.to(orig)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group=None,
    causal: bool = False,
    kv_mask: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact attention of this rank's Q block ``[B, S/n, H, D]`` over the
    K/V blocks of every rank of ``group`` (None: the process's sequence
    group; without one, plain blockwise attention over the local block).

    Step 0 attends to the block held here; each of the n - 1 later steps
    first rotates K/V one hop (rank r receives rank r - 1's block), then
    attends. ``causal`` masks by global position: query ``index·S_loc + i``
    sees keys at global positions at or before it. ``kv_mask`` and
    ``segment_ids`` ([B, S/n], this rank's tokens) travel with their K/V
    block; the query-side segment ids stay here. A query row whose every
    key is masked returns zeros, as :func:`attention_reference`."""
    group = mesh.sequence_group() if group is None else group
    active = collectives.is_initialized() and group is not None and collectives.world_size(group) > 1
    n = collectives.world_size(group) if active else 1
    my_idx = torch.distributed.get_rank(group) if active else 0
    orig = q.dtype
    q32 = q.float()
    b, s_loc, h, d = q32.shape
    scale = 1.0 / math.sqrt(d)
    o = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc, 1), _MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    q_pos = my_idx * s_loc + torch.arange(s_loc, device=q.device)
    q_seg = segment_ids

    def block_update(o, m, l, k_blk, v_blk, mask_blk, seg_blk, step_no):
        # the block held at ring step t left rank (my_idx - t) mod n
        src = (my_idx - step_no) % n
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
        visible = None
        if causal:
            k_pos = src * s_loc + torch.arange(s_loc, device=q.device)
            visible = (q_pos[:, None] >= k_pos[None, :])[None].expand(b, s_loc, s_loc)
        if mask_blk is not None:
            pad = mask_blk[:, None, :].expand(b, s_loc, s_loc)
            visible = pad if visible is None else visible & pad
        if seg_blk is not None:
            same = q_seg[:, :, None] == seg_blk[:, None, :]
            visible = same if visible is None else visible & same
        if visible is not None:
            scores = torch.where(visible[:, None], scores, torch.full((), _MASK_VALUE, device=q.device))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        if visible is not None and (mask_blk is not None or seg_blk is not None):
            # exp(MASK - MASK) = 1 would count masked keys in a row that has
            # seen no visible key yet: zero them so l counts real keys only
            p = p * visible[:, None].to(p.dtype)
        l = l * correction + p.sum(dim=-1, keepdim=True)
        o = o * correction + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        return o, m_new, l

    o, m, l = block_update(o, m, l, k, v, kv_mask, segment_ids, 0)
    if n > 1:
        kv, mask_blk, seg_blk = torch.stack([k, v]), kv_mask, segment_ids
        for step_no in range(1, n):
            kv = collectives.shift(kv, group, offset=1, ring=True)
            if mask_blk is not None:
                mask_blk = collectives.shift(mask_blk, group, offset=1, ring=True)
            if seg_blk is not None:
                seg_blk = collectives.shift(seg_blk, group, offset=1, ring=True)
            o, m, l = block_update(o, m, l, kv[0], kv[1], mask_blk, seg_blk, step_no)
    # rows with no visible key have l == 0: the guard maps their 0/0 to 0
    out = o / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(orig)


def make_ring_attention(*, causal: bool = False, masked: bool = False, segmented: bool = False, group=None):
    """``fn(q, k, v, [kv_mask], [segment_ids])`` over global ``[B, S, H,
    D]`` tensors (and ``[B, S]`` masks, in that order when their flags are
    set): this rank's block, its data index's rows (``mesh.shard_rows``)
    and its sequence index's S block, goes through :func:`ring_attention`;
    the result is this rank's output block ``[B/dp, S/n, H, D]``."""

    def fn(q, k, v, *extras):
        n, s = mesh.sequence_parallel_degree(), mesh.sequence_index()

        def local(t):
            t = t[mesh.shard_rows(t.shape[0])]
            blk = t.shape[1] // n
            return t[:, s * blk:(s + 1) * blk]

        it = iter(extras)
        kv_mask = local(next(it)) if masked else None
        segment_ids = local(next(it)) if segmented else None
        return ring_attention(local(q), local(k), local(v), group=group, causal=causal, kv_mask=kv_mask,
                              segment_ids=segment_ids)

    return fn


__all__ = ["attention_reference", "make_ring_attention", "ring_attention"]
