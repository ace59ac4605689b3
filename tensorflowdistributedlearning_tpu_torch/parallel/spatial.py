"""Spatial (sequence) parallelism: halo exchange and sharded convolution
(counterpart of the JAX package's ``parallel/spatial.py``).

Under ``sequence_parallel = sp`` > 1 every image's rows lie over the
sequence group of ``parallel/mesh.py`` in ``sp`` equal contiguous blocks
(:func:`mesh.shard_batch_spatial`); W and the channels are whole on every
rank. A k x k convolution of such a block needs ``rate·(k-1)/2`` rows of
each neighbouring block, which :func:`halo_exchange` brings over with one
shift each way (``collectives.shift``, an open chain: the outermost blocks
receive zeros, the zero padding of a SAME convolution). The JAX package's
``axis_name`` is a group argument here (None: the process's sequence
group); every function is differentiable, its backward the transpose of
its forward, so the step's gradient is JAX's (``train/step.py``).
Convolutions are ``F.conv2d``, as the JAX package leaves them to XLA.

Tensors are NHWC, filters OIHW (the port's layout; JAX's are HWIO).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tensorflowdistributedlearning_tpu_torch.parallel import collectives, mesh


def _group(group):
    return mesh.sequence_group() if group is None else group


def _index_and_size(group):
    """(this rank's index in ``group``, its size); (0, 1) without one."""
    if group is None or not collectives.is_initialized():
        return 0, 1
    return torch.distributed.get_rank(group), collectives.world_size(group)


def halo_exchange(x: torch.Tensor, halo: int, *, group=None, spatial_axis: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` extended by ``halo`` rows of each
    neighbour's along ``spatial_axis``: the previous rank's last rows above,
    the next rank's first rows below, zeros beyond the first and last
    blocks (the zero padding of a SAME convolution)."""
    if halo <= 0:
        return x
    local = x.shape[spatial_axis]
    if halo > local:
        raise ValueError(
            f"halo {halo} exceeds the local shard extent {local} along axis "
            f"{spatial_axis}; a single-hop exchange cannot reach beyond the "
            "adjacent shard — use fewer devices on the sequence axis or a "
            "smaller kernel"
        )
    group = _group(group)
    # my last rows become the next rank's top halo; my first rows the
    # previous rank's bottom halo
    from_prev = collectives.shift(x.narrow(spatial_axis, local - halo, halo), group, offset=1)
    from_next = collectives.shift(x.narrow(spatial_axis, 0, halo), group, offset=-1)
    return torch.cat([from_prev, x, from_next], dim=spatial_axis)


def _conv(x: torch.Tensor, weight: torch.Tensor, stride: int, rate: int, groups: int, ph, pw) -> torch.Tensor:
    """``F.conv2d`` of NHWC ``x`` with the explicit pads ``ph``, ``pw``
    (low, high), NHWC out."""
    if any(ph) or any(pw):
        x = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride=stride, dilation=rate, groups=groups)
    return y.permute(0, 2, 3, 1)


def conv_plan(h_local: int, w: int, kh: int, kw: int, stride: int, rate: int, phase: str) -> dict:
    """The geometry :func:`spatial_conv2d` computes a block with: the halo
    rows, the total H pad of the phase, the W pads (low, high), the block's
    output rows, and the offset and extent of the halo-extended rows the
    VALID convolution reads."""
    ekh = kh + (kh - 1) * (rate - 1)
    ekw = kw + (kw - 1) * (rate - 1)
    halo = (ekh - 1) // 2
    if phase == "same":
        total_h = max(ekh - stride, 0)
        total_w = max((-(-w // stride) - 1) * stride + ekw - w, 0)
    else:
        total_h = ekh - 1
        total_w = ekw - 1
    out_rows = h_local // stride
    # the first tap of this block's first output row lies total_h // 2 rows
    # above the block's start: offset (halo - that) in the extended block
    return {"halo": halo, "ekh": ekh, "total_h": total_h, "pw": (total_w // 2, total_w - total_w // 2),
            "out_rows": out_rows, "offset": halo - total_h // 2, "window": (out_rows - 1) * stride + ekh}


def gather_pads(plan: dict, hg: int, stride: int, phase: str):
    """The H pads (low, high) of the whole convolution the all-gather path
    computes on ``hg`` gathered rows."""
    ekh = plan["ekh"]
    total = plan["total_h"] if phase == "fixed" else max((-(-hg // stride) - 1) * stride + ekh - hg, 0)
    return total // 2, total - total // 2


def spatial_conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    *,
    stride: int = 1,
    rate: int = 1,
    group=None,
    groups: int = 1,
    phase: str = "same",
) -> torch.Tensor:
    """2-D (atrous, grouped) convolution of an H-sharded NHWC block,
    exactly the rows of the unsharded op that this rank owns.

    ``x``: this rank's block ``[B, H_local, W, C_in]``; ``weight``: OIHW
    ``[C_out, C_in/groups, kh, kw]`` with kh odd. The padding phase is the
    reference op's: ``"same"`` is XLA's SAME (total pad ``max(ek - stride,
    0)``, the low side ``total // 2``), ``"fixed"`` slim's ``fixed_padding``
    then VALID (total ``ek - 1``), with ``ek`` the dilated extent. With
    ``stride`` > 1, H_local must divide by it so the blocks stay aligned
    with the global stride phase. When the halo exceeds H_local (deep
    atrous stages on small maps) the rows are all-gathered instead and the
    whole convolution computed, then this rank's output rows kept (as a
    block of their own, like the halo path's)."""
    if phase not in ("same", "fixed"):
        raise ValueError(f"Unknown padding phase {phase!r}")
    kh, kw = weight.shape[-2], weight.shape[-1]
    if kh % 2 != 1:
        raise ValueError(f"spatial_conv2d requires odd kernel height, got {kh}")
    h_local = x.shape[1]
    if h_local % stride != 0:
        raise ValueError(
            f"H_local {h_local} must be divisible by stride {stride} to keep "
            "shard boundaries stride-aligned"
        )
    plan = conv_plan(h_local, x.shape[2], kh, kw, stride, rate, phase)
    group = _group(group)
    if plan["halo"] > h_local:
        # one hop cannot reach beyond the adjacent block: gather H whole,
        # convolve, keep this rank's output rows
        idx, _ = _index_and_size(group)
        full = collectives.all_gather_dim(x, group, dim=1)
        out = _conv(full, weight, stride, rate, groups, gather_pads(plan, full.shape[1], stride, phase), plan["pw"])
        return out.narrow(1, idx * plan["out_rows"], plan["out_rows"]).contiguous()
    padded = halo_exchange(x, plan["halo"], group=group, spatial_axis=1)
    return _conv(padded.narrow(1, plan["offset"], plan["window"]), weight, stride, rate, groups, (0, 0), plan["pw"])


def uses_gather(h_local: int, kernel_size: int, rate: int = 1) -> bool:
    """Whether :func:`spatial_conv2d` of a ``kernel_size`` conv at ``rate``
    on blocks of ``h_local`` rows takes the all-gather path (its halo
    exceeds the block)."""
    return (kernel_size - 1) * rate // 2 > h_local


def spatial_max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, *, group=None) -> torch.Tensor:
    """SAME max pool of an H-sharded NHWC block, exactly the unsharded
    ``max_pool(padding="SAME")``'s rows: the halo scheme of
    :func:`spatial_conv2d`, with the halo rows beyond the image (the zeros
    the exchange gives the outermost blocks) set to -inf so they never
    win."""
    h_local = x.shape[1]
    if h_local % stride != 0:
        raise ValueError(
            f"H_local {h_local} must be divisible by stride {stride} to keep "
            "shard boundaries stride-aligned"
        )
    halo = (window - 1) // 2
    group = _group(group)
    idx, n = _index_and_size(group)
    neg = float("-inf") if x.is_floating_point() else int(torch.iinfo(x.dtype).min)
    padded = halo_exchange(x, halo, group=group, spatial_axis=1)
    if halo > 0:
        rows = torch.arange(padded.shape[1], device=x.device)
        beyond = ((rows < halo) & (idx == 0)) | ((rows >= padded.shape[1] - halo) & (idx == n - 1))
        padded = torch.where(beyond[None, :, None, None], torch.full((), neg, dtype=x.dtype, device=x.device), padded)
    pad_lo = max(window - stride, 0) // 2
    out_rows = h_local // stride
    sliced = padded.narrow(1, halo - pad_lo, (out_rows - 1) * stride + window)
    w = x.shape[2]
    total_w = max((-(-w // stride) - 1) * stride + window - w, 0)
    sliced = F.pad(sliced, (0, 0, total_w // 2, total_w - total_w // 2), value=neg)
    y = F.max_pool2d(sliced.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def spatial_global_mean(x: torch.Tensor, *, group=None, keepdims: bool = False) -> torch.Tensor:
    """The mean over (H, W) of an H-sharded NHWC batch: the block's mean
    (float32 sums, in ``x``'s dtype, as ``jnp.mean``), then its mean over
    the group (equal blocks), taken in float32."""
    local = x.float().mean(dim=(1, 2), keepdim=keepdims).to(x.dtype)
    return collectives.pmean(local.float(), _group(group)).to(x.dtype)


def spatial_gather(x: torch.Tensor, *, group=None, axis: int = 1) -> torch.Tensor:
    """The whole tensor from its H blocks, on every rank (one all-gather
    over the sequence group): where a computation needs the whole extent
    (the decoder's bilinear upsampling, the per-image loss)."""
    return collectives.all_gather_dim(x, _group(group), dim=axis)


def ring_all_gather(x: torch.Tensor, *, group=None, axis: int = 0) -> torch.Tensor:
    """The concatenation of every rank's ``x`` along ``axis`` in the
    group's order, on every rank, as n - 1 ring hops
    (``collectives.ring_all_gather``)."""
    return collectives.ring_all_gather(x, _group(group), dim=axis)


def reduce_scatter(x: torch.Tensor, *, group=None, axis: int = 0) -> torch.Tensor:
    """The sum over the group, each rank left its own 1/n block of
    ``axis`` (``lax.psum_scatter(tiled=True)``); ``x.shape[axis]`` must
    divide by the group's size."""
    return collectives.reduce_scatter(x, _group(group), dim=axis)


def shard_spatial(x: torch.Tensor, *, spatial_axis: int = 1) -> torch.Tensor:
    """This rank's part of a global array: axis 0's rows of its data index
    and ``spatial_axis``'s block of its sequence index."""
    if spatial_axis == 0:
        raise ValueError("spatial_axis 0 is the batch dimension; pick a spatial dimension >= 1")
    x = x[mesh.shard_rows(x.shape[0])]
    sp, s = mesh.sequence_parallel_degree(), mesh.sequence_index()
    if x.shape[spatial_axis] % sp:
        raise ValueError(f"Spatial extent {x.shape[spatial_axis]} must be divisible by the sequence-parallel degree {sp}")
    k = x.shape[spatial_axis] // sp
    return x.narrow(spatial_axis, s * k, k)


def sequence_parallel_degree() -> int:
    """The process's sequence-axis size (``parallel/mesh.py``)."""
    return mesh.sequence_parallel_degree()


def validate_spatial_config(model_config, sequence_parallel: int) -> None:
    """Fail fast when a model and input cannot run H-sharded: every strided
    stage needs its per-rank H divisible by the stride, which holds for the
    whole network iff the input height divides by ``overall_stride ·
    sequence_parallel`` (``output_stride``, else the stride-32 trunk; a
    ViT's patch size). The MoE ViT is refused."""
    if sequence_parallel <= 1:
        return
    if getattr(model_config, "moe_experts", 0):
        raise ValueError(
            "sequence_parallel and moe_experts cannot combine: per-shard MoE "
            "routing under H-sharded tokens is unvalidated (capacity and the "
            "load-balancing loss would be computed per sequence shard)"
        )
    if getattr(model_config, "backbone", None) == "vit":
        overall = model_config.patch_size
    else:
        overall = model_config.output_stride or 32
    required = overall * sequence_parallel
    h = model_config.input_shape[0]
    if h % required != 0:
        raise ValueError(
            f"sequence_parallel={sequence_parallel} requires the input height "
            f"to be divisible by stride*sequence_parallel = "
            f"{overall}*{sequence_parallel} = {required}, got {h}. Pad/resize "
            f"the input (e.g. {-(-h // required) * required}) or lower the "
            "sequence-parallel degree."
        )


__all__ = [
    "conv_plan",
    "gather_pads",
    "halo_exchange",
    "reduce_scatter",
    "ring_all_gather",
    "sequence_parallel_degree",
    "shard_spatial",
    "spatial_conv2d",
    "spatial_gather",
    "spatial_global_mean",
    "spatial_max_pool",
    "uses_gather",
    "validate_spatial_config",
]
