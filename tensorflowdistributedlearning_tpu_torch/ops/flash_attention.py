"""Softmax attention: the hand-written online-softmax kernel and its plain
version (counterpart of ``tensorflowdistributedlearning_tpu/ops/
flash_attention.py``).

:func:`flash_attention` keeps the JAX contract: ``q``, ``k``, ``v`` of one
shape ``[B, T, H, D]``, scale ``1/sqrt(D)``, float32 math whatever the
input dtype, masked scores at ``-1e30`` under ``causal``, the row sum
floored at ``1e-30``, the output in ``q``'s dtype.

Dispatch, as in ``ops/kernels.py``: a CPU tensor takes
:func:`flash_attention_plain`; a CUDA tensor launches a kernel or raises.
The input dtype alone picks the kernel: bfloat16 goes to the tensor-core
kernel ``csrc/flash_attention_tc.cu`` (``mma.sync`` bf16 products, float32
softmax and sums, P split into three bf16 terms), float32 to the CUDA-core
kernel ``csrc/flash_attention_f32.cu`` (IEEE float32 FMAs, no TF32). Each
launch adds one to ``kernels.LAUNCHES["flash_attention"]``, and a
tensor-core launch also to ``["flash_attention_tc"]``. Both kernels read
``q``, ``k`` and ``v`` in place through their strides (in the ViT they are
slices of the qkv projection), so the three transposed copies the JAX
wrapper makes are not made; both copy in 16-byte pieces, and an input whose
base or strides are not 16-byte aligned is first copied to a contiguous
tensor. Each takes the head widths of :data:`KERNEL_HEAD_DIMS` for its
dtype and raises on any other (``config.require_supported`` refuses such a
fused ViT before it reaches the card). ``csrc/flash_attention.cu``, the
earlier CUDA-core kernel, is built but no path calls it.

Gradients (ViT training): :func:`flash_attention` is a
``torch.autograd.Function`` on both arms, as the JAX package's is a
``custom_vjp``. The forward saves ``(q, k, v)`` and neither the output nor
a logsumexp (JAX's ``_flash_fwd``); the backward
(:func:`flash_attention_backward`, JAX's ``_flash_bwd``) rebuilds the
scores in plain float32 PyTorch: ``P = softmax(q·kᵀ·scale)`` (masked under
``causal``), ``dV = Pᵀ·g``, ``dP = g·vᵀ``, ``dS = P∘(dP - rowsum(dP∘P))``,
``dQ = dS·k·scale``, ``dK = dSᵀ·q·scale``, each returned in the input
dtype. The JAX package computes these products in XLA outside any Pallas
kernel, so they stay PyTorch products here; a Hopper backward kernel is
queued in ROADMAP.md (B 1).

Not carried over: ``_VMEM_KV_LIMIT_BYTES``, the TPU kernel's VMEM budget
above which its wrapper fell back to XLA, and the ViT's ``_FUSED_MAX_SEQ``
(a ceiling measured on a TPU). An online softmax over K/V tiles holds no
score row whole, so it has no such ceiling: with ``use_fused_attention`` the
kernel runs at every sequence length. ``MultiHeadSelfAttention`` keeps its
``num_prefix_tokens`` field for the structure of the model only.
``kv_mask`` and ``segment_ids`` of ``attention_reference`` come with ring
attention.
"""

from __future__ import annotations

import torch

from tensorflowdistributedlearning_tpu_torch.ops import _build
from tensorflowdistributedlearning_tpu_torch.ops import kernels

# the JAX package's mask value: -inf would poison a row whose every key is
# masked (exp(-inf - -inf) = nan)
MASK_VALUE = -1e30
# head widths each kernel is instantiated for, by input dtype: the
# tensor-core arm steps d by 16 (m16n8k16); the float32 arm, whose 16-byte
# copies need d % 4 == 0, is built for the same widths, since a
# float32-compute ViT reaches the bf16 arm too (under int8-compute).
# config.require_supported refuses a fused ViT with any other width
KERNEL_HEAD_DIMS = {
    torch.bfloat16: tuple(range(16, 129, 16)),
    torch.float32: tuple(range(16, 129, 16)),
}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"flash_attention expects q, k, v of one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def _scale(d: int) -> float:
    return 1.0 / (d ** 0.5)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """Plain version (counterpart of ``attention_reference``): the full
    float32 score matrix, masked at ``-1e30`` above the diagonal under
    ``causal``, ``exp(s - max)`` weights, their sum floored at ``1e-30``;
    ``[B, T, H, D]`` out in ``q``'s dtype."""
    _check(q, k, v)
    qf, kf, vf = (x.float() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * _scale(q.shape[-1])
    if causal:
        t = q.shape[1]
        visible = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(visible, s, torch.full_like(s, MASK_VALUE))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1).clamp_min(1e-30)  # [B, H, T]
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / denom.transpose(1, 2)[..., None]
    return o.to(q.dtype)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *,
                             causal: bool = False):
    """``(dq, dk, dv)`` of attention at ``q, k, v`` [B, T, H, D] for the
    output cotangent ``g`` (JAX's ``_flash_bwd``): float32 math on the
    recomputed weights, results in ``q``'s dtype."""
    dtype = q.dtype
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    scale = _scale(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        t = q.shape[1]
        visible = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(visible, s, torch.full_like(s, MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _strides(x: torch.Tensor, name: str):
    if x.stride(3) != 1:
        raise ValueError(f"flash_attention: {name} must have a contiguous last axis, got strides {x.stride()}")
    return x.stride(0), x.stride(1), x.stride(2)


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x`` if its base and its b, t, h strides are 16-byte aligned (what
    the tensor-core kernel's 16-byte copies need), else a contiguous copy."""
    nbytes = x.element_size()
    if x.data_ptr() % 16 == 0 and all((s * nbytes) % 16 == 0 for s in x.stride()[:3]) and x.stride(3) == 1:
        return x
    return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)


# C entry point of each arm, by input dtype; both take one argument list
ENTRIES = {torch.bfloat16: "tfdl_flash_attention_tc", torch.float32: "tfdl_flash_attention_f32"}


def _launch(entry: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """One launch of the C entry ``entry`` on checked CUDA inputs; returns
    the output. Counts nothing: :func:`flash_attention` counts its launches."""
    b, t, h, d = q.shape
    strides = [s for name, x in (("q", q), ("k", k), ("v", v)) for s in _strides(x, name)]
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib, fn = kernels._entry(entry)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
            b, t, h, d, *strides, int(bool(causal)), _scale(d), kernels._stream(q),
        )
    _build.check(lib, code, "flash_attention")
    return out


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """The forward of one checked call: the plain version on the CPU, else
    one kernel launch, counted."""
    if kernels._use_plain(q):
        return flash_attention_plain(q, k, v, causal=causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}; q, k, v must share one CUDA device")
        if t.dtype not in ENTRIES:
            raise TypeError(f"flash_attention: the kernel takes float32 or bfloat16, got {t.dtype}")
    d = q.shape[-1]
    if d not in KERNEL_HEAD_DIMS[q.dtype]:
        raise ValueError(
            f"flash_attention: the {q.dtype} kernel takes head widths {KERNEL_HEAD_DIMS[q.dtype]}, got {d}"
        )
    tensor_cores = q.dtype == torch.bfloat16
    q, k, v = (_aligned16(x) for x in (q, k, v))
    out = _launch(ENTRIES[q.dtype], q, k, v, causal)
    kernels.LAUNCHES["flash_attention"] += 1
    if tensor_cores:
        kernels.LAUNCHES["flash_attention_tc"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The forward of :func:`_forward`, the backward of
    :func:`flash_attention_backward` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, g, causal=ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False) -> torch.Tensor:
    """Softmax attention on ``[B, T, H, D]`` (float32 or bfloat16), float32
    math, output ``[B, T, H, D]`` contiguous in ``q``'s dtype, differentiable
    in ``q``, ``k`` and ``v``. CPU: plain version; CUDA:
    ``csrc/flash_attention_tc.cu`` for bfloat16 inputs,
    ``csrc/flash_attention_f32.cu`` for float32 (head widths of
    :data:`KERNEL_HEAD_DIMS`, any sequence length, inputs read through their
    strides). The backward is :func:`flash_attention_backward` on both."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, bool(causal))
    return _forward(q, k, v, bool(causal))
