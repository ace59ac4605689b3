"""Quantized-compute kernels: int8 arithmetic on the serve path (counterpart
of ``tensorflowdistributedlearning_tpu/ops/quant_kernels.py``).

An ``int8-compute`` artifact (``train/quantize.py``) routes every eligible
convolution through :func:`int8_conv2d`, which

1. quantizes its input per tensor, symmetric (:func:`quantize_activations`:
   ``scale = max|x|/127``, zero-point 0, so a bucket's zero rows stay zero
   and cannot move the scale), in PyTorch ops, as the JAX package does it in
   XLA outside its kernel;
2. runs the convolution as int8 x int8 -> int32 on the tensor cores,
   through the kernel :func:`conv_route` picks from the shape: a 1x1 conv
   without pads is the GEMM ``[B*H*W, Cin] x [Cout, Cin]^T`` of
   ``csrc/int8_gemm.cu``; a k x k conv with Cin a multiple of 32 is the
   Hopper implicit GEMM of ``csrc/int8_conv_tc.cu`` (TMA im2col loads,
   ``wgmma``); the rest takes ``csrc/int8_conv.cu`` (``mma.sync``);
3. ends in the fused epilogue ``act(f32(acc) * (xs * w_scale[n]) + bias[n])``
   (``csrc/epilogue.cuh``, shared with :func:`ops.kernels.fused_bias_act`),
   cast to the activation dtype (bf16).

:func:`int8_matmul` runs ``csrc/int8_gemm.cu``, a Hopper GEMM (TMA loads,
``wgmma`` s8.s8.s32, the same epilogue), wherever TMA can describe the
operands (:func:`matmul_route`: K a multiple of 16); other shapes take the
conv kernel as a 1x1 conv over ``[1, 1, M, K]``. The ViT's Dense layers
reach it through :class:`QuantLinear`.

Plain versions (``*_plain``) compute the same function as the kernel:
exact integer accumulation (float64 sums of int8 products, exact while
``K * 127**2 < 2**53``), then the same f32 epilogue ops one by one, so on
the card kernel and plain version agree bit for bit. The dequantize-then-f32
``int8_conv2d_reference`` of the JAX package is another function (its sums
round in f32); the tests hold the port to it only with a tolerance.

Dispatch as in ``ops/kernels.py``: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises, and each launch adds one to
``kernels.LAUNCHES["int8_conv2d"]`` / ``["int8_matmul"]`` (and a launch
of a route other than ``int8_conv.cu`` also to ``["int8_conv2d_gemm"]``,
``["int8_conv2d_tc"]`` or ``["int8_matmul_gemm"]``).

The JAX package's ``int8_intercept`` (a flax method interceptor at trace
time) becomes a module swap at load time: :func:`swap_int8_layers` replaces
every eligible :class:`models.layers.Conv2dSame` by a :class:`QuantConv2d`
that holds the int8 filter in the kernel's layout, under the eligibility
rule of ``make_int8_interceptor`` (:func:`int8_eligible`), and every
``nn.Linear`` with a record by a :class:`QuantLinear` (the rule's
``nn.Dense`` arm). The ViT's patch conv (stride 16) is no ``Conv2dSame``
and keeps the dequantized float path, as the interceptor's stride rule
leaves it in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from tensorflowdistributedlearning_tpu_torch.ops import _build
from tensorflowdistributedlearning_tpu_torch.ops import kernels

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric dynamic quantization: ``(q int8, scale f32)``
    with ``scale = max|x|/127`` (1.0 for an all-zero tensor) and ``q =
    clip(round(x/scale), -127, 127)``: f32 division, round half to even.
    ``scale`` is a 0-dim tensor on ``x``'s device (no host round trip).
    Divisions are tensor by tensor: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which is not the JAX package's
    division."""
    xf = x.float()
    m = xf.abs().amax()
    scale = torch.where(m > 0, m / torch.full_like(m, 127.0), torch.ones_like(m))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _conv_pads(padding, kh: int, kw: int) -> Optional[Pads]:
    """Normalize a SAME/VALID/explicit padding spec to ((lo,hi),(lo,hi)) for
    a stride-1 undilated conv; None = unsupported (caller falls back)."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return ((0, 0), (0, 0))
        if p == "SAME":
            # stride-1 SAME: total pad k-1, split low-first like XLA
            return (
                ((kh - 1) // 2, kh // 2),
                ((kw - 1) // 2, kw // 2),
            )
        return None
    try:
        (a, b), (c, d) = ((p[0], p[1]) for p in padding)
    except (TypeError, ValueError, IndexError):
        return None
    if min(a, b, c, d) < 0:
        return None
    return ((int(a), int(b)), (int(c), int(d)))


def _epilogue_plain(acc: torch.Tensor, xs: torch.Tensor, w_scale: torch.Tensor, bias, act: str, out_dtype):
    """The kernel's epilogue op by op: int32 -> f32 (nearest even), times
    the f32 product ``xs * w_scale[n]``, plus ``bias[n]``, act, cast."""
    y = acc.to(torch.float32) * (xs * w_scale.float())
    if bias is not None:
        y = y + bias.float()
    return kernels.activate(y, act).to(out_dtype)


def _check_epilogue_args(n: int, w_scale, bias, act: str) -> None:
    if act not in kernels.ACTIVATIONS:
        raise ValueError(f"act {act!r} not in {sorted(kernels.ACTIVATIONS)}")
    if tuple(w_scale.shape) != (n,):
        raise ValueError(f"w_scale must be [{n}], got {tuple(w_scale.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be [{n}], got {tuple(bias.shape)}")


def _launch(name: str, xq, xs, wk, w_scale, bias, out, dims, pads: Pads, act: str) -> None:
    """One launch of ``csrc/int8_conv.cu``: ``dims`` = (B, H, W, Cin, Cout,
    kh, kw), ``wk`` the [Cout, kh, kw, Cin] filter. Counts nothing: the
    callers count under their own names."""
    kernels._require_cuda(name, xq, wk, dtypes=(torch.int8,))
    kernels._require_cuda_f32(name, xs, w_scale, bias)
    kernels._require_cuda(name, out, dtypes=(torch.float32, torch.bfloat16))
    b, h, w, cin, cout, kh, kw = dims
    (pt, pb), (pl, pr) = pads
    # 16-byte loads need 16-byte rows of channels and 16-byte aligned bases
    vec = int(cin % 16 == 0 and xq.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0)
    lib, fn = kernels._entry("tfdl_int8_conv2d")
    with torch.cuda.device(xq.device):
        code = fn(
            xq.data_ptr(), wk.data_ptr(), xs.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, h, w, cin, cout, kh, kw, pt, pb, pl, pr, kernels.ACTIVATIONS[act],
            int(out.dtype == torch.bfloat16), vec, kernels._stream(xq),
        )
    _build.check(lib, code, name)


# -- int8 conv2d (stride-1, undilated) -----------------------------------------

# int8_conv_tc.cu loads one tap's channel slice of 128, 64 or 32 bytes (a
# wgmma swizzle row) per TMA im2col box, so Cin comes in multiples of 32;
# the box's corners (-pad, pad - (side - 1)) are signed bytes
TC_CIN_MULTIPLE = 32
TC_MAX_CORNER = 127


def conv_route(kh: int, kw: int, cin: int, pads: Pads, aligned: bool = True) -> str:
    """The kernel :func:`int8_conv2d_ohwi` launches for a stride-1 conv
    with a ``kh`` x ``kw`` filter over ``cin`` channels and ``pads``,
    chosen from the shape and the operands' alignment before any launch:

    - ``"gemm"`` (``csrc/int8_gemm.cu``): a 1x1 conv without pads, the
      GEMM [B*H*W, Cin] x [Cout, Cin]^T, when TMA can describe its rows
      (Cin a multiple of 16, bases 16-byte aligned);
    - ``"tc"`` (``csrc/int8_conv_tc.cu``, TMA im2col + ``wgmma``): the
      other convs with Cin a multiple of 32, aligned bases and pads the
      im2col box can hold;
    - ``"conv"`` (``csrc/int8_conv.cu``): the rest.

    All three give the same bits."""
    (pt, pb), (pl, pr) = pads
    if not aligned:
        return "conv"
    if kh == kw == 1 and pt == pb == pl == pr == 0 and cin % GEMM_K_MULTIPLE == 0:
        return "gemm"
    corners = (pt, pl, pb - (kh - 1), pr - (kw - 1))
    if cin % TC_CIN_MULTIPLE == 0 and max(abs(c) for c in corners) <= TC_MAX_CORNER:
        return "tc"
    return "conv"


def _launch_tc(xq, xs, wk, w_scale, bias, out, pads: Pads, act: str) -> None:
    """One launch of ``csrc/int8_conv_tc.cu`` on ``xq`` [B, H, W, Cin] and
    ``wk`` [Cout, kh, kw, Cin] (both 16-byte aligned, Cin % 32 == 0)."""
    kernels._require_cuda("int8_conv2d", xq, wk, dtypes=(torch.int8,))
    kernels._require_cuda_f32("int8_conv2d", xs, w_scale, bias)
    kernels._require_cuda("int8_conv2d", out, dtypes=(torch.float32, torch.bfloat16))
    b, h, w, cin = xq.shape
    cout, kh, kw, _ = wk.shape
    (pt, pb), (pl, pr) = pads
    lib, fn = kernels._entry("tfdl_int8_conv2d_tc")
    with torch.cuda.device(xq.device):
        code = fn(
            xq.data_ptr(), wk.data_ptr(), xs.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, h, w, cin, cout, kh, kw, pt, pb, pl, pr, kernels.ACTIVATIONS[act],
            int(out.dtype == torch.bfloat16), kernels._stream(xq),
        )
    _build.check(lib, code, "int8_conv2d")


def _launch_conv(xq, xs, wk, w_scale, bias, out, pads: Pads, act: str) -> str:
    """``out`` [B, Ho, Wo, Cout] = the int8 conv of ``xq`` [B, H, W, Cin]
    with ``wk`` [Cout, kh, kw, Cin] and the epilogue, through the kernel
    :func:`conv_route` picks; counts the launch as ``int8_conv2d`` and,
    off ``int8_conv.cu``, as ``int8_conv2d_{route}``. Returns the route."""
    b, h, w, cin = xq.shape
    cout, kh, kw, _ = wk.shape
    aligned = xq.data_ptr() % 16 == 0 and wk.data_ptr() % 16 == 0
    route = conv_route(kh, kw, cin, pads, aligned)
    if route == "gemm":
        _launch_gemm(xq.view(-1, cin), xs, wk.view(cout, cin), w_scale, bias, out.view(-1, cout), act, "int8_conv2d")
    elif route == "tc":
        _launch_tc(xq, xs, wk, w_scale, bias, out, pads, act)
    else:
        _launch("int8_conv2d", xq, xs, wk, w_scale, bias, out, (b, h, w, cin, cout, kh, kw), pads, act)
    kernels.LAUNCHES["int8_conv2d"] += 1
    if route != "conv":
        kernels.LAUNCHES[f"int8_conv2d_{route}"] += 1
    return route


def _earlier_int8_conv(xq, xs, wk, w_scale, bias, out, pads: Pads, act: str) -> None:
    """The earlier kernel of every conv route (``tfdl_int8_conv2d`` of
    ``csrc/int8_conv.cu``) on the same quantized operands. Kept to be timed
    and held bit for bit beside the routes; no path calls it, and it counts
    nothing."""
    b, h, w, cin = xq.shape
    cout, kh, kw, _ = wk.shape
    _launch("int8_conv2d (earlier kernel)", xq, xs, wk, w_scale, bias, out, (b, h, w, cin, cout, kh, kw), pads, act)


def _conv_out_hw(x: torch.Tensor, kh: int, kw: int, pads: Pads) -> Tuple[int, int]:
    (pt, pb), (pl, pr) = pads
    ho = x.shape[1] + pt + pb - (kh - 1)
    wo = x.shape[2] + pl + pr - (kw - 1)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"int8_conv2d: empty output {ho}x{wo} for x {tuple(x.shape)}, {kh}x{kw}, pads {pads}")
    return ho, wo


def _check_conv(x: torch.Tensor, wk: torch.Tensor, w_scale, bias, act: str) -> None:
    if wk.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wk.dtype}")
    if x.dim() != 4 or wk.dim() != 4:
        raise ValueError(
            f"int8_conv2d expects x [B,H,W,Cin] and a 4-D filter, got {tuple(x.shape)} and {tuple(wk.shape)}"
        )
    if x.shape[-1] != wk.shape[-1]:
        raise ValueError(f"x channels {x.shape[-1]} != filter Cin {wk.shape[-1]}")
    _check_epilogue_args(wk.shape[0], w_scale, bias, act)


def _conv_acc_plain(xq: torch.Tensor, wk: torch.Tensor, pads: Pads) -> torch.Tensor:
    """Exact int32 accumulator of the stride-1 conv: per tap, a float64
    matmul of the shifted int8 input with the tap's [Cin, Cout] filter."""
    (pt, pb), (pl, pr) = pads
    cout, kh, kw, _ = wk.shape
    ho, wo = _conv_out_hw(xq, kh, kw, pads)
    xp = torch.nn.functional.pad(xq.to(torch.float64), (0, 0, pl, pr, pt, pb))
    w64 = wk.to(torch.float64)
    acc = torch.zeros((xq.shape[0], ho, wo, cout), dtype=torch.float64, device=xq.device)
    for i in range(kh):
        for j in range(kw):
            acc += xp[:, i:i + ho, j:j + wo, :] @ w64[:, i, j, :].T
    return acc.to(torch.int32)


def int8_conv2d_ohwi_plain(
    x: torch.Tensor, wk: torch.Tensor, w_scale: torch.Tensor, pads: Pads, *,
    bias: Optional[torch.Tensor] = None, act: str = "none", out_dtype=None,
) -> torch.Tensor:
    """Plain version of :func:`int8_conv2d_ohwi`: the same quantization,
    exact integer accumulation, the kernel's epilogue op by op."""
    _check_conv(x, wk, w_scale, bias, act)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xq, xs = quantize_activations(x)
    return _epilogue_plain(_conv_acc_plain(xq, wk, pads), xs, w_scale, bias, act, out_dtype)


def int8_conv2d_ohwi(
    x: torch.Tensor, wk: torch.Tensor, w_scale: torch.Tensor, pads: Pads, *,
    bias: Optional[torch.Tensor] = None, act: str = "none", out_dtype=None,
) -> torch.Tensor:
    """The conv in the kernel's filter layout: ``x`` [B,H,W,Cin] float,
    ``wk`` [Cout, kh, kw, Cin] int8, ``w_scale`` [Cout] f32, ``pads``
    ((top, bottom), (left, right)); returns [B,Ho,Wo,Cout] in ``out_dtype``
    (default ``x.dtype``). CPU: plain version; CUDA: the kernel
    :func:`conv_route` picks."""
    _check_conv(x, wk, w_scale, bias, act)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if kernels._use_plain(x):
        return int8_conv2d_ohwi_plain(x, wk, w_scale, pads, bias=bias, act=act, out_dtype=out_dtype)
    cout, kh, kw, cin = wk.shape
    ho, wo = _conv_out_hw(x, kh, kw, pads)
    xq, xs = quantize_activations(x)
    out = torch.empty((x.shape[0], ho, wo, cout), dtype=out_dtype, device=x.device)
    _launch_conv(xq, xs, wk, w_scale, bias, out, pads, act)
    return out


def _hwio_to_ohwi(wq: torch.Tensor) -> torch.Tensor:
    if wq.dim() != 4:
        raise ValueError(f"int8_conv2d expects wq [kh,kw,Cin,Cout], got {tuple(wq.shape)}")
    return wq.permute(3, 0, 1, 2).contiguous()


def _pads_or_raise(padding, wq: torch.Tensor) -> Pads:
    pads = _conv_pads(padding, wq.shape[0], wq.shape[1]) if wq.dim() == 4 else None
    if pads is None:
        raise ValueError(f"unsupported padding spec {padding!r}")
    return pads


def int8_conv2d_plain(x, wq, w_scale, *, padding="SAME", bias=None, act: str = "none", out_dtype=None):
    """Plain version of :func:`int8_conv2d` (JAX filter layout)."""
    return int8_conv2d_ohwi_plain(
        x, _hwio_to_ohwi(wq), w_scale, _pads_or_raise(padding, wq), bias=bias, act=act, out_dtype=out_dtype
    )


def int8_conv2d(x, wq, w_scale, *, padding="SAME", bias=None, act: str = "none", out_dtype=None):
    """Quantized-compute stride-1 undilated conv with the JAX package's
    signature: ``x`` [B,H,W,Cin] float, ``wq`` [kh,kw,Cin,Cout] int8,
    ``w_scale`` [Cout] f32, ``padding`` SAME/VALID/explicit pairs. CPU:
    plain version; CUDA: the kernel (the filter is transposed to its
    layout per call; :class:`QuantConv2d` keeps it transposed)."""
    return int8_conv2d_ohwi(
        x, _hwio_to_ohwi(wq), w_scale, _pads_or_raise(padding, wq), bias=bias, act=act, out_dtype=out_dtype
    )


# -- int8 matmul --------------------------------------------------------------

# TMA describes a row-major int8 operand only when its rows are a multiple
# of 16 bytes apart
GEMM_K_MULTIPLE = 16


def matmul_route(k: int) -> str:
    """The kernel :func:`int8_matmul` launches for reduction width ``k``,
    chosen from the shape before any launch: ``"gemm"`` (``csrc/
    int8_gemm.cu``) when TMA can describe the [M, K] and [N, K] operands,
    else ``"conv"`` (``csrc/int8_conv.cu`` as a 1x1 conv). Both give the
    same bits."""
    return "gemm" if k % GEMM_K_MULTIPLE == 0 else "conv"


def _launch_gemm(xq: torch.Tensor, xs, wk: torch.Tensor, w_scale, bias, out: torch.Tensor, act: str,
                 name: str = "int8_matmul") -> None:
    """One launch of ``csrc/int8_gemm.cu``: ``xq`` [M, K], ``wk`` [N, K]
    (copied when its base is not 16-byte aligned), ``out`` [M, N]; errors
    name the wrapper ``name``."""
    kernels._require_cuda(name, xq, wk, dtypes=(torch.int8,))
    kernels._require_cuda_f32(name, xs, w_scale, bias)
    kernels._require_cuda(name, out, dtypes=(torch.float32, torch.bfloat16))
    if wk.data_ptr() % 16:
        wk = wk.clone()
    (m, k), n = xq.shape, wk.shape[0]
    lib, fn = kernels._entry("tfdl_int8_gemm")
    with torch.cuda.device(xq.device):
        code = fn(
            xq.data_ptr(), wk.data_ptr(), xs.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            m, n, k, kernels.ACTIVATIONS[act], int(out.dtype == torch.bfloat16), kernels._stream(xq),
        )
    _build.check(lib, code, name)


def _launch_matmul(xq: torch.Tensor, xs, wk: torch.Tensor, w_scale, bias, out: torch.Tensor, act: str) -> None:
    """``out`` [M, N] = the int8 product of ``xq`` [M, K] and ``wk`` [N, K]
    with the epilogue, through the kernel :func:`matmul_route` picks."""
    (m, k), n = xq.shape, wk.shape[0]
    if matmul_route(k) == "gemm":
        _launch_gemm(xq, xs, wk, w_scale, bias, out, act)
        kernels.LAUNCHES["int8_matmul_gemm"] += 1
        kernels.LAUNCHES["int8_matmul"] += 1
    else:
        _launch("int8_matmul", xq.reshape(1, 1, m, k), xs, wk, w_scale, bias, out, (1, 1, m, k, n, 1, 1),
                ((0, 0), (0, 0)), act)
        kernels.LAUNCHES["int8_matmul"] += 1


def _check_matmul(x, wq, w_scale, bias, act) -> None:
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    if wq.dim() != 2 or x.shape[-1] != wq.shape[0]:
        raise ValueError(f"x last dim {x.shape[-1]} != wq rows of {tuple(wq.shape)}")
    _check_epilogue_args(wq.shape[1], w_scale, bias, act)


def int8_matmul_plain(x, wq, w_scale, *, bias=None, act: str = "none", out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`int8_matmul`: exact integer product (float64
    sums), then the kernel's epilogue op by op."""
    _check_matmul(x, wq, w_scale, bias, act)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xq, xs = quantize_activations(x)
    acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.int32)
    return _epilogue_plain(acc, xs, w_scale, bias, act, out_dtype)


def int8_matmul(x, wq, w_scale, *, bias=None, act: str = "none", out_dtype=None) -> torch.Tensor:
    """Quantized-compute dense layer: ``x`` [..., K] float, ``wq`` [K, N]
    int8, ``w_scale`` [N] f32, ``bias`` [N] or None; [..., N] in
    ``out_dtype`` (default ``x.dtype``). CPU: plain version; CUDA: the
    kernel :func:`matmul_route` picks, counted as ``int8_matmul`` (the
    weight is transposed to the kernels' [N, K] per call;
    :class:`QuantLinear` keeps it transposed)."""
    _check_matmul(x, wq, w_scale, bias, act)
    if kernels._use_plain(x):
        return int8_matmul_plain(x, wq, w_scale, bias=bias, act=act, out_dtype=out_dtype)
    return int8_matmul_nk(x, wq.t().contiguous(), w_scale, bias=bias, act=act, out_dtype=out_dtype)


def int8_matmul_nk(x, wk, w_scale, *, bias=None, act: str = "none", out_dtype=None) -> torch.Tensor:
    """:func:`int8_matmul` with the weight in the kernel's layout ``wk``
    [N, K] (K contiguous per output feature: the layout of an
    ``nn.Linear`` weight). CPU: plain version; CUDA: the kernel
    :func:`matmul_route` picks."""
    _check_matmul(x, wk.t(), w_scale, bias, act)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if kernels._use_plain(x):
        return int8_matmul_plain(x, wk.t(), w_scale, bias=bias, act=act, out_dtype=out_dtype)
    n, k = wk.shape
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    xq, xs = quantize_activations(x)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _launch_matmul(xq.reshape(m, k), xs, wk, w_scale, bias, out, act)
    return out.reshape(*lead, n)


# -- the load-time module swap ----------------------------------------------------


def int8_eligible(conv: nn.Module) -> bool:
    """``make_int8_interceptor``'s rule for an ``nn.Conv``: 2-D, stride 1,
    undilated, one group, and a padding :func:`_conv_pads` accepts (the
    port's convolutions are all flax ``"SAME"``)."""
    from tensorflowdistributedlearning_tpu_torch.models.layers import Conv2dSame

    if not isinstance(conv, Conv2dSame) or conv.weight.dim() != 4 or conv.groups != 1:
        return False
    if tuple(conv.stride) != (1, 1) or tuple(conv.dilation) != (1, 1):
        return False
    kh, kw = conv.kernel_size
    return _conv_pads(conv.same_padding, kh, kw) is not None


class QuantConv2d(nn.Module):
    """An int8-compute convolution: the int8 filter in the kernel's layout
    [Cout, kh, kw, Cin], its f32 per-output-channel scale, the f32 bias (or
    none); NHWC in, ``out_dtype`` (bf16) out through :func:`int8_conv2d_ohwi`."""

    def __init__(self, q_oihw: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], pads: Pads,
                 out_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if q_oihw.dtype != torch.int8 or q_oihw.dim() != 4:
            raise ValueError(f"QuantConv2d expects an int8 OIHW filter, got {q_oihw.dtype} {tuple(q_oihw.shape)}")
        self.register_buffer("weight_q", q_oihw.permute(0, 2, 3, 1).contiguous())
        self.register_buffer("w_scale", scale.float().contiguous())
        self.register_buffer("bias", None if bias is None else bias.float().contiguous())
        self.pads = pads
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv2d_ohwi(x, self.weight_q, self.w_scale, self.pads, bias=self.bias, act="none",
                                out_dtype=self.out_dtype)


class QuantLinear(nn.Module):
    """An int8-compute dense layer: the int8 weight [out, in] (the kernel's
    [N, K] layout), its f32 per-output-feature scale and the f32 bias (or
    none); ``[..., in]`` in, ``[..., out]`` in ``out_dtype`` (bf16) out
    through :func:`int8_matmul_nk`, the bias fused into the epilogue, no
    activation (the interceptor's ``nn.Dense`` rule)."""

    def __init__(self, q_nk: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor],
                 out_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if q_nk.dtype != torch.int8 or q_nk.dim() != 2:
            raise ValueError(f"QuantLinear expects an int8 [out, in] weight, got {q_nk.dtype} {tuple(q_nk.shape)}")
        self.register_buffer("weight_q", q_nk.contiguous())
        self.register_buffer("w_scale", scale.float().contiguous())
        self.register_buffer("bias", None if bias is None else bias.float().contiguous())
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul_nk(x, self.weight_q, self.w_scale, bias=self.bias, act="none", out_dtype=self.out_dtype)


def int8_targets(model: nn.Module, weight_names) -> Dict[str, Tuple[nn.Module, str, nn.Module]]:
    """``{path: (parent, child name, layer)}`` of the layers of ``model``
    that the interceptor's rule routes when every weight in
    ``weight_names`` (``{module}.weight`` keys) has an int8 record: each
    ``nn.Linear`` (the rule's ``nn.Dense`` arm) and each conv
    :func:`int8_eligible` takes. Grouped, strided or dilated convs and
    layers of other classes (the space-to-depth stem) are left out."""
    out: Dict[str, Tuple[nn.Module, str, nn.Module]] = {}
    for name, module in model.named_modules():
        for child_name, child in module.named_children():
            path = f"{name}.{child_name}" if name else child_name
            if f"{path}.weight" in weight_names and (isinstance(child, nn.Linear) or int8_eligible(child)):
                out[path] = (module, child_name, child)
    return out


def swap_int8_layers(model: nn.Module, records: Dict[str, Dict[str, torch.Tensor]],
                     biases: Dict[str, torch.Tensor], act_dtype: torch.dtype = torch.bfloat16) -> int:
    """The interceptor's rule as a module swap: every layer of ``model``
    with a ``{"q", "scale"}`` record (keyed ``{module}.weight``, the weight
    in the port's layout, the record's f32 scale) that :func:`int8_targets`
    takes, its bias from ``biases`` (keyed ``{module}.bias``; the bf16
    leaf, used as f32, as JAX's fused epilogue uses it), becomes

    - a :class:`QuantLinear` when it is an ``nn.Linear`` (the weight
      [out, in]): every ``nn.Dense`` with a record goes through
      ``int8_matmul``, the classifiers' ``logits`` included;
    - a :class:`QuantConv2d` when it is an eligible conv (the filter OIHW).

    Both return ``act_dtype``. Other layers keep their dequantized float
    path. Returns the number of layers swapped."""
    targets = int8_targets(model, records)
    for path, (module, child_name, child) in targets.items():
        rec = records[f"{path}.weight"]
        bias = biases.get(f"{path}.bias") if child.bias is not None else None
        if isinstance(child, nn.Linear):
            quant = QuantLinear(rec["q"], rec["scale"], bias, act_dtype)
        else:
            kh, kw = child.kernel_size
            quant = QuantConv2d(rec["q"], rec["scale"], bias, _conv_pads(child.same_padding, kh, kw), act_dtype)
        setattr(module, child_name, quant.to(child.weight.device))
    return len(targets)
