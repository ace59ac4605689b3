"""The serve path's kernels, each with its plain PyTorch version.

Counterpart of ``tensorflowdistributedlearning_tpu/ops/pallas_kernels.py``.
The Pallas TPU kernels become hand-written CUDA kernels for Hopper
(``csrc/*.cu``, built by ``ops/_build.py``):

- :func:`depthwise_conv2d` — stride-1 SAME depthwise conv with atrous rate
  (``csrc/depthwise.cu``), forward only;
- :func:`fused_bn_act` — inference BN + activation (+ residual)
  (``csrc/bn_act.cu``);
- :func:`fused_sigmoid_mask` — the segmentation serve head
  (``csrc/sigmoid_mask.cu``), bit-identical to its plain version.

Dispatch: the tensor's device picks the arm and nothing else does. A CPU
tensor takes the plain version (``*_plain``); a CUDA tensor launches the
kernel or raises. Public functions keep the JAX layout (NHWC activations,
``[kh, kw, C]`` depthwise filters). Each wrapper adds one to its entry in
:data:`LAUNCHES` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflowdistributedlearning_tpu_torch.ops import _build

# kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES: Dict[str, int] = {
    "depthwise_conv2d": 0,
    "fused_bn_act": 0,
    "fused_sigmoid_mask": 0,
}

# activation codes shared with csrc/bn_act.cu
ACTIVATIONS = {"none": 0, "relu": 1, "relu6": 2, "sigmoid": 3, "gelu": 4}

_c_void = ctypes.c_void_p
_signatures = {
    "depthwise": (
        "tfdl_depthwise_conv2d_f32",
        [_c_void, _c_void, _c_void] + [ctypes.c_int] * 7 + [_c_void],
    ),
    "bn_act": (
        "tfdl_bn_act_f32",
        [_c_void] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, _c_void],
    ),
    "sigmoid_mask": (
        "tfdl_sigmoid_mask_f32",
        [_c_void] * 3 + [ctypes.c_int64, ctypes.c_float, _c_void],
    ),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _entry(lib_name: str):
    """The C entry point of ``csrc/{lib_name}.cu`` with argtypes set (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib = _build.library(lib_name)
    fn_name, argtypes = _signatures[lib_name]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _require_cuda_f32(name: str, *tensors: Optional[torch.Tensor]) -> None:
    device = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}")
        device = t.device
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only in this port, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors (NHWC), got strides {t.stride()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- depthwise conv -----------------------------------------------------------


def _check_depthwise(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 3:
        raise ValueError(f"depthwise_conv2d expects x [B,H,W,C], w [kh,kw,C]; got {tuple(x.shape)}, {tuple(w.shape)}")
    kh, kw, c = w.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"depthwise_conv2d requires odd kernel dims, got {kh}x{kw}")
    if x.shape[-1] != c:
        raise ValueError(f"channel mismatch: x has {x.shape[-1]}, w has {c}")


def depthwise_conv2d_plain(x: torch.Tensor, w: torch.Tensor, rate: int = 1) -> torch.Tensor:
    """Plain version: grouped convolution on the NCHW view, the counterpart
    of ``depthwise_conv2d_reference``. ``x`` [B,H,W,C], ``w`` [kh,kw,C];
    returns [B,H,W,C]."""
    _check_depthwise(x, w)
    kh, kw, c = w.shape
    weight = w.permute(2, 0, 1).unsqueeze(1)  # [C, 1, kh, kw]
    pad = (rate * (kh - 1) // 2, rate * (kw - 1) // 2)
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), padding=pad, dilation=rate, groups=c)
    return out.permute(0, 2, 3, 1)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, rate: int = 1) -> torch.Tensor:
    """Stride-1 SAME depthwise conv; ``x`` [B,H,W,C], ``w`` [kh,kw,C],
    ``rate`` the atrous dilation. CPU: plain version; CUDA: the kernel."""
    _check_depthwise(x, w)
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, w, rate)
    _require_cuda_f32("depthwise_conv2d", x, w)
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    out = torch.empty_like(x)
    lib, fn = _entry("depthwise")
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, kh, kw, int(rate), _stream(x))
    _build.check(lib, code, "depthwise_conv2d")
    LAUNCHES["depthwise_conv2d"] += 1
    return out


# -- fused inference BN + activation (+ residual) ------------------------------


def fold_bn(
    scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as a per-channel affine ``y = x*m + b`` with
    ``m = scale*rsqrt(var+eps)``, ``b = bias - mean*m``, in float32 (the
    counterpart of ``_fold_bn``)."""
    m = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * m
    return m, b


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if act == "sigmoid":
        return torch.sigmoid(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")  # jax.nn.gelu's default form
    raise ValueError(f"act {act!r} not in {sorted(ACTIVATIONS)}")


def _check_bn_act(x, m, b, act, residual) -> None:
    if act not in ACTIVATIONS:
        raise ValueError(f"act {act!r} not in {sorted(ACTIVATIONS)}")
    if x.dim() != 4:
        raise ValueError(f"fused_bn_act expects [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    for name, v in (("m", m), ("b", b)):
        if tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be [{c}] to match x's channels, got {tuple(v.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != x shape {tuple(x.shape)}")


def bn_act_folded_plain(
    x: torch.Tensor, m: torch.Tensor, b: torch.Tensor, act: str = "relu",
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel body: ``act(x*m + b [+ residual])``."""
    _check_bn_act(x, m, b, act, residual)
    y = x * m + b
    if residual is not None:
        y = y + residual
    return _activate(y, act)


def bn_act_folded(
    x: torch.Tensor, m: torch.Tensor, b: torch.Tensor, act: str = "relu",
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``act(x*m + b [+ residual])`` over NHWC ``x`` with already-folded
    [C] vectors — what a module with a cached fold calls. CPU: plain
    version; CUDA: the kernel."""
    _check_bn_act(x, m, b, act, residual)
    if x.device.type == "cpu":
        return bn_act_folded_plain(x, m, b, act, residual)
    _require_cuda_f32("fused_bn_act", x, m, b, residual)
    out = torch.empty_like(x)
    lib, fn = _entry("bn_act")
    r_ptr = residual.data_ptr() if residual is not None else None
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), m.data_ptr(), b.data_ptr(), r_ptr, out.data_ptr(),
            x.numel(), x.shape[-1], ACTIVATIONS[act], _stream(x),
        )
    _build.check(lib, code, "fused_bn_act")
    LAUNCHES["fused_bn_act"] += 1
    return out


def fused_bn_act_plain(
    x, scale, bias, mean, var, *, eps: float = 1e-3, act: str = "relu", residual=None
) -> torch.Tensor:
    """Plain version of :func:`fused_bn_act` (counterpart of
    ``fused_bn_act_reference``)."""
    m, b = fold_bn(scale, bias, mean, var, eps)
    return bn_act_folded_plain(x, m, b, act, residual)


def fused_bn_act(
    x, scale, bias, mean, var, *, eps: float = 1e-3, act: str = "relu", residual=None
) -> torch.Tensor:
    """Fused inference BN + activation (+ residual add): ``x`` [B,H,W,C],
    four [C] BN vectors, optional residual [B,H,W,C]. The fold runs in f32
    torch ops; the elementwise pass is the kernel on CUDA."""
    m, b = fold_bn(scale, bias, mean, var, eps)
    return bn_act_folded(x, m, b, act, residual)


# -- fused sigmoid + threshold mask head ----------------------------------------


def fused_sigmoid_mask_plain(logits: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version — literally the unfused head: ``sigmoid`` in the logits
    dtype, then ``(p > threshold)`` as float32. The kernel must match it bit
    for bit."""
    probs = torch.sigmoid(logits)
    return probs, (probs > threshold).float()


def fused_sigmoid_mask(logits: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigmoid(logits), (sigmoid(logits) > threshold).float32)`` from one
    read of the logits. CPU: plain version; CUDA: the kernel."""
    if logits.device.type == "cpu":
        return fused_sigmoid_mask_plain(logits, threshold)
    _require_cuda_f32("fused_sigmoid_mask", logits)
    probs = torch.empty_like(logits)
    mask = torch.empty_like(logits)
    lib, fn = _entry("sigmoid_mask")
    with torch.cuda.device(logits.device):
        code = fn(
            logits.data_ptr(), probs.data_ptr(), mask.data_ptr(), logits.numel(),
            float(threshold), _stream(logits),
        )
    _build.check(lib, code, "fused_sigmoid_mask")
    LAUNCHES["fused_sigmoid_mask"] += 1
    return probs, mask
