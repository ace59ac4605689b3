"""The port's kernels, each with its plain PyTorch version.

Counterpart of ``tensorflowdistributedlearning_tpu/ops/pallas_kernels.py``.
The Pallas TPU kernels become hand-written CUDA kernels for Hopper
(``csrc/*.cu``, built by ``ops/_build.py``):

- :func:`depthwise_conv2d` — stride-1 SAME depthwise conv with atrous rate,
  differentiable (:class:`DepthwiseConv2dFunction`, the custom VJP's
  counterpart): forward ``csrc/depthwise.cu``'s tiled kernel; dx the same
  kernel with the filter flipped in space by index; dw
  ``csrc/depthwise_dw.cu``'s band kernel, planned on the host by
  :func:`dw_plan` (other shapes: the earlier tile kernel). Each takes
  float32 or bfloat16 tensors (bf16 loads, float32 sums, bf16 stores, as
  the TPU kernel takes any dtype and accumulates in float32);
- :func:`fused_bn_act` — inference BN + activation (+ residual)
  (``csrc/bn_act.cu``'s row kernel: 16-byte loads, no division per
  element), float32 or bfloat16 activations with the float32 fold,
  inference-only as the TPU kernel is; with bfloat16 parameters
  (the quantized serving specs) :func:`bn_act_unfolded` repeats flax's own
  order and roundings;
- :func:`fused_bias_act` — per-channel bias + activation over the last axis
  (``csrc/bias_act.cu``: 16-byte column vectors walked down the rows where
  :func:`bias_act_plan` gives a plan, the earlier one-thread-per-element
  kernel otherwise), the standalone face of the epilogue that the int8
  kernels (``ops/quant_kernels.py``) share through ``csrc/epilogue.cuh``;
- :func:`fused_sigmoid_mask` — the segmentation serve head
  (``csrc/sigmoid_mask.cu``: float4 loads and stores where every base is
  16-byte aligned), bit-identical to its plain version.

The int8 kernels' wrappers live in ``ops/quant_kernels.py`` and the
attention kernels' in ``ops/flash_attention.py``; their counters and C
entry points are registered here with the others.

Dispatch: the tensor's device picks the arm and nothing else does. A CPU
tensor takes the plain version (``*_plain``); a CUDA tensor launches the
kernel or raises. Public functions keep the JAX layout (NHWC activations,
``[kh, kw, C]`` depthwise filters). Each wrapper adds one to its entry in
:data:`LAUNCHES` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflowdistributedlearning_tpu_torch.ops import _build

# kernel launches since the last reset_launch_counts(), by wrapper name; a
# wrapper with two kernels counts all its launches under its own name and
# one arm's again apart (flash_attention_tc: the bf16 tensor-core arm;
# int8_matmul_gemm: the GEMM route, the rest went through int8_conv.cu;
# depthwise_conv2d_dw_band: dw through the band kernel, the rest through the
# earlier tile kernel; depthwise_conv2d_bf16, _dx_bf16, _dw_bf16 and
# fused_bn_act_bf16_act: the bf16-activation arms (fused_bn_act_bf16 is the
# arm for bf16 parameters);
# int8_conv2d_gemm / int8_conv2d_tc: the 1x1 convs through int8_gemm.cu and
# the k x k convs through int8_conv_tc.cu, the rest through int8_conv.cu)
LAUNCHES: Dict[str, int] = {
    "depthwise_conv2d": 0,
    "depthwise_conv2d_dx": 0,
    "depthwise_conv2d_dw": 0,
    "depthwise_conv2d_dw_band": 0,
    "depthwise_conv2d_bf16": 0,
    "depthwise_conv2d_dx_bf16": 0,
    "depthwise_conv2d_dw_bf16": 0,
    "fused_bn_act": 0,
    "fused_bn_act_bf16": 0,
    "fused_bn_act_bf16_act": 0,
    "fused_bias_act": 0,
    "fused_sigmoid_mask": 0,
    "int8_conv2d": 0,
    "int8_conv2d_gemm": 0,
    "int8_conv2d_tc": 0,
    "int8_matmul": 0,
    "int8_matmul_gemm": 0,
    "flash_attention": 0,
    "flash_attention_tc": 0,
}

# activation codes shared with csrc/epilogue.cuh
ACTIVATIONS = {"none": 0, "relu": 1, "relu6": 2, "sigmoid": 3, "gelu": 4}

_c_void = ctypes.c_void_p
_c_int = ctypes.c_int
# C entry point -> (library = csrc/{library}.cu, argtypes)
_signatures = {
    "tfdl_depthwise_tiled_f32": ("depthwise", [_c_void] * 3 + [_c_int] * 8 + [_c_void]),
    "tfdl_depthwise_tiled_bf16": ("depthwise", [_c_void] * 3 + [_c_int] * 8 + [_c_void]),
    "tfdl_depthwise_conv2d_f32": ("depthwise", [_c_void] * 3 + [_c_int] * 7 + [_c_void]),
    "tfdl_depthwise_dw_f32": (
        "depthwise_dw", [_c_void] * 4 + [_c_int] * 7 + [ctypes.c_int64, ctypes.c_int64, _c_void],
    ),
    "tfdl_depthwise_dw_bf16": (
        "depthwise_dw", [_c_void] * 4 + [_c_int] * 7 + [ctypes.c_int64, ctypes.c_int64, _c_void],
    ),
    "tfdl_depthwise_dw_band_f32": ("depthwise_dw", [_c_void] * 4 + [_c_int] * 11 + [_c_void]),
    "tfdl_depthwise_dw_band_bf16": ("depthwise_dw", [_c_void] * 4 + [_c_int] * 11 + [_c_void]),
    "tfdl_bn_act_f32": ("bn_act", [_c_void] * 5 + [ctypes.c_int64, _c_int, _c_int, _c_void]),
    "tfdl_bn_act_unfolded": (
        "bn_act", [_c_void, _c_int] + [_c_void] * 4 + [ctypes.c_int64, _c_int, _c_int, _c_void],
    ),
    "tfdl_bn_act_rows_f32": ("bn_act", [_c_void] * 5 + [ctypes.c_int64, _c_int, _c_int, _c_int, _c_void]),
    "tfdl_bn_act_rows_bf16": ("bn_act", [_c_void] * 5 + [ctypes.c_int64, _c_int, _c_int, _c_int, _c_void]),
    "tfdl_bn_act_rows_unfolded": (
        "bn_act", [_c_void, _c_int] + [_c_void] * 4 + [ctypes.c_int64, _c_int, _c_int, _c_int, _c_void],
    ),
    "tfdl_bias_act": ("bias_act", [_c_void, _c_int, _c_void, _c_void, ctypes.c_int64, _c_int, _c_int, _c_void]),
    "tfdl_bias_act_vec": (
        "bias_act", [_c_void, _c_int, _c_void, _c_void, ctypes.c_int64] + [_c_int] * 4 + [_c_void],
    ),
    "tfdl_sigmoid_mask_f32": ("sigmoid_mask", [_c_void] * 3 + [ctypes.c_int64, ctypes.c_float, _c_void]),
    "tfdl_sigmoid_mask_vec_f32": ("sigmoid_mask", [_c_void] * 3 + [ctypes.c_int64, ctypes.c_float, _c_int, _c_void]),
    "tfdl_int8_conv2d": ("int8_conv", [_c_void] * 6 + [_c_int] * 14 + [_c_void]),
    "tfdl_int8_conv2d_tc": ("int8_conv_tc", [_c_void] * 6 + [_c_int] * 13 + [_c_void]),
    "tfdl_int8_gemm": ("int8_gemm", [_c_void] * 6 + [_c_int] * 5 + [_c_void]),
    "tfdl_flash_attention": (
        "flash_attention", [_c_void] * 4 + [_c_int] * 5 + [ctypes.c_int64] * 9 + [_c_int, ctypes.c_float, _c_void],
    ),
    "tfdl_flash_attention_f32": (
        "flash_attention_f32", [_c_void] * 4 + [_c_int] * 5 + [ctypes.c_int64] * 9 + [_c_int, ctypes.c_float, _c_void],
    ),
    "tfdl_flash_attention_tc": (
        "flash_attention_tc", [_c_void] * 4 + [_c_int] * 5 + [ctypes.c_int64] * 9 + [_c_int, ctypes.c_float, _c_void],
    ),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _entry(fn_name: str):
    """``(library, C entry point)`` with argtypes set (every pointer and the
    stream as ``c_void_p``, so none is cut to 32 bits)."""
    lib_name, argtypes = _signatures[fn_name]
    lib = _build.library(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _require_cuda_f32(name: str, *tensors: Optional[torch.Tensor]) -> None:
    _require_cuda(name, *tensors, dtypes=(torch.float32,))


def _require_cuda(name: str, *tensors: Optional[torch.Tensor], dtypes: Tuple[torch.dtype, ...]) -> None:
    """Every tensor on one CUDA device, contiguous and of one of ``dtypes``
    (the kernel's own types: each wrapper widens this only as far as its
    kernel goes)."""
    device = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device, got {t.device}")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: tensors on {device} and {t.device}")
        device = t.device
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the kernel takes {[str(d) for d in dtypes]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors (NHWC), got strides {t.stride()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _use_plain(t: torch.Tensor) -> bool:
    """The dispatch rule: a CPU tensor takes the plain version; any other
    device launches the kernel (and raises where it cannot)."""
    return t.device.type == "cpu"


# -- depthwise conv -----------------------------------------------------------

# pixels of (b, y, x) per block of the earlier dw kernel: 128 rows spread over
# its 8 lanes, with the tile count held under the grid's y limit
_DW_TILE_ROWS = 128
_DW_MAX_TILES = 65535
_DW_MAX_SIDE = 7

# the dw band kernel's block (csrc/depthwise_dw.cu) and the H100 limits its
# plan is made for
DW_BAND_THREADS = 256
DW_BAND_WARPS = DW_BAND_THREADS // 32
DW_BAND_CHANNELS = (32, 16, 8, 4)  # channels a block, widest first
H100_SMS = 132
H100_SMEM_BLOCK = 232448  # 227 KB: the most shared memory one block may use
H100_SMEM_SM = 233472  # 228 KB an SM holds, 1 KB of it reserved per block
H100_THREADS_SM = 2048


@dataclass(frozen=True)
class DwPlan:
    """How the dw band kernel cuts its work: a block owns ``channels``
    channels (of ``slices``), one band of ``band_rows`` rows (of ``bands``)
    and ``images`` consecutive images (of ``groups`` groups), staged
    ``stages`` at a time in ``smem_bytes`` of shared memory."""

    channels: int
    slices: int
    band_rows: int
    bands: int
    images: int
    groups: int
    stages: int
    smem_bytes: int

    @property
    def tiles(self) -> int:
        """Partial sums per channel: one per (image group, band)."""
        return self.groups * self.bands

    @property
    def blocks(self) -> int:
        return self.tiles * self.slices


def dw_band_smem(
    h: int, w: int, kh: int, kw: int, rate: int, channels: int, band_rows: int, stages: int, itemsize: int = 4
) -> int:
    """Shared-memory bytes of the band kernel, as its C entry computes them:
    ``stages`` copies of a band of g and its x rows with the halo clipped to
    the image, in elements of ``itemsize`` bytes (4 float32, 2 bfloat16),
    or the warps' float32 tap sums, whichever is larger."""
    ph = rate * (kh - 1) // 2
    stage = (min(h, band_rows + 2 * ph) + band_rows) * w * channels
    return max(itemsize * stages * stage, 4 * DW_BAND_WARPS * kh * kw * channels)


def dw_plan(
    b: int, h: int, w: int, c: int, kh: int, kw: int, rate: int, aligned: bool, itemsize: int = 4
) -> Optional[DwPlan]:
    """The band kernel's plan for dw of x, g [b, h, w, c] with a kh x kw
    filter at ``rate`` and elements of ``itemsize`` bytes, or None where the
    earlier tile kernel takes the call (c % 4 != 0, a base of x or g not
    aligned to a thread's 4 channels, 16 bytes in float32 and 8 in
    bfloat16, an empty tensor, or no band of one row that fits in shared
    memory).

    The widest channel slice and the tallest band that fill the 132 SMs
    with one image a block (else the fitting pair with the most blocks);
    then images a block in two stages, so that the blocks make about one
    wave of what the SMs hold at once."""
    if c % 4 or not aligned or b * h * w * c == 0:
        return None
    widest = 4
    while widest < min(c, DW_BAND_CHANNELS[0]):
        widest *= 2
    best = None  # (blocks, channels, band_rows)
    for channels in (cs for cs in DW_BAND_CHANNELS if cs <= widest):
        slices = -(-c // channels)
        for band_rows in sorted({-(-h // n) for n in range(1, h + 1)}, reverse=True):
            if dw_band_smem(h, w, kh, kw, rate, channels, band_rows, 1, itemsize) > H100_SMEM_BLOCK:
                continue
            blocks = b * -(-h // band_rows) * slices
            if best is None or blocks > best[0]:
                best = (blocks, channels, band_rows)
            if blocks >= H100_SMS:
                break
        if best is not None and best[0] >= H100_SMS:
            break
    if best is None:
        return None
    _, channels, band_rows = best
    slices, bands = -(-c // channels), -(-h // band_rows)
    for stages in (2, 1):
        smem = dw_band_smem(h, w, kh, kw, rate, channels, band_rows, stages, itemsize)
        if smem > H100_SMEM_BLOCK:
            continue
        per_sm = min(H100_THREADS_SM // DW_BAND_THREADS, H100_SMEM_SM // (smem + 1024))
        images = min(b, -(-(b * bands * slices) // (H100_SMS * per_sm)))
        groups = -(-b // images)
        images = -(-b // groups)
        if images > 1 or stages == 1:
            break
    return DwPlan(channels, slices, band_rows, bands, images, groups, stages, smem)


def _check_depthwise(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 3:
        raise ValueError(f"depthwise_conv2d expects x [B,H,W,C], w [kh,kw,C]; got {tuple(x.shape)}, {tuple(w.shape)}")
    kh, kw, c = w.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"depthwise_conv2d requires odd kernel dims, got {kh}x{kw}")
    if x.shape[-1] != c:
        raise ValueError(f"channel mismatch: x has {x.shape[-1]}, w has {c}")


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic: float32 for bf16 (and float32)
    inputs, as the kernels sum; float64 where a test asks for it."""
    return torch.promote_types(x.dtype, torch.float32)


def depthwise_conv2d_plain(x: torch.Tensor, w: torch.Tensor, rate: int = 1) -> torch.Tensor:
    """Plain version: grouped convolution on the NCHW view, the counterpart
    of ``depthwise_conv2d_reference``. ``x`` [B,H,W,C], ``w`` [kh,kw,C];
    returns [B,H,W,C] in ``x``'s dtype. A bfloat16 ``x`` is computed in
    float32 and rounded once, the kernel's rule and the TPU kernel's (f32
    sums, out in ``x.dtype``). Differentiable through PyTorch's own
    autograd."""
    _check_depthwise(x, w)
    kh, kw, c = w.shape
    weight = w.permute(2, 0, 1).unsqueeze(1)  # [C, 1, kh, kw]
    pad = (rate * (kh - 1) // 2, rate * (kw - 1) // 2)
    cdt = _sum_dtype(x)
    out = F.conv2d(x.permute(0, 3, 1, 2).to(cdt), weight.to(cdt), padding=pad, dilation=rate, groups=c)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _dx_plain(g: torch.Tensor, w: torch.Tensor, rate: int) -> torch.Tensor:
    return depthwise_conv2d_plain(g, w.flip(0, 1), rate)


def _dw_plain(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int, rate: int) -> torch.Tensor:
    """dw in float32 (float32 sums of bf16 inputs; float64 stays float64)."""
    x, g = x.to(_sum_dtype(x)), g.to(_sum_dtype(x))
    h, wd = x.shape[1], x.shape[2]
    ph, pw = rate * (kh - 1) // 2, rate * (kw - 1) // 2
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    rows = []
    for i in range(kh):
        row = []
        for j in range(kw):
            tap = xp[:, i * rate : i * rate + h, j * rate : j * rate + wd, :]
            row.append((tap * g).sum(dim=(0, 1, 2)))
        rows.append(torch.stack(row))
    return torch.stack(rows)


def depthwise_conv2d_backward_plain(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, rate: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``(dx, dw)`` of :func:`depthwise_conv2d`, written as the JAX
    VJP (``_dw_bwd``) writes it: dx is the grouped conv of ``g`` with the
    spatially flipped filter (stride-1 SAME, symmetric padding, odd sides);
    dw[i, j, c] is the sum over (B, H, W) of ``g`` times ``x`` shifted by
    tap (i, j), zero outside, summed in float32 and returned in ``w``'s
    dtype (``_dw_bwd``'s ``dw.astype(w.dtype)``)."""
    _check_depthwise(x, w)
    kh, kw, _ = w.shape
    return _dx_plain(g, w, rate), _dw_plain(x, g, kh, kw, rate).to(w.dtype)


def _require_one_dtype(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """The depthwise kernels' types: every tensor float32, or every one
    bfloat16 (on one CUDA device, contiguous)."""
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16 tensors, got {dtype}")
    _require_cuda(name, *tensors, dtypes=(dtype,))
    return dtype


def _launch_depthwise(x: torch.Tensor, w: torch.Tensor, rate: int, flip: bool, name: str) -> torch.Tensor:
    """One launch of ``csrc/depthwise.cu``'s tiled kernel: the conv of
    ``x`` with ``w``, or with ``w`` flipped in space when ``flip`` (dx),
    the flip an index in the kernel; float32, or bfloat16 (its bf16 arm,
    counted again as ``{name}_bf16``). Counts one launch under ``name``."""
    bf16 = _require_one_dtype(name, x, w) == torch.bfloat16
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    out = torch.empty_like(x)
    lib, fn = _entry("tfdl_depthwise_tiled_bf16" if bf16 else "tfdl_depthwise_tiled_f32")
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, kh, kw, int(rate), int(flip), _stream(x))
    _build.check(lib, code, name)
    LAUNCHES[name] += 1
    if bf16:
        LAUNCHES[f"{name}_bf16"] += 1
    return out


def _earlier_depthwise(x: torch.Tensor, w: torch.Tensor, rate: int, flip: bool) -> torch.Tensor:
    """The earlier depthwise kernel (``tfdl_depthwise_kernel`` of
    ``csrc/depthwise.cu``), launched as the wrappers launched it before the
    tiled kernel: dx on a flipped copy of ``w``. Kept to be timed and held
    bit for bit beside the tiled kernel; no path calls it, and it counts
    nothing."""
    _require_cuda_f32("depthwise_conv2d (earlier kernel)", x, w)
    if flip:
        w = w.flip(0, 1).contiguous()
    b, h, wd, c = x.shape
    kh, kw, _ = w.shape
    out = torch.empty_like(x)
    lib, fn = _entry("tfdl_depthwise_conv2d_f32")
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, kh, kw, int(rate), _stream(x))
    _build.check(lib, code, "depthwise_conv2d (earlier kernel)")
    return out


def depthwise_conv2d_forward(x: torch.Tensor, w: torch.Tensor, rate: int = 1) -> torch.Tensor:
    """The forward pass alone, without autograd. CPU: plain version; CUDA:
    ``csrc/depthwise.cu``."""
    _check_depthwise(x, w)
    if _use_plain(x):
        with torch.no_grad():
            return depthwise_conv2d_plain(x, w, rate)
    return _launch_depthwise(x, w, rate, False, "depthwise_conv2d")


def depthwise_conv2d_dx(g: torch.Tensor, w: torch.Tensor, rate: int = 1) -> torch.Tensor:
    """Input gradient: the forward kernel on ``w`` flipped in space, one
    launch with the flip as an index (exact for stride-1 SAME with symmetric
    padding and odd sides, which ``_check_depthwise`` enforces). CPU: plain
    version; CUDA: the kernel."""
    _check_depthwise(g, w)
    if _use_plain(g):
        with torch.no_grad():
            return _dx_plain(g, w, rate)
    return _launch_depthwise(g, w, rate, True, "depthwise_conv2d_dx")


def _aligned(*tensors: torch.Tensor, to: int = 16) -> bool:
    return all(t.data_ptr() % to == 0 for t in tensors)


def _launch_dw_tiles(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int, rate: int, name: str) -> torch.Tensor:
    """One call of the earlier dw kernel (``tfdl_depthwise_dw_partial_kernel``
    and its tile sum), at any shape, float32 partial sums; dw in ``x``'s
    dtype. Counts nothing."""
    b, h, wd, c = x.shape
    pixels = b * h * wd
    tile_rows = max(_DW_TILE_ROWS, -(-pixels // _DW_MAX_TILES))
    tiles = max(1, -(-pixels // tile_rows))
    partial = torch.empty((tiles, kh * kw, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((kh, kw, c), dtype=x.dtype, device=x.device)
    lib, fn = _entry("tfdl_depthwise_dw_bf16" if x.dtype == torch.bfloat16 else "tfdl_depthwise_dw_f32")
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), b, h, wd, c, kh, kw,
            int(rate), tiles, tile_rows, _stream(x),
        )
    _build.check(lib, code, name)
    return dw


def _check_dw(x: torch.Tensor, g: torch.Tensor, kernel_size: Tuple[int, int]) -> Tuple[int, int]:
    kh, kw = int(kernel_size[0]), int(kernel_size[1])
    if x.dim() != 4 or g.shape != x.shape:
        raise ValueError(f"depthwise_conv2d_dw expects x and g of one [B,H,W,C] shape, got {tuple(x.shape)}, {tuple(g.shape)}")
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"depthwise_conv2d requires odd kernel dims, got {kh}x{kw}")
    return kh, kw


def _require_dw_cuda(name: str, x: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> None:
    _require_one_dtype(name, x, g)
    if kh > _DW_MAX_SIDE or kw > _DW_MAX_SIDE:
        raise ValueError(f"{name}: the CUDA kernels take sides up to {_DW_MAX_SIDE}, got {kh}x{kw}")


def dw_route(x: torch.Tensor, g: torch.Tensor, kernel_size: Tuple[int, int], rate: int = 1) -> Optional[DwPlan]:
    """The band kernel's plan for this call, or None for the earlier tile
    kernel: chosen from the shape, the dtype and the bases' alignment (a
    thread's 4 channels: 16 bytes, 8 in bfloat16), before any launch."""
    b, h, wd, c = x.shape
    itemsize = x.element_size()
    return dw_plan(b, h, wd, c, int(kernel_size[0]), int(kernel_size[1]), int(rate),
                   _aligned(x, g, to=4 * itemsize), itemsize)


def depthwise_conv2d_dw(
    x: torch.Tensor, g: torch.Tensor, kernel_size: Tuple[int, int], rate: int = 1
) -> torch.Tensor:
    """Filter gradient ``[kh, kw, C]`` of the conv of ``x`` whose output
    gradient is ``g`` (both [B,H,W,C], float32 or both bfloat16), summed in
    float32 and returned in their dtype. CPU: plain version; CUDA:
    ``csrc/depthwise_dw.cu`` (odd sides up to 7; bit-reproducible), the band
    kernel where :func:`dw_route` plans one (counted again as
    ``depthwise_conv2d_dw_band``), else the earlier tile kernel; bf16
    inputs counted again as ``depthwise_conv2d_dw_bf16``."""
    kh, kw = _check_dw(x, g, kernel_size)
    if _use_plain(x):
        with torch.no_grad():
            return _dw_plain(x, g, kh, kw, rate).to(x.dtype)
    _require_dw_cuda("depthwise_conv2d_dw", x, g, kh, kw)
    bf16 = x.dtype == torch.bfloat16
    plan = dw_route(x, g, (kh, kw), rate)
    if plan is None:
        dw = _launch_dw_tiles(x, g, kh, kw, rate, "depthwise_conv2d_dw")
    else:
        b, h, wd, c = x.shape
        partial = torch.empty((plan.tiles, kh * kw, c), dtype=torch.float32, device=x.device)
        dw = torch.empty((kh, kw, c), dtype=x.dtype, device=x.device)
        lib, fn = _entry("tfdl_depthwise_dw_band_bf16" if bf16 else "tfdl_depthwise_dw_band_f32")
        with torch.cuda.device(x.device):
            code = fn(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), b, h, wd, c, kh, kw, int(rate),
                plan.channels, plan.band_rows, plan.images, plan.stages, _stream(x),
            )
        _build.check(lib, code, "depthwise_conv2d_dw")
        LAUNCHES["depthwise_conv2d_dw_band"] += 1
    LAUNCHES["depthwise_conv2d_dw"] += 1
    if bf16:
        LAUNCHES["depthwise_conv2d_dw_bf16"] += 1
    return dw


def _earlier_depthwise_dw(
    x: torch.Tensor, g: torch.Tensor, kernel_size: Tuple[int, int], rate: int = 1
) -> torch.Tensor:
    """The earlier dw kernel (``tfdl_depthwise_dw_partial_kernel`` of
    ``csrc/depthwise_dw.cu``) at every shape, as the wrapper launched it
    before the band kernel. Kept to be timed beside the band kernel; no path
    calls it, and it counts nothing."""
    kh, kw = _check_dw(x, g, kernel_size)
    _require_dw_cuda("depthwise_conv2d_dw (earlier kernel)", x, g, kh, kw)
    return _launch_dw_tiles(x, g, kh, kw, rate, "depthwise_conv2d_dw (earlier kernel)")


class DepthwiseConv2dFunction(torch.autograd.Function):
    """Autograd of the depthwise conv, the counterpart of the JAX package's
    ``jax.custom_vjp`` (``pallas_kernels.py:155-200``): the forward kernel,
    then dx (forward kernel, filter flipped by index) and dw
    (``depthwise_dw.cu``'s band kernel, or its earlier tile kernel).
    Each arm follows its tensor's device, so CPU tensors train through the
    plain versions and CUDA tensors through the kernels."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, rate: int) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        ctx.rate = int(rate)
        return depthwise_conv2d_forward(x, w, rate)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = depthwise_conv2d_dx(g, w, ctx.rate) if ctx.needs_input_grad[0] else None
        dw = depthwise_conv2d_dw(x, g, w.shape[:2], ctx.rate) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, rate: int = 1) -> torch.Tensor:
    """Stride-1 SAME depthwise conv; ``x`` [B,H,W,C], ``w`` [kh,kw,C] of
    one dtype (float32, or bfloat16: the JAX layer casts the filter to the
    compute dtype), ``rate`` the atrous dilation. Differentiable in ``x``
    and ``w``; the gradients come in the inputs' dtype. CPU: plain
    versions; CUDA: the kernels."""
    _check_depthwise(x, w)
    return DepthwiseConv2dFunction.apply(x, w, int(rate))


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


def activate(y: torch.Tensor, act: str) -> torch.Tensor:
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


# the row kernels' 16-byte arm: a thread's four channels are one 16-byte
# word of every row (8 bytes of a bf16 row), so the channels come in fours
# and every base is 16-byte aligned
BN_VEC_CHANNELS = 4
BN_VEC_ALIGN = 16
# the bf16-activation row kernel's vector arm: a thread's eight channels are
# one 16-byte word of a bf16 row (and two of the float32 fold)
BN_VEC_CHANNELS_BF16 = 8


def bn_act_vectorized(c: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether the BN + act row kernels take their 16-byte arm for ``c``
    channels and these tensors (None entries ignored), chosen from shape
    and alignment before the launch; else their scalar arm. Same bits
    either way."""
    return c % BN_VEC_CHANNELS == 0 and all(t is None or t.data_ptr() % BN_VEC_ALIGN == 0 for t in tensors)


def bn_act_vectorized_bf16(c: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether the bf16-activation row kernel takes its vector arm (eight
    channels a thread: ``c % 8 == 0`` and every base 16-byte aligned, None
    entries ignored); else its scalar arm. Same bits either way."""
    return c % BN_VEC_CHANNELS_BF16 == 0 and all(t is None or t.data_ptr() % BN_VEC_ALIGN == 0 for t in tensors)


def bn_act_folded_plain(
    x: torch.Tensor, m: torch.Tensor, b: torch.Tensor, act: str = "relu",
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the kernel body: ``act(x*m + b [+ residual])`` in
    float32 (the product and each add rounded on its own), returned in
    ``x``'s dtype: the bf16 arm reads bf16 ``x`` and ``residual`` and
    rounds once at the end, as the TPU kernel writes ``x.dtype``."""
    _check_bn_act(x, m, b, act, residual)
    y = x.to(_sum_dtype(x)) * m + b
    if residual is not None:
        y = y + residual.to(y.dtype)
    return activate(y, act).to(x.dtype)


def bn_act_folded(
    x: torch.Tensor, m: torch.Tensor, b: torch.Tensor, act: str = "relu",
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``act(x*m + b [+ residual])`` over NHWC ``x`` with already-folded
    float32 [C] vectors — what a module with a cached fold calls; ``x``
    and ``residual`` float32, or both bfloat16 (out bf16). CPU: plain
    version; CUDA: the kernel (the bf16 arm counted again as
    ``fused_bn_act_bf16_act``), which refuses inputs that need a
    gradient."""
    _check_bn_act(x, m, b, act, residual)
    if _use_plain(x):
        return bn_act_folded_plain(x, m, b, act, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, m, b, residual)):
        raise RuntimeError(
            "fused_bn_act: the CUDA kernel is inference-only, as the TPU kernel is, and has "
            "no backward; call it under torch.no_grad() (eval), or train the model in "
            "training mode, whose BatchNorm uses batch statistics in plain ops"
        )
    bf16 = _require_one_dtype("fused_bn_act", *(t for t in (x, residual) if t is not None)) == torch.bfloat16
    _require_cuda_f32("fused_bn_act", m, b)
    if m.device != x.device:
        raise ValueError(f"fused_bn_act: tensors on {x.device} and {m.device}")
    out = torch.empty_like(x)
    c = x.shape[-1]
    vec = (bn_act_vectorized_bf16 if bf16 else bn_act_vectorized)(c, x, m, b, residual, out)
    lib, fn = _entry("tfdl_bn_act_rows_bf16" if bf16 else "tfdl_bn_act_rows_f32")
    r_ptr = residual.data_ptr() if residual is not None else None
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), m.data_ptr(), b.data_ptr(), r_ptr, out.data_ptr(), x.numel() // max(c, 1), c,
            ACTIVATIONS[act], int(vec), _stream(x),
        )
    _build.check(lib, code, "fused_bn_act")
    LAUNCHES["fused_bn_act"] += 1
    if bf16:
        LAUNCHES["fused_bn_act_bf16_act"] += 1
    return out


def _earlier_bn_act(
    x: torch.Tensor, m: torch.Tensor, b: torch.Tensor, act: str = "relu", residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The earlier kernel of :func:`bn_act_folded` (``tfdl_bn_act_f32``:
    one thread per element, the channel a 64-bit modulo). Kept to be timed
    and held bit for bit beside the row kernel; no path calls it, and it
    counts nothing."""
    _check_bn_act(x, m, b, act, residual)
    _require_cuda_f32("fused_bn_act (earlier kernel)", x, m, b, residual)
    out = torch.empty_like(x)
    lib, fn = _entry("tfdl_bn_act_f32")
    r_ptr = residual.data_ptr() if residual is not None else None
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), m.data_ptr(), b.data_ptr(), r_ptr, out.data_ptr(),
            x.numel(), x.shape[-1], ACTIVATIONS[act], _stream(x),
        )
    _build.check(lib, code, "fused_bn_act (earlier kernel)")
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


def unfold_bn_bf16(
    scale: Optional[torch.Tensor], bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """flax's inference BN vectors for bfloat16 parameters and statistics:
    ``mul = rsqrt(var + eps) [* scale]`` computed in bf16 (eps rounded to
    bf16, every op rounded to bf16, as ``flax.linen.normalization._normalize``
    does), returned with ``mean`` and ``bias`` as float32 tensors that hold
    bf16 values exactly: ``(mean, mul, bias)``."""
    bf16 = torch.bfloat16
    # rsqrt in f32, rounded once (XLA's bf16 rsqrt; PyTorch's own bf16
    # rsqrt on the CPU rounds twice)
    mul = torch.rsqrt((var.to(bf16) + torch.tensor(eps, dtype=bf16, device=var.device)).float()).to(bf16)
    if scale is not None:
        mul = mul * scale.to(bf16)
    return mean.to(bf16).float(), mul.float(), bias.to(bf16).float()


def _check_unfolded(x, mean, mul, bias, act) -> None:
    if act not in ACTIVATIONS:
        raise ValueError(f"act {act!r} not in {sorted(ACTIVATIONS)}")
    c = x.shape[-1]
    for name, v in (("mean", mean), ("mul", mul), ("bias", bias)):
        if tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be [{c}] to match x's channels, got {tuple(v.shape)}")


def bn_act_unfolded_plain(
    x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor, act: str = "relu"
) -> torch.Tensor:
    """Plain version of the unfolded kernel: flax's ``((x - mean) * mul) +
    bias`` in the promoted dtype of ``x`` and the bf16 vectors (bf16 for a
    bf16 ``x``, every op rounded; f32 for an f32 ``x``), then the activation
    on the float32 result."""
    _check_unfolded(x, mean, mul, bias, act)
    cdt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    y = x.to(cdt) - mean.to(cdt)
    y = y * mul.to(cdt)
    y = y + bias.to(cdt)
    return activate(y.float(), act)


def bn_act_unfolded(
    x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor, act: str = "relu"
) -> torch.Tensor:
    """Inference BN + act for bf16 parameters (:func:`unfold_bn_bf16`'s
    vectors) over NHWC ``x`` (bf16 or f32); float32 out. CPU: plain version;
    CUDA: ``tfdl_bn_act_rows_unfolded`` in ``csrc/bn_act.cu``, counted as
    ``fused_bn_act_bf16``."""
    _check_unfolded(x, mean, mul, bias, act)
    if _use_plain(x):
        return bn_act_unfolded_plain(x, mean, mul, bias, act)
    _require_cuda("fused_bn_act_bf16", x, dtypes=(torch.float32, torch.bfloat16))
    _require_cuda_f32("fused_bn_act_bf16", mean, mul, bias)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    c = x.shape[-1]
    lib, fn = _entry("tfdl_bn_act_rows_unfolded")
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
            out.data_ptr(), x.numel() // max(c, 1), c, ACTIVATIONS[act],
            int(bn_act_vectorized(c, x, mean, mul, bias, out)), _stream(x),
        )
    _build.check(lib, code, "fused_bn_act_bf16")
    LAUNCHES["fused_bn_act_bf16"] += 1
    return out


def _earlier_bn_act_unfolded(
    x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor, act: str = "relu"
) -> torch.Tensor:
    """The earlier kernel of :func:`bn_act_unfolded`
    (``tfdl_bn_act_unfolded``: one thread per element). Kept to be timed
    and held bit for bit beside the row kernel; no path calls it, and it
    counts nothing."""
    _check_unfolded(x, mean, mul, bias, act)
    _require_cuda("fused_bn_act_bf16 (earlier kernel)", x, dtypes=(torch.float32, torch.bfloat16))
    _require_cuda_f32("fused_bn_act_bf16 (earlier kernel)", mean, mul, bias)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib, fn = _entry("tfdl_bn_act_unfolded")
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), mean.data_ptr(), mul.data_ptr(), bias.data_ptr(),
            out.data_ptr(), x.numel(), x.shape[-1], ACTIVATIONS[act], _stream(x),
        )
    _build.check(lib, code, "fused_bn_act_bf16 (earlier kernel)")
    return out


# -- fused bias + activation ----------------------------------------------------


def _check_bias_act(x, bias, act) -> None:
    if act not in ACTIVATIONS:
        raise ValueError(f"act {act!r} not in {sorted(ACTIVATIONS)}")
    if x.dim() < 1:
        raise ValueError("fused_bias_act expects [..., C]")
    if bias is not None and tuple(bias.shape) != (x.shape[-1],):
        raise ValueError(f"bias must be [{x.shape[-1]}] to match x's last axis, got {tuple(bias.shape)}")


def fused_bias_act_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None, act: str = "none") -> torch.Tensor:
    """Plain version (counterpart of ``fused_bias_act_reference``):
    ``act(x + bias)`` in float32, returned in ``x``'s dtype."""
    _check_bias_act(x, bias, act)
    y = x.float()
    if bias is not None:
        y = y + bias.float()
    return activate(y, act).to(x.dtype)


# the vector arm of csrc/bias_act.cu: 16 bytes a load, TFDL_BA_BLOCKS_SM
# blocks of TFDL_THREADS resident on an SM
BIAS_ACT_VEC_BYTES = 16
BIAS_ACT_THREADS = 256
BIAS_ACT_BLOCKS_SM = 4


@dataclass(frozen=True)
class BiasActPlan:
    """How the vector arm of ``csrc/bias_act.cu`` walks x viewed as [P, C]:
    a thread owns ``vec`` consecutive channels (one 16-byte vector) of one of
    the ``groups = C / vec`` column groups and walks every ``rows``-th row
    from its first; ``blocks`` blocks of :data:`BIAS_ACT_THREADS`."""

    vec: int
    groups: int
    rows: int
    blocks: int


def bias_act_plan(total: int, c: int, itemsize: int, aligned: bool) -> Optional[BiasActPlan]:
    """The vector arm's plan for ``total`` elements of ``itemsize`` bytes
    with ``c`` channels, or None where the earlier one-thread-per-element
    kernel takes the call (c not a multiple of the vector width, 8 bf16 or 4
    floats; a base of x or out not 16-byte aligned; an empty tensor).

    As many row walkers as one wave of the 132 SMs holds at
    :data:`BIAS_ACT_BLOCKS_SM` blocks each, at most one per row."""
    vec = BIAS_ACT_VEC_BYTES // itemsize
    if total <= 0 or c <= 0 or c % vec or not aligned:
        return None
    groups = c // vec
    resident = H100_SMS * BIAS_ACT_BLOCKS_SM * BIAS_ACT_THREADS
    rows = max(1, min(total // c, resident // groups))
    return BiasActPlan(vec, groups, rows, -(-rows * groups // BIAS_ACT_THREADS))


def bias_act_route(x: torch.Tensor, out: torch.Tensor) -> Optional[BiasActPlan]:
    """The vector arm's plan for this call, or None for the earlier kernel."""
    return bias_act_plan(x.numel(), x.shape[-1], x.element_size(), _aligned(x, out))


def _require_bias_act_cuda(name: str, x: torch.Tensor, bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Checks the CUDA arm's inputs; returns the bias as contiguous float32."""
    _require_cuda(name, x, dtypes=(torch.float32, torch.bfloat16))
    b32 = None if bias is None else bias.float().contiguous()
    _require_cuda_f32(name, b32)
    return b32


def fused_bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None, act: str = "none") -> torch.Tensor:
    """Per-channel bias + activation over the last axis of ``x`` [..., C]
    (float32 or bfloat16), f32 math, output in ``x``'s dtype; ``bias`` [C]
    or None. Inference-only, as the TPU kernel is. CPU: plain version;
    CUDA: ``csrc/bias_act.cu``, its vector arm where :func:`bias_act_route`
    plans one (same bits either way)."""
    _check_bias_act(x, bias, act)
    if _use_plain(x):
        return fused_bias_act_plain(x, bias, act)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, bias)):
        raise RuntimeError("fused_bias_act: the CUDA kernel is inference-only, as the TPU kernel is")
    b32 = _require_bias_act_cuda("fused_bias_act", x, bias)
    out = torch.empty_like(x)
    plan = bias_act_route(x, out)
    if plan is None:
        _launch_bias_act(x, b32, out, act, "fused_bias_act")
    else:
        c = x.shape[-1]
        lib, fn = _entry("tfdl_bias_act_vec")
        with torch.cuda.device(x.device):
            code = fn(
                x.data_ptr(), int(x.dtype == torch.bfloat16), b32.data_ptr() if b32 is not None else None,
                out.data_ptr(), x.numel() // c, c, ACTIVATIONS[act], plan.rows, plan.blocks, _stream(x),
            )
        _build.check(lib, code, "fused_bias_act")
    LAUNCHES["fused_bias_act"] += 1
    return out


def _launch_bias_act(x: torch.Tensor, b32: Optional[torch.Tensor], out: torch.Tensor, act: str, name: str) -> None:
    """One launch of the earlier kernel (``tfdl_bias_act_kernel``: one
    thread per element) into ``out``; counts nothing."""
    lib, fn = _entry("tfdl_bias_act")
    with torch.cuda.device(x.device):
        code = fn(
            x.data_ptr(), int(x.dtype == torch.bfloat16), b32.data_ptr() if b32 is not None else None,
            out.data_ptr(), x.numel(), x.shape[-1], ACTIVATIONS[act], _stream(x),
        )
    _build.check(lib, code, name)


def _earlier_fused_bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None, act: str = "none") -> torch.Tensor:
    """The earlier kernel of :func:`fused_bias_act` at any shape. Kept to be
    timed and held bit for bit beside the vector arm; counts nothing."""
    _check_bias_act(x, bias, act)
    b32 = _require_bias_act_cuda("fused_bias_act (earlier kernel)", x, bias)
    out = torch.empty_like(x)
    _launch_bias_act(x, b32, out, act, "fused_bias_act (earlier kernel)")
    return out


# -- fused sigmoid + threshold mask head ----------------------------------------


def fused_sigmoid_mask_plain(logits: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version — literally the unfused head: ``sigmoid`` in the logits
    dtype, then ``(p > threshold)`` as float32. The kernel must match it bit
    for bit."""
    probs = torch.sigmoid(logits)
    return probs, (probs > threshold).float()


def sigmoid_mask_vectorized(*tensors: torch.Tensor) -> bool:
    """Whether the sigmoid-mask kernel takes its float4 arm: every base
    16-byte aligned (the n % 4 tail is computed inside it); else its scalar
    arm. Chosen from the pointers before the launch; same bits either way."""
    return _aligned(*tensors)


def fused_sigmoid_mask(logits: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sigmoid(logits), (sigmoid(logits) > threshold).float32)`` from one
    read of the logits. CPU: plain version; CUDA: the kernel, its float4 arm
    where :func:`sigmoid_mask_vectorized`."""
    if _use_plain(logits):
        return fused_sigmoid_mask_plain(logits, threshold)
    _require_cuda_f32("fused_sigmoid_mask", logits)
    probs = torch.empty_like(logits)
    mask = torch.empty_like(logits)
    lib, fn = _entry("tfdl_sigmoid_mask_vec_f32")
    with torch.cuda.device(logits.device):
        code = fn(
            logits.data_ptr(), probs.data_ptr(), mask.data_ptr(), logits.numel(), float(threshold),
            int(sigmoid_mask_vectorized(logits, probs, mask)), _stream(logits),
        )
    _build.check(lib, code, "fused_sigmoid_mask")
    LAUNCHES["fused_sigmoid_mask"] += 1
    return probs, mask


def _earlier_fused_sigmoid_mask(logits: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The earlier sigmoid-mask kernel (``tfdl_sigmoid_mask_kernel``: one
    thread per element). Kept to be timed and held bit for bit beside the
    float4 kernel; no path calls it, and it counts nothing."""
    _require_cuda_f32("fused_sigmoid_mask (earlier kernel)", logits)
    probs = torch.empty_like(logits)
    mask = torch.empty_like(logits)
    lib, fn = _entry("tfdl_sigmoid_mask_f32")
    with torch.cuda.device(logits.device):
        code = fn(
            logits.data_ptr(), probs.data_ptr(), mask.data_ptr(), logits.numel(), float(threshold), _stream(logits),
        )
    _build.check(lib, code, "fused_sigmoid_mask (earlier kernel)")
    return probs, mask
