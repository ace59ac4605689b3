"""Build the native host libraries at first use and bind them with ctypes
(counterpart of the JAX package's ``native/loader.py``).

Two sources of this directory, the port's own copies of the JAX package's:

- ``io.cc``: multithreaded PNG/JPEG decode with an antialiased bilinear
  resize, off the interpreter lock. It links libpng and libjpeg: the build
  tries PNG + JPEG first, then PNG alone (``-DTFDL_NO_JPEG``).
- ``records.cc``: the TFRecord reader (a background reader thread, crc
  checks, a shuffle pool), the offset-indexed range reads of the data
  service, and the writer's masked crc32c. It links nothing.

Each is compiled with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into
``{package}/_build/native/`` (or ``$TFDL_TORCH_BUILD_DIR/native/``) under a
name that carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library never loaded; installs are a pid-unique temp file
and an atomic ``os.replace``, so processes building at once never tear a
file. Libraries load with ctypes' default ``RTLD_LOCAL``: the JAX package's
library exports the same ``tfdl_*`` names and may share the process.

Nothing falls back silently. The records library is required: a build
failure raises with the compiler's words. The decoder may be missing (the
GPU host has no libpng headers): that is logged once, :func:`decoder` names
what decodes (``"native"`` or ``"png.py"``), PNGs at the target size then
decode through ``data/png.py`` to the same floats, and a JPEG or an image
that needs a resize raises, naming the missing header. A blob the native
decoder rejects raises with its index; nothing decodes it another way.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# link variants of the decoder, in the order tried, with what each decodes
IO_VARIANTS: Tuple[Tuple[Tuple[str, ...], bool], ...] = (
    (("-lpng", "-ljpeg"), True),
    (("-DTFDL_NO_JPEG", "-lpng"), False),
)
MISSING_DECODER = "the native decoder (native/io.cc needs png.h and jpeglib.h to build)"
PNG_DECODER = "png.py"

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_jpeg = False


def source(name: str) -> str:
    """Path of ``native/{name}.cc`` (``io`` or ``records``)."""
    return os.path.join(_HERE, f"{name}.cc")


def build_dir() -> str:
    root = os.environ.get("TFDL_TORCH_BUILD_DIR") or os.path.join(_PKG, "_build")
    return os.path.join(root, "native")


def library_path(name: str, flags: Sequence[str]) -> str:
    """Where ``native/{name}.cc`` built with ``flags`` is installed: the
    name carries a hash of the source and every flag."""
    h = hashlib.sha256(" ".join((*GXX_FLAGS, *flags)).encode())
    with open(source(name), "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir(), f"libtfdl_{name}-{h.hexdigest()[:16]}.so")


def compile_library(name: str, flags: Sequence[str]) -> Tuple[Optional[str], str]:
    """``(library path, "")`` of ``native/{name}.cc`` built with ``flags``
    (compiled now unless already installed), or ``(None, why)``."""
    target = library_path(name, flags)
    if os.path.exists(target):
        return target, ""
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, source(name), *flags, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        return None, f"{' '.join(cmd)}: rc {proc.returncode}\n{proc.stderr.strip()[-1500:]}"
    os.replace(tmp, target)
    return target, ""


_U8P = ctypes.POINTER(ctypes.c_uint8)


def _bind_io(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tfdl_decode_png_batch.restype = ctypes.c_int
    lib.tfdl_decode_png_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.tfdl_decode_image_batch.restype = ctypes.c_int
    lib.tfdl_decode_image_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.tfdl_decode_image_blob_batch.restype = ctypes.c_int
    lib.tfdl_decode_image_blob_batch.argtypes = [
        ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.tfdl_version.restype = ctypes.c_char_p
    return lib


def _bind_records(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.tfdl_rec_open.restype = ctypes.c_int64
    lib.tfdl_rec_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
    ]
    lib.tfdl_rec_next.restype = ctypes.c_int
    lib.tfdl_rec_next.argtypes = [ctypes.c_int64, ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_uint64)]
    lib.tfdl_rec_close.restype = None
    lib.tfdl_rec_close.argtypes = [ctypes.c_int64]
    lib.tfdl_ranges_open.restype = ctypes.c_int64
    lib.tfdl_ranges_open.argtypes = [ctypes.c_char_p]
    lib.tfdl_ranges_read.restype = ctypes.c_int
    lib.tfdl_ranges_read.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.tfdl_ranges_close.restype = None
    lib.tfdl_ranges_close.argtypes = [ctypes.c_int64]
    lib.tfdl_masked_crc32c.restype = ctypes.c_uint32
    lib.tfdl_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    return lib


def io_library() -> Optional[ctypes.CDLL]:
    """The decoder library, built on the first call; None when no variant
    builds here (logged once, with the compiler's words)."""
    global _jpeg
    with _lock:
        if "io" in _libs:
            return _libs["io"]
        why: List[str] = []
        lib = None
        for flags, jpeg in IO_VARIANTS:
            path, err = compile_library("io", flags)
            if path is not None:
                try:
                    lib, _jpeg = _bind_io(ctypes.CDLL(path)), jpeg
                except OSError as e:  # built, but a linked library is missing at run time
                    why.append(f"{path}: {e}")
                    continue
                logger.info("image decoder: native (%s, %s)", os.path.basename(path),
                            "PNG + JPEG" if jpeg else "PNG only: JPEGs raise")
                break
            why.append(err)
        if lib is None:
            logger.warning(
                "image decoder: %s. %s did not build, so PNGs at the target size decode through data/png.py and "
                "a JPEG or a resize raises. Compiler: %s", PNG_DECODER, MISSING_DECODER, why[-1][:600],
            )
        _libs["io"] = lib
        return lib


def records_library() -> ctypes.CDLL:
    """The record reader library, built on the first call; raises with the
    compiler's words when it cannot build."""
    with _lock:
        lib = _libs.get("records")
        if lib is None:
            path, err = compile_library("records", ())
            if path is None:
                raise RuntimeError(f"native/records.cc did not build: the record reader needs g++. {err}")
            lib = _libs["records"] = _bind_records(ctypes.CDLL(path))
        return lib


def native_available() -> bool:
    """True when the native decoder built and loaded here."""
    return io_library() is not None


def jpeg_available() -> bool:
    """True when the native decoder built with libjpeg."""
    return io_library() is not None and _jpeg


def decoder() -> str:
    """What decodes images in this process: ``"native"`` or ``"png.py"``."""
    return "native" if native_available() else PNG_DECODER


def _default_threads(n_items: int) -> int:
    # blobs: at least 16 per thread, capped by the cores (a thread per core on
    # a small batch spends more time starting threads than decoding)
    return max(1, min(os.cpu_count() or 1, n_items // 16))


def _is_jpeg(head: bytes) -> bool:
    return head[:2] == b"\xff\xd8"


def _refuse_jpegs(heads: Sequence[bytes], names: Sequence[str]) -> None:
    """Raise on the first JPEG when the decoder has no libjpeg."""
    for head, name in zip(heads, names):
        if _is_jpeg(head):
            missing = "jpeglib.h" if native_available() else "png.h and jpeglib.h"
            raise RuntimeError(
                f"{name} is a JPEG: decoding it needs the native decoder built with libjpeg, and {missing} "
                "were missing when native/io.cc was built here"
            )


def _to_floats(pixels: np.ndarray, h: int, w: int, channels: int, what: str) -> np.ndarray:
    """Stored 8-bit samples [H, W, C] to the floats the native decoder gives
    for a PNG at the target size: alpha dropped, value / 255, grey repeated
    into every channel or RGB folded to grey with its BT.601 weights."""
    if pixels.shape[:2] != (h, w):
        raise RuntimeError(
            f"{what} is {pixels.shape[0]}x{pixels.shape[1]}, not {h}x{w}: a resize needs "
            f"{MISSING_DECODER}, and it did not build here"
        )
    colour = pixels[:, :, :1] if pixels.shape[2] <= 2 else pixels[:, :, :3]
    x = colour.astype(np.float32) / np.float32(255.0)
    if x.shape[2] == channels:
        return x
    if x.shape[2] == 1:
        return np.repeat(x, channels, axis=2)
    if channels != 1:
        raise ValueError(f"{what}: cannot give {channels} channels from RGB")
    return (np.float32(0.299) * x[:, :, 0] + np.float32(0.587) * x[:, :, 1]
            + np.float32(0.114) * x[:, :, 2])[:, :, None]


def _decode_png_py(data: bytes, h: int, w: int, channels: int, what: str) -> np.ndarray:
    from tensorflowdistributedlearning_tpu_torch.data.png import read_png

    try:
        pixels = read_png(data, what)
    except ValueError as e:
        raise RuntimeError(f"{e}; other PNGs need {MISSING_DECODER}, and it did not build here") from e
    return _to_floats(pixels, h, w, channels, what)


def decode_image_blobs(
    blobs: Sequence[bytes], shape: Tuple[int, int], channels: int = 3, n_threads: Optional[int] = None
) -> np.ndarray:
    """Decode in-memory PNG/JPEG byte strings (record payloads) into
    [N, h, w, channels] float32 in [0, 1], antialias-resized: the native
    decoder on fmemopen'd streams when it built, else ``data/png.py`` for
    PNGs at the target size. Raises on the first blob neither can decode,
    with its index."""
    h, w = shape
    blobs = list(blobs)
    out = np.empty((len(blobs), h, w, channels), np.float32)
    if not blobs:
        return out
    names = [f"image blob {i} of {len(blobs)}" for i in range(len(blobs))]
    if not jpeg_available():
        _refuse_jpegs(blobs, names)
    lib = io_library()
    if lib is None:
        for i, blob in enumerate(blobs):
            out[i] = _decode_png_py(blob, h, w, channels, names[i])
        return out
    bufs = [np.frombuffer(b, np.uint8) for b in blobs]  # keep the buffers alive through the call
    ptrs = (_U8P * len(bufs))(*[b.ctypes.data_as(_U8P) for b in bufs])
    sizes = (ctypes.c_ulonglong * len(bufs))(*[b.size for b in bufs])
    rc = lib.tfdl_decode_image_blob_batch(
        ptrs, sizes, len(bufs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, channels,
        n_threads or _default_threads(len(bufs)),
    )
    if rc != 0:
        raise ValueError(f"native decode failed for {names[rc - 1]} (not a PNG/JPEG the decoder reads)")
    return out


def decode_png_batch(
    paths: Sequence[str], h: int, w: int, channels: int = 1, n_threads: Optional[int] = None
) -> np.ndarray:
    """Decode fixed-size PNGs (the TGS-salt contract: every file already
    h x w) into [N, h, w, channels] float32 in [0, 1]: the native
    multithreaded decoder when it built, else ``data/png.py`` (the JAX
    package's ``decode_png_batch``; its PIL path has no counterpart).
    ``decode_image_batch`` takes other sizes and JPEGs."""
    paths = [os.fspath(p) for p in paths]
    out = np.empty((len(paths), h, w, channels), np.float32)
    if not paths:
        return out
    lib = io_library()
    if lib is None:
        for i, p in enumerate(paths):
            with open(p, "rb") as f:
                out[i] = _decode_png_py(f.read(), h, w, channels, p)
        return out
    c_paths = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    rc = lib.tfdl_decode_png_batch(
        c_paths, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, channels,
        n_threads or min(len(paths), os.cpu_count() or 1),
    )
    if rc != 0:
        raise ValueError(f"native PNG decode failed for {paths[rc - 1]!r}")
    return out


def decode_image_batch(
    paths: Sequence[str], h: int, w: int, channels: int = 3, n_threads: Optional[int] = None
) -> np.ndarray:
    """Decode PNG/JPEG files of any size into [N, h, w, channels] float32 in
    [0, 1], antialias-bilinearly resized (the ImageFolder decode): native
    and multithreaded when the decoder built, else ``data/png.py`` for PNGs
    at the target size. Raises on the first file neither can decode."""
    paths = [os.fspath(p) for p in paths]
    out = np.empty((len(paths), h, w, channels), np.float32)
    if not paths:
        return out
    if not jpeg_available():
        heads = []
        for p in paths:
            with open(p, "rb") as f:
                heads.append(f.read(2))
        _refuse_jpegs(heads, paths)
    lib = io_library()
    if lib is None:
        for i, p in enumerate(paths):
            with open(p, "rb") as f:
                out[i] = _decode_png_py(f.read(), h, w, channels, p)
        return out
    c_paths = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    rc = lib.tfdl_decode_image_batch(
        c_paths, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, channels,
        n_threads or min(len(paths), os.cpu_count() or 1),
    )
    if rc != 0:
        raise ValueError(f"native decode failed for {paths[rc - 1]!r} (not a PNG/JPEG the decoder reads)")
    return out


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked crc32c of ``data``, computed by ``records.cc``."""
    return int(records_library().tfdl_masked_crc32c(data, len(data)))
