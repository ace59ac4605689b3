"""A small PNG codec on ``zlib`` and numpy alone.

The JAX package decodes with its native reader or PIL; neither is a
dependency of the port (the GPU host has no PIL, and no libpng to build the
native decoder with). This reads 8-bit grey, grey+alpha, RGB and RGBA images
(non-interlaced, any of the five row filters): :func:`read_png` gives the
samples as they are stored, :func:`read_png_gray` converts colour to grey
with PIL's ``convert("L")`` integer formula, so a TGS file decodes to the
bytes PIL gives. :func:`encode_png` writes 8-bit grey, grey+alpha, RGB and RGBA images
(row filter 0); its bytes differ from PIL's, the pixels it stores do not.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _unfilter(raw: bytes, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"{path}: image data has {rows.size} bytes, expected {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    if not rows[:, 0].any():  # every row filter 0 (encode_png's): the bytes are the samples
        return rows[:, 1:].copy()
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum per byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.astype(np.int64)
            up = prev.astype(np.int64)
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) // 2
                else:
                    upleft = up[i - bpp] if i >= bpp else 0
                    p = left + up[i] - upleft
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - upleft)
                    pred = left if (pa <= pb and pa <= pc) else (up[i] if pb <= pc else upleft)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(data: bytes, what: str = "PNG data") -> np.ndarray:
    """Decode an 8-bit, non-interlaced grey/grey+alpha/RGB/RGBA PNG held in
    ``data`` to its stored samples, [H, W, C] uint8 with C in 1..4; raises
    ValueError naming ``what`` for anything else."""
    header = None
    idat = []
    for kind, body in _chunks(data, what):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{what}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{what}: only 8-bit, non-interlaced grey/grey+alpha/RGB/RGBA PNGs are read "
            f"(bit depth {depth}, colour type {colour}, interlace {interlace})"
        )
    bpp = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp, what)
    return pixels.reshape(height, width, bpp)


def read_png_gray(path: str) -> np.ndarray:
    """Decode an 8-bit PNG file to a [H, W] uint8 grey image."""
    with open(path, "rb") as f:
        pixels = read_png(f.read(), path)
    if pixels.shape[2] <= 2:
        return np.ascontiguousarray(pixels[:, :, 0])
    r, g, b = (pixels[:, :, i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


_COLOUR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> colour type


def encode_png(image: np.ndarray) -> bytes:
    """Encode a [H, W] grey or [H, W, C] (C = 1, 2, 3 or 4) uint8 image as an
    8-bit PNG: every row filter 0, the image data one ``zlib`` stream."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[2] not in _COLOUR_TYPES:
        raise ValueError(f"encode_png expects [H, W] or [H, W, 1|2|3|4] uint8, got shape {image.shape}")
    height, width, channels = image.shape
    raw = np.concatenate([np.zeros((height, 1), np.uint8), image.reshape(height, width * channels)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, _COLOUR_TYPES[channels], 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png_gray(path: str, image: np.ndarray) -> None:
    """Encode a [H, W] uint8 image as an 8-bit grey PNG file (row filter 0)."""
    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError(f"write_png_gray expects [H, W] uint8, got shape {image.shape}")
    with open(path, "wb") as f:
        f.write(encode_png(image))
