"""TensorBoard event files without TensorFlow (the port's copy of the JAX
package's ``utils/summary.py``, byte for byte the same records).

It hand-encodes the two protobuf messages TensorBoard reads (``Event``
wrapping ``Summary``) and frames them as TFRecords with the masked CRC-32C
of the port's ``native/records.cc``. Images are PNG-encoded by the port's
``data/png.py`` (the GPU host has no PIL).

Wire schema (field numbers from the public tensorboard .protos):
  Event:   1=wall_time(double) 2=step(int64) 5=summary(message)
  Summary: 1=repeated Value;  Value: 1=tag(string) 2=simple_value(float)
                                     4=image(message)
  Image:   1=height 2=width 3=colorspace 4=encoded_image_string(PNG bytes)

:func:`read_events` reads the scalars back as the JAX package's does;
:func:`read_images` decodes the image summaries.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from tensorflowdistributedlearning_tpu_torch.data import png
from tensorflowdistributedlearning_tpu_torch.native import loader as native_loader

# -- protobuf wire-format primitives ----------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _field_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _field_double(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _field_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _tfrecord(payload: bytes) -> bytes:
    crc = native_loader.masked_crc32c
    header = struct.pack("<Q", len(payload))
    return header + struct.pack("<I", crc(header)) + payload + struct.pack("<I", crc(payload))


# -- summary messages ---------------------------------------------------------


def _scalar_value(tag: str, value: float) -> bytes:
    body = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, body)  # Summary.value


def _image_value(tag: str, image: np.ndarray) -> bytes:
    """``image``: [H, W] or [H, W, C] float in [0, 1] or uint8."""
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    h, w = image.shape[0], image.shape[1]
    colorspace = 1 if image.ndim == 2 else image.shape[-1]
    img_msg = (
        _field_varint(1, h) + _field_varint(2, w) + _field_varint(3, colorspace)
        + _field_bytes(4, png.encode_png(image))
    )
    body = _field_bytes(1, tag.encode()) + _field_bytes(4, img_msg)
    return _field_bytes(1, body)


def _event(step: int, summary_body: bytes, wall_time: Optional[float] = None) -> bytes:
    return (
        _field_double(1, wall_time if wall_time is not None else time.time())
        + _field_varint(2, step)
        + _field_bytes(5, summary_body)
    )


# -- public writer -----------------------------------------------------------


class SummaryWriter:
    """Append-only TensorBoard event file in ``logdir`` (one per writer, named
    ``events.out.tfevents.{ts}.{host}`` as TensorFlow names them)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.uname().nodename}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        # the file-version header event TensorFlow's writer emits first
        header = _field_double(1, time.time()) + _field_bytes(3, b"brain.Event:2")
        self._f.write(_tfrecord(header))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(_tfrecord(_event(step, _scalar_value(tag, value))))

    def scalars(self, values: Dict[str, float], step: int) -> None:
        body = b"".join(_scalar_value(t, v) for t, v in values.items())
        self._f.write(_tfrecord(_event(step, body)))

    def image(self, tag: str, image: np.ndarray, step: int) -> None:
        """One image summary (the trainers' input/label/probability/
        prediction images)."""
        self._f.write(_tfrecord(_event(step, _image_value(tag, np.asarray(image)))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


# -- readers -----------------------------------------------------------------


def _records(path: str):
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        yield data[pos + 12: pos + 12 + length]
        pos += 12 + length + 4


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(data: bytes):
    """``(field, wire type, value)`` of one message: ints for varints, bytes
    for length-delimited fields and the raw 8 or 4 bytes of fixed ones."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(data, pos)
        elif wt == 1:
            val, pos = data[pos: pos + 8], pos + 8
        elif wt == 5:
            val, pos = data[pos: pos + 4], pos + 4
        elif wt == 2:
            ln, pos = _read_varint(data, pos)
            val, pos = data[pos: pos + ln], pos + ln
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, val


def _summary_values(payload: bytes):
    """``(step, [(tag, field, value)])`` of one Event record."""
    step, values = 0, []
    for field, _, val in _fields(payload):
        if field == 2:
            step = val
        elif field == 5:
            for vfield, _, value in _fields(val):
                if vfield != 1:
                    continue
                tag, kind, content = None, None, None
                for f, _, v in _fields(value):
                    if f == 1:
                        tag = v.decode()
                    elif f in (2, 4):
                        kind, content = f, v
                if tag is not None and kind is not None:
                    values.append((tag, kind, content))
    return step, values


def read_events(path: str) -> List[Tuple[int, Dict[str, float]]]:
    """The scalars of an event file, ``[(step, {tag: value})]``, one entry per
    event that holds any."""
    out = []
    for payload in _records(path):
        step, values = _summary_values(payload)
        scalars = {tag: struct.unpack("<f", v)[0] for tag, kind, v in values if kind == 2}
        if scalars:
            out.append((step, scalars))
    return out


def read_images(path: str) -> List[Tuple[int, Dict[str, np.ndarray]]]:
    """The image summaries of an event file, decoded by ``data/png.py``:
    ``[(step, {tag: uint8 [H, W] or [H, W, C]})]``."""
    out = []
    for payload in _records(path):
        step, values = _summary_values(payload)
        images = {}
        for tag, kind, msg in values:
            if kind != 4:
                continue
            encoded = next(v for f, _, v in _fields(msg) if f == 4)
            pixels = png.read_png(encoded, f"{path}:{tag}")
            images[tag] = pixels[:, :, 0] if pixels.shape[2] == 1 else pixels
        if images:
            out.append((step, images))
    return out
