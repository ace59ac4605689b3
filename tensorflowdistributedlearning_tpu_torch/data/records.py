"""TFRecord shards: the writer, the native threaded reader and the
classification stream (counterpart of the JAX package's ``data/records.py``;
the same framing, sidecars, seeds and batches).

- ``write_records`` / ``read_records``: the public TFRecord framing (length
  + masked crc32c + payload + crc). The writer takes its checksums from
  ``native/records.cc``; ``read_records`` is pure Python, the plain version
  the tests hold the native reader to, and nothing switches to it on its own.
- ``RecordStream``: ctypes binding over ``native/records.cc``, one
  background C++ thread per stream reading ahead, verifying crcs and serving
  from a shuffle pool.
- ``write_shard_index`` / ``shard_offsets`` / ``count_records``: the
  ``.idx`` count/offset sidecar, checked against the shard's byte size and
  mtime.
- ``ShardRangeReader``: records at indexed byte offsets (native
  fseek + crc), the read primitive of ``data/service.py``'s workers.
- ``ClassificationRecords``: the ``fit`` loop's record source when the
  data service is off, and its eval stream. Payload: ``int32 LE label |
  encoded image`` (PNG/JPEG, decoded by ``native.decode_image_blobs``),
  decodes running ``decode_ahead`` batches ahead of the consumer.

Opens, range reads and decodes retry on ``OSError`` through
``resilience/retry.py``.
"""

from __future__ import annotations

import ctypes
import glob as glob_lib
import os
import struct
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple
from zipfile import BadZipFile

import numpy as np

from tensorflowdistributedlearning_tpu_torch.data.png import encode_png
from tensorflowdistributedlearning_tpu_torch.native import loader as native_loader
from tensorflowdistributedlearning_tpu_torch.parallel import multihost
from tensorflowdistributedlearning_tpu_torch.resilience import retry as retry_lib


def _open_shard(path: str, mode: str = "rb"):
    """A shard file open with transient-I/O retry."""
    return retry_lib.call_with_retry(lambda: open(path, mode), name="record_open", exceptions=(OSError,))


# -- crc32c (Castagnoli), table-driven: the plain version of records.cc's -------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def masked_crc(data: bytes) -> int:
    """TFRecord's masked crc32c, in pure Python."""
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    crc = c ^ 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- framing --------------------------------------------------------------------


def write_records(path: str, records: Sequence[bytes]) -> None:
    """Write one TFRecord shard (public framing, readable by any TFRecord
    consumer), and drop a ``.idx`` sidecar the rewrite made stale."""
    crc = native_loader.masked_crc32c
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", crc(rec)))
    # a same-size rewrite within one mtime tick would pass shard_offsets'
    # freshness check and serve stale offsets
    try:
        os.remove(shard_index_path(path))
    except FileNotFoundError:
        pass


def _read_record(f, path: str, verify: bool) -> Optional[bytes]:
    """The record at ``f``'s position, or None at a clean end of file."""
    header = f.read(12)
    if not header:
        return None
    if len(header) != 12:
        raise ValueError(f"{path}: truncated record header")
    (length,) = struct.unpack("<Q", header[:8])
    if verify and masked_crc(header[:8]) != struct.unpack("<I", header[8:12])[0]:
        raise ValueError(f"{path}: corrupt length crc")
    data = f.read(length)
    footer = f.read(4)
    if len(data) != length or len(footer) != 4:
        raise ValueError(f"{path}: truncated record body")
    if verify and masked_crc(data) != struct.unpack("<I", footer)[0]:
        raise ValueError(f"{path}: corrupt data crc")
    return data


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Pure-Python shard reader: the plain version of the native one."""
    with _open_shard(path) as f:
        while True:
            rec = _read_record(f, path, verify)
            if rec is None:
                return
            yield rec


# -- native streaming reader ----------------------------------------------------


class RecordStream:
    """Iterator of record payloads over a list of TFRecord shards: a
    background C++ reader thread, crc verification and a shuffle pool of
    ``shuffle_buffer`` records (the shard order shuffled by ``seed``). Each
    ``iter`` opens a native handle and the generator closes it, also when
    abandoned."""

    def __init__(self, paths: Sequence[str], *, shuffle_buffer: int = 1, seed: int = 0, verify_crc: bool = True):
        if not paths:
            raise ValueError("RecordStream needs at least one shard path")
        self.paths = [os.path.abspath(p) for p in paths]
        self.shuffle_buffer = max(1, int(shuffle_buffer))
        self.seed = seed
        self.verify_crc = verify_crc

    def __iter__(self) -> Iterator[bytes]:
        lib = native_loader.records_library()
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        handle = lib.tfdl_rec_open(arr, len(self.paths), self.shuffle_buffer, ctypes.c_uint64(self.seed),
                                   1 if self.verify_crc else 0)
        if handle == 0:
            raise RuntimeError("tfdl_rec_open failed")
        try:
            data = ctypes.POINTER(ctypes.c_uint8)()
            length = ctypes.c_uint64()
            while True:
                rc = lib.tfdl_rec_next(handle, ctypes.byref(data), ctypes.byref(length))
                if rc == 0:
                    return
                if rc == -2:
                    raise IOError("failed to open/read a TFRecord shard (missing file or permissions) among "
                                  + ", ".join(self.paths))
                if rc == -3:
                    raise RuntimeError("RecordStream handle is invalid or already closed")
                if rc < 0:
                    raise ValueError("corrupt TFRecord stream (crc/framing mismatch) in " + ", ".join(self.paths))
                yield ctypes.string_at(data, length.value)
        finally:
            lib.tfdl_rec_close(handle)


# -- classification payloads (int32 label + encoded image) ----------------------


def encode_classification_record(label: int, image_bytes: bytes) -> bytes:
    return struct.pack("<i", label) + image_bytes


def decode_classification_record(payload: bytes) -> Tuple[int, bytes]:
    (label,) = struct.unpack("<i", payload[:4])
    return label, payload[4:]


def check_classification_labels(labels: np.ndarray, num_classes: Optional[int]) -> None:
    """Label-range validation (``None`` skips: unknown class count)."""
    if num_classes is not None and labels.size:
        lo, hi = int(labels.min()), int(labels.max())
        if lo < 0 or hi >= num_classes:
            raise ValueError(
                f"record label out of range [0, {num_classes}): saw {lo}..{hi} — the shards hold more classes "
                "than the model's num_classes"
            )


def decode_classification_batch(
    blobs: Sequence[bytes],
    labels: Sequence[int],
    valid_rows: int,
    *,
    image_shape: Tuple[int, int],
    channels: int,
    num_classes: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Blobs and labels to ``{'images', 'labels', 'valid'}``: labels checked
    on the valid rows, the blobs decoded (retried on ``OSError``) and
    normalised. The one recipe of the record stream and the service's
    workers."""
    from tensorflowdistributedlearning_tpu_torch.data.imagefolder import _normalize

    arr_labels = np.asarray(labels, np.int32)
    check_classification_labels(arr_labels[:valid_rows], num_classes)
    images = retry_lib.call_with_retry(
        lambda: native_loader.decode_image_blobs(blobs, tuple(image_shape), channels),
        name="record_batch", exceptions=(OSError,),
    )
    valid = np.zeros(len(blobs), np.float32)
    valid[:valid_rows] = 1.0
    return {"images": _normalize(images, channels), "labels": arr_labels, "valid": valid}


def write_classification_shards(
    out_dir: str, images: Sequence[np.ndarray], labels: Sequence[int], *, shards: int = 2, prefix: str = "train"
) -> List[str]:
    """Encode uint8 HWC images as PNG payload records across ``shards``
    files, record ``i`` into shard ``i % shards``, each with its ``.idx``
    sidecar (a dataset-prep tool; also the tests' fixture writer)."""
    records: List[List[bytes]] = [[] for _ in range(shards)]
    for i, (img, label) in enumerate(zip(images, labels)):
        records[i % shards].append(encode_classification_record(int(label), encode_png(np.asarray(img))))
    paths = []
    for s in range(shards):
        path = os.path.join(out_dir, f"{prefix}-{s:05d}-of-{shards:05d}.tfrecord")
        write_records(path, records[s])
        write_shard_index(path)
        paths.append(path)
    return paths


# -- shard record index (.idx sidecar) -----------------------------------------

INDEX_SUFFIX = ".idx"


def shard_index_path(path: str) -> str:
    return path + INDEX_SUFFIX


def _scan_offsets(path: str) -> np.ndarray:
    """Record start offsets by a header-only scan (seeks over payloads, no
    crc). Raises on truncation."""
    offsets: List[int] = []
    size = os.path.getsize(path)
    with _open_shard(path) as f:
        pos = 0
        while True:
            header = f.read(12)
            if not header:
                break
            if len(header) != 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            f.seek(length + 4, os.SEEK_CUR)
            # seeking past the end succeeds silently: a shard cut mid-record
            # would be counted whole while the verifying reader fails later
            if f.tell() > size:
                raise ValueError(f"{path}: truncated record body")
            offsets.append(pos)
            pos += 12 + length + 4
    return np.asarray(offsets, np.uint64)


def write_shard_index(path: str) -> np.ndarray:
    """Write the ``.idx`` sidecar of one shard (record start offsets and the
    shard's byte size, an ``np.savez``), installed atomically; returns the
    offsets."""
    idx = shard_index_path(path)
    offsets = _scan_offsets(path)
    tmp = f"{idx}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, offsets=offsets, file_size=np.int64(os.path.getsize(path)))
    os.replace(tmp, idx)
    return offsets


def shard_offsets(path: str) -> np.ndarray:
    """Record start offsets of one shard: from the ``.idx`` sidecar when it
    is fresh (its byte size is the shard's and it is not older than the
    shard), else a header scan."""
    idx = shard_index_path(path)
    try:
        if os.path.getmtime(idx) >= os.path.getmtime(path):
            with np.load(idx) as z:
                if int(z["file_size"]) == os.path.getsize(path):
                    return z["offsets"].astype(np.uint64)
    except (OSError, KeyError, ValueError, BadZipFile):
        pass  # missing, corrupt or foreign sidecar: the scan is the oracle
    return _scan_offsets(path)


def count_records(paths: Sequence[str]) -> int:
    """Records across shards: the ``.idx`` sidecars when fresh, else scans."""
    return sum(len(shard_offsets(p)) for p in paths)


class ShardRangeReader:
    """Records at known byte offsets of one shard (offsets from
    ``shard_offsets``): native fseek/fread with crc verification. One
    reader serves one thread; each service worker opens its own."""

    def __init__(self, path: str, *, verify_crc: bool = True):
        self.path = os.path.abspath(path)
        self.verify_crc = verify_crc
        self._lib = native_loader.records_library()
        self._handle = self._lib.tfdl_ranges_open(self.path.encode())
        if self._handle == 0:
            raise IOError(f"cannot open record shard {self.path}")

    def read(self, offsets: Sequence[int]) -> List[bytes]:
        """Record payloads at ``offsets``, in the given order."""
        offsets = list(offsets)
        if not offsets:
            return []
        if not self._handle:
            raise RuntimeError("ShardRangeReader is closed")
        n = len(offsets)
        arr = (ctypes.c_uint64 * n)(*[int(o) for o in offsets])
        datas = (ctypes.POINTER(ctypes.c_uint8) * n)()
        lens = (ctypes.c_uint64 * n)()
        rc = self._lib.tfdl_ranges_read(self._handle, arr, n, 1 if self.verify_crc else 0, datas, lens)
        if rc == -3:
            raise RuntimeError("ShardRangeReader handle is invalid or already closed")
        if rc == -2:
            raise IOError(f"read failed in record shard {self.path}")
        if rc != 0:
            raise ValueError(
                f"{self.path}: corrupt record at an indexed offset (crc/framing mismatch — stale .idx or shard "
                "damage)"
            )
        return [ctypes.string_at(datas[i], lens[i]) for i in range(n)]

    def close(self) -> None:
        if self._handle:
            self._lib.tfdl_ranges_close(self._handle)
            self._handle = 0

    def __enter__(self) -> "ShardRangeReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # workers cache readers thread-locally
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def host_shard_paths(
    paths: Sequence[str], process_index: Optional[int] = None, process_count: Optional[int] = None
) -> List[str]:
    """This process's round-robin subset of the sorted shard files (the
    static assignment; ``data.service.epoch_shard_assignment`` re-deals
    every epoch). The default slot is this rank's data slot
    (``multihost.data_slot``)."""
    if process_index is None or process_count is None:
        process_index, process_count = multihost.data_slot()
    return [p for i, p in enumerate(sorted(paths)) if i % process_count == process_index]


class ClassificationRecords:
    """Record-sharded classification source: ``{root}/{split}-*.tfrecord``
    (``write_classification_shards``), decoded in batches."""

    def __init__(
        self,
        root: str,
        *,
        split: str = "train",
        image_shape: Tuple[int, int] = (32, 32),
        channels: int = 3,
        num_classes: Optional[int] = None,
    ):
        self.paths = sorted(glob_lib.glob(os.path.join(root, f"{split}-*.tfrecord")))
        if not self.paths:
            raise ValueError(f"No {split}-*.tfrecord shards under {root}")
        self.image_shape = image_shape
        self.channels = channels
        self.num_classes = num_classes

    def _emit(self, blobs: List[bytes], labels: List[int], valid_rows: int) -> Dict[str, np.ndarray]:
        return decode_classification_batch(
            blobs, labels, valid_rows, image_shape=self.image_shape, channels=self.channels,
            num_classes=self.num_classes,
        )

    def batches(
        self,
        batch_size: int,
        *,
        seed: int = 0,
        shuffle_buffer: int = 1024,
        repeat: bool = True,
        steps: Optional[int] = None,
        pad_to_batches: Optional[int] = None,
        decode_ahead: int = 1,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Batched ``{'images', 'labels', 'valid'}`` stream.

        ``repeat=True``: an infinite (or ``steps``-bounded) shuffled stream,
        every row valid, the shards reopened each epoch with seed ``seed +
        epoch``; a partial batch at an epoch's end carries into the next.
        ``repeat=False``: one ordered pass; ``pad_to_batches`` extends it to
        exactly that many batches by wrapping around to the start with
        ``valid = 0`` rows (the last partial batch pads the same way).

        ``decode_ahead``: decodes run on one background thread up to this
        many batches ahead of the consumer, in order; 0 decodes in line."""
        assembled = self._assemble(batch_size, seed=seed, shuffle_buffer=shuffle_buffer, repeat=repeat,
                                   steps=steps, pad_to_batches=pad_to_batches)
        if decode_ahead <= 0:
            for work in assembled:
                yield self._emit(*work)
            return
        pending: deque = deque()
        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="records-decode") as pool:
            for work in assembled:
                pending.append(pool.submit(self._emit, *work))
                while len(pending) > decode_ahead:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    def _assemble(
        self,
        batch_size: int,
        *,
        seed: int,
        shuffle_buffer: int,
        repeat: bool,
        steps: Optional[int],
        pad_to_batches: Optional[int],
    ) -> Iterator[Tuple[List[bytes], List[int], int]]:
        """``(blobs, labels, valid_rows)`` work items in emission order."""
        emitted = 0
        epoch = 0
        labels: List[int] = []
        blobs: List[bytes] = []
        while True:
            seen_any = False
            for payload in RecordStream(self.paths, shuffle_buffer=shuffle_buffer if repeat else 1,
                                        seed=seed + epoch):
                seen_any = True
                label, img = decode_classification_record(payload)
                labels.append(label)
                blobs.append(img)
                if len(blobs) == batch_size:
                    yield blobs, labels, batch_size
                    emitted += 1
                    labels, blobs = [], []
                    if repeat and steps is not None and emitted >= steps:
                        return
                    if not repeat and pad_to_batches is not None and emitted >= pad_to_batches:
                        return
            if not seen_any:
                raise ValueError("record shards contain zero records: " + ", ".join(self.paths))
            if not repeat:
                yield from self._padded_tail(blobs, labels, batch_size, seed, emitted, pad_to_batches)
                return
            epoch += 1

    def _padded_tail(self, blobs, labels, batch_size, seed, emitted, pad_to_batches):
        """The ordered pass's last partial batch and its ``valid = 0``
        padding batches, refilled by wrapping around to the first record."""
        tail_valid = len(blobs)
        if not (blobs or (pad_to_batches or 0) > emitted):
            return
        target = pad_to_batches if pad_to_batches is not None else emitted + 1
        refill = iter(RecordStream(self.paths, shuffle_buffer=1, seed=seed))
        while emitted < target:
            while len(blobs) < batch_size:
                payload = next(refill, None)
                if payload is None:
                    refill = iter(RecordStream(self.paths, shuffle_buffer=1, seed=seed))
                    payload = next(refill)
                label, img = decode_classification_record(payload)
                labels.append(label)
                blobs.append(img)
            yield blobs, labels, tail_valid
            emitted += 1
            labels, blobs = [], []
            tail_valid = 0  # later padded batches are wholly invalid
