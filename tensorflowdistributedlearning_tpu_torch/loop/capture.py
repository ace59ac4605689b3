"""Traffic capture tee (the port's copy of the JAX package's
``loop/capture.py``): a stride-sampled subset of accepted ``/v1/predict``
requests is written off the hot path as record shards (``data/records.py``
framing, PNG payloads, ``.idx`` sidecars) under a bounded disk quota,
self-labelled with the served model's own integer output.

``maybe_capture`` only copies the arrays and enqueues; PNG encoding
(``data/png.py``: the GPU host has no PIL), framing and eviction run on one
writer thread. A full queue drops the sample and counts it (``tee_dropped``
on every ``serve_window``). Sealed shards are installed atomically (a
temporary file and ``os.replace``).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Dict, List, Tuple

import numpy as np

from tensorflowdistributedlearning_tpu_torch.data import png as png_lib
from tensorflowdistributedlearning_tpu_torch.data import records as records_lib

logger = logging.getLogger(__name__)

CAPTURE_WINDOW_EVENT = "capture_window"

# sentinel that tells the writer thread to drain and exit
_STOP = object()


def to_uint8_image(arr: np.ndarray) -> np.ndarray:
    """Deterministic float->uint8 image conversion for PNG payloads.

    Serving inputs are normalized floats (standard-normal or [0,1] — the
    artifacts' pinned eval batches are standard-normal too); PNG wants
    uint8. [0,1] inputs scale by 255; anything else min-max scales per
    image. Pure function of the input array, so a captured record is
    byte-reproducible from the sample that produced it."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint8:
        return arr
    a = arr.astype(np.float64)
    if not np.all(np.isfinite(a)):
        raise ValueError("non-finite values in capture sample")
    lo, hi = float(a.min()), float(a.max())
    if 0.0 <= lo and hi <= 1.0:
        return np.round(a * 255.0).astype(np.uint8)
    if hi == lo:
        return np.zeros(a.shape, np.uint8)
    return np.round((a - lo) * (255.0 / (hi - lo))).astype(np.uint8)


def encode_example(image: np.ndarray, label: int) -> bytes:
    """One example -> one framed record payload: the uint8 image as a PNG
    (grey, grey + alpha, RGB or RGBA by its channel count) behind
    ``encode_classification_record``."""
    img = to_uint8_image(image)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    return records_lib.encode_classification_record(int(label), png_lib.encode_png(img))


def _label_array(outputs: Dict, n: int) -> np.ndarray:
    """Per-example self-labels from the served model's outputs: the first
    integer-valued output with one value per example (fit's serving_fn names
    it ``class``). No integer output -> label 0 for every example (the shard
    stays structurally valid; a later supervised join can relabel)."""
    for name in sorted(outputs):
        arr = np.asarray(outputs[name])
        if np.issubdtype(arr.dtype, np.integer) and arr.shape[:1] == (n,):
            return arr.reshape(n, -1)[:, 0] if arr.ndim > 1 else arr
    return np.zeros(n, np.int32)


class TrafficCapture:
    """The tee one serving replica arms (``serve --capture-dir``).

    Shards are named ``capture-{seq:05d}.tfrecord`` with ``.idx`` sidecars;
    ``records_per_shard`` examples seal a shard, ``close()`` seals a partial
    one. ``quota_bytes`` bounds sealed-shard disk use — over quota the
    OLDEST sealed shard is evicted first (the newest data is the most
    valuable to a retrain)."""

    def __init__(
        self,
        directory: str,
        *,
        sample_fraction: float = 1.0,
        records_per_shard: int = 64,
        quota_bytes: int = 64 << 20,
        queue_size: int = 256,
    ):
        if not 0.0 < sample_fraction <= 1.0:
            raise ValueError(
                f"sample_fraction must be in (0, 1], got {sample_fraction}"
            )
        if records_per_shard < 1:
            raise ValueError("records_per_shard must be >= 1")
        if quota_bytes < 1:
            raise ValueError("quota_bytes must be >= 1")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.records_per_shard = int(records_per_shard)
        self.quota_bytes = int(quota_bytes)
        self._stride = max(1, round(1.0 / sample_fraction))
        self._counter = 0
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._lock = threading.Lock()
        # window counters (drained by window_snapshot) + cumulative drops
        self._win: Dict[str, int] = self._zero_window()
        self.total_dropped = 0
        self.total_captured = 0
        self._pending: List[bytes] = []
        # (path, bytes) of sealed shards, oldest first — the eviction order
        self._sealed: List[Tuple[str, int]] = []
        # resume the sequence past shards a previous incarnation sealed (a
        # restarted replica reuses its capture dir; starting at 0 again would
        # overwrite data not yet ingested). Pre-existing shards are
        # NOT quota-tracked: this process never evicts data it did not write.
        self._seq = 1 + max(
            (
                int(f[len("capture-"):-len(".tfrecord")])
                for f in os.listdir(directory)
                if f.startswith("capture-")
                and f.endswith(".tfrecord")
                and f[len("capture-"):-len(".tfrecord")].isdigit()
            ),
            default=-1,
        )
        self._closed = False
        self._writer = threading.Thread(
            target=self._writer_loop, name="capture-writer", daemon=True
        )
        self._writer.start()

    @staticmethod
    def _zero_window() -> Dict[str, int]:
        return {
            "selected": 0,
            "captured": 0,
            "dropped": 0,
            "encode_failures": 0,
            "shards_sealed": 0,
            "shards_evicted": 0,
            "bytes_written": 0,
        }

    # -- hot path -------------------------------------------------------------

    def maybe_capture(self, instances: np.ndarray, outputs: Dict) -> None:
        """Stride-sample one ACCEPTED request; never blocks, never raises.
        Copies the batch (the caller's array goes back to the request pool)
        and enqueues for the writer thread; a full queue counts a drop."""
        with self._lock:
            self._counter += 1
            if self._counter % self._stride != 0 or self._closed:
                return
            self._win["selected"] += 1
        try:
            n = int(np.asarray(instances).shape[0])
            item = (np.array(instances, copy=True), _label_array(outputs, n))
        except Exception:  # noqa: BLE001 — a malformed output must not 500
            # the request that already answered successfully
            with self._lock:
                self._win["encode_failures"] += 1
            return
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            with self._lock:
                self._win["dropped"] += 1
                self.total_dropped += 1

    # -- writer thread --------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                self._seal_pending()
                return
            images, labels = item
            for i in range(len(images)):
                try:
                    rec = encode_example(images[i], int(labels[i]))
                except Exception:  # noqa: BLE001 — one bad sample must not
                    # kill the writer for the replica's lifetime
                    with self._lock:
                        self._win["encode_failures"] += 1
                    continue
                self._pending.append(rec)
                with self._lock:
                    self._win["captured"] += 1
                    self.total_captured += 1
                if len(self._pending) >= self.records_per_shard:
                    self._seal_pending()

    def _seal_pending(self) -> None:
        if not self._pending:
            return
        path = os.path.join(self.directory, f"capture-{self._seq:05d}.tfrecord")
        self._seq += 1
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            records_lib.write_records(tmp, self._pending)
            os.replace(tmp, path)
            records_lib.write_shard_index(path)
        except OSError:
            logger.exception("capture shard seal failed: %s", path)
            self._pending = []
            return
        size = os.path.getsize(path)
        self._pending = []
        with self._lock:
            self._sealed.append((path, size))
            self._win["shards_sealed"] += 1
            self._win["bytes_written"] += size
        self._enforce_quota()

    def _enforce_quota(self) -> None:
        """Evict oldest-first until sealed bytes fit the quota (the newest
        shard always survives — evicting what was just written would make
        the tee a no-op at any quota below one shard)."""
        while True:
            with self._lock:
                total = sum(b for _, b in self._sealed)
                if total <= self.quota_bytes or len(self._sealed) <= 1:
                    return
                path, _ = self._sealed.pop(0)
                self._win["shards_evicted"] += 1
            for victim in (path, records_lib.shard_index_path(path)):
                try:
                    os.remove(victim)
                except FileNotFoundError:
                    pass

    # -- lifecycle / telemetry ------------------------------------------------

    def window_snapshot(self, drain: bool = True) -> Dict:
        """One ``capture_window`` record: this window's counters plus the
        live totals the report reads (cumulative drops stay visible even
        when every later window is clean)."""
        with self._lock:
            win = dict(self._win)
            if drain:
                self._win = self._zero_window()
            sealed_bytes = sum(b for _, b in self._sealed)
            out = {
                **win,
                "shards": len(self._sealed),
                "bytes_on_disk": sealed_bytes,
                "quota_bytes": self.quota_bytes,
                "total_captured": self.total_captured,
                "total_dropped": self.total_dropped,
            }
        return out

    def active(self) -> bool:
        with self._lock:
            return any(self._win.values()) or bool(self._pending)

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue, seal the partial shard, stop the writer. After
        close the tee drops silently-but-counted (the server may still be
        answering its last drained requests)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(_STOP)
        self._writer.join(timeout=timeout)

