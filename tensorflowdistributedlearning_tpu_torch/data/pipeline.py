"""Host-side input pipeline: decode, shuffle, batch, prefetch (counterpart of
``tensorflowdistributedlearning_tpu/data/pipeline.py``).

The host decodes PNGs once into RAM and assembles numpy batches; geometry
and augmentation run on the device (``data/augment.py``). The batch streams
are the JAX package's numpy code, so the same seed gives the same batches in
the same order. :func:`device_prefetch` copies each batch from pinned host
memory to the device with a non-blocking copy on a producer thread, staying
``depth`` batches ahead of the train loop.
"""

from __future__ import annotations

import os
import queue as queue_lib
import threading
import weakref
from glob import glob
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflowdistributedlearning_tpu_torch.data.augment import MEAN, STD
from tensorflowdistributedlearning_tpu_torch.data.png import read_png_gray
from tensorflowdistributedlearning_tpu_torch.parallel import multihost


def load_png(path: str) -> np.ndarray:
    """Decode one PNG to grey [H, W, 1] float32 in [0, 1]."""
    return (read_png_gray(path).astype(np.float32) / np.float32(255.0))[:, :, None]


def _decode_batch(paths: Sequence[str]) -> np.ndarray:
    """[N, H, W, 1] float32 in [0, 1] of same-sized PNGs."""
    if not paths:
        return np.empty((0, 0, 0, 1), np.float32)
    first = load_png(paths[0])
    out = np.empty((len(paths), *first.shape), np.float32)
    out[0] = first
    for i, path in enumerate(paths[1:], start=1):
        image = load_png(path)
        if image.shape != first.shape:
            raise ValueError(f"{path}: shape {image.shape[:2]} differs from the first image's {first.shape[:2]}")
        out[i] = image
    return out


def load_masks(data_dir: str, ids: Sequence[str]) -> np.ndarray:
    """``{data_dir}/masks/{id}.png`` as binary [N, H, W, 1] float32 (> 0.5)."""
    paths = [os.path.join(data_dir, "masks", f"{i}.png") for i in ids]
    return (_decode_batch(paths) > 0.5).astype(np.float32)


def discover_ids(data_dir: str) -> List[str]:
    """Example ids of ``{data_dir}/images/*.png``, sorted."""
    paths = sorted(glob(os.path.join(data_dir, "images", "*.png")))
    return [os.path.splitext(os.path.basename(p))[0] for p in paths]


def mask_coverage(masks: np.ndarray) -> np.ndarray:
    """Fraction of positive pixels per mask (the stratification signal)."""
    return masks.reshape(masks.shape[0], -1).mean(axis=1)


class InMemoryDataset:
    """Decoded examples in host RAM: ``images`` [N, H, W, 1] float32,
    normalized as (x - MEAN) / STD; ``masks`` [N, H, W, 1] float32 in {0, 1}
    (None for test sets)."""

    def __init__(self, images: np.ndarray, masks: Optional[np.ndarray], ids: List[str]):
        self.images = images
        self.masks = masks
        self.ids = ids

    def __len__(self) -> int:
        return len(self.ids)

    @classmethod
    def from_directory(
        cls,
        data_dir: str,
        ids: Optional[Sequence[str]] = None,
        with_masks: bool = True,
        normalize: bool = True,
    ) -> "InMemoryDataset":
        """Load ``{data_dir}/images/{id}.png`` (+ ``masks/``) for ``ids``
        (all of ``discover_ids`` when None)."""
        ids = list(discover_ids(data_dir) if ids is None else ids)
        if not ids:
            raise ValueError(f"No examples found under {data_dir}/images")
        images = _decode_batch([os.path.join(data_dir, "images", f"{i}.png") for i in ids])
        if normalize:
            images = (images - MEAN) / STD
        masks = load_masks(data_dir, ids) if with_masks else None
        return cls(images, masks, ids)

    def select(self, ids: Sequence[str]) -> "InMemoryDataset":
        index = {i: k for k, i in enumerate(self.ids)}
        rows = np.asarray([index[i] for i in ids])
        return InMemoryDataset(self.images[rows], None if self.masks is None else self.masks[rows], list(ids))


def host_shard(ids: Sequence[str]) -> List[str]:
    """The ids this process is responsible for in a data-parallel run: the
    round-robin share ``ids[index::degree]`` of its data slot
    (``multihost.data_slot``: the rank of the world without tensor
    parallelism); everything in a single process."""
    index, n = multihost.data_slot()
    if n == 1:
        return list(ids)
    return list(ids)[index::n]


def train_batches(
    dataset: InMemoryDataset, batch_size: int, seed: int, steps: Optional[int] = None
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite (or ``steps``-bounded) stream of shuffled {'images', 'masks'}
    batches: seeded epoch permutations chained so every batch is full."""
    n = len(dataset)
    if n == 0:
        raise ValueError("Empty dataset")
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    pos = 0
    emitted = 0
    while steps is None or emitted < steps:
        while len(order) - pos < batch_size:
            order = np.concatenate([order[pos:], rng.permutation(n)])
            pos = 0
        rows = order[pos : pos + batch_size]
        pos += batch_size
        emitted += 1
        yield {"images": dataset.images[rows], "masks": dataset.masks[rows]}


def eval_index_batches(
    n: int, batch_size: int, num_batches: Optional[int] = None
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``(rows, valid)`` index batches covering ``n`` examples in order; the
    last partial batch wraps around (modulo ``n``) and ``valid`` marks its
    pad rows 0, so every example counts exactly once."""
    total = num_batches if num_batches is not None else max(1, -(-n // batch_size))
    for b in range(total):
        start = b * batch_size
        rows = np.arange(start, min(start + batch_size, n), dtype=np.int64)
        valid = np.ones(batch_size, np.float32)
        if len(rows) < batch_size:
            valid[len(rows) :] = 0.0
            pad = (
                np.arange(batch_size - len(rows), dtype=np.int64) % n
                if n > 0
                else np.zeros(batch_size - len(rows), np.int64)
            )
            rows = np.concatenate([rows, pad])
        yield rows, valid


def eval_batches(
    dataset: InMemoryDataset, batch_size: int, num_batches: Optional[int] = None
) -> Iterator[Dict[str, np.ndarray]]:
    """One ordered pass as {'images', 'valid'[, 'masks']} batches under the
    :func:`eval_index_batches` padding contract."""
    n = len(dataset)
    h, w, c = dataset.images.shape[1:]
    for rows, valid in eval_index_batches(n, batch_size, num_batches):
        if n == 0:
            batch = {"images": np.zeros((batch_size, h, w, c), np.float32), "valid": valid}
            if dataset.masks is not None:
                batch["masks"] = np.zeros((batch_size, h, w, 1), np.float32)
        else:
            batch = {"images": dataset.images[rows], "valid": valid}
            if dataset.masks is not None:
                batch["masks"] = dataset.masks[rows]
        yield batch


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: through pinned memory and a
    non-blocking copy for CUDA (the caching host allocator keeps each pinned
    buffer until its copy has run), as they are for the CPU."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def device_prefetch(iterator: Iterator, place: Callable, depth: int = 2, registry=None) -> Iterator:
    """Buffered host-to-device prefetch: a daemon thread places batches
    (``place``, e.g. :func:`to_device`) and stays ``depth`` batches ahead.
    Puts are stop-aware, so a consumer that abandons the stream releases the
    thread; errors in the producer re-raise in the consumer. ``registry``
    (an ``obs.metrics.MetricsRegistry``) records the batches still ready at
    each take into ``prefetch/queue_depth`` (0: the consumer caught the
    producer)."""
    if depth < 1:
        raise ValueError(f"device_prefetch depth must be >= 1, got {depth}")
    q: queue_lib.Queue = queue_lib.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    class _Failure:
        def __init__(self, error: BaseException):
            self.error = error

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue_lib.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(place(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
            put(_Failure(e))
            return
        put(done)

    thread = threading.Thread(target=producer, daemon=True, name="device_prefetch")
    thread.start()
    hist = None
    if registry is not None:
        from tensorflowdistributedlearning_tpu_torch.obs.telemetry import PREFETCH_DEPTH_HISTOGRAM

        hist = registry.histogram(PREFETCH_DEPTH_HISTOGRAM)

    def consume():
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, _Failure):
                    raise item.error
                if hist is not None:
                    hist.record(float(q.qsize()))
                yield item
        finally:
            stop.set()

    gen = consume()
    weakref.finalize(gen, stop.set)
    return gen
