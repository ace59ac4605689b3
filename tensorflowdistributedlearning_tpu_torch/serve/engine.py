"""Bucketed inference engine (counterpart of the JAX package's
``serve/engine.py``).

Requests are zero-padded up to the smallest bucket of a fixed ladder
(default 1/4/16/64) that fits, run, and sliced back, so the device only ever
sees ``len(buckets)`` batch shapes, each of them exercised by
:meth:`InferenceEngine.warmup` before traffic.

In the JAX package each bucket is its own XLA executable and warmup compiles
them (with a persistent compile cache, ``engine.py:54-97``, so a replica can
load rather than compile). Eager PyTorch compiles nothing per shape, so that
cache has no counterpart here; warmup still runs every bucket once to load
the kernels, settle cuDNN's algorithm choice and fill the caching
allocator. Capturing one CUDA graph per bucket is a later change.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflowdistributedlearning_tpu_torch.obs.metrics import MetricsRegistry

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 4, 16, 64)


class RequestTooLargeError(ValueError):
    """More examples than the largest bucket: the caller must chunk."""


def _to_numpy(tree, n: int):
    if isinstance(tree, dict):
        return {k: _to_numpy(v, n) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree[:n].detach().cpu().numpy()
    return np.asarray(tree)[:n]


class InferenceEngine:
    """Pads request batches into a fixed bucket ladder and runs ``serve_fn``
    (``x [B, *example_shape] -> dict of [B, ...]``). ``infer`` is
    thread-safe: the pad scratch buffers are thread-local and instrument
    updates are locked."""

    def __init__(
        self,
        serve_fn: Callable,
        example_shape: Sequence[int],
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        input_dtype="float32",
        registry: Optional[MetricsRegistry] = None,
    ):
        self.serve_fn = serve_fn
        self.example_shape = tuple(int(d) for d in example_shape)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.input_dtype = np.dtype(input_dtype)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._pad_h = self.registry.histogram("serve/pad")
        self._compute_h = self.registry.histogram("serve/compute")
        self._hit_counters = {b: self.registry.counter(f"serve/bucket_hits/{b}") for b in self.buckets}
        self._example_counters = {b: self.registry.counter(f"serve/bucket_examples/{b}") for b in self.buckets}
        self._scratch = threading.local()
        self.warmed = False

    @classmethod
    def from_artifact(
        cls,
        directory: str,
        *,
        device=None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        registry: Optional[MetricsRegistry] = None,
    ) -> "InferenceEngine":
        """Engine over an exported artifact (``train/serving.py``) on
        ``device`` (CUDA when None). The manifest supplies the example shape
        and input dtype."""
        from tensorflowdistributedlearning_tpu_torch.train import serving as serving_lib

        manifest = serving_lib.read_manifest(directory)
        shape = manifest["input_shape"]
        if any(d is None for d in shape[1:]):
            raise ValueError(f"artifact input shape {shape} has a symbolic non-batch dim")
        serve = serving_lib.load_serving_artifact(directory, device)
        return cls(
            serve, tuple(shape[1:]), buckets=buckets, input_dtype=manifest["input_dtype"], registry=registry
        )

    @property
    def max_batch_size(self) -> int:
        return self.buckets[-1]

    @property
    def bucket_hits(self) -> Dict[int, int]:
        return {b: c.value for b, c in self._hit_counters.items()}

    @property
    def padding_waste(self) -> Dict[int, float]:
        """Per bucket that saw traffic: ``1 - examples / (hits * bucket)``."""
        waste: Dict[int, float] = {}
        for b in self.buckets:
            hits = self._hit_counters[b].value
            if hits:
                waste[b] = round(1.0 - self._example_counters[b].value / (hits * b), 4)
        return waste

    def _scratch_for(self, bucket: int) -> np.ndarray:
        bufs = getattr(self._scratch, "bufs", None)
        if bufs is None:
            bufs = self._scratch.bufs = {}
        buf = bufs.get(bucket)
        if buf is None:
            buf = bufs[bucket] = np.zeros((bucket, *self.example_shape), self.input_dtype)
        return buf

    def select_bucket(self, n: int) -> int:
        """Smallest bucket that fits ``n`` examples."""
        if n < 1:
            raise ValueError(f"cannot serve an empty batch (n={n})")
        i = bisect.bisect_left(self.buckets, n)
        if i == len(self.buckets):
            raise RequestTooLargeError(
                f"{n} examples exceeds the largest bucket ({self.max_batch_size}); chunk the request"
            )
        return self.buckets[i]

    def warmup(self) -> Dict[int, float]:
        """Run every bucket once on zeros; returns per-bucket wall seconds."""
        timings: Dict[int, float] = {}
        for b in self.buckets:
            x = np.zeros((b, *self.example_shape), self.input_dtype)
            t0 = time.perf_counter()
            _to_numpy(self.serve_fn(x), b)
            timings[b] = time.perf_counter() - t0
        self.warmed = True
        return timings

    def infer(self, x) -> Dict:
        """Forward ``x [n, *example_shape]`` through the ladder: pad to the
        selected bucket, run, slice every output back to ``n`` rows (numpy)."""
        x = np.asarray(x, self.input_dtype)
        if x.shape[1:] != self.example_shape:
            raise ValueError(f"expected examples of shape {self.example_shape}, got batch {x.shape}")
        n = x.shape[0]
        bucket = self.select_bucket(n)
        t0 = time.perf_counter()
        if n != bucket:
            buf = self._scratch_for(bucket)
            buf[:n] = x
            buf[n:] = 0
            x = buf
        self._pad_h.record(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = _to_numpy(self.serve_fn(x), n)  # the device-to-host copy waits for the result
        self._compute_h.record(time.perf_counter() - t0)
        self._hit_counters[bucket].inc()
        self._example_counters[bucket].inc(n)
        return out
