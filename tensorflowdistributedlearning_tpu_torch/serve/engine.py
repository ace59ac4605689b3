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
allocator. That first run of a bucket is what compiles in JAX, and the
engine reports it as such: ``warmup(budget=K)`` leaves the top of the ladder
cold, and a cold bucket's first hit is counted per bucket
(``serve/cold_bucket_hits/{b}``) and, under telemetry, as a post-warmup
``compile`` event (``obs/telemetry.FirstRunDetector``). With a tracer the
engine emits ``pad`` and ``compute`` spans that nest under the batcher's
``batch`` span; the compute span ends after the device-to-host copy, so it
times the device work, not the launch. Capturing one CUDA graph per bucket
is a speed item for later.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflowdistributedlearning_tpu_torch.obs import trace as trace_lib
from tensorflowdistributedlearning_tpu_torch.obs.metrics import MetricsRegistry
from tensorflowdistributedlearning_tpu_torch.utils.devices import resolve_device

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 4, 16, 64)

# the untraced request path pays no span entry
_NULL_CTX = contextlib.nullcontext()


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
        quantization: Optional[Dict] = None,
        tracer: Optional[trace_lib.Tracer] = None,
        device=None,
    ):
        self.serve_fn = serve_fn
        # the device serve_fn runs on (None for a raw closure): the card the
        # server's cost and watermarks count
        self.device = device
        self.example_shape = tuple(int(d) for d in example_shape)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.input_dtype = np.dtype(input_dtype)
        # the manifest's quantization section (None for a raw closure)
        self.quantization = quantization
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else trace_lib.NULL_TRACER
        self._pad_h = self.registry.histogram("serve/pad")
        self._compute_h = self.registry.histogram("serve/compute")
        self._hit_counters = {b: self.registry.counter(f"serve/bucket_hits/{b}") for b in self.buckets}
        self._example_counters = {b: self.registry.counter(f"serve/bucket_examples/{b}") for b in self.buckets}
        self._scratch = threading.local()
        self.warmed = False
        # buckets run at least once; warmup(budget=K) leaves the rest cold
        self.warmed_buckets: set = set()
        self._cold_counters = {b: self.registry.counter(f"serve/cold_bucket_hits/{b}") for b in self.buckets}
        # the telemetry's FirstRunDetector once warmup(telemetry=...) ran
        self._first_runs = None

    @classmethod
    def from_artifact(
        cls,
        directory: str,
        *,
        device=None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        registry: Optional[MetricsRegistry] = None,
        tracer: Optional[trace_lib.Tracer] = None,
    ) -> "InferenceEngine":
        """Engine over an exported artifact (``train/serving.py``) on
        ``device`` (CUDA when None). The manifest supplies the example shape,
        input dtype and quantization section."""
        from tensorflowdistributedlearning_tpu_torch.train import serving as serving_lib

        manifest = serving_lib.read_manifest(directory)
        shape = manifest["input_shape"]
        if any(d is None for d in shape[1:]):
            raise ValueError(f"artifact input shape {shape} has a symbolic non-batch dim")
        device = resolve_device(device)
        serve = serving_lib.load_serving_artifact(directory, device)
        return cls(
            serve, tuple(shape[1:]), buckets=buckets, input_dtype=manifest["input_dtype"], registry=registry,
            quantization=manifest.get("quantization"), tracer=tracer, device=device,
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

    def warmup(self, telemetry=None, *, budget: Optional[int] = None, mark_warm: bool = True) -> Dict[int, float]:
        """Run the smallest ``budget`` buckets (all when None) once on zeros;
        returns per-bucket wall seconds. With ``telemetry``: one
        ``serve_warmup`` event, each first run counted by its
        ``FirstRunDetector``, the warm mark (``mark_warm=False`` defers it:
        a replica warming several engines marks once, after the last) and a
        ``compile``-phase watermark."""
        detector = getattr(telemetry, "detector", None)
        if detector is not None:
            self._first_runs = detector
        to_warm = self.buckets
        if budget is not None and budget < len(self.buckets):
            to_warm = self.buckets[: max(0, int(budget))]
        timings: Dict[int, float] = {}
        for b in to_warm:
            x = np.zeros((b, *self.example_shape), self.input_dtype)
            t0 = time.perf_counter()
            _to_numpy(self.serve_fn(x), b)
            timings[b] = round(time.perf_counter() - t0, 6)
            self.warmed_buckets.add(b)
            if self._first_runs is not None:
                self._first_runs.note(timings[b])
        self.warmed = True
        if telemetry is not None:
            warm_fields: Dict = {}
            if self.quantization is not None:
                warm_fields["serving_dtype"] = self.quantization.get("dtype")
                if self.quantization.get("compute_dtype"):
                    warm_fields["compute_dtype"] = self.quantization["compute_dtype"]
            cold = [b for b in self.buckets if b not in self.warmed_buckets]
            if cold:
                warm_fields["cold_buckets"] = [str(b) for b in cold]
                warm_fields["prewarm_budget"] = len(to_warm)
            telemetry.event(
                "serve_warmup",
                buckets={str(b): timings[b] for b in sorted(timings)},
                example_shape=list(self.example_shape),
                input_dtype=str(self.input_dtype),
                **warm_fields,
            )
            if mark_warm:
                telemetry.mark_warm()
            from tensorflowdistributedlearning_tpu_torch.obs import capacity as capacity_lib

            telemetry.sample_watermark(capacity_lib.PHASE_COMPILE)
        return timings

    def infer(self, x) -> Dict:
        """Forward ``x [n, *example_shape]`` through the ladder: pad to the
        selected bucket, run, slice every output back to ``n`` rows (numpy)."""
        x = np.asarray(x, self.input_dtype)
        if x.shape[1:] != self.example_shape:
            raise ValueError(f"expected examples of shape {self.example_shape}, got batch {x.shape}")
        n = x.shape[0]
        bucket = self.select_bucket(n)
        first_run = self.warmed and bucket not in self.warmed_buckets
        if first_run:
            # a cold bucket past a budgeted warmup: this dispatch pays the first run
            self._cold_counters[bucket].inc()
            self.warmed_buckets.add(bucket)
        traced = self.tracer.enabled
        attrs = {"bucket": bucket, "n": n} if traced else None
        t0 = time.perf_counter()
        with self.tracer.span(trace_lib.SPAN_PAD, attrs=attrs) if traced else _NULL_CTX:
            if n != bucket:
                buf = self._scratch_for(bucket)
                buf[:n] = x
                buf[n:] = 0
                x = buf
        self._pad_h.record(time.perf_counter() - t0)
        t0 = time.perf_counter()
        with self.tracer.span(trace_lib.SPAN_COMPUTE, attrs=attrs) if traced else _NULL_CTX:
            out = _to_numpy(self.serve_fn(x), n)  # the device-to-host copy waits for the result
        compute_s = time.perf_counter() - t0
        self._compute_h.record(compute_s)
        self._hit_counters[bucket].inc()
        self._example_counters[bucket].inc(n)
        if first_run and self._first_runs is not None:
            self._first_runs.note(compute_s)
        return out
