"""The streaming data service: global-shuffle epochs, parallel read and
decode workers, and an index-keyed resume (counterpart of the JAX package's
``data/service.py``; the same seed tags, plans and batches, so batch ``i``
here is batch ``i`` there).

- ``epoch_shard_assignment``: every epoch permutes all shard files with a
  seeded generator and deals them round-robin across the processes; within
  a process's epoch the records are a full seeded permutation.
- The epochs concatenate into one infinite virtual record sequence, and
  batch ``i`` is records ``[i*B, (i+1)*B)`` of it: a pure function of
  ``(seed, i)``, whatever the worker count. N background workers claim
  batch indices round-robin, read their records (``ClassificationRecordSource``
  through ``records.ShardRangeReader`` at the ``.idx`` offsets) or index
  host arrays (``ArrayBatchSource``), decode, and a reorder buffer hands the
  batches back in index order with bounded backpressure.
- ``DataServiceState``: the resume state ``(seed, next batch index)``, with
  the batch size, world size and shard fingerprint it was written under.
  The trainers save it beside every checkpoint
  (``train.checkpoint.CheckpointManager.save_data_state``); a resume
  validates it and replays the exact remaining stream.

With a ``registry`` (an ``obs.metrics.MetricsRegistry``), the reorder
buffer's depth at each take, the consumer's underruns, the workers' busy
seconds and the worker count flow into it under the JAX package's
``data_service/*`` names, which the trainers' step windows drain.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tensorflowdistributedlearning_tpu_torch.data import records as rec
from tensorflowdistributedlearning_tpu_torch.parallel import multihost
from tensorflowdistributedlearning_tpu_torch.resilience import retry as retry_lib

# seed-stream tags: every rng in the service derives from a distinct
# (seed, tag, ...) SeedSequence so shard assignment, record permutations and
# any future stream can never collide
_TAG_SHARDS = 0x5A
_TAG_RECORDS = 0xC3


class _PlanCache:
    """Small thread-safe cache for per-epoch plans, keyed by the FULL
    ``(seed, epoch)`` pair — a source reused by two services with different
    seeds must never serve the first seed's permutation to the second.
    Capacity is a handful: a batch touches at most a few neighbouring
    epochs, and plans are pure functions so eviction only costs recompute."""

    def __init__(self, capacity: int = 4):
        self._capacity = int(capacity)
        self._lock = threading.Lock()
        self._plans: Dict[Tuple[int, int], object] = {}
        self._order: List[Tuple[int, int]] = []

    def get_or_build(self, seed: int, epoch: int, build):
        key = (int(seed), int(epoch))
        with self._lock:
            cached = self._plans.get(key)
        if cached is not None:
            return cached
        plan = build()
        with self._lock:
            if key not in self._plans:
                self._plans[key] = plan
                self._order.append(key)
                while len(self._order) > self._capacity:
                    self._plans.pop(self._order.pop(0), None)
        return plan


def epoch_shard_assignment(
    paths: Sequence[str],
    *,
    seed: int,
    epoch: int,
    process_index: int,
    process_count: int,
) -> List[str]:
    """This process's shard files for ``epoch``: a seeded permutation of the
    (canonically sorted) full shard list, dealt round-robin across processes.

    Deterministic given ``(seed, epoch, process_index, process_count)``; the
    per-epoch union over processes is always EXACTLY the full shard set (the
    permutation is a bijection and the round-robin deal partitions it), so no
    record is read twice or skipped within an epoch, and with ``len(paths) >=
    process_count`` every process owns at least one shard every epoch — the
    uneven-split contract ``tests/test_torch_data_service.py`` holds."""
    if process_count < 1 or not 0 <= process_index < process_count:
        raise ValueError(
            f"bad process slot {process_index}/{process_count} for shard "
            "assignment"
        )
    order = sorted(paths)
    rng = np.random.default_rng((int(seed), _TAG_SHARDS, int(epoch)))
    perm = rng.permutation(len(order))
    return [order[perm[i]] for i in range(process_index, len(order), process_count)]


@dataclasses.dataclass(frozen=True)
class DataServiceState:
    """The stream's full resume state. Because batch ``i`` is a pure function
    of ``(seed, i)``, ``(seed, batch_index)`` pins the exact remaining
    stream — PROVIDED batch size and world size are unchanged (batch ``i``
    maps to virtual records ``[i*B, (i+1)*B)`` of this host's plan, so either
    changing silently re-trains or skips data); both ride along and are
    validated on restore. ``epoch`` is the derived position (informational —
    rendered in reports, recomputed on restore)."""

    seed: int
    batch_index: int
    epoch: int = 0
    batch_size: int = 0  # 0 = unknown (legacy sidecar): not validated
    process_count: int = 0  # 0 = unknown (legacy sidecar): not validated
    # digest of the sorted shard basenames ("" = unknown): a changed shard
    # SET re-deals every epoch plan, which is the same silent replay/skip
    # failure as a changed seed — validated when both sides know it
    shard_fingerprint: str = ""

    def to_json(self) -> Dict:
        out = {
            "seed": int(self.seed),
            "batch_index": int(self.batch_index),
            "epoch": int(self.epoch),
        }
        if self.batch_size:
            out["batch_size"] = int(self.batch_size)
        if self.process_count:
            out["process_count"] = int(self.process_count)
        if self.shard_fingerprint:
            out["shard_fingerprint"] = self.shard_fingerprint
        return out

    @classmethod
    def from_json(cls, d: Dict) -> "DataServiceState":
        return cls(
            seed=int(d["seed"]),
            batch_index=int(d["batch_index"]),
            epoch=int(d.get("epoch", 0)),
            batch_size=int(d.get("batch_size", 0)),
            process_count=int(d.get("process_count", 0)),
            shard_fingerprint=str(d.get("shard_fingerprint", "")),
        )


class ClassificationRecordSource:
    """Record-shard source for the service: classification payloads
    (``int32 label | encoded image``) read at indexed offsets and decoded to
    the fit loop's ``{'images','labels','valid'}`` batches.

    Takes the FULL shard list (not a host subset): per-epoch host assignment
    happens here, via ``epoch_shard_assignment`` over
    ``(process_index, process_count)`` — pass them explicitly in tests/tools,
    default to this rank's slot."""

    def __init__(
        self,
        paths: Sequence[str],
        *,
        image_shape: Tuple[int, int],
        channels: int = 3,
        num_classes: Optional[int] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        verify_crc: bool = True,
    ):
        if not paths:
            raise ValueError("ClassificationRecordSource needs shard paths")
        if process_index is None or process_count is None:
            process_index, process_count = multihost.data_slot()
        if len(paths) < process_count:
            raise ValueError(
                f"{len(paths)} record shard(s) for {process_count} processes "
                "— every process needs at least one per epoch; re-shard the "
                "dataset (write_classification_shards(shards>=process_count))"
            )
        self.paths = [str(p) for p in paths]
        # shard-set identity for the resume contract: basenames, not full
        # paths, so the same dataset restored under a different mount still
        # matches while any re-sharding/addition/removal is caught
        import hashlib

        self.shard_fingerprint = hashlib.md5(
            "\n".join(sorted(os.path.basename(p) for p in self.paths)).encode()
        ).hexdigest()[:16]
        self.image_shape = tuple(image_shape)
        self.channels = int(channels)
        self.num_classes = num_classes
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.verify_crc = bool(verify_crc)
        self._lock = threading.Lock()
        self._offsets: Dict[str, np.ndarray] = {}
        self._plans = _PlanCache()
        self._local = threading.local()

    # -- deterministic epoch plans ----------------------------------------

    def _shard_offsets(self, path: str) -> np.ndarray:
        with self._lock:
            got = self._offsets.get(path)
        if got is not None:
            return got
        offs = rec.shard_offsets(path)
        with self._lock:
            self._offsets[path] = offs
        return offs

    def _plan(self, seed: int, epoch: int):
        """(shards, shard_slot[], offset[]) for this host's ``epoch`` — the
        seeded full permutation over every record in the epoch's assigned
        shards. Cached per (seed, epoch); pure function of (seed, epoch,
        slot)."""

        def build():
            shards = epoch_shard_assignment(
                self.paths,
                seed=seed,
                epoch=epoch,
                process_index=self.process_index,
                process_count=self.process_count,
            )
            slots: List[np.ndarray] = []
            offsets: List[np.ndarray] = []
            for s, path in enumerate(shards):
                offs = self._shard_offsets(path)
                slots.append(np.full(len(offs), s, np.int64))
                offsets.append(offs)
            slot_arr = (
                np.concatenate(slots) if slots else np.empty(0, np.int64)
            )
            off_arr = (
                np.concatenate(offsets) if offsets else np.empty(0, np.uint64)
            )
            rng = np.random.default_rng(
                (int(seed), _TAG_RECORDS, int(epoch), self.process_index)
            )
            perm = rng.permutation(len(slot_arr))
            return (shards, slot_arr[perm], off_arr[perm])

        return self._plans.get_or_build(seed, epoch, build)

    def epoch_size(self, seed: int, epoch: int) -> int:
        shards = epoch_shard_assignment(
            self.paths,
            seed=seed,
            epoch=epoch,
            process_index=self.process_index,
            process_count=self.process_count,
        )
        return int(sum(len(self._shard_offsets(p)) for p in shards))

    # -- worker-side read + decode ----------------------------------------

    # per-worker-thread open-reader bound: without it a run over an
    # ImageNet-scale shard count (1024+) would hold workers x shards open
    # FILE*s (past the common 1024-fd ulimit) plus each native handle's last
    # read buffers. Reopen-on-miss is one fopen+fseek — noise next to decode.
    _MAX_READERS_PER_THREAD = 16

    def _reader(self, path: str):
        from collections import OrderedDict

        cache = getattr(self._local, "readers", None)
        if cache is None:
            cache = self._local.readers = OrderedDict()
        reader = cache.get(path)
        if reader is None:
            reader = cache[path] = rec.ShardRangeReader(
                path, verify_crc=self.verify_crc
            )
            while len(cache) > self._MAX_READERS_PER_THREAD:
                _, evicted = cache.popitem(last=False)
                evicted.close()
        else:
            cache.move_to_end(path)
        return reader

    def materialize(
        self, seed: int, parts: List[Tuple[int, np.ndarray]]
    ) -> Dict[str, np.ndarray]:
        """Assemble one batch from plan positions: ``parts`` is
        ``[(epoch, positions), ...]`` in batch order. Reads are grouped per
        shard (one native range call each) and scattered back into plan
        order, so the result is independent of grouping; transient read I/O
        retries through the resilience stack. Decode (label validation, blob
        decode behind the ``io-data`` fault site, normalization) is the ONE
        shared recipe ``records.decode_classification_batch`` — service-fed
        and legacy-fed batches cannot drift."""

        def read() -> List[bytes]:
            entries: List[Tuple[str, int]] = []
            for epoch, idxs in parts:
                shards, slot_arr, off_arr = self._plan(seed, epoch)
                for i in idxs:
                    entries.append((shards[slot_arr[i]], int(off_arr[i])))
            by_shard: Dict[str, Tuple[List[int], List[int]]] = {}
            for pos, (path, off) in enumerate(entries):
                positions, offs = by_shard.setdefault(path, ([], []))
                positions.append(pos)
                offs.append(off)
            payloads: List[Optional[bytes]] = [None] * len(entries)
            for path, (positions, offs) in by_shard.items():
                for pos, payload in zip(
                    positions, self._reader(path).read(offs)
                ):
                    payloads[pos] = payload
            return payloads

        payloads = retry_lib.call_with_retry(
            read, name="data_service_read", exceptions=(OSError,)
        )
        labels: List[int] = []
        blobs: List[bytes] = []
        for payload in payloads:
            label, img = rec.decode_classification_record(payload)
            labels.append(label)
            blobs.append(img)
        return rec.decode_classification_batch(
            blobs,
            labels,
            len(blobs),
            image_shape=self.image_shape,
            channels=self.channels,
            num_classes=self.num_classes,
        )


class ArrayBatchSource:
    """In-memory source for the service: seeded epoch permutations over host
    arrays, batches assembled by fancy indexing — the index-keyed,
    service-fed replacement for ``pipeline.train_batches``'s chained
    rng-stateful permutations (same mixing, but batch ``i`` is a pure
    function of the seed, so the K-fold trainer resumes deterministically
    without seed-folding tricks). ``arrays`` values must share a leading
    dimension (e.g. ``{'images': ..., 'masks': ...}``).

    ``process_count``: the world size the arrays were SHARDED FOR (callers
    that host-shard before constructing — the K-fold trainer's
    ``pipeline.host_shard`` fold split). When set it rides the service's
    resume sidecar, so a resumed fold that crossed a world resize re-deals
    explicitly (logged) instead of silently indexing a different host
    shard; None/0 = world-independent arrays (nothing validated)."""

    def __init__(
        self,
        arrays: Dict[str, np.ndarray],
        *,
        process_count: Optional[int] = None,
    ):
        if not arrays:
            raise ValueError("ArrayBatchSource needs at least one array")
        self.process_count = int(process_count or 0)
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"array lengths disagree: {lengths}")
        self.n = next(iter(lengths.values()))
        if self.n == 0:
            raise ValueError("ArrayBatchSource over an empty dataset")
        self.arrays = dict(arrays)
        self._plans = _PlanCache()

    def epoch_size(self, seed: int, epoch: int) -> int:
        return self.n

    def _plan(self, seed: int, epoch: int) -> np.ndarray:
        return self._plans.get_or_build(
            seed,
            epoch,
            lambda: np.random.default_rng(
                (int(seed), _TAG_RECORDS, int(epoch))
            ).permutation(self.n),
        )

    def materialize(
        self, seed: int, parts: List[Tuple[int, np.ndarray]]
    ) -> Dict[str, np.ndarray]:
        rows = np.concatenate(
            [self._plan(seed, epoch)[idxs] for epoch, idxs in parts]
        )
        return {k: v[rows] for k, v in self.arrays.items()}


class StreamingDataService:
    """N parallel read+decode workers executing the index-keyed batch plan,
    with an in-order reorder buffer and bounded backpressure.

    One service drives ONE stream (``batches()`` is single-shot, like
    ``device_prefetch``). ``registry`` (an ``obs.metrics.MetricsRegistry``)
    records the reorder-buffer depth, underruns and worker busy time under
    the ``data_service/*`` names; None records nothing.

    ``resume_state`` (a ``DataServiceState`` json dict, from the checkpoint
    sidecar) is VALIDATED against ``(seed, start_batch)``: a mismatch means
    the run is about to silently replay or skip data, which must crash, not
    train — with ONE deliberate exception: a changed ``process_count`` (a
    world resize) re-deals the per-epoch shard
    assignment at the new world size instead of refusing. The re-deal keeps
    the epoch-boundary math intact — batch ``i`` maps onto the NEW world's
    per-host virtual record sequence through the same cumulative-epoch-size
    accounting, so the resumed stream is still a pure function of
    ``(seed, batch_index, process_index, process_count)`` and a resized
    resume lands bit-identical to a clean same-world run from the same
    checkpoint. Seed, per-host batch size and the shard fingerprint are still
    hard-refused on mismatch (those change WHAT the indices mean, not who
    reads them); the accepted re-deal is logged and surfaced as
    ``self.redeal``, which the trainers ledger as a ``data_redeal`` event."""

    def __init__(
        self,
        source,
        *,
        batch_size: int,
        seed: int,
        workers: int = 2,
        start_batch: int = 0,
        queue_depth: Optional[int] = None,
        registry=None,
        resume_state: Optional[Dict] = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if workers < 1:
            raise ValueError(
                f"data service needs >= 1 worker, got {workers} "
                "(0 selects the legacy in-line stream at the trainer level)"
            )
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        if queue_depth is not None and queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {queue_depth} "
                "(capacity below 1 would livelock the reorder buffer)"
            )
        self.source = source
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.workers = int(workers)
        self.start_batch = int(start_batch)
        self._capacity = (
            int(queue_depth) if queue_depth else max(2, self.workers + 1)
        )
        self._registry = registry
        # set when an accepted resume crossed a world resize: the validated
        # re-deal's facts ({"old_process_count", "new_process_count",
        # "batch_index"})
        self.redeal: Optional[Dict] = None
        if resume_state is not None:
            restored = DataServiceState.from_json(resume_state)
            fingerprint = self._shard_fingerprint()
            mismatch = (
                restored.seed != self.seed
                or restored.batch_index != self.start_batch
                or (restored.batch_size
                    and restored.batch_size != self.batch_size)
                or (restored.shard_fingerprint and fingerprint
                    and restored.shard_fingerprint != fingerprint)
            )
            if mismatch:
                raise ValueError(
                    "data service resume state mismatch: checkpoint sidecar "
                    f"has (seed={restored.seed}, "
                    f"batch_index={restored.batch_index}, "
                    f"batch_size={restored.batch_size or '?'}, "
                    f"shards={restored.shard_fingerprint or '?'}) but "
                    f"this run wants (seed={self.seed}, "
                    f"batch_index={self.start_batch}, "
                    f"batch_size={self.batch_size}, "
                    f"shards={fingerprint or '?'}) — resuming would replay "
                    "or skip training data; restore with the original "
                    "seed/step/per-host batch size and shard set"
                )
            new_count = self._process_count()
            if (
                restored.process_count
                and new_count
                and restored.process_count != new_count
            ):
                # world resize: the per-epoch shard deal is a pure
                # function of (seed, epoch, process_index, process_count), so
                # the NEW world re-derives every plan from scratch — nothing
                # of the old deal survives to conflict. The epoch-boundary
                # math (cumulative epoch sizes -> (epoch, offset) of any
                # batch index) is re-priced under the new per-host epoch
                # sizes by the same _locate/_extend_cum accounting, keeping
                # the stream deterministic for every host of the new world.
                self.redeal = {
                    "old_process_count": int(restored.process_count),
                    "new_process_count": int(new_count),
                    "batch_index": int(self.start_batch),
                }
                import logging

                logging.getLogger(__name__).warning(
                    "data service resuming across a world resize: "
                    "process_count %d -> %d at batch_index %d — re-dealing "
                    "the per-epoch shard assignment (validated: seed, "
                    "per-host batch size and shard set unchanged)",
                    restored.process_count, new_count, self.start_batch,
                )
        # cumulative epoch sizes: _cum[e] = records before epoch e
        self._cum: List[int] = [0]
        self._cum_lock = threading.Lock()
        self._cond = threading.Condition()
        self._ready: Dict[int, Dict[str, np.ndarray]] = {}
        self._next_emit = self.start_batch
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._started = False

    # -- index-keyed plan math ---------------------------------------------

    def _extend_cum_locked(self, n_epochs: Optional[int], record_j: int) -> None:
        """Grow the cumulative-size cache to cover ``n_epochs`` epochs and/or
        virtual record ``record_j``. Caller holds ``_cum_lock``. The sizes
        are cached HERE so the hot path (every worker, every batch) never
        re-derives a shard assignment the cache already priced."""
        while (n_epochs is not None and len(self._cum) <= n_epochs) or (
            record_j >= self._cum[-1]
        ):
            e = len(self._cum) - 1
            size = self.source.epoch_size(self.seed, e)
            if size < 0:
                raise ValueError(f"negative epoch size {size}")
            # a host may own only empty shards for SOME epoch, but a
            # stream that never produces a record must raise, not spin
            if size == 0 and self._cum[-1] == 0 and e >= 64:
                raise ValueError(
                    "data service source reports zero records "
                    "(empty shards?)"
                )
            self._cum.append(self._cum[-1] + size)

    def _locate(self, record_j: int) -> Tuple[int, int]:
        """(epoch, offset_within_epoch) of virtual record ``record_j``."""
        import bisect

        with self._cum_lock:
            self._extend_cum_locked(None, record_j)
            e = bisect.bisect_right(self._cum, record_j) - 1
            return e, record_j - self._cum[e]

    def _epoch_size(self, epoch: int) -> int:
        with self._cum_lock:
            self._extend_cum_locked(epoch + 1, 0)
            return self._cum[epoch + 1] - self._cum[epoch]

    def _parts(self, batch_index: int) -> List[Tuple[int, np.ndarray]]:
        start = batch_index * self.batch_size
        need = self.batch_size
        parts: List[Tuple[int, np.ndarray]] = []
        epoch, offset = self._locate(start)
        while need > 0:
            size = self._epoch_size(epoch)
            if size <= 0:
                epoch += 1
                offset = 0
                continue
            take = min(need, size - offset)
            parts.append((epoch, np.arange(offset, offset + take)))
            need -= take
            epoch += 1
            offset = 0
        return parts

    def _process_count(self) -> int:
        """The source's world size, when it has one (record sources do; the
        in-memory array source is already host-local) — 0 means unknown."""
        return int(getattr(self.source, "process_count", 0) or 0)

    def _shard_fingerprint(self) -> str:
        """The source's shard-set digest ("" when it has none — in-memory
        sources)."""
        return str(getattr(self.source, "shard_fingerprint", "") or "")

    def state(self, batch_index: Optional[int] = None) -> DataServiceState:
        """Resume state for ``batch_index`` — what the trainers sidecar into
        checkpoints. ALWAYS pass the trainer's step counter when the stream
        feeds a prefetcher (the trainers do): the default snapshots the next
        batch the raw stream would yield, which behind ``device_prefetch`` /
        dispatch-ahead runs AHEAD of the last trained step — a sidecar
        written from it would skip data on resume."""
        if batch_index is None:
            with self._cond:
                batch_index = self._next_emit
        epoch, _ = self._locate(batch_index * self.batch_size)
        return DataServiceState(
            seed=self.seed,
            batch_index=int(batch_index),
            epoch=epoch,
            batch_size=self.batch_size,
            process_count=self._process_count(),
            shard_fingerprint=self._shard_fingerprint(),
        )

    # -- the stream --------------------------------------------------------

    def batches(
        self, steps: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        """The service's output stream: batches ``start_batch ..
        start_batch+steps`` in index order (infinite when ``steps`` is None).
        Starts the workers eagerly; the returned generator releases them on
        close/GC, so an abandoned consumer (preemption, a test reading one
        batch) never leaks threads — the same stop-aware contract as
        ``device_prefetch``."""
        if self._started:
            raise RuntimeError(
                "StreamingDataService.batches() is single-shot; build a new "
                "service for a new stream"
            )
        self._started = True
        end = None if steps is None else self.start_batch + int(steps)
        ready_hist = under_hist = busy_hist = None
        if self._registry is not None:
            from tensorflowdistributedlearning_tpu_torch.obs import telemetry as tm

            ready_hist = self._registry.histogram(tm.DATA_READY_HISTOGRAM)
            under_hist = self._registry.histogram(tm.DATA_UNDERRUN_HISTOGRAM)
            busy_hist = self._registry.histogram(tm.DATA_WORKER_BUSY_HISTOGRAM)
            self._registry.gauge(tm.DATA_WORKERS_GAUGE).set(self.workers)
        for w in range(self.workers):
            t = threading.Thread(
                target=self._worker,
                args=(w, end, busy_hist),
                daemon=True,
                name=f"data-service-{w}",
            )
            t.start()
            self._threads.append(t)
        gen = self._consume(end, ready_hist, under_hist)
        import weakref

        # a generator dropped before its first next() never reaches the
        # try/finally inside — the finalizer still releases the workers
        weakref.finalize(gen, self._stop.set)
        return gen

    def _worker(self, wid: int, end: Optional[int], busy_hist) -> None:
        try:
            i = self.start_batch + wid
            while (end is None or i < end) and not self._stop.is_set():
                parts = self._parts(i)
                t0 = time.perf_counter()
                batch = self.source.materialize(self.seed, parts)
                if busy_hist is not None:
                    busy_hist.record(time.perf_counter() - t0)
                with self._cond:
                    while (
                        i - self._next_emit >= self._capacity
                        and not self._stop.is_set()
                    ):
                        self._cond.wait(0.05)
                    if self._stop.is_set():
                        return
                    self._ready[i] = batch
                    self._cond.notify_all()
                i += self.workers
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            with self._cond:
                if self._error is None:
                    self._error = e
                self._cond.notify_all()

    def _consume(self, end, ready_hist, under_hist):
        try:
            i = self.start_batch
            while end is None or i < end:
                with self._cond:
                    if i not in self._ready:
                        if self._error is not None:
                            raise self._error
                        # the consumer arrived before the batch: an underrun
                        # (the first take, waiting for the workers to spin
                        # up, is startup)
                        if under_hist is not None and i > self.start_batch:
                            under_hist.record(1.0)
                        while i not in self._ready:
                            if self._error is not None:
                                raise self._error
                            if self._stop.is_set():
                                # closed under the consumer (run teardown):
                                # the awaited batch was discarded with the
                                # workers — end the stream instead of
                                # polling for it forever
                                return
                            self._cond.wait(0.1)
                    batch = self._ready.pop(i)
                    self._next_emit = i + 1
                    depth = len(self._ready)
                    self._cond.notify_all()
                if ready_hist is not None:
                    ready_hist.record(float(depth))
                yield batch
                i += 1
        finally:
            self.close()

    def close(self) -> None:
        """Stop the workers and drop buffered batches. Idempotent; called by
        the stream's own ``finally``/finalizer, and by the trainers on run
        teardown for promptness."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
