"""JSONL run ledger (the port's copy of the JAX package's ``obs/ledger.py``,
same file names, event schema and failure stance).

``{workdir}/telemetry.jsonl`` is append-only, one JSON object per line, each
carrying ``event`` (the kind) and ``t`` (``time.time()``). A run writes a
``run_header`` first, then its events, and a ``run_end``; readers anchor on
the LAST ``run_header`` (:func:`last_run_events`), so the port's
``telemetry-report`` (``obs/report.py``) and the JAX package's read a port
workdir alike (``docs/LEDGER_SCHEMA.md``).

Telemetry never takes the producer down: an unwritable workdir degrades to
one logged warning and every later ``event()`` is a no-op.

Exit hooks: the first ledger a process opens registers an ``atexit`` flush
and a SIGTERM flusher. The flusher chains: it flushes every open ledger,
then hands the signal to the handler that was installed before it (the
default action re-raises, so the exit code stays 128 + SIGTERM). A handler
installed after it (the serve tier's drain, ``serve/server.py``) calls
:func:`flush_all_ledgers` itself and the handler the flusher replaced
(:func:`chained_sigterm`), never the flusher's re-raise.
"""

from __future__ import annotations

import atexit
import glob
import io
import json
import logging
import os
import re
import signal as signal_lib
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

LEDGER_FILENAME = "telemetry.jsonl"
SCHEMA_VERSION = 1

_LIVE_LEDGERS: "weakref.WeakSet[RunLedger]" = weakref.WeakSet()
_EXIT_HOOKS_INSTALLED = False
# the SIGTERM handler the flusher found installed, called after the flush
_CHAINED_SIGTERM = None


def flush_all_ledgers(blocking: bool = True) -> None:
    """Flush every open ledger's buffered lines. ``blocking=False`` is the
    signal-handler mode: the handler runs on the main thread, which may hold
    a ledger's write lock mid-line, so each lock wait is bounded."""
    try:
        ledgers = list(_LIVE_LEDGERS)
    except Exception:  # noqa: BLE001 — teardown-order hazards
        return
    for ledger in ledgers:
        try:
            ledger.flush(blocking=blocking)
        except Exception:  # noqa: BLE001
            pass


def sigterm_flush(signum, frame) -> None:
    """The ledger's SIGTERM handler: flush, then the handler it replaced (the
    default action: restore it and re-raise)."""
    flush_all_ledgers(blocking=False)
    prev = _CHAINED_SIGTERM
    if callable(prev):
        prev(signum, frame)
        return
    if prev == signal_lib.SIG_IGN:
        return
    signal_lib.signal(signum, signal_lib.SIG_DFL)
    os.kill(os.getpid(), signum)


def chained_sigterm():
    """The SIGTERM handler :func:`sigterm_flush` replaced (None before the
    first ledger opened): a handler installed after the flusher that skips
    the flusher still owes this one its call."""
    return _CHAINED_SIGTERM


def _install_exit_hooks() -> None:
    """Once per process, at the first ledger open: an ``atexit`` flush and,
    on the main thread, :func:`sigterm_flush` in front of whatever SIGTERM
    handler is installed."""
    global _EXIT_HOOKS_INSTALLED, _CHAINED_SIGTERM
    if _EXIT_HOOKS_INSTALLED:
        return
    _EXIT_HOOKS_INSTALLED = True
    atexit.register(flush_all_ledgers)
    try:
        if threading.current_thread() is threading.main_thread():
            current = signal_lib.getsignal(signal_lib.SIGTERM)
            if current is not sigterm_flush:
                _CHAINED_SIGTERM = current
                signal_lib.signal(signal_lib.SIGTERM, sigterm_flush)
    except (ValueError, OSError, RuntimeError):
        pass  # an exotic embedding: atexit still covers clean exits


def per_process_filename(process_index: int) -> str:
    """Process (or serve replica) 0 writes ``telemetry.jsonl``; every other
    index ``telemetry-{index}.jsonl`` beside it."""
    if process_index == 0:
        return LEDGER_FILENAME
    return f"telemetry-{int(process_index)}.jsonl"


_LEDGER_FILE = re.compile(r"^telemetry(?:-(\d+))?\.jsonl$")


def ledger_paths(workdir: str) -> List[str]:
    """Every per-process ledger in ``workdir``, ordered by process index."""
    found = []
    for path in glob.glob(os.path.join(workdir, "telemetry*.jsonl")):
        m = _LEDGER_FILE.match(os.path.basename(path))
        if m:
            found.append((int(m.group(1) or 0), path))
    return [p for _, p in sorted(found)]


class RunLedger:
    """Append-only JSONL event writer rooted at a workdir."""

    def __init__(self, workdir: str, *, filename: str = LEDGER_FILENAME):
        self.path = os.path.join(workdir, filename)
        self._f: Optional[io.TextIOBase] = None
        # handler threads, the batcher worker and the window ticker all
        # write here: line writes are serialised
        self._lock = threading.Lock()
        try:
            os.makedirs(workdir, exist_ok=True)
            self._f = open(self.path, "a", encoding="utf-8")
            _LIVE_LEDGERS.add(self)
            _install_exit_hooks()
        except OSError as e:
            logger.warning("telemetry ledger disabled: cannot open %s (%s)", self.path, e)

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def event(self, kind: str, /, **fields) -> None:
        """Append one event and flush it; a write failure disables the
        ledger with one warning (never raises)."""
        self._write(kind, fields, flush=True)

    def event_buffered(self, kind: str, /, **fields) -> None:
        """Append one event without a flush (high-rate ``trace`` spans); the
        line reaches disk at the next flushed event, ``flush()``, ``close()``
        or an exit hook."""
        self._write(kind, fields, flush=False)

    def _write(self, kind: str, fields: Dict, flush: bool) -> None:
        if self._f is None:
            return
        record = {"event": kind, "t": time.time(), **fields}
        line = json.dumps(record, default=_jsonable) + "\n"
        try:
            with self._lock:
                if self._f is None:
                    return
                self._f.write(line)
                if flush:
                    self._f.flush()
        except (OSError, ValueError) as e:  # ValueError: write to a closed file
            logger.warning("telemetry ledger disabled mid-run: write to %s failed (%s)", self.path, e)
            self._f = None

    # how long a signal-handler flush waits for the write lock
    _SIGNAL_FLUSH_TIMEOUT_S = 0.25

    def flush(self, blocking: bool = True) -> None:
        """Push buffered events to disk; ``blocking=False`` bounds the lock
        wait (the signal-handler path)."""
        if blocking:
            self._lock.acquire()
        elif not self._lock.acquire(timeout=self._SIGNAL_FLUSH_TIMEOUT_S):
            return
        try:
            if self._f is not None:
                try:
                    self._f.flush()
                except OSError:
                    pass
        finally:
            self._lock.release()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
        _LIVE_LEDGERS.discard(self)


def _jsonable(obj):
    """Best-effort JSON coercion of numpy and torch scalars/arrays."""
    for attr in ("item", "tolist"):
        fn = getattr(obj, attr, None)
        if fn is not None:
            try:
                return fn()
            except Exception:  # noqa: BLE001
                pass
    return str(obj)


def read_ledger(path: str) -> List[Dict]:
    """Parse a ledger (the jsonl file or its workdir) into event dicts; a
    torn final line is dropped."""
    return read_ledger_with_errors(path)[0]


def read_ledger_with_errors(path: str) -> Tuple[List[Dict], int]:
    """``read_ledger`` plus the count of undecodable lines skipped."""
    if os.path.isdir(path):
        path = os.path.join(path, LEDGER_FILENAME)
    events: List[Dict] = []
    errors = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                errors += 1
                continue
            if isinstance(record, dict):
                events.append(record)
            else:
                errors += 1
    return events, errors


def last_run_events(events: List[Dict]) -> List[Dict]:
    """The final ``run_header`` and everything after it (the whole list when
    there is no header)."""
    for i in range(len(events) - 1, -1, -1):
        if events[i].get("event") == "run_header":
            return events[i:]
    return events
