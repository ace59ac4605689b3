"""Deterministic fault injection (the port's copy of the JAX package's
``resilience/faults.py``): one spec string names what fails, where and when,
and the instrumented sites call :func:`fire`, a no-op when nothing is
installed.

Spec grammar (``--inject-fault``)::

    KIND@AT[xCOUNT]

    sigkill@30      SIGKILL this process after the 30th answered serve
                    request (serve/server.py fires SITE_REQUEST per
                    response): the replica vanishes without draining
    raise@12        raise InjectedFault after train step 12
    sigterm@12      SIGTERM this process after train step 12
    sigterm@5-20    the step drawn uniformly from [5, 20] by the seed
    io-data@3x2     transient IOError on the 3rd and 4th record batch
    io-read@2       transient IOError on the 2nd tracked file open
    io-ckpt@1       transient IOError on the 1st checkpoint save
    sigkill-step@6  SIGKILL this process after train step 6
    nan-loss@2      poison the 2nd observed loss with NaN (``poisoned()``)

Every kind parses, with the JAX package's seeded draws. The serve path
fires ``SITE_REQUEST``; the trainers' sites are queue A 14.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
import signal
import threading
from typing import Optional

# injection sites the codebase carries hooks at
SITE_STEP = "step"  # trainers, after each completed train step (index = step)
SITE_DATA = "data"  # data/records.py, per emitted record batch
SITE_IO = "io"  # tracked file opens (record shards, kaggle CSVs)
SITE_CHECKPOINT = "checkpoint"  # CheckpointManager, per save attempt
SITE_LOSS = "loss"  # obs/health.py, per observed loss window (poisoned())
SITE_REQUEST = "request"  # serve/server.py, per answered /v1/predict

_KIND_SITE = {
    "raise": SITE_STEP,
    "sigterm": SITE_STEP,
    "sigkill": SITE_REQUEST,
    "sigkill-step": SITE_STEP,
    "io-data": SITE_DATA,
    "io-read": SITE_IO,
    "io-ckpt": SITE_CHECKPOINT,
    "nan-loss": SITE_LOSS,
}

_SPEC_RE = re.compile(
    r"^(?P<kind>raise|sigterm|sigkill-step|sigkill|io-data|io-read|io-ckpt"
    r"|nan-loss)"
    r"@(?P<lo>\d+)(?:-(?P<hi>\d+))?"
    r"(?:x(?P<count>\d+))?$"
)


class InjectedFault(RuntimeError):
    """The non-transient injected failure (``raise@STEP``) — nothing retries
    it; it models a crash the supervisor must restart through."""


class TransientInjectedIOError(OSError):
    """Injected transient I/O failure — the retry decorator's exception set
    covers it, so the recovery path is the production one."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One resolved fault: ``kind`` (grammar above), ``at`` (step for step
    kinds; 1-based occurrence for io kinds), ``count`` fires."""

    kind: str
    at: int
    count: int = 1

    @property
    def site(self) -> str:
        return _KIND_SITE[self.kind]


def parse_fault_spec(spec: str, seed: int = 0) -> FaultSpec:
    """Parse ``KIND@AT[xCOUNT]``; an ``AT`` range ``LO-HI`` resolves to one
    seeded-uniform draw (inclusive), so "kill at a random step" is
    reproducible from the seed alone."""
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad fault spec {spec!r}; expected KIND@AT[xCOUNT] with KIND in "
            f"{sorted(_KIND_SITE)} (e.g. 'sigterm@12', 'io-data@3x2', "
            "'raise@5-20' for a seeded random step)"
        )
    lo = int(m.group("lo"))
    hi = int(m.group("hi")) if m.group("hi") else lo
    if hi < lo:
        raise ValueError(f"bad fault spec {spec!r}: range {lo}-{hi} is empty")
    at = lo if hi == lo else random.Random(seed).randint(lo, hi)
    count = int(m.group("count")) if m.group("count") else 1
    if count < 1:
        raise ValueError(f"bad fault spec {spec!r}: count must be >= 1")
    return FaultSpec(kind=m.group("kind"), at=at, count=count)


class FaultInjector:
    """Executes one ``FaultSpec`` against the ``fire()`` hook stream.

    Occurrence counters are per-site and per-process; a supervised restart
    starts a fresh process with fresh counters (which is the point: whether
    the fault re-fires after resume is decided by the *spec*, not by state
    smuggled across the restart)."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self._occurrences = 0
        self.fired = 0

    def poisoned(self, site: str, index: Optional[int] = None) -> bool:
        """Non-raising twin of ``fire`` for value-transforming sites: does an
        installed value fault (``nan-loss``) fire at this occurrence? The
        1-based occurrence window [at, at + count) matches the io kinds —
        ``index`` (the step) is informational; the AT in the spec counts
        *observations* (log windows), which stay meaningful whatever the
        window cadence is."""
        spec = self.spec
        if site != spec.site or spec.kind != "nan-loss":
            return False
        with self._lock:
            self._occurrences += 1
            if not spec.at <= self._occurrences < spec.at + spec.count:
                return False
            self.fired += 1
        return True

    def fire(self, site: str, index: Optional[int] = None) -> None:
        spec = self.spec
        if site != spec.site or spec.kind == "nan-loss":
            return
        with self._lock:
            if site == SITE_STEP:
                if index != spec.at or self.fired >= spec.count:
                    return
            else:
                # io sites: 1-based occurrence window [at, at + count)
                self._occurrences += 1
                if not spec.at <= self._occurrences < spec.at + spec.count:
                    return
            self.fired += 1
        if spec.kind == "raise":
            raise InjectedFault(f"injected fault: raise at step {spec.at}")
        if spec.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if spec.kind in ("sigkill", "sigkill-step"):
            # uncatchable by design: the replica/host-death drills must model
            # a process that VANISHES (OOM kill, node loss), not one that
            # drains
            os.kill(os.getpid(), signal.SIGKILL)
            return
        raise TransientInjectedIOError(
            f"injected transient I/O error ({spec.kind} occurrence "
            f"{self._occurrences})"
        )


_INJECTOR: Optional[FaultInjector] = None


def install(spec: Optional[str], seed: int = 0) -> Optional[FaultInjector]:
    """Install the process-global injector from a spec string (``None``/empty
    uninstalls). Returns the injector."""
    global _INJECTOR
    _INJECTOR = FaultInjector(parse_fault_spec(spec, seed)) if spec else None
    return _INJECTOR


def uninstall() -> None:
    global _INJECTOR
    _INJECTOR = None


def installed() -> Optional[FaultInjector]:
    return _INJECTOR


def fire(site: str, index: Optional[int] = None) -> None:
    """The hook the instrumented sites call; free when nothing is installed."""
    if _INJECTOR is not None:
        _INJECTOR.fire(site, index)


def poisoned(site: str, index: Optional[int] = None) -> bool:
    """Value-fault query (``nan-loss``): should the caller corrupt the value
    it is about to observe? Free when nothing is installed."""
    return _INJECTOR is not None and _INJECTOR.poisoned(site, index)
