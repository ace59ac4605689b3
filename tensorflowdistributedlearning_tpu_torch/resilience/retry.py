"""Retry with exponential backoff and jitter for transient I/O failures
(the port's copy of the JAX package's ``resilience/retry.py``).

The record reader and the data service retry their shard opens, range reads
and decodes on ``OSError`` through :func:`call_with_retry`, as the JAX
package does. Every retry is counted in an ``obs.metrics`` registry under
``retry/{name}``, so a clean run is observably clean (zero retries). The
fault sites of the JAX package (``resilience/faults.py``) arrive with
queue A 14.

Exhaustion raises ``RetryExhaustedError``: deliberately not an ``OSError``
(an outer retry must not re-retry an inner exhaustion) and not a
``RuntimeError``, with ``name``/``attempts``/``last`` attached and
``__cause__`` chained to the final failure.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from tensorflowdistributedlearning_tpu_torch.obs.metrics import MetricsRegistry

# the default sink for retry counters; tests and /metrics-style snapshots read
# it via ``retries()`` — per-call ``registry=`` overrides for scoped counting
RETRY_REGISTRY = MetricsRegistry()

# OSError subclasses that are deterministic, not transient: backing off on a
# missing file or a permission wall wastes the whole backoff schedule and then
# re-types the error — callers keep seeing the original FileNotFoundError etc.
NON_TRANSIENT = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
)


class RetryExhaustedError(Exception):
    """All attempts failed; ``__cause__`` is the last underlying exception."""

    def __init__(self, name: str, attempts: int, last: BaseException):
        super().__init__(
            f"{name}: failed after {attempts} attempt(s); last error: "
            f"{type(last).__name__}: {last}"
        )
        self.name = name
        self.attempts = attempts
        self.last = last


def retries(name: Optional[str] = None) -> int:
    """Total retries recorded in the default registry (optionally for one
    ``retry/{name}`` counter)."""
    snapshot = RETRY_REGISTRY.snapshot()["counters"]
    if name is not None:
        return snapshot.get(f"retry/{name}", 0)
    return sum(v for k, v in snapshot.items() if k.startswith("retry/"))


def reset_registry() -> None:
    """Fresh default registry (test isolation)."""
    global RETRY_REGISTRY
    RETRY_REGISTRY = MetricsRegistry()


def backoff_delay(
    attempt: int,
    *,
    base_delay_s: float,
    max_delay_s: float,
    jitter_frac: float,
    rng: random.Random,
) -> float:
    """The one exponential-backoff-with-symmetric-jitter formula (shared by
    the retry loop and, with queue A 14, the restart supervisor): doubles from ``base_delay_s``,
    caps at ``max_delay_s``, jitters +-``jitter_frac``."""
    delay = min(base_delay_s * 2 ** (attempt - 1), max_delay_s)
    return max(0.0, delay * (1.0 + jitter_frac * (2.0 * rng.random() - 1.0)))


def call_with_retry(
    fn: Callable,
    *,
    name: str,
    exceptions: Tuple[Type[BaseException], ...] = (OSError,),
    attempts: int = 3,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    jitter_frac: float = 0.25,
    seed: int = 0,
    registry: Optional[MetricsRegistry] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    give_up: Tuple[Type[BaseException], ...] = NON_TRANSIENT,
):
    """Call ``fn()`` retrying ``exceptions`` up to ``attempts`` total tries.

    Backoff doubles from ``base_delay_s`` (capped at ``max_delay_s``) with
    seeded symmetric jitter (+-``jitter_frac``) — deterministic for a given
    seed, so tests can pin schedules. ``on_retry(attempt, error)`` runs before
    each sleep. ``give_up``
    exceptions re-raise immediately and unwrapped even when ``exceptions``
    covers them — deterministic failures (missing file, permissions) must
    keep their type and cost no backoff."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    reg = registry if registry is not None else RETRY_REGISTRY
    rng = random.Random(seed)
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203 — retry loop
            if isinstance(e, give_up):
                raise
            if attempt == attempts:
                raise RetryExhaustedError(name, attempts, e) from e
            reg.counter(f"retry/{name}").inc()
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(
                backoff_delay(
                    attempt,
                    base_delay_s=base_delay_s,
                    max_delay_s=max_delay_s,
                    jitter_frac=jitter_frac,
                    rng=rng,
                )
            )
