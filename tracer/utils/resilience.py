"""Transient-failure resilience for long renders.

The reference binary has no failure handling at all (a CUDA fault kills
the run, src/main.cu). Some failures of a distributed run are TRANSIENT
— a lost worker, a dropped connection, a briefly unavailable backend —
and long animations should ride through them. This module provides the
retry half of the §5 'failure detection' subsystem (checkpoint/resume
for fits lives in tracer.opt.fit).

Only errors that look transient are retried: JAX runtime errors whose
message carries UNAVAILABLE / DEADLINE_EXCEEDED / 'worker process
crashed' / connection markers. Programming errors (shape mismatches,
tracer leaks, compile failures) re-raise immediately.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")

TRANSIENT_MARKERS = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "worker process crashed",
    "Connection reset",
    "Connection refused",
    "Socket closed",
    "ABORTED",
)


def is_transient(err: BaseException) -> bool:
    """Heuristic: does this exception look like a recoverable backend
    failure rather than a programming error?"""
    msg = str(err)
    return any(m in msg for m in TRANSIENT_MARKERS)


def retry_transient(
    fn: Callable[[], T],
    retries: int = 3,
    backoff_s: float = 5.0,
    backoff_factor: float = 2.0,
    on_retry: Callable[[int, BaseException], None] | None = None,
) -> T:
    """Run fn(), retrying up to `retries` times on transient backend
    errors with exponential backoff. Non-transient errors and the final
    failure propagate unchanged."""
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as err:  # noqa: BLE001 - filtered by is_transient
            if attempt >= retries or not is_transient(err):
                raise
            if on_retry is not None:
                on_retry(attempt + 1, err)
            time.sleep(delay)
            delay *= backoff_factor
    raise AssertionError("unreachable")
