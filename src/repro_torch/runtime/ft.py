"""Fault-tolerance primitives of the port: bounded retry and its budget.

The port's copy of the engine-facing part of ``repro.runtime.ft``:
``bounded_retry``, the retry primitive of the engine fallback chain
(``core.engine``), and ``FTConfig``, whose ``max_retries`` / ``backoff_s``
set its budget.  The checkpoint/restart driver and the straggler detector
belong to a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


def bounded_retry(fn: Callable[[], Any], max_retries: int, backoff_s: float,
                  retryable: Optional[Callable[[BaseException], bool]] = None):
    """Call ``fn()`` with bounded retry + exponential backoff.  Returns
    ``(result, retries_used)``.  ``retryable`` filters which exceptions are
    worth another attempt (default: any ``Exception``); a non-retryable
    failure — or exhausting the budget — re-raises the last error."""
    attempt = 0
    while True:
        try:
            return fn(), attempt
        except Exception as exc:
            if retryable is not None and not retryable(exc):
                raise
            attempt += 1
            if attempt > max_retries:
                raise
            time.sleep(backoff_s * (2 ** (attempt - 1)))


@dataclasses.dataclass
class FTConfig:
    """The budget of ``bounded_retry`` in the fallback chain, with the
    reference's defaults.  The reference's checkpoint and straggler fields
    come with the slices that read them."""
    max_retries: int = 3
    backoff_s: float = 0.05
