"""Bounded retry with backoff for one-shot opens.

The port's own copy of ``sparknet_tpu/utils/retry.py`` (:28-87):
``backoff_delays``, ``retry_call`` and ``io_retry``.  The reference
inherits retry semantics from Spark (a failed task is rescheduled up to
``spark.task.maxFailures`` times; reference: CifarApp.scala:36 pins it to
1), but its one-shot opens (an LMDB mmap, a source list) have no such
cover, and a transient NFS blip kills the job.  The DB readers of
``data/lmdb_io.py`` and the feed's opens go through :func:`io_retry`.

Knobs (read per call):
  SPARKNET_IO_RETRIES   attempts for data-plane file and DB opens (3)
  SPARKNET_IO_BACKOFF   base delay in seconds (0.05)
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Iterable

from . import knobs


def backoff_delays(attempts: int, base: float) -> Iterable[float]:
    """The sleep schedule between ``attempts`` tries: base, 2·base,
    4·base, ... capped at 30 s (len == attempts - 1).  The JAX package's
    ``jitter`` serves only its multi-host restarts (ROADMAP A12), so the
    port has none."""
    for i in range(max(attempts - 1, 0)):
        yield min(base * 2.0 ** i, 30.0)


def retry_call(fn: Callable[..., Any], *args: Any,
               attempts: int = 3, base_delay: float = 0.1,
               retry_on: tuple[type[BaseException], ...] = (OSError,),
               sleep: Callable[[float], None] = time.sleep,
               describe: str | None = None, **kwargs: Any) -> Any:
    """Call ``fn(*args, **kwargs)``; on an exception in ``retry_on`` retry
    up to ``attempts`` total tries with exponential backoff.  The final
    failure re-raises the last exception unchanged (bounded budget — this
    is Spark's maxFailures contract, not an infinite supervisor)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delays = list(backoff_delays(attempts, base_delay))
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if i == attempts - 1:
                raise
            what = describe or getattr(fn, "__name__", "call")
            print(f"retry: {what} failed ({type(e).__name__}: {e}); "
                  f"attempt {i + 1}/{attempts}, backing off {delays[i]:.2g}s",
                  file=sys.stderr)
            sleep(delays[i])
    raise AssertionError("unreachable")  # pragma: no cover


def io_retry(fn: Callable[..., Any], *args: Any,
             describe: str | None = None, **kwargs: Any) -> Any:
    """``retry_call`` tuned from the SPARKNET_IO_* env knobs — the wrapper
    the data-plane opens (LMDB mmap, HDF5, source lists) go through."""
    attempts = int(knobs.raw("SPARKNET_IO_RETRIES", "3") or 3)
    base = float(knobs.raw("SPARKNET_IO_BACKOFF", "0.05") or 0.05)
    return retry_call(fn, *args, attempts=attempts, base_delay=base,
                      retry_on=(OSError,), describe=describe, **kwargs)
