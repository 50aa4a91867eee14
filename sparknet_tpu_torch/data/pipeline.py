"""The pieces of the feed pipeline that the device feed runs on.

The port's own copy of the part of ``sparknet_tpu/data/pipeline.py`` that
``data/prefetch.py::DeviceFeed`` needs:

- :func:`feed_workers` (:69) and :func:`feed_depth` (:80), the
  ``SPARKNET_FEED_WORKERS`` and ``SPARKNET_FEED_DEPTH`` knobs (a width of
  0 takes one thread);
- :class:`FeedStats` (:88), per-stage wall-time accounting, without the
  JAX package's telemetry hooks (the port has no telemetry yet);
- :class:`DecodePool` (:198), the order-preserving thread pool, with
  threads only (the JAX package's ``workers=0`` serial path is not
  ported);
- :class:`BufferRing` (:395), preallocated rotating buffers, as torch
  tensors, pinned when the feed's target is a CUDA device, the whole
  rotation allocated at once.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Iterator

import torch

from ..utils import knobs


def _env_int(name: str, default: int) -> int:
    raw = knobs.raw(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}") from None


def feed_workers() -> int:
    """Decode-pool width: ``SPARKNET_FEED_WORKERS``, else the CPU count
    capped at 8.  The port's pool has threads only; 0, the JAX package's
    serial path, takes one thread, which gives the same ordered stream."""
    n = _env_int("SPARKNET_FEED_WORKERS", min(os.cpu_count() or 1, 8))
    if n < 0:
        raise ValueError(f"SPARKNET_FEED_WORKERS must be >= 0, got {n}")
    return max(n, 1)


def feed_depth(default: int = 4) -> int:
    """Prefetch depth: ``SPARKNET_FEED_DEPTH``, else ``default``."""
    n = _env_int("SPARKNET_FEED_DEPTH", default)
    if n < 1:
        raise ValueError(f"SPARKNET_FEED_DEPTH must be >= 1, got {n}")
    return n


def feed_putters(default: int = 2) -> int:
    """Host-to-device copy threads: ``SPARKNET_FEED_PUTTERS``, else
    ``default``, at least 1."""
    return max(1, _env_int("SPARKNET_FEED_PUTTERS", default))


class FeedStats:
    """Thread-safe per-stage time and count accounting for one feed.

    Stage seconds are summed over whichever threads ran the stage, so
    with several putters ``device_put_s`` is thread-seconds.
    ``snapshot()`` returns totals, ``per_batch()`` divides by delivered
    batches."""

    STAGES = ("read", "decode", "transform", "device_put")

    def __init__(self):
        self._lock = threading.Lock()
        self._s = {k: 0.0 for k in self.STAGES}
        self.batches = 0
        self.records = 0

    def note(self, stage: str, seconds: float, records: int = 0) -> None:
        with self._lock:
            self._s[stage] = self._s.get(stage, 0.0) + seconds
            self.records += records

    def count_batch(self, records: int = 0) -> None:
        with self._lock:
            self.batches += 1
            self.records += records

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            out: dict[str, Any] = {f"{k}_s": round(v, 6)
                                   for k, v in self._s.items()}
            out.update(batches=self.batches, records=self.records)
            return out

    def per_batch(self) -> dict[str, float]:
        """Mean stage seconds per delivered batch (0.0 before the
        first)."""
        with self._lock:
            n = max(self.batches, 1)
            return {f"{k}_s": round(v / n, 6) for k, v in self._s.items()}


class DecodeWorkerError(RuntimeError):
    """A pool thread died without producing its result (thread death,
    not an exception of the work function: those surface as themselves
    at their item's position)."""

    def __init__(self, name: str, ticket: int, detail: str = ""):
        self.pool = name
        self.ticket = ticket
        suffix = f": {detail}" if detail else ""
        super().__init__(
            f"{name} pipeline worker died before producing item "
            f"#{ticket}{suffix}")


_STOP = object()


class DecodePool:
    """Order-preserving parallel map with a bounded in-flight window.

    Items are submitted and consumed serially, in the same order; only
    ``fn`` runs on the pool's threads.  An exception raised by ``fn`` is
    re-raised from ``result()`` at its item's position; a pool whose
    threads all died raises :class:`DecodeWorkerError` from ``result()``
    within about two polls, never a hang."""

    _POLL_S = 0.1

    def __init__(self, fn: Callable[[Any], Any], workers: int,
                 window: int | None = None, name: str = "decode",
                 stats: FeedStats | None = None, stage: str = "decode"):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.fn = fn
        self.name = name
        self.workers = int(workers)
        self._window = int(window) if window else max(2, 2 * self.workers)
        self._stats = stats
        self._stage = stage
        self._closed = False
        self._next_submit = 0
        self._next_consume = 0
        self._in: "queue.Queue[Any]" = queue.Queue()
        self._cond = threading.Condition()
        self._results: dict[int, tuple[bool, Any]] = {}
        self._pump: threading.Thread | None = None
        self._threads = [
            threading.Thread(target=self._run, name=f"{name}-{i}",
                             daemon=True)
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # -- worker side ------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._in.get()
            if item is _STOP:
                return
            ticket, payload = item
            t0 = time.perf_counter()
            try:
                value, ok = self.fn(payload), True
            except BaseException as e:  # re-raised at the item's ordinal
                value, ok = e, False
            if self._stats is not None:
                self._stats.note(self._stage, time.perf_counter() - t0)
            with self._cond:
                self._results[ticket] = (ok, value)
                self._cond.notify_all()

    # -- consumer side ----------------------------------------------------
    def submit(self, item: Any) -> int:
        """Enqueue one work item; blocks while the in-flight window is
        full.  Returns the item's ticket."""
        if self._closed:
            raise RuntimeError(f"{self.name} pool is closed")
        ticket = self._next_submit
        self._next_submit += 1
        with self._cond:
            while (self._next_submit - self._next_consume > self._window
                   and not self._closed):
                self._check_workers(ticket)
                self._cond.wait(self._POLL_S)
        self._in.put((ticket, item))
        return ticket

    def _check_workers(self, ticket: int) -> None:
        if not any(t.is_alive() for t in self._threads):
            raise DecodeWorkerError(
                self.name, ticket, "no live workers left in the pool")

    def result(self) -> Any:
        """The next result in submission order; re-raises the work
        function's exception for that item, or DecodeWorkerError if the
        pool died under it."""
        if self._next_consume >= self._next_submit:
            raise RuntimeError(
                f"{self.name} pool: result() with nothing in flight")
        ticket = self._next_consume
        with self._cond:
            while ticket not in self._results:
                self._check_workers(ticket)
                self._cond.wait(self._POLL_S)
            ok, value = self._results.pop(ticket)
            self._next_consume += 1
            self._cond.notify_all()
        if ok:
            return value
        raise value

    def imap(self, it) -> Iterator[Any]:
        """Order-preserving parallel map over an iterator.  A pump thread
        advances the source and submits under the window's backpressure;
        results come out in source order.  An exception raised by the
        source is re-raised after every item submitted before it has been
        yielded."""
        src_err: list[BaseException] = []
        src_done = threading.Event()

        def pump() -> None:
            try:
                for item in it:
                    if self._closed:
                        return
                    self.submit(item)
            except BaseException as e:
                src_err.append(e)
            finally:
                src_done.set()
                with self._cond:
                    self._cond.notify_all()

        self._pump = threading.Thread(target=pump, name=f"{self.name}-pump",
                                      daemon=True)
        self._pump.start()
        while True:
            with self._cond:
                while (self._next_consume >= self._next_submit
                       and not src_done.is_set()):
                    self._cond.wait(self._POLL_S)
            if self._next_consume < self._next_submit:
                yield self.result()
                continue
            if src_err:
                raise src_err[0]
            return

    def threads(self) -> list[threading.Thread]:
        """The pool's threads, its pump's included once ``imap`` runs."""
        return self._threads + ([self._pump] if self._pump else [])

    def close(self) -> None:
        """Stop the threads and drop queued work; in-flight results are
        discarded.  The pump exits once its source stops (close the
        source first).  Safe to call more than once."""
        self._closed = True
        while True:  # drop queued, unstarted work
            try:
                self._in.get_nowait()
            except queue.Empty:
                break
        for _ in self._threads:
            self._in.put(_STOP)
        with self._cond:
            self._cond.notify_all()
        for t in self.threads():
            t.join(timeout=5.0)

    def __enter__(self) -> "DecodePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def ring_size(depth: int, window: int) -> int:
    """The :class:`BufferRing` size for a feed that keeps ``depth`` host
    batches and a put window of ``window`` batches in flight: every stage
    that can hold a batch at once, plus the consumer's working batch,
    plus one in the middle of its copy."""
    return depth + window + 2


class BufferRing:
    """A rotation of ``size`` preallocated host buffers, one per
    ``take()``: pinned (page-locked) when ``pin`` is set, so a copy from
    one to a CUDA device can run asynchronously.  The whole rotation is
    allocated at the first take of a shape and kept: pinning a buffer
    costs more than the copy it speeds up, and page-locking a buffer
    stalls the kernel launches of a round running meanwhile.

    Aliasing contract (the caller's to uphold): buffer k is handed out
    again after ``size`` further takes, so every stage that holds
    buffers at once must together hold fewer than ``size``
    (:func:`ring_size`).  Thread-safe: concurrent takes get distinct
    buffers."""

    def __init__(self, size: int, pin: bool = False):
        if size < 2:
            raise ValueError(f"BufferRing needs size >= 2, got {size}")
        self.size = size
        self.pin = pin
        self._bufs: list[torch.Tensor] = []
        self._i = 0
        self._shape: tuple | None = None
        self._dtype: torch.dtype | None = None
        self._lock = threading.Lock()

    def take(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """The next buffer in rotation (contents undefined).  A shape or
        dtype change drops the old rotation and allocates a new one."""
        shape = tuple(shape)
        with self._lock:
            if self._shape != shape or self._dtype != dtype:
                self._bufs = []   # the old rotation goes before the new
                self._bufs = [torch.empty(shape, dtype=dtype,
                                          pin_memory=self.pin)
                              for _ in range(self.size)]
                self._shape, self._dtype = shape, dtype
                self._i = 0
            buf = self._bufs[self._i % self.size]
            self._i += 1
            return buf

    @property
    def buffers(self) -> list[torch.Tensor]:
        with self._lock:
            return list(self._bufs)

    @property
    def nbytes(self) -> int:
        """Host bytes the ring holds now."""
        return sum(b.numel() * b.element_size() for b in self.buffers)
