"""Background prefetch and asynchronous host-to-device copies, with a
feeder watchdog.

The port's own copy of ``sparknet_tpu/data/prefetch.py``:
:class:`FeedStalled` (:42), :class:`PrefetchIterator` (:49-255),
:class:`DeviceFeed` (:257-340) and :func:`device_feed` (:343), in PyTorch
idiom.  The reference's JavaData feed is synchronous: every minibatch
blocks the solver on a callback, a host float copy and a lazy transfer
(reference: caffe/src/caffe/layers/java_data_layer.cpp:36-44).  Here a
thread builds the host batches ahead of time and a second tier copies
them to the device, so the host's work and the copies overlap the
device's steps.

Watchdog: the consumer never blocks without bound.  Every wait is a short
poll that checks the feeder thread (its death and, with
``stall_timeout``, a hang); a failed feeder is restarted once on the same
source iterator (nothing is lost: the hook that models a failure fires
before a pull), and a feed still dead after that raises
:class:`FeedStalled`.  The JAX package's fault injector and health-plane
heartbeat are not ported; :meth:`PrefetchIterator._before_pull` is where
the injector fires there, and a test overrides it here.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Iterator, Mapping

import numpy as np
import torch

from .pipeline import BufferRing, DecodePool, feed_depth, feed_putters, \
    ring_size


class FeedStalled(RuntimeError):
    """The prefetch feeder stopped producing (thread death or a stall past
    the timeout) and the one restart did not bring it back."""


class PrefetchIterator:
    """Wraps an iterator; a background thread keeps ``depth`` items
    ready.

    ``close()`` stops the producer and drops staged items; an endless
    source (``RoundFeed.rounds()``) needs it, or the producer stays
    blocked on the full queue.  Usable as a context manager.

    - ``stall_timeout``: seconds the consumer waits for an item before
      it declares the feeder hung (None: no deadline; a dead feeder is
      still found by the liveness poll).
    - ``restarts``: how many times a dead or hung feeder is restarted
      before :class:`FeedStalled` (default 1).  A restarted feeder takes
      over the same source under a lock, and a superseded one never
      touches the source again.
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator[Any], depth: int = 2,
                 stall_timeout: float | None = None, restarts: int = 1):
        self._source = iter(it)
        self._q: queue.Queue[Any] = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._done = False
        # _gen_lock guards the generation counter and every pull from the
        # source: only the current generation's feeder advances it, so an
        # abandoned (hung) feeder that wakes late exits without a pull
        self._gen_lock = threading.Lock()
        self._generation = 0
        self._restarts_left = int(restarts)
        self._produced = 0    # items pulled from the source
        self._delivered = 0   # items handed to the consumer
        self._stall_timeout = stall_timeout
        self._threads: list[threading.Thread] = []
        self._spawn()

    def _before_pull(self, produced: int) -> tuple[str, float] | None:
        """A failure to model before the ``produced``-th pull, or None:
        ``("die", 0)`` ends the feeder thread silently, ``("hang", s)``
        stalls it ``s`` seconds.  The fault injector decides
        (``SPARKNET_FAULT=feeder_die@round:N`` / ``feeder_hang:<s>@round:N``,
        N the pull); ``slow_feed:<s>`` sleeps before every pull."""
        from ..utils import faults
        injector = faults.get_injector()
        delay = injector.feed_delay()
        if delay:
            time.sleep(delay)
        return injector.feeder_event(produced)

    # -- feeder side ------------------------------------------------------
    def _current(self, gen: int) -> bool:
        return not self._stop.is_set() and gen == self._generation

    def _spawn(self) -> None:
        t = threading.Thread(target=self._run, args=(self._generation,),
                             name="prefetch", daemon=True)
        self._thread = t
        self._threads.append(t)
        t.start()

    def _put(self, item: Any, gen: int) -> bool:
        while self._current(gen):
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, gen: int) -> None:
        try:
            while self._current(gen):
                ev = self._before_pull(self._produced)
                if ev is not None:
                    kind, seconds = ev
                    if kind == "die":
                        return      # silent thread death: no sentinel
                    time.sleep(seconds)
                    continue
                with self._gen_lock:
                    if not self._current(gen):
                        return
                    try:
                        item = next(self._source)
                        self._produced += 1
                    except StopIteration:
                        item = self._SENTINEL
                if item is self._SENTINEL:
                    self._put(item, gen)
                    return
                if not self._put(item, gen):
                    return
        except BaseException as e:  # surfaced on next()
            self._err = e
            self._put(self._SENTINEL, gen)

    # -- watchdog ---------------------------------------------------------
    def _revive(self, reason: str) -> None:
        """Restart the feeder, or raise FeedStalled once the budget is
        spent.  The generation bump retires the old feeder either way."""
        with self._gen_lock:
            self._generation += 1
            spent = self._restarts_left <= 0
            if not spent:
                self._restarts_left -= 1
        if spent:
            self._done = True
            self._err = FeedStalled(
                f"prefetch feed stalled after {self._delivered} delivered "
                f"batches: {reason} (restart budget spent)")
            raise self._err
        print(f"prefetch: {reason}; restarting feeder "
              f"({self._restarts_left} restarts left)",
              file=sys.stderr, flush=True)
        self._spawn()

    # -- consumer side ----------------------------------------------------
    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self) -> Any:
        if self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        deadline = (time.monotonic() + self._stall_timeout
                    if self._stall_timeout is not None else None)
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                if not self._thread.is_alive() and self._q.empty():
                    if self._err is not None:
                        # the feeder failed but its sentinel was lost
                        self._done = True
                        raise self._err
                    self._revive("feeder thread died without finishing "
                                 "its source")
                    deadline = (time.monotonic() + self._stall_timeout
                                if self._stall_timeout is not None else None)
                elif deadline is not None and time.monotonic() > deadline:
                    self._revive(f"no batch within the "
                                 f"{self._stall_timeout:g}s stall timeout")
                    deadline = time.monotonic() + self._stall_timeout
                continue
            if item is self._SENTINEL:
                self._done = True
                if self._err is not None:
                    raise self._err
                raise StopIteration
            self._delivered += 1
            return item

    def threads(self) -> list[threading.Thread]:
        """Every feeder thread this iterator started."""
        return list(self._threads)

    def close(self) -> None:
        """Stop the producer (every generation of it) and drop staged
        items."""
        self._stop.set()
        self._done = True
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class DeviceFeed:
    """Double-buffered host-to-device feed: a :class:`PrefetchIterator`
    keeps ``depth`` host batches ready, and ``putters`` threads copy up to
    ``putters + 1`` batches to ``device`` ahead of the consumer, so the
    host's batch building, the copies and the consumer's steps overlap.
    Device memory for staged batches stays bounded by that window,
    whatever the host depth.

    Each put copies every array of the batch into a buffer of a
    :class:`BufferRing` (one ring per key, sized by :func:`ring_size`),
    then to the device.  On a CUDA device the ring is pinned, the copy is
    asynchronous (``non_blocking``) on a side stream that the feed owns,
    and the putter waits for it before it hands the batch on, as the JAX
    package's ``jax.block_until_ready`` does: a yielded batch is resident,
    the pinned buffer is free to take again, and ``FeedStats``'
    ``device_put_s`` is the real transfer.  The consumer's stream then
    reads the batch with no wait, and ``__next__`` records that stream on
    each tensor, so the caching allocator never gives its memory back to
    the side stream while the consumer's work may still read it.  On the
    CPU it is the same pipeline without pinning or streams.

    ``device_cast`` maps keys to a device dtype: the host array ships in
    its own dtype (uint8 pixels are a quarter of f32's bytes) and one cast
    runs on the device after the copy.

    Items come in order; a source error surfaces after the items staged
    before it; the watchdog (``stall_timeout``, ``restarts``) runs in the
    prefetch tier.  ``close()`` (or the context manager) stops both
    tiers and joins their threads."""

    def __init__(self, batches: Iterator[Mapping[str, Any]],
                 device: str | torch.device, depth: int | None = None,
                 stall_timeout: float | None = None, restarts: int = 1,
                 putters: int | None = None,
                 device_cast: Mapping[str, torch.dtype] | None = None,
                 stats: Any | None = None):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if cuda and not torch.cuda.is_available():
            raise RuntimeError("DeviceFeed: CUDA is not available")
        depth = feed_depth() if depth is None else int(depth)
        putters = feed_putters() if putters is None else int(putters)
        self.stats = stats
        self._cast = dict(device_cast) if device_cast else {}
        self._ring_size = ring_size(depth, putters + 1)
        self.rings: dict[str, BufferRing] = {}
        self._rings_lock = threading.Lock()
        self.stream = (torch.cuda.Stream(device=self.device) if cuda
                       else None)
        self._pf = PrefetchIterator(batches, depth=depth,
                                    stall_timeout=stall_timeout,
                                    restarts=restarts)
        self._pool = DecodePool(self._put, workers=putters,
                                window=putters + 1, name="device_put",
                                stats=stats, stage="device_put")
        self._it = self._pool.imap(self._pf)

    def _ring(self, key: str) -> BufferRing:
        with self._rings_lock:
            if key not in self.rings:
                self.rings[key] = BufferRing(self._ring_size,
                                             pin=self.stream is not None)
            return self.rings[key]

    def _stage(self, key: str, v) -> torch.Tensor:
        src = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v)
        buf = self._ring(key).take(src.shape, src.dtype)
        buf.copy_(src)
        # on the CPU the "device copy" is a copy too: a yielded batch
        # never aliases a ring buffer
        out = (buf.to(self.device, non_blocking=True)
               if self.stream is not None else buf.clone())
        want = self._cast.get(key)
        if want is not None and out.dtype != want:
            out = out.to(want)   # one device op, after the copy
        return out

    def _put(self, batch: Mapping[str, Any]) -> dict[str, torch.Tensor]:
        if self.stream is None:
            return {k: self._stage(k, v) for k, v in batch.items()}
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = {k: self._stage(k, v) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return out

    @property
    def pinned_bytes(self) -> int:
        """Host bytes of the pinned staging rings (0 on the CPU)."""
        with self._rings_lock:
            rings = list(self.rings.values())
        return sum(r.nbytes for r in rings if r.pin)

    def threads(self) -> list[threading.Thread]:
        return self._pf.threads() + self._pool.threads()

    def __iter__(self) -> "DeviceFeed":
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        batch = next(self._it)
        if self.stream is not None:
            consumer = torch.cuda.current_stream(self.device)
            for t in batch.values():
                t.record_stream(consumer)
        if self.stats is not None:
            self.stats.count_batch()
        return batch

    def close(self) -> None:
        """Stop the prefetch feeder and the put pool, dropping staged
        batches."""
        self._pf.close()
        self._pool.close()

    def __enter__(self) -> "DeviceFeed":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def device_feed(batches: Iterator[Mapping[str, Any]],
                device: str | torch.device, depth: int | None = None,
                stall_timeout: float | None = None, restarts: int = 1,
                putters: int | None = None,
                device_cast: Mapping[str, torch.dtype] | None = None,
                stats: Any | None = None) -> DeviceFeed:
    """Prefetch host batches and copy them to ``device`` ahead of the
    consumer (see :class:`DeviceFeed`).  ``depth`` defaults to
    ``SPARKNET_FEED_DEPTH`` (4), ``putters`` to ``SPARKNET_FEED_PUTTERS``
    (2)."""
    return DeviceFeed(batches, device, depth=depth,
                      stall_timeout=stall_timeout, restarts=restarts,
                      putters=putters, device_cast=device_cast, stats=stats)
