"""The port's training feed (``data/pipeline.py``, ``data/prefetch.py``)
on the CPU, against the JAX package's.

- The same source through the port's ``device_feed(device="cpu")`` and
  the JAX package's ``device_feed`` gives the same batches, byte for byte
  and in order; ``device_cast`` casts after the copy in both.
- ``FeedStats`` counts, the ``SPARKNET_FEED_DEPTH`` and
  ``SPARKNET_FEED_PUTTERS`` knobs, a source error surfacing after the
  staged items, and ``close()`` joining every thread.
- The watchdog (the semantics of tests/test_integrity.py:475-500): a
  dead feeder is restarted once with no item lost, a hung one within the
  stall timeout, and a second death raises ``FeedStalled``.  The JAX
  package models the failures with its fault injector; the port's hook
  is ``PrefetchIterator._before_pull``, overridden here.
- The staging ring: its rotation and its size (``ring_size``), pure
  Python.  Pinning and the side stream are checked on the card
  (tests/test_torch_cuda_feed.py, ``chip_smoke.py``).
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.data import FeedStats as JaxFeedStats
from sparknet_tpu.data import device_feed as jax_device_feed
from sparknet_tpu_torch.data.pipeline import (BufferRing, DecodePool,
                                              DecodeWorkerError, FeedStats,
                                              feed_depth, ring_size)
from sparknet_tpu_torch.data.prefetch import (DeviceFeed, FeedStalled,
                                              PrefetchIterator, device_feed)


def _source(n: int, seed: int = 0):
    """Round-shaped batches of mixed dtypes, made with numpy."""
    rng = np.random.default_rng(seed)
    return [{"data": rng.normal(size=(2, 4, 3, 5, 5)).astype(np.float32),
             "pixels": rng.integers(0, 256, (2, 4, 3, 6, 6)).astype(np.uint8),
             "label": rng.integers(0, 10, (2, 4)).astype(np.int32)}
            for _ in range(n)]


def test_feed_equals_the_jax_device_feed_byte_for_byte():
    src = _source(9)
    with device_feed(iter(src), "cpu", depth=2) as feed:
        got = list(feed)
    with jax_device_feed(iter(src), depth=2) as jfeed:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in jfeed]
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert g[k].numpy().dtype == w[k].dtype, (i, k)
            assert g[k].numpy().tobytes() == w[k].tobytes(), (i, k)
    # a yielded batch is a copy: it aliases neither the source nor a
    # staging buffer of the ring
    assert not np.shares_memory(got[0]["data"].numpy(), src[0]["data"])


def test_device_cast_casts_after_the_copy_as_jax_does():
    host = [{"data": np.full((2, 3), i, np.uint8),
             "label": np.ones(2, np.float32)} for i in range(5)]
    stats = FeedStats()
    with device_feed(iter(host), "cpu", depth=2,
                     device_cast={"data": torch.float32},
                     stats=stats) as feed:
        got = list(feed)
    with jax_device_feed(iter(host), depth=2,
                         device_cast={"data": jnp.float32}) as jfeed:
        want = list(jfeed)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["data"].dtype == torch.float32
        assert g["data"].numpy().tobytes() == np.asarray(w["data"]).tobytes()
        np.testing.assert_array_equal(g["data"].numpy(),
                                      np.full((2, 3), i, np.float32))
        assert g["label"].dtype == torch.float32
    # the ring staged the source dtype
    assert feed.rings["data"].buffers[0].dtype == torch.uint8


def test_feed_stats_count_batches_and_put_time():
    stats, jstats = FeedStats(), JaxFeedStats()
    with device_feed(iter(_source(4)), "cpu", depth=1, stats=stats) as feed:
        list(feed)
    with jax_device_feed(iter(_source(4)), depth=1, stats=jstats) as jfeed:
        list(jfeed)
    snap, jsnap = stats.snapshot(), jstats.snapshot()
    assert snap["batches"] == jsnap["batches"] == 4
    assert snap["device_put_s"] > 0.0
    assert stats.per_batch()["device_put_s"] == pytest.approx(
        snap["device_put_s"] / 4, rel=1e-3, abs=1e-6)
    assert set(FeedStats.STAGES) == set(JaxFeedStats.STAGES)


def test_feed_depth_and_putters_knobs(monkeypatch):
    monkeypatch.setenv("SPARKNET_FEED_DEPTH", "6")
    monkeypatch.setenv("SPARKNET_FEED_PUTTERS", "3")
    assert feed_depth() == 6
    feed = device_feed(iter(_source(1)), "cpu")
    assert feed._pf._q.maxsize == 6
    assert len(feed._pool._threads) == 3
    assert feed._ring_size == ring_size(6, 4)
    feed.close()
    monkeypatch.setenv("SPARKNET_FEED_DEPTH", "0")
    with pytest.raises(ValueError, match="SPARKNET_FEED_DEPTH"):
        device_feed(iter([]), "cpu")
    monkeypatch.setenv("SPARKNET_FEED_DEPTH", "two")
    with pytest.raises(ValueError, match="integer"):
        device_feed(iter([]), "cpu")


def test_source_error_surfaces_after_the_staged_items():
    def bad():
        yield from _source(3)
        raise RuntimeError("feed source exploded")

    for make in (lambda: device_feed(bad(), "cpu", depth=2),
                 lambda: jax_device_feed(bad(), depth=2)):
        with make() as feed:
            for _ in range(3):
                next(feed)
            with pytest.raises(RuntimeError, match="feed source exploded"):
                next(feed)


class _Chaos(PrefetchIterator):
    """A feeder that fails as the JAX package's fault injector makes it:
    ``plan`` maps a pull count to ``("die", 0)`` or ``("hang", s)``, each
    fired once."""

    def __init__(self, it, plan, **kw):
        self._plan = dict(plan)
        super().__init__(it, **kw)

    def _before_pull(self, produced):
        return self._plan.pop(produced, None)


def test_dead_feeder_is_restarted_once_with_nothing_lost():
    it = _Chaos(iter(range(20)), {5: ("die", 0)}, depth=2)
    assert list(it) == list(range(20))
    assert len(it.threads()) == 2          # the first feeder and its heir


def test_hung_feeder_is_restarted_within_the_stall_timeout():
    t0 = time.monotonic()
    it = _Chaos(iter(range(10)), {3: ("hang", 3.0)}, depth=2,
                stall_timeout=0.3)
    assert list(it) == list(range(10))
    assert time.monotonic() - t0 < 2.5     # one stall timeout, not the hang


def test_second_death_raises_feed_stalled():
    it = _Chaos(iter(range(10)), {2: ("die", 0), 4: ("die", 0)}, depth=1,
                restarts=1)
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    with pytest.raises(FeedStalled, match="restart budget spent"):
        list(it)
    with pytest.raises(FeedStalled):       # sticky, like a source error
        next(it)


def test_close_joins_every_thread():
    def endless():
        while True:
            yield from _source(2)

    feed = device_feed(endless(), "cpu", depth=2, putters=2)
    next(feed)
    next(feed)
    threads = feed.threads()
    assert len(threads) == 4               # feeder, two putters, pump
    feed.close()
    assert not any(t.is_alive() for t in threads)


def test_device_feed_refuses_a_card_it_does_not_have(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceFeed(iter([]), "cuda")


def test_buffer_ring_rotates_and_restarts_on_shape_change():
    ring = BufferRing(3)
    a = ring.take((2, 4), torch.float32)
    assert len(ring.buffers) == 3          # the whole rotation at once
    b = ring.take((2, 4), torch.float32)
    c = ring.take((2, 4), torch.float32)
    assert a is not b and b is not c and a is not c
    assert ring.take((2, 4), torch.float32) is a     # rotation wraps
    assert ring.take((2, 4), torch.float32) is b
    d = ring.take((3, 3), torch.float32)             # new shape
    assert d.shape == (3, 3) and ring.buffers[0] is d
    assert all(x.shape == (3, 3) for x in ring.buffers)
    assert ring.take((3, 3), torch.uint8).dtype == torch.uint8
    assert not ring.pin and ring.nbytes == 27
    with pytest.raises(ValueError):
        BufferRing(1)


@pytest.mark.parametrize("depth,putters", [(1, 1), (1, 2), (3, 2)])
def test_ring_outlasts_every_holder_of_a_staging_buffer(depth, putters):
    """``ring_size`` (BufferRing's rule, depth + window + 2) against a
    model of the feed: a staging buffer is held from its take until its
    copy settles, and at most ``window`` = putters + 1 puts are in flight
    while the consumer works on one batch and ``depth`` host batches wait.
    Replaying every interleaving of that model's takes, a buffer is never
    taken again while held."""
    window = putters + 1
    size = ring_size(depth, window)
    assert size == depth + window + 2
    ring = BufferRing(size)
    held: list[torch.Tensor] = []
    for _ in range(10 * size):
        buf = ring.take((1,), torch.float32)
        assert all(buf is not h for h in held)
        held.append(buf)
        # the most a feed can hold at once: every in-flight put, the
        # batches staged ahead of the consumer, and the consumer's own
        held = held[-(window + depth + 1):]


def test_decode_pool_keeps_order_and_raises_at_the_ordinal():
    def fn(i):
        time.sleep(0.001 * (i % 3))
        if i == 5:
            raise KeyError("item 5")
        return i * i

    pool = DecodePool(fn, workers=3, window=4)
    out = []
    with pytest.raises(KeyError, match="item 5"):
        for v in pool.imap(iter(range(9))):
            out.append(v)
    assert out == [i * i for i in range(5)]
    pool.close()
    assert not any(t.is_alive() for t in pool.threads())


def test_decode_pool_with_dead_workers_is_a_typed_error():
    pool = DecodePool(lambda x: x, workers=1)
    pool.close()                           # every worker gone
    pool._closed = False
    pool.submit(1)
    with pytest.raises(DecodeWorkerError, match="no live workers"):
        pool.result()
