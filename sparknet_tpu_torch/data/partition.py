"""PartitionedDataset, the local stand-in for Spark's RDD tier.

The port's own copy of ``sparknet_tpu/data/partition.py``.  The reference
loads and shards data as Spark RDDs (reference: src/main/scala/loaders/
ImageNetLoader.scala:91; coalesce and per-partition sizes at
src/main/scala/apps/ImageNetApp.scala:89-95); this class keeps the same
partition semantics on one host, one partition per worker, and its
partition-indexed API is what ``data/spark_bridge.py`` hands each host.
A partition may be a list or a lazy sequence: ``imagenet.
LazyTarPartition`` decodes its records on access, a ``records.
RecordShard`` reads each with one crc-checked ranged read
(:meth:`PartitionedDataset.from_records`), and :meth:`cached` puts either
behind a tiered ``pipeline.ShardCache``.  The elastic re-form uses
:meth:`without_partitions` and :meth:`rebalance`.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Iterable, Iterator, Sequence


class PartitionedDataset:
    """An ordered list of partitions, each a sequence of records.
    Anything with ``__len__`` and ``__getitem__`` is kept as it is, so a
    lazy partition (``imagenet.LazyTarPartition``, a
    ``records.RecordShard``) is never materialized here."""

    def __init__(self, partitions: Sequence[Any]):
        self.partitions = [
            p if hasattr(p, "__len__") and hasattr(p, "__getitem__")
            else list(p)
            for p in partitions]

    @classmethod
    def from_items(cls, items: Iterable[Any], num_partitions: int,
                   shuffle: bool = False, seed: int = 0) -> "PartitionedDataset":
        """Round-robin shard (the parallelize + coalesce analog)."""
        items = list(items)
        if shuffle:
            random.Random(seed).shuffle(items)
        parts: list[list[Any]] = [[] for _ in range(num_partitions)]
        for i, item in enumerate(items):
            parts[i % num_partitions].append(item)
        return cls(parts)

    @classmethod
    def from_records(cls, source: str,
                     verify: bool = False) -> "PartitionedDataset":
        """Open a pre-decoded record-shard source (``tools/convert.py``
        output: a ``*.rec`` file, a directory of them, or an object-store
        URL) as one lazy partition per shard.  Each partition is a
        ``records.RecordShard`` — ``__getitem__`` is one crc-checked
        ranged read, no decode — so the usual lazy-partition machinery
        (``cached()``, ``rebalance``, ``quarantine_map``) composes
        unchanged.  ``verify=True`` routes reads through a
        ``VerifyingStore`` carrying every record's crc."""
        from .records import ShardSet
        return cls(ShardSet.open(source, verify=verify).partitions())

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def partition_sizes(self) -> list[int]:
        """Per-partition element counts (the zipPartitions sizes RDD,
        reference: ImageNetApp.scala:94-95)."""
        return [len(p) for p in self.partitions]

    def count(self) -> int:
        return sum(len(p) for p in self.partitions)

    def map(self, fn: Callable[[Any], Any]) -> "PartitionedDataset":
        return PartitionedDataset([[fn(x) for x in p] for p in self.partitions])

    def map_partitions(self, fn: Callable[[list[Any]], list[Any]]
                       ) -> "PartitionedDataset":
        return PartitionedDataset([fn(list(p)) for p in self.partitions])

    def quarantine_map(self, fn: Callable[[Any], Any],
                       quarantine) -> "PartitionedDataset":
        """:meth:`map`, but a record whose ``fn`` raises
        ``DataCorruptionError`` is routed through ``quarantine`` (a
        ``data.integrity.Quarantine``): skipped and counted under
        ``partition:<i>``, within the quarantine's bounded budget
        (exceeding it raises ``QuarantineExceeded``).  This is the
        decode-with-accounting analog of the reference's silent
        undecodable-image drop (ScaleAndConvert.scala:23-25) — the same
        forward progress, but every drop is attributed and bounded."""
        from .integrity import DataCorruptionError
        parts: list[list[Any]] = []
        for pi, p in enumerate(self.partitions):
            out = []
            for rec in p:
                try:
                    out.append(fn(rec))
                except DataCorruptionError as e:
                    quarantine.admit(e, source=f"partition:{pi}")
            parts.append(out)
        return PartitionedDataset(parts)

    def coalesce(self, n: int) -> "PartitionedDataset":
        flat = [x for p in self.partitions for x in p]
        return PartitionedDataset.from_items(flat, n)

    # -- elastic membership support (the re-shard half of degraded-mode
    #    training: when a worker is dropped or rejoins, the survivor set
    #    must re-cover ALL the data, not orphan the lost partition) ------
    def without_partitions(self, dropped: Sequence[int]
                           ) -> "PartitionedDataset":
        """Remove the given partition indices (a dead worker's shard),
        keeping order — the records they held are NOT re-covered; chain
        with :meth:`rebalance` when the survivors must take them over."""
        drop = set(dropped)
        bad = [i for i in drop if not 0 <= i < self.num_partitions]
        if bad:
            raise IndexError(
                f"partition indices {sorted(bad)} out of range for "
                f"{self.num_partitions} partitions")
        return PartitionedDataset(
            [p for i, p in enumerate(self.partitions) if i not in drop])

    def rebalance(self, num_partitions: int) -> "PartitionedDataset":
        """Re-shard every record over ``num_partitions`` contiguous,
        size-balanced partitions (sizes differ by at most 1), preserving
        record order.  This is the elastic re-form primitive: after a
        permanent worker loss the survivors call
        ``ds.without_partitions([dead]).rebalance(n_survivors)`` and the
        full epoch is re-covered by the smaller worker set; a rejoining
        worker re-runs it with the larger count at the next round
        boundary.  Unlike :meth:`coalesce` (round-robin — the historical
        parallelize analog), contiguous reassignment keeps each record's
        neighborhood, so sequential readers (LMDB cursors, tar members)
        stay sequential."""
        if num_partitions < 1:
            raise ValueError(
                f"rebalance needs num_partitions >= 1, got {num_partitions}")
        flat = [x for p in self.partitions for x in p]
        n, k = len(flat), num_partitions
        base, extra = divmod(n, k)
        parts, at = [], 0
        for i in range(k):
            size = base + (1 if i < extra else 0)
            parts.append(flat[at:at + size])
            at += size
        return PartitionedDataset(parts)

    def cached(self, max_shards: int | None = None,
               cache=None) -> "PartitionedDataset":
        """A view whose partitions materialize through a shared
        ``pipeline.ShardCache`` LRU: multi-epoch training over lazy
        partitions (``imagenet.LazyTarPartition`` decodes per access)
        pays decode once per shard instead of once per epoch, bounded to
        ``max_shards`` resident shards (default: all of them — the
        whole-dataset cache).  Pass an existing :class:`ShardCache` to
        share one budget across datasets (e.g. train + test views)."""
        from .pipeline import CachedPartition, ShardCache
        if cache is None:
            cache = ShardCache(max_shards or self.num_partitions or 1)
        return PartitionedDataset(
            [CachedPartition(p, key, cache)
             for key, p in enumerate(self.partitions)])

    def iterator(self, partition: int) -> Iterator[Any]:
        return iter(self.partitions[partition])

    def reduce(self, fn: Callable[[Any, Any], Any]) -> Any:
        acc = None
        for p in self.partitions:
            for x in p:
                acc = x if acc is None else fn(acc, x)
        return acc
