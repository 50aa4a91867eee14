"""PartitionedDataset, the local stand-in for Spark's RDD tier.

The port's copy of the part of ``sparknet_tpu/data/partition.py``
(:19-170) that the training slice uses.  The reference loads and shards
data as Spark RDDs (reference: src/main/scala/loaders/ImageNetLoader.scala:91;
coalesce and per-partition sizes at src/main/scala/apps/ImageNetApp.scala:
89-95); this class keeps the same partition semantics on one host: one
partition per worker.  A partition may be a list or a lazy sequence such
as ``imagenet.LazyTarPartition``, which decodes its records on access.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Iterable, Sequence


class PartitionedDataset:
    """An ordered list of partitions, each a sequence of records.
    Anything with ``__len__`` and ``__getitem__`` is kept as it is, so a
    lazy partition is never materialized here."""

    def __init__(self, partitions: Sequence[Any]):
        self.partitions = [
            p if hasattr(p, "__len__") and hasattr(p, "__getitem__")
            else list(p)
            for p in partitions]

    @classmethod
    def from_items(cls, items: Iterable[Any], num_partitions: int,
                   shuffle: bool = False,
                   seed: int = 0) -> "PartitionedDataset":
        """Round-robin shard (the parallelize + coalesce analog)."""
        items = list(items)
        if shuffle:
            random.Random(seed).shuffle(items)
        parts: list[list[Any]] = [[] for _ in range(num_partitions)]
        for i, item in enumerate(items):
            parts[i % num_partitions].append(item)
        return cls(parts)

    def partition_sizes(self) -> list[int]:
        """Per-partition element counts (the zipPartitions sizes RDD,
        reference: ImageNetApp.scala:94-95)."""
        return [len(p) for p in self.partitions]

    def count(self) -> int:
        return sum(len(p) for p in self.partitions)

    def map(self, fn: Callable[[Any], Any]) -> "PartitionedDataset":
        return PartitionedDataset([[fn(x) for x in p]
                                   for p in self.partitions])
