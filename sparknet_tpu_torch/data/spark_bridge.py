"""Spark RDD to partition bridge: the data tier the reference builds its
driver loop around (reference: src/main/scala/apps/ImageNetApp.scala
:89-95: coalesce(numWorkers), persist, count, the per-partition sizes
RDD, zipPartitions task dispatch).

The port's own copy of ``sparknet_tpu/data/spark_bridge.py``.  It is
written against the minimal RDD protocol the logic needs
(``getNumPartitions()``, ``coalesce(n)``, ``mapPartitionsWithIndex(f)``,
``collect()``, and ``repartition(n)`` where the RDD has it), which a live
``pyspark.RDD`` satisfies and a local fake satisfies in tests and on the
card's machine.  No module of the port imports ``pyspark``:
:func:`spark_context` loads it by name when called, and refuses without
it as the JAX package does.

Topology: each host process owns the partitions ``i == process_index
(mod num_processes)``; worker-side ``mapPartitionsWithIndex`` ships each
partition's records to its owner, which feeds them to the trainer as a
``PartitionedDataset``: zipPartitions' data locality without the JVM.
A spill directory (``to_local_dataset(spill_dir=)``, ``spill_to``) keeps
records off the driver; each spilled partition carries a crc32 that is
checked when it is read back.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from .partition import PartitionedDataset


def _spill_path(spill_dir: str, index: int) -> str:
    import os
    return os.path.join(spill_dir, f"part-{index:05d}.pkl")


def _spill_partitions(rdd: Any, spill_dir: str,
                      transform: Callable[[Any], Any] | None,
                      ) -> list[tuple[int, int]]:
    """Write each partition executor-side (task-local, like
    foreachPartition); only (index, count, crc32) metadata returns to the
    driver.  An existing spill (``_meta.json`` present) is reused so
    every host of a multi-process run shares ONE spill pass.  The per-
    file crc32 is the read-side integrity check: a spill that rots on
    the shared filesystem is detected at read time (``_read_spill``), not
    fed into training as garbage pickles."""
    import json
    import os
    meta_path = os.path.join(spill_dir, "_meta.json")
    n_parts = int(rdd.getNumPartitions())
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("num_partitions") != n_parts:
            raise ValueError(
                f"stale spill at {spill_dir!r}: written for "
                f"{meta.get('num_partitions')} partitions, RDD now has "
                f"{n_parts} — clear the directory (a spill dir belongs to "
                f"ONE dataset/transform/worker-count combination)")
        return [(int(i), int(n)) for i, n in meta["counts"]]
    os.makedirs(spill_dir, exist_ok=True)

    def spill(i: int, it: Iterable[Any]):
        import os
        import pickle
        import zlib
        n = 0
        crc = 0
        tmp = _spill_path(spill_dir, i) + ".tmp"
        with open(tmp, "wb") as f:
            for rec in it:
                blob = pickle.dumps(transform(rec) if transform else rec,
                                    protocol=pickle.HIGHEST_PROTOCOL)
                crc = zlib.crc32(blob, crc)
                f.write(blob)
                n += 1
        os.replace(tmp, _spill_path(spill_dir, i))  # atomic publish
        return [(i, n, crc & 0xFFFFFFFF)]

    meta = list(rdd.mapPartitionsWithIndex(spill).collect())
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"num_partitions": n_parts,
                   "counts": [[int(i), int(n)] for i, n, _ in meta],
                   "crc32": {str(int(i)): int(c) for i, _, c in meta}}, f)
    os.replace(tmp, meta_path)
    return [(i, n) for i, n, _ in meta]


def _read_spill(spill_dir: str, index: int,
                expect_crc: int | None = None) -> list[Any]:
    """Read one spilled partition back, retrying transient I/O at file
    granularity and verifying the spill-time crc32 when known; a durable
    mismatch raises ``DataCorruptionError`` naming the partition file."""
    import os
    import pickle
    import zlib

    from ..utils.retry import io_retry
    from .integrity import DataCorruptionError
    path = _spill_path(spill_dir, index)

    def read() -> bytes:
        with open(path, "rb") as f:
            return f.read()

    raw = io_retry(read, describe=f"read spill {os.path.basename(path)}")
    if expect_crc is not None:
        got = zlib.crc32(raw) & 0xFFFFFFFF
        if got != expect_crc:
            raise DataCorruptionError(
                f"spilled partition failed its crc32 "
                f"({got:#010x} != {expect_crc:#010x}, {len(raw)} bytes) — "
                f"the spill rotted on the shared filesystem; clear "
                f"{spill_dir!r} and re-spill", source=path, key=index)
    out = []
    import io as _io
    f = _io.BytesIO(raw)
    while True:
        try:
            out.append(pickle.load(f))
        except EOFError:
            return out


def _spill_crcs(spill_dir: str) -> dict[int, int]:
    """The per-partition crc32 index of an existing spill ({} for spills
    written before checksums existed — those read unverified)."""
    import json
    import os
    meta_path = os.path.join(spill_dir, "_meta.json")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        return {int(i): int(c) for i, c in meta.get("crc32", {}).items()}
    except (OSError, json.JSONDecodeError, ValueError):
        return {}


def _require_rdd(rdd: Any) -> None:
    for attr in ("getNumPartitions", "coalesce", "mapPartitionsWithIndex",
                 "collect"):
        if not hasattr(rdd, attr):
            raise TypeError(
                f"object {type(rdd).__name__} does not satisfy the RDD "
                f"protocol (missing {attr}); pass a pyspark RDD or a "
                "compatible fake")


def spark_context(app_name: str = "sparknet_tpu"):
    """A live SparkContext: needs pyspark on the driver host, loaded by
    name here so that no module of the port depends on it (reference
    cluster setup: SETUP.md, ec2/)."""
    import importlib
    try:
        pyspark = importlib.import_module("pyspark")
    except ImportError as e:
        raise ImportError(
            "the Spark data tier needs pyspark, which is not in this "
            "build — use PartitionedDataset/load_imagenet for local "
            "sharding, or install pyspark on the driver host") from e
    conf = pyspark.SparkConf().setAppName(app_name)
    # the reference disables task retry: re-running a side-effectful
    # training task corrupts state (CifarApp.scala:36)
    conf.set("spark.task.maxFailures", "1")
    return pyspark.SparkContext(conf=conf)


class SparkPartitionBridge:
    """Shard an RDD of records across hosts the way the reference's apps
    shard across executors."""

    def __init__(self, rdd: Any, num_workers: int,
                 process_index: int = 0, num_processes: int = 1):
        _require_rdd(rdd)
        if num_workers % num_processes:
            raise ValueError(
                f"num_workers={num_workers} must divide evenly across "
                f"{num_processes} host processes")
        n = rdd.getNumPartitions()
        if n < num_workers and hasattr(rdd, "repartition"):
            # pyspark coalesce cannot INCREASE partition count without a
            # shuffle — repartition does
            rdd = rdd.repartition(num_workers)
        elif n != num_workers:
            rdd = rdd.coalesce(num_workers)
        if rdd.getNumPartitions() != num_workers:
            raise ValueError(
                f"could not shard RDD into {num_workers} partitions "
                f"(got {rdd.getNumPartitions()}); repartition the source")
        self.rdd = rdd
        self.num_workers = num_workers
        self.process_index = process_index
        self.num_processes = num_processes

    def partition_sizes(self) -> list[int]:
        """Per-partition element counts (the trainPartitionSizes RDD,
        reference: ImageNetApp.scala:94-95)."""
        pairs = self.rdd.mapPartitionsWithIndex(
            lambda i, it: [(i, sum(1 for _ in it))]).collect()
        sizes = [0] * self.num_workers
        for i, n in pairs:
            sizes[i] = n
        return sizes

    def local_partition_indices(self) -> list[int]:
        """Partitions owned by this host process."""
        return list(range(self.process_index, self.num_workers,
                          self.num_processes))

    def to_local_dataset(self,
                         transform: Callable[[Any], Any] | None = None,
                         spill_dir: str | None = None,
                         ) -> PartitionedDataset:
        """Materialize THIS host's partitions as a PartitionedDataset
        (records optionally mapped by ``transform`` worker-side), keeping
        the reference's zipPartitions data-locality contract
        (ImageNetApp.scala:145 — records never funnel through the driver):

        - ``spill_dir`` set (a path executors AND this host can read —
          shared FS or fuse-mounted object store): each partition is
          pickled executor-side by ``foreachPartition``-style tasks; only
          (index, count) metadata rides the collect, and this host reads
          just its owned partition files.  An existing spill (e.g. from
          ``spill_to`` or another host) is reused as-is — ``transform``
          is baked in at spill time.  At ImageNet scale this is the only
          tier that avoids re-creating the driver bottleneck the
          reference's design exists to remove.
        - otherwise, ``toLocalIterator`` when the RDD has it (live
          pyspark): partitions stream through the driver ONE at a time —
          bounded driver memory, no whole-RDD materialization.
        - otherwise (minimal fakes): an owned-partitions-only collect.
        """
        owned = set(self.local_partition_indices())

        if spill_dir is not None:
            meta = dict(_spill_partitions(self.rdd, spill_dir, transform))
            crcs = _spill_crcs(spill_dir)
            parts = []
            for i in sorted(owned):
                parts.append(_read_spill(spill_dir, i, crcs.get(i))
                             if meta.get(i, 0) else [])
            return PartitionedDataset(parts)

        def keep(i: int, it: Iterable[Any]):
            if i not in owned:
                return iter(())
            if transform is None:
                return ((i, x) for x in it)
            return ((i, transform(x)) for x in it)

        tagged = self.rdd.mapPartitionsWithIndex(keep)
        if hasattr(tagged, "toLocalIterator"):
            stream = tagged.toLocalIterator()
        else:
            stream = iter(tagged.collect())
        parts_d: dict[int, list[Any]] = {i: [] for i in owned}
        for i, x in stream:
            parts_d[i].append(x)
        return PartitionedDataset([parts_d[i] for i in sorted(parts_d)])

    def spill_to(self, spill_dir: str,
                 transform: Callable[[Any], Any] | None = None,
                 ) -> list[int]:
        """Executor-side spill of every partition to ``spill_dir`` without
        reading any record on the driver; returns per-partition counts.
        Hosts then build datasets via ``to_local_dataset(spill_dir=...)``
        (each reads only its owned files)."""
        meta = dict(_spill_partitions(self.rdd, spill_dir, transform))
        return [meta.get(i, 0) for i in range(self.num_workers)]

    def compute_mean(self, to_array: Callable[[Any], Any]) -> Any:
        """Distributed mean image: per-partition pixel sums reduced on the
        driver (ComputeMean.apply, reference: ComputeMean.scala:8-44)."""
        import numpy as np

        def partial(i: int, it: Iterable[Any]):
            acc = None
            n = 0
            for rec in it:
                arr = np.asarray(to_array(rec), np.float64)
                acc = arr if acc is None else acc + arr
                n += 1
            return [(acc, n)] if n else []

        total, count = None, 0
        for acc, n in self.rdd.mapPartitionsWithIndex(partial).collect():
            total = acc if total is None else total + acc
            count += n
        if not count:
            raise ValueError("empty RDD")
        return (total / count).astype(np.float32)
