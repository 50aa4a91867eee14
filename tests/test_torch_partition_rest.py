"""The rest of the port's ``PartitionedDataset`` against the JAX one, on
the CPU: each method the port took over in its data-tier slice
(``from_records``, ``num_partitions``, ``map_partitions``,
``quarantine_map``, ``coalesce``, ``without_partitions``, ``rebalance``,
``cached``, ``iterator``, ``reduce``) gives the JAX method's partitions,
record for record, on the same items, and both classes have the same
methods."""

from __future__ import annotations

import inspect

import numpy as np
import pytest

from sparknet_tpu.data import PartitionedDataset as JaxDataset
from sparknet_tpu.data.integrity import DataCorruptionError as JaxBad
from sparknet_tpu.data.integrity import Quarantine as JaxQuarantine
from sparknet_tpu.data.integrity import QuarantinePolicy as JaxPolicy
from sparknet_tpu.data.records import convert_to_shards as jax_convert
from sparknet_tpu_torch.data import PartitionedDataset
from sparknet_tpu_torch.data.integrity import (DataCorruptionError,
                                               Quarantine, QuarantinePolicy)
from sparknet_tpu_torch.data.pipeline import ShardCache

ITEMS = list(range(23))


def _both(n=4, items=ITEMS):
    return (PartitionedDataset.from_items(items, n, shuffle=True, seed=3),
            JaxDataset.from_items(items, n, shuffle=True, seed=3))


def _parts(ds):
    return [list(p) for p in ds.partitions]


def test_the_two_classes_have_the_same_methods():
    def public(cls):
        return {k for k, _ in inspect.getmembers(cls) if not
                k.startswith("_")}
    assert public(PartitionedDataset) == public(JaxDataset)


@pytest.mark.parametrize("n", [1, 3, 7])
def test_coalesce_equals_jax(n):
    ours, theirs = _both()
    assert _parts(ours.coalesce(n)) == _parts(theirs.coalesce(n))
    assert ours.coalesce(n).num_partitions == n


@pytest.mark.parametrize("n", [1, 2, 5, 30])
def test_rebalance_equals_jax(n):
    ours, theirs = _both()
    assert _parts(ours.rebalance(n)) == _parts(theirs.rebalance(n))
    sizes = ours.rebalance(n).partition_sizes()
    assert max(sizes) - min(sizes) <= 1


def test_rebalance_refuses_zero_partitions():
    with pytest.raises(ValueError, match="num_partitions >= 1"):
        _both()[0].rebalance(0)


@pytest.mark.parametrize("dropped", [[0], [1, 3], []])
def test_without_partitions_equals_jax(dropped):
    ours, theirs = _both()
    assert _parts(ours.without_partitions(dropped)) == \
        _parts(theirs.without_partitions(dropped))
    assert _parts(ours.without_partitions(dropped).rebalance(3)) == \
        _parts(theirs.without_partitions(dropped).rebalance(3))


def test_without_partitions_refuses_out_of_range():
    with pytest.raises(IndexError, match="out of range"):
        _both()[0].without_partitions([4])


def test_map_partitions_iterator_and_reduce_equal_jax():
    ours, theirs = _both()
    rev = lambda p: p[::-1]  # noqa: E731
    assert _parts(ours.map_partitions(rev)) == \
        _parts(theirs.map_partitions(rev))
    assert [list(ours.iterator(i)) for i in range(4)] == \
        [list(theirs.iterator(i)) for i in range(4)]
    assert ours.reduce(lambda a, b: a * 3 + b) == \
        theirs.reduce(lambda a, b: a * 3 + b)
    assert PartitionedDataset([[], []]).reduce(max) is None


def test_quarantine_map_equals_jax():
    def fn_for(err):
        def fn(x):
            if x % 5 == 0:
                raise err(f"bad {x}", key=x)
            return x * 2
        return fn

    ours, theirs = _both()
    q = Quarantine(QuarantinePolicy(max_records=10), source="t")
    jq = JaxQuarantine(JaxPolicy(max_records=10), source="t")
    assert _parts(ours.quarantine_map(fn_for(DataCorruptionError), q)) == \
        _parts(theirs.quarantine_map(fn_for(JaxBad), jq))
    assert q.report() == jq.report()
    assert q.report()["total_bad"] == 5


def test_cached_materializes_once_and_equals_jax(tmp_path):
    calls = []

    class Lazy:
        def __init__(self, items):
            self.items = items

        def __len__(self):
            return len(self.items)

        def __getitem__(self, idx):
            calls.append(idx)
            return self.items[idx]

    parts = [Lazy(list(range(i * 5, i * 5 + 5))) for i in range(3)]
    cache = ShardCache(2, spill_dir=str(tmp_path / "spill"))
    view = PartitionedDataset(parts).cached(cache=cache)
    jview = JaxDataset([list(p.items) for p in parts]).cached(2)
    for _ in range(2):
        assert _parts(view) == _parts(jview)
    # each partition materialized once (a slice), the evictee from disk
    assert len(calls) == 3
    assert cache.tier_counts()["disk_hits"] > 0
    assert PartitionedDataset(parts).cached().partitions[0]._cache \
        .max_shards == 3


def test_from_records_equals_jax_on_jax_written_shards(tmp_path):
    rng = np.random.default_rng(0)
    recs = [(rng.integers(0, 256, size=(2, 3, 3)).astype(np.uint8), i)
            for i in range(10)]
    jax_convert(iter(recs), str(tmp_path), shard_bytes=3 * 26)
    ours = PartitionedDataset.from_records(str(tmp_path), verify=True)
    theirs = JaxDataset.from_records(str(tmp_path))
    assert ours.partition_sizes() == theirs.partition_sizes() == \
        [3, 3, 3, 1]
    flat = lambda ds: [(x.tobytes(), y) for p in ds.partitions  # noqa
                       for x, y in p]
    assert flat(ours) == flat(theirs)
    assert flat(ours.rebalance(2).cached()) == \
        flat(theirs.rebalance(2).cached())
