"""The port's Spark bridge against the JAX package's, on the CPU, over a
local fake of the minimal RDD protocol (tests/test_spark_bridge.py's,
copied here).

- The cases of tests/test_spark_bridge.py:51-167 against the port:
  coalesce and sizes, multi-host ownership, transform and mean, uneven
  processes and the protocol check refused, streamed partitions, the
  spill directory keeping records off the driver, a transform baked in
  at spill time.
- Partition sizes, ownership, ``compute_mean`` and the spilled files
  equal the JAX bridge's; each package reads the other's spill, and a
  spill file with a flipped byte raises its crc error in both.
- A ``local_sgd`` round of lenet (2 workers, tau 3) fed through
  ``RoundFeed`` from the bridge's dataset: the round equals the JAX
  bridge's round bit for bit, and the trainers' losses and params agree
  at tests/test_torch_trainer.py's bound (rtol 2e-4, atol 2e-5).
- ``spark_context`` without pyspark refuses with the JAX message.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest

from sparknet_tpu.apps.common import RoundFeed as JaxRoundFeed
from sparknet_tpu.data import spark_bridge as jsb
from sparknet_tpu.data.integrity import \
    DataCorruptionError as JaxCorruption
from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu_torch.apps.common import RoundFeed
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.data.integrity import DataCorruptionError
from sparknet_tpu_torch.data.spark_bridge import (SparkPartitionBridge,
                                                  spark_context)
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                 TrainerConfig)
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

RTOL, ATOL = 2e-4, 2e-5


class FakeRDD:
    """The minimal RDD protocol: a partition list and the methods the
    bridge uses."""

    def __init__(self, partitions):
        self.partitions = [list(p) for p in partitions]

    def getNumPartitions(self):
        return len(self.partitions)

    def coalesce(self, n):
        flat = [x for p in self.partitions for x in p]
        parts = [[] for _ in range(n)]
        for i, x in enumerate(flat):
            parts[i % n].append(x)
        return type(self)(parts)

    def mapPartitionsWithIndex(self, f):
        return _Collected([list(f(i, iter(p)))
                           for i, p in enumerate(self.partitions)])

    def collect(self):
        return [x for p in self.partitions for x in p]


class _Collected:
    def __init__(self, parts):
        self.parts = parts

    def collect(self):
        return [x for p in self.parts for x in p]


class StreamingFakeRDD(FakeRDD):
    """Live pyspark's shape: results stream through toLocalIterator, and
    a collect() of records trips (zipPartitions never funnels records
    through the driver, ImageNetApp.scala:145)."""

    def mapPartitionsWithIndex(self, f):
        return _StreamingCollected([list(f(i, iter(p)))
                                    for i, p in enumerate(self.partitions)])


class _StreamingCollected(_Collected):
    def toLocalIterator(self):
        for p in self.parts:
            yield from p

    def collect(self):
        flat = [x for p in self.parts for x in p]
        for x in flat:   # metadata only: (index, count[, crc32])
            assert isinstance(x, tuple) and all(
                isinstance(v, int) for v in x), \
                f"record-bearing collect() reached the driver: {x!r}"
        return flat


class RepartitionFakeRDD(FakeRDD):
    """An RDD whose coalesce cannot raise the partition count, as
    pyspark's cannot without a shuffle."""

    def coalesce(self, n):
        if n > len(self.partitions):
            return self
        return super().coalesce(n)

    def repartition(self, n):
        return FakeRDD.coalesce(self, n)


def _records(n):
    return [(np.full((2, 3, 3), i, np.float32), i % 4) for i in range(n)]


# ---------------------------------------------------------------------------
# tests/test_spark_bridge.py's cases against the port
# ---------------------------------------------------------------------------

def test_bridge_coalesce_and_sizes():
    rdd = FakeRDD([_records(10), _records(6)])
    bridge = SparkPartitionBridge(rdd, num_workers=4)
    assert bridge.rdd.getNumPartitions() == 4
    assert sum(bridge.partition_sizes()) == 16


def test_bridge_multihost_ownership():
    rdd = FakeRDD([[(i, i)] for i in range(8)])
    b0 = SparkPartitionBridge(rdd, 8, process_index=0, num_processes=2)
    b1 = SparkPartitionBridge(rdd, 8, process_index=1, num_processes=2)
    assert b0.local_partition_indices() == [0, 2, 4, 6]
    assert b1.local_partition_indices() == [1, 3, 5, 7]
    d0, d1 = b0.to_local_dataset(), b1.to_local_dataset()
    assert d0.num_partitions == 4 and d1.num_partitions == 4
    got = sorted(x for p in d0.partitions + d1.partitions for x in p)
    assert got == [(i, i) for i in range(8)]


def test_bridge_transform_and_mean():
    recs = _records(12)
    bridge = SparkPartitionBridge(FakeRDD([recs]), num_workers=3)
    ds = bridge.to_local_dataset(transform=lambda r: (r[0] * 2, r[1]))
    assert ds.count() == 12
    assert float(ds.partitions[0][1][0].max()) % 2 == 0
    mean = bridge.compute_mean(lambda r: r[0])
    np.testing.assert_allclose(mean, np.stack([r[0] for r in recs]).mean(0),
                               rtol=1e-6)


def test_bridge_uneven_processes_rejected():
    with pytest.raises(ValueError, match="divide evenly"):
        SparkPartitionBridge(FakeRDD([[1]]), 3, num_processes=2)


def test_bridge_protocol_check():
    with pytest.raises(TypeError, match="RDD protocol"):
        SparkPartitionBridge(object(), 2)


def test_bridge_repartitions_when_coalesce_cannot_grow():
    bridge = SparkPartitionBridge(RepartitionFakeRDD([_records(9)]), 3)
    assert bridge.partition_sizes() == [3, 3, 3]


def test_bridge_streams_partitions_not_collect():
    bridge = SparkPartitionBridge(StreamingFakeRDD([_records(12)]),
                                  num_workers=4, process_index=0,
                                  num_processes=2)
    ds = bridge.to_local_dataset()
    assert ds.num_partitions == 2 and ds.count() == 6


def test_bridge_spill_dir_keeps_records_off_driver(tmp_path):
    recs = _records(16)
    rdd = StreamingFakeRDD([recs])
    b0 = SparkPartitionBridge(rdd, 4, process_index=0, num_processes=2)
    b1 = SparkPartitionBridge(rdd, 4, process_index=1, num_processes=2)
    d0 = b0.to_local_dataset(spill_dir=str(tmp_path))
    d1 = b1.to_local_dataset(spill_dir=str(tmp_path))
    assert d0.num_partitions == 2 and d1.num_partitions == 2
    got = sorted(r[1] for p in d0.partitions + d1.partitions for r in p)
    assert got == sorted(r[1] for r in recs)
    assert sorted(os.listdir(tmp_path)) == (
        ["_meta.json"] + [f"part-{i:05d}.pkl" for i in range(4)])


def test_bridge_spill_transform_applied_worker_side(tmp_path):
    bridge = SparkPartitionBridge(StreamingFakeRDD([_records(6)]), 2)
    assert bridge.spill_to(str(tmp_path),
                           transform=lambda r: (r[0] * 3, r[1])) == [3, 3]
    ds = bridge.to_local_dataset(spill_dir=str(tmp_path))
    ds2 = bridge.to_local_dataset(spill_dir=str(tmp_path))
    assert float(ds.partitions[0][1][0].max()) % 3 == 0 and ds2.count() == 6


def test_stale_spill_is_refused(tmp_path):
    SparkPartitionBridge(FakeRDD([_records(6)]), 2).spill_to(str(tmp_path))
    with pytest.raises(ValueError, match="stale spill"):
        SparkPartitionBridge(FakeRDD([_records(6)]), 3).spill_to(
            str(tmp_path))


def test_spark_context_without_pyspark_refuses(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyspark", None)
    with pytest.raises(ImportError, match="pyspark") as ours:
        spark_context()
    with pytest.raises(ImportError, match="pyspark") as theirs:
        jsb.spark_context()
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Against the JAX bridge
# ---------------------------------------------------------------------------

def _both(partitions, n, **kw):
    return (SparkPartitionBridge(FakeRDD(partitions), n, **kw),
            jsb.SparkPartitionBridge(FakeRDD(partitions), n, **kw))


def _flat(ds):
    return [(np.asarray(x).tobytes(), y) for p in ds.partitions
            for x, y in p]


@pytest.mark.parametrize("n,proc", [(4, (0, 1)), (4, (1, 2)), (3, (0, 1))])
def test_sizes_ownership_and_mean_equal_the_jax_bridge(n, proc):
    parts = [_records(7), _records(10), _records(2)]
    ours, theirs = _both(parts, n, process_index=proc[0],
                         num_processes=proc[1])
    assert ours.partition_sizes() == theirs.partition_sizes()
    assert ours.local_partition_indices() == \
        theirs.local_partition_indices()
    assert _flat(ours.to_local_dataset()) == \
        _flat(theirs.to_local_dataset())
    to = lambda r: r[0] + r[1]  # noqa: E731
    assert ours.compute_mean(to).tobytes() == \
        theirs.compute_mean(to).tobytes()


def test_spills_are_equal_and_read_across(tmp_path):
    parts = [_records(9), _records(5)]
    ours, theirs = _both(parts, 2)
    tf = lambda r: (r[0] * 2, r[1])  # noqa: E731
    assert ours.spill_to(str(tmp_path / "p"), transform=tf) == \
        theirs.spill_to(str(tmp_path / "j"), transform=tf)
    for name in ["_meta.json"] + [f"part-{i:05d}.pkl" for i in range(2)]:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    # each package reads the other's spill
    a = ours.to_local_dataset(spill_dir=str(tmp_path / "j"))
    b = theirs.to_local_dataset(spill_dir=str(tmp_path / "p"))
    assert _flat(a) == _flat(b) == _flat(
        theirs.to_local_dataset(transform=tf))


def test_a_rotted_spill_raises_its_crc_error(tmp_path):
    ours, theirs = _both([_records(8)], 2)
    ours.spill_to(str(tmp_path))
    path = tmp_path / "part-00001.pkl"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(DataCorruptionError, match="crc32") as ei:
        ours.to_local_dataset(spill_dir=str(tmp_path))
    assert ei.value.key == 1 and "part-00001.pkl" in str(ei.value)
    with pytest.raises(JaxCorruption, match="crc32"):
        theirs.to_local_dataset(spill_dir=str(tmp_path))


def _digits(n, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    x = rng.normal(scale=0.3, size=(n, 1, 28, 28)).astype(np.float32)
    for i, k in enumerate(labels):
        x[i, :, k % 28, :] += 2.0
    return [(x[i], int(labels[i])) for i in range(n)]


def test_local_sgd_round_from_the_bridge_tracks_the_jax_trainer(tmp_path):
    txt = 'base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\n'
    tau, batch = 3, 4
    parts = [_digits(20, 0), _digits(14, 1)]
    ours, theirs = _both(parts, 2)
    ds = ours.to_local_dataset(spill_dir=str(tmp_path))
    jds = theirs.to_local_dataset()
    rounds = [RoundFeed(ds, batch, tau, seed=2).next_round()
              for _ in range(1)]
    jround = JaxRoundFeed(jds, batch, tau, seed=2).next_round()
    for k in ("data", "label"):
        assert rounds[0][k].tobytes() == jround[k].tobytes(), k
    jtr = JaxTrainer(jax_solver(txt, jax_lenet(batch, batch)), make_mesh(2),
                     JaxConfig(strategy="local_sgd", tau=tau), seed=0)
    tr = DistributedTrainer(load_solver_prototxt_with_net(
        txt, lenet(batch, batch)), 2, TrainerConfig(tau=tau), seed=0,
        device="cpu")
    tr.params = params_from_jax(jax.device_get(jtr.params), tr.train_net,
                                device="cpu")
    loss, jloss = tr.train_round(rounds[0]), jtr.train_round(jround)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    want = jax.device_get(jtr.params)
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            np.testing.assert_allclose(b.numpy(), np.asarray(want[k][i]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}[{i}]")
