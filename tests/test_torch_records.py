"""The port's record shards, ``VerifyingStore`` and tiered ``ShardCache``
against the JAX package's, on the CPU.

- Shard bytes: the same records written by either package's
  ``write_shard`` and ``convert_to_shards`` give identical files, and
  each package reads the other's.
- The cases of tests/test_records.py:55-348 and :420 against the port:
  the round trip, a flipped byte as typed corruption with attribution,
  non-uint8 refused, a garbage file, rolling shards, quarantine at
  convert, ``VerifyingStore`` (and its torn-read heal), ``from_records``,
  concurrent ranged reads, the cache tiers, spill and its bound, and the
  convert CLI's round trip.  The device augmentation cases (:351-418)
  stay with ROADMAP A14.
- ``records_feed`` equals, bit for bit, the JAX ``records_feed`` and the
  JAX serial LMDB stream the shards were converted from, at 0 and 4
  readers, clean and under ``corrupt_record`` faults (the same records
  quarantined, the same replacements); ``raw=True`` ships the JAX
  package's uint8 batches; ``db_feed`` dispatches to it.
- ``caffe_cli train`` from ``backend: RECORDS``:
  tests/test_torch_caffe_cli.py.
- Refusals that remain: ``s3://`` and ``gs://`` name ROADMAP A6.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

from sparknet_tpu.data import db as jdb
from sparknet_tpu.data import records as jrec
from sparknet_tpu.data.integrity import Quarantine as JaxQuarantine
from sparknet_tpu.data.integrity import QuarantinePolicy as JaxPolicy
from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.proto.caffe_pb import Phase as JaxPhase
from sparknet_tpu.utils import faults as jfaults
from sparknet_tpu_torch.data import PartitionedDataset
from sparknet_tpu_torch.data.db import array_to_datum, db_feed
from sparknet_tpu_torch.data.integrity import (DataCorruptionError,
                                               Quarantine, QuarantinePolicy)
from sparknet_tpu_torch.data.lmdb_io import write_lmdb
from sparknet_tpu_torch.data.objectstore import (LocalStore,
                                                 VerifyingStore, get_store)
from sparknet_tpu_torch.data.pipeline import FeedStats, ShardCache
from sparknet_tpu_torch.data.records import (RecordShard, ShardSet,
                                             ShardWriter, convert_to_shards,
                                             is_records_source,
                                             records_feed, write_shard)
from sparknet_tpu_torch.models.dsl import layer
from sparknet_tpu_torch.proto import Phase
from sparknet_tpu_torch.utils import faults

STRIDE = 3 * 8 * 8 + 8


def _records(n, c=3, h=8, w=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, size=(c, h, w)).astype(np.uint8),
             int(rng.integers(0, 10))) for _ in range(n)]


def _write_lmdb_of(path, recs):
    write_lmdb(path, [(b"%08d" % i, array_to_datum(img, label))
                      for i, (img, label) in enumerate(recs)])


def _layers(source, batch, backend, transform=None):
    tp = transform or {"scale": 0.5, "mean_value": [16.0]}
    kw = dict(data_param={"source": source, "batch_size": batch,
                          "backend": backend}, transform_param=tp)
    return (layer("d", "Data", [], ["data", "label"], **kw),
            jax_layer("d", "Data", [], ["data", "label"], **kw))


def _pull(feed, n):
    out = [{k: np.array(v) for k, v in next(feed).items()}
           for _ in range(n)]
    feed.close()
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            assert x[k].tobytes() == y[k].tobytes(), k


def _norm(rep):
    rep = dict(rep)
    rep.pop("examples", None)
    rep.pop("by_source", None)   # the source names differ by backend
    return rep


def _reset_faults():
    faults.reset_injector()
    jfaults.reset_injector()


# ---------------------------------------------------------------------------
# The format across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["write_shard", "convert_to_shards"])
def test_shard_bytes_equal_the_jax_writers_and_read_across(tmp_path,
                                                           writer):
    recs = _records(11, seed=3)
    if writer == "write_shard":
        write_shard(str(tmp_path / "p.rec"), recs)
        jrec.write_shard(str(tmp_path / "j.rec"), recs)
        pairs = [("p.rec", "j.rec")]
    else:
        out = convert_to_shards(iter(recs), str(tmp_path / "p"),
                                shard_bytes=4 * STRIDE)
        jout = jrec.convert_to_shards(iter(recs), str(tmp_path / "j"),
                                      shard_bytes=4 * STRIDE)
        assert len(out["shards"]) == len(jout["shards"]) == 3
        assert {k: v for k, v in out.items() if k != "shards"} == \
            {k: v for k, v in jout.items() if k != "shards"}
        pairs = [(os.path.relpath(a, tmp_path), os.path.relpath(b, tmp_path))
                 for a, b in zip(out["shards"], jout["shards"])]
    for ours, theirs in pairs:
        assert (tmp_path / ours).read_bytes() == \
            (tmp_path / theirs).read_bytes()
    # each package reads the other's
    ss = ShardSet.open(str(tmp_path / pairs[0][1]))
    jss = jrec.ShardSet.open(str(tmp_path / pairs[0][0]))
    for i in range(ss.count):
        a, b = ss.locate(i), jss.locate(i)
        (x, lx), (y, ly) = a[0].read(a[1]), b[0].read(b[1])
        assert x.tobytes() == y.tobytes() == recs[i][0].tobytes()
        assert lx == ly == recs[i][1]
    ss.close()
    jss.close()


# ---------------------------------------------------------------------------
# tests/test_records.py's cases against the port
# ---------------------------------------------------------------------------

def test_shard_roundtrip_bit_exact(tmp_path):
    recs = _records(7)
    path = str(tmp_path / "a.rec")
    assert write_shard(path, recs) == 7
    shard = RecordShard.open(path)
    assert shard.count == 7 and len(shard) == 7
    assert (shard.c, shard.h, shard.w) == (3, 8, 8)
    for i, (img, label) in enumerate(recs):
        got, glabel = shard.read(i)
        assert got.dtype == np.uint8
        assert np.array_equal(img, got)
        assert label == glabel
    assert len(shard[2:5]) == 3
    assert np.array_equal(shard[3][0], recs[3][0])
    assert sum(1 for _ in shard) == 7


def test_shard_flipped_byte_is_typed_corruption_with_attribution(tmp_path):
    recs = _records(5)
    path = str(tmp_path / "a.rec")
    write_shard(path, recs)
    shard = RecordShard.open(path)
    pos = shard.offset(3) + 5
    with open(path, "r+b") as f:
        f.seek(pos)
        orig = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([orig ^ 0xFF]))
    shard = RecordShard.open(path)
    with pytest.raises(DataCorruptionError) as ei:
        shard.read(3)
    assert ei.value.key == 3 and ei.value.offset == shard.offset(3)
    assert "a.rec" in str(ei.value)
    # neighbours read clean: corruption is per record
    assert np.array_equal(shard.read(2)[0], recs[2][0])


def test_shard_writer_rejects_non_uint8(tmp_path):
    w = ShardWriter(str(tmp_path / "a.rec"), 1, 2, 2)
    with pytest.raises(DataCorruptionError):
        w.add(np.full((1, 2, 2), 0.5, np.float32), 0)
    w.add(np.zeros((1, 2, 2), np.uint8), 1)
    assert w.close() == 1


def test_garbage_file_is_typed_corruption(tmp_path):
    path = str(tmp_path / "junk.rec")
    with open(path, "wb") as f:
        f.write(b"not a shard at all, far too short?" * 3)
    with pytest.raises(DataCorruptionError):
        RecordShard.open(path)


def test_convert_rolls_shards_and_shardset_replays_in_order(tmp_path):
    recs = _records(10, c=2, h=4, w=4)
    stride = 2 * 4 * 4 + 8
    out = convert_to_shards(iter(recs), str(tmp_path / "s"),
                            shard_bytes=3 * stride)
    assert out["records"] == 10 and len(out["shards"]) > 1
    assert out["geometry"] == (2, 4, 4)
    ss = ShardSet.open(str(tmp_path / "s"))
    assert ss.count == 10
    for i, (img, label) in enumerate(recs):
        shard, j = ss.locate(i)
        got, glabel = shard.read(j)
        assert np.array_equal(img, got) and label == glabel
    assert is_records_source(str(tmp_path / "s"))
    assert not is_records_source(str(tmp_path))
    ss.close()


def test_convert_quarantines_bad_records(tmp_path):
    def stream():
        yield np.zeros((1, 2, 2), np.uint8), 0
        yield np.full((1, 2, 2), 0.5, np.float32), 1   # not representable
        yield np.ones((1, 2, 2), np.uint8), 2

    q = Quarantine(QuarantinePolicy(max_fraction=0.5), epoch_size=3)
    out = convert_to_shards(stream(), str(tmp_path / "s"), quarantine=q)
    assert out["records"] == 2
    assert q.report()["total_bad"] == 1


def test_shardset_verifying_store_reads_bit_exact(tmp_path):
    recs = _records(9)
    convert_to_shards(iter(recs), str(tmp_path / "s"),
                      shard_bytes=4 * STRIDE)
    ss = ShardSet.open(str(tmp_path / "s"), verify=True)
    assert all(isinstance(s.store, VerifyingStore) for s in ss.shards)
    for i, (img, label) in enumerate(recs):
        shard, j = ss.locate(i)
        got, glabel = shard.read(j)
        assert np.array_equal(img, got) and label == glabel
    ss.close()


def test_verifying_store_heals_a_torn_read_and_names_rot(tmp_path):
    """One fresh re-read tells a torn read (heals) from rot (typed error
    with the key and offset); ``checksum_range`` registers a range."""
    payload = bytes(range(256)) * 4
    (tmp_path / "blob").write_bytes(payload)
    inner = LocalStore(str(tmp_path))
    store = VerifyingStore(inner)
    crc = store.checksum_range("blob", 100, 50)
    assert store.open_range("blob", 100, 50) == payload[100:150]
    reads = []

    class Torn(LocalStore):
        def open_range(self, key, offset, length):
            reads.append(offset)
            raw = super().open_range(key, offset, length)
            return raw[::-1] if len(reads) == 1 else raw

    torn = VerifyingStore(Torn(str(tmp_path)), {("blob", 100): crc})
    assert torn.open_range("blob", 100, 50) == payload[100:150]
    assert len(reads) == 2
    store.add_checksum("blob", 200, crc)        # a wrong crc: rot
    with pytest.raises(DataCorruptionError) as ei:
        store.open_range("blob", 200, 50)
    assert ei.value.key == "blob" and ei.value.offset == 200
    store.close()


def test_partitioned_dataset_from_records(tmp_path):
    recs = _records(8)
    convert_to_shards(iter(recs), str(tmp_path / "s"),
                      shard_bytes=3 * STRIDE)
    ds = PartitionedDataset.from_records(str(tmp_path / "s"))
    assert sum(len(p) for p in ds.partitions) == 8
    flat = [r for part in ds.partitions for r in part]
    for (img, label), (gimg, glabel) in zip(recs, flat):
        assert np.array_equal(img, gimg) and label == glabel


def test_local_store_concurrent_ranged_reads(tmp_path):
    blobs = {}
    for k in range(3):
        payload = bytes((k * 17 + i) % 256 for i in range(4096))
        (tmp_path / f"b{k}").write_bytes(payload)
        blobs[f"b{k}"] = payload
    store = LocalStore(str(tmp_path))
    errs = []

    def reader(tid):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(300):
                key = f"b{int(rng.integers(3))}"
                off = int(rng.integers(0, 4000))
                ln = int(rng.integers(1, 96))
                if store.open_range(key, off, ln) != \
                        blobs[key][off:off + ln]:
                    errs.append((tid, key, off, ln))
        except Exception as e:  # noqa: BLE001 (collected for the assert)
            errs.append((tid, repr(e)))

    threads = [threading.Thread(target=reader, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    store.close()


def test_shard_cache_tiers_spill_and_promote(tmp_path):
    cache = ShardCache(max_shards=2, spill_dir=str(tmp_path / "spill"),
                       max_spill=8)
    payloads = {k: bytes([k]) * 64 for k in range(4)}
    for k in range(4):   # 2 and 3 evict 0 and 1 to disk
        assert cache.get(k, lambda k=k: payloads[k]) == payloads[k]
    tiers = cache.tier_counts()
    assert tiers["ram_shards"] == 2 and tiers["disk_shards"] == 2
    assert cache.get(3, lambda: b"wrong") == payloads[3]        # RAM
    assert cache.get(0, lambda: b"wrong") == payloads[0]        # disk
    tiers = cache.tier_counts()
    assert tiers["ram_hits"] == 1
    assert tiers["disk_hits"] == 1
    assert tiers["misses"] == 4
    assert tiers["spills"] >= 3


def test_shard_cache_spill_bound_deletes_oldest(tmp_path):
    cache = ShardCache(max_shards=1, spill_dir=str(tmp_path / "spill"),
                       max_spill=2)
    for k in range(5):
        cache.get(k, lambda k=k: bytes([k]))
    assert cache.tier_counts()["disk_shards"] <= 2
    assert len(os.listdir(str(tmp_path / "spill"))) <= 2
    # the newest evictee (3) is still on disk, the oldest ones are gone
    assert cache.get(3, lambda: b"wrong") == bytes([3])
    assert cache.get(0, lambda: b"again") == b"again"


def test_shard_cache_without_spill_dir_just_evicts():
    cache = ShardCache(max_shards=1, spill_dir="")
    cache.get("a", lambda: b"a")
    cache.get("b", lambda: b"b")
    assert cache.tier_counts()["disk_shards"] == 0
    assert cache.get("a", lambda: b"a2") == b"a2"


def test_shard_cache_knobs(monkeypatch, tmp_path):
    from sparknet_tpu_torch.data.pipeline import (cache_shards,
                                                  cache_spill_dir,
                                                  cache_spill_shards)
    from sparknet_tpu_torch.data.records import (record_readers,
                                                 shard_bytes_target)
    monkeypatch.setenv("SPARKNET_CACHE_SHARDS", "3")
    monkeypatch.setenv("SPARKNET_CACHE_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("SPARKNET_CACHE_SPILL_SHARDS", "5")
    monkeypatch.setenv("SPARKNET_RECORD_READERS", "0")
    monkeypatch.setenv("SPARKNET_RECORD_SHARD_MB", "32")
    assert (cache_shards(), cache_spill_dir(), cache_spill_shards()) == \
        (3, str(tmp_path), 5)
    assert ShardCache().spill_dir == str(tmp_path)
    assert ShardCache().max_shards == 3 and ShardCache(2).max_shards == 2
    assert record_readers() == 0 and shard_bytes_target() == 32 << 20
    monkeypatch.setenv("SPARKNET_RECORD_SHARD_MB", "0")
    with pytest.raises(ValueError, match="SPARKNET_RECORD_SHARD_MB"):
        shard_bytes_target()


# ---------------------------------------------------------------------------
# records_feed against the JAX feeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("corrupt", [False, True])
def test_records_feed_equals_the_jax_records_and_lmdb_feeds(
        tmp_path, monkeypatch, corrupt, workers):
    if corrupt:
        monkeypatch.setenv("SPARKNET_FAULT", "corrupt_record:0.1")
        monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    n, batch, batches = 48, 8, 13       # 13 x 8 > 2 epochs: rolls covered
    recs = _records(n, seed=7)
    lmdb = str(tmp_path / "lmdb")
    _write_lmdb_of(lmdb, recs)
    shards = str(tmp_path / "shards")
    convert_to_shards(iter(recs), shards, shard_bytes=20 * STRIDE)
    _, jlp = _layers(lmdb, batch, "LMDB")
    lp, jrlp = _layers(shards, batch, "RECORDS")

    def quarantine(cls, pol):
        return cls(pol(max_fraction=0.5), epoch_size=n)

    _reset_faults()
    qa = quarantine(JaxQuarantine, JaxPolicy)
    want = _pull(jdb.db_feed(jlp, JaxPhase.TRAIN, seed=0, quarantine=qa,
                             workers=0), batches)
    _reset_faults()
    qj = quarantine(JaxQuarantine, JaxPolicy)
    jrec_batches = _pull(jrec.records_feed(jrlp, JaxPhase.TRAIN, seed=0,
                                           quarantine=qj, workers=workers),
                         batches)
    _reset_faults()
    qp = quarantine(Quarantine, QuarantinePolicy)
    stats = FeedStats()
    got = _pull(records_feed(lp, Phase.TRAIN, seed=0, quarantine=qp,
                             workers=workers, stats=stats), batches)
    _assert_same(got, want)
    _assert_same(got, jrec_batches)
    assert _norm(qp.report()) == _norm(qa.report()) == _norm(qj.report())
    if corrupt:
        assert qp.report()["total_bad"] > 0
        assert any(shards in s for s in qp.report()["by_source"])
    snap = stats.snapshot()
    assert snap["read_s"] > 0 and snap["batches"] == batches


def test_records_feed_raw_ships_the_jax_uint8_batches(tmp_path):
    recs = _records(20, seed=9)
    shards = str(tmp_path / "s")
    convert_to_shards(iter(recs), shards, shard_bytes=6 * STRIDE)
    lp, jlp = _layers(shards, 6, "RECORDS")
    _reset_faults()
    got = _pull(records_feed(lp, Phase.TRAIN, seed=1, raw=True), 5)
    want = _pull(jrec.records_feed(jlp, JaxPhase.TRAIN, seed=1, raw=True), 5)
    _assert_same(got, want)
    assert got[0]["data"].dtype == np.uint8
    assert got[0]["data"].tobytes() == np.stack(
        [r[0] for r in recs[:6]]).tobytes()


def test_db_feed_dispatches_records_backend(tmp_path):
    recs = _records(16, seed=2)
    shards = str(tmp_path / "s")
    convert_to_shards(iter(recs), shards)
    lp, jlp = _layers(shards, 4, "RECORDS",
                      {"crop_size": 6, "mirror": True, "scale": 0.25})
    _reset_faults()
    a = _pull(db_feed(lp, Phase.TRAIN, seed=0), 6)
    _reset_faults()
    b = _pull(records_feed(lp, Phase.TRAIN, seed=0), 6)
    c = _pull(jdb.db_feed(jlp, JaxPhase.TRAIN, seed=0), 6)
    _assert_same(a, b)
    _assert_same(a, c)


def test_records_feed_from_verifying_store_with_tiered_cache(tmp_path):
    recs = _records(24, seed=5)
    shards = str(tmp_path / "s")
    convert_to_shards(iter(recs), shards, shard_bytes=8 * STRIDE)
    lp, _ = _layers(shards, 8, "RECORDS")
    _reset_faults()
    ref = _pull(records_feed(lp, Phase.TRAIN, seed=0, workers=0), 6)
    cache = ShardCache(max_shards=1, spill_dir=str(tmp_path / "spill"),
                       max_spill=8)
    _reset_faults()
    got = _pull(records_feed(lp, Phase.TRAIN, seed=0, workers=2,
                             verify=True, cache=cache), 6)
    _assert_same(got, ref)
    tiers = cache.tier_counts()
    assert tiers["misses"] >= 3               # one cold miss a shard
    assert tiers["ram_hits"] > 0              # locality within a shard
    assert tiers["disk_hits"] > 0             # epoch 2 reads the spill


def test_convert_cli_lmdb_roundtrip(tmp_path, capsys):
    from sparknet_tpu_torch.tools import convert as convert_cli
    recs = _records(12, seed=11)
    db = str(tmp_path / "lmdb")
    _write_lmdb_of(db, recs)
    out_dir = str(tmp_path / "shards")
    assert convert_cli.main(["--source", db, "--out", out_dir]) == 0
    ss = ShardSet.open(out_dir)
    assert ss.count == 12
    for i, (img, label) in enumerate(recs):
        shard, j = ss.locate(i)
        got, glabel = shard.read(j)
        assert np.array_equal(img, got) and label == glabel
    ss.close()


@pytest.mark.parametrize("url", ["s3://bucket/shards", "gs://bucket/shards"])
def test_object_store_urls_name_their_item(url):
    with pytest.raises(NotImplementedError, match="ROADMAP A6, object store"):
        get_store(url)
    with pytest.raises(NotImplementedError, match="ROADMAP A6, object store"):
        ShardSet.open(url)
