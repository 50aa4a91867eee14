"""The port's DB readers, writers, Datum codec, quarantine and retry
against the JAX package's, on the CPU.

- LMDB: round trips through ``write_lmdb``/``LmdbReader`` (one leaf, a
  tree of several levels with 500-byte keys, values that span several
  overflow pages, an empty DB), each package's DB read by the other key
  for key and byte for byte, and the two writers' ``data.mdb`` equal; a
  torn meta page 0 falls back to meta 1, and both torn raise.
- LevelDB: round trips through ``write_leveldb`` (a log record that spans
  32 KiB blocks); a hand-built sstable with snappy-compressed data
  blocks (literals and overlapping copies) plus a newer log that
  overwrites and deletes keys, read the same by both packages; snappy
  and crc32c against the JAX functions.
- Datums: ``array_to_datum`` writes the JAX bytes for uint8 and float
  images; ``datum_to_array`` returns the JAX arrays; every corruption
  case raises ``DataCorruptionError`` carrying its key in both packages;
  an encoded Datum raises ``NotImplementedError`` naming ROADMAP A15.
- ``Quarantine``: the same budgets, reports and the same record past the
  budget as the JAX class, for several policies; ``from_env``.
- ``retry``: the same backoff schedules as the JAX functions.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import pytest

from sparknet_tpu.data import db as jdb
from sparknet_tpu.data import integrity as jint
from sparknet_tpu.data import leveldb_io as jldb
from sparknet_tpu.data import lmdb_io as jlmdb
from sparknet_tpu.utils import retry as jretry
from sparknet_tpu_torch.data import db
from sparknet_tpu_torch.data import integrity
from sparknet_tpu_torch.data import leveldb_io as ldb
from sparknet_tpu_torch.data import lmdb_io
from sparknet_tpu_torch.utils import retry


def _items(n, key_len=8, value_len=64, seed=0):
    rng = np.random.default_rng(seed)
    return [((b"%08d" % i).ljust(key_len, b"k"),
             rng.integers(0, 256, size=value_len).astype(np.uint8).tobytes())
            for i in range(n)]


LMDB_CASES = {
    "one_leaf": dict(n=5),
    "multi_level": dict(n=120, key_len=500),
    "multi_page_values": dict(n=6, value_len=3 * 4096 + 17),
    "empty": dict(n=0),
}


@pytest.mark.parametrize("case", LMDB_CASES)
def test_lmdb_round_trip_and_cross_package(tmp_path, case):
    items = _items(**LMDB_CASES[case])
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert lmdb_io.write_lmdb(ours, items) == len(items)
    jlmdb.write_lmdb(theirs, items)
    with open(os.path.join(ours, "data.mdb"), "rb") as f, \
            open(os.path.join(theirs, "data.mdb"), "rb") as g:
        assert f.read() == g.read()
    for path in (ours, theirs):
        with lmdb_io.LmdbReader(path) as r, jlmdb.LmdbReader(path) as jr:
            assert len(r) == len(jr) == len(items)
            assert list(r.items()) == list(jr.items()) == sorted(items)
            if case == "multi_level":
                assert r.depth >= 3
            if not items:
                with pytest.raises(lmdb_io.LmdbError):
                    r.first()


def test_lmdb_torn_meta_pages(tmp_path):
    items = _items(10)
    path = str(tmp_path / "db")
    lmdb_io.write_lmdb(path, items)
    mdb = os.path.join(path, "data.mdb")
    with open(mdb, "r+b") as f:
        f.seek(16)
        f.write(b"\0\0\0\0")          # meta page 0's magic
    with lmdb_io.LmdbReader(path) as r:
        assert list(r.items()) == items
    with open(mdb, "r+b") as f:
        f.seek(4096 + 16)
        f.write(b"\0\0\0\0")          # and meta page 1's
    for reader in (lmdb_io.LmdbReader, jlmdb.LmdbReader):
        with pytest.raises(lmdb_io.LmdbError if reader is
                           lmdb_io.LmdbReader else jlmdb.LmdbError,
                           match="no valid LMDB meta page"):
            reader(path)


def test_leveldb_round_trip_and_cross_package(tmp_path):
    # one value larger than a 32 KiB log block: FIRST/MIDDLE/LAST
    items = _items(20) + [(b"zz_big", bytes(range(256)) * 300)]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    assert ldb.write_leveldb(ours, items) == len(items)
    jldb.write_leveldb(theirs, items)
    for name in ("000003.log", "MANIFEST-000002", "CURRENT"):
        with open(os.path.join(ours, name), "rb") as f, \
                open(os.path.join(theirs, name), "rb") as g:
            assert f.read() == g.read(), name
    for path in (ours, theirs):
        r, jr = ldb.LeveldbReader(path), jldb.LeveldbReader(path)
        assert len(r) == len(jr) == len(items)
        assert list(r.items()) == list(jr.items()) == sorted(items)


def _snappy_compress(data: bytes) -> bytes:
    """A raw snappy stream of ``data`` in which every run of one repeated
    4-byte unit becomes a literal and an overlapping 2-byte-offset copy,
    and everything else literals (a long literal takes the 1-byte length
    form)."""
    out = bytearray(ldb._varint_bytes(len(data)))
    pos = 0
    while pos < len(data):
        unit = data[pos:pos + 4]
        run = 4
        while (pos + run + 4 <= len(data) and run < 64
               and data[pos + run:pos + run + 4] == unit):
            run += 4
        if run > 4:
            out += bytes([(4 - 1) << 2]) + unit
            ln = run - 4
            out += bytes([((ln - 1) << 2) | 2]) + struct.pack("<H", 4)
            pos += run
            continue
        lit = data[pos:pos + 100]
        out += bytes([60 << 2, len(lit) - 1]) + lit
        pos += len(lit)
    return bytes(out)


def _block(entries) -> bytes:
    body = bytearray()
    for k, v in entries:
        body += (ldb._varint_bytes(0) + ldb._varint_bytes(len(k))
                 + ldb._varint_bytes(len(v)) + k + v)
    return bytes(body) + struct.pack("<II", 0, 1)


def _write_sstable(path, kvs, seq0=1):
    """A one-data-block table: a snappy data block, a raw index block, an
    empty metaindex and the footer (leveldb table_format.md)."""
    entries = [(k + struct.pack("<Q", ((seq0 + i) << 8) | 1), v)
               for i, (k, v) in enumerate(kvs)]
    data = _snappy_compress(_block(entries))
    out = bytearray(data + b"\x01" + b"\0" * 4)
    handle = ldb._varint_bytes(0) + ldb._varint_bytes(len(data))
    meta_off = len(out)
    meta = struct.pack("<I", 0)
    out += meta + b"\0" * 5
    idx_off = len(out)
    index = _block([(entries[-1][0], handle)])
    out += index + b"\0" * 5
    footer = (ldb._varint_bytes(meta_off) + ldb._varint_bytes(len(meta))
              + ldb._varint_bytes(idx_off) + ldb._varint_bytes(len(index)))
    out += footer.ljust(40, b"\0") + struct.pack("<Q", ldb.TABLE_MAGIC)
    with open(path, "wb") as f:
        f.write(out)


def test_leveldb_sstable_snappy_and_newer_log(tmp_path):
    path = str(tmp_path / "ldb")
    os.makedirs(path)
    kvs = [(b"k%03d" % i, (b"abcd" * (i + 3)) + bytes([i]) * 70)
           for i in range(12)]
    _write_sstable(os.path.join(path, "000005.ldb"), kvs)
    # a newer log: k003 overwritten, k004 deleted, k999 added
    batch = struct.pack("<QI", 100, 3)
    batch += bytes([1]) + ldb._varint_bytes(4) + b"k003" \
        + ldb._varint_bytes(3) + b"new"
    batch += bytes([0]) + ldb._varint_bytes(4) + b"k004"
    batch += bytes([1]) + ldb._varint_bytes(4) + b"k999" \
        + ldb._varint_bytes(1) + b"z"
    ldb._write_log(os.path.join(path, "000006.log"), [batch])
    want = dict(kvs)
    want[b"k003"] = b"new"
    del want[b"k004"]
    want[b"k999"] = b"z"
    got = list(ldb.LeveldbReader(path).items())
    assert got == sorted(want.items())
    assert got == list(jldb.LeveldbReader(path).items())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snappy_and_crc32c_match_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    raw = (b"xyzw" * int(rng.integers(2, 16))
           + rng.integers(0, 256, size=int(rng.integers(1, 300)))
           .astype(np.uint8).tobytes())
    comp = _snappy_compress(raw)
    assert ldb.snappy_decompress(comp) == jldb.snappy_decompress(comp) == raw
    with pytest.raises(ldb.LeveldbError, match="length mismatch"):
        ldb.snappy_decompress(ldb._varint_bytes(len(raw) + 1) + comp[
            len(ldb._varint_bytes(len(raw))):])
    want = jldb._crc32c(raw)
    assert ldb._crc32c(raw) == want
    monkeypatch.setattr(ldb, "_gcrc", None)   # the pure-Python table
    assert ldb._crc32c(raw) == want
    assert ldb._crc32c(b"123456789") == 0xE3069283   # the CRC-32C check


DATUM_IMAGES = {
    "uint8": lambda rng: rng.integers(0, 256, (3, 5, 4)).astype(np.uint8),
    "integral_float": lambda rng: rng.integers(0, 256, (1, 3, 3))
    .astype(np.float32),
    "float": lambda rng: rng.normal(size=(2, 3, 4)).astype(np.float32),
}


@pytest.mark.parametrize("kind", DATUM_IMAGES)
def test_datum_codec_matches_jax(kind):
    img = DATUM_IMAGES[kind](np.random.default_rng(3))
    raw = db.array_to_datum(img, 7)
    assert raw == jdb.array_to_datum(img, 7)
    arr, label = db.datum_to_array(raw)
    jarr, jlabel = jdb.datum_to_array(raw)
    assert label == jlabel == 7
    assert arr.dtype == jarr.dtype == np.float32
    np.testing.assert_array_equal(arr, jarr)
    np.testing.assert_array_equal(arr, img.astype(np.float32))


def _datum(**fields) -> bytes:
    from sparknet_tpu_torch.proto.textformat import PMessage
    from sparknet_tpu_torch.proto.wireformat import encode
    m = PMessage()
    for k, v in fields.items():
        for x in (v if isinstance(v, list) else [v]):
            m.add(k, x)
    return encode(m, "Datum")


GOOD = _datum(channels=1, height=2, width=3, data=bytes(range(6)), label=1)
CORRUPT = {
    "truncated": GOOD[:-3],
    "garbage": b"\xff\xff\xff\xff\xff\xff",
    "payload_short": _datum(channels=1, height=2, width=3,
                            data=bytes(range(5))),
    "payload_long": _datum(channels=3, height=2, width=3,
                           data=bytes(range(6))),
    "zero_geometry": _datum(channels=0, height=2, width=3,
                            data=bytes(range(6))),
    "float_count": _datum(channels=1, height=2, width=2,
                          float_data=[1.0, 2.0, 3.0]),
}


@pytest.mark.parametrize("case", CORRUPT)
def test_corrupt_datums_raise_with_key(case):
    raw = CORRUPT[case]
    with pytest.raises(integrity.DataCorruptionError) as ours:
        db.datum_to_array(raw, key=b"00000042", source="src")
    with pytest.raises(jint.DataCorruptionError) as theirs:
        jdb.datum_to_array(raw, key=b"00000042", source="src")
    assert ours.value.key == theirs.value.key == b"00000042"
    assert ours.value.source == "src"
    assert "key=b'00000042'" in str(ours.value)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("height,width", [(0, 0), (8, 8)])
def test_undecodable_encoded_datum_raises_as_jax(height, width):
    """A 4-byte JPEG start is an undecodable encoded Datum: both packages
    raise ``DataCorruptionError`` naming its key (at its own size through
    PIL, sized through libjpeg), on the CPU."""
    raw = _datum(channels=3, height=height, width=width,
                 data=b"\xff\xd8\xff\xe0", encoded=True)
    with pytest.raises(integrity.DataCorruptionError) as ours:
        db.datum_to_array(raw, key=b"k", source="src", device="cpu")
    with pytest.raises(jint.DataCorruptionError) as theirs:
        jdb.datum_to_array(raw, key=b"k", source="src")
    assert ours.value.key == theirs.value.key == b"k"
    assert str(ours.value).split(":")[0] == str(theirs.value).split(":")[0]


POLICIES = [(0.0, 0, 10), (0.0, 2, 10), (0.25, 0, 10), (0.1, 1, 40),
            (0.5, 3, None)]


@pytest.mark.parametrize("fraction,records,epoch", POLICIES)
def test_quarantine_matches_jax(fraction, records, epoch):
    q = integrity.Quarantine(integrity.QuarantinePolicy(fraction, records),
                             epoch_size=epoch, source="db")
    jq = jint.Quarantine(jint.QuarantinePolicy(fraction, records),
                         epoch_size=epoch, source="db")
    assert q.budget == jq.budget
    for i in range(20):
        if i == 7:
            q.start_epoch()
            jq.start_epoch()
        err = integrity.DataCorruptionError("bad", key=i, offset=i)
        jerr = jint.DataCorruptionError("bad", key=i, offset=i)
        try:
            jq.admit(jerr, source="a" if i % 2 else None)
        except jint.QuarantineExceeded as e:
            with pytest.raises(integrity.QuarantineExceeded) as ours:
                q.admit(err, source="a" if i % 2 else None)
            assert ours.value.report == e.report
            assert str(ours.value) == str(e)
            break
        q.admit(err, source="a" if i % 2 else None)
        assert q.report() == jq.report()
    else:
        pytest.fail("no policy here absorbs 20 bad records an epoch")


def test_quarantine_policy_from_env_and_bounds():
    env = {"SPARKNET_QUARANTINE_FRACTION": "0.2",
           "SPARKNET_QUARANTINE_RECORDS": "3"}
    assert integrity.QuarantinePolicy.from_env(env) == \
        integrity.QuarantinePolicy(0.2, 3)
    assert integrity.QuarantinePolicy.from_env(env).budget(10) == \
        jint.QuarantinePolicy.from_env(env).budget(10) == 5
    for bad in (dict(max_fraction=1.5), dict(max_records=-1)):
        with pytest.raises(ValueError):
            integrity.QuarantinePolicy(**bad)
    assert integrity.crc32(b"abc") == jint.crc32(b"abc")


@pytest.mark.parametrize("attempts,base", [(1, 0.1), (5, 0.05), (12, 1.0)])
def test_backoff_delays_match_jax(attempts, base):
    """The JAX schedule at its defaults (factor 2, cap 30 s, no jitter);
    12 tries from 1 s reach the cap."""
    ours = list(retry.backoff_delays(attempts, base))
    theirs = list(jretry.backoff_delays(attempts, base))
    assert ours == theirs and len(ours) == attempts - 1


def test_retry_call_and_io_retry(monkeypatch):
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    assert retry.retry_call(flaky, attempts=3, base_delay=0.5,
                            sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 1.0]
    with pytest.raises(OSError):
        retry.retry_call(lambda: (_ for _ in ()).throw(OSError("x")),
                         attempts=2, sleep=lambda s: None)
    with pytest.raises(ValueError):
        retry.retry_call(flaky, attempts=0)
    monkeypatch.setenv("SPARKNET_IO_RETRIES", "1")
    with pytest.raises(FileNotFoundError):
        retry.io_retry(open, "/nonexistent/db/data.mdb", "rb")
