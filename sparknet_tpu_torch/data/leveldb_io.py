"""Read and write LevelDB databases without libleveldb.

The port's own copy of ``sparknet_tpu/data/leveldb_io.py`` (:34-368).
The reference's ``Data`` layer supports ``backend: LEVELDB`` (reference:
caffe/src/caffe/util/db_leveldb.cpp; the default of caffe.proto's
DataParameter).  Neither libleveldb, plyvel nor snappy is installed where
the port runs, so this module parses the on-disk format directly:

- SSTable files (``*.ldb``/``*.sst``): footer -> index block -> data
  blocks, block entries with shared-prefix encoding, snappy or raw
  blocks.
- Write-ahead logs (``*.log``): 32 KiB blocks of FULL/FIRST/MIDDLE/LAST
  fragments carrying write batches (Caffe's last records usually live
  here: db_leveldb just Put()s and closes, so the memtable is only in
  the log).
- A raw-snappy decompressor (literal and copy tags) for compressed
  blocks.

Simplification against leveldb: instead of replaying MANIFEST version
edits, ``LeveldbReader`` scans every table and log file and keeps the
highest-sequence entry per key.  For Caffe-written datasets (written
once, no overwrites) this is exact.  CRCs are not verified on read; the
writer computes real crc32c so that leveldb can verify them.
"""

from __future__ import annotations

import glob
import os
import struct
from typing import Iterator

TABLE_MAGIC = 0xDB4775248B80FB57
TYPE_DELETION, TYPE_VALUE = 0, 1


class LeveldbError(Exception):
    pass


def _varint(buf, pos: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def snappy_decompress(data) -> bytes:
    """Raw (non-framed) snappy, as used for LevelDB blocks."""
    ulen, pos = _varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                nb = ln - 60
                ln = int.from_bytes(data[pos:pos + nb], "little") + 1
                pos += nb
            out += data[pos:pos + ln]
            pos += ln
        else:
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos:pos + 2], "little")
                pos += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos:pos + 4], "little")
                pos += 4
            if off == 0 or off > len(out):
                raise LeveldbError("corrupt snappy copy")
            while ln > 0:  # copies may overlap (run-length style)
                chunk = min(ln, off)
                start = len(out) - off
                out += out[start:start + chunk]
                ln -= chunk
    if len(out) != ulen:
        raise LeveldbError(
            f"snappy length mismatch: {len(out)} != {ulen}")
    return bytes(out)


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Block contents + 1-byte type + 4-byte crc (crc unverified)."""
    raw = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return raw
    if ctype == 1:
        return snappy_decompress(raw)
    raise LeveldbError(f"unknown block compression {ctype}")


def _block_entries(block: bytes) -> Iterator[tuple[bytes, bytes]]:
    """Decode shared-prefix entries; the restart array sits at the tail."""
    if len(block) < 4:
        return
    n_restarts, = struct.unpack_from("<I", block, len(block) - 4)
    end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + vlen]
        pos += vlen


def _read_sstable(path: str) -> Iterator[tuple[bytes, int, int, bytes]]:
    """Yield (user_key, sequence, type, value) from one table file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 48:
        raise LeveldbError(f"{path}: truncated table")
    footer = data[-48:]
    magic, = struct.unpack_from("<Q", footer, 40)
    if magic != TABLE_MAGIC:
        raise LeveldbError(f"{path}: bad table magic {magic:#x}")
    pos = 0
    _mi_off, pos = _varint(footer, pos)
    _mi_size, pos = _varint(footer, pos)
    idx_off, pos = _varint(footer, pos)
    idx_size, pos = _varint(footer, pos)
    index = _read_block(data, idx_off, idx_size)
    for _last_key, handle in _block_entries(index):
        hpos = 0
        b_off, hpos = _varint(handle, hpos)
        b_size, hpos = _varint(handle, hpos)
        block = _read_block(data, b_off, b_size)
        for ikey, value in _block_entries(block):
            if len(ikey) < 8:
                raise LeveldbError(f"{path}: internal key too short")
            trailer, = struct.unpack_from("<Q", ikey, len(ikey) - 8)
            yield ikey[:-8], trailer >> 8, trailer & 0xFF, value


def _read_log(path: str) -> Iterator[tuple[bytes, int, int, bytes]]:
    """Yield (user_key, sequence, type, value) from a write-ahead log."""
    BLOCK = 32768
    with open(path, "rb") as f:
        data = f.read()
    record = bytearray()
    pos = 0
    while pos + 7 <= len(data):
        block_left = BLOCK - (pos % BLOCK)
        if block_left < 7:
            pos += block_left  # trailer padding
            continue
        _crc, length, rtype = struct.unpack_from("<IHB", data, pos)
        pos += 7
        if rtype == 0 and length == 0:
            break  # zeroed tail
        frag = data[pos:pos + length]
        pos += length
        if rtype == 1:        # FULL
            record = bytearray(frag)
        elif rtype == 2:      # FIRST
            record = bytearray(frag)
            continue
        elif rtype == 3:      # MIDDLE
            record += frag
            continue
        elif rtype == 4:      # LAST
            record += frag
        else:
            raise LeveldbError(f"{path}: bad log record type {rtype}")
        yield from _decode_batch(bytes(record))
        record = bytearray()


def _decode_batch(batch: bytes) -> Iterator[tuple[bytes, int, int, bytes]]:
    if len(batch) < 12:
        return
    seq, count = struct.unpack_from("<QI", batch, 0)
    pos = 12
    for i in range(count):
        t = batch[pos]
        pos += 1
        klen, pos = _varint(batch, pos)
        key = batch[pos:pos + klen]
        pos += klen
        if t == TYPE_VALUE:
            vlen, pos = _varint(batch, pos)
            value = batch[pos:pos + vlen]
            pos += vlen
        else:
            value = b""
        yield key, seq + i, t, value


class LeveldbReader:
    """Key-ordered reader over a LevelDB directory: a lazy heap-merge of
    the (sorted) sstables with the logs' memtable contents, newest sequence
    per key winning.  Only the logs are materialized up front — they hold
    at most a memtable's worth of recent writes; table blocks stream on
    demand, so ``first()`` (shape peeking) never scans the whole DB."""

    def __init__(self, path: str):
        if not os.path.isdir(path):
            raise LeveldbError(f"{path}: not a LevelDB directory")
        self.path = path
        self._tables = sorted(glob.glob(os.path.join(path, "*.ldb"))
                              + glob.glob(os.path.join(path, "*.sst")))
        log_entries: list[tuple[bytes, int, int, bytes]] = []
        for p in sorted(glob.glob(os.path.join(path, "*.log"))):
            log_entries.extend(_read_log(p))
        log_entries.sort(key=lambda e: (e[0], -e[1]))
        self._log_entries = log_entries
        self._len: int | None = None

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        import heapq
        sources = [_read_sstable(p) for p in self._tables]
        sources.append(iter(self._log_entries))
        # order by (key, -seq): the first entry of each key group wins
        merged = heapq.merge(*sources, key=lambda e: (e[0], -e[1]))
        current: bytes | None = None
        for key, _seq, t, value in merged:
            if key == current:
                continue  # older version of the same key
            current = key
            if t == TYPE_VALUE:
                yield key, value

    def __len__(self) -> int:
        if self._len is None:
            self._len = sum(1 for _ in self.items())
        return self._len

    def first(self) -> tuple[bytes, bytes]:
        for kv in self.items():
            return kv
        raise LeveldbError("empty database")

    def close(self) -> None:
        self._tables = []
        self._log_entries = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# A log-only writer: enough for tests and small datasets.
# A log-only DB is exactly what leveldb leaves behind after Put()s with no
# compaction — any real leveldb (and this reader) recovers it.
# ---------------------------------------------------------------------------

_CRC32C_TABLE: list[int] | None = None

try:  # a native implementation where installed (GB/s against ~8 MB/s)
    import google_crc32c as _gcrc
except ImportError:
    _gcrc = None


def _crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli, reflected poly 0x82F63B78) — the checksum real
    leveldb verifies during log recovery."""
    if _gcrc is not None:
        return _gcrc.extend(crc, bytes(data))
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """leveldb's crc mask (util/crc32c.h Mask)."""
    c = _crc32c(data)
    return ((((c >> 15) | (c << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _write_log(path: str, records) -> None:
    """leveldb log_format: 32 KiB blocks of crc-checked
    FULL/FIRST/MIDDLE/LAST fragments (db/log_writer.cc)."""
    BLOCK = 32768
    with open(path, "wb") as f:
        written = 0
        for record in records:
            pos = 0
            first = True
            while True:
                left = BLOCK - (written % BLOCK)
                if left < 7:
                    f.write(b"\0" * left)
                    written += left
                    left = BLOCK
                frag = record[pos:pos + left - 7]
                pos += len(frag)
                last = pos >= len(record)
                rtype = 1 if (first and last) else (
                    2 if first else (4 if last else 3))
                crc = _masked_crc(bytes([rtype]) + frag)
                f.write(struct.pack("<IHB", crc, len(frag), rtype) + frag)
                written += 7 + len(frag)
                first = False
                if last:
                    break


def _varint_bytes(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def write_leveldb(path: str, items) -> int:
    """Write items as a log-only LevelDB: CURRENT, a MANIFEST holding one
    valid VersionEdit (comparator + log/file numbers + last sequence;
    db/version_edit.cc tags), and one write-ahead .log with real
    crc32c-checked records — a log-only DB is exactly what leveldb leaves
    behind after Put()s with no compaction, so recovery replays the log.
    Format-correct per leveldb's log_format.md/version_edit.cc (this
    module's reader round-trips it)."""
    os.makedirs(path, exist_ok=True)
    n = 0

    def batches():
        nonlocal n
        seq = 1
        for key, value in items:
            body = (struct.pack("<QI", seq, 1) + bytes([TYPE_VALUE])
                    + _varint_bytes(len(key)) + key
                    + _varint_bytes(len(value)) + value)
            yield body
            seq += 1
            n += 1

    _write_log(os.path.join(path, "000003.log"), batches())
    comparator = b"leveldb.BytewiseComparator"
    edit = (_varint_bytes(1) + _varint_bytes(len(comparator)) + comparator
            + _varint_bytes(2) + _varint_bytes(3)    # kLogNumber = 3
            + _varint_bytes(3) + _varint_bytes(4)    # kNextFileNumber = 4
            + _varint_bytes(4) + _varint_bytes(n))   # kLastSequence
    _write_log(os.path.join(path, "MANIFEST-000002"), [edit])
    with open(os.path.join(path, "CURRENT"), "w") as f:
        f.write("MANIFEST-000002\n")
    return n
