"""Read and write LMDB databases without liblmdb.

The port's own copy of ``sparknet_tpu/data/lmdb_io.py`` (:45-321).  The
reference's ``Data`` layer streams serialized ``Datum`` records out of an
LMDB (or LevelDB) environment through a sequential cursor (reference:
caffe/src/caffe/util/db_lmdb.cpp, caffe/src/caffe/data_reader.cpp:62-109).
Neither liblmdb nor py-lmdb is installed where the port runs, so this
module implements the LMDB file format directly:

- ``LmdbReader``: a zero-copy mmap reader.  It parses the meta pages,
  walks the main DB's B+tree in key order and resolves overflow
  (BIGDATA) values; databases written by liblmdb (inline or overflow
  values) read too.
- ``write_lmdb``: a bulk bottom-up writer (sorted keys -> leaf pages ->
  branch levels -> meta).  Values always go to overflow pages (valid
  LMDB; readers follow F_BIGDATA).

Format reference: the stable LMDB on-disk layout (openldap mdb.c):
magic 0xBEEFC0DE, 16-byte page headers, 2-byte in-page node offsets,
branch node pgno packed lo/hi/flags, meta pages 0 and 1.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterable, Iterator

from ..utils.retry import io_retry

MAGIC = 0xBEEFC0DE
VERSION = 1
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
P_LEAF2 = 0x20
F_BIGDATA = 0x01
PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

# MDB_db: md_pad(u32) md_flags(u16) md_depth(u16) branch/leaf/overflow
# pages + entries + root (5 × u64) — 48 bytes
_DB = struct.Struct("<IHHQQQQQ")
# MDB_meta after the page header: magic, version, address, mapsize
_META_HEAD = struct.Struct("<IIQQ")


class LmdbError(Exception):
    pass


def _db_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Sequential (key-ordered) reader over an LMDB main database."""

    def __init__(self, path: str):
        self.path = _db_path(path)
        # the open+mmap is a one-shot control-plane edge (NFS blips on a
        # pod fail it transiently) — bounded retry, SPARKNET_IO_* knobs
        self._f = io_retry(open, self.path, "rb",
                           describe=f"open {self.path}")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            self._f.close()
            raise
        meta = self._pick_meta()
        (self.psize, _flags, self.depth, _b, _l, _o,
         self.entries, self.root) = meta

    def _read_meta(self, byte_off: int):
        off = byte_off + PAGEHDRSZ
        magic, version, _addr, _mapsize = _META_HEAD.unpack_from(
            self._mm, off)
        if magic != MAGIC:
            raise LmdbError(f"bad LMDB magic at {byte_off}: {magic:#x}")
        if version not in (VERSION, 999):
            raise LmdbError(f"unsupported LMDB version {version}")
        off += _META_HEAD.size
        db0 = _DB.unpack_from(self._mm, off)
        db1 = _DB.unpack_from(self._mm, off + _DB.size)
        off += 2 * _DB.size
        _last_pg, txnid = struct.unpack_from("<QQ", self._mm, off)
        psize = db0[0]  # mm_psize aliases mm_dbs[0].md_pad
        return txnid, (psize, db1[1], db1[2], db1[3], db1[4], db1[5],
                       db1[6], db1[7])

    def _pick_meta(self):
        """Meta 0 sits at offset 0; meta 1 at one page — whose size comes
        from meta 0 (liblmdb uses the OS page size, not always 4096).  If
        meta 0 is torn, probe the common page sizes for meta 1."""
        metas = []
        psize_guesses = []
        try:
            m0 = self._read_meta(0)
            metas.append(m0)
            psize_guesses.append(m0[1][0])
        except (LmdbError, struct.error):
            psize_guesses.extend((4096, 8192, 16384, 32768, 65536))
        for psize in psize_guesses:
            try:
                metas.append(self._read_meta(psize))
                break
            except (LmdbError, struct.error, IndexError):
                continue
        if not metas:
            raise LmdbError(f"{self.path}: no valid LMDB meta page")
        return max(metas)[1]

    # -- page accessors ---------------------------------------------------
    def _page(self, pgno: int) -> tuple[int, int, int]:
        """(byte offset, flags, nkeys)."""
        off = pgno * self.psize
        flags, lower = struct.unpack_from("<HH", self._mm, off + 10)
        nkeys = (lower - PAGEHDRSZ) // 2
        return off, flags, nkeys

    def _node(self, page_off: int, idx: int):
        ptr, = struct.unpack_from("<H", self._mm,
                                  page_off + PAGEHDRSZ + 2 * idx)
        noff = page_off + ptr
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mm, noff)
        return noff, lo, hi, flags, ksize

    def _leaf_value(self, noff, lo, hi, flags, ksize) -> bytes:
        dsize = lo | (hi << 16)
        data_off = noff + 8 + ksize
        if flags & F_BIGDATA:
            ovpg, = struct.unpack_from("<Q", self._mm, data_off)
            start = ovpg * self.psize + PAGEHDRSZ
            return bytes(self._mm[start:start + dsize])
        return bytes(self._mm[data_off:data_off + dsize])

    def _walk(self, pgno: int) -> Iterator[tuple[bytes, bytes]]:
        off, flags, nkeys = self._page(pgno)
        if flags & P_LEAF:
            if flags & P_LEAF2:
                raise LmdbError("LEAF2 (dupfixed) pages unsupported")
            for i in range(nkeys):
                noff, lo, hi, nflags, ksize = self._node(off, i)
                key = bytes(self._mm[noff + 8:noff + 8 + ksize])
                yield key, self._leaf_value(noff, lo, hi, nflags, ksize)
        elif flags & P_BRANCH:
            for i in range(nkeys):
                _noff, lo, hi, nflags, _ksize = self._node(off, i)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
        else:
            raise LmdbError(f"unexpected page flags {flags:#x} at {pgno}")

    # -- public API -------------------------------------------------------
    def __len__(self) -> int:
        return self.entries

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        """All (key, value) pairs in key order — the DB cursor loop of
        data_reader.cpp:90-108."""
        if self.root == P_INVALID:
            return
        yield from self._walk(self.root)

    def first(self) -> tuple[bytes, bytes]:
        for kv in self.items():
            return kv
        raise LmdbError("empty database")

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Bulk writer
# ---------------------------------------------------------------------------

def _even(n: int) -> int:
    return n + (n & 1)


def write_lmdb(path: str, items: Iterable[tuple[bytes, bytes]],
               psize: int = 4096) -> int:
    """Write (key, value) pairs as a fresh LMDB environment; returns the
    entry count.  ``path`` is created as a directory holding ``data.mdb``
    (the subdir layout Caffe's db_lmdb.cpp opens).  Keys are sorted —
    LMDB is a B+tree; Caffe's sequential "%08d_..." keys arrive sorted
    already."""
    pairs = sorted(items)
    for k, _ in pairs:
        if len(k) > 511:
            raise LmdbError(f"key too long for LMDB ({len(k)} > 511)")
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "data.mdb")

    pages: list[bytes] = []          # data pages, index = pgno - 2

    def add_page(buf: bytes) -> int:
        pages.append(buf)
        return len(pages) + 1        # pgno (0/1 are meta)

    def page_hdr(pgno: int, flags: int, lower: int, upper: int,
                 overflow_pages: int = 0) -> bytes:
        if flags & P_OVERFLOW:
            return struct.pack("<QHHI", pgno, 0, flags, overflow_pages)
        return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)

    n_overflow = 0

    def write_overflow(value: bytes) -> int:
        nonlocal n_overflow
        npg = max(1, -(-(PAGEHDRSZ + len(value)) // psize))
        first = len(pages) + 2
        buf = page_hdr(first, P_OVERFLOW, 0, 0, npg) + value
        buf += b"\0" * (npg * psize - len(buf))
        for i in range(npg):
            add_page(buf[i * psize:(i + 1) * psize])
        n_overflow += npg
        return first

    # ---- leaf level
    def build_level(nodes: list[tuple[bytes, bytes]], leaf: bool
                    ) -> list[tuple[bytes, int]]:
        """Pack (key, payload) nodes into pages; returns (first key, pgno)
        per page.  Leaf payload = 8-byte overflow pgno (+ size header);
        branch payload = child pgno packed into the node header."""
        out_pages: list[tuple[bytes, int]] = []
        cur: list[bytes] = []
        cur_first: bytes | None = None
        used = 0

        def flush():
            nonlocal cur, cur_first, used
            if not cur:
                return
            pgno = len(pages) + 2
            nptrs = len(cur)
            ptrs = []
            top = psize
            body = bytearray(psize)
            for node in cur:
                top -= _even(len(node))
                ptrs.append(top)
                body[top:top + len(node)] = node
            lower = PAGEHDRSZ + 2 * nptrs
            hdr = page_hdr(pgno, P_LEAF if leaf else P_BRANCH, lower, top)
            body[:PAGEHDRSZ] = hdr
            body[PAGEHDRSZ:PAGEHDRSZ + 2 * nptrs] = struct.pack(
                f"<{nptrs}H", *ptrs)
            add_page(bytes(body))
            out_pages.append((cur_first, pgno))
            cur, cur_first, used = [], None, 0

        for i, (key, payload) in enumerate(nodes):
            if leaf:
                ovpg = write_overflow(payload)
                node = struct.pack("<HHHH", len(payload) & 0xFFFF,
                                  len(payload) >> 16, F_BIGDATA,
                                  len(key)) + key + struct.pack("<Q", ovpg)
            else:
                pgno_child = payload  # int
                node = struct.pack(
                    "<HHHH", pgno_child & 0xFFFF,
                    (pgno_child >> 16) & 0xFFFF,
                    (pgno_child >> 32) & 0xFFFF, len(key)) + key
            need = _even(len(node)) + 2
            if cur and PAGEHDRSZ + used + need > psize:
                flush()
            if not cur:
                cur_first = key
                if not leaf:
                    # leftmost branch node carries an empty key
                    node = struct.pack(
                        "<HHHH", payload & 0xFFFF,
                        (payload >> 16) & 0xFFFF,
                        (payload >> 32) & 0xFFFF, 0)
            cur.append(node)
            used += _even(len(node)) + 2
        flush()
        return out_pages

    depth = 0
    branch_pages = 0
    if pairs:
        level = build_level(pairs, leaf=True)
        leaf_pages = len(level)
        depth = 1
        while len(level) > 1:
            level = build_level([(k, pg) for k, pg in level], leaf=False)
            branch_pages += len(level)
            depth += 1
        root = level[0][1]
    else:
        leaf_pages = 0
        root = P_INVALID

    last_pg = len(pages) + 1
    mapsize = max((last_pg + 1) * psize, 1 << 20)

    def meta(pgno: int) -> bytes:
        buf = page_hdr(pgno, P_META, 0, 0)
        buf += _META_HEAD.pack(MAGIC, VERSION, 0, mapsize)
        buf += _DB.pack(psize, 0, 0, 0, 0, 0, 0, P_INVALID)      # FREE_DBI
        buf += _DB.pack(0, 0, depth, branch_pages, leaf_pages,
                        n_overflow, len(pairs), root)            # MAIN_DBI
        buf += struct.pack("<QQ", last_pg, 1)
        return buf + b"\0" * (psize - len(buf))

    with open(out, "wb") as f:
        f.write(meta(0))
        f.write(meta(1))
        for p in pages:
            f.write(p)
    # lock file so liblmdb-based tools can open the env
    open(os.path.join(path, "lock.mdb"), "wb").close()
    return len(pairs)
