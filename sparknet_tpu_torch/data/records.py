"""Pre-decoded record shards: the convert-once storage format.

The port's own copy of ``sparknet_tpu/data/records.py``.  Decoding the
same bytes every epoch is the feed's largest host cost; Caffe's answer
(convert_imageset writes decoded records once, arXiv 1408.5093) and
Caffe con Troll's (the data path's memory traffic sets end-to-end
throughput, arXiv 1504.04343) are the same, and this module is the
convert-once half:

- **Shard format v1**: a versioned container of uint8 crop-ready (C,H,W)
  pixel blocks and i64 labels at a fixed stride, so record ``i`` lives
  at a computable offset and is one ranged read
  (``ObjectStore.open_range``), no index, no decode.  A per-record crc32
  table sits between the header and the records, read whole at open
  time; it is also the checksum registry of
  ``objectstore.VerifyingStore``.

  ::

      [ 64 B header | count x u32 crc table | count x stride records ]
      header: magic "SPRKREC\\x01", version, count, (c, h, w),
              label bytes, stride, crc(table), crc(header)
      record: c*h*w uint8 pixels ++ i64-LE label   (stride bytes)

- :class:`ShardWriter` / :func:`write_shard`: the streaming writer
  (placeholder header and table, patched on close), used by
  ``tools/convert.py``.
- :class:`RecordShard`: the reader over any ``ObjectStore``; it keeps
  the ``__len__``/``__getitem__`` lazy-partition contract, so a shard is
  a ``PartitionedDataset`` partition, and it composes with the tiered
  ``pipeline.ShardCache`` (RAM, then the local-disk spill, then the
  store).  :class:`ShardSet`: the ordered shards of one source.
- :func:`records_feed`: ``db_feed``'s batch stream without the decode:
  pulls (the fault injector's ``corrupt_record`` coin, the quarantine's
  epoch roll) stay serial on the consumer thread, so the stream equals
  the serial LMDB stream the shards were converted from, bit for bit;
  the ranged reads run on the port's ``DecodePool``.  ``raw=True``
  ships the uint8 pixels untransformed.
- :func:`convert_to_shards`: the library half of ``tools/convert.py``.

Knobs: ``SPARKNET_RECORD_READERS`` (the ranged-read pool's width, default
``SPARKNET_FEED_WORKERS``; 0 takes one thread, the same ordered stream),
``SPARKNET_RECORD_SHARD_MB`` (the converter's shard size).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Any, Iterable, Iterator

import numpy as np

from ..utils import faults, knobs
from .integrity import DataCorruptionError, Quarantine, QuarantinePolicy, crc32
from .objectstore import ObjectStore, VerifyingStore, get_store

MAGIC = b"SPRKREC\x01"
VERSION = 1
HEADER_SIZE = 64
LABEL_BYTES = 8
SHARD_SUFFIX = ".rec"

# magic(8s) version(u32) flags(u32) count(u64) c(u32) h(u32) w(u32)
# label_bytes(u32) stride(u64) table_crc(u32) — header_crc(u32) follows,
# covering everything before it; the tail pads to HEADER_SIZE
_HEADER = struct.Struct("<8sIIQIIIIQI")
_LABEL = struct.Struct("<q")


def record_readers() -> int:
    """Ranged-read pool width: ``SPARKNET_RECORD_READERS``, else the
    decode-pool default (``SPARKNET_FEED_WORKERS``).  0, the JAX
    package's serial path, takes one thread here."""
    raw = knobs.raw("SPARKNET_RECORD_READERS", "")
    if not raw:
        from .pipeline import feed_workers
        return feed_workers()
    n = int(raw)
    if n < 0:
        raise ValueError(f"SPARKNET_RECORD_READERS must be >= 0, got {n}")
    return n


def shard_bytes_target() -> int:
    """Converter shard-size target in bytes (``SPARKNET_RECORD_SHARD_MB``,
    default 64 MB) — big enough that sequential streaming amortizes the
    per-object open, small enough that one shard is a cache unit."""
    mb = knobs.get_int("SPARKNET_RECORD_SHARD_MB", 64)
    if mb < 1:
        raise ValueError(f"SPARKNET_RECORD_SHARD_MB must be >= 1, got {mb}")
    return mb * (1 << 20)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class ShardWriter:
    """Streaming shard writer: records append sequentially, the header
    and crc table are patched on :meth:`close` (one seek-back — the file
    is invalid until closed, by construction, so a torn write can never
    parse as a short-but-valid shard)."""

    def __init__(self, path: str, c: int, h: int, w: int,
                 capacity: int | None = None):
        if min(c, h, w) <= 0:
            raise ValueError(f"impossible geometry ({c}, {h}, {w})")
        self.path = path
        self.c, self.h, self.w = int(c), int(h), int(w)
        self.stride = self.c * self.h * self.w + LABEL_BYTES
        self.capacity = capacity
        self._crcs: list[int] = []
        self._f = open(path, "wb")
        self._f.write(b"\0" * HEADER_SIZE)      # patched on close
        if capacity:                            # table placeholder
            self._f.write(b"\0" * (4 * capacity))
        self._closed = False

    @property
    def count(self) -> int:
        return len(self._crcs)

    @property
    def nbytes(self) -> int:
        """Record bytes written so far (the converter's roll trigger)."""
        return self.count * self.stride

    def add(self, img: np.ndarray, label: int) -> None:
        """Append one (C,H,W) uint8 image + label.  Float inputs that
        hold exact uint8 values (the decode path's 0–255 f32) are cast
        losslessly; anything else is a typed error — the format stores
        pre-decoded uint8 pixels, nothing lossier."""
        if self._closed:
            raise RuntimeError(f"{self.path}: writer is closed")
        if self.capacity is not None and self.count >= self.capacity:
            raise RuntimeError(
                f"{self.path}: shard capacity {self.capacity} exceeded")
        img = np.asarray(img)
        if img.shape != (self.c, self.h, self.w):
            raise DataCorruptionError(
                f"record shape {img.shape} != shard geometry "
                f"({self.c}, {self.h}, {self.w})", source=self.path)
        if img.dtype != np.uint8:
            as_u8 = img.astype(np.uint8)
            if not np.array_equal(as_u8.astype(img.dtype), img):
                raise DataCorruptionError(
                    "record is not uint8-representable (float pixels "
                    "outside exact 0..255) — shard format v1 stores "
                    "pre-decoded uint8", source=self.path)
            img = as_u8
        block = (np.ascontiguousarray(img).tobytes()
                 + _LABEL.pack(int(label)))
        self._crcs.append(crc32(block))
        self._f.write(block)

    def close(self) -> int:
        """Finalize: write the crc table and the validated header;
        returns the record count."""
        if self._closed:
            return self.count
        self._closed = True
        try:
            if self.capacity is not None and self.count > self.capacity:
                raise RuntimeError("capacity bookkeeping corrupted")
            table = np.asarray(self._crcs, "<u4").tobytes()
            if self.capacity is None:
                # table goes where the placeholder wasn't: rewrite the
                # records after it (small shards; the converter passes
                # capacity for the streaming path)
                self._f.flush()
                with open(self.path, "rb") as rf:
                    rf.seek(HEADER_SIZE)
                    body = rf.read()
                self._f.seek(HEADER_SIZE)
                self._f.write(table)
                self._f.write(body)
            else:
                pad = b"\0" * (4 * (self.capacity - self.count))
                self._f.seek(HEADER_SIZE)
                self._f.write(table + pad)
                table = table + pad
            head = _HEADER.pack(MAGIC, VERSION, 0, self.count,
                                self.c, self.h, self.w, LABEL_BYTES,
                                self.stride, crc32(table))
            head += struct.pack("<I", crc32(head))
            self._f.seek(0)
            self._f.write(head.ljust(HEADER_SIZE, b"\0"))
        finally:
            self._f.close()
        return self.count

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_shard(path: str, records: Iterable[tuple[np.ndarray, int]]) -> int:
    """Write an iterable of (img, label) as one shard; geometry comes
    from the first record.  Returns the record count."""
    it = iter(records)
    try:
        img, label = next(it)
    except StopIteration:
        raise ValueError(f"{path}: cannot write an empty shard") from None
    w = ShardWriter(path, *np.asarray(img).shape)
    with w:
        w.add(img, label)
        for img, label in it:
            w.add(img, label)
    return w.count


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _parse_header(raw: bytes, source: str) -> tuple:
    if len(raw) < HEADER_SIZE:
        raise DataCorruptionError(
            f"shard header truncated ({len(raw)} < {HEADER_SIZE} bytes)",
            source=source, offset=0)
    (magic, version, _flags, count, c, h, w, label_bytes, stride,
     table_crc) = _HEADER.unpack_from(raw, 0)
    if magic != MAGIC:
        raise DataCorruptionError(
            f"bad shard magic {magic!r}", source=source, offset=0)
    (header_crc,) = struct.unpack_from("<I", raw, _HEADER.size)
    if crc32(raw[:_HEADER.size]) != header_crc:
        raise DataCorruptionError(
            "shard header checksum mismatch", source=source, offset=0)
    if version != VERSION:
        raise DataCorruptionError(
            f"unsupported shard version {version}", source=source, offset=0)
    if (label_bytes != LABEL_BYTES or min(c, h, w) <= 0
            or stride != c * h * w + LABEL_BYTES):
        raise DataCorruptionError(
            f"inconsistent shard geometry c={c} h={h} w={w} "
            f"stride={stride}", source=source, offset=0)
    return count, c, h, w, stride, table_crc


class RecordShard:
    """Reader over one shard in an :class:`ObjectStore`.

    The header and crc table are read once at construction (two small
    ranged reads); after that ``read(i)`` is exactly one ranged read of
    ``stride`` bytes, crc-validated against the table.  Thread-safe for
    concurrent readers (the parallel ranged-read pool) as long as the
    backing store's ``open_range`` is — ``LocalStore`` uses per-call
    ``os.pread`` on a refcounted fd pool for exactly this.

    Satisfies ``__len__``/``__getitem__``, so a shard can stand directly
    as a ``PartitionedDataset`` partition (decode-free lazy records) and
    compose with ``PartitionedDataset.cached()``.

    ``attach_cache``: an optional tiered ``pipeline.ShardCache`` holding
    whole-shard pixel blobs — a cold shard streams from the store in ONE
    big ranged read (wire speed, not one blocking read per record), a
    warm one serves every record from host RAM, and RAM evictions spill
    to local-disk files instead of falling back to the origin store.
    """

    def __init__(self, store: ObjectStore, key: str,
                 source: str | None = None):
        self.store = store
        self.key = key
        self.source = source or key
        head = store.open_range(key, 0, HEADER_SIZE)
        (self.count, self.c, self.h, self.w, self.stride,
         table_crc) = _parse_header(head, self.source)
        table = store.open_range(key, HEADER_SIZE, 4 * self.count)
        if len(table) != 4 * self.count or crc32(table) != table_crc:
            raise DataCorruptionError(
                f"shard crc table corrupt ({len(table)} bytes)",
                source=self.source, offset=HEADER_SIZE)
        self.crcs = np.frombuffer(table, "<u4").copy()
        self.data_off = HEADER_SIZE + 4 * self.count
        self._cache = None
        self._cache_key: Any = None

    @classmethod
    def open(cls, path: str) -> "RecordShard":
        """Open a local shard file (a LocalStore rooted at its dir)."""
        from .objectstore import LocalStore
        root, name = os.path.split(os.path.abspath(path))
        return cls(LocalStore(root), name, source=path)

    # -- integrity plumbing ----------------------------------------------
    def register_checksums(self, vstore: VerifyingStore,
                           key: str | None = None) -> int:
        """Register every record block's crc32 with a VerifyingStore so
        its ranged reads become self-verifying (torn-read retry + typed
        corruption with byte-offset attribution).  Returns the count."""
        key = key or self.key
        for i in range(self.count):
            vstore.add_checksum(key, self.offset(i), int(self.crcs[i]))
        return self.count

    def attach_cache(self, cache, key: Any = None) -> None:
        """Serve ``read_raw`` through a tiered ``ShardCache`` of
        whole-shard pixel blobs (see class docstring)."""
        self._cache = cache
        self._cache_key = key if key is not None else self.source

    # -- record access ----------------------------------------------------
    def offset(self, i: int) -> int:
        return self.data_off + i * self.stride

    def _load_blob(self) -> bytes:
        # The whole-region read skips the store's range-checksum tier:
        # that registry is keyed per record block, and a blob read at
        # data_off would collide with record 0's entry.  Integrity is
        # not weakened — unpack() crc-validates every slice of the blob
        # against the in-shard table.
        store = self.store
        if isinstance(store, VerifyingStore):
            from ..utils.retry import io_retry
            return io_retry(store.inner.open_range, self.key,
                            self.data_off, self.count * self.stride,
                            describe=f"shard blob {self.key}")
        return store.open_range(self.key, self.data_off,
                                self.count * self.stride)

    def read_raw(self, i: int) -> bytes:
        """Record ``i``'s block bytes — one ranged read (or a slice of
        the cached whole-shard blob), NOT yet crc-validated; pair with
        :meth:`unpack`."""
        if not 0 <= i < self.count:
            raise IndexError(f"record {i} out of range [0, {self.count})")
        if self._cache is not None:
            blob = self._cache.get(self._cache_key, self._load_blob)
            off = i * self.stride
            return bytes(blob[off:off + self.stride])
        return self.store.open_range(self.key, self.offset(i), self.stride)

    def unpack(self, raw: bytes, i: int) -> tuple[np.ndarray, int]:
        """Validate + unpack one record block: crc against the table,
        then a zero-decode frombuffer view copy.  Corruption raises
        :class:`DataCorruptionError` with source/key/offset attribution
        (the quarantine layer's admission unit)."""
        if len(raw) != self.stride or crc32(raw) != int(self.crcs[i]):
            raise DataCorruptionError(
                f"record block checksum mismatch "
                f"({len(raw)}/{self.stride} bytes)",
                source=self.source, key=i, offset=self.offset(i))
        img = np.frombuffer(raw, np.uint8,
                            count=self.stride - LABEL_BYTES).reshape(
                                self.c, self.h, self.w)
        (label,) = _LABEL.unpack_from(raw, self.stride - LABEL_BYTES)
        return img, label

    def read(self, i: int) -> tuple[np.ndarray, int]:
        return self.unpack(self.read_raw(i), i)

    # -- lazy-partition contract -----------------------------------------
    def __len__(self) -> int:
        return self.count

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self.read(i) for i in range(*idx.indices(self.count))]
        return self.read(int(idx))

    def __iter__(self):
        return (self.read(i) for i in range(self.count))


class ShardSet:
    """An ordered set of shards behind one feed: cumulative indexing
    (``locate`` maps a dataset ordinal to (shard, local index)), one
    shared store, optional VerifyingStore wrap with every shard's crc
    table pre-registered."""

    def __init__(self, shards: list[RecordShard], source: str):
        if not shards:
            raise ValueError(f"{source}: no record shards found")
        self.shards = shards
        self.source = source
        geo = {(s.c, s.h, s.w) for s in shards}
        if len(geo) > 1:
            raise DataCorruptionError(
                f"shards disagree on geometry: {sorted(geo)}",
                source=source)
        self.c, self.h, self.w = shards[0].c, shards[0].h, shards[0].w
        self._starts: list[int] = []
        at = 0
        for s in shards:
            self._starts.append(at)
            at += s.count
        self.count = at

    @classmethod
    def open(cls, source: str, verify: bool = False) -> "ShardSet":
        """Open every ``*.rec`` under ``source`` — a local file, a local
        directory, or a ``file://`` URL (``s3://`` and ``gs://`` raise
        naming ROADMAP A6, object store) — in sorted key order.  ``verify=True`` wraps the
        store in a :class:`VerifyingStore` carrying every record's crc,
        so each ranged read is independently verified with the one-
        fresh-re-read torn-vs-rot distinction."""
        path = source[7:] if source.startswith("file://") else source
        if "://" not in source and os.path.isfile(path):
            from .objectstore import LocalStore
            root, name = os.path.split(os.path.abspath(path))
            store: ObjectStore = LocalStore(root)
            keys = [name]
        else:
            store, prefix = get_store(source)
            keys = [k for k in store.list_keys(prefix)
                    if k.endswith(SHARD_SUFFIX)]
        shards = [RecordShard(store, k, source=f"{source}:{k}")
                  for k in keys]
        if verify:
            vstore = VerifyingStore(store)
            for s in shards:
                s.register_checksums(vstore)
                s.store = vstore
        return cls(shards, source)

    def attach_cache(self, cache) -> None:
        for i, s in enumerate(self.shards):
            s.attach_cache(cache, key=(self.source, i))

    def locate(self, ordinal: int) -> tuple[RecordShard, int]:
        i = ordinal % self.count
        import bisect
        si = bisect.bisect_right(self._starts, i) - 1
        return self.shards[si], i - self._starts[si]

    def partitions(self) -> list[RecordShard]:
        return list(self.shards)

    def close(self) -> None:
        for s in self.shards:
            s.store.close()


# ---------------------------------------------------------------------------
# Feed
# ---------------------------------------------------------------------------

def is_records_source(source: str) -> bool:
    """True when ``source`` names shard records: a ``*.rec`` file/key or
    a directory (or store prefix) holding at least one."""
    if source.endswith(SHARD_SUFFIX):
        return True
    path = source[7:] if source.startswith("file://") else source
    if "://" in source or not os.path.isdir(path):
        return False
    try:
        return any(n.endswith(SHARD_SUFFIX) for n in os.listdir(path))
    except OSError:
        return False


def records_feed(lp, phase, tops: list[str] | None = None, seed: int = 0,
                 quarantine: Quarantine | None = None,
                 workers: int | None = None, stats=None,
                 raw: bool = False, verify: bool | None = None,
                 cache=None) -> Iterator[dict[str, np.ndarray]]:
    """Batch stream for a records-backed ``Data`` layer — ``db_feed``'s
    contract without the decode stage.

    Determinism mirrors ``db_feed`` exactly: records are PULLED serially
    on the consumer thread (sequential ordinal, the fault injector's
    per-seq ``corrupt_record`` coin, quarantine epoch accounting), while
    the ranged READS fan out over an order-preserving ``DecodePool`` —
    so for a fixed seed the parallel records stream is bit-identical to
    the serial one AND to the serial LMDB decode path the shards were
    converted from (same pixels, same labels, same quarantine
    admissions, same replacement pulls).  IO seconds book to the feed's
    ``read`` stage, crc-check/unpack to ``decode``, so the stage split tells
    a slow store from a slow host.

    ``raw=True`` skips the host transform and ships uint8 pixels
    untouched (plus f32 labels), for a consumer that augments on the
    device.  ``verify=True`` (or data_param ``verify``) routes reads
    through a :class:`VerifyingStore`.  The JAX package's ``buffers``
    (a host ``BufferRing``) is not taken: the port's rings are the
    device feed's (``data/prefetch.py``).
    ``cache``: a tiered ``pipeline.ShardCache`` for whole-shard blobs
    (cold = one streaming read, warm = host RAM, evicted = local-disk
    spill)."""
    from .db import DataTransformer
    from .pipeline import DecodePool
    p = lp.sub("data_param")
    source = str(p.get("source"))
    batch = int(p.get("batch_size", 1))
    if verify is None:
        verify = bool(p.get("verify", False))
    shards = ShardSet.open(source, verify=verify)
    if cache is not None:
        shards.attach_cache(cache)
    tf = None if raw else DataTransformer(lp.sub("transform_param"),
                                          phase, seed)
    if tf is not None:
        tf.check_mean((shards.c, shards.h, shards.w), source)
    tops = tops or list(lp.top) or ["data", "label"]
    epoch_size = shards.count
    if quarantine is None:
        quarantine = Quarantine(QuarantinePolicy.from_env(),
                                epoch_size=epoch_size, source=source)
    injector = faults.get_injector()
    state = {"seq": 0}

    def pull() -> tuple[RecordShard, int, int, bool]:
        """Serial ordinal advance: epoch budget roll + fault coin happen
        here, on the consumer thread, in pull order — exactly where
        ``db_feed`` flips them."""
        seq = state["seq"]
        state["seq"] += 1
        if seq and seq % epoch_size == 0:
            quarantine.start_epoch()
        shard, local = shards.locate(seq)
        return shard, local, seq, injector.corrupt_record(seq)

    def fetch_one(item) -> tuple[np.ndarray, int]:
        """Ranged read + crc validate + unpack (runs on pool workers).
        The injected fault corrupts the payload AFTER the read — rotting
        bytes on the medium, which the crc check must catch and the
        quarantine must attribute."""
        shard, local, seq, inject = item
        t0 = time.perf_counter()
        raw_block = shard.read_raw(local)
        if stats is not None:
            stats.note("read", time.perf_counter() - t0)
        if inject:
            raw_block = faults.corrupt_bytes(raw_block, seq)
        t0 = time.perf_counter()
        try:
            return shard.unpack(raw_block, local)
        finally:
            if stats is not None:
                stats.note("decode", time.perf_counter() - t0)

    if workers is None:
        workers = record_readers()
    pool = DecodePool(fetch_one, workers=max(workers, 1),
                      name=f"records:{source}", window=batch + 2)

    def emit(imgs_l: list, labels_l: list) -> dict[str, np.ndarray]:
        n = len(imgs_l)
        stacked = np.stack(imgs_l)          # uint8 [n, c, h, w]
        if tf is None:
            data = stacked
            if stats is not None:
                stats.count_batch(n)
        else:
            t0 = time.perf_counter() if stats is not None else 0.0
            data = tf.batch(stacked)
            if stats is not None:
                stats.note("transform", time.perf_counter() - t0)
                stats.count_batch(n)
        out = {tops[0]: data}
        if len(tops) > 1:
            out[tops[1]] = np.asarray(labels_l, np.float32)
        return out

    def collect_one(imgs_l: list, labels_l: list) -> None:
        try:
            img, label = pool.result()
        except DataCorruptionError as e:
            quarantine.admit(e)     # raises QuarantineExceeded past budget
            return
        imgs_l.append(img)
        labels_l.append(label)

    try:
        while True:
            for _ in range(batch):
                pool.submit(pull())
            imgs_l: list[np.ndarray] = []
            labels_l: list[int] = []
            for _ in range(batch):
                collect_one(imgs_l, labels_l)
            while len(imgs_l) < batch:     # replace quarantined records
                pool.submit(pull())
                collect_one(imgs_l, labels_l)
            yield emit(imgs_l, labels_l)
    finally:
        pool.close()
        shards.close()


# ---------------------------------------------------------------------------
# Conversion (the library half of tools/convert.py)
# ---------------------------------------------------------------------------

def convert_to_shards(records: Iterable[tuple[np.ndarray, int]],
                      out_dir: str, *, quarantine: Quarantine | None = None,
                      shard_bytes: int | None = None,
                      prefix: str = "shard") -> dict[str, Any]:
    """Write an (img, label) stream as a directory of shards, rolling a
    new shard every ``shard_bytes`` (default ``SPARKNET_RECORD_SHARD_MB``).

    A record that raises :class:`DataCorruptionError` while being pulled
    from the source iterator — or that is not uint8-representable — goes
    through ``quarantine`` (the PR-3 path: skipped, counted per source,
    bounded budget) instead of poisoning the shard.  Returns a summary
    dict: shard paths, record count, quarantine report."""
    os.makedirs(out_dir, exist_ok=True)
    if shard_bytes is None:
        shard_bytes = shard_bytes_target()
    if quarantine is None:
        quarantine = Quarantine(QuarantinePolicy.from_env(),
                                source=out_dir)
    paths: list[str] = []
    writer: ShardWriter | None = None
    total = 0
    geometry: tuple[int, int, int] | None = None
    it = iter(records)
    while True:
        try:
            img, label = next(it)
        except StopIteration:
            break
        except DataCorruptionError as e:
            quarantine.admit(e)
            continue
        img = np.asarray(img)
        if writer is not None and writer.nbytes >= shard_bytes:
            writer.close()
            writer = None
        if writer is None:
            path = os.path.join(
                out_dir, f"{prefix}-{len(paths):05d}{SHARD_SUFFIX}")
            writer = ShardWriter(path, *img.shape)
            geometry = (writer.c, writer.h, writer.w)
            paths.append(path)
        try:
            writer.add(img, label)
        except DataCorruptionError as e:
            quarantine.admit(e)
            continue
        total += 1
    if writer is not None:
        writer.close()
    if not paths:
        raise ValueError(f"{out_dir}: source yielded no writable records")
    return {"shards": paths, "records": total, "geometry": geometry,
            "quarantine": quarantine.report()}
