"""Database-backed host feeds: the ``Data`` layer's LMDB and LevelDB path.

The port's own copy of the database half of ``sparknet_tpu/data/db.py``:
``open_db`` (:34), ``datum_to_array`` (:46), ``array_to_datum`` (:111),
``DataTransformer`` (:145-257; its batch transform, as the per-image
``__call__`` serves only the image feeds of ROADMAP A15), ``_cycle_items``
(:260), ``db_feed`` (:278-445), ``feed_for_layer`` (:601) and
``feed_for_net`` (:622).  A reader pulls serialized ``Datum`` records
from the DB cursor (reference: caffe/src/caffe/data_reader.cpp:62-109), a
``pipeline.DecodePool`` decodes them, ``DataTransformer`` applies scale,
crop, mirror and mean to the whole batch (reference:
caffe/src/caffe/data_transformer.cpp), and the batches go to the card
through ``data/prefetch.py::device_feed``.

The JAX package parses a clean batch in one call of its native library
when that library is built, and falls back to numpy otherwise
(sparknet_tpu/native/__init__.py:114, :196-215).  The port has no native
library: every record takes the numpy path, and the batches equal the
JAX feed's byte for byte (the crop only copies, the mean is one f32
subtract).

Refused by name: encoded (JPEG/PNG) Datums, ``ImageData`` and
``WindowData`` (ROADMAP A15, image decoding: the card's machine has
neither PIL nor libjpeg's headers), ``HDF5Data`` (ROADMAP A6, HDF5: no
``h5py`` there) and record shards, ``backend: RECORDS`` or ``*.rec``
(ROADMAP A6, records).
"""

from __future__ import annotations

import os
import time
from typing import Any, Iterator

import numpy as np

from ..proto.caffe_pb import Phase
from ..proto.wireformat import WireError, decode
from .integrity import DataCorruptionError, Quarantine, QuarantinePolicy

IMAGE_DECODING = ("ROADMAP A15, image decoding: the port decodes no "
                  "JPEG or PNG yet")
HDF5_ITEM = "ROADMAP A6, HDF5: the port reads no HDF5 yet"
RECORDS_ITEM = "ROADMAP A6, records: record shards are not ported yet"
SHARD_SUFFIX = ".rec"


# ---------------------------------------------------------------------------
# DB openers
# ---------------------------------------------------------------------------

def open_db(source: str, backend: str = "LMDB"):
    """db.cpp GetDB analog: backend enum -> reader."""
    backend = str(backend).upper()
    if backend in ("LMDB", "1"):
        from .lmdb_io import LmdbReader
        return LmdbReader(source)
    if backend in ("LEVELDB", "0"):
        from .leveldb_io import LeveldbReader
        return LeveldbReader(source)
    if backend == "RECORDS":
        raise NotImplementedError(f"{source}: backend RECORDS "
                                  f"({RECORDS_ITEM})")
    raise ValueError(f"unknown DB backend {backend!r}")


def datum_to_array(datum_bytes: bytes, *, key: Any = None,
                   source: str | None = None) -> tuple[np.ndarray, int]:
    """Serialized Datum -> ((C,H,W) float32, label) (reference:
    data_transformer.cpp Transform(Datum) input handling).

    Every malformed input (truncated protobuf, a payload whose byte count
    contradicts channels×height×width, impossible geometry) raises
    :class:`~.integrity.DataCorruptionError` carrying ``key``/``source``
    attribution.  An encoded Datum raises ``NotImplementedError`` naming
    the image-decoding item."""
    try:
        m = decode(datum_bytes, "Datum")
    except WireError as e:
        raise DataCorruptionError(
            f"undecodable Datum bytes ({len(datum_bytes)} bytes): {e}",
            source=source, key=key) from e
    c = int(m.get("channels", 1))
    h = int(m.get("height", 1))
    w = int(m.get("width", 1))
    label = int(m.get("label", 0))
    data = m.get("data")
    if m.get("encoded"):
        raise NotImplementedError(
            f"encoded Datum [source={source!r}, key={key!r}] "
            f"({IMAGE_DECODING})")
    if c <= 0 or h <= 0 or w <= 0:
        raise DataCorruptionError(
            f"impossible Datum geometry channels={c} height={h} width={w}",
            source=source, key=key)
    if data:
        if len(data) != c * h * w:
            raise DataCorruptionError(
                f"Datum payload is {len(data)} bytes but "
                f"channels*height*width = {c}*{h}*{w} = {c * h * w}",
                source=source, key=key)
        arr = np.frombuffer(data, np.uint8).astype(np.float32)
        return arr.reshape(c, h, w), label
    floats = [float(v) for v in m.get_all("float_data")]
    if len(floats) != c * h * w:
        raise DataCorruptionError(
            f"Datum float_data has {len(floats)} values but "
            f"channels*height*width = {c}*{h}*{w} = {c * h * w}",
            source=source, key=key)
    return np.asarray(floats, np.float32).reshape(c, h, w), label


def array_to_datum(img: np.ndarray, label: int = 0) -> bytes:
    """(C,H,W) array -> serialized Datum (reference: util/io.cpp
    CVMatToDatum): raw uint8 ``data`` when every value is a byte, else
    ``float_data``."""
    from ..proto.textformat import PMessage
    from ..proto.wireformat import encode
    m = PMessage()
    c, h, w = img.shape
    m.add("channels", c)
    m.add("height", h)
    m.add("width", w)
    if img.dtype == np.uint8 or (
            img.min() >= 0 and img.max() <= 255
            and np.allclose(img, np.round(img))):
        m.add("data", np.ascontiguousarray(img, np.uint8).tobytes())
    else:
        for v in img.reshape(-1):
            m.add("float_data", float(v))
    m.add("label", int(label))
    return encode(m, "Datum")


# ---------------------------------------------------------------------------
# DataTransformer
# ---------------------------------------------------------------------------

class DataTransformer:
    """scale / mean (file or values) / crop / mirror, matching
    data_transformer.cpp Transform: train = random crop + random mirror,
    test = center crop, mean subtracted at the crop window.  The offsets
    and flips come from ``np.random.default_rng(seed)`` in the JAX
    package's order, so the same seed gives the same batches."""

    def __init__(self, transform_param, phase: Phase, seed: int = 0):
        p = transform_param
        self.scale = float(p.get("scale", 1.0))
        self.crop = int(p.get("crop_size", 0))
        self.mirror = bool(p.get("mirror", False))
        self.phase = phase
        self.rng = np.random.default_rng(seed)
        self.mean: np.ndarray | None = None
        mean_file = p.get("mean_file")
        if mean_file is not None:
            from ..proto.caffemodel import load_mean_binaryproto
            self.mean = load_mean_binaryproto(str(mean_file))
        else:
            values = [float(v) for v in p.get_all("mean_value")]
            if values:
                self.mean = np.asarray(values, np.float32).reshape(-1, 1, 1)
        # reusable full-size f32 scratch for the batch mean-subtract
        # (consumed within batch(), never escapes).  Not thread-safe:
        # batch() runs on the one feed thread
        self._scratch: np.ndarray | None = None

    def check_mean(self, shape: tuple[int, int, int],
                   source: str | None = None) -> None:
        """Raise unless the mean fits (C, H, W) images: a mean image of
        their shape, one value, or one value per channel
        (data_transformer.cpp CHECKs)."""
        if self.mean is None:
            return
        c, h, w = shape
        mc, mh, mw = self.mean.shape
        if (mh, mw) == (1, 1) and mc in (1, c):
            return
        if (mc, mh, mw) != (c, h, w):
            raise ValueError(
                f"mean of shape {self.mean.shape} does not fit the "
                f"{shape} images of {source or 'the source'}")

    def _sub_mean(self, x: np.ndarray) -> np.ndarray:
        """``x - mean`` into the reusable scratch buffer."""
        if self._scratch is None or self._scratch.shape != x.shape:
            self._scratch = np.empty(x.shape, np.float32)
        np.subtract(x, self.mean, out=self._scratch)
        return self._scratch

    def batch(self, imgs: np.ndarray) -> np.ndarray:
        """Transform an [n, c, h, w] batch in one pass: the feed's
        transform."""
        x = np.asarray(imgs, np.float32)   # no copy when already f32
        n, c, h, w = x.shape
        if self.crop:
            if self.mean is not None:
                # full-size subtract == window subtract
                x = self._sub_mean(x)
            crop = self.crop
            if self.phase == Phase.TRAIN:
                ys = self.rng.integers(0, h - crop + 1, size=n)
                xs = self.rng.integers(0, w - crop + 1, size=n)
            else:
                ys = np.full(n, (h - crop) // 2)
                xs = np.full(n, (w - crop) // 2)
            flips = (self.rng.integers(0, 2, size=n)
                     if self.mirror and self.phase == Phase.TRAIN
                     else np.zeros(n, np.int64))
            res = np.empty((n, c, crop, crop), np.float32)
            for i in range(n):
                img = x[i, :, ys[i]:ys[i] + crop, xs[i]:xs[i] + crop]
                res[i] = img[:, :, ::-1] if flips[i] else img
            if self.scale != 1.0:
                np.multiply(res, self.scale, out=res)
            return res
        res = x if self.mean is None else x - self.mean
        if self.mirror and self.phase == Phase.TRAIN:
            flips = self.rng.integers(0, 2, size=n).astype(bool)
            if res is x:   # never flip the caller's array in place
                res = x.copy()
            res[flips] = res[flips, :, :, ::-1]
        if self.scale != 1.0:
            res = res * self.scale
        return np.ascontiguousarray(res)


# ---------------------------------------------------------------------------
# Feeds
# ---------------------------------------------------------------------------

def _cycle_items(reader):
    """Endless cursor with rewind-at-end (data_reader.cpp:100-106)."""
    while True:
        n = 0
        for kv in reader.items():
            yield kv
            n += 1
        if n == 0:
            raise ValueError("empty database")


def _is_records(source: str) -> bool:
    """True when ``source`` names record shards: a ``*.rec`` file or a
    directory holding one (sparknet_tpu/data/records.py:444)."""
    if source.endswith(SHARD_SUFFIX):
        return True
    if not os.path.isdir(source):
        return False
    return any(n.endswith(SHARD_SUFFIX) for n in os.listdir(source))


def corrupt_record(seq: int, value: bytes) -> bytes | None:
    """The fault injector's seam: the bytes to hand the decoder in place
    of the feed's record number ``seq``, or None to leave it.  None here
    (the JAX package's ``faults.get_injector().corrupt_record`` is not
    ported, ROADMAP A9); tests patch it."""
    return None


def db_feed(lp, phase: Phase, seed: int = 0,
            quarantine: Quarantine | None = None,
            workers: int | None = None, stats=None,
            ) -> Iterator[dict[str, np.ndarray]]:
    """Batch stream for a ``Data`` layer (LMDB/LevelDB backed).  Decode
    and the integrity checks fan out over a ``pipeline.DecodePool`` of
    ``workers`` threads (default ``SPARKNET_FEED_WORKERS``), and the batch
    is transformed in one vectorized ``DataTransformer.batch`` pass.

    Determinism: records are pulled serially on the consumer thread (DB
    cursor order, the fault seam and the quarantine's epoch accounting
    are all pull-side), and pool results come back in submission order,
    so for a fixed seed the stream is the same whatever the worker count,
    down to which records are quarantined and which replace them.

    Every decoded record is validated (decode, and geometry against the
    source's first record); a record that fails goes through
    ``quarantine``: skipped, counted per source and replaced by the next
    record, under a bounded per-epoch budget (past it,
    ``QuarantineExceeded``).  The default quarantine takes its policy
    from ``SPARKNET_QUARANTINE_FRACTION``/``_RECORDS`` (default: zero
    tolerance, so the first bad record raises).

    ``stats``: an optional ``pipeline.FeedStats`` receiving per-stage
    decode and transform seconds."""
    from .pipeline import DecodePool, feed_workers
    p = lp.sub("data_param")
    source = str(p.get("source"))
    batch = int(p.get("batch_size", 1))
    backend = p.get("backend", "LEVELDB")
    if str(backend).upper() == "RECORDS" or _is_records(source):
        raise NotImplementedError(f"Data layer {lp.name!r} source "
                                  f"{source!r} ({RECORDS_ITEM})")
    reader = open_db(source, str(backend))
    tf = DataTransformer(lp.sub("transform_param"), phase, seed)
    tops = list(lp.top) or ["data", "label"]
    cursor = _cycle_items(reader)
    epoch_size = len(reader)
    if quarantine is None:
        quarantine = Quarantine(QuarantinePolicy.from_env(),
                                epoch_size=epoch_size, source=source)
    # peek the first record for the source's geometry
    first_img, _ = datum_to_array(reader.first()[1], source=source)
    c, h, w = first_img.shape
    tf.check_mean((c, h, w), source)
    state = {"seq": 0}   # feed-lifetime record counter

    def pull() -> tuple[Any, bytes]:
        """(key, value) of the next record; rolls the quarantine's epoch
        budget at each full pass over the source."""
        key, val = next(cursor)
        seq = state["seq"]
        state["seq"] += 1
        if seq and seq % epoch_size == 0:
            quarantine.start_epoch()
        bad = corrupt_record(seq, val)
        return key, (val if bad is None else bad)

    def decode_one(kv) -> tuple[np.ndarray, int]:
        """Decode and geometry-check one record (on a pool thread); the
        pool re-raises its DataCorruptionError at this record's place."""
        key, val = kv
        img, label = datum_to_array(val, key=key, source=source)
        if img.shape != (c, h, w):
            raise DataCorruptionError(
                f"record shape {img.shape} != source geometry "
                f"({c}, {h}, {w})", source=source, key=key)
        return img, label

    # window >= batch: the feed submits a whole batch before collecting
    pool = DecodePool(decode_one, workers=feed_workers()
                      if workers is None else workers,
                      name=f"db:{source}", stats=stats, stage="decode",
                      window=batch + 2)

    def transform(imgs: list[np.ndarray]) -> np.ndarray:
        t0 = time.perf_counter()
        data = tf.batch(np.stack(imgs))
        if stats is not None:
            stats.note("transform", time.perf_counter() - t0)
            stats.count_batch(len(imgs))
        return data

    def collect_one(imgs_l: list, labels_l: list) -> None:
        """Take the pool's next result in order; a corrupt record goes to
        the quarantine (raising past its budget) and is not appended."""
        try:
            img, label = pool.result()
        except DataCorruptionError as e:
            quarantine.admit(e)
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
            while len(imgs_l) < batch:   # replace quarantined records
                pool.submit(pull())
                collect_one(imgs_l, labels_l)
            out = {tops[0]: transform(imgs_l)}
            if len(tops) > 1:
                out[tops[1]] = np.asarray(labels_l, np.float32)
            yield out
    finally:
        pool.close()
        reader.close()


def feed_for_layer(lp, phase: Phase, seed: int = 0, **kw):
    """The host feed of a data layer, the analog of LayerRegistry creating
    the right data layer (layer_factory.hpp).  ``kw`` goes to
    :func:`db_feed`."""
    if lp.type == "Data":
        return db_feed(lp, phase, seed=seed, **kw)
    if lp.type in ("ImageData", "WindowData"):
        raise NotImplementedError(
            f"layer {lp.name!r} ({lp.type}) ({IMAGE_DECODING})")
    if lp.type == "HDF5Data":
        raise NotImplementedError(
            f"layer {lp.name!r} (HDF5Data) ({HDF5_ITEM})")
    raise ValueError(f"layer {lp.name!r} ({lp.type}) has no host feed")


_FEEDABLE_TYPES = ("Data", "ImageData", "WindowData", "HDF5Data")


def feed_for_net(net_param, phase: Phase, seed: int = 0, **kw):
    """Feed for the first self-sourcing data layer active in ``phase``
    (the standalone `caffe train` data path)."""
    from ..proto.caffe_pb import NetState
    for lp in net_param.filtered(NetState(phase)).layer:
        if lp.type in _FEEDABLE_TYPES:
            return feed_for_layer(lp, phase, seed=seed, **kw)
    raise ValueError(
        f"net has no DB/file-backed data layer for phase {phase}; feed it "
        "explicitly (set_train_data/set_test_data)")
