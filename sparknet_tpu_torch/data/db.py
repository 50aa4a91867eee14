"""Database- and file-backed host feeds: the ``Data``, ``ImageData`` and
``WindowData`` layers' data path.

The port's own copy of ``sparknet_tpu/data/db.py``: ``open_db`` (:34),
``datum_to_array`` (:46, encoded Datums too), ``array_to_datum`` (:111),
``DataTransformer`` (:145-257), ``_cycle_items`` (:260), ``db_feed``
(:278-445), ``image_data_feed`` (:448-482), ``window_data_feed``
(:485-541) with ``_crop_warp_window`` (:544-598), ``feed_for_layer``
(:601), ``feed_for_net`` (:622), ``read_image_list`` (:647),
``load_image`` (:663-693), ``_warp`` (:695) and ``read_window_file``
(:716).  A reader pulls serialized ``Datum`` records from the DB cursor
(reference: caffe/src/caffe/data_reader.cpp:62-109), a
``pipeline.DecodePool`` decodes them, ``DataTransformer`` applies scale,
crop, mirror and mean to the whole batch (reference:
caffe/src/caffe/data_transformer.cpp), and the batches go to the card
through ``data/prefetch.py::device_feed``.

JPEGs (encoded Datums, ``ImageData`` lists, ``WindowData`` images) are
decoded by ``data/jpeg.py`` on the feed's ``device``: nvJPEG and the
resize kernel on the card by default, PIL and the plain resize on the
CPU when asked; the pixels come back to the host as float32, the JAX
package's arrays.  Where the JAX package takes PIL instead (a
natural-size encoded Datum, an image libjpeg refuses, a file that is no
JPEG), the port gives PIL's pixels without PIL for what it decodes: a
PNG through ``data/png.py`` on either device, a CMYK JPEG through
nvJPEG and ``jpeg.cmyk_to_rgb`` on the card, each resized as PIL's
BILINEAR does by ``data/pil_resample.py``.  The CPU keeps PIL for the
JPEGs and the formats the port does not decode; on the card those
formats (:data:`FORMATS_LEFT`) and a YCCK JPEG raise naming their
ROADMAP A15 item.

The JAX package parses a clean batch of raw Datums in one call of its
native library when that library is built, and falls back to numpy
otherwise (sparknet_tpu/native/__init__.py:114, :196-215).  The port has
no native library: every record takes the numpy path, and the batches
equal the JAX feed's byte for byte (the crop only copies, the mean is one
f32 subtract).

Record shards (``backend: RECORDS``, a ``*.rec`` file or a directory of
them, written once by ``tools/convert.py``) go to
``data/records.py::records_feed``: the same batches, transform,
quarantine and determinism, with no decode (:271-329).  ``HDF5Data`` is
fed by ``data/hdf5.py::hdf5_feed`` (:610-619), over the port's own HDF5
reader.
"""

from __future__ import annotations

import os
import time
from typing import Any, Iterator

import numpy as np
import torch

from ..proto.caffe_pb import Phase
from ..proto.wireformat import WireError, decode
from ..utils.device import resolve_device
from ..utils.retry import io_retry
from . import jpeg, pil_resample, png
from .integrity import DataCorruptionError, Quarantine, QuarantinePolicy

REFUSED_JPEG_ITEM = "ROADMAP A15, images libjpeg refuses"
NOT_JPEG_ITEM = "ROADMAP A15, non-JPEG images on the card"
# the image formats Caffe's OpenCV reads that the card does not decode yet
FORMATS_LEFT = "GIF, BMP, TIFF"


# ---------------------------------------------------------------------------
# DB openers
# ---------------------------------------------------------------------------

def open_db(source: str, backend: str = "LMDB"):
    """db.cpp GetDB analog: backend enum -> reader.  Record shards have
    no Datum cursor: ``db_feed`` streams ``backend: RECORDS`` through
    ``records_feed``."""
    backend = str(backend).upper()
    if backend in ("LMDB", "1"):
        from .lmdb_io import LmdbReader
        return LmdbReader(source)
    if backend in ("LEVELDB", "0"):
        from .leveldb_io import LeveldbReader
        return LeveldbReader(source)
    raise ValueError(f"unknown DB backend {backend!r}")


def datum_to_array(datum_bytes: bytes, *, key: Any = None,
                   source: str | None = None,
                   device: str | torch.device = "cuda",
                   ) -> tuple[np.ndarray, int]:
    """Serialized Datum -> ((C,H,W) float32, label) (reference:
    data_transformer.cpp Transform(Datum) input handling).

    An encoded Datum is decoded on ``device`` (``data/jpeg.py``):
    force-resized to its height x width when both are set, at its own
    size otherwise.  Every malformed input (truncated protobuf, a payload
    whose byte count contradicts channels×height×width, impossible
    geometry, an undecodable encoded image) raises
    :class:`~.integrity.DataCorruptionError` carrying ``key``/``source``
    attribution."""
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
        raw = bytes(data)
        if h and w:
            img = jpeg.decode_jpeg_resize(raw, h, w, device)
            if img is None:
                raise DataCorruptionError(
                    "undecodable encoded Datum", source=source, key=key)
            return img.cpu().numpy(), label
        return _decode_natural(raw, device, key, source), label
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


def _decode_natural(raw: bytes, device, key, source) -> np.ndarray:
    """An encoded Datum's image at its own size, RGB, as the JAX package's
    PIL decodes it (``sparknet_tpu/data/db.py:78-88``): a PNG through
    ``png.py`` on either device; on the CPU anything else through PIL; on
    the card a JPEG through nvJPEG, a CMYK one through ``decode_cmyk``."""
    what = f"encoded Datum [source={source!r}, key={key!r}]"
    try:
        if png.is_png(raw):
            return _hwc(png.decode_png(raw).convert("RGB"))
        if resolve_device(device).type == "cpu":
            return jpeg.pil_image(raw, "RGB")
    except (png.PNGError, jpeg.UndecodableImage) as e:
        raise DataCorruptionError(f"undecodable encoded Datum: {e}",
                                  source=source, key=key) from e
    img = jpeg.decode_jpeg(raw, device)
    if img is not None:
        return img.cpu().numpy()
    rgb = _other_on_card(raw, device, what)
    if rgb is None:
        raise DataCorruptionError("undecodable encoded Datum",
                                  source=source, key=key)
    return _hwc(rgb)


def _hwc(arr: np.ndarray) -> np.ndarray:
    """(H, W, 3) or (H, W) uint8 -> (C, H, W) float32."""
    arr = np.asarray(arr, np.float32)
    return arr[None] if arr.ndim == 2 else np.ascontiguousarray(
        arr.transpose(2, 0, 1))


def _other_format(raw: bytes) -> bool:
    """True for the image formats Caffe's OpenCV reads besides JPEG and
    PNG, which the card does not decode: GIF, BMP, TIFF."""
    return raw.startswith((b"GIF8", b"BM", b"II*\x00", b"MM\x00*"))


def _other_on_card(raw: bytes, device, what: str) -> np.ndarray | None:
    """On the card, the pixels PIL's ``convert("RGB")`` gives of an image
    nvJPEG's three-component path dropped: a CMYK JPEG's, as (H, W, 3)
    uint8 on the host; None for bytes that are no image.  GIF, BMP and
    TIFF raise naming :data:`NOT_JPEG_ITEM`."""
    if _other_format(raw):
        raise NotImplementedError(
            f"{what} is no JPEG or PNG ({NOT_JPEG_ITEM}: {FORMATS_LEFT} are "
            f"left)")
    rgb = jpeg.decode_cmyk(raw, device)
    return None if rgb is None else rgb.cpu().numpy()


def datum_shape(datum_bytes: bytes, *,
                source: str | None = None) -> tuple[int, int, int]:
    """(C, H, W) of the image ``datum_to_array`` makes of a Datum, read
    without decoding an encoded one: its height x width when set, else
    the JPEG's frame header (3 channels, as the decode converts to
    RGB)."""
    try:
        m = decode(datum_bytes, "Datum")
    except WireError as e:
        raise DataCorruptionError(
            f"undecodable Datum bytes ({len(datum_bytes)} bytes): {e}",
            source=source) from e
    if not m.get("encoded"):
        return datum_to_array(datum_bytes, source=source)[0].shape
    h, w = int(m.get("height", 1)), int(m.get("width", 1))
    if h and w:
        return 3, h, w
    return (3,) + _image_size(bytes(m.get("data")), source)


def _image_size(raw: bytes, what) -> tuple[int, int]:
    """(height, width) of an encoded image: a JPEG's from its frame
    header, a PNG's from its IHDR; any other's decoded by PIL, as the JAX
    package takes it (PIL is imported only then)."""
    size = jpeg.jpeg_size(raw) or png.png_size(raw)
    if size is None:
        try:
            size = jpeg.pil_image(raw, "RGB").shape[1:]
        except jpeg.UndecodableImage as e:
            raise DataCorruptionError(f"undecodable image: {e}",
                                      source=what) from e
    return size


def array_to_datum(img: np.ndarray | None, label: int = 0,
                   encoded: bytes | None = None) -> bytes:
    """(C,H,W) array -> serialized Datum (reference: util/io.cpp
    CVMatToDatum): raw uint8 ``data`` when every value is a byte, else
    ``float_data``.  With ``encoded``, the file's compressed bytes
    instead, as channels 3 and height and width 0 (ReadFileToDatum)."""
    from ..proto.textformat import PMessage
    from ..proto.wireformat import encode
    m = PMessage()
    if encoded is not None:
        m.add("channels", 3)
        m.add("height", 0)
        m.add("width", 0)
        m.add("data", encoded)
        m.add("encoded", True)
    else:
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

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """Transform one (C, H, W) image: the image feeds' transform."""
        out = img.astype(np.float32)
        if self.mean is not None:
            out = out - self.mean   # full-size subtract == window subtract
        if self.crop:
            c, h, w = out.shape
            if self.phase == Phase.TRAIN:
                y = int(self.rng.integers(0, h - self.crop + 1))
                x = int(self.rng.integers(0, w - self.crop + 1))
            else:
                y, x = (h - self.crop) // 2, (w - self.crop) // 2
            out = out[:, y:y + self.crop, x:x + self.crop]
        if self.mirror and self.phase == Phase.TRAIN and self.rng.integers(2):
            out = out[:, :, ::-1]
        if self.scale != 1.0:
            out = out * self.scale
        return np.ascontiguousarray(out)

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


def corrupt_record(seq: int, value: bytes) -> bytes | None:
    """The fault injector's seam: the bytes to hand the decoder in place
    of the feed's record number ``seq``, or None to leave it.
    ``SPARKNET_FAULT=corrupt_record:<p>`` rots that share of the records,
    the same records as in the JAX package (a pure function of ``seq``,
    sparknet_tpu/data/db.py:344-358)."""
    from ..utils import faults
    if faults.get_injector().corrupt_record(seq):
        return faults.corrupt_bytes(value, seq)
    return None


def db_feed(lp, phase: Phase, seed: int = 0,
            quarantine: Quarantine | None = None,
            workers: int | None = None, stats=None,
            device: str | torch.device = "cuda",
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
    decode and transform seconds.  ``device``: where encoded Datums are
    decoded (each pool thread with its own nvJPEG state and stream on
    the card).

    A record-shard source (``backend: RECORDS``, a ``*.rec`` path or a
    directory of them) goes to ``records.records_feed``: the same batch,
    transform, quarantine and determinism contract without the decode
    stage (``device`` unused)."""
    from .pipeline import DecodePool, feed_workers
    from .records import is_records_source, records_feed
    p = lp.sub("data_param")
    source = str(p.get("source"))
    batch = int(p.get("batch_size", 1))
    backend = p.get("backend", "LEVELDB")
    if str(backend).upper() == "RECORDS" or is_records_source(source):
        # yield from, not return: db_feed is a generator
        yield from records_feed(lp, phase, seed=seed,
                                quarantine=quarantine, workers=workers,
                                stats=stats)
        return
    reader = open_db(source, str(backend))
    tf = DataTransformer(lp.sub("transform_param"), phase, seed)
    tops = list(lp.top) or ["data", "label"]
    cursor = _cycle_items(reader)
    epoch_size = len(reader)
    if quarantine is None:
        quarantine = Quarantine(QuarantinePolicy.from_env(),
                                epoch_size=epoch_size, source=source)
    # peek the first record for the source's geometry
    first_img, _ = datum_to_array(reader.first()[1], source=source,
                                  device=device)
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
        img, label = datum_to_array(val, key=key, source=source,
                                    device=device)
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


def image_data_feed(lp, phase: Phase, seed: int = 0,
                    device: str | torch.device = "cuda",
                    ) -> Iterator[dict[str, np.ndarray]]:
    """Batch stream for an ``ImageData`` layer (reference:
    caffe/src/caffe/layers/image_data_layer.cpp): a ``source`` list file
    of "path label" lines, optional force-resize to new_height×new_width,
    shuffle, then the DataTransformer, image by image; images decoded on
    ``device``."""
    p = lp.sub("image_data_param")
    entries = read_image_list(str(p.get("source")),
                              str(p.get("root_folder", "")))
    batch = int(p.get("batch_size", 1))
    new_h = int(p.get("new_height", 0))
    new_w = int(p.get("new_width", 0))
    color = bool(p.get("is_color", True))
    shuffle = bool(p.get("shuffle", False))
    tf = DataTransformer(lp.sub("transform_param"), phase, seed)
    rng = np.random.default_rng(seed)
    tops = list(lp.top) or ["data", "label"]
    order = np.arange(len(entries))
    if shuffle:
        rng.shuffle(order)
    pos = 0
    while True:
        imgs, labels = [], []
        for _ in range(batch):
            # wrap mid-batch like lines_id_ in image_data_layer.cpp
            # (re-shuffling at each epoch boundary when shuffle is set)
            if pos >= len(order):
                pos = 0
                if shuffle:
                    rng.shuffle(order)
            path, label = entries[order[pos]]
            pos += 1
            imgs.append(tf(load_image(path, new_h, new_w, color, device)))
            labels.append(label)
        yield _pack(tops, imgs, labels)


def window_data_feed(lp, phase: Phase, seed: int = 0,
                     device: str | torch.device = "cuda",
                     ) -> Iterator[dict[str, np.ndarray]]:
    """Batch stream for a ``WindowData`` layer (reference:
    caffe/src/caffe/layers/window_data_layer.cpp): foreground/background
    window sampling at fg_fraction, crop + warp each window to crop_size,
    context padding, mean subtraction at the window; images decoded on
    ``device`` at their own size."""
    p = lp.sub("window_data_param")
    fg_threshold = float(p.get("fg_threshold", 0.5))
    bg_threshold = float(p.get("bg_threshold", 0.5))
    images, fg, bg = read_window_file(str(p.get("source")),
                                      fg_threshold, bg_threshold)
    if not fg and not bg:
        raise ValueError(
            f"WindowData layer {lp.name!r}: no sampleable windows — every "
            f"window overlap falls in [{bg_threshold}, {fg_threshold}) "
            f"(fg_threshold={fg_threshold}, bg_threshold={bg_threshold})")
    batch = int(p.get("batch_size", 1))
    fg_frac = float(p.get("fg_fraction", 0.25))
    context_pad = int(p.get("context_pad", 0))
    tf_param = lp.sub("transform_param")
    crop = int(tf_param.get("crop_size", 0)) or 227
    mirror = bool(tf_param.get("mirror", False))
    scale = float(tf_param.get("scale", 1.0))
    mean_values = [float(v) for v in tf_param.get_all("mean_value")]
    mean = (np.asarray(mean_values, np.float32).reshape(-1, 1, 1)
            if mean_values else None)
    use_square = str(p.get("crop_mode", "warp")) == "square"
    rng = np.random.default_rng(seed)
    tops = list(lp.top) or ["data", "label"]
    n_fg = int(round(batch * fg_frac))
    cache: dict[int, np.ndarray] = {}

    def get_image(img_idx: int) -> np.ndarray:
        if img_idx not in cache:
            if len(cache) > 32:
                cache.clear()
            path = images[img_idx][0]
            cache[img_idx] = load_image(path, 0, 0, True, device)
        return cache[img_idx]

    def sample(pool):
        return pool[int(rng.integers(0, len(pool)))]

    while True:
        imgs, labels = [], []
        for i in range(batch):
            use_fg = bool(fg) and (i < n_fg or not bg)
            win = sample(fg if use_fg else bg)
            img_idx, label, _ov, x1, y1, x2, y2 = win
            img = get_image(img_idx)
            do_mirror = bool(mirror and phase == Phase.TRAIN
                             and rng.integers(2))
            imgs.append(_crop_warp_window(
                img, x1, y1, x2, y2, crop, context_pad, use_square,
                do_mirror, mean, scale))
            labels.append(0 if not use_fg else label)
        yield _pack(tops, imgs, labels)


def _crop_warp_window(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                      crop: int, context_pad: int, use_square: bool,
                      do_mirror: bool, mean: np.ndarray | None,
                      scale: float) -> np.ndarray:
    """The window crop of window_data_layer.cpp:300-420: expand the
    region by context_scale = crop/(crop - 2·context_pad) around its
    center (squared first in "square" crop_mode), clip to the image, warp
    the clipped part by the *unclipped* scale factors, and paste it at
    the pad offset into a zeroed crop×crop buffer (out-of-image context
    stays 0 after mean subtraction).  Rounds half to even, as Python's
    ``round`` and the JAX package do."""
    c, rows, cols = img.shape
    pad_w = pad_h = 0
    crop_w = crop_h = crop
    if context_pad > 0 or use_square:
        if 2 * context_pad >= crop:
            raise ValueError(
                f"context_pad {context_pad} must be less than half the "
                f"net input size {crop} (window_data_layer.cpp context "
                f"scale would invert)")
        context_scale = crop / (crop - 2.0 * context_pad)
        half_h = (y2 - y1 + 1) / 2.0
        half_w = (x2 - x1 + 1) / 2.0
        cx, cy = x1 + half_w, y1 + half_h
        if use_square:
            half_h = half_w = max(half_h, half_w)
        x1 = int(round(cx - half_w * context_scale))
        x2 = int(round(cx + half_w * context_scale))
        y1 = int(round(cy - half_h * context_scale))
        y2 = int(round(cy + half_h * context_scale))
        unclipped_h, unclipped_w = y2 - y1 + 1, x2 - x1 + 1
        pad_x1, pad_y1 = max(0, -x1), max(0, -y1)
        pad_x2 = max(0, x2 - cols + 1)
        pad_y2 = max(0, y2 - rows + 1)
        x1, x2 = x1 + pad_x1, x2 - pad_x2
        y1, y2 = y1 + pad_y1, y2 - pad_y2
        clipped_h, clipped_w = y2 - y1 + 1, x2 - x1 + 1
        scale_x, scale_y = crop / unclipped_w, crop / unclipped_h
        crop_w = int(round(clipped_w * scale_x))
        crop_h = int(round(clipped_h * scale_y))
        pad_x1 = int(round(pad_x1 * scale_x))
        pad_x2 = int(round(pad_x2 * scale_x))
        pad_y1 = int(round(pad_y1 * scale_y))
        pad_h = pad_y1
        pad_w = pad_x2 if do_mirror else pad_x1  # mirrored padding
        crop_h = min(crop_h, crop - pad_h)
        crop_w = min(crop_w, crop - pad_w)
    window = img[:, y1:y2 + 1, x1:x2 + 1]
    warped = _warp(window, crop_h, crop_w)
    if do_mirror:
        warped = warped[:, :, ::-1]
    if mean is not None:
        warped = warped - mean
    out = np.zeros((c, crop, crop), np.float32)
    out[:, pad_h:pad_h + crop_h, pad_w:pad_w + crop_w] = warped * scale
    return out


def feed_for_layer(lp, phase: Phase, seed: int = 0,
                   device: str | torch.device = "cuda", **kw):
    """The host feed of a data layer, the analog of LayerRegistry creating
    the right data layer (layer_factory.hpp).  Images decode on
    ``device``; ``kw`` goes to :func:`db_feed`."""
    if lp.type == "Data":
        return db_feed(lp, phase, seed=seed, device=device, **kw)
    if lp.type == "ImageData":
        return image_data_feed(lp, phase, seed=seed, device=device)
    if lp.type == "WindowData":
        return window_data_feed(lp, phase, seed=seed, device=device)
    if lp.type == "HDF5Data":
        from .hdf5 import hdf5_feed
        p = lp.sub("hdf5_data_param")
        return hdf5_feed(str(p.get("source")), list(lp.top),
                         int(p.get("batch_size", 1)),
                         shuffle=bool(p.get("shuffle", False)), seed=seed)
    raise ValueError(f"layer {lp.name!r} ({lp.type}) has no host feed")


_FEEDABLE_TYPES = ("Data", "ImageData", "WindowData", "HDF5Data")


def feed_for_net(net_param, phase: Phase, seed: int = 0, *,
                 state=None, **kw):
    """Feed for the first self-sourcing data layer active in ``phase``
    (the standalone `caffe train` data path), or in the full ``state``
    (a ``NetState`` with its level and stages) when one is given."""
    from ..proto.caffe_pb import NetState
    for lp in net_param.filtered(state or NetState(phase)).layer:
        if lp.type in _FEEDABLE_TYPES:
            return feed_for_layer(lp, phase, seed=seed, **kw)
    raise ValueError(
        f"net has no DB/file-backed data layer for phase {phase}; feed it "
        "explicitly (set_train_data/set_test_data)")


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _pack(tops, imgs, labels) -> dict[str, np.ndarray]:
    out = {tops[0]: np.asarray(np.stack(imgs), np.float32)}
    if len(tops) > 1:
        out[tops[1]] = np.asarray(labels, np.float32)
    return out


def read_image_list(source: str, root: str = "") -> list[tuple[str, int]]:
    """"path label" lines (any whitespace between, as Caffe's
    istringstream reads them) -> [(root/path, label)]."""
    entries = []
    with open(source) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            path, label = line.rsplit(None, 1)
            entries.append((os.path.join(root, path), int(label)))
    if not entries:
        raise ValueError(f"{source}: empty image list")
    return entries


def load_image(path: str, new_h: int, new_w: int, color: bool,
               device: str | torch.device = "cuda") -> np.ndarray:
    """An image file -> (C,H,W) float32 0-255, decoded on ``device``.

    A JPEG with a new size goes through the JPEG decoder and its
    force-resize (ScaleAndConvert semantics; gray: the mean of the three
    resized channels); at its own size, RGB or, gray, integer ITU-R 601
    luma.  Everything else takes the JAX package's PIL path, PIL's
    ``convert`` and BILINEAR resize (``sparknet_tpu/data/db.py:680-693``):
    a PNG through ``png.py`` and ``pil_resample.py`` on either device;
    on the CPU any other image through PIL; on the card a CMYK JPEG
    through ``decode_cmyk``, while GIF, BMP, TIFF and a JPEG nvJPEG
    refuses raise naming their ROADMAP A15 item.  The read retries
    transient I/O errors (SPARKNET_IO_RETRIES/_BACKOFF)."""

    def read() -> bytes:
        with open(path, "rb") as f:
            return f.read()

    device = resolve_device(device)
    raw = io_retry(read, describe=f"read {path}")
    sized = bool(new_h and new_w)
    mode = "RGB" if color else "L"
    if raw[:2] == jpeg.SOI and sized:
        img = jpeg.decode_jpeg_resize(raw, new_h, new_w, device,
                                      gray=not color)
        if img is not None:
            return img.cpu().numpy()
    if png.is_png(raw):
        return _pil_sized(png.decode_png(raw).convert(mode), new_h, new_w)
    if device.type == "cpu":
        return jpeg.pil_image(raw, mode, (new_h, new_w) if sized else None)
    if raw[:2] == jpeg.SOI and not sized:
        if color:
            img = jpeg.decode_jpeg(raw, device)
        else:
            rgb = jpeg.decode_rgb(raw, device)
            img = None if rgb is None else jpeg.luma601(rgb)
        if img is not None:
            return img.cpu().numpy()
    rgb = _other_on_card(raw, device, path)
    if rgb is None:
        raise NotImplementedError(
            f"{path}: a JPEG the native decoder refuses, which the JAX "
            f"package reads with PIL ({REFUSED_JPEG_ITEM})")
    return _pil_sized(rgb if color else png.luma601(rgb), new_h, new_w)


def _pil_sized(pixels: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """PIL's pixels (uint8, (H, W, 3) or (H, W)), resized to new_h x new_w
    as PIL's BILINEAR does when both are set -> (C, H, W) float32."""
    if new_h and new_w:
        pixels = pil_resample.resize(pixels, (new_h, new_w))
    return _hwc(pixels)


def _warp(window: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear force-resize in float64 (the warp of
    window_data_layer.cpp): ``np.linspace`` sample points, float64
    weights, one cast to float32 at the end."""
    c, h, w = window.shape
    if h == out_h and w == out_w:
        return window.astype(np.float32)
    ys = np.linspace(0, h - 1, out_h)
    xs = np.linspace(0, w - 1, out_w)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]
    p00 = window[:, y0][:, :, x0]
    p01 = window[:, y0][:, :, x1]
    p10 = window[:, y1][:, :, x0]
    p11 = window[:, y1][:, :, x1]
    return ((1 - wy) * ((1 - wx) * p00 + wx * p01)
            + wy * ((1 - wx) * p10 + wx * p11)).astype(np.float32)


def read_window_file(source: str, fg_threshold: float, bg_threshold: float):
    """Parse the R-CNN window file format (window_data_layer.cpp:71-132):
    repeated blocks of::

        # <image_index>
        <image_path>
        <channels> <height> <width>
        <num_windows>
        <label> <overlap> <x1> <y1> <x2> <y2>   (× num_windows)

    Returns (images, fg_windows, bg_windows) with windows as
    (image_idx, label, overlap, x1, y1, x2, y2)."""
    images: list[tuple[str, tuple[int, int, int]]] = []
    fg, bg = [], []
    with open(source) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        if not lines[i].startswith("#"):
            raise ValueError(f"{source}: expected '# index' at line {i}")
        path = lines[i + 1]
        c, h, w = (int(v) for v in lines[i + 2].split())
        num = int(lines[i + 3])
        img_idx = len(images)
        images.append((path, (c, h, w)))
        i += 4
        for _ in range(num):
            parts = lines[i].split()
            i += 1
            label, overlap = int(parts[0]), float(parts[1])
            x1, y1, x2, y2 = (int(v) for v in parts[2:6])
            win = (img_idx, label, overlap, x1, y1, x2, y2)
            if overlap >= fg_threshold:
                fg.append(win)
            elif overlap < bg_threshold:
                bg.append(win)
    return images, fg, bg
