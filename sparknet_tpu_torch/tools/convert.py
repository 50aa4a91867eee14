"""Convert LMDB / LevelDB / HDF5 / imagenet-tar sources into pre-decoded
record shards (``sparknet_tpu_torch.data.records`` format v1).

The port's counterpart of the root ``tools/convert.py``, with its flags
and its one JSON summary line.  Every record is decoded once here
(Caffe's convert_imageset lesson, arXiv 1408.5093) and written as a
fixed-stride uint8 block with its crc32; every later epoch is ranged
reads, no decode.  A record that fails to decode or is not
uint8-representable goes through the quarantine (its budget from the
``SPARKNET_QUARANTINE_*`` knobs, zero by default, so any corruption is a
typed failure; ``--max-bad-fraction`` budgets it), and the conversion
goes on with the next record (the root tool's generators end at the
first bad record, silently dropping the rest).  Encoded Datums and
tar JPEGs decode on ``--device`` (the card by default,
``data/jpeg.py``); raw Datums and HDF5 need no device.

Shard roll size: ``SPARKNET_RECORD_SHARD_MB`` (default 64) or
``--shard-mb``.  Prints ONE JSON summary line (shards, records,
geometry, quarantine report, source, backend).

Usage:
  python -m sparknet_tpu_torch.tools.convert --source /data/train_lmdb \\
      --backend lmdb --out /data/train_shards
  python -m sparknet_tpu_torch.tools.convert --source /data/train.h5 \\
      --backend hdf5 --out shards [--data-key data --label-key label]
  python -m sparknet_tpu_torch.tools.convert --source /data/tars \\
      --backend tar --labels labels.txt --resize 256 --out shards

Backends: lmdb, leveldb, hdf5, tar, auto (default: sniff the source).
The output directory feeds straight back in: a ``Data`` layer with
``backend: RECORDS`` (or any ``source`` holding ``*.rec``) streams it
through ``records_feed``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _to_uint8(img: np.ndarray, *, source: str, key=None,
              quantize: bool = False) -> np.ndarray:
    """The uint8 form of a decoded record.  Exact-valued floats (a raw
    Datum's 0..255 integers as f32) cast losslessly; with ``quantize``
    (the JPEG-resize path, fractional by nature) values are rounded and
    clipped, once, here.  Anything else is typed corruption for the
    quarantine."""
    from ..data.integrity import DataCorruptionError
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    if quantize:
        return np.clip(np.round(img), 0, 255).astype(np.uint8)
    as_u8 = img.astype(np.uint8)
    if np.array_equal(as_u8.astype(img.dtype), img):
        return as_u8
    raise DataCorruptionError(
        "record is not uint8-representable (float pixels outside exact "
        "0..255); pass --quantize to round-clip at convert time",
        source=source, key=key)


class _Records:
    """(img_u8, label) over ``items``, each decoded by ``decode`` when
    pulled.  An iterator, not a generator: a record whose decode raises
    ``DataCorruptionError`` leaves the stream open, so
    ``convert_to_shards``' quarantine skips that record alone and the
    conversion goes on (a generator ends at its first raise, dropping
    every later record)."""

    def __init__(self, items, decode):
        self._items = iter(items)
        self._decode = decode

    def __iter__(self) -> "_Records":
        return self

    def __next__(self):
        return self._decode(next(self._items))


def iter_db(source: str, backend: str, quantize: bool = False,
            device: str = "cuda") -> _Records:
    """(img_u8, label) in cursor order off an LMDB/LevelDB (the order
    ``db_feed`` replays: the bit identity depends on it)."""
    from ..data.db import datum_to_array, open_db

    def decode(kv):
        key, val = kv
        img, label = datum_to_array(val, key=key, source=source,
                                    device=device)
        return _to_uint8(img, source=source, key=key,
                         quantize=quantize), label

    return _Records(open_db(source, backend).items(), decode)


def iter_hdf5(source: str, data_key: str, label_key: str,
              quantize: bool = False) -> _Records:
    from ..data.hdf5 import load_hdf5_blobs
    blobs = load_hdf5_blobs(source, [data_key, label_key])
    data, labels = blobs[data_key], blobs[label_key]
    if data.ndim != 4:
        raise ValueError(
            f"{source}:{data_key} must be [n, c, h, w], got {data.shape}")
    return _Records(range(data.shape[0]), lambda i: (_to_uint8(
        data[i], source=source, key=i, quantize=quantize), int(labels[i])))


def iter_tars(source: str, label_file: str, resize: int,
              device: str = "cuda"):
    """Decoded (img_u8, label) over every tar under ``source``: the
    ImageNetLoader path (stream-untar, JPEG decode, force-resize) paid
    once.  The resize is fractional, so this path always quantizes."""
    from ..data.imagenet import (decode_and_resize, list_tars,
                                 read_label_map, stream_tar_images)
    labels = read_label_map(label_file)
    for tar in list_tars(source):
        pairs = stream_tar_images(tar, labels)
        for img, label in decode_and_resize(pairs, resize, device):
            yield _to_uint8(img, source=tar, quantize=True), label


def sniff_backend(source: str) -> str:
    from ..data.hdf5 import is_hdf5_file
    if os.path.isfile(source):
        return "hdf5" if is_hdf5_file(source) else "lmdb"
    if os.path.isdir(source):
        names = os.listdir(source)
        if any(n.endswith(".tar") for n in names):
            return "tar"
        if any(n.endswith(".mdb") for n in names):
            return "lmdb"
        if any(n.endswith((".ldb", ".sst", ".log")) for n in names):
            return "leveldb"
    raise ValueError(
        f"cannot sniff a backend for {source!r}; pass --backend")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True,
                    help="LMDB/LevelDB dir, .h5 file, or tar root")
    ap.add_argument("--out", required=True,
                    help="output shard directory (created)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "lmdb", "leveldb", "hdf5", "tar"])
    ap.add_argument("--labels", default=None,
                    help="label map file (tar backend)")
    ap.add_argument("--resize", type=int, default=256,
                    help="force-resize edge for the tar backend")
    ap.add_argument("--data-key", default="data")
    ap.add_argument("--label-key", default="label")
    ap.add_argument("--quantize", action="store_true",
                    help="round-clip non-integer float pixels to uint8 "
                         "instead of quarantining them")
    ap.add_argument("--max-bad-fraction", type=float, default=None,
                    help="quarantine budget override (default: the "
                         "SPARKNET_QUARANTINE_* knobs)")
    ap.add_argument("--shard-mb", type=int, default=None,
                    help="shard roll size override "
                         "(default SPARKNET_RECORD_SHARD_MB)")
    ap.add_argument("--device", default="cuda",
                    help="where encoded images decode: cuda (default) or "
                         "cpu")
    args = ap.parse_args(argv)

    from ..data.integrity import Quarantine, QuarantinePolicy
    from ..data.records import convert_to_shards

    backend = args.backend
    if backend == "auto":
        backend = sniff_backend(args.source)
    if backend in ("lmdb", "leveldb"):
        records = iter_db(args.source, backend.upper(),
                          quantize=args.quantize, device=args.device)
    elif backend == "hdf5":
        records = iter_hdf5(args.source, args.data_key, args.label_key,
                            quantize=args.quantize)
    else:
        if not args.labels:
            ap.error("--backend tar requires --labels")
        records = iter_tars(args.source, args.labels, args.resize,
                            device=args.device)

    policy = (QuarantinePolicy(max_fraction=args.max_bad_fraction)
              if args.max_bad_fraction is not None
              else QuarantinePolicy.from_env())
    quarantine = Quarantine(policy, source=args.source)
    summary = convert_to_shards(
        records, args.out, quarantine=quarantine,
        shard_bytes=args.shard_mb * (1 << 20) if args.shard_mb else None)
    summary["source"] = args.source
    summary["backend"] = backend
    print(json.dumps(summary, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
