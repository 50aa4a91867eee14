"""ImageNet-style loader: tar archives of JPEGs and a filename -> label map.

The port's own copy of ``sparknet_tpu/data/imagenet.py``.  The reference's
S3 loader chain (reference: src/main/scala/loaders/ImageNetLoader.scala:
list tar objects :25-38, read the ``train.txt`` label map :41-54, stream
JPEG bytes out of each tar :56-86, ``apply`` :91 yielding (bytes, label)
pairs) followed by decode and force-resize (reference:
src/main/scala/preprocessing/ScaleAndConvert.scala:16-27, undecodable
images dropped :23-25).

Records are decoded on access (``LazyTarPartition``) by ``data/jpeg.py``:
nvJPEG and the resize kernel on the card by default, PIL and the plain
resize on the CPU when asked.  Each image comes back to the host as
float32 (3, size, size), the JAX package's item, so ``RoundFeed`` and the
device feed run on it unchanged.
"""

from __future__ import annotations

import os
import tarfile
from typing import Iterator

import numpy as np
import torch

from . import jpeg
from .partition import PartitionedDataset


def read_label_map(path: str) -> dict[str, int]:
    """Parse a ``train.txt``-style "filename label" map
    (ImageNetLoader.getLabels, reference: ImageNetLoader.scala:41-54)."""
    labels: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, lab = line.rsplit(None, 1)
            labels[os.path.basename(name)] = int(lab)
    return labels


def list_tars(root: str, prefix: str = "") -> list[str]:
    """All .tar files under ``root`` matching the key prefix
    (ImageNetLoader.getFilePathsRDD, reference: ImageNetLoader.scala:25-38)."""
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".tar"):
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                if rel.startswith(prefix):
                    out.append(os.path.join(dirpath, f))
    return sorted(out)


def stream_tar_images(tar_path: str, labels: dict[str, int],
                      ) -> Iterator[tuple[bytes, int]]:
    """Stream (jpeg bytes, label) from one tar
    (ImageNetLoader.loadImagesFromTar, reference: ImageNetLoader.scala:56-86).
    Entries missing from the label map are skipped."""
    with tarfile.open(tar_path) as tf:
        for member in tf:
            if not member.isfile():
                continue
            name = os.path.basename(member.name)
            if name not in labels:
                continue
            f = tf.extractfile(member)
            if f is None:
                continue
            yield f.read(), labels[name]


def decode_image(data: bytes, size: int,
                 device: str | torch.device) -> np.ndarray | None:
    """JPEG bytes -> host float32 (3, size, size), force-resized on
    ``device``; None when undecodable."""
    img = jpeg.decode_jpeg_resize(data, size, size, device)
    return None if img is None else img.cpu().numpy()


def decode_and_resize(pairs: Iterator[tuple[bytes, int]], size: int = 256,
                      device: str | torch.device = "cuda",
                      ) -> Iterator[tuple[np.ndarray, int]]:
    """JPEG -> planar f32 (3, size, size), force-resize; undecodable images
    dropped (ScaleAndConvert semantics)."""
    for data, label in pairs:
        img = decode_image(data, size, device)
        if img is not None:
            yield img, label


class LazyTarPartition:
    """A partition of (image, label) records decoded on access.

    Holds only an index, (tar key, byte offset, byte size, label) per
    record, so resident memory grows with the records, not their pixels.
    Slicing decodes just the touched window, which is RoundFeed's
    contiguous-run access.  An undecodable entry is counted in
    ``dropped`` and replaced by the partition's first decodable image and
    its label, so batch shapes stay static (ScaleAndConvert's drop).
    ``decoded_count`` counts every record read, dropped ones included.
    A decoder that fails raises from the read; it is never a drop."""

    def __init__(self, entries: list[tuple[str, int, int, int]],
                 store, size: int, device: str | torch.device = "cuda"):
        self.entries = entries
        self.store = store
        self.size = size
        self.device = device
        self.decoded_count = 0
        self.dropped = 0
        self._fallback: tuple[np.ndarray, int] | None = None

    def __len__(self) -> int:
        return len(self.entries)

    def _get_fallback(self) -> tuple[np.ndarray, int]:
        """First decodable record of the partition (image and its label:
        the corrupt record's label under other pixels would be label
        noise)."""
        if self._fallback is None:
            for key, off, nbytes, label in self.entries:
                raw = self.store.open_range(key, off, nbytes)
                img = decode_image(raw, self.size, self.device)
                if img is not None:
                    self._fallback = (img, label)
                    break
            else:
                raise RuntimeError(
                    "no image in this partition decodes: every entry is "
                    "undecodable JPEG data")
        return self._fallback

    def _decode(self, entry) -> tuple[np.ndarray, int]:
        key, off, nbytes, label = entry
        raw = self.store.open_range(key, off, nbytes)
        self.decoded_count += 1
        img = decode_image(raw, self.size, self.device)
        if img is None:
            self.dropped += 1
            return self._get_fallback()
        if self._fallback is None:
            self._fallback = (img, label)
        return img, label

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self._decode(e) for e in self.entries[idx]]
        return self._decode(self.entries[idx])

    def __iter__(self):
        for e in self.entries:
            yield self._decode(e)


def index_tars(source: str, label_file: str, prefix: str = "",
               store=None) -> list[tuple[str, int, int, int]]:
    """One sequential pass over the tar headers building the lazy record
    index (no image bytes are read).  ``source``: a local directory or a
    file:// URL (reference: ImageNetLoader.scala:25-54).  Pass ``store``
    to reuse an open store."""
    if store is None:
        from .objectstore import get_store
        store, key_prefix = get_store(source)
    else:
        key_prefix = ""
    labels = read_label_map(label_file)
    entries: list[tuple[str, int, int, int]] = []
    for key in store.list_keys(key_prefix or prefix):
        if not key.endswith(".tar"):
            continue
        with store.open(key) as f:
            with tarfile.open(fileobj=f, mode="r|") as tf:  # streaming
                for member in tf:
                    if not member.isfile():
                        continue
                    name = os.path.basename(member.name)
                    if name not in labels:
                        continue
                    entries.append((key, member.offset_data, member.size,
                                    labels[name]))
    if not entries:
        raise FileNotFoundError(
            f"no labeled images found under {source!r} "
            f"(labels: {len(labels)} entries)")
    return entries


def load_imagenet(tar_root: str, label_file: str, num_partitions: int,
                  size: int = 256, prefix: str = "", seed: int = 0,
                  device: str | torch.device = "cuda",
                  ) -> PartitionedDataset:
    """Full chain: tars -> record index -> shuffled, lazily decoded
    partitions (ImageNetLoader.apply, reference: ImageNetLoader.scala:91;
    decode on access in place of the up-front ScaleAndConvert map)."""
    from .objectstore import get_store
    store, key_prefix = get_store(tar_root)
    entries = index_tars(tar_root, label_file, key_prefix or prefix,
                         store=store)
    rng = np.random.default_rng(seed)
    rng.shuffle(entries)
    parts = []
    n = max(1, num_partitions)
    per = len(entries) // n
    for w in range(n):
        lo = w * per
        hi = lo + per if w < n - 1 else len(entries)
        parts.append(LazyTarPartition(entries[lo:hi], store, size, device))
    return PartitionedDataset(parts)
