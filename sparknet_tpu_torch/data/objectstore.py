"""Object-store abstraction for dataset ingestion: the local half.

The port's own copy of ``sparknet_tpu/data/objectstore.py``'s
``ObjectStore`` (:31-50), ``_PooledFd`` (:53) and ``LocalStore``
(:65-158), and ``get_store`` (:297-307) for bare paths and ``file://``.
The reference's workers stream training tars from S3 (reference:
src/main/scala/loaders/ImageNetLoader.scala:25-38 list objects, :56-86
stream-untar); here a store lists keys under a prefix and opens a key as
a byte stream or reads a byte range, which is what the tar index and its
lazy partitions (``data/imagenet.py``) need.  ``s3://`` and ``gs://``
raise, naming ROADMAP A6 (no ``boto3`` or GCS client on the card's
machine).
"""

from __future__ import annotations

import os
import threading
from typing import BinaryIO

OBJECT_STORE_ITEM = ("ROADMAP A6, object store: the port reads local "
                     "paths and file:// only")


class ObjectStore:
    """list/open interface over a keyed byte store."""

    def list_keys(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def open(self, key: str) -> BinaryIO:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def open_range(self, key: str, offset: int, length: int) -> bytes:
        """Random-access read (tar-index lazy decode).  Default: seek."""
        with self.open(key) as f:
            f.seek(offset)
            return f.read(length)

    def close(self) -> None:
        """Release any pooled resources (no-op by default)."""


class _PooledFd:
    """One pooled descriptor: refcounted so eviction under concurrent
    readers defers the close to the last reader out."""

    __slots__ = ("fd", "refs", "evicted")

    def __init__(self, fd: int):
        self.fd = fd
        self.refs = 0
        self.evicted = False


class LocalStore(ObjectStore):
    """Filesystem-backed store; keys are paths relative to ``root``.

    ``open_range`` (the lazy-partition / record-shard hot path — one
    call per record, fanned out over the parallel ranged-read pool) is
    fully thread-safe: reads use per-call ``os.pread`` (positioned read,
    no shared seek cursor to race on) against a small LRU pool of raw
    descriptors.  Only pool bookkeeping happens under the lock; the
    actual IO runs outside it, so N pool workers genuinely read in
    parallel.  A descriptor evicted (or ``close()``d) while readers are
    mid-``pread`` stays open until the last of them releases it —
    eviction can never invalidate a concurrent read."""

    _MAX_HANDLES = 8

    def __init__(self, root: str):
        self.root = root
        self._fds: "dict[str, _PooledFd]" = {}
        self._lock = threading.Lock()

    def _acquire(self, key: str) -> _PooledFd:
        with self._lock:
            h = self._fds.get(key)
            if h is not None:
                # re-insert: plain dicts preserve insertion order, so
                # pop+set keeps the dict LRU-first for eviction
                del self._fds[key]
                self._fds[key] = h
                h.refs += 1
                return h
        # open outside the lock (disk metadata IO must not serialize the
        # pool), then publish — racing openers of the same key keep the
        # first published fd and retire their own
        fd = os.open(os.path.join(self.root, key), os.O_RDONLY)
        with self._lock:
            h = self._fds.get(key)
            if h is not None:
                os.close(fd)
                del self._fds[key]
                self._fds[key] = h
                h.refs += 1
                return h
            h = _PooledFd(fd)
            h.refs = 1
            self._fds[key] = h
            while len(self._fds) > self._MAX_HANDLES:
                oldest = next(iter(self._fds))
                self._evict_locked(oldest)
            return h

    def _evict_locked(self, key: str) -> None:
        h = self._fds.pop(key)
        h.evicted = True
        if h.refs == 0:
            os.close(h.fd)

    def _release(self, h: _PooledFd) -> None:
        with self._lock:
            h.refs -= 1
            if h.evicted and h.refs == 0:
                os.close(h.fd)

    def open_range(self, key: str, offset: int, length: int) -> bytes:
        h = self._acquire(key)
        try:
            return os.pread(h.fd, length, offset)
        finally:
            self._release(h)

    def close(self) -> None:
        with self._lock:
            for key in list(self._fds):
                self._evict_locked(key)

    def __del__(self):  # best-effort fd release
        try:
            self.close()
        except Exception:
            pass

    def list_keys(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), self.root)
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def open(self, key: str) -> BinaryIO:
        return open(os.path.join(self.root, key), "rb")

    def size(self, key: str) -> int:
        return os.path.getsize(os.path.join(self.root, key))


def get_store(url: str) -> tuple[ObjectStore, str]:
    """URL -> (store, key prefix).  Bare paths and file:// map to
    LocalStore; s3:// and gs:// raise, naming their ROADMAP item."""
    if url.startswith(("s3://", "gs://")):
        raise NotImplementedError(f"{url}: {OBJECT_STORE_ITEM}")
    path = url[7:] if url.startswith("file://") else url
    return LocalStore(path), ""
