"""CIFAR-10 binary-format IO.

The port's own copy of ``sparknet_tpu/data/cifar.py``.  Reads the
standard CIFAR-10 binary batches — one record is a label byte followed by
3072 CHW pixel bytes — as the reference's loader does (reference:
src/main/scala/loaders/CifarLoader.scala:65 readBatch; train-set shuffle
via random permutation at :34).  Records are decoded with numpy, the JAX
package's own path where its native library is not built
(sparknet_tpu/native/__init__.py:102-105).  A writer makes format-exact
fixtures, so tests need no download.
"""

from __future__ import annotations

import os

import numpy as np

CIFAR_SHAPE = (3, 32, 32)
_REC = 1 + 3 * 32 * 32


def load_cifar10_binary(paths: list[str] | str, shuffle: bool = False,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Read batch file(s) -> (images [N,3,32,32] float32 in [0,255],
    labels [N] int32)."""
    if isinstance(paths, str):
        paths = [paths]
    if not paths:
        raise FileNotFoundError("no CIFAR batch files given")
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(f"CIFAR batch file not found: {p}")
    images, labels = [], []
    for path in paths:
        raw = np.fromfile(path, dtype=np.uint8)
        if raw.size % _REC:
            raise ValueError(
                f"{path}: size {raw.size} not a multiple of {_REC}")
        recs = raw.reshape(-1, _REC)
        labels.append(recs[:, 0].astype(np.int32))
        images.append(recs[:, 1:].reshape((-1,) + CIFAR_SHAPE)
                      .astype(np.float32))
    x = np.concatenate(images)
    y = np.concatenate(labels)
    if shuffle:
        perm = np.random.default_rng(seed).permutation(len(x))
        x, y = x[perm], y[perm]
    return x, y


def write_cifar10_binary(path: str, images: np.ndarray,
                         labels: np.ndarray) -> None:
    """Write records in the binary batch format (test-fixture generator)."""
    n = len(labels)
    out = np.empty((n, _REC), np.uint8)
    out[:, 0] = np.asarray(labels, np.uint8)
    out[:, 1:] = np.asarray(images, np.uint8).reshape(n, -1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out.tofile(path)
