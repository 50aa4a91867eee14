"""MNIST idx-format IO (for the LeNet config; reference zoo:
caffe/examples/mnist), with a writer for format-exact test fixtures.

The port's own copy of ``sparknet_tpu/data/mnist.py``."""

from __future__ import annotations

import os
import struct

import numpy as np


def load_mnist_idx(image_path: str, label_path: str
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Read idx3/idx1 files -> (images [N,1,H,W] float32 0..255, labels [N])."""
    with open(image_path, "rb") as f:
        magic, n, h, w = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx3 magic {magic}")
        images = np.frombuffer(f.read(n * h * w), np.uint8)
    with open(label_path, "rb") as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx1 magic {magic}")
        labels = np.frombuffer(f.read(n2), np.uint8)
    return (images.reshape(n, 1, h, w).astype(np.float32),
            labels.astype(np.int32))


def write_mnist_idx(image_path: str, label_path: str, images: np.ndarray,
                    labels: np.ndarray) -> None:
    n, _, h, w = images.shape
    os.makedirs(os.path.dirname(image_path) or ".", exist_ok=True)
    with open(image_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, h, w))
        f.write(np.asarray(images, np.uint8).tobytes())
    with open(label_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(np.asarray(labels, np.uint8).tobytes())
