"""Host-side image preprocessing in numpy.

The port's copy of the part of ``sparknet_tpu/data/transforms.py``
(:39-98) that the training slice uses: the mean image (reference:
src/main/scala/preprocessing/ComputeMean.scala:8-44), random-crop +
mirror + mean-subtract train preprocessing and center-crop test
preprocessing (reference: src/main/scala/apps/ImageNetApp.scala:155-169
and :117-131), with Caffe's DataTransformer semantics (reference:
caffe/src/caffe/data_transformer.cpp).  There is no native library: the
crops are numpy slices.  ``random_crop_mirror`` draws from its generator
in the JAX version's order (ys, xs, flips), so the same seed gives the
same batches byte for byte.
"""

from __future__ import annotations

import numpy as np


def compute_mean_image(images: np.ndarray) -> np.ndarray:
    """Mean image over a stack of images, accumulated in float64."""
    return images.astype(np.float64).mean(axis=0).astype(np.float32)


def random_crop_mirror(batch: np.ndarray, crop: int,
                       rng: np.random.Generator, mirror: bool = True,
                       mean: np.ndarray | float | None = None) -> np.ndarray:
    """Random crop to (crop, crop) and a random horizontal mirror of each
    image of an (N, C, H, W) batch, less the mean (DataTransformer's
    train path).  A full-size mean is subtracted before the crop, as
    Caffe indexes the mean at each sample's crop window."""
    n, c, h, w = batch.shape
    ys = rng.integers(0, h - crop + 1, size=n)
    xs = rng.integers(0, w - crop + 1, size=n)
    flips = (rng.integers(0, 2, size=n) if mirror
             else np.zeros(n, np.int64))
    x = np.asarray(batch, np.float32)
    if isinstance(mean, np.ndarray) and mean.shape[-2:] != (crop, crop):
        x = x - np.asarray(mean, np.float32)
        mean = None
    out = np.empty((n, c, crop, crop), np.float32)
    for i in range(n):
        img = x[i, :, ys[i]:ys[i] + crop, xs[i]:xs[i] + crop]
        out[i] = img[:, :, ::-1] if flips[i] else img
    if mean is not None:
        out -= np.asarray(mean, np.float32)
    return out


def center_crop(batch: np.ndarray, crop: int,
                mean: np.ndarray | float | None = None) -> np.ndarray:
    """Deterministic center crop, less the mean (the test path,
    ImageNetApp.scala:117-131).  A full-size mean is cropped the same
    way."""
    n, c, h, w = batch.shape
    y, x = (h - crop) // 2, (w - crop) // 2
    out = np.array(batch[:, :, y:y + crop, x:x + crop], np.float32)
    if mean is not None:
        if isinstance(mean, np.ndarray) and mean.shape[-2:] != (crop, crop):
            mean = mean[..., y:y + crop, x:x + crop]
        out -= np.asarray(mean, np.float32)
    return out
