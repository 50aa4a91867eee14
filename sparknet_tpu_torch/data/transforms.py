"""Host-side image preprocessing in numpy.

The port's copy of ``sparknet_tpu/data/transforms.py``: the mean image
(reference: src/main/scala/preprocessing/ComputeMean.scala:8-44),
random-crop + mirror + mean-subtract train preprocessing and center-crop
test preprocessing (reference: src/main/scala/apps/ImageNetApp.scala:
155-169 and :117-131), with Caffe's DataTransformer semantics
(reference: caffe/src/caffe/data_transformer.cpp), and
``augment_batch_host``, the numpy half of ``ops/augment.py``.
``random_crop_mirror`` crops through the native pipeline (``native``,
numpy where it is not built) and draws from its generator in the JAX
version's order (ys, xs, flips), so the same seed gives the same batches
byte for byte.

Every function takes ``np.asarray(..., np.float32)`` (no copy of an f32
input) and an optional ``out`` buffer to write into: a buffer of the
wrong shape, dtype or layout is ignored and a fresh one allocated.
"""

from __future__ import annotations

import numpy as np


def _take(out: np.ndarray | None, shape: tuple) -> np.ndarray:
    """``out`` when it is f32, C-contiguous and of ``shape``, else a
    fresh buffer."""
    if (out is not None and out.shape == shape and out.dtype == np.float32
            and out.flags["C_CONTIGUOUS"]):
        return out
    return np.empty(shape, np.float32)


def compute_mean_image(images: np.ndarray) -> np.ndarray:
    """Mean image over a stack of images, accumulated in float64."""
    return images.astype(np.float64).mean(axis=0).astype(np.float32)


def subtract_mean(batch: np.ndarray, mean: np.ndarray | float,
                  out: np.ndarray | None = None) -> np.ndarray:
    x = np.asarray(batch, np.float32)
    dest = _take(out, x.shape)
    np.subtract(x, mean, out=dest)
    return dest


def random_crop_mirror(batch: np.ndarray, crop: int,
                       rng: np.random.Generator, mirror: bool = True,
                       mean: np.ndarray | float | None = None,
                       out: np.ndarray | None = None) -> np.ndarray:
    """Random crop to (crop, crop) and a random horizontal mirror of each
    image of an (N, C, H, W) batch, less the mean (DataTransformer's
    train path), through ``native.crop_batch``.  A full-size mean is
    subtracted before the crop, as Caffe indexes the mean at each
    sample's crop window."""
    from .. import native
    n, c, h, w = batch.shape
    ys = rng.integers(0, h - crop + 1, size=n).astype(np.int32)
    xs = rng.integers(0, w - crop + 1, size=n).astype(np.int32)
    flips = (rng.integers(0, 2, size=n) if mirror
             else np.zeros(n)).astype(np.int32)
    if isinstance(mean, np.ndarray) and mean.shape[-2:] != (crop, crop):
        batch = np.asarray(batch, np.float32) - np.asarray(mean, np.float32)
        mean = None
    return native.crop_batch(np.asarray(batch, np.float32), crop,
                             ys, xs, flips, mean, out=out)


def center_crop(batch: np.ndarray, crop: int,
                mean: np.ndarray | float | None = None,
                out: np.ndarray | None = None) -> np.ndarray:
    """Deterministic center crop, less the mean (the test path,
    ImageNetApp.scala:117-131).  A full-size mean is cropped the same
    way."""
    n, c, h, w = batch.shape
    y, x = (h - crop) // 2, (w - crop) // 2
    dest = _take(out, (n, c, crop, crop))
    dest[...] = batch[:, :, y:y + crop, x:x + crop]
    if mean is not None:
        if isinstance(mean, np.ndarray) and mean.shape[-2:] != (crop, crop):
            mean = center_crop_mean(mean, crop)
        np.subtract(dest, mean, out=dest)
    return dest


def center_crop_mean(mean: np.ndarray, crop: int) -> np.ndarray:
    h, w = mean.shape[-2], mean.shape[-1]
    y, x = (h - crop) // 2, (w - crop) // 2
    return mean[..., y:y + crop, x:x + crop]


def scale(batch: np.ndarray, factor: float,
          out: np.ndarray | None = None) -> np.ndarray:
    """DataTransformer's ``scale`` (e.g. 1/256 for LeNet)."""
    x = np.asarray(batch, np.float32)
    dest = _take(out, x.shape)
    np.multiply(x, factor, out=dest)
    return dest


def augment_batch_host(imgs: np.ndarray, generator, spec) -> np.ndarray:
    """``ops.augment.augment_batch`` in numpy, on the host: the same draws
    (``ops.augment.draw_offsets`` on the same CPU generator) and the same
    order (cast, full-size mean subtract, crop, mirror, scale), each op
    IEEE-exact, so ``Solver.set_augment(spec, device=False)`` trains on
    the bits ``device=True`` gives.  The crop and mirror are one
    ``native.crop_batch`` call."""
    from .. import native
    from ..ops.augment import draw_offsets
    n, c, h, w = imgs.shape
    ys, xs, flips = (a.numpy() for a in draw_offsets(generator, n, h, w,
                                                     spec))
    x = np.asarray(imgs).astype(np.float32)
    if spec.mean is not None:
        x = x - np.asarray(spec.mean, np.float32)
    if not (spec.mirror and spec.train):
        flips = np.zeros_like(flips)
    if spec.crop:
        x = native.crop_batch(x, spec.crop, ys, xs, flips)
    elif flips.any():
        x[flips == 1] = x[flips == 1, :, :, ::-1]
    if spec.scale != 1.0:
        x = x * np.float32(spec.scale)
    return x
