"""PIL's ``Image.resize``, in numpy, for the two places the JAX package
resizes with PIL:

- ``BILINEAR`` on 8-bit images: a non-JPEG ``ImageData`` or image file
  read with a new size (``sparknet_tpu/data/db.py:685-686``);
- ``NEAREST``, ``BILINEAR`` and ``BICUBIC`` on float images, one mode
  ``F`` channel at a time (``sparknet_tpu/pycaffe_io.py:159-172``).

It follows Pillow's ``libImaging/Resample.c`` and, for ``NEAREST``,
``Geometry.c``'s scaling affine transform; the card's machine has no PIL,
and this runs on the host on both devices.

Bilinear and bicubic are separable: a horizontal pass, then a vertical
one.  For each output position the source window is centred at
(i + 0.5)·scale, its support the filter's (1 bilinear, 2 bicubic with
a = -0.5) times max(scale, 1), so that shrinking averages; the weights
are the filter at (j - centre + 0.5)/max(scale, 1), summed in order and
normalized.  On 8-bit images each pass turns the weights into 22-bit
fixed point (rounded half away from zero), adds half a unit, and
clips the shifted sum to 0-255, so the horizontal pass's rounding feeds
the vertical one.  On float images each pass sums in float64, in order,
and stores float32.  ``NEAREST`` takes source index int(x0 + k·s) with
x0 = s/2, stepping by s = in/out in float64 as Pillow accumulates it.
The same size returns a copy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NEAREST", "BILINEAR", "BICUBIC", "resize"]

NEAREST, BILINEAR, BICUBIC = "nearest", "bilinear", "bicubic"
_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, method: str):
    """Pillow's ``precompute_coeffs``: per output position the first source
    index, the window's length and its normalized float64 weights, as
    (xmin (out,), count (out,), weights (out, ksize))."""
    filt, base = _FILTERS[method]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    j = np.arange(ksize)
    w = filt((j[None, :] + xmin[:, None] - center[:, None] + 0.5)
             * (1.0 / filterscale))
    w = np.where(j[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):            # in order, as the C loop sums
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    return xmin, xmax, w


def _pass_u8(img: np.ndarray, out_size: int, method: str) -> np.ndarray:
    """One 8-bit pass along axis 1 of (rows, n, channels) uint8 (the
    weights past each window are 0)."""
    xmin, _, w = _coeffs(img.shape[1], out_size, method)
    scaled = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + np.arange(w.shape[1])[None, :],
                     img.shape[1] - 1)
    src = img.astype(np.int64)[:, idx]             # (rows, out, ksize, ch)
    ss = (1 << (_PRECISION_BITS - 1)) + (src * k[None, :, :, None]).sum(2)
    return np.clip(ss >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass_f32(img: np.ndarray, out_size: int, method: str) -> np.ndarray:
    """One float pass along axis 1 of (rows, n) float32: float64 sums in
    order, stored float32."""
    xmin, count, w = _coeffs(img.shape[1], out_size, method)
    src = img.astype(np.float64)
    ss = np.zeros((img.shape[0], out_size))
    for k in range(w.shape[1]):
        idx = np.minimum(xmin + k, img.shape[1] - 1)
        ss = ss + np.where(k < count, src[:, idx] * w[:, k], 0.0)
    return ss.astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's ``ImagingScaleAffine`` positions: int(x0 + k·s) with
    s = in/out, x0 = s/2, accumulated in float64; -1 where off the
    source."""
    s = float(in_size) / out_size
    xo = np.add.accumulate(np.r_[s * 0.5, np.full(out_size - 1, s)])
    xin = np.where(xo < 0.0, -1, np.trunc(xo)).astype(np.int64)
    return np.where(xin < in_size, xin, -1)


def resize(img: np.ndarray, size: tuple[int, int],
           method: str = BILINEAR) -> np.ndarray:
    """PIL's ``Image.resize((w, h), method)`` of ``img``: (H, W) or
    (H, W, C) uint8 (``BILINEAR``: an "L" or "RGB" image), or (H, W)
    float32 (a mode "F" image, any method) -> the same at ``size`` =
    (height, width)."""
    oh, ow = int(size[0]), int(size[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"resize: output {oh}x{ow}")
    if method not in (NEAREST, BILINEAR, BICUBIC):
        raise ValueError(f"resize: method {method!r}")
    if img.dtype == np.uint8:
        if method != BILINEAR:
            raise ValueError("resize: 8-bit images take BILINEAR here")
    elif img.dtype != np.float32 or img.ndim != 2:
        raise TypeError(f"resize: wants uint8 or a float32 (H, W) plane, "
                        f"got {img.dtype} {img.shape}")
    if img.shape[:2] == (oh, ow):
        return img.copy()
    if method == NEAREST:
        ys, xs = _nearest_index(img.shape[0], oh), _nearest_index(
            img.shape[1], ow)
        out = img[np.maximum(ys, 0)][:, np.maximum(xs, 0)]
        out[ys < 0] = 0
        out[:, xs < 0] = 0
        return out
    if img.dtype == np.uint8:
        x = img if img.ndim == 3 else img[:, :, None]
        if x.shape[1] != ow:
            x = _pass_u8(x, ow, method)
        if x.shape[0] != oh:
            x = _pass_u8(x.transpose(1, 0, 2), oh, method).transpose(1, 0, 2)
        x = np.ascontiguousarray(x)
        return x if img.ndim == 3 else x[:, :, 0]
    x = img
    if x.shape[1] != ow:
        x = _pass_f32(x, ow, method)
    if x.shape[0] != oh:
        x = _pass_f32(np.ascontiguousarray(x.T), oh, method).T
    return np.ascontiguousarray(x)
