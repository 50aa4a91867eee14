"""The port's ``data/pil_resample.py`` against PIL's ``Image.resize``, on
the CPU, over a sweep of sizes: up, down, to and from one pixel, and
ratios that are no integer.

- 8-bit "L" and "RGB" images under ``BILINEAR`` (the JAX package's
  non-JPEG ``load_image``, ``sparknet_tpu/data/db.py:685-686``): bit for
  bit.
- float32 mode "F" planes under ``NEAREST``, ``BILINEAR`` and ``BICUBIC``
  (``sparknet_tpu/pycaffe_io.py:159-172``): within 1e-6 relative.

Pillow is compiled here, so the sweep is the check that its arithmetic
(22-bit fixed-point weights, the rounding of each pass, the support
scaled when shrinking, NEAREST's accumulated positions) was followed.
"""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from sparknet_tpu_torch.data import pil_resample

SOURCES = [(17, 23), (1, 9), (9, 1), (1, 1), (64, 80), (375, 500)]
TARGETS = [(1, 1), (1, 7), (7, 1), (5, 5), (13, 29), (37, 41), (64, 48),
           (100, 3), (256, 256), (227, 227)]
PIL_METHODS = {pil_resample.NEAREST: Image.NEAREST,
               pil_resample.BILINEAR: Image.BILINEAR,
               pil_resample.BICUBIC: Image.BICUBIC}


def _targets(h, w):
    return TARGETS + [(2 * h + 1, 3 * w), (h, w),
                      (max(1, h // 3), max(1, w // 2)), (h + 1, w - 1 or 1)]


@pytest.mark.parametrize("src", SOURCES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_bilinear_8bit_equals_pil_bit_for_bit(src, mode):
    h, w = src
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 256, (h, w) if mode == "L" else (h, w, 3),
                       dtype=np.uint8)
    for oh, ow in _targets(h, w):
        want = np.asarray(Image.fromarray(img, mode).resize(
            (ow, oh), Image.BILINEAR))
        got = pil_resample.resize(img, (oh, ow), pil_resample.BILINEAR)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"to {oh}x{ow}")


@pytest.mark.parametrize("src", SOURCES[:5], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("method", list(PIL_METHODS))
def test_float_planes_equal_pil_within_1e_6(src, method):
    h, w = src
    rng = np.random.default_rng(h * 7 + w)
    plane = (rng.normal(size=(h, w)) * 40 + 100).astype(np.float32)
    for oh, ow in _targets(h, w):
        want = np.asarray(Image.fromarray(plane, "F").resize(
            (ow, oh), PIL_METHODS[method]))
        got = pil_resample.resize(plane, (oh, ow), method)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=f"to {oh}x{ow}")


def test_a_photo_resized_to_caffenets_256_equals_pil():
    """The main path's shape: a 375x500 RGB photo to 256x256."""
    rng = np.random.default_rng(5)
    img = np.clip(rng.normal(128, 60, (375, 500, 3)), 0, 255).astype(
        np.uint8)
    want = np.asarray(Image.fromarray(img).resize((256, 256),
                                                  Image.BILINEAR))
    np.testing.assert_array_equal(pil_resample.resize(img, (256, 256)), want)


def test_same_size_is_a_copy_and_bad_requests_raise():
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    out = pil_resample.resize(img, (3, 4))
    assert out is not img and (out == img).all()
    with pytest.raises(ValueError):
        pil_resample.resize(img, (0, 4))
    with pytest.raises(ValueError):
        pil_resample.resize(img, (5, 5), pil_resample.BICUBIC)
    with pytest.raises(TypeError):
        pil_resample.resize(img.astype(np.float64), (5, 5))
