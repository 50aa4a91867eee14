"""The port's CMYK conversion (``data/jpeg.py::cmyk_to_rgb``) against
PIL, on the CPU.

PIL reads every CMYK JPEG inverted, as Adobe writes them (rawmode
``CMYK;I``), and its ``convert("RGB")`` is Pillow's ``cmyk2rgb``.  On the
card nvJPEG hands the port the components as the file stores them and
``cmyk_to_rgb`` makes PIL's RGB of them; here it is fed PIL's own
planes (re-inverted to the file's convention) and must give PIL's RGB
bit for bit, on the committed Adobe CMYK fixture and on every value
pair of C and K.  The Adobe marker's transform is read as PIL reads it.
The decode itself runs on the card only (tests/test_torch_cuda_kernels.py
and ``chip_smoke.py`` phase 5j hold it against PIL's pixels).
"""

from __future__ import annotations

import io
import json
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from sparknet_tpu_torch.data import jpeg

FIXTURES = (pathlib.Path(__file__).resolve().parent.parent
            / "sparknet_tpu_torch" / "data" / "png_fixtures")


def _stored(cmyk: np.ndarray) -> torch.Tensor:
    """PIL's CMYK pixels (H, W, 4) -> (4, H, W) as the file stores them."""
    return torch.from_numpy(np.ascontiguousarray(
        (255 - cmyk).transpose(2, 0, 1)))


def test_fixture_converts_to_pils_rgb_bit_for_bit():
    data = (FIXTURES / "cmyk_adobe.jpg").read_bytes()
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "CMYK"
        cmyk = np.asarray(im)
        want = np.asarray(im.convert("RGB"))
    got = jpeg.cmyk_to_rgb(_stored(cmyk), inverted=True)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    np.testing.assert_array_equal(
        got.numpy(), np.load(FIXTURES / manifest["images"]["cmyk_adobe.jpg"]
                             ["rgb_pixels"]))


def test_every_c_and_k_pair_equals_pil():
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, 255 - c, (c * 7) % 256, k], -1).astype(np.uint8)
    want = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    got = jpeg.cmyk_to_rgb(_stored(cmyk), inverted=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_without_the_inversion_the_pixels_differ():
    data = (FIXTURES / "cmyk_adobe.jpg").read_bytes()
    with Image.open(io.BytesIO(data)) as im:
        cmyk, want = np.asarray(im), np.asarray(im.convert("RGB"))
    got = jpeg.cmyk_to_rgb(_stored(cmyk), inverted=False).numpy()
    assert np.abs(got.astype(int) - want).mean() > 20


def test_decode_cmyk_runs_on_the_card_only():
    """nvJPEG's path; the CPU paths read CMYK with PIL, as the JAX
    package does."""
    data = (FIXTURES / "cmyk_adobe.jpg").read_bytes()
    with pytest.raises(ValueError, match="CUDA device"):
        jpeg.decode_cmyk(data, "cpu")


@pytest.mark.parametrize("transform", [0, 1, 2])
def test_adobe_transform_is_read_from_app14(transform):
    arr = np.zeros((8, 8, 4), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "CMYK").save(buf, "JPEG")
    data = bytearray(buf.getvalue())
    at = data.index(b"Adobe")
    assert jpeg.adobe_transform(bytes(data)) == data[at + 11] == 0
    data[at + 11] = transform
    assert jpeg.adobe_transform(bytes(data)) == transform
    plain = (FIXTURES.parent / "jpeg_fixtures" / "s444.jpg").read_bytes()
    assert jpeg.adobe_transform(plain) is None
