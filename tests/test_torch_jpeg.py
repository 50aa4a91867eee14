"""The port's JPEG decoder (``sparknet_tpu_torch/data/jpeg.py``) and its
resize kernel's plain version against the JAX package's native libjpeg
path, on the CPU, and the committed JPEG fixtures rebuilt from their
seeds.

On the CPU the port decodes with PIL and resizes with
``resize_bilinear_reference``; the JAX package decodes with libjpeg and
resizes in C++ (``sparknet_tpu/native/data_pipeline.cpp:202-276``).  Both
are libjpeg-turbo's islow IDCT with fancy upsampling and the same float32
operations in the same order, so the tolerance is zero: bit for bit, at
256x256, 20x20, an upscale, 1x1 and the natural size, and the same drops.

The fixtures (``sparknet_tpu_torch/data/jpeg_fixtures/``, read by
``chip_smoke.py`` on the card, where nvJPEG is held against their
libjpeg pixels) are made here from seeded numpy:

    python tests/test_torch_jpeg.py --write

``test_fixtures_rebuild_from_their_seeds`` rebuilds them and checks the
bytes, the expected pixels and the manifest.  A ``cuda``-marked test
holds the resize kernel against its plain version; it skips here.
"""

from __future__ import annotations

import hashlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "sparknet_tpu_torch" / "data" / "jpeg_fixtures"


# ---------------------------------------------------------------------------
# The fixtures, from seeds
# ---------------------------------------------------------------------------

def scene(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: smooth colour waves, four flat rectangles with
    hard edges, and a little luma noise (no chroma noise, as in photos)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    fy, fx = rng.uniform(0.01, 0.05, 2)
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([120 + 80 * np.sin(xx * fx + ph[c])
                    * np.cos(yy * fy + ph[c] / 2) for c in range(3)], -1)
    for _ in range(4):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        y1 = y0 + rng.integers(3, max(4, h // 3))
        x1 = x0 + rng.integers(3, max(4, w // 3))
        img[y0:y1, x0:x1] = rng.integers(0, 256, 3)
    img += rng.normal(0, 3, (h, w, 1))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _encode(arr: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    from PIL import Image
    im = Image.fromarray(arr)
    if mode != "RGB":
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


# name -> (height, width), seed, PIL mode, save options; sizes no multiple
# of 16 but for one
SMALL = {
    "s420": ((37, 53), 1, "RGB", dict(quality=90, subsampling="4:2:0")),
    "s422": ((40, 61), 2, "RGB", dict(quality=90, subsampling="4:2:2")),
    "s444": ((33, 47), 3, "RGB", dict(quality=90, subsampling="4:4:4")),
    "gray": ((45, 30), 4, "L", dict(quality=90)),
    "progressive": ((50, 70), 5, "RGB", dict(quality=90, subsampling="4:2:0",
                                             progressive=True)),
    "restart": ((49, 66), 6, "RGB", dict(quality=90, subsampling="4:2:0",
                                         restart_marker_blocks=2)),
    "cmyk": ((40, 40), 7, "CMYK", dict(quality=90)),
    "truncated": ((64, 80), 8, "RGB", dict(quality=90, subsampling="4:2:0")),
}
TRUNCATE_AT = 2 / 3     # of the truncated fixture's bytes: inside its scan
UNDECODABLE = {"garbage": b"not a jpeg at all",
               "header_only": b"\xff\xd8\xff\xe0truncated"}
# ImageNet's common sizes (height, width), q90, 4:2:0 (PIL's default)
IMAGENET = [(375, 500), (500, 375), (333, 500), (500, 333), (400, 500),
            (334, 500), (500, 500), (300, 400)]


def libjpeg_pixels(data: bytes) -> np.ndarray | None:
    """(H, W, 3) uint8 as libjpeg decodes ``data`` to RGB (PIL's
    libjpeg-turbo, an EOI appended as the native pipeline's memory source
    supplies one at the end of a cut scan), or None where libjpeg's
    ``JCS_RGB`` refuses it."""
    from PIL import Image
    try:
        im = Image.open(io.BytesIO(data + b"\xff\xd9"))
        if len(im.getbands()) == 4:
            return None
        return np.asarray(im.convert("RGB"), np.uint8)
    except Exception:
        return None


def build_fixtures() -> tuple[dict[str, bytes], dict]:
    """Every fixture file's bytes by name, and the manifest."""
    files: dict[str, bytes] = {}
    small, imagenet = {}, {}
    for name, (hw, seed, mode, kw) in SMALL.items():
        data = _encode(scene(*hw, seed), mode, **kw)
        if name == "truncated":
            data = data[:int(len(data) * TRUNCATE_AT)]
        files[f"{name}.jpg"] = data
        px = libjpeg_pixels(data)
        entry = {"file": f"{name}.jpg", "height": hw[0], "width": hw[1],
                 "mode": mode, "options": kw,
                 "sha256": hashlib.sha256(data).hexdigest(),
                 "pixels": None if px is None else f"{name}.npy"}
        if px is not None:
            buf = io.BytesIO()
            np.save(buf, px)
            files[f"{name}.npy"] = buf.getvalue()
        small[name] = entry
    for name, data in UNDECODABLE.items():
        files[f"{name}.jpg"] = data
        small[name] = {"file": f"{name}.jpg",
                       "sha256": hashlib.sha256(data).hexdigest(),
                       "pixels": None}
    for i, hw in enumerate(IMAGENET):
        data = _encode(scene(*hw, 100 + i), quality=90)
        files[f"imagenet_{i}.jpg"] = data
        px = libjpeg_pixels(data)
        imagenet[f"imagenet_{i}"] = {
            "file": f"imagenet_{i}.jpg", "height": hw[0], "width": hw[1],
            "sha256": hashlib.sha256(data).hexdigest(),
            "channel_mean": [float(v) for v in
                             px.reshape(-1, 3).mean(0, dtype=np.float64)]}
    manifest = {"seeds": "tests/test_torch_jpeg.py::build_fixtures",
                "small": small, "imagenet": imagenet}
    files["manifest.json"] = (json.dumps(manifest, indent=1, sort_keys=True)
                              + "\n").encode()
    return files, manifest


def write_fixtures() -> None:
    FIXTURES.mkdir(parents=True, exist_ok=True)
    files, _ = build_fixtures()
    for name, data in files.items():
        (FIXTURES / name).write_bytes(data)


if __name__ == "__main__" and "--write" in sys.argv:
    write_fixtures()
    sys.exit(0)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

from sparknet_tpu import native  # noqa: E402
from sparknet_tpu_torch.data import jpeg  # noqa: E402
from sparknet_tpu_torch.ops import cuda_kernels as ck  # noqa: E402


def _manifest() -> dict:
    return json.loads((FIXTURES / "manifest.json").read_text())


def _read(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def _all_jpegs() -> list[str]:
    m = _manifest()
    return sorted(e["file"] for e in m["small"].values()) + sorted(
        e["file"] for e in m["imagenet"].values())


def test_fixtures_rebuild_from_their_seeds():
    files, manifest = build_fixtures()
    on_disk = {p.name for p in FIXTURES.iterdir() if p.is_file()}
    assert on_disk == set(files)
    for name, data in files.items():
        assert _read(name) == data, name
    assert sum(len(v) for v in files.values()) < 1 << 20
    small = manifest["small"]
    for name, e in small.items():
        data = _read(e["file"])
        assert hashlib.sha256(data).hexdigest() == e["sha256"]
        if e["pixels"]:
            px = np.load(FIXTURES / e["pixels"])
            assert px.dtype == np.uint8
            assert px.shape == (e["height"], e["width"], 3)
    # the set covers what the decoder must take
    assert {e.get("mode") for e in small.values()} >= {"RGB", "L", "CMYK"}
    subs = {e["options"].get("subsampling") for e in small.values()
            if "options" in e}
    assert subs >= {"4:2:0", "4:2:2", "4:4:4"}
    assert b"\xff\xdd" in _read("restart.jpg")         # DRI marker
    assert b"\xff\xc2" in _read("progressive.jpg")     # SOF2
    assert any(e.get("height", 16) % 16 and e.get("width", 16) % 16
               for e in small.values())
    assert small["cmyk"]["pixels"] is None
    assert small["truncated"]["pixels"] is not None
    for e in manifest["imagenet"].values():
        px = libjpeg_pixels(_read(e["file"]))
        assert px.shape == (e["height"], e["width"], 3)
        np.testing.assert_array_equal(px.reshape(-1, 3).mean(0),
                                      e["channel_mean"])


SIZES = [(256, 256), (20, 20), (300, 97), (1, 1), (1, 50), (50, 1)]


@pytest.mark.parametrize("name", [
    "s420.jpg", "s422.jpg", "s444.jpg", "gray.jpg", "progressive.jpg",
    "restart.jpg", "truncated.jpg", "imagenet_0.jpg", "imagenet_7.jpg"])
def test_decode_resize_equals_native_bit_for_bit(name):
    data = _read(name)
    h, w = jpeg.jpeg_size(data)
    for oh, ow in SIZES + [(h, w), (2 * h + 1, 3 * w)]:
        want = native.decode_jpeg_resize(data, oh, ow)
        got = jpeg.decode_jpeg_resize(data, oh, ow, "cpu")
        assert got.dtype == torch.float32 and got.shape == (3, oh, ow)
        assert got.numpy().tobytes() == want.tobytes(), (oh, ow)
        gray = jpeg.decode_jpeg_resize(data, oh, ow, "cpu", gray=True)
        assert gray.numpy().tobytes() == want.mean(
            0, keepdims=True).tobytes(), (oh, ow)
    # natural size: an exact copy of libjpeg's pixels
    nat = jpeg.decode_jpeg(data, "cpu").numpy()
    assert nat.tobytes() == native.decode_jpeg_resize(data, h, w).tobytes()
    px = libjpeg_pixels(data)
    np.testing.assert_array_equal(nat, px.transpose(2, 0, 1))
    np.testing.assert_array_equal(jpeg.decode_rgb(data, "cpu").numpy(), px)


@pytest.mark.parametrize("name", ["cmyk.jpg", "garbage.jpg",
                                  "header_only.jpg"])
def test_drops_equal_native(name):
    data = _read(name)
    assert native.decode_jpeg_resize(data, 8, 8) is None
    assert jpeg.decode_jpeg_resize(data, 8, 8, "cpu") is None
    assert jpeg.decode_jpeg(data, "cpu") is None
    assert jpeg.decode_rgb(data, "cpu") is None


def test_truncated_scan_decodes_with_libjpeg_fill():
    """libjpeg warns on a scan cut short and fills the rest from zeroed
    coefficients (mid-gray); the native pipeline returns that image, and
    so does the port's CPU path."""
    data = _read("truncated.jpg")
    want = native.decode_jpeg_resize(data, 64, 80)
    got = jpeg.decode_jpeg(data, "cpu").numpy()
    assert got.tobytes() == want.tobytes()
    assert (got[:, -8:] == 128).all()        # the filled rows
    assert not (got[:, :8] == 128).all()     # the decoded rows


def test_luma601_equals_pil_convert_l():
    from PIL import Image
    for name in _all_jpegs():
        data = _read(name)
        rgb = jpeg.decode_rgb(data, "cpu")
        if rgb is None or name == "truncated.jpg":
            continue
        want = np.asarray(Image.open(io.BytesIO(data)).convert("L"),
                          np.float32)
        np.testing.assert_array_equal(jpeg.luma601(rgb).numpy()[0], want)


def test_jpeg_size_reads_the_frame_header():
    m = _manifest()
    for e in list(m["small"].values()) + list(m["imagenet"].values()):
        if "height" in e:
            assert jpeg.jpeg_size(_read(e["file"])) == (e["height"],
                                                        e["width"])
    assert jpeg.jpeg_size(b"not a jpeg") is None
    assert jpeg.jpeg_size(b"\xff\xd8\xff\xe0trunc") is None


@pytest.mark.parametrize("fault", ["f64", "swap"])
def test_planted_resize_faults_differ_from_the_plain_version(fault):
    """The faults ``chip_smoke.py`` plants against the resize kernel show
    at the main path's shape, 375x500 -> 256x256, and in an upscale."""
    from chip_smoke import planted_resize
    src = jpeg.decode_rgb(_read("imagenet_0.jpg"), "cpu")
    assert src.shape == (375, 500, 3)
    up = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (64, 48, 3), dtype=np.uint8))
    for img in (src, up):
        want = ck.resize_bilinear_reference(img, 256, 256)
        assert not torch.equal(planted_resize(img, 256, 256, fault), want)


@pytest.mark.parametrize("fault", ["box", "swap"])
def test_planted_colour_faults_differ_from_the_plain_version(fault):
    """The faults ``chip_smoke.py`` plants against ``ycc_to_rgb`` show on
    4:2:0 and 4:2:2 planes."""
    from chip_smoke import planted_ycc
    rng = np.random.default_rng(2)
    for (h, w), (ch, cw) in (((375, 500), (188, 250)), ((40, 61), (40, 31))):
        y, cb, cr = (torch.from_numpy(rng.integers(0, 256, s,
                                                   dtype=np.uint8))
                     for s in ((h, w), (ch, cw), (ch, cw)))
        want = ck.ycc_to_rgb_reference(y, cb, cr)
        assert not torch.equal(planted_ycc(y, cb, cr, fault), want)


def libjpeg_upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libjpeg-turbo's chroma upsampling, loop for loop as jdsample.c
    writes it (h2v1_fancy_upsample, h2v2_fancy_upsample with its row
    context, and the replicating h2v1_upsample/h2v2_upsample that
    jinit_upsampler picks for chroma at most 2 wide)."""
    c = c.astype(np.int64)
    ch, cw = c.shape
    sub_h, sub_v = (1 if cw == w else 2), (1 if ch == h else 2)
    if sub_h == 1:
        return c
    out = np.zeros((ch * sub_v, 2 * cw), np.int64)
    for r in range(ch):
        if cw <= 2:
            for v in range(sub_v):
                out[r * sub_v + v] = np.repeat(c[r], 2)
            continue
        if sub_v == 1:
            row, o = c[r], out[r]
            o[0] = row[0]
            o[1] = (row[0] * 3 + row[1] + 2) >> 2
            for i in range(1, cw - 1):
                o[2 * i] = (row[i] * 3 + row[i - 1] + 1) >> 2
                o[2 * i + 1] = (row[i] * 3 + row[i + 1] + 2) >> 2
            o[2 * cw - 2] = (row[cw - 1] * 3 + row[cw - 2] + 1) >> 2
            o[2 * cw - 1] = row[cw - 1]
            continue
        for v in range(2):
            near = c[r]
            far = c[max(r - 1, 0)] if v == 0 else c[min(r + 1, ch - 1)]
            o = out[2 * r + v]
            this, nxt = near[0] * 3 + far[0], near[1] * 3 + far[1]
            o[0] = (this * 4 + 8) >> 4
            o[1] = (this * 3 + nxt + 7) >> 4
            last, this = this, nxt
            for i in range(1, cw - 1):
                nxt = near[i + 1] * 3 + far[i + 1]
                o[2 * i] = (this * 3 + last + 8) >> 4
                o[2 * i + 1] = (this * 3 + nxt + 7) >> 4
                last, this = this, nxt
            o[2 * cw - 2] = (this * 3 + last + 8) >> 4
            o[2 * cw - 1] = (this * 4 + 7) >> 4
    return out[:h, :w]


@pytest.mark.parametrize("h,w,sub_h,sub_v", [
    (37, 53, 2, 2), (40, 61, 2, 1), (38, 52, 2, 2), (1, 9, 2, 2),
    (5, 4, 2, 2), (7, 3, 2, 1), (9, 5, 2, 2), (6, 6, 1, 1)])
def test_chroma_upsampling_follows_libjpeg_loops(h, w, sub_h, sub_v):
    ch, cw = -(-h // sub_v), -(-w // sub_h)
    c = np.random.default_rng(h * w).integers(0, 256, (ch, cw),
                                              dtype=np.uint8)
    got = ck._upsample_reference(torch.from_numpy(c), h, w)
    np.testing.assert_array_equal(got.numpy(), libjpeg_upsample(c, h, w))


@pytest.mark.parametrize("name", ["s420.jpg", "s422.jpg", "s444.jpg",
                                  "progressive.jpg", "restart.jpg",
                                  "imagenet_0.jpg"])
def test_colour_conversion_equals_libjpeg(name):
    """libjpeg's own upsampled YCbCr (PIL's YCbCr draft: the colour
    conversion left out) converted by the plain version equals libjpeg's
    RGB bit for bit."""
    from PIL import Image
    data = _read(name)
    im = Image.open(io.BytesIO(data))
    im.draft("YCbCr", None)
    ycc = torch.from_numpy(np.asarray(im).copy())
    got = ck.ycc_to_rgb(ycc[..., 0].contiguous(), ycc[..., 1].contiguous(),
                        ycc[..., 2].contiguous())
    np.testing.assert_array_equal(got.numpy(), libjpeg_pixels(data))


def test_ycc_to_rgb_refuses_4_4_0_and_misfit_planes():
    y = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="4:4:0"):
        ck.ycc_to_rgb_reference(y, y[:4], y[:4])
    with pytest.raises(ValueError, match="fits no"):
        ck.ycc_to_rgb_reference(y, y[:3, :3], y[:3, :3])


def test_resize_wrapper_uses_the_plain_version_on_cpu_tensors():
    src = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (7, 9, 3), dtype=np.uint8))
    before = dict(ck.launch_counts)
    out = ck.resize_bilinear(src, 5, 11)
    assert torch.equal(out, ck.resize_bilinear_reference(src, 5, 11))
    assert ck.launch_counts == before
    one = ck.resize_bilinear(src[:1, :1], 3, 2)
    assert torch.equal(one, src[0, 0].float()[:, None, None].expand(3, 3, 2))


def test_cpu_decode_names_a_missing_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="PIL"):
        jpeg.decode_jpeg(_read("s420.jpg"), "cpu")


def test_decoding_on_the_card_needs_one_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jpeg.decode_jpeg(_read("s420.jpg"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [((500, 375), (256, 256)),
                                   ((64, 48), (256, 256)),
                                   ((37, 53), (37, 53)),
                                   ((1, 40), (9, 7)), ((40, 1), (9, 7)),
                                   ((33, 47), (1, 1))])
def test_resize_kernel_equals_plain_version_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    (h, w), (oh, ow) = shape
    src = torch.from_numpy(np.random.default_rng(h * w).integers(
        0, 256, (h, w, 3), dtype=np.uint8)).cuda()
    for gray in (False, True):
        got = ck.resize_bilinear(src, oh, ow, gray)
        torch.cuda.synchronize()
        want = ck.resize_bilinear_reference(src, oh, ow, gray)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), ck.resize_bilinear_reference(
            src.cpu(), oh, ow, gray))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,sub_h,sub_v", [
    (500, 375, 2, 2), (37, 53, 2, 2), (40, 61, 2, 1), (33, 47, 1, 1),
    (5, 4, 2, 2), (1, 9, 2, 2)])
def test_ycc_kernel_equals_plain_version_on_the_card(h, w, sub_h, sub_v):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(h + w)
    ch, cw = -(-h // sub_v), -(-w // sub_h)
    y, cb, cr = (torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8))
                 .cuda() for s in ((h, w), (ch, cw), (ch, cw)))
    got = ck.ycc_to_rgb(y, cb, cr)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ck.ycc_to_rgb_reference(
        y.cpu(), cb.cpu(), cr.cpu()))
