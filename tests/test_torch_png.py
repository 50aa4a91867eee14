"""The port's PNG decoder (``sparknet_tpu_torch/data/png.py``) against
PIL, on the CPU, and the committed image fixtures rebuilt from their
seeds.

The JAX package reads every image that is no JPEG through PIL; the port
decodes PNG itself, so that the card's machine, which has no PIL, takes
them.  The tolerance is zero: every fixture's ``convert("RGB")`` and
``convert("L")`` equal PIL's bit for bit, and every corrupt fixture is
refused where PIL refuses it.

The fixtures (``sparknet_tpu_torch/data/png_fixtures/``, read by
``chip_smoke.py`` on the card, which checks them against the PIL pixels
the manifest holds) are made here from seeded numpy, PIL and ``zlib``:

    python tests/test_torch_png.py --write

They cover colour types 0, 2, 3 (with tRNS), 4 and 6 at every legal bit
depth, Adam7, every one of the five filters (rows written by the
encoder below, which cycles them), PIL's own adaptive filtering, a PNG
the size of an ImageNet photo, a broken CRC, a cut IDAT, and one Adobe
CMYK JPEG written by PIL (its pixels are PIL's ``convert("RGB")``).
"""

from __future__ import annotations

import hashlib
import io
import itertools
import json
import pathlib
import struct
import sys
import zlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "sparknet_tpu_torch" / "data" / "png_fixtures"
JPEG_FIXTURES = ROOT / "sparknet_tpu_torch" / "data" / "jpeg_fixtures"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}


# ---------------------------------------------------------------------------
# A PNG encoder that writes every filter and Adam7 (PIL writes neither on
# request)
# ---------------------------------------------------------------------------

def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(ctype))))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _pack_rows(samples: np.ndarray, bits: int) -> list[bytes]:
    """(h, w, c) samples -> each row's bytes, big-endian, bits packed."""
    h, w, c = samples.shape
    rows = []
    for r in range(h):
        v = samples[r].reshape(-1).astype(np.int64)
        if bits == 16:
            rows.append(v.astype(">u2").tobytes())
        elif bits == 8:
            rows.append(v.astype(np.uint8).tobytes())
        else:
            per = 8 // bits
            v = np.r_[v, np.zeros((-len(v)) % per, np.int64)].reshape(-1, per)
            shifts = np.arange(8 - bits, -1, -bits)
            rows.append((v << shifts).sum(1).astype(np.uint8).tobytes())
    return rows


def _filter_rows(rows: list[bytes], bpp: int, kinds) -> bytes:
    out = bytearray()
    prior = bytes(len(rows[0]))
    for row, k in zip(rows, kinds):
        f = bytearray(len(row))
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[k]
            f[i] = (x - pred) & 255
        out.append(k)
        out += f
        prior = row
    return bytes(out)


def encode_png(samples: np.ndarray, bits: int, color_type: int, *,
               palette: np.ndarray | None = None, trns: bytes | None = None,
               interlace: bool = False, filters=(0, 1, 2, 3, 4),
               extra: list[tuple[bytes, bytes]] = ()) -> bytes:
    """(h, w, samples) -> PNG bytes, the rows' filters cycling through
    ``filters`` (in each Adam7 pass anew)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * bits // 8)
    cyc = itertools.cycle(filters)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                rows = _pack_rows(sub, bits)
                raw += _filter_rows(rows, bpp, [next(cyc) for _ in rows])
    else:
        rows = _pack_rows(samples, bits)
        raw = _filter_rows(rows, bpp, [next(cyc) for _ in rows])
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, bits, color_type, 0, 0, int(interlace)))
    for ctype, body in extra:
        out += _chunk(ctype, body)
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(raw, 9)
    # two IDAT chunks, as large files carry several
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    return out + _chunk(b"IEND", b"")


def random_png(color_type: int, bits: int, h: int, w: int, seed: int, *,
               interlace: bool = False, filters=(0, 1, 2, 3, 4),
               with_trns: bool = True) -> bytes:
    """A PNG of seeded smooth-plus-noise samples (so every filter has
    something to predict), with a palette and tRNS where the type takes
    them."""
    rng = np.random.default_rng(seed)
    top = 2 ** bits - 1
    yy, xx = np.mgrid[0:h, 0:w]
    chans = CHANNELS[color_type]
    base = np.stack([(xx * (c + 1) * 7 + yy * (5 - c) * 3) % (top + 1)
                     for c in range(chans)], -1)
    noise = rng.integers(0, max(2, (top + 1) // 8), (h, w, chans))
    samples = ((base + noise) % (top + 1)).astype(
        np.uint16 if bits == 16 else np.uint8)
    palette = trns = None
    if color_type == 3:
        n = 2 ** bits
        palette = rng.integers(0, 256, (n, 3))
        trns = rng.integers(0, 256, n // 2 + 1).astype(np.uint8).tobytes() \
            if with_trns else None
    elif color_type in (0, 2) and with_trns:
        trns = struct.pack(">" + "H" * CHANNELS[color_type],
                           *[int(v) for v in samples[0, 0]])
    return encode_png(samples, bits, color_type, palette=palette, trns=trns,
                      interlace=interlace, filters=filters)


# ---------------------------------------------------------------------------
# The fixtures, from seeds
# ---------------------------------------------------------------------------

def _pil_png(arr, mode: str, **kw) -> bytes:
    from PIL import Image
    im = Image.fromarray(arr) if mode != "I;16" else Image.frombytes(
        "I;16", arr.shape[::-1], arr.astype("<u2").tobytes())
    if mode not in ("I;16", im.mode):
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _scene(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: colour waves, four flat rectangles and a little
    noise (tests/test_torch_jpeg.py's ``scene``)."""
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


def build_fixtures() -> tuple[dict[str, bytes], dict]:
    """name -> bytes, and the manifest."""
    from PIL import Image
    files: dict[str, bytes] = {}
    # the encoder's: every type and depth, every filter, some Adam7
    seed = 100
    for ct, depths in DEPTHS.items():
        for bits in depths:
            seed += 1
            files[f"t{ct}_d{bits}.png"] = random_png(ct, bits, 11, 13, seed)
    for ct, bits in ((0, 1), (0, 2), (0, 16), (2, 8), (3, 4), (4, 16),
                     (6, 8), (6, 16)):
        seed += 1
        files[f"t{ct}_d{bits}_adam7.png"] = random_png(
            ct, bits, 19, 23, seed, interlace=True)
    files["t2_d8_adam7_3x2.png"] = random_png(2, 8, 3, 2, 150,
                                              interlace=True)
    files["t2_d8_1x1.png"] = random_png(2, 8, 1, 1, 151)
    # PIL's own: adaptive filtering
    sc = _scene(40, 56, 7)
    files["pil_rgb.png"] = _pil_png(sc, "RGB")
    files["pil_l.png"] = _pil_png(sc, "L")
    files["pil_rgba.png"] = _pil_png(np.dstack([sc, sc[..., :1]]), "RGBA")
    files["pil_la.png"] = _pil_png(np.dstack([sc[..., 1], sc[..., 2]]), "LA")
    files["pil_1.png"] = _pil_png(sc, "1")
    files["pil_i16.png"] = _pil_png(
        (sc[..., 0].astype(np.uint16) * 5 + 1), "I;16")
    pim = Image.fromarray(sc).quantize(16)
    buf = io.BytesIO()
    pim.save(buf, "PNG", transparency=bytes(range(0, 256, 16)), bits=4)
    files["pil_p4_trns.png"] = buf.getvalue()
    # an ImageNet-sized photo: the 375x500 JPEG fixture's pixels
    with Image.open(JPEG_FIXTURES / "imagenet_0.jpg") as im:
        files["photo_375x500.png"] = _pil_png(np.asarray(im.convert("RGB")),
                                              "RGB")
    # corrupt: a broken IHDR CRC; the file cut inside its IDAT
    good = files["t2_d8.png"]
    files["bad_crc.png"] = good[:29] + bytes([good[29] ^ 0x01]) + good[30:]
    at = good.index(b"IDAT")
    files["cut_idat.png"] = good[:at + 4 + 20]
    # one Adobe CMYK JPEG written by PIL
    cmyk = np.dstack([sc, 255 - sc[..., :1]])
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=92)
    files["cmyk_adobe.jpg"] = buf.getvalue()

    manifest = {"seeds": "tests/test_torch_png.py::build_fixtures",
                "images": {}, "corrupt": {}}
    for name, data in files.items():
        entry = {"sha256": hashlib.sha256(data).hexdigest()}
        try:
            with Image.open(io.BytesIO(data)) as im:
                im.load()
                entry["mode"] = im.mode
                entry["height"], entry["width"] = im.height, im.width
                for mode in ("RGB", "L"):
                    px = np.ascontiguousarray(np.asarray(im.convert(mode)))
                    key = mode.lower()
                    entry[f"{key}_sha256"] = hashlib.sha256(
                        px.tobytes()).hexdigest()
                    if px.size <= 40 * 56 * 3:
                        entry[f"{key}_pixels"] = f"{name}.{key}.npy"
        except (OSError, SyntaxError) as e:
            manifest["corrupt"][name] = {**entry,
                                         "pil_error": type(e).__name__}
            continue
        manifest["images"][name] = entry
    return files, manifest


def _pixels_npy(name: str, data: bytes, mode: str) -> bytes:
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        px = np.ascontiguousarray(np.asarray(im.convert(mode)))
    buf = io.BytesIO()
    np.save(buf, px)
    return buf.getvalue()


def write_fixtures() -> None:
    files, manifest = build_fixtures()
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for name, data in files.items():
        (FIXTURES / name).write_bytes(data)
        e = manifest["images"].get(name, {})
        for mode in ("RGB", "L"):
            npy = e.get(f"{mode.lower()}_pixels")
            if npy:
                (FIXTURES / npy).write_bytes(_pixels_npy(name, data, mode))
    (FIXTURES / "manifest.json").write_text(
        json.dumps(manifest, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__" and "--write" in sys.argv:
    write_fixtures()
    sys.exit(0)


from sparknet_tpu_torch.data import png  # noqa: E402


def _manifest() -> dict:
    return json.loads((FIXTURES / "manifest.json").read_text())


def _pil(data: bytes, mode: str) -> np.ndarray:
    from PIL import Image
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert(mode))


def test_fixtures_rebuild_from_their_seeds():
    files, manifest = build_fixtures()
    assert manifest == _manifest()
    for name, data in files.items():
        assert (FIXTURES / name).read_bytes() == data, name
    covered = {(e["mode"]) for e in manifest["images"].values()}
    assert covered >= {"1", "L", "I;16", "RGB", "P", "LA", "RGBA", "CMYK"}
    assert set(manifest["corrupt"]) == {"bad_crc.png", "cut_idat.png"}


@pytest.mark.parametrize("name", sorted(
    n for n in _manifest()["images"] if n.endswith(".png")))
def test_fixture_decodes_to_pil_pixels_bit_for_bit(name):
    data = (FIXTURES / name).read_bytes()
    e = _manifest()["images"][name]
    img = png.decode_png(data)
    assert img.mode == e["mode"]
    assert png.png_size(data) == (e["height"], e["width"])
    for mode in ("RGB", "L"):
        got = img.convert(mode)
        np.testing.assert_array_equal(got, _pil(data, mode))
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            e[f"{mode.lower()}_sha256"]
        npy = e.get(f"{mode.lower()}_pixels")
        if npy:
            np.testing.assert_array_equal(got, np.load(FIXTURES / npy))


@pytest.mark.parametrize("name", ["bad_crc.png", "cut_idat.png"])
def test_corrupt_fixtures_refused_as_pil_refuses_them(name):
    from PIL import Image
    data = (FIXTURES / name).read_bytes()
    with pytest.raises((OSError, SyntaxError)):
        with Image.open(io.BytesIO(data)) as im:
            im.load()
    with pytest.raises(png.PNGError):
        png.decode_png(data)


def test_a_flipped_idat_byte_is_refused():
    data = (FIXTURES / "photo_375x500.png").read_bytes()
    at = data.index(b"IDAT") + 4 + 5000
    bad = data[:at] + bytes([data[at] ^ 0x5A]) + data[at + 1:]
    with pytest.raises(png.PNGError):
        png.decode_png(bad)


@pytest.mark.parametrize("ct,bits", [(ct, b) for ct, ds in DEPTHS.items()
                                     for b in ds])
@pytest.mark.parametrize("interlace", [False, True])
def test_random_images_equal_pil(ct, bits, interlace):
    """Seeded images at odd sizes, one filter a run and all five cycled,
    with and without Adam7, with and without tRNS."""
    for i, (h, w) in enumerate([(1, 1), (2, 9), (9, 2), (17, 31)]):
        for filters in ((0,), (1,), (2,), (3,), (4,), (4, 3, 1, 2, 0)):
            data = random_png(ct, bits, h, w, 7 * i + len(filters),
                              interlace=interlace, filters=filters,
                              with_trns=bool(i % 2))
            img = png.decode_png(data)
            for mode in ("RGB", "L"):
                np.testing.assert_array_equal(
                    img.convert(mode), _pil(data, mode),
                    err_msg=f"{h}x{w} filters {filters} {mode}")


def test_sixteen_bit_gray_clips_as_pil_does():
    samples = np.array([[[0], [200], [400], [600]]], np.uint16)
    data = encode_png(samples, 16, 0)
    img = png.decode_png(data)
    assert img.mode == "I;16"
    np.testing.assert_array_equal(img.convert("L"), [[0, 200, 255, 255]])
    np.testing.assert_array_equal(img.convert("L"), _pil(data, "L"))


@pytest.mark.parametrize("plte", [True, False])
def test_a_palette_index_past_the_plte_reads_black_as_in_pil(plte):
    samples = np.array([[[0], [1], [5], [9]]], np.uint8)
    pal = np.array([[10, 20, 30], [40, 50, 60]])
    data = encode_png(samples, 4, 3, palette=pal if plte else None)
    img = png.decode_png(data)
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(img.convert(mode), _pil(data, mode))
    assert (img.convert("RGB")[0, 2:] == 0).all()


@pytest.mark.parametrize("bad", ["signature", "filter", "ihdr_depth",
                                 "no_idat"])
def test_malformed_headers_raise(bad):
    from PIL import Image
    good = random_png(2, 8, 4, 4, 3)
    if bad == "signature":
        data = b"\x89PNX" + good[4:]
    elif bad == "filter":
        samples = np.zeros((2, 2, 3), np.uint8)
        raw = b"\x07" + bytes(6) + b"\x00" + bytes(6)
        data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 2, 2, 8, 2, 0, 0, 0)) + _chunk(
            b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))
        del samples
    elif bad == "ihdr_depth":
        data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 2, 2, 4, 2, 0, 0, 0)) + _chunk(b"IEND", b""))
    else:
        data = good[:33] + _chunk(b"IEND", b"")
    with pytest.raises(png.PNGError):
        png.decode_png(data)
    with pytest.raises((OSError, SyntaxError, ValueError)):
        with Image.open(io.BytesIO(data)) as im:
            im.load()
            im.convert("RGB")
