"""PNG bytes to pixels on the host, with no PIL.

The JAX package reads every image that is no JPEG through PIL
(``sparknet_tpu/data/db.py:680-693``, ``sparknet_tpu/pycaffe_io.py:
147-156``), and the card's machine has no PIL.  This is the port's own
decoder for PNG, over ``zlib`` and numpy, giving PIL's pixels for the
conversions those paths make, ``convert("RGB")`` and ``convert("L")``.
It runs on the host on both devices (reference: the PNG specification,
ISO/IEC 15948, sections 5-9, 11.2 and 12):

- the signature, the chunks' CRCs as PIL checks them (every chunk before
  the image data; the data itself is held by zlib's Adler-32), IHDR,
  PLTE, tRNS and consecutive IDATs; other chunks are skipped;
- the five filters (None, Sub, Up, Average, Paeth) and Adam7 interlace;
- colour types 0, 2, 3, 4 and 6 at every legal bit depth.

``PNGImage.mode`` is the mode PIL opens the image in: "1", "L" (gray of
2 or 4 bits scaled to 0-255 as PIL unpacks it), "I;16" (16-bit gray),
"RGB", "P", "LA", "RGBA"; 16-bit colour keeps each sample's high byte.
``convert`` then follows Pillow's converters: alpha and tRNS are dropped,
not composited; a palette is expanded (an index past the PLTE, or any
index of a palette image without one, reads black, as in PIL); "L" of
colour is ITU-R 601 luma in PIL's integer form; "I;16" clips to 255 for
both.  16-bit gray with alpha opens, as in PIL, as "RGBA".

A bad signature, a chunk cut short, a broken CRC, a bad IHDR and a zlib
stream that is bad or ends before the image does raise
:class:`PNGError`, which the callers turn into ``DataCorruptionError``
where PIL raises too.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

__all__ = ["SIGNATURE", "PNGError", "PNGImage", "is_png", "png_size",
           "decode_png", "unfilter", "luma601"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> (samples a pixel, legal bit depths)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PNGError(ValueError):
    """Bytes that are no decodable PNG."""


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def png_size(data: bytes) -> tuple[int, int] | None:
    """(height, width) from the IHDR, read without decoding; None when the
    bytes hold no PNG header."""
    if not is_png(data) or len(data) < 24 or data[12:16] != b"IHDR":
        return None
    w, h = struct.unpack(">II", data[16:24])
    return h, w


def luma601(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 -> uint8 ITU-R 601 luma in PIL's integer form:
    (19595 R + 38470 G + 7471 B + 32768) >> 16."""
    c = rgb.astype(np.int32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 32768) >> 16).astype(np.uint8)


@dataclass
class PNGImage:
    """A decoded PNG: ``samples`` (H, W, samples a pixel) as stored
    (uint16 at bit depth 16, else uint8; palette indices for colour type
    3), the PLTE as (N, 3) uint8 and the tRNS bytes."""

    width: int
    height: int
    bit_depth: int
    color_type: int
    interlaced: bool
    samples: np.ndarray
    palette: np.ndarray | None
    transparency: bytes | None

    @property
    def mode(self) -> str:
        """The mode PIL opens this image in."""
        ct, bits = self.color_type, self.bit_depth
        if ct == 0:
            return "1" if bits == 1 else "I;16" if bits == 16 else "L"
        if ct == 4 and bits == 16:
            return "RGBA"
        return {2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[ct]

    def pixels(self) -> np.ndarray:
        """The pixels in PIL's mode (:attr:`mode`): (H, W) for "1", "L",
        "I;16" and "P", (H, W, bands) otherwise."""
        s, ct, bits = self.samples, self.color_type, self.bit_depth
        if ct == 3:
            return s[..., 0]
        if ct == 0:
            if bits == 16:
                return s[..., 0]
            return (s[..., 0].astype(np.int32) * (255 // (2 ** bits - 1))
                    ).astype(np.uint8)
        return (s >> 8).astype(np.uint8) if bits == 16 else s

    def _palette256(self) -> np.ndarray:
        """PIL's palette: the PLTE's entries, black past them."""
        pal = np.zeros((256, 3), np.uint8)
        if self.palette is not None:
            n = min(len(self.palette), 256)
            pal[:n] = self.palette[:n]
        return pal

    def convert(self, mode: str) -> np.ndarray:
        """PIL's ``convert(mode)`` for "RGB" ((H, W, 3) uint8) and "L"
        ((H, W) uint8)."""
        if mode not in ("RGB", "L"):
            raise ValueError(f"convert: mode {mode!r} (RGB or L)")
        px, m = self.pixels(), self.mode
        if m == "I;16":
            gray = np.minimum(px, 255).astype(np.uint8)
            return gray if mode == "L" else np.repeat(gray[..., None], 3, 2)
        if m == "P":
            rgb = self._palette256()[px]
        elif m in ("1", "L"):
            rgb = np.repeat(px[..., None], 3, 2) if mode == "RGB" else px
            if mode == "L":
                return np.ascontiguousarray(rgb)
        elif self.color_type == 4:                # LA; 16-bit: RGBA
            gray = px[..., 0]
            if mode == "L":
                return np.ascontiguousarray(gray)
            rgb = np.repeat(gray[..., None], 3, 2)
        else:                                   # RGB, RGBA
            rgb = px[..., :3]
        rgb = np.ascontiguousarray(rgb)
        return rgb if mode == "RGB" else luma601(rgb)


def _chunks(data: bytes):
    """(type, body) of each chunk up to IEND; the CRC is checked on every
    chunk before the first IDAT, as PIL checks it.  Past the first IDAT
    the file may end early, as PIL lets it: the zlib stream then says
    whether the image data is whole."""
    if not is_png(data):
        raise PNGError("not a PNG file (bad signature)")
    i, seen_idat = 8, False
    while True:
        if i + 8 > len(data):
            if seen_idat:
                return
            raise PNGError("truncated PNG file (no image data)")
        length, ctype = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + length]
        seen_idat |= ctype == b"IDAT"
        if len(body) < length or i + 12 + length > len(data):
            if not seen_idat:
                raise PNGError(
                    f"truncated PNG file (chunk {ctype!r} cut short)")
            if ctype == b"IDAT":
                yield ctype, body
            return
        crc = struct.unpack(">I", data[i + 8 + length:i + 12 + length])[0]
        if not seen_idat and zlib.crc32(body, zlib.crc32(ctype)) != crc:
            raise PNGError(f"broken PNG file (bad checksum in {ctype!r})")
        yield ctype, body
        if ctype == b"IEND":
            return
        i += 12 + length


def _row_bytes(width: int, bits_per_pixel: int) -> int:
    return (width * bits_per_pixel + 7) // 8


def unfilter(raw: np.ndarray, height: int, row_bytes: int,
             bpp: int) -> np.ndarray:
    """Undo the per-row filters of one (sub)image: ``raw`` holds ``height``
    rows of a filter byte and ``row_bytes`` bytes; ``bpp`` is the filter's
    byte distance to the left neighbour (bytes a pixel, at least 1).
    Returns (height, row_bytes) uint8.  With only None, Sub and Up rows
    each row is undone whole (Sub as a running sum); with any Average or
    Paeth row the image is swept along its anti-diagonals of pixels,
    every pixel's left, upper and upper-left neighbours done before it."""
    rows = raw.reshape(height, row_bytes + 1)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise PNGError(f"bad filter type {int(kinds.max())}")
    if row_bytes % bpp:
        raise PNGError("row length no multiple of its pixels")
    data = rows[:, 1:].astype(np.int32)
    if (kinds >= 3).any():
        return _sweep(data, kinds, row_bytes, bpp)
    out = np.zeros((height + 1, row_bytes), np.int32)  # row 0: above row 1
    for r in range(height):
        cur = data[r]
        if kinds[r] == 1:
            cur = np.cumsum(cur.reshape(-1, bpp), 0).reshape(-1)
        elif kinds[r] == 2:
            cur = cur + out[r]
        out[r + 1] = cur & 255
    return out[1:].astype(np.uint8)


def _sweep(data, kinds, row_bytes, bpp) -> np.ndarray:
    """Every row, whatever its filter, by anti-diagonals of pixels: pixel
    (r, p) needs (r, p-1), (r-1, p) and (r-1, p-1).  The rows are stored
    skewed, pixel (r, p) at column q = p + r + 2 of row r + 1 (row 0 the
    zero row above the image, two zero columns in front), so that a
    diagonal is one column and its three neighbours are the two columns
    before it: every step works on slices."""
    n, cols = data.shape[0], row_bytes // bpp
    rr = np.arange(n)[:, None]
    q = np.arange(cols)[None, :] + rr + 2
    grid = np.zeros((n + 1, cols + n + 2, bpp), np.int16)
    src = np.zeros((n, cols + n + 2, bpp), np.int16)
    src[rr, q] = data.reshape(n, cols, bpp)
    kind = kinds[:, None].astype(np.int16)
    has = {k for k in range(1, 5) if (kinds == k).any()}
    all_paeth = bool((kinds == 4).all())
    for col in range(2, cols + n + 1):
        lo, hi = max(0, col - cols - 1), min(n, col - 1)
        a = grid[lo + 1:hi + 1, col - 1]
        b = grid[lo:hi, col - 1]
        k = kind[lo:hi]
        pred = np.where(k == 1, a, 0) if 1 in has else 0
        if 2 in has:
            pred = np.where(k == 2, b, pred)
        if 3 in has:
            pred = np.where(k == 3, (a + b) >> 1, pred)
        if 4 in has:
            c = grid[lo:hi, col - 2]
            da, db = a - c, b - c
            pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
            pae = np.where((pa <= pb) & (pa <= pc), a,
                           np.where(pb <= pc, b, c))
            pred = pae if all_paeth else np.where(k == 4, pae, pred)
        grid[lo + 1:hi + 1, col] = (src[lo:hi, col] + pred) & 255
    return grid[1:][rr, q].reshape(n, row_bytes).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, channels: int,
             bits: int) -> np.ndarray:
    """Unfiltered rows -> (H, width, channels) samples."""
    h = rows.shape[0]
    if bits == 16:
        s = rows.reshape(h, -1).view(">u2").astype(np.uint16)
    elif bits == 8:
        s = rows
    else:
        per = 8 // bits
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        s = ((rows[:, :, None] >> shifts) & (2 ** bits - 1)).reshape(
            h, rows.shape[1] * per)
    return np.ascontiguousarray(s[:, :width * channels]).reshape(
        h, width, channels)


def decode_png(data: bytes) -> PNGImage:
    """PNG bytes -> :class:`PNGImage`; raises :class:`PNGError`."""
    hdr = None
    palette = trns = None
    idat: list[bytes] = []
    in_idat = done_idat = False
    for ctype, body in _chunks(bytes(data)):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise PNGError("bad IHDR length")
            hdr = struct.unpack(">IIBBBBB", body)
        elif hdr is None:
            raise PNGError(f"chunk {ctype!r} before IHDR")
        elif ctype == b"PLTE":
            if len(body) % 3 or not body:
                raise PNGError("bad PLTE length")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            if done_idat:
                raise PNGError("IDAT chunks not consecutive")
            idat.append(body)
            in_idat = True
            continue
        if in_idat:
            done_idat = True
    if hdr is None:
        raise PNGError("no IHDR chunk")
    width, height, bits, ctype_, comp, filt, interlace = hdr
    if ctype_ not in _TYPES or bits not in _TYPES[ctype_][1]:
        raise PNGError(f"bad colour type {ctype_} at bit depth {bits}")
    if width == 0 or height == 0 or comp or filt or interlace > 1:
        raise PNGError(f"bad IHDR {hdr}")
    if not idat:
        raise PNGError("no IDAT chunk")
    channels = _TYPES[ctype_][0]
    bpp_bits = channels * bits
    bpp = max(1, bpp_bits // 8)
    if interlace:
        passes = []
        for x0, y0, dx, dy in _ADAM7:
            pw = (width - x0 + dx - 1) // dx if width > x0 else 0
            ph = (height - y0 + dy - 1) // dy if height > y0 else 0
            passes.append((pw, ph))
    else:
        passes = [(width, height)]
    need = sum(ph * (_row_bytes(pw, bpp_bits) + 1)
               for pw, ph in passes if pw and ph)
    try:   # the whole stream, so that a bad Adler-32 at its end raises
        raw = zlib.decompressobj().decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"bad zlib stream: {e}") from e
    if len(raw) < need:
        raise PNGError(f"image data cut short ({len(raw)} of {need} bytes)")
    raw = np.frombuffer(raw, np.uint8)
    dtype = np.uint16 if bits == 16 else np.uint8
    if not interlace:
        rb = _row_bytes(width, bpp_bits)
        rows = unfilter(raw, height, rb, bpp)
        samples = _samples(rows, width, channels, bits)
    else:
        samples = np.zeros((height, width, channels), dtype)
        at = 0
        for (x0, y0, dx, dy), (pw, ph) in zip(_ADAM7, passes):
            if not (pw and ph):
                continue
            rb = _row_bytes(pw, bpp_bits)
            n = ph * (rb + 1)
            rows = unfilter(raw[at:at + n], ph, rb, bpp)
            at += n
            samples[y0::dy, x0::dx] = _samples(rows, pw, channels, bits)
    return PNGImage(width, height, bits, ctype_, bool(interlace),
                    samples.astype(dtype, copy=False), palette, trns)
