"""JPEG bytes to planar float32 images, on the card or on the CPU.

The port's counterpart of the JAX package's JPEG decode
(``sparknet_tpu/native/__init__.py:174-195``, ``decode_jpeg_resize``, over
``sparknet_tpu/native/data_pipeline.cpp:202-276``: libjpeg, then a bilinear
force-resize; ScaleAndConvert semantics, reference:
src/main/scala/preprocessing/ScaleAndConvert.scala:16-27).  Every function
returns float32 ``(3, H, W)`` values 0-255 (``(1, H, W)`` gray) on
``device``, or ``None`` for bytes that are no decodable JPEG, which the
caller drops as the JAX package does.

- On a CUDA device, nvJPEG (CUDA toolkit) decodes on the card: a YCbCr
  JPEG sampled 4:4:4, 4:2:2 or 4:2:0 to its component planes, which the
  hand-written kernel ``ops/cuda_kernels.ycc_to_rgb`` upsamples and
  converts to RGB as libjpeg does (so the pixels differ from libjpeg's
  only by the IDCTs' rounding); a gray JPEG, or another sampling, to
  nvJPEG's own RGB.  The hand-written kernel
  ``ops/cuda_kernels.resize_bilinear`` makes the planar float32 image
  (both kernels in ``ops/csrc/jpeg.cu``).  Each calling thread
  decodes on a stream of its own and has its own nvJPEG state.  A decoder
  that fails (no library, a failed handle, launch or allocation) raises: it
  never counts as an undecodable image and never hands the work to the CPU.
- On the CPU (the tests' path), PIL decodes and the plain version
  ``resize_bilinear_reference`` resizes.  PIL and the native pipeline's
  libjpeg are both libjpeg-turbo's islow IDCT with fancy upsampling, so the
  pixels equal the JAX package's native path bit for bit.  PIL is imported
  there only: a machine without it raises, naming it.  ``pil_image`` is
  the JAX package's PIL path for images the native pipeline does not take
  (no JPEG, or one libjpeg refuses), CPU only.

Both drop what the native pipeline refuses: bytes that do not start with
a JPEG's SOI marker, JPEGs with four components (CMYK, YCCK: libjpeg's
``JCS_RGB`` output refuses them), and JPEGs that fail to parse.  Where
the JAX package reads a four-component JPEG with PIL instead (an image
file, a natural-size encoded Datum), ``decode_cmyk`` takes a CMYK one:
nvJPEG's components as the file stores them, turned into PIL's RGB by
the plain ``cmyk_to_rgb`` on the card; the CPU keeps PIL for them.  A JPEG
whose scan is cut short decodes, as libjpeg does (a warning, and the rest
of the image filled from zeroed coefficients): on the CPU, an EOI marker
appended after the data makes PIL's libjpeg stop where the native
pipeline's memory source inserts its own.  nvJPEG also decodes such a
JPEG, but fills the rest otherwise (ROADMAP §C).
"""

from __future__ import annotations

import ctypes
import io
import threading

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from ..ops.cuda_kernels import resize_bilinear_reference
from ..utils.device import resolve_device

__all__ = ["decode_jpeg", "decode_jpeg_resize", "decode_rgb", "decode_planes",
           "decode_cmyk", "cmyk_to_rgb", "adobe_transform",
           "resize_bilinear_reference", "jpeg_size", "luma601", "pil_image",
           "UndecodableImage"]

SOI = b"\xff\xd8"
EOI = b"\xff\xd9"

# sparknet_jpeg_info/decode_rgbi return codes (ops/csrc/jpeg.cu)
_UNDECODABLE, _FOUR_COMPONENTS = 1, 2

_local = threading.local()


def decode_jpeg(data: bytes, device: str | torch.device = "cuda",
                ) -> torch.Tensor | None:
    """JPEG bytes -> float32 (3, H, W) at the image's own size on
    ``device``, or None when undecodable."""
    return _decode(data, 0, 0, device, gray=False)


def decode_jpeg_resize(data: bytes, out_h: int, out_w: int,
                       device: str | torch.device = "cuda",
                       gray: bool = False) -> torch.Tensor | None:
    """JPEG bytes -> float32 (3, out_h, out_w) on ``device``, force-resized
    (aspect ignored), or None when undecodable.  ``gray``: (1, out_h,
    out_w), the mean of the three resized channels, as the JAX package's
    ``load_image`` takes it (``sparknet_tpu/data/db.py:677-679``)."""
    if out_h < 1 or out_w < 1:
        raise ValueError(f"decode_jpeg_resize: output {out_h}x{out_w}")
    return _decode(data, out_h, out_w, device, gray)


def luma601(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> float32 (1, H, W) ITU-R 601 luma in PIL's
    integer form (``convert("L")``: (19595 R + 38470 G + 7471 B + 32768)
    >> 16), on the tensor's device."""
    c = rgb.to(torch.int32)
    y = (c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
         + 32768) >> 16
    return y.to(torch.float32)[None]


def jpeg_size(data: bytes) -> tuple[int, int] | None:
    """(height, width) from a JPEG's start-of-frame header, read without
    decoding; None when the bytes hold no frame header."""
    if data[:2] != SOI:
        return None
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            return None
        marker = data[i + 1]
        if marker == 0xFF:          # fill byte
            i += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):   # no length field
            i += 2
            continue
        length = int.from_bytes(data[i + 2:i + 4], "big")
        # SOF0-15 less DHT (C4), JPG (C8) and DAC (CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 9 > len(data):
                return None
            return (int.from_bytes(data[i + 5:i + 7], "big"),
                    int.from_bytes(data[i + 7:i + 9], "big"))
        if marker == 0xDA:          # a scan before any frame header
            return None
        i += 2 + length
    return None


def adobe_transform(data: bytes) -> int | None:
    """The colour transform of a JPEG's Adobe APP14 marker (0: none, so
    CMYK for four components; 1: YCbCr; 2: YCCK), or None without one."""
    i = 2
    while i + 4 <= len(data) and data[i] == 0xFF:
        marker = data[i + 1]
        if marker in (0xD8, 0x01, *range(0xD0, 0xD8)) or marker == 0xFF:
            i += 1 if marker == 0xFF else 2
            continue
        length = int.from_bytes(data[i + 2:i + 4], "big")
        if marker == 0xEE and data[i + 4:i + 9] == b"Adobe" and length >= 12:
            return data[i + 15]
        if marker == 0xDA:          # the scan: no marker after it counts
            return None
        i += 2 + length
    return None


def cmyk_to_rgb(cmyk: torch.Tensor, inverted: bool) -> torch.Tensor:
    """(4, H, W) uint8 components as a CMYK JPEG stores them -> (H, W, 3)
    uint8 RGB, PIL's ``convert("RGB")`` of the image PIL opens, on the
    tensor's device.  ``inverted``: the components are stored inverted,
    as Adobe's convention has them and as PIL reads every CMYK JPEG
    (rawmode ``CMYK;I``, ``PIL/JpegImagePlugin.py``).  Then, as
    Pillow's ``cmyk2rgb``: with nk = 255 - K, each of R, G, B is
    nk - C·nk/255 rounded as ``MULDIV255`` does: t = C·nk + 128,
    ((t >> 8) + t) >> 8."""
    c = cmyk.to(torch.int32)
    if inverted:
        c = 255 - c
    nk = 255 - c[3]
    t = c[:3] * nk + 128
    rgb = (nk - (((t >> 8) + t) >> 8)).clamp_(0, 255)
    return rgb.to(torch.uint8).permute(1, 2, 0).contiguous()


def decode_cmyk(data: bytes, device: str | torch.device = "cuda",
                ) -> torch.Tensor | None:
    """A CMYK JPEG's bytes -> (H, W, 3) uint8 RGB on the CUDA ``device``,
    PIL's ``convert("RGB")`` pixels within the IDCTs' rounding; None for
    bytes that are no decodable four-component JPEG.  A YCCK JPEG (Adobe
    transform 2), or one whose components are subsampled, raises naming
    ROADMAP A15.  (The CPU paths read CMYK JPEGs with PIL, as the JAX
    package does.)"""
    data = bytes(data)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"decode_cmyk runs on a CUDA device, not {dev}")
    if data[:2] != SOI:
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    info = (ctypes.c_int * 6)()
    rc = ck._function("jpeg", "sparknet_jpeg_info")(data, len(data), info)
    if rc != _FOUR_COMPONENTS:
        if rc in (0, _UNDECODABLE):
            return None
        raise _nvjpeg_error("nvjpegGetImageInfo", rc)
    h, w, _, _, ch, cw = tuple(info)
    transform = adobe_transform(data)
    if transform == 2 or (ch, cw) != (h, w):
        raise NotImplementedError(
            f"a {'YCCK' if transform == 2 else 'subsampled CMYK'} JPEG "
            f"(ROADMAP A15, images libjpeg refuses)")
    s = _thread_stream(dev)
    with torch.cuda.device(dev), torch.cuda.stream(s):
        planes = torch.empty((4, h, w), dtype=torch.uint8, device=dev)
        rc = ck._function("jpeg", "sparknet_jpeg_decode_unchanged")(
            data, len(data), *(planes[i].data_ptr() for i in range(4)), w,
            s.cuda_stream)
        if not _checked(rc):
            return None
        rgb = cmyk_to_rgb(planes, inverted=True)
        s.synchronize()
    return rgb


def decode_rgb(data: bytes, device: str | torch.device = "cuda",
               ) -> torch.Tensor | None:
    """JPEG bytes -> (H, W, 3) uint8 interleaved RGB on ``device`` (the
    decode alone, before any resize), or None when undecodable."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return _rgb_cpu(bytes(data))
    return _rgb_cuda(bytes(data), dev)


def _decode(data, out_h: int, out_w: int, device, gray: bool):
    dev = resolve_device(device)
    data = bytes(data)
    if dev.type == "cpu":
        rgb = _rgb_cpu(data)
        if rgb is None:
            return None
        return resize_bilinear_reference(rgb, out_h or rgb.shape[0],
                                         out_w or rgb.shape[1], gray)
    rgb = _rgb_cuda(data, dev)
    if rgb is None:
        return None
    s = _thread_stream(rgb.device)
    with torch.cuda.device(rgb.device), torch.cuda.stream(s):
        out = ck.resize_bilinear(rgb, out_h or rgb.shape[0],
                                 out_w or rgb.shape[1], gray)
        s.synchronize()   # the result is complete for any stream
    return out


class UndecodableImage(ValueError):
    """PIL could not read an image (the CPU's PIL paths)."""


def _pil():
    """PIL's Image module; raises, naming PIL, where it is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "decoding images on the CPU needs PIL (Pillow), which is not "
            "installed here; decode JPEGs on the card (device='cuda')") from e
    return Image


def pil_image(data: bytes, mode: str,
              size: tuple[int, int] | None = None) -> np.ndarray:
    """The JAX package's PIL path, on the CPU only (``sparknet_tpu/data/
    db.py:80-88``, :682-693): any image PIL reads, converted to ``mode``
    ("RGB", or "L": integer ITU-R 601 luma), resized to ``size`` (height,
    width) with PIL's own BILINEAR filter when given; float32 (C, H, W).
    Raises :class:`UndecodableImage` with PIL's message on bad data."""
    Image = _pil()
    try:
        im = Image.open(io.BytesIO(data)).convert(mode)
        if size:
            im = im.resize((size[1], size[0]), Image.BILINEAR)
        arr = np.asarray(im, np.float32)
    except Exception as e:
        raise UndecodableImage(str(e)) from e
    return arr[None] if arr.ndim == 2 else np.ascontiguousarray(
        arr.transpose(2, 0, 1))


def _rgb_cpu(data: bytes) -> torch.Tensor | None:
    """(H, W, 3) uint8 from PIL's libjpeg, or None where the native
    pipeline would refuse the bytes."""
    Image = _pil()
    if data[:2] != SOI:
        return None
    try:
        im = Image.open(io.BytesIO(data + EOI))
        if im.format != "JPEG" or len(im.getbands()) == 4:
            return None
        arr = np.asarray(im.convert("RGB"), np.uint8)
    except Exception:   # PIL's errors on bad data; its absence raised above
        return None
    return torch.from_numpy(arr.copy())


def _thread_stream(dev: torch.device) -> torch.cuda.Stream:
    """This thread's decode stream on ``dev``."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    s = streams.get(dev.index)
    if s is None:
        s = streams[dev.index] = torch.cuda.Stream(dev)
    return s


def _nvjpeg_error(what: str, rc: int) -> RuntimeError:
    why = (f"nvJPEG status {-rc - 1000}" if rc <= -1000
           else f"CUDA error {-rc}")
    return RuntimeError(f"{what} failed ({why}): the decoder on the card is "
                        f"broken, not the image")


# nvjpegChromaSubsampling_t values whose planes ycc_to_rgb takes
_CSS_444, _CSS_422, _CSS_420 = 0, 1, 2


def _info_cuda(data: bytes, dev: torch.device):
    """(device with its index, (h, w, components, nvjpegChromaSubsampling_t,
    chroma h, chroma w)), or None for bytes nvJPEG cannot read or with
    four components."""
    if dev.type != "cuda":
        raise ValueError(f"JPEG decoding runs on a CUDA device or the CPU, "
                         f"not {dev}")
    if data[:2] != SOI:
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    info = (ctypes.c_int * 6)()
    rc = ck._function("jpeg", "sparknet_jpeg_info")(data, len(data), info)
    if rc in (_UNDECODABLE, _FOUR_COMPONENTS):
        return None
    if rc != 0:
        raise _nvjpeg_error("nvjpegGetImageInfo", rc)
    return dev, tuple(info)


def _checked(rc: int) -> bool:
    """False for undecodable data; raises for a failed decoder."""
    if rc == _UNDECODABLE:
        return False
    if rc != 0:
        raise _nvjpeg_error("nvjpegDecode", rc)
    return True


def decode_planes(data: bytes, device: str | torch.device = "cuda"):
    """A three-component JPEG sampled 4:4:4, 4:2:2 or 4:2:0 -> its Y, Cb
    and Cr planes, uint8 at their sampled sizes, decoded by nvJPEG on the
    card and complete when returned; None for any other bytes."""
    data = bytes(data)
    found = _info_cuda(data, resolve_device(device))
    if found is None or not _has_planes(found[1]):
        return None
    return _planes(data, *found)


# nvjpegChromaSubsampling_t values whose planes ycc_to_rgb takes
_CSS_444, _CSS_422, _CSS_420 = 0, 1, 2


def _has_planes(info) -> bool:
    return info[2] == 3 and info[3] in (_CSS_444, _CSS_422, _CSS_420)


def _planes(data: bytes, dev: torch.device, info):
    h, w, _, _, ch, cw = info
    s = _thread_stream(dev)
    u8 = dict(dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev), torch.cuda.stream(s):
        y = torch.empty((h, w), **u8)
        cb, cr = torch.empty((ch, cw), **u8), torch.empty((ch, cw), **u8)
        rc = ck._function("jpeg", "sparknet_jpeg_decode_planes")(
            data, len(data), y.data_ptr(), w, cb.data_ptr(), cr.data_ptr(),
            cw, s.cuda_stream)
    return (y, cb, cr) if _checked(rc) else None


def _rgb_cuda(data: bytes, dev: torch.device) -> torch.Tensor | None:
    """(H, W, 3) uint8 decoded by nvJPEG on this thread's stream, complete
    when returned; None when undecodable.  Three-component JPEGs sampled
    4:4:4, 4:2:2 or 4:2:0 come back as planes that ``ycc_to_rgb`` turns
    into libjpeg's RGB; the others as nvJPEG's own RGB."""
    found = _info_cuda(data, dev)
    if found is None:
        return None
    dev, info = found
    s = _thread_stream(dev)
    with torch.cuda.device(dev), torch.cuda.stream(s):
        if _has_planes(info):
            planes = _planes(data, dev, info)
            return None if planes is None else ck.ycc_to_rgb(*planes)
        rgb = torch.empty((info[0], info[1], 3), dtype=torch.uint8,
                          device=dev)
        rc = ck._function("jpeg", "sparknet_jpeg_decode_rgbi")(
            data, len(data), rgb.data_ptr(), rgb.stride(0), s.cuda_stream)
    return rgb if _checked(rc) else None
