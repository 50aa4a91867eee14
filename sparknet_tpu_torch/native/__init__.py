"""The native host data pipeline: ``data_pipeline.cpp`` over ctypes.

The port's counterpart of ``sparknet_tpu/native/__init__.py``: the host
data plane's hot loops (the batched crop, mirror and mean of a feed's
transform, CIFAR record decoding, the batched Datum parse, the mean
image's sums, a libjpeg decode and force-resize) in C++, compiled with
``g++`` at first use into ``sparknet_tpu_torch/_build/`` and loaded over
ctypes.  Each entry has a numpy path with the same results bit for bit,
taken where no library could be built (``available()`` says which);
``parse_datum_batch`` then returns None and its callers parse record by
record.

The build is named by a hash of the source and the flags and written to
a temporary name first, then renamed into place, so processes that
build at once never load half a library.  Where libjpeg's header is
missing, the library is built without it (``-DSN_NO_JPEG``): the other
four entries stay, and ``decode_jpeg_resize`` falls back to
``data/jpeg.py``'s CPU decode (``jpeg_available()`` says which).  On
the card JPEGs decode with nvJPEG, not here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "data_pipeline.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# (defines, link flags), tried in order: with libjpeg, then without
VARIANTS = (([], ["-ljpeg"]), (["-DSN_NO_JPEG"], []))

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _target(defines: list[str], libs: list[str]) -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS + defines + libs).encode())
    return BUILD_DIR / f"libsparknet_data-{digest.hexdigest()[:16]}.so"


def _compile(defines: list[str], libs: list[str]) -> tuple[Path | None, str]:
    """The built library of one variant, compiling it if needed; (None,
    the compiler's complaint) when it does not build."""
    out = _target(defines, libs)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *defines, str(_SRC), *libs, "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return None, f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None, proc.stderr[-2000:]
    os.replace(tmp, out)   # atomic: another process never loads half
    return out, ""


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i64, i32p, f32p, f64p, u8p, i64p = (
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"))
    lib.sn_decode_cifar.argtypes = [u8p, i64, f32p, i32p]
    lib.sn_crop_batch_f32.argtypes = [
        f32p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
        ctypes.c_int, i32p, i32p, i32p, ctypes.c_void_p, i64]
    lib.sn_accumulate_mean.argtypes = [f32p, i64, i64, f64p]
    lib.sn_decode_jpeg_resize.argtypes = [
        u8p, i64, ctypes.c_int, ctypes.c_int, f32p]
    lib.sn_parse_datum_batch.argtypes = [
        u8p, i64p, i64p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i32p]
    lib.sn_has_jpeg.argtypes = []
    for fn in (lib.sn_decode_cifar, lib.sn_crop_batch_f32,
               lib.sn_accumulate_mean, lib.sn_decode_jpeg_resize,
               lib.sn_parse_datum_batch, lib.sn_has_jpeg):
        fn.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None where it does not
    build (the callers then take the numpy paths)."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        errors = []
        for defines, libs in VARIANTS:
            path, err = _compile(defines, libs)
            if path is not None:
                try:
                    _lib = _bind(path)
                    return _lib
                except OSError as e:   # e.g. built where libjpeg was
                    err = f"{path.name} does not load: {e}"
            errors.append(err)
        _build_error = "\n".join(errors)
        print("sparknet_tpu_torch.native: build failed, using the numpy "
              f"paths\n{_build_error}", file=sys.stderr)
        return None


def available() -> bool:
    return get_lib() is not None


def build_error() -> str | None:
    """Why the library did not build, or None."""
    get_lib()
    return _build_error


def jpeg_available() -> bool:
    """True when the built library has libjpeg's decode."""
    lib = get_lib()
    return lib is not None and lib.sn_has_jpeg() == 1


# ---------------------------------------------------------------------------
# numpy-signature entries, each with its numpy path
# ---------------------------------------------------------------------------

def decode_cifar(records: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint8 [N, 3073] CIFAR-10 records -> (f32 [N, 3, 32, 32] images,
    int32 [N] labels)."""
    records = np.ascontiguousarray(records, np.uint8)
    n = records.shape[0]
    lib = get_lib()
    if lib is None:
        labels = records[:, 0].astype(np.int32)
        images = records[:, 1:].reshape(n, 3, 32, 32).astype(np.float32)
        return images, labels
    images = np.empty((n, 3, 32, 32), np.float32)
    labels = np.empty((n,), np.int32)
    rc = lib.sn_decode_cifar(records.reshape(-1), n, images.reshape(-1),
                             labels)
    if rc != 0:
        raise RuntimeError(f"sn_decode_cifar failed: {rc}")
    return images, labels


def crop_batch(batch: np.ndarray, crop: int, ys: np.ndarray, xs: np.ndarray,
               flips: np.ndarray, mean: np.ndarray | float | None = None,
               out: np.ndarray | None = None) -> np.ndarray:
    """Crop each image of an f32 (N, C, H, W) batch to (crop, crop) at
    (ys, xs), mirror those whose ``flips`` is 1, then subtract ``mean``
    (one value, or one of the crop's size) (ByteImage.cropInto over a
    batch).  ``out``: a (N, C, crop, crop) f32 C-contiguous buffer to
    write into; another one is ignored and a fresh one allocated."""
    batch = np.ascontiguousarray(batch, np.float32)
    n, c, h, w = batch.shape
    ys = np.ascontiguousarray(ys, np.int32)
    xs = np.ascontiguousarray(xs, np.int32)
    flips = np.ascontiguousarray(flips, np.int32)
    if crop > h or crop > w or any(
            len(a) != n for a in (ys, xs, flips)) or (n and (
            ys.min() < 0 or xs.min() < 0 or ys.max() + crop > h
            or xs.max() + crop > w)):
        raise ValueError(f"crop_batch: a {crop}x{crop} window at the "
                         f"offsets given leaves the {h}x{w} images")
    if (out is None or out.shape != (n, c, crop, crop)
            or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]):
        out = np.empty((n, c, crop, crop), np.float32)
    mean_arr: np.ndarray | None = None
    if mean is not None:
        m = np.asarray(mean, np.float32)
        mean_arr = (m.reshape(1) if m.ndim == 0 else np.ascontiguousarray(
            np.broadcast_to(m, (c, crop, crop)), np.float32))
    lib = get_lib()
    if lib is None:
        for i in range(n):
            img = batch[i, :, ys[i]:ys[i] + crop, xs[i]:xs[i] + crop]
            out[i] = img[:, :, ::-1] if flips[i] else img
        if mean_arr is not None:
            out -= mean_arr if mean_arr.size > 1 else mean_arr[0]
        return out
    mean_ptr = (mean_arr.ctypes.data_as(ctypes.c_void_p)
                if mean_arr is not None else None)
    rc = lib.sn_crop_batch_f32(
        batch.reshape(-1), n, c, h, w, out.reshape(-1), crop, ys, xs, flips,
        mean_ptr, 0 if mean_arr is None else mean_arr.size)
    if rc != 0:
        raise RuntimeError(f"sn_crop_batch_f32 failed: {rc}")
    return out


def accumulate_mean(images: np.ndarray, acc: np.ndarray) -> None:
    """Add an f32 [N, ...] batch into the float64 per-pixel sums ``acc``,
    image after image (ComputeMean's partition sums)."""
    images = np.ascontiguousarray(images, np.float32)
    n = images.shape[0]
    plane = images.size // max(n, 1)
    if (acc.size != plane or acc.dtype != np.float64
            or not acc.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"accumulator mismatch: acc {acc.shape}/{acc.dtype} (C-"
            f"contiguous float64 wanted), image plane has {plane} elements")
    lib = get_lib()
    if lib is None:
        for img in images.reshape(n, -1):
            acc += img.reshape(acc.shape)
        return
    rc = lib.sn_accumulate_mean(images.reshape(-1), n, plane,
                                acc.reshape(-1))
    if rc != 0:
        raise RuntimeError(f"sn_accumulate_mean failed: {rc}")


def decode_jpeg_resize(data: bytes, out_h: int, out_w: int
                       ) -> np.ndarray | None:
    """JPEG bytes -> f32 [3, out_h, out_w], force-resized with aspect
    ignored (ScaleAndConvert); None for bytes libjpeg does not decode
    (the caller drops them).  Without libjpeg here, ``data/jpeg.py``'s
    CPU decode, which gives libjpeg's pixels and this resize's values."""
    lib = get_lib()
    if lib is None or lib.sn_has_jpeg() != 1:
        from ..data import jpeg
        img = jpeg.decode_jpeg_resize(data, out_h, out_w, device="cpu")
        return None if img is None else img.numpy()
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((3, out_h, out_w), np.float32)
    rc = lib.sn_decode_jpeg_resize(buf, buf.size, out_h, out_w,
                                   out.reshape(-1))
    if rc != 0:
        return None
    return out


def parse_datum_batch(records: list[bytes], c: int, h: int, w: int,
                      ) -> tuple[np.ndarray, np.ndarray] | None:
    """Serialized Datums -> (f32 [n, c, h, w], int32 labels) in one
    native pass (data_reader.cpp with C++ protobuf).  None without the
    library, or when a record is encoded, malformed or of another shape:
    the caller then parses record by record."""
    lib = get_lib()
    if lib is None or not records:
        return None
    sizes = np.asarray([len(r) for r in records], np.int64)
    offsets = np.zeros(len(records), np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    buf = np.frombuffer(b"".join(records), np.uint8)
    if not buf.size:
        buf = np.zeros(1, np.uint8)
    out = np.empty((len(records), c, h, w), np.float32)
    labels = np.empty((len(records),), np.int32)
    rc = lib.sn_parse_datum_batch(buf, offsets, sizes, len(records),
                                  c, h, w, out.reshape(-1), labels)
    if rc != 0:
        return None
    return out, labels
