"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Each kernel is CUDA C++ for Hopper (``sm_90a``) under ``ops/csrc/`` with a
plain C interface.  It is built with ``nvcc`` from the checkout's sources
at first use, into ``sparknet_tpu_torch/_build/``, and loaded with
``ctypes``.  Each wrapper:

- on a CPU tensor, returns its kernel's plain PyTorch version;
- on a CUDA tensor, checks device, dtype, shape and contiguity, allocates
  the outputs, launches the kernel on the current stream and raises if
  the launch fails.  It never falls back to the plain version;
- adds one to its entry in :data:`launch_counts` for each launch; an
  LRN kernel launched with its ReLU folded in (``relu=True``) counts
  under its own ``<wrapper>_relu`` entry, so a run shows that the fold
  ran.

Kernels, all of ``sparknet_tpu/ops/pallas_kernels.py``'s TPU kernels:

``lrn_across_channels`` (``csrc/lrn.cu``) replaces ``_lrn_infer_kernel``
(:72-80), reached through ``relu_lrn_across_channels`` (:128-149):
Caffe's ACROSS_CHANNELS LRN forward without the ``scale`` residual, with
an optional ReLU in front.

``lrn_across_channels_fwd`` (``csrc/lrn.cu``) replaces ``_lrn_fwd_kernel``
(:56-69), the forward of that function's custom VJP (:152): the same
forward, also returning ``scale``.

``lrn_across_channels_bwd`` (``csrc/lrn_bwd.cu``) replaces
``_lrn_bwd_kernel`` (:83-102), the custom VJP's backward (:157-171).

``max_pool_bwd`` (``csrc/maxpool_bwd.cu``) replaces
``_maxpool_bwd_kernel_s1`` (:203-265) and ``_maxpool_bwd_kernel_strided``
(:277-341) under ``max_pool_vmem_bwd`` (:379-405): the MAX-pool backward
with Caffe's first-maximum tie-break, any stride and padding.

Two kernels have no TPU counterpart; they take the place of the libjpeg
decode and resize of the JAX package's native pipeline
(``sparknet_tpu/native/data_pipeline.cpp:202-276``).  ``ycc_to_rgb``
(``csrc/jpeg.cu``) upsamples the chroma planes nvJPEG decodes and converts
them to interleaved RGB with libjpeg-turbo's integer arithmetic;
``resize_bilinear`` (``csrc/jpeg.cu``) force-resizes interleaved RGB into
planar float32 with the native pipeline's float32 arithmetic
(:248-272), bit for bit.  The same library binds nvJPEG itself, which
``data/jpeg.py`` drives.

The LRN kernels and the pool backward take a launch plan chosen here by
shape (:func:`lrn_plan`, :func:`lrn_bwd_plan`, :func:`max_pool_bwd_plan`):
plain functions that the CPU tests check for coverage and limits without
a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# kernel library name -> its source under csrc/ (each includes common.cuh)
SOURCES = {"lrn": "lrn.cu", "lrn_bwd": "lrn_bwd.cu",
           "maxpool_bwd": "maxpool_bwd.cu", "jpeg": "jpeg.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]
# library name -> the libraries it links beyond the CUDA runtime
LINK_FLAGS = {"jpeg": ["-lnvjpeg"]}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> {C function: argtypes}; every function returns the
# launch's cudaError_t as an int
_SIGNATURES = {
    "lrn": {
        "sparknet_lrn_across_channels":
            [_P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P],
        "sparknet_lrn_across_channels_fwd":
            [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P],
    },
    "lrn_bwd": {
        "sparknet_lrn_across_channels_bwd":
            [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _I, _P],
    },
    "maxpool_bwd": {
        "sparknet_max_pool_bwd":
            [_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _I, _I,
             _I, _I, _I, _I, _I, _I, _P],
    },
    "jpeg": {
        "sparknet_jpeg_info": [_P, ctypes.c_longlong, _P],
        "sparknet_jpeg_decode_rgbi": [_P, ctypes.c_longlong, _P, _I, _P],
        "sparknet_jpeg_decode_planes":
            [_P, ctypes.c_longlong, _P, _I, _P, _P, _I, _P],
        "sparknet_jpeg_decode_unchanged":
            [_P, ctypes.c_longlong, _P, _P, _P, _P, _I, _P],
        "sparknet_ycc_to_rgb":
            [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
        "sparknet_resize_bilinear": [_P, _I, _I, _I, _P, _I, _I, _I, _P],
    },
}

# wrapper name -> kernel launches since the last reset
launch_counts: dict[str, int] = {
    "lrn_across_channels": 0, "lrn_across_channels_fwd": 0,
    "lrn_across_channels_bwd": 0, "max_pool_bwd": 0, "ycc_to_rgb": 0,
    "resize_bilinear": 0, "lrn_across_channels_relu": 0,
    "lrn_across_channels_fwd_relu": 0, "lrn_across_channels_bwd_relu": 0}

_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and Path(home, "bin", "nvcc").exists():
        return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _target(name: str) -> Path:
    """Build output, named by the hash of the source, the shared headers
    and the compile and link flags, so an edited source or flag never
    loads a stale library."""
    digest = hashlib.sha256((_CSRC / SOURCES[name]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + LINK_FLAGS.get(name, [])).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named kernel libraries (all by default) that are not
    built yet, one ``nvcc`` per source, all started together.  Returns
    ``{name: {"seconds": s, "ptxas": text}}`` for the ones compiled now.
    Raises with the compiler's output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name]),
             *LINK_FLAGS.get(name, [])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report = {}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build never loads half
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def _function(lib_name: str, fn_name: str):
    lib = _libs.get(lib_name)
    if lib is None:
        with _build_lock:
            if lib_name not in _libs:
                build([lib_name])
                lib = ctypes.CDLL(str(_target(lib_name)))
                for fname, argtypes in _SIGNATURES[lib_name].items():
                    fn = getattr(lib, fname)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _libs[lib_name] = lib
        lib = _libs[lib_name]
    return getattr(lib, fn_name)


def _launch(wrapper: str, lib_name: str, fn_name: str, device, *args):
    """Launch on the current stream of ``device``; raise if refused."""
    fn = _function(lib_name, fn_name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper}: kernel launch failed with CUDA "
                           f"error {rc}")
    launch_counts[wrapper] += 1


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: wants a CPU or CUDA tensor, "
                         f"got one on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: wants float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{what}: wants an (N, C, H, W) tensor, "
                         f"got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: wants a contiguous tensor")


def _check_alike(what: str, x: torch.Tensor, **others: torch.Tensor):
    """Each of ``others`` on x's device, of x's dtype, contiguous."""
    for name, t in others.items():
        _check_cuda_input(t, f"{what} ({name})")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"x is {x.dtype} on {x.device}")


def _check_lrn(what: str, x: torch.Tensor, size: int) -> None:
    _check_cuda_input(x, what)
    if size < 1:
        raise ValueError(f"{what}: local_size must be >= 1, got {size}")


# ---------------------------------------------------------------------------
# Launch plans
# ---------------------------------------------------------------------------

SMS = 132                      # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232_448             # shared bytes one block may opt in to
SMEM_DEFAULT = 48 * 1024       # shared bytes a block gets without opting in
GRID_X_MAX, GRID_Y_MAX = 2**31 - 1, 65535


class LRNPlan(NamedTuple):
    """An LRN kernel's launch: ``chunk`` channels per thread over a grid
    of ``blocks`` = (position blocks, channel blocks) of ``threads``.  A
    forward block is one chunk of ``threads`` positions; a backward block
    is 32 positions by ``threads // 32`` consecutive chunks."""
    chunk: int
    blocks: tuple[int, int]
    threads: int


LRN_THREADS = 128
LRN_CHUNKS = (4, 8)             # the kernel's compile-time chunk lengths
# threads one wave of the card holds (2,048 a multiprocessor): below this
# a longer chunk would leave multiprocessors idle
LRN_FILL_THREADS = SMS * 2048


def _lrn_positions(what: str, n: int, c: int, hw: int) -> int:
    """n * hw, the positions an LRN kernel's threads run over, flattened
    over (n, p), so any batch with ``n * hw < 2**31`` is taken."""
    positions = n * hw
    if n < 1 or c < 1 or hw < 1:
        raise ValueError(f"{what}: empty shape ({n}, {c}, {hw})")
    if positions > GRID_X_MAX:
        raise ValueError(f"{what}: n * hw = {positions} positions exceed "
                         f"the kernel's int32 index")
    return positions


@functools.lru_cache(maxsize=512)
def lrn_plan(n: int, c: int, hw: int) -> LRNPlan:
    """The LRN forward's launch: the longer chunk where it still gives the
    card a full wave of threads, else the shorter, and no longer than the
    channels need: short chunks spread a small batch over the card, long
    ones cut the halo's reloads at large batches."""
    positions = _lrn_positions("lrn_plan", n, c, hw)
    chunk = LRN_CHUNKS[0]
    for cand in LRN_CHUNKS:
        if positions * -(-c // cand) >= LRN_FILL_THREADS:
            chunk = cand
    chunk = min(chunk, next((k for k in LRN_CHUNKS if k >= c),
                            LRN_CHUNKS[-1]))
    blocks = (-(-positions // LRN_THREADS), -(-c // chunk))
    if blocks[1] > GRID_Y_MAX:
        raise ValueError(f"lrn_plan: {c} channels need {blocks[1]} chunks, "
                         f"over the grid's {GRID_Y_MAX}")
    return LRNPlan(chunk, blocks, LRN_THREADS)


LRN_BWD_CHUNK = 4               # the backward kernel's chunk length
LRN_BWD_LANES = 32              # positions of a block, one per lane
LRN_BWD_MAX_WARPS = 8           # the most warps the kernel takes a block
# the plan's warps: 4 and 8 measure within 2% of each other at CaffeNet's
# norms, 4 ahead (chip_smoke.py's lrn_bwd_warps line)
LRN_BWD_WARPS = 4


@functools.lru_cache(maxsize=512)
def lrn_bwd_plan(n: int, c: int, hw: int) -> LRNPlan:
    """The LRN backward's launch: blocks of 32 positions by up to
    ``LRN_BWD_WARPS`` warps, each warp a chunk of 4 consecutive channels,
    as many warps as the channels fill.  The warps of a block pass each
    other their edge channels' terms, so only the block's outer halo is
    loaded twice: at size 5 and 4 warps, 4 halo channels to 16."""
    positions = _lrn_positions("lrn_bwd_plan", n, c, hw)
    warps = min(LRN_BWD_WARPS, -(-c // LRN_BWD_CHUNK))
    blocks = (-(-positions // LRN_BWD_LANES),
              -(-c // (LRN_BWD_CHUNK * warps)))
    if blocks[1] > GRID_Y_MAX:
        raise ValueError(f"lrn_bwd_plan: {c} channels need {blocks[1]} "
                         f"blocks, over the grid's {GRID_Y_MAX}")
    return LRNPlan(LRN_BWD_CHUNK, blocks, LRN_BWD_LANES * warps)


class PoolBand(NamedTuple):
    """One band of a plane in the pool backward, as the kernel's
    ``band_of`` computes it: it owns dx rows [r0, r1), computes window
    rows [oi0, oi0 + nwr) and stages input rows [xr0, xr0 + nxr)."""
    r0: int
    r1: int
    oi0: int
    nwr: int
    xr0: int
    nxr: int


def pool_band(band: int, bands: int, band_rows: int, h: int, kh: int,
              sh: int, ph: int, oh: int) -> PoolBand:
    """``csrc/maxpool_bwd.cu::band_of``, line for line.  The last band
    stages down to the plane's last row, so one band of whole planes is
    one contiguous range."""
    r0 = band * band_rows
    r1 = min(r0 + band_rows, h)
    oi0 = (r0 + ph - kh) // sh + 1 if r0 + ph >= kh else 0
    oi1 = min((r1 - 1 + ph) // sh, oh - 1)
    nwr = max(oi1 - oi0 + 1, 0)
    xr0 = max(oi0 * sh - ph, 0)
    xr1 = h if band == bands - 1 else min(oi1 * sh - ph + kh, h)
    return PoolBand(r0, r1, oi0, nwr, xr0, max(xr1 - xr0, 0))


def pool_band_bytes(b: PoolBand, planes: int, w: int, ow: int,
                    elem_bytes: int) -> int:
    """Shared bytes of a block for a band of ``planes`` planes, as the
    kernel's ``band_bytes``: an (argmax, dy) int2 per window, then the
    staged x rows, with 16 bytes of slack to align them as their
    source."""
    wins = planes * b.nwr * ow
    return -(-8 * wins // 16) * 16 + 16 + elem_bytes * planes * b.nxr * w


class PoolPlan(NamedTuple):
    """The pool backward's launch: blocks of ``planes_per_block`` whole
    planes, or of one band of ``band_rows`` dx rows of a plane cut into
    ``bands``; ``blocks`` blocks of ``threads`` threads with ``smem_bytes``
    each.  The kernel derives ``threads`` from the plane's width."""
    planes_per_block: int
    band_rows: int
    bands: int
    blocks: int
    threads: int
    smem_bytes: int


POOL_THREADS = 256             # the most threads of a pool block
POOL_BLOCK_ELEMS = 3072        # dx elements a block of packed planes aims at
POOL_FILL_BLOCKS = 8           # blocks a multiprocessor that packing leaves
POOL_MAX_ROWS = 1 << 22        # the kernel's float-reciprocal division bound


def pool_block_threads(w: int) -> int:
    """Threads of a pool block, as the kernel's ``block_threads``: whole
    rows of ``min(w, 256)`` lanes."""
    lanes = min(w, POOL_THREADS)
    return POOL_THREADS // lanes * lanes


def _pool_smem(planes: int, band_rows: int, h: int, w: int, kh: int,
               sh: int, ph: int, oh: int, ow: int, elem_bytes: int) -> int:
    """The largest band's shared bytes, as the kernel's ``launch``."""
    bands = -(-h // band_rows)
    return max(pool_band_bytes(pool_band(b, bands, band_rows, h, kh, sh, ph,
                                         oh), planes, w, ow, elem_bytes)
               for b in range(bands))


@functools.lru_cache(maxsize=512)
def max_pool_bwd_plan(planes: int, h: int, w: int, kh: int, kw: int,
                      sh: int, sw: int, ph: int, pw: int, oh: int, ow: int,
                      elem_bytes: int) -> PoolPlan:
    """A plane whose staging fits the default 48 KB of shared memory is
    one band, and several such planes share a block up to about
    ``POOL_BLOCK_ELEMS`` dx elements and 48 KB, while leaving at least
    ``POOL_FILL_BLOCKS`` blocks a multiprocessor.  A bigger plane is cut
    into the tallest bands of dx rows that fit 48 KB, or, failing that,
    the 227 KB a block may opt in to; a plane whose single-row band does
    not fit is refused.  Few planes are cut into more bands, so that the
    grid still fills the card."""
    if planes < 1 or min(h, w, kh, kw, sh, sw, oh, ow) < 1:
        raise ValueError("max_pool_bwd_plan: empty shape or geometry")
    if h + ph >= POOL_MAX_ROWS or w + pw >= POOL_MAX_ROWS:
        raise ValueError(f"max_pool_bwd_plan: a {h}x{w} plane exceeds the "
                         f"kernel's {POOL_MAX_ROWS} rows or columns")
    smem = functools.partial(_pool_smem, h=h, w=w, kh=kh, sh=sh, ph=ph,
                             oh=oh, ow=ow, elem_bytes=elem_bytes)
    if smem(1, h) <= SMEM_DEFAULT:
        ppb = max(1, min(POOL_BLOCK_ELEMS // (h * w),
                         planes // (POOL_FILL_BLOCKS * SMS)))
        while ppb > 1 and smem(ppb, h) > SMEM_DEFAULT:
            ppb -= 1
        band_rows = h
    else:
        ppb = 1
        fits = lambda limit: next((r for r in range(h, 0, -1)
                                   if smem(1, r) <= limit), None)
        band_rows = fits(SMEM_DEFAULT) or fits(SMEM_MAX)
        if band_rows is None:
            raise ValueError(f"max_pool_bwd_plan: one dx row of a {h}x{w} "
                             f"plane needs {smem(1, 1)} shared bytes, over "
                             f"the {SMEM_MAX} a block may use")
        # as many bands, of even height where that fits no worse
        even = -(-h // -(-h // band_rows))
        if smem(1, even) <= smem(1, band_rows):
            band_rows = even
    if ppb == 1 and planes * -(-h // band_rows) < 2 * SMS:
        band_rows = min(band_rows, -(-h // min(h, -(-2 * SMS // planes))))
    bands = -(-h // band_rows)
    blocks = -(-planes // ppb) * bands
    if blocks > GRID_X_MAX:
        raise ValueError(f"max_pool_bwd_plan: {blocks} blocks exceed the "
                         f"grid's {GRID_X_MAX}")
    return PoolPlan(ppb, band_rows, bands, blocks, pool_block_threads(w),
                    smem(ppb, band_rows))


# ---------------------------------------------------------------------------
# LRN: forward (inference and training forms) and backward
# ---------------------------------------------------------------------------

def _math_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 math for f32 and bf16 I/O, as the kernels; f64 stays f64 (the
    plain versions' finite-difference tests)."""
    return torch.promote_types(x.dtype, torch.float32)


def _window_sum(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Sum of ``v`` over the channel window [c - lo, c + hi], zero-padded,
    by shifted adds in ascending channel order (the TPU kernels' order)."""
    c = v.shape[1]
    padded = F.pad(v, (0, 0, 0, 0, lo, hi))
    out = padded[:, 0:c]
    for d in range(1, lo + hi + 1):
        out = out + padded[:, d:d + c]
    return out


def _lrn_window(size: int) -> tuple[int, int]:
    """(pre, post) of Caffe's forward window."""
    pre = (size - 1) // 2
    return pre, size - 1 - pre


def _lrn_scale(a: torch.Tensor, size: int, alpha: float,
               k: float) -> torch.Tensor:
    return k + (alpha / size) * _window_sum(a * a, *_lrn_window(size))


def lrn_across_channels_reference(x: torch.Tensor, size: int, alpha: float,
                                  beta: float, k: float,
                                  relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the inference kernel: f32 math, the window
    summed by shifted adds in ascending channel order, cast back to the
    I/O dtype."""
    a = x.to(_math_dtype(x))
    if relu:
        a = torch.relu(a)
    return (a * _lrn_scale(a, size, alpha, k).pow(-beta)).to(x.dtype)


def lrn_across_channels(x: torch.Tensor, size: int, alpha: float,
                        beta: float, k: float,
                        relu: bool = False) -> torch.Tensor:
    """Caffe ACROSS_CHANNELS LRN of an (N, C, H, W) tensor, f32 or bf16,
    with ``relu`` folding a zero-slope ReLU in front: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return lrn_across_channels_reference(x, size, alpha, beta, k, relu)
    _check_lrn("lrn_across_channels", x, size)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _launch("lrn_across_channels" + ("_relu" if relu else ""), "lrn",
            "sparknet_lrn_across_channels", x.device, x.data_ptr(),
            y.data_ptr(), n, c, h * w, size, alpha / size, beta, k,
            int(relu), int(x.dtype == torch.bfloat16),
            lrn_plan(n, c, h * w).chunk)
    return y


def lrn_across_channels_fwd_reference(
        x: torch.Tensor, size: int, alpha: float, beta: float, k: float,
        relu: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: ``(y, scale)``, both in the
    I/O dtype, y computed from the unrounded scale."""
    a = x.to(_math_dtype(x))
    if relu:
        a = torch.relu(a)
    scale = _lrn_scale(a, size, alpha, k)
    return (a * scale.pow(-beta)).to(x.dtype), scale.to(x.dtype)


def lrn_across_channels_fwd(x: torch.Tensor, size: int, alpha: float,
                            beta: float, k: float, relu: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The LRN forward that also returns its ``scale`` residual, the
    forward of :class:`ops.vision` LRN's autograd function: the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return lrn_across_channels_fwd_reference(x, size, alpha, beta, k,
                                                 relu)
    _check_lrn("lrn_across_channels_fwd", x, size)
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    scale = torch.empty_like(x)
    if x.numel() == 0:
        return y, scale
    _launch("lrn_across_channels_fwd" + ("_relu" if relu else ""), "lrn",
            "sparknet_lrn_across_channels_fwd", x.device, x.data_ptr(),
            y.data_ptr(), scale.data_ptr(), n, c, h * w, size, alpha / size,
            beta, k, int(relu), int(x.dtype == torch.bfloat16),
            lrn_plan(n, c, h * w).chunk)
    return y, scale


def lrn_across_channels_bwd_reference(
        x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, size: int,
        alpha: float, beta: float, relu: bool = False) -> torch.Tensor:
    """Plain version of the backward, the closed form of the JAX package's
    ``_relu_lrn_ref_vjp_bwd`` (ops/vision.py:543-559): the window of the
    ratio sum is the forward's reflected, (post, pre)."""
    md = _math_dtype(x)
    xf, s, g = x.to(md), scale.to(md), dy.to(md)
    a = torch.relu(xf) if relu else xf
    y = a * s.pow(-beta)
    pre, post = _lrn_window(size)
    ratio = _window_sum(g * y / s, post, pre)
    da = g * s.pow(-beta) - (2.0 * alpha * beta / size) * a * ratio
    if relu:
        da = torch.where(xf > 0, da, torch.zeros_like(da))
    return da.to(x.dtype)


def lrn_across_channels_bwd(x: torch.Tensor, scale: torch.Tensor,
                            dy: torch.Tensor, size: int, alpha: float,
                            beta: float, relu: bool = False) -> torch.Tensor:
    """Gradient of the LRN with respect to its input, from the forward's
    input ``x``, its ``scale`` residual and the output gradient ``dy``:
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return lrn_across_channels_bwd_reference(x, scale, dy, size, alpha,
                                                 beta, relu)
    what = "lrn_across_channels_bwd"
    _check_lrn(what, x, size)
    _check_alike(what, x, scale=scale, dy=dy)
    if scale.shape != x.shape or dy.shape != x.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)} and dy {tuple(dy.shape)} "
                         f"differ in shape")
    n, c, h, w = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    plan = lrn_bwd_plan(n, c, h * w)
    _launch(what + ("_relu" if relu else ""), "lrn_bwd",
            "sparknet_lrn_across_channels_bwd", x.device,
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), n,
            c, h * w, size, 2.0 * alpha * beta / size, beta, int(relu),
            int(x.dtype == torch.bfloat16), plan.threads // LRN_BWD_LANES)
    return dx


# ---------------------------------------------------------------------------
# MAX-pool backward
# ---------------------------------------------------------------------------

def _pool_windows(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int,
                  ph: int, pw: int, oh: int, ow: int) -> torch.Tensor:
    """Every pooling window of x as (N, C, oh*ow, kh*kw), taps in
    row-major order, the padding at -inf, in x's math dtype."""
    n, c, h, w = x.shape
    hp, wp = (oh - 1) * sh + kh, (ow - 1) * sw + kw
    xp = F.pad(x.to(_math_dtype(x)),
               (pw, max(wp - w - pw, 0), ph, max(hp - h - ph, 0)),
               value=-math.inf)[:, :, :hp, :wp]
    wins = xp.unfold(2, kh, sh).unfold(3, kw, sw)   # (N, C, oh, ow, kh, kw)
    return wins.reshape(n, c, oh * ow, kh * kw)


def _route_to_taps(idx: torch.Tensor, dy: torch.Tensor, h: int, w: int,
                   kh: int, kw: int, sh: int, sw: int, ph: int, pw: int,
                   oh: int, ow: int) -> torch.Tensor:
    """dx from each window's chosen tap ``idx`` (N, C, oh*ow): every
    window's dy added at its tap, in the math dtype of dy's I/O type."""
    n, c = dy.shape[:2]
    hb = max((oh - 1) * sh + kh, h + ph)
    wb = max((ow - 1) * sw + kw, w + pw)
    oi = torch.arange(oh, device=idx.device).repeat_interleave(ow)
    oj = torch.arange(ow, device=idx.device).repeat(oh)
    rows = oi * sh + torch.div(idx, kw, rounding_mode="floor")
    cols = oj * sw + idx % kw
    flat = (rows * wb + cols).reshape(n * c, oh * ow)
    acc = torch.zeros(n * c, hb * wb, dtype=_math_dtype(dy),
                      device=dy.device)
    acc.scatter_add_(1, flat, dy.to(acc.dtype).reshape(n * c, oh * ow))
    acc = acc.reshape(n, c, hb, wb)[:, :, ph:ph + h, pw:pw + w]
    return acc.to(dy.dtype).contiguous()


def max_pool_bwd_reference(x: torch.Tensor, dy: torch.Tensor, kh: int,
                           kw: int, sh: int, sw: int, ph: int, pw: int,
                           oh: int, ow: int) -> torch.Tensor:
    """Plain version of the MAX-pool backward: each window's first
    maximum (``argmax`` keeps the first) gathered explicitly, then every
    window's dy added there, in f32 for f32/bf16 I/O."""
    idx = _pool_windows(x, kh, kw, sh, sw, ph, pw, oh, ow).argmax(dim=-1)
    return _route_to_taps(idx, dy, x.shape[2], x.shape[3], kh, kw, sh, sw,
                          ph, pw, oh, ow)


def max_pool_bwd(x: torch.Tensor, dy: torch.Tensor, kh: int, kw: int,
                 sh: int, sw: int, ph: int, pw: int, oh: int,
                 ow: int) -> torch.Tensor:
    """Gradient of Caffe MAX pooling (kernel kh x kw, stride sh x sw,
    padding ph x pw, ceil-mode output oh x ow) with respect to its input
    ``x``, from the output gradient ``dy``: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return max_pool_bwd_reference(x, dy, kh, kw, sh, sw, ph, pw, oh, ow)
    what = "max_pool_bwd"
    _check_cuda_input(x, what)
    _check_alike(what, x, dy=dy)
    n, c, h, w = x.shape
    if tuple(dy.shape) != (n, c, oh, ow):
        raise ValueError(f"{what}: dy is {tuple(dy.shape)}, the pool's "
                         f"output is {(n, c, oh, ow)}")
    if (min(kh, kw, sh, sw, oh, ow) < 1 or not 0 <= ph < kh
            or not 0 <= pw < kw or (oh - 1) * sh - ph >= h
            or (ow - 1) * sw - pw >= w):
        raise ValueError(f"{what}: geometry kernel {kh}x{kw}, stride "
                         f"{sh}x{sw}, pad {ph}x{pw}, output {oh}x{ow} on a "
                         f"{h}x{w} input leaves a window with no input")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    plan = max_pool_bwd_plan(n * c, h, w, kh, kw, sh, sw, ph, pw, oh, ow,
                             x.element_size())
    _launch(what, "maxpool_bwd", "sparknet_max_pool_bwd", x.device,
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), n * c, h, w, kh, kw,
            sh, sw, ph, pw, oh, ow, plan.planes_per_block, plan.band_rows,
            plan.smem_bytes, int(x.dtype == torch.bfloat16))
    return dx


# ---------------------------------------------------------------------------
# Decoded JPEGs: libjpeg's chroma upsampling and colour conversion, and the
# bilinear force-resize (csrc/jpeg.cu)
# ---------------------------------------------------------------------------

def _sampling(plane: torch.Tensor, h: int, w: int) -> tuple[int, int]:
    """(sub_h, sub_v) of a chroma plane of an h x w image: 1, or 2 when
    the plane holds every other column (row), ceil(w / 2) of them."""
    ch, cw = plane.shape
    sub_h = 1 if cw == w else 2
    sub_v = 1 if ch == h else 2
    if cw != -(-w // sub_h) or ch != -(-h // sub_v):
        raise ValueError(f"a {ch}x{cw} chroma plane fits no 4:4:4, 4:2:2 "
                         f"or 4:2:0 sampling of a {h}x{w} image")
    if (sub_h, sub_v) == (1, 2):
        raise ValueError("4:4:0 chroma (every other row only) is not "
                         "upsampled here")
    return sub_h, sub_v


def _upsample_reference(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """libjpeg-turbo's chroma upsampling of an (ch, cw) uint8 plane to (h,
    w) int32: none for 4:4:4; for chroma at most 2 wide, replication
    (jdsample.c h2v1_upsample, h2v2_upsample); else the fancy triangle
    filters (h2v1_fancy_upsample, h2v2_fancy_upsample), edges replicated."""
    sub_h, sub_v = _sampling(c, h, w)
    c = c.to(torch.int32)
    if sub_h == 1:
        return c
    if c.shape[1] <= 2:
        return c.repeat_interleave(sub_v, 0).repeat_interleave(2, 1)[:h, :w]

    def along_x(s, lo: int, hi: int, edge_scale: int):
        """Even and odd outputs of each input column: (3 s[i] + s[i-1] +
        lo) and (3 s[i] + s[i+1] + hi), the edge columns with
        edge_scale * s alone."""
        left = torch.cat([s[:, :1], s[:, :-1]], 1)
        right = torch.cat([s[:, 1:], s[:, -1:]], 1)
        even, odd = 3 * s + left + lo, 3 * s + right + hi
        even[:, 0] = edge_scale * s[:, 0] + lo
        odd[:, -1] = edge_scale * s[:, -1] + hi
        return torch.stack([even, odd], 2).reshape(s.shape[0], -1)

    if sub_v == 1:
        out = along_x(c, 1, 2, 4) >> 2
    else:
        up = torch.cat([c[:1], c[:-1]], 0)
        down = torch.cat([c[1:], c[-1:]], 0)
        rows = [along_x(3 * c + far, lo, lo - 1, 4) >> 4
                for far, lo in ((up, 8), (down, 8))]
        out = torch.stack(rows, 1).reshape(2 * c.shape[0], -1)
    return out[:h, :w]


def ycc_to_rgb_reference(y: torch.Tensor, cb: torch.Tensor,
                         cr: torch.Tensor) -> torch.Tensor:
    """Plain version of the colour conversion: Y (H, W) and Cb, Cr planes
    at their sampling, uint8, to (H, W, 3) uint8 RGB as libjpeg-turbo
    decodes (jdcolor.c ycc_rgb_convert: Cr=>R nearest 1.40200 Cr, Cb=>B
    nearest 1.77200 Cb, G = Y + floor((-22554 Cb - 46802 Cr + 2^15) /
    2^16), clamped)."""
    h, w = y.shape
    luma = y.to(torch.int32)
    b_ = _upsample_reference(cb, h, w) - 128
    r_ = _upsample_reference(cr, h, w) - 128
    rgb = torch.stack([luma + ((91881 * r_ + 32768) >> 16),
                       luma + ((-22554 * b_ + 32768 - 46802 * r_) >> 16),
                       luma + ((116130 * b_ + 32768) >> 16)], -1)
    return rgb.clamp(0, 255).to(torch.uint8)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor,
               cr: torch.Tensor) -> torch.Tensor:
    """Y (H, W) and Cb, Cr (sampled 4:4:4, 4:2:2 or 4:2:0) uint8 planes
    to (H, W, 3) uint8 RGB, chroma upsampled and converted as libjpeg-turbo
    does: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors, equal bit for bit."""
    if y.device.type == "cpu":
        return ycc_to_rgb_reference(y, cb, cr)
    what = "ycc_to_rgb"
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.device != y.device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, y on "
                             f"{y.device}")
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise TypeError(f"{what}: {name} must be a contiguous 2-D "
                            f"uint8 plane, got {t.dtype} {tuple(t.shape)}")
    if cb.shape != cr.shape:
        raise ValueError(f"{what}: Cb {tuple(cb.shape)} != Cr "
                         f"{tuple(cr.shape)}")
    h, w = y.shape
    if not 1 <= h <= 65535 or w < 1:
        raise ValueError(f"{what}: a {h}x{w} image")
    sub_h, sub_v = _sampling(cb, h, w)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    _launch(what, "jpeg", "sparknet_ycc_to_rgb", y.device, y.data_ptr(), w,
            cb.data_ptr(), cr.data_ptr(), cb.shape[1], h, w, cb.shape[0],
            cb.shape[1], sub_h, sub_v, out.data_ptr(), 3 * w)
    return out

def _resize_taps(n_in: int, n_out: int):
    """Source indices (lower, upper) and the upper tap's weight of each
    output index along one axis, in float32 as the native pipeline forms
    them: the scale (n_in - 1) / (n_out - 1) divided in float32, its
    product with the index truncated."""
    f32 = torch.float32
    scale = (np.float32(n_in - 1) / np.float32(n_out - 1)
             if n_in > 1 and n_out > 1 else np.float32(0))
    f = torch.arange(n_out, dtype=f32) * torch.tensor(scale, dtype=f32)
    i0 = f.to(torch.int64)
    i1 = torch.where(i0 + 1 < n_in, i0 + 1, i0)
    return i0, i1, f - i0.to(f32)


def resize_bilinear_reference(src: torch.Tensor, out_h: int, out_w: int,
                              gray: bool = False) -> torch.Tensor:
    """Plain version of the resize: ``src`` (H, W, 3) uint8, interleaved
    RGB, to planar float32 (3, out_h, out_w), aligned corners, each value
    ``(1-wy)*((1-wx)*p00 + wx*p01) + wy*((1-wx)*p10 + wx*p11)`` in float32
    in that order (sparknet_tpu/native/data_pipeline.cpp:248-272).  With
    ``gray``, (1, out_h, out_w): ((R + G) + B) / 3 of those, numpy's
    float32 mean over the channel axis."""
    y0, y1, wy = (t.to(src.device) for t in _resize_taps(src.shape[0],
                                                           out_h))
    x0, x1, wx = (t.to(src.device) for t in _resize_taps(src.shape[1],
                                                           out_w))
    p = src.permute(2, 0, 1).to(torch.float32)
    r0, r1 = p[:, y0], p[:, y1]
    wy, wx = wy[:, None], wx[None, :]
    v = ((1 - wy) * ((1 - wx) * r0[:, :, x0] + wx * r0[:, :, x1])
         + wy * ((1 - wx) * r1[:, :, x0] + wx * r1[:, :, x1]))
    if gray:
        # divided by a tensor: a CUDA tensor divided by a Python number is
        # multiplied by its reciprocal, which rounds otherwise
        return ((v[0] + v[1] + v[2]) / torch.full_like(v[0], 3.0))[None]
    return v


def resize_bilinear(src: torch.Tensor, out_h: int, out_w: int,
                    gray: bool = False) -> torch.Tensor:
    """Force-resize an interleaved RGB image, (H, W, 3) uint8 with rows
    ``src.stride(0)`` bytes apart, to planar float32 (3, out_h, out_w),
    or (1, out_h, out_w) gray: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors, equal bit for bit."""
    if src.device.type == "cpu":
        return resize_bilinear_reference(src, out_h, out_w, gray)
    what = "resize_bilinear"
    if src.device.type != "cuda":
        raise ValueError(f"{what}: wants a CPU or CUDA tensor, got one on "
                         f"{src.device}")
    if src.dtype != torch.uint8 or src.dim() != 3 or src.shape[2] != 3:
        raise TypeError(f"{what}: wants an (H, W, 3) uint8 image, got "
                        f"{src.dtype} {tuple(src.shape)}")
    if src.stride(2) != 1 or src.stride(1) != 3:
        raise ValueError(f"{what}: wants interleaved rows (strides (pitch, "
                         f"3, 1)), got {src.stride()}")
    h, w = src.shape[0], src.shape[1]
    if min(h, w, out_h, out_w) < 1 or out_h > 65535:
        raise ValueError(f"{what}: a {h}x{w} image to {out_h}x{out_w}")
    out = torch.empty((1 if gray else 3, out_h, out_w), dtype=torch.float32,
                      device=src.device)
    _launch(what, "jpeg", "sparknet_resize_bilinear", src.device,
            src.data_ptr(), h, w, src.stride(0), out.data_ptr(), out_h,
            out_w, int(gray))
    return out
