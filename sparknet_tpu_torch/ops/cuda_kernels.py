"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Each kernel is CUDA C++ for Hopper (``sm_90a``) under ``ops/csrc/`` with a
plain C interface.  It is built with ``nvcc`` from the checkout's sources
at first use, into ``sparknet_tpu_torch/_build/``, and loaded with
``ctypes``.  Each wrapper:

- on a CPU tensor, returns its kernel's plain PyTorch version;
- on a CUDA tensor, checks device, dtype, shape and contiguity, allocates
  the outputs, launches the kernel on the current stream and raises if
  the launch fails.  It never falls back to the plain version;
- adds one to its entry in :data:`launch_counts` for each launch.

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
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# kernel library name -> its source under csrc/ (each includes common.cuh)
SOURCES = {"lrn": "lrn.cu", "lrn_bwd": "lrn_bwd.cu",
           "maxpool_bwd": "maxpool_bwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> {C function: argtypes}; every function returns the
# launch's cudaError_t as an int
_SIGNATURES = {
    "lrn": {
        "sparknet_lrn_across_channels":
            [_P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P],
        "sparknet_lrn_across_channels_fwd":
            [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _I, _P],
    },
    "lrn_bwd": {
        "sparknet_lrn_across_channels_bwd":
            [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P],
    },
    "maxpool_bwd": {
        "sparknet_max_pool_bwd":
            [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _I,
             _I, _I, _I, _I, _P],
    },
}

# wrapper name -> kernel launches since the last reset
launch_counts: dict[str, int] = {
    "lrn_across_channels": 0, "lrn_across_channels_fwd": 0,
    "lrn_across_channels_bwd": 0, "max_pool_bwd": 0}

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
    and the flags, so an edited source never loads a stale library."""
    digest = hashlib.sha256((_CSRC / SOURCES[name]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
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
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])],
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
    if x.shape[0] > 65535:
        raise ValueError(f"{what}: batch {x.shape[0]} exceeds the kernel's "
                         f"grid limit of 65535")


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
    _launch("lrn_across_channels", "lrn", "sparknet_lrn_across_channels",
            x.device, x.data_ptr(), y.data_ptr(), n, c, h * w, size,
            alpha / size, beta, k, int(relu), int(x.dtype == torch.bfloat16))
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
    _launch("lrn_across_channels_fwd", "lrn",
            "sparknet_lrn_across_channels_fwd", x.device, x.data_ptr(),
            y.data_ptr(), scale.data_ptr(), n, c, h * w, size, alpha / size,
            beta, k, int(relu), int(x.dtype == torch.bfloat16))
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
    _launch(what, "lrn_bwd", "sparknet_lrn_across_channels_bwd", x.device,
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), n,
            c, h * w, size, 2.0 * alpha * beta / size, beta, int(relu),
            int(x.dtype == torch.bfloat16))
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
    # each window's argmax position, the kernel's first pass
    argpos = torch.empty(n * c * oh * ow, dtype=torch.int32, device=x.device)
    _launch(what, "maxpool_bwd", "sparknet_max_pool_bwd", x.device,
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), argpos.data_ptr(),
            n * c, h, w, kh, kw, sh, sw, ph, pw, oh, ow,
            int(x.dtype == torch.bfloat16))
    return dx
