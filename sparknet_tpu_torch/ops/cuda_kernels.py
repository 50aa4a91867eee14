"""The port's hand-written CUDA kernels, their wrappers and plain versions.

Each kernel is CUDA C++ for Hopper (``sm_90a``) under ``ops/csrc/`` with a
plain C interface.  It is built with ``nvcc`` from the checkout's sources
at first use, into ``sparknet_tpu_torch/_build/``, and loaded with
``ctypes``.  Each wrapper:

- on a CPU tensor, returns its kernel's plain PyTorch version;
- on a CUDA tensor, checks device, dtype, shape and contiguity, allocates
  the output, launches the kernel on the current stream and raises if the
  launch fails.  It never falls back to the plain version;
- adds one to its entry in :data:`launch_counts` for each launch.

Kernels:

``lrn_across_channels`` (``csrc/lrn.cu``) replaces the TPU kernel
``_lrn_infer_kernel`` of ``sparknet_tpu/ops/pallas_kernels.py:72-80``,
reached through ``relu_lrn_across_channels`` (:128-149): Caffe's
ACROSS_CHANNELS LRN forward without the ``scale`` residual, with an
optional ReLU in front.
"""

from __future__ import annotations

import ctypes
import hashlib
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

# kernel library name -> its source under csrc/
SOURCES = {"lrn": "lrn.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v"]

# wrapper name -> kernel launches since the last reset
launch_counts: dict[str, int] = {"lrn_across_channels": 0}

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
    """Build output, named by the source's content hash so an edited
    source never loads a stale library."""
    digest = hashlib.sha256((_CSRC / SOURCES[name]).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


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
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent build never loads half
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    return report


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _build_lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            if name == "lrn":
                fn = lib.sparknet_lrn_across_channels
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_float, ctypes.c_float,
                               ctypes.c_float, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


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


# ---------------------------------------------------------------------------
# lrn_across_channels
# ---------------------------------------------------------------------------

def lrn_across_channels_reference(x: torch.Tensor, size: int, alpha: float,
                                  beta: float, k: float,
                                  relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 math, the window summed by
    shifted adds in ascending channel order, cast back to the I/O dtype."""
    a = x.float()
    if relu:
        a = torch.relu(a)
    pre = (size - 1) // 2
    post = size - 1 - pre
    c = x.shape[1]
    padded = F.pad(a * a, (0, 0, 0, 0, pre, post))
    ssum = padded[:, 0:c]
    for d in range(1, size):
        ssum = ssum + padded[:, d:d + c]
    scale = k + (alpha / size) * ssum
    return (a * scale.pow(-beta)).to(x.dtype)


def lrn_across_channels(x: torch.Tensor, size: int, alpha: float,
                        beta: float, k: float,
                        relu: bool = False) -> torch.Tensor:
    """Caffe ACROSS_CHANNELS LRN of an (N, C, H, W) tensor, f32 or bf16,
    with ``relu`` folding a zero-slope ReLU in front: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return lrn_across_channels_reference(x, size, alpha, beta, k, relu)
    _check_cuda_input(x, "lrn_across_channels")
    if size < 1:
        raise ValueError(f"lrn_across_channels: local_size must be >= 1, "
                         f"got {size}")
    n, c, h, w = x.shape
    if n > 65535:
        raise ValueError(f"lrn_across_channels: batch {n} exceeds the "
                         f"kernel's grid limit of 65535")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _library("lrn").sparknet_lrn_across_channels
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), n, c, h * w, size, alpha / size,
                beta, k, int(relu), int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"lrn_across_channels: kernel launch failed with "
                           f"CUDA error {rc}")
    launch_counts["lrn_across_channels"] += 1
    return y
