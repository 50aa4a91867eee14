"""Device resolution and f32 precision for the port's entry points.

Entry points default to ``"cuda"``.  Without a CUDA device they raise
instead of carrying on on the CPU; the CPU runs only when the caller asks
for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run on the CPU explicitly")
    return dev


def device_label(dev: torch.device) -> str:
    """``cuda/<card name>`` or ``cpu/cpu``: the device a result names
    (the bench line's spelling)."""
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"{dev.type}/{kind}"


@contextlib.contextmanager
def deterministic_cudnn() -> Iterator[None]:
    """cuDNN's deterministic algorithms inside the scope: a bit-parity
    check asks two runs of the same steps for the same bits, which the
    default algorithms do not promise on the card (no effect on the
    CPU)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


# PyTorch's two TF32 flags are process-wide, not per thread, so the scopes
# that clear them are counted: the first to enter saves and clears them,
# the last to leave restores them, whatever threads the scopes run on.
_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved: tuple[bool, bool] = (False, False)


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Run f32 convolutions and matmuls in full f32 inside the scope, as
    the JAX package's CPU path does: cuDNN runs f32 convolutions in TF32
    by default (``torch.backends.cudnn.allow_tf32``), and TF32 keeps
    about three decimal digits.  Clears both TF32 flags on entry and
    restores them when the last open scope exits.  Work enqueued inside
    the scope, its autograd backward included, is enqueued in full f32;
    while any scope is open, every thread of the process sees the flags
    cleared."""
    global _tf32_depth, _tf32_saved
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = (torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = _tf32_saved
