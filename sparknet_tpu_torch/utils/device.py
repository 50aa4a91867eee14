"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``.  Without a CUDA device they raise
instead of carrying on on the CPU; the CPU runs only when the caller asks
for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run on the CPU explicitly")
    return dev
