"""Device memory observability.

The port's copy of ``device_memory_summary`` from
``sparknet_tpu/utils/profiling.py`` (:45), on ``torch.cuda.mem_get_info``
and ``torch.cuda.memory_stats``; ``caffe_cli device_query`` prints it.
The rest of that module (trace annotations, the profiler server, the
bench helpers) belongs to ROADMAP A13.
"""

from __future__ import annotations

import torch


def device_memory_summary() -> list[dict]:
    """One row per CUDA device: its name, the bytes PyTorch's allocator
    holds in tensors now and at its peak, the card's free bytes and its
    total (``bytes_limit``).  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no device to query")
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i}",
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_free": free,
            "bytes_limit": total,
        })
    return out
