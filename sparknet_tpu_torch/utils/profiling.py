"""Tracing, device memory and the bench's shared pieces.

The port's counterpart of ``sparknet_tpu/utils/profiling.py``:

- :func:`trace` captures a ``torch.profiler`` trace (CPU and, on the
  card, CUDA activity) of the enclosed block and writes it as a Chrome
  trace; ``utils/trace_tables.py`` turns the profile into per-op and
  per-layer tables.  :func:`annotate` names a region inside a trace
  (``record_function``, plus an NVTX range on the card);
  :func:`layer_scope` is the ``L[<layer>]`` range ``graph/net.py`` puts
  around each layer while a profiler runs, the convention the JAX
  package's named scopes follow (``utils/xplane.py:26``).
- :func:`device_memory_summary` and :func:`save_memory_profile` (the
  caching allocator's snapshot).
- The benchmark harness pieces shared by ``bench.py`` and
  ``tools/profile_step.py``, so the profiled program is the benchmarked
  one: :data:`BENCH_SOLVER_PROTOTXT`, :func:`build_bench_model`, the
  FLOP counts (:func:`step_cost_flops`, :func:`fwd_cost_flops`,
  :func:`eval_cost_flops`), :func:`peak_flops` and the blocks
  (:func:`train_block`, :func:`eval_block`).

The JAX package counts FLOPs with XLA's ``cost_analysis``, which also
counts elementwise work and the update; here they are counted from the
net's geometry (convolution and inner-product multiply-adds), so the two
counts differ by that gap (``PERF.md`` §6 states it).  The JAX
profiler's remote ``server`` has no torch counterpart (ROADMAP A13).
:func:`record_fusion_plan` and :func:`record_tuning` stamp a capture
with the net's fusion plan and lowering table.
"""

from __future__ import annotations

import contextlib
import os
import pickle
from typing import Callable, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block: CPU activity, and CUDA activity when
    a card is present; yields the profiler (``trace_tables.op_tables``
    reads its events) and writes ``trace_<pid>.json`` (a Chrome trace)
    into ``log_dir`` at exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


class annotate(contextlib.ContextDecorator):
    """A named region inside a trace, usable as a decorator or a context
    manager: a ``record_function`` range for ``torch.profiler`` and, once
    CUDA is initialised, an NVTX range for tools that read those."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


def layer_scope(name: str):
    """``annotate(f"L[{name}]")`` while a profiler records, else a shared
    no-op: a layer's forward costs nothing extra outside a trace."""
    if torch._C._autograd._profiler_enabled():
        return annotate(f"L[{name}]")
    return contextlib.nullcontext()


def card_line(device: torch.device | None = None) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (``NVIDIA H100 80GB HBM3, 700.00 W``), or the name alone with
    "power limit not read" where nvidia-smi does not answer."""
    import subprocess
    index = (device.index if device is not None
             and device.index is not None else 0)
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return (out[0].strip() if out else
            f"{torch.cuda.get_device_name(index)}, power limit not read")


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


def save_memory_profile(path: str) -> None:
    """Write the CUDA caching allocator's snapshot (segments, blocks and,
    when memory history is being recorded, the allocation traces) as a
    pickle, the format PyTorch's memory visualiser reads.  Raises without
    a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no device memory")
    with open(path, "wb") as f:
        pickle.dump(torch.cuda.memory._snapshot(), f)


# ---------------------------------------------------------------------------
# Benchmark-harness pieces shared by bench.py and tools/profile_step.py
# ---------------------------------------------------------------------------

BENCH_SOLVER_PROTOTXT = (
    'base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
    'lr_policy: "step"\ngamma: 0.1\nstepsize: 100000\n')


def build_bench_model(name: str, batch: int):
    """(net_param, input_shape, num_classes) for a benchmark model name."""
    from ..models import caffenet, googlenet, lenet, vgg16
    if name == "lenet":
        return lenet(batch, batch), (1, 28, 28), 10
    if name == "googlenet":
        return googlenet(batch, batch, crop=224), (3, 224, 224), 1000
    if name == "vgg16":
        return vgg16(batch, batch, crop=224), (3, 224, 224), 1000
    if name == "caffenet":
        return caffenet(batch, batch), (3, 227, 227), 1000
    raise ValueError(f"unknown bench model {name!r}")


def record_fusion_plan(net, out_dir: str | None = None) -> str:
    """The net's vertical-fusion plan id (``"off"`` when nothing fuses,
    the perf-ledger fingerprint field) and, given a capture's
    ``out_dir``, its plan written there as ``fusion_plan.json``, so that
    ``SPARKNET_FUSE=<that file>`` replays the chains the capture ran
    (the JAX package's ``record_fusion_plan``).  Shared by ``bench.py``
    and ``tools/profile_step.py``."""
    if out_dir is not None and net._fuse_plan is not None:
        net._fuse_plan.save(os.path.join(out_dir, "fusion_plan.json"))
    return net.fuse_plan_id()


def record_tuning(net, out_dir: str | None = None) -> str:
    """The net's lowering-table id (``"off"`` when none) and, given a
    capture's ``out_dir``, the table it latched copied there as
    ``tuning.json``, so ``SPARKNET_TUNE=<that file>`` replays the
    lowerings the capture ran."""
    if out_dir is not None and net._tune_table is not None:
        net._tune_table.save(os.path.join(out_dir, "tuning.json"))
    return net.tune_plan_id()


def fwd_cost_flops(net) -> float:
    """Model FLOPs of one forward of ``net`` at its declared shapes (the
    multiply-adds of its convolutions and inner products)."""
    return float(net.forward_flops())


def eval_cost_flops(solver) -> float:
    """Model FLOPs of one test-net forward (the eval-pass numerator)."""
    return fwd_cost_flops(solver.test_net)


def grad_blobs(net) -> set[str]:
    """The blobs of ``net`` that depend on a param: autograd computes an
    input gradient for a layer only where its bottom is one of them."""
    needs_grad: set[str] = set()
    shapes = net.param_shapes()
    for node in net.nodes:
        if (node.lp.name in shapes or node.shared_refs
                or any(b in needs_grad for b in node.bottoms)):
            needs_grad.update(node.tops)
    return needs_grad


def step_cost_flops(solver) -> float:
    """Model FLOPs of one train step of ``solver`` (all ``iter_size``
    micro-batches): each convolution and inner product's forward, its weight gradient
    (the same multiply-adds) and its input gradient (the same again),
    except where the input is a blob no param shapes: below a data blob
    autograd computes no input gradient.  The update's and the
    elementwise layers' work is not counted."""
    net = solver.train_net
    needs_grad = grad_blobs(net)
    total = 0
    for node, f in net.layer_flops():
        total += 2 * f + (f if node.bottoms[0] in needs_grad else 0)
    return float(total * max(solver.sp.iter_size, 1))


# dense peak FLOP/s by card name and compute dtype: NVIDIA's H100 SXM5
# data sheet, at the 700 W limit (bf16 on the tensor cores; f32 outside
# them, TF32 off as the port's f32 steps run)
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "f32": 67e12},
}


def peak_flops(device_name: str, dtype: str = "bf16") -> float | None:
    """Peak FLOP/s of the card named ``device_name``
    (``torch.cuda.get_device_name``) for ``dtype`` ("bf16" or "f32"), or
    None for a card (or the CPU) the table does not know."""
    return _PEAK_FLOPS.get(device_name, {}).get(dtype)


def train_block(solver, iters: int) -> Callable[[], torch.Tensor]:
    """The benchmark block: ``run()`` takes ``iters`` Solver steps on the
    solver's train feed (resident data in the bench) as a plain loop and
    returns the last step's loss, a device scalar it never reads: the
    host does not wait on the card inside a block.  A step is the
    Solver's own (``solvers/step.py``'s update under its precision); the
    display, snapshot and signal polling of ``Solver.step`` are not run.
    Stands in for the JAX package's ``scanned_train_block``."""
    if solver._train_iter is None:
        raise RuntimeError("no train data set; call set_train_data first")

    def run() -> torch.Tensor:
        loss = None
        for _ in range(iters):
            batches = solver._next_batches()
            with solver._precision():
                solver.params, solver.state, loss = solver._local_update(
                    solver.params, solver.state, solver.iter, batches,
                    solver.generator)
            solver.iter += 1
        return loss

    return run


def eval_block(solver, iters: int,
               batch: dict[str, torch.Tensor]) -> Callable[[], torch.Tensor]:
    """Forward-only analog of :func:`train_block`: ``run()`` takes
    ``iters`` test-net forwards on ``batch`` with the solver's params
    (no gradient: the inference kernels) and returns the last forward's
    loss, unread.  Stands in for ``scanned_eval_block``."""
    net = solver.test_net
    extra = solver._test_extras[0]

    def run() -> torch.Tensor:
        out = None
        params = {**extra, **solver.params} if extra else solver.params
        with torch.no_grad(), solver._precision():
            for _ in range(iters):
                out = net.forward(params, batch, train=False,
                                  generator=solver.test_generator,
                                  device=solver.device).loss
        return out

    return run
