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
counts differ by that gap (``PERF.md`` §6 states it).  :func:`server`
is the counterpart of the JAX profiler's remote server: an HTTP thread
that records ``torch.profiler`` captures on demand (``GET
/capture?ms=N``) and refuses one while another profiler records.
:func:`record_fusion_plan` and :func:`record_tuning` stamp a capture
with the net's fusion plan and lowering table.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import tempfile
import threading
import time
from typing import Callable, Iterator

import torch

# ``torch.profiler.profile`` objects recording now, by id, in any thread:
# Kineto runs one session a process, and a second one started from
# another thread kills the process, so :func:`server` checks this set
# (and claims its place in it) under the lock before it starts one.
_sessions_lock = threading.Lock()
_sessions: set[int] = set()
# set while a server capture records every thread: :func:`layer_scope`
# opens its ranges on threads whose own profiler flag is off
_capturing = threading.Event()


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block: CPU activity, and CUDA activity when
    a card is present; yields the profiler (``trace_tables.op_tables``
    reads its events) and writes ``trace_<pid>.json`` (a Chrome trace)
    into ``log_dir`` at exit.  A :func:`server` capture asked for while
    the block runs is refused."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    with _sessions_lock:
        _sessions.add(id(prof))
    try:
        with prof:
            yield prof
    finally:
        with _sessions_lock:
            _sessions.discard(id(prof))
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
    """``annotate(f"L[{name}]")`` while a profiler records on this
    thread or a :func:`server` capture records every thread, else a
    shared no-op: a layer's forward costs nothing extra outside a
    trace."""
    if torch._C._autograd._profiler_enabled() or _capturing.is_set():
        return annotate(f"L[{name}]")
    return contextlib.nullcontext()


class ProfilerBusy(RuntimeError):
    """A capture asked for while another profiler records (HTTP 409)."""


CAPTURE_MS_MAX = 60_000


def _count_profiler_sessions() -> None:
    """Make every ``torch.profiler.profile`` started from now on enter
    :data:`_sessions` while it records, whoever starts it (idempotent;
    stays for the life of the process)."""
    cls = torch.profiler.profile
    if getattr(cls.start, "_sparknet_counted", False):
        return
    start, stop = cls.start, cls.stop

    def counted_start(self):
        with _sessions_lock:
            _sessions.add(id(self))
        try:
            start(self)
        except BaseException:
            with _sessions_lock:
                _sessions.discard(id(self))
            raise

    def counted_stop(self):
        try:
            stop(self)
        finally:
            with _sessions_lock:
                _sessions.discard(id(self))

    counted_start._sparknet_counted = True
    cls.start, cls.stop = counted_start, counted_stop


def _all_threads_config():
    """Kineto's config that records the CPU ranges of every thread, not
    only the capturing one; None where this torch lacks it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


def capture_trace(ms: float) -> dict:
    """Record ``torch.profiler`` (CPU and, on the card, CUDA activity)
    for ``ms`` milliseconds over whatever the process runs, and return
    the Chrome trace.  Raises :class:`ProfilerBusy` while another
    profiler records anywhere in the process.

    What a capture sees: every kernel the card runs in the window (CUPTI
    records the device, whichever thread launched), and, where this torch
    has Kineto's ``profile_all_threads``, the ATen ops and
    ``record_function`` ranges of every thread, the serving thread's
    ``L[layer]`` scopes among them (``otherData.all_threads`` says
    which).  Without it only the capturing thread's own ranges appear,
    and that thread only sleeps.  Ranges opened before the window are
    not in it."""
    if not 0 < ms <= CAPTURE_MS_MAX:
        raise ValueError(f"capture ms must be in (0, {CAPTURE_MS_MAX}], "
                         f"got {ms}")
    config = _all_threads_config()
    kw = {"experimental_config": config} if config is not None else {}
    prof = torch.profiler.profile(activities=_activities(), **kw)
    with _sessions_lock:
        if _sessions or torch._C._autograd._profiler_enabled():
            raise ProfilerBusy(f"another profiler records "
                               f"({len(_sessions)} session(s))")
        _sessions.add(id(prof))
    try:
        with prof:
            if config is not None:
                _capturing.set()
            try:
                time.sleep(ms / 1e3)
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            finally:
                _capturing.clear()
        with tempfile.TemporaryDirectory(prefix="capture_") as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
    finally:
        with _sessions_lock:
            _sessions.discard(id(prof))
    doc.setdefault("otherData", {})["all_threads"] = config is not None
    doc["otherData"]["capture_ms"] = ms
    return doc


class ProfilerServer:
    """The HTTP thread :func:`server` runs; ``url`` is where it listens."""

    def __init__(self, host: str, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, urlparse

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, code: int, body: dict) -> None:
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path != "/capture":
                    self._json(404, {"error": "NotFound",
                                     "detail": f"no route {url.path}"})
                    return
                try:
                    ms = float(parse_qs(url.query).get("ms", ["100"])[0])
                    self._json(200, capture_trace(ms))
                except ProfilerBusy as e:
                    self._json(409, {"error": "ProfilerBusy",
                                     "detail": str(e)})
                except ValueError as e:
                    self._json(400, {"error": "BadRequest",
                                     "detail": str(e)})

        _count_profiler_sessions()
        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="profiler-server", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10.0)


@contextlib.contextmanager
def server(port: int = 9999, host: str = "127.0.0.1"
           ) -> Iterator[ProfilerServer]:
    """Live profiling server (the JAX package's ``profiling.server``):
    an HTTP thread on ``host:port`` (0 picks a free port) for the life
    of the block.  ``GET /capture?ms=N`` answers with the Chrome trace of
    :func:`capture_trace` over N ms of whatever the process runs; a
    capture while a profiler already records (another capture,
    :func:`trace`, ``tools/profile_step.py``, any ``torch.profiler``
    started since a server first came up) answers 409 with ``{"error":
    "ProfilerBusy"}``.  :func:`fetch_capture` is the client."""
    srv = ProfilerServer(host, port)
    try:
        yield srv
    finally:
        srv.close()


def fetch_capture(url: str, ms: float, timeout: float = 120.0) -> dict:
    """``GET {url}/capture?ms=N``: the trace, or :class:`ProfilerBusy`
    on a 409."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"{url}/capture?ms={ms}",
                                    timeout=timeout) as resp:
            return json.load(resp)
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")
        if e.code == 409:
            raise ProfilerBusy(body) from None
        raise RuntimeError(f"capture failed: HTTP {e.code} {body}") from None


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
