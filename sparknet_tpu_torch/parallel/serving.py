"""Serving plane: dynamic micro-batched inference with admission control.

The port's counterpart of ``sparknet_tpu/parallel/serving.py``:

- :class:`InferenceEngine` — a thread-safe request queue with dynamic
  micro-batching: pending requests for one model coalesce until the oldest
  request's deadline (``SPARKNET_SERVE_MAX_DELAY_MS``) expires or the
  largest batch shape fills, whichever is first.  The batch is padded to
  one of a small, fixed set of batch shapes (``SPARKNET_SERVE_SHAPES``);
  pad rows are zeros and their outputs are masked off at demux.  Row ``i``
  of a per-example net depends only on input row ``i``, so a request
  batched with strangers gets bit-identical probabilities to a solo run
  padded to the same shape.
- :class:`ModelHouse` — load zoo models by name, LRU-evicted under a
  device-memory budget (``SPARKNET_SERVE_HBM_MB``).  Loading runs every
  batch shape once as warm-up, off the request path; ``submit`` to an
  unloaded model is a typed error.
- Admission control — a bounded queue (typed :class:`Overloaded`) and
  per-tenant QPS token buckets.
- :func:`run_closed_loop` / :func:`solo_references` — the closed-loop load
  harness and the bit-identity oracle.

Two threads own the hot path.  The dispatcher pads a batch, copies it to
the card, launches the forward and the copy of its result into pinned
host memory, and records a CUDA event — all without waiting.  The
harvester waits on the event and demuxes rows to their waiters.
``cfg.inflight_batches`` bounds the window between them.  Grad mode is
thread-local in PyTorch, so the forward enters ``torch.inference_mode``
on the thread that runs it.

f32 serving means full f32: an f32 model's forwards run inside
``utils.device.full_f32``, which clears the TF32 flags of cuDNN
convolutions and of matmuls for the length of the forward's enqueue and
then restores them (bf16 models leave the flags alone).

``ModelHouse.load(name, weights=path)`` serves a ``.caffemodel`` (or npz)
in place of the seeded weights.  Not ported yet: the SLO monitor, health
beacons, the telemetry registry, fault injection, registry versions, and
the HTTP shell (``tools/serve.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..convert import params_from_jax
from ..graph.net import Net
from ..models import (alexnet, caffenet, cifar10_full, cifar10_quick,
                      googlenet, lenet, vgg16)
from ..models.dsl import softmax_layer
from ..proto.caffe_pb import BlobShape, NetParameter, NetState, Phase
from ..utils import knobs
from ..utils.device import full_f32, resolve_device


# ---------------------------------------------------------------------------
# Typed errors — admission and liveness failures are API, not stack traces
# ---------------------------------------------------------------------------

class ServingError(RuntimeError):
    """Base class for serving-plane failures."""


class Overloaded(ServingError):
    """Typed admission rejection.  ``reason`` is ``"queue_full"`` or
    ``"tenant_rate"``."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"overloaded ({reason})"
                         + (f": {detail}" if detail else ""))


class EngineDead(ServingError):
    """The engine stopped or a worker thread died: every pending waiter and
    every later submit gets this — never a hang."""


class UnknownModel(ServingError):
    """Submit against a model the house has not loaded (loading warms up
    every batch shape, which belongs off the request path)."""


class OverBudget(ServingError):
    """The model alone exceeds the house's device-memory budget, so no LRU
    eviction could make it fit.  Raised before any warm-up; override with
    ``ModelHouse.load(..., force=True)`` or
    ``SPARKNET_SERVE_FORCE_ADMIT=1``."""

    def __init__(self, name: str, param_mb: float, budget_mb: float):
        self.model = name
        self.param_mb = param_mb
        self.budget_mb = budget_mb
        super().__init__(
            f"model {name!r} needs {param_mb:.1f} MB of params but the "
            f"budget is {budget_mb:g} MB — it could never fit; load with "
            f"force=True (or SPARKNET_SERVE_FORCE_ADMIT=1) to admit it "
            f"anyway")


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

def _env_float(name: str, default: float) -> float:
    raw = knobs.raw(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None


def _env_quotas(name: str) -> dict[str, float]:
    """``SPARKNET_SERVE_QUOTAS=acme=200,beta=50`` -> {tenant: qps}."""
    quotas: dict[str, float] = {}
    for item in knobs.raw(name, "").split(","):
        item = item.strip()
        if not item:
            continue
        tenant, _, qps = item.partition("=")
        try:
            quotas[tenant] = float(qps)
        except ValueError:
            raise ValueError(
                f"{name} wants tenant=qps pairs, got {item!r}") from None
    return quotas


def _env_shapes(name: str, default: tuple[int, ...]) -> tuple[int, ...]:
    raw = knobs.raw(name, "")
    if not raw:
        return default
    try:
        shapes = tuple(sorted({int(s) for s in raw.split(",") if s.strip()}))
    except ValueError:
        raise ValueError(
            f"{name} must be comma-separated ints, got {raw!r}") from None
    if not shapes or shapes[0] < 1:
        raise ValueError(f"{name} needs positive batch shapes, got {raw!r}")
    return shapes


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine + model-house configuration (env defaults)."""

    batch_shapes: tuple[int, ...] = dataclasses.field(
        default_factory=lambda: _env_shapes("SPARKNET_SERVE_SHAPES",
                                            (1, 4, 16, 64)))
    max_delay_ms: float = dataclasses.field(
        default_factory=lambda: _env_float("SPARKNET_SERVE_MAX_DELAY_MS",
                                           5.0))
    max_queue: int = dataclasses.field(
        default_factory=lambda: int(_env_float("SPARKNET_SERVE_QUEUE", 256)))
    # dispatched-but-not-demuxed batch window: >1 pipelines host pad/demux
    # under device compute
    inflight_batches: int = dataclasses.field(
        default_factory=lambda: int(_env_float("SPARKNET_SERVE_INFLIGHT",
                                               2)))
    hbm_budget_mb: float = dataclasses.field(
        default_factory=lambda: _env_float("SPARKNET_SERVE_HBM_MB", 2048.0))
    dtype: str = dataclasses.field(
        default_factory=lambda: knobs.raw("SPARKNET_SERVE_DTYPE", "bf16"))
    # per-tenant offered-QPS caps (absent tenant = uncapped, "*" caps every
    # tenant without an explicit entry)
    tenant_qps: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: _env_quotas("SPARKNET_SERVE_QUOTAS"))
    seed: int = 0

    def __post_init__(self):
        shapes = tuple(sorted(set(int(s) for s in self.batch_shapes)))
        if not shapes or shapes[0] < 1:
            raise ValueError(f"batch_shapes must be positive: {shapes}")
        object.__setattr__(self, "batch_shapes", shapes)
        if self.max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, "
                             f"got {self.max_delay_ms}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.inflight_batches < 1:
            raise ValueError(f"inflight_batches must be >= 1, "
                             f"got {self.inflight_batches}")
        if self.dtype not in ("bf16", "f32"):
            raise ValueError(f"dtype must be bf16 or f32, got {self.dtype!r}")
        for t, q in dict(self.tenant_qps).items():
            if q <= 0:
                raise ValueError(f"tenant {t!r}: qps cap must be > 0")


# ---------------------------------------------------------------------------
# Deploy-net transform + zoo registry
# ---------------------------------------------------------------------------

# data-source layer types (their tops come from the host, not the graph)
_DATA_TYPES = frozenset({
    "JavaData", "MemoryData", "Data", "DummyData", "HDF5Data", "ImageData",
    "WindowData", "Input",
})


def zoo_models() -> dict[str, Callable[[], NetParameter]]:
    """Name -> NetParameter factory for every servable zoo model."""
    return {
        "lenet": lambda: lenet(1, 1),
        "cifar10_quick": lambda: cifar10_quick(1, 1),
        "cifar10_full": lambda: cifar10_full(1, 1),
        "alexnet": lambda: alexnet(1, 1),
        "caffenet": lambda: caffenet(1, 1),
        "googlenet": lambda: googlenet(1, 1, crop=224),
        "vgg16": lambda: vgg16(1, 1, crop=224),
    }


def deploy_from(net_param: NetParameter,
                max_batch: int) -> tuple[NetParameter, tuple[int, ...]]:
    """Train/test zoo NetParameter -> (deploy NetParameter, per-example
    input shape): data layers, loss layers and Accuracy dropped, a trailing
    Softmax ``prob`` head added on the last TEST-phase loss layer's logits,
    and a net-level ``input: "data"`` declared at ``max_batch``.  Layer
    names are untouched, so weights carry over by name."""
    test_state = NetState(Phase.TEST)
    kept, data_layers = [], []
    logits = None
    for lp in net_param.layer:
        if not lp.included_in(test_state) or lp.type == "Accuracy":
            continue
        if lp.type in _DATA_TYPES:
            data_layers.append(lp)
        elif lp.type.endswith("Loss"):
            # the last surviving loss names the deploy head's logits
            if lp.bottom:
                logits = lp.bottom[0]
        else:
            kept.append(lp)
    # the data blob's shape, from shape inference over the data layers alone
    probe = Net(dataclasses.replace(net_param, layer=data_layers), test_state)
    if "data" not in probe.input_blobs:
        raise ValueError(f"net {net_param.name!r} has no 'data' input blob")
    in_shape = tuple(probe.input_blobs["data"][1:])
    if logits is None:
        raise ValueError(
            f"net {net_param.name!r}: no loss layer to derive the deploy "
            f"head from")
    if not (kept and kept[-1].type == "Softmax" and logits in kept[-1].top):
        kept = kept + [softmax_layer("prob", logits, "prob")]
    return NetParameter(
        name=f"{net_param.name}_deploy", layer=kept, input=["data"],
        input_shape=[BlobShape(dim=[int(max_batch), *in_shape])]), in_shape


class LoadedModel:
    """One servable model: deploy net + params on ``device``, with every
    serving batch shape run once at load as warm-up (the request path
    never meets a first call).  ``weights`` is a weight file to serve in
    place of the seeded draw (a ``.caffemodel``, V1 zoo files included, or
    an npz; ``solvers.solver.load_weights_into``): its layers that the
    deploy net lacks (train weights: GoogLeNet's auxiliary heads, the
    loss) are ignored by name, as Net::CopyTrainedLayersFrom does, and a
    layer it shares must match in blob count and shape.  ``params`` are
    in-memory weights (``convert.params_from_jax``; ``drop_extra`` lets
    them carry layers the deploy net lacks)."""

    def __init__(self, name: str, net_param: NetParameter, cfg: ServeConfig,
                 *, device: str | torch.device = "cuda",
                 weights: str | None = None,
                 params: Mapping[str, Sequence[Any]] | None = None,
                 drop_extra: bool = False,
                 max_param_mb: float | None = None):
        if weights and params is not None:
            raise ValueError("pass weights (a file) or params, not both")
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        deploy, self.in_shape = deploy_from(net_param, cfg.batch_shapes[-1])
        self.name = name
        self.dtype = cfg.dtype
        self.batch_shapes = cfg.batch_shapes
        compute = torch.bfloat16 if cfg.dtype == "bf16" else None
        self.net = Net(deploy, NetState(Phase.TEST), compute_dtype=compute)
        if params is None:
            self.params = self.net.init(
                torch.Generator().manual_seed(cfg.seed), device=self.device)
            if weights:
                from ..solvers.solver import load_weights_into
                self.params = load_weights_into(self.net, self.params,
                                                weights)
        else:
            self.params = params_from_jax(params, self.net,
                                          device=self.device,
                                          drop_extra=drop_extra)
        self.weights = weights
        self.param_bytes = sum(b.numel() * b.element_size()
                               for blobs in self.params.values()
                               for b in blobs)
        # budget verdict BEFORE warm-up
        if max_param_mb is not None and self.param_bytes > max_param_mb \
                * 2**20:
            raise OverBudget(name, self.param_bytes / 2**20, max_param_mb)
        # the forward's copy of the f32 masters in the compute dtype, made
        # once (the per-layer cast of a cast blob is a no-op)
        self._fwd_params = self.params if compute is None else {
            k: Net._cast(v, compute) for k, v in self.params.items()}
        self._out_blob = self.net.output_blobs[-1]
        self.classes = int(self.net.blob_shapes[self._out_blob][-1])
        for s in self.batch_shapes:
            self.infer(np.zeros((s,) + self.in_shape, np.float32))
        big = self.batch_shapes[-1]
        self.flops_per_image = self.net.forward_flops() / big
        self.warmup_s = round(time.perf_counter() - t0, 3)
        self.last_used = time.monotonic()

    def precision(self):
        """The scope this model's forwards run in: full f32 (TF32 off)
        for an f32 model, nothing for bf16."""
        return full_f32() if self.dtype == "f32" else contextlib.nullcontext()

    def pad_shape(self, n: int) -> int:
        """Smallest batch shape holding ``n`` requests."""
        for s in self.batch_shapes:
            if s >= n:
                return s
        return self.batch_shapes[-1]

    def infer_async(self, batch: np.ndarray):
        """Launch the forward on an already-padded batch and return a handle
        for :meth:`harvest` without waiting: on the card, the result's copy
        into pinned host memory is queued behind the forward and a CUDA
        event marks its end."""
        with torch.inference_mode():
            x = torch.from_numpy(batch)
            if self.device.type == "cuda":
                x = x.pin_memory().to(self.device, non_blocking=True)
            with self.precision():
                out = self.net.apply(self._fwd_params, {"data": x},
                                     blobs=[self._out_blob])[self._out_blob]
            # f32 rows whatever the compute dtype: the cast is exact and
            # deterministic, so the bit-identity contract survives it
            out = out.float()
            if self.device.type != "cuda":
                return out, None
            host = torch.empty(out.shape, dtype=torch.float32,
                               pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            return host, done

    @staticmethod
    def harvest(handle) -> np.ndarray:
        """Wait for an :meth:`infer_async` handle -> (S, classes) f32."""
        host, done = handle
        if done is not None:
            done.synchronize()
        return host.numpy()

    def infer(self, batch: np.ndarray) -> np.ndarray:
        """One forward on an already-padded batch -> (S, classes) f32
        probabilities (synchronous convenience)."""
        return self.harvest(self.infer_async(batch))

    def info(self) -> dict[str, Any]:
        return {"name": self.name, "in_shape": list(self.in_shape),
                "classes": self.classes, "dtype": self.dtype,
                "device": str(self.device),
                "param_mb": round(self.param_bytes / 2**20, 3),
                "batch_shapes": list(self.batch_shapes),
                "flops_per_image": self.flops_per_image,
                "warmup_s": self.warmup_s, "weights": self.weights}


class ModelHouse:
    """Load/evict zoo models by name under a device-memory budget.

    ``load`` builds and warms up OUTSIDE the lock (loading model B must not
    stall serving model A), then admits it and LRU-evicts until the budget
    holds again (the newly loaded model is never the victim).  A model
    larger than the whole budget is a typed :class:`OverBudget` at load
    time unless forced, in which case it is admitted alone."""

    def __init__(self, cfg: ServeConfig, *,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._models: "OrderedDict[str, LoadedModel]" = OrderedDict()
        self.evictions = 0

    def load(self, name: str, weights: str | None = None,
             force: bool | None = None) -> LoadedModel:
        """Load zoo model ``name`` (with the weights of file ``weights``,
        else the seeded draw), or return it if it is loaded with the same
        ``weights``; another ``weights`` reloads it."""
        with self._lock:
            hit = self._models.get(name)
            if hit is not None and hit.weights == weights:
                self._models.move_to_end(name)
                return hit
        zoo = zoo_models()
        if name not in zoo:
            raise UnknownModel(
                f"model {name!r} not in the zoo (known: {sorted(zoo)})")
        if force is None:
            force = knobs.raw("SPARKNET_SERVE_FORCE_ADMIT") == "1"
        lm = LoadedModel(name, zoo[name](), self.cfg, device=self.device,
                         weights=weights, max_param_mb=None if force
                         else self.cfg.hbm_budget_mb)
        with self._lock:
            self._models[name] = lm
            self._models.move_to_end(name)
            self._evict_over_budget(keep=name)
        return lm

    def _evict_over_budget(self, keep: str) -> None:
        budget = self.cfg.hbm_budget_mb * 2**20
        while (sum(m.param_bytes for m in self._models.values()) > budget
               and len(self._models) > 1):
            victim = next(iter(self._models))
            if victim == keep:
                self._models.move_to_end(victim)
                continue
            self._models.pop(victim)
            self.evictions += 1

    def get(self, name: str) -> LoadedModel:
        """The loaded model, LRU-touched — typed UnknownModel when absent
        (loading never happens implicitly on this path)."""
        with self._lock:
            lm = self._models.get(name)
            if lm is None:
                raise UnknownModel(
                    f"model {name!r} is not loaded "
                    f"(loaded: {sorted(self._models) or '[]'}); load it "
                    f"first — warm-up stays off the request path")
            self._models.move_to_end(name)
            lm.last_used = time.monotonic()
            return lm

    def evict(self, name: str) -> bool:
        with self._lock:
            return self._models.pop(name, None) is not None

    def loaded(self) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {n: m.info() for n, m in self._models.items()}


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

class TokenBucket:
    """Per-tenant QPS cap: ``rate`` tokens/s, burst of ``max(1, rate)``.
    Callers hold the engine lock."""

    def __init__(self, rate: float, clock: Callable[[], float]):
        self.rate = float(rate)
        self.burst = max(1.0, self.rate)
        self._tokens = self.burst
        self._clock = clock
        self._last = clock()

    def allow(self) -> bool:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False


# ---------------------------------------------------------------------------
# Requests, futures, results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeResult:
    """One demultiplexed prediction with its latency stamps."""

    model: str
    probs: np.ndarray          # (classes,) float32
    tenant: str
    request_id: int
    queue_ms: float            # submit -> batch dispatch
    infer_ms: float            # dispatch -> results on host
    total_ms: float            # submit -> demux
    batch_n: int               # real requests in the coalesced batch
    padded_to: int             # batch shape the batch ran at


class _Request:
    __slots__ = ("id", "model", "x", "tenant", "t_submit", "event",
                 "result", "error")

    def __init__(self, rid: int, model: str, x: np.ndarray, tenant: str,
                 t_submit: float):
        self.id = rid
        self.model = model
        self.x = x
        self.tenant = tenant
        self.t_submit = t_submit
        self.event = threading.Event()
        self.result: ServeResult | None = None
        self.error: BaseException | None = None


class ServeFuture:
    """Handle for one in-flight request.  ``result()`` polls in bounded
    slices and re-checks engine liveness each wake, so a dead engine is a
    typed :class:`EngineDead` within ~2 polls — never a hang."""

    _POLL_S = 0.1

    def __init__(self, engine: "InferenceEngine", req: _Request):
        self._engine = engine
        self._req = req

    def done(self) -> bool:
        return self._req.event.is_set()

    def result(self, timeout: float | None = None) -> ServeResult:
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._req.event.wait(self._POLL_S):
            if not self._engine.alive:
                raise EngineDead(
                    f"engine died while request #{self._req.id} "
                    f"({self._req.model}) was pending: "
                    f"{self._engine.death_note}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"request #{self._req.id} ({self._req.model}) not "
                    f"served within {timeout:.1f}s")
        if self._req.error is not None:
            raise self._req.error
        if self._req.result is None:
            raise ServingError(f"request #{self._req.id} completed empty")
        return self._req.result


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

_HARVEST_STOP = object()


class InferenceEngine:
    """Thread-safe dynamic micro-batching over a :class:`ModelHouse`.

    The **dispatcher** collects the ripest model queue (a full
    largest-shape batch, or the oldest request past the coalesce deadline),
    pads to the smallest batch shape and launches the forward without
    waiting; the **harvester** waits for each launched batch and demuxes
    rows back to their waiters with latency stamps.  ``submit`` applies
    admission control synchronously; rejected work raises
    :class:`Overloaded` and never occupies queue space."""

    def __init__(self, models: ModelHouse, cfg: ServeConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.models = models
        self.cfg = cfg or models.cfg
        self._clock = clock
        self._cond = threading.Condition()
        self._queues: dict[str, deque[_Request]] = {}
        self._depth = 0
        self._next_id = 0
        self._stopping = False
        self._dead = False
        self.death_note = ""
        self._in_flight = 0
        self._batches_in_flight = 0
        self._buckets: dict[str, TokenBucket] = {}
        # counters (guarded by _cond's lock)
        self.completed = 0
        self.failed = 0
        self.rejected = {"queue_full": 0, "tenant_rate": 0}
        self.dispatches = 0
        self._lat_ms: deque[float] = deque(maxlen=4096)
        self._queue_ms: deque[float] = deque(maxlen=4096)
        # per batch shape: dispatch-to-host latency of each batch
        self._batch_ms: dict[int, deque[float]] = {}
        # occupancy["<padded shape>"][<real n>] = batches dispatched
        self.occupancy: dict[str, dict[int, int]] = {}
        self._t_start = time.monotonic()
        self._harvest_q: "queue.Queue[Any]" = queue.Queue(
            maxsize=self.cfg.inflight_batches)
        self._harvester = threading.Thread(
            target=self._harvest_loop, name="serve-harvest", daemon=True)
        self._harvester.start()
        self._dispatcher = threading.Thread(
            target=self._loop, name="serve-dispatch", daemon=True)
        self._dispatcher.start()

    # -- liveness ---------------------------------------------------------
    @property
    def alive(self) -> bool:
        return not (self._dead or self._stopping)

    def _mark_dead(self, note: str) -> None:
        with self._cond:
            self._dead = True
            self.death_note = note
            pending = [r for dq in self._queues.values() for r in dq]
            for dq in self._queues.values():
                dq.clear()
            self._depth = 0
            self._cond.notify_all()
        # batches already dispatched into the harvest window: their
        # waiters must not hang on a dead harvester
        while True:
            try:
                item = self._harvest_q.get_nowait()
            except queue.Empty:
                break
            if item is not _HARVEST_STOP:
                pending.extend(item[1])
        try:
            self._harvest_q.put_nowait(_HARVEST_STOP)
        except queue.Full:
            pass
        for r in pending:
            r.error = EngineDead(f"engine died with request pending: {note}")
            r.event.set()

    # -- submission (admission control happens HERE) ----------------------
    def submit(self, model: str, x, tenant: str = "anon") -> ServeFuture:
        """Enqueue one example for ``model``; returns a future.  Raises
        Overloaded / UnknownModel / EngineDead synchronously — admission
        failures never consume queue space."""
        if not self.alive:
            raise EngineDead(f"engine is not serving: "
                             f"{self.death_note or 'stopped'}")
        lm = self.models.get(model)          # typed UnknownModel if absent
        x = np.ascontiguousarray(x, np.float32)
        if x.shape != lm.in_shape:
            raise ServingError(
                f"model {model!r} expects input {lm.in_shape}, "
                f"got {x.shape}")
        with self._cond:
            cap = self.cfg.tenant_qps.get(tenant,
                                          self.cfg.tenant_qps.get("*"))
            if cap is not None:
                bucket = self._buckets.get(tenant)
                if bucket is None or bucket.rate != float(cap):
                    bucket = self._buckets[tenant] = TokenBucket(
                        cap, self._clock)
                if not bucket.allow():
                    self.rejected["tenant_rate"] += 1
                    raise Overloaded(
                        "tenant_rate",
                        f"tenant {tenant!r} over its {cap:g} qps cap")
            # the bound covers OUTSTANDING work (queued + dispatched, not
            # answered): max_queue / throughput bounds accepted latency
            if self._depth + self._in_flight >= self.cfg.max_queue:
                self.rejected["queue_full"] += 1
                raise Overloaded(
                    "queue_full",
                    f"{self._depth} queued + {self._in_flight} in flight "
                    f"(bound {self.cfg.max_queue})")
            req = _Request(self._next_id, model, x, tenant, self._clock())
            self._next_id += 1
            self._queues.setdefault(model, deque()).append(req)
            self._depth += 1
            self._cond.notify_all()
        return ServeFuture(self, req)

    def classify(self, model: str, x, tenant: str = "anon",
                 timeout: float | None = 30.0) -> ServeResult:
        """Blocking convenience: submit + wait."""
        return self.submit(model, x, tenant).result(timeout)

    # -- dispatcher -------------------------------------------------------
    def _loop(self) -> None:
        try:
            while True:
                work = self._collect()
                if work is None:
                    break                        # clean stop
                self._dispatch(*work)
            # graceful stop: let the harvester drain dispatched batches
            # (their waiters get real results), then exit on the sentinel
            while True:
                try:
                    self._harvest_q.put(_HARVEST_STOP, timeout=0.1)
                    return
                except queue.Full:
                    if self._dead:
                        return
        except BaseException as e:  # dispatcher death -> typed, never a hang
            self._mark_dead(f"dispatcher died: {e!r}")

    def _collect(self):
        """Block until a model queue is ripe: the largest batch shape fills,
        or the oldest request crosses the coalesce deadline.  Returns
        (model, requests), or None when stopping."""
        max_shape = self.cfg.batch_shapes[-1]
        delay_s = self.cfg.max_delay_ms / 1000.0
        with self._cond:
            while True:
                if self._stopping or self._dead:
                    return None
                now = self._clock()
                ripe = None
                next_deadline = None
                for name, dq in self._queues.items():
                    if not dq:
                        continue
                    deadline = dq[0].t_submit + delay_s
                    if len(dq) >= max_shape or deadline <= now:
                        ripe = name
                        break
                    if next_deadline is None or deadline < next_deadline:
                        next_deadline = deadline
                if ripe is not None:
                    dq = self._queues[ripe]
                    take = min(len(dq), max_shape)
                    reqs = [dq.popleft() for _ in range(take)]
                    self._depth -= take
                    self._in_flight += take
                    self._cond.notify_all()
                    return ripe, reqs
                self._cond.wait(0.05 if next_deadline is None
                                else max(next_deadline - now, 1e-4))

    def _fail_batch(self, reqs: list[_Request], model: str,
                    cause: Exception) -> None:
        """A model failure fails THIS batch's requests (typed) and leaves
        the engine alive."""
        err = ServingError(
            f"batch of {len(reqs)} on {model!r} failed: {cause}")
        err.__cause__ = cause
        with self._cond:
            self.failed += len(reqs)
            self._in_flight -= len(reqs)
        for r in reqs:
            r.error = err
            r.event.set()

    def _dispatch(self, model: str, reqs: list[_Request]) -> None:
        """Pad and launch one coalesced batch into the harvest window
        (backpressured at ``cfg.inflight_batches``)."""
        n = len(reqs)
        t_dispatch = self._clock()
        try:
            lm = self.models.get(model)
            shape = lm.pad_shape(n)
            batch = np.zeros((shape,) + lm.in_shape, np.float32)
            for i, r in enumerate(reqs):
                batch[i] = r.x
            # pad rows computed, masked at demux
            handle = lm.infer_async(batch)
        except Exception as e:
            self._fail_batch(reqs, model, e)
            return
        with self._cond:
            self._batches_in_flight += 1
        item = (model, reqs, shape, t_dispatch, lm, handle)
        while True:
            try:
                self._harvest_q.put(item, timeout=0.1)
                return
            except queue.Full:
                if self._dead:       # harvester died; _mark_dead drains
                    return

    def _harvest_loop(self) -> None:
        try:
            while True:
                item = self._harvest_q.get()
                if item is _HARVEST_STOP:
                    return
                self._finish(*item)
        except BaseException as e:  # harvester death -> typed, never a hang
            self._mark_dead(f"harvester died: {e!r}")

    def _finish(self, model: str, reqs: list[_Request], shape: int,
                t_dispatch: float, lm: LoadedModel, handle) -> None:
        """Wait for one launched batch, then demux rows to waiters."""
        n = len(reqs)
        try:
            probs = lm.harvest(handle)
            t_done = self._clock()
        except Exception as e:
            with self._cond:
                self._batches_in_flight -= 1
            self._fail_batch(reqs, model, e)
            return
        if not np.isfinite(probs[:n]).all():
            # non-finite rows must never reach a caller: fail the batch typed
            with self._cond:
                self._batches_in_flight -= 1
            self._fail_batch(reqs, model, ServingError(
                f"model {model!r} produced non-finite probabilities — "
                f"refusing to serve them"))
            return
        infer_ms = (t_done - t_dispatch) * 1e3
        results = [ServeResult(
            model=model, probs=probs[i], tenant=r.tenant, request_id=r.id,
            queue_ms=round((t_dispatch - r.t_submit) * 1e3, 3),
            infer_ms=round(infer_ms, 3),
            total_ms=round((t_done - r.t_submit) * 1e3, 3),
            batch_n=n, padded_to=shape) for i, r in enumerate(reqs)]
        with self._cond:
            self.dispatches += 1
            self.completed += n
            self._in_flight -= n
            self._batches_in_flight -= 1
            by_n = self.occupancy.setdefault(str(shape), {})
            by_n[n] = by_n.get(n, 0) + 1
            self._batch_ms.setdefault(shape, deque(maxlen=4096)).append(
                infer_ms)
            for res in results:
                self._lat_ms.append(res.total_ms)
                self._queue_ms.append(res.queue_ms)
        for r, res in zip(reqs, results):
            r.result = res
            r.event.set()

    # -- stats ------------------------------------------------------------
    @staticmethod
    def _percentiles(samples: Sequence[float]) -> dict[str, float]:
        if not samples:
            return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
        p50, p95, p99 = np.percentile(np.asarray(samples, np.float64),
                                      [50, 95, 99])
        return {"p50_ms": round(float(p50), 3),
                "p95_ms": round(float(p95), 3),
                "p99_ms": round(float(p99), 3)}

    def stats(self) -> dict[str, Any]:
        with self._cond:
            out = {
                "alive": self.alive,
                "uptime_s": round(time.monotonic() - self._t_start, 1),
                "queue_depth": self._depth,
                "in_flight": self._in_flight,
                "in_flight_batches": self._batches_in_flight,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": dict(self.rejected),
                "dispatches": self.dispatches,
                "occupancy": {s: dict(v)
                              for s, v in self.occupancy.items()},
                **self._percentiles(self._lat_ms),
                "queue_p50_ms": self._percentiles(
                    self._queue_ms)["p50_ms"],
                # dispatch-to-host latency of each batch, by batch shape
                "batch_ms": {str(s): {"batches": len(v),
                                      **self._percentiles(v)}
                             for s, v in sorted(self._batch_ms.items())},
                "batch_shapes": list(self.cfg.batch_shapes),
                "max_delay_ms": self.cfg.max_delay_ms,
                "max_queue": self.cfg.max_queue,
            }
        out["models"] = self.models.loaded()
        return out

    # -- shutdown ---------------------------------------------------------
    def stop(self) -> None:
        """Stop serving: queued waiters get typed EngineDead, dispatched
        batches drain; idempotent."""
        with self._cond:
            if self._stopping:
                return
            self._stopping = True
            pending = [r for dq in self._queues.values() for r in dq]
            for dq in self._queues.values():
                dq.clear()
            self._depth = 0
            self.death_note = self.death_note or "engine stopped"
            self._cond.notify_all()
        for r in pending:
            r.error = EngineDead("engine stopped with request queued")
            r.event.set()
        self._dispatcher.join(timeout=10.0)
        self._harvester.join(timeout=10.0)

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Closed-loop load harness
# ---------------------------------------------------------------------------

def solo_references(lm: LoadedModel, inputs: Sequence[np.ndarray]
                    ) -> dict[int, dict[int, np.ndarray]]:
    """Per batch shape, the SOLO result row for every input: input i padded
    with zero rows to each batch shape, row 0 kept.  The oracle for the
    bit-identity check — a request that rides a batch of strangers at
    shape s must equal refs[s][i] exactly."""
    refs: dict[int, dict[int, np.ndarray]] = {}
    for s in lm.batch_shapes:
        by_idx = {}
        for i, x in enumerate(inputs):
            batch = np.zeros((s,) + lm.in_shape, np.float32)
            batch[0] = np.asarray(x, np.float32)
            by_idx[i] = lm.infer(batch)[0].copy()
        refs[s] = by_idx
    return refs


def run_closed_loop(engine: InferenceEngine, model: str,
                    inputs: Sequence[np.ndarray], *,
                    clients: int = 4, window: int = 1,
                    duration_s: float = 2.0,
                    offered_qps: float | None = None,
                    tenant: str = "loadgen",
                    timeout_s: float = 30.0,
                    refs: Mapping[int, Mapping[int, np.ndarray]] | None
                    = None) -> dict[str, Any]:
    """Drive ``clients`` closed-loop workers for ``duration_s``, each
    keeping up to ``window`` requests outstanding (total concurrency =
    clients x window).

    ``offered_qps=None`` saturates (each client resubmits the moment its
    window has room); with a rate, client j schedules arrival k at
    ``t0 + (j + k*clients)/qps`` and sleeps to it (offered > capacity shows
    up as ``rejected``).  ``refs`` (from :func:`solo_references`) turns on
    the exactness audit: every completed request is compared bit for bit
    against its solo reference at the shape it actually rode."""
    t0 = time.monotonic()
    t_end = t0 + duration_s
    lat_ms: list[list[float]] = [[] for _ in range(clients)]
    done = [0] * clients
    rejected = [0] * clients
    errors = [0] * clients
    mismatches = [0] * clients

    def client(j: int) -> None:
        pend: "deque[tuple[float, int, ServeFuture]]" = deque()

        def harvest_one() -> None:
            t_s, idx, fut = pend.popleft()
            try:
                res = fut.result(timeout_s)
            except (ServingError, TimeoutError):
                errors[j] += 1
                return
            lat_ms[j].append((time.monotonic() - t_s) * 1e3)
            done[j] += 1
            if refs is not None:
                ref = refs.get(res.padded_to, {}).get(idx)
                if ref is None or not np.array_equal(res.probs, ref):
                    mismatches[j] += 1

        k = 0
        while True:
            now = time.monotonic()
            if now >= t_end:
                break
            if len(pend) >= window:
                harvest_one()
                continue
            if offered_qps:
                t_arrive = t0 + (j + k * clients) / offered_qps
                if t_arrive >= t_end:
                    break
                if t_arrive > now:
                    if pend and pend[0][2].done():
                        harvest_one()
                    else:
                        time.sleep(min(t_arrive - now, 0.02))
                    continue
            idx = (j + k * clients) % len(inputs)
            k += 1
            t_s = time.monotonic()
            try:
                pend.append((t_s, idx, engine.submit(model, inputs[idx],
                                                     tenant=tenant)))
            except Overloaded:
                if offered_qps:
                    rejected[j] += 1     # paced: the rejection IS the datum
                else:
                    # unpaced saturation: wait for outstanding work instead
                    # of burning the loop on rejections
                    k -= 1
                    if pend:
                        harvest_one()
                    else:
                        time.sleep(0.001)
            except (ServingError, TimeoutError):
                errors[j] += 1
        while pend:   # drain the window; completions past t_end count
            harvest_one()

    threads = [threading.Thread(target=client, args=(j,), daemon=True)
               for j in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + timeout_s + 10.0)
    wall = time.monotonic() - t0
    all_lat = sorted(x for lst in lat_ms for x in lst)
    pct = (lambda q: round(float(np.percentile(all_lat, q)), 3)
           if all_lat else 0.0)
    completed = sum(done)
    return {
        "offered_qps": round(offered_qps, 1) if offered_qps else None,
        "achieved_qps": round(completed / wall, 1),
        "clients": clients,
        "window": window,
        "duration_s": round(wall, 2),
        "completed": completed,
        "rejected": sum(rejected),
        "errors": sum(errors),
        "exact_mismatches": sum(mismatches) if refs is not None else None,
        "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
        "max_ms": round(all_lat[-1], 3) if all_lat else 0.0,
        "mean_ms": round(float(np.mean(all_lat)), 3) if all_lat else 0.0,
    }
