"""Unified telemetry plane: metrics registry, span tracer, flight recorder.

The port's own copy of ``sparknet_tpu/utils/telemetry.py``: the same
metric names, label keys, span names and ``cat``s, and the same file
formats, so one folding tool reads the snapshots and trace shards of
both packages.  The seams that publish into it are the feed's stage
timings (``data/pipeline.py::FeedStats``), the prefetch watchdog
(``data/prefetch.py``), the checkpoint writer (``utils/checkpoint.py``),
the trainer's rounds, harvests and checkpoint submits
(``parallel/trainer.py``), the serving engine's batches
(``parallel/serving.py``) and SIGTERM (``utils/signals.py``).

- :class:`MetricsRegistry` — process-local counters / gauges /
  histograms with labels, one lock per metric, rendered as Prometheus
  text exposition and as JSON file snapshots for headless training jobs
  (``SPARKNET_METRICS_SNAP=dir``: written atomically, throttled, plus a
  final write at exit; :func:`fold_snapshots` folds them).
- **Span tracer** — Chrome-trace-event JSONL shards (one per process),
  enabled by ``SPARKNET_TRACE_DIR=dir``.  Timestamps are epoch
  microseconds, so shards from different processes of one run align.
  Every event carries the correlation IDs: ``run`` (SPARKNET_RUN_ID,
  else derived once per process), ``job`` (SPARKNET_FLEET_JOB), ``inc``
  (SPARKNET_INCARNATION), ``rank`` (SPARKNET_PROC_ID), ``attempt``
  (SPARKNET_FAULT_ATTEMPT).  A span is host wall time: the seams open
  and close spans only where the host already waits for the card or
  not at all, so tracing adds no synchronisation.
- :class:`FlightRecorder` — a bounded ring of recent structured events
  (``SPARKNET_FLIGHT_EVENTS``, default 256).  The seams record guard
  trips, resumes, feeder restarts and SIGTERM receipt; ``dump()`` writes
  the tail as JSON next to the trace shards at the moment something
  went wrong.

**Off switch:** ``SPARKNET_TELEMETRY=0`` makes the whole plane a no-op:
``get_registry()`` returns a null registry whose metrics are shared
singletons with pass methods, ``span()`` returns a shared null context
manager, and the recorder drops events — nothing is allocated per
round and no file is ever written.  Tracing additionally requires
``SPARKNET_TRACE_DIR`` even when telemetry is on, so the default
steady-state cost is a few counter increments per round.

Env knobs (declared in ``utils/knobs.py``):
  SPARKNET_TELEMETRY      — "0" disables the whole plane (default on).
  SPARKNET_TRACE_DIR      — write trace_*.jsonl shards + flight dumps here.
  SPARKNET_METRICS_SNAP   — write metrics_rank*.json/.prom snapshots here.
  SPARKNET_METRICS_SNAP_S — min seconds between snapshots (default 2).
  SPARKNET_FLIGHT_EVENTS  — flight-recorder ring size (default 256).
  SPARKNET_RUN_ID         — correlation run id (default: derived).
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time
import weakref
from typing import Any, Callable, Iterable, Mapping

from . import knobs

ENV_ENABLE = "SPARKNET_TELEMETRY"
ENV_TRACE_DIR = "SPARKNET_TRACE_DIR"
ENV_SNAP_DIR = "SPARKNET_METRICS_SNAP"
ENV_SNAP_S = "SPARKNET_METRICS_SNAP_S"
ENV_FLIGHT = "SPARKNET_FLIGHT_EVENTS"
ENV_RUN_ID = "SPARKNET_RUN_ID"

# default latency buckets (seconds): sub-ms serving demux through
# multi-second checkpoint writes
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def enabled() -> bool:
    """Whether the telemetry plane is on (``SPARKNET_TELEMETRY=0`` is
    the global off switch)."""
    return knobs.raw(ENV_ENABLE, "") != "0"


_DERIVED_RUN: str | None = None


def correlation_ids() -> dict[str, Any]:
    """The IDs that join one process's telemetry into the distributed
    story: run / fleet job / incarnation / rank / attempt.  Read from
    the env contract the launcher + fleet already maintain; ``run`` is
    derived once per process when SPARKNET_RUN_ID is absent, so even an
    un-launched local run correlates with itself.  A process that is
    NOT under the launcher (so must not set SPARKNET_PROC_ID — the
    cluster env contract validates the full triple) can still claim a
    distinct shard rank via SPARKNET_TELEMETRY_RANK, which wins."""
    global _DERIVED_RUN
    run = knobs.raw(ENV_RUN_ID)
    if not run:
        if _DERIVED_RUN is None:
            _DERIVED_RUN = f"run-{int(time.time()):x}-{os.getpid()}"
        run = _DERIVED_RUN
    out: dict[str, Any] = {
        "run": run,
        "rank": int(knobs.raw("SPARKNET_TELEMETRY_RANK")
                    or knobs.raw("SPARKNET_PROC_ID", "0") or 0),
        "inc": knobs.get_int("SPARKNET_INCARNATION", 0),
        "attempt": knobs.get_int("SPARKNET_FAULT_ATTEMPT", 0),
    }
    job = knobs.raw("SPARKNET_FLEET_JOB")
    if job:
        out["job"] = job
    return out


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def _label_key(labels: Mapping[str, Any]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _render_labels(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """Base: one named metric with per-labelset children, one lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    # subclasses: _samples() -> iterable of (labelkey, payload)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def _samples(self):
        with self._lock:
            return list(self._values.items())


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def _samples(self):
        with self._lock:
            return list(self._values.items())


class Histogram(_Metric):
    """Prometheus-style cumulative-bucket histogram."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] | None = None):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        # labelkey -> [per-bucket counts..., +Inf count], sum
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * (len(self.buckets) + 1)
                self._sums[key] = 0.0
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[key] += value

    class _Timer:
        __slots__ = ("_h", "_labels", "_t0")

        def __init__(self, h, labels):
            self._h, self._labels = h, labels

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._h.observe(time.perf_counter() - self._t0, **self._labels)

    def time(self, **labels) -> "Histogram._Timer":
        return self._Timer(self, labels)

    def _samples(self):
        with self._lock:
            return [(k, (list(c), self._sums[k], sum(c)))
                    for k, c in self._counts.items()]


class _NullMetric:
    """Shared no-op stand-in for every metric kind: inc/set/observe all
    swallow their arguments, ``time()`` returns the shared null context
    manager — nothing is allocated, nothing is retained."""

    kind = "null"
    name = "null"

    def inc(self, *a, **kw) -> None:
        pass

    def dec(self, *a, **kw) -> None:
        pass

    def set(self, *a, **kw) -> None:
        pass

    def observe(self, *a, **kw) -> None:
        pass

    def value(self, *a, **kw) -> float:
        return 0.0

    def time(self, **kw):
        return NULL_SPAN


class MetricsRegistry:
    """Name -> metric, idempotent by name (re-asking for an existing
    metric returns the same object; a kind mismatch raises — two seams
    silently sharing one name as different types is a bug)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []   # weak refs to scrape-time fillers
        self._last_snap = 0.0

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"asked for {cls.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] | None = None) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Register a scrape-time filler (called before render/snapshot
        to set point-in-time gauges).  Bound methods are held weakly so
        a dead owner silently unregisters."""
        try:
            ref = weakref.WeakMethod(fn)  # type: ignore[arg-type]
        except TypeError:
            ref = lambda f=fn: f          # plain function: strong, stable
        with self._lock:
            self._collectors.append(ref)

    def _collect(self) -> None:
        with self._lock:
            refs = list(self._collectors)
        live = []
        for ref in refs:
            fn = ref()
            if fn is None:
                continue
            live.append(ref)
            try:
                fn()
            except Exception:
                pass   # a broken collector must not break the scrape
        with self._lock:
            self._collectors = live

    # -- export -----------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4)."""
        self._collect()
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: list[str] = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, (counts, total, n) in m._samples():
                    cum = 0
                    for b, c in zip(m.buckets, counts):
                        cum += c
                        le = 'le="%g"' % b
                        lines.append(
                            f"{name}_bucket{_render_labels(key, le)} {cum}")
                    cum += counts[-1]
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{_render_labels(key, inf)} {cum}")
                    lines.append(f"{name}_sum{_render_labels(key)} {total:g}")
                    lines.append(f"{name}_count{_render_labels(key)} {n}")
            else:
                for key, v in m._samples():
                    lines.append(f"{name}{_render_labels(key)} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> dict[str, Any]:
        """JSON-able view of every metric (the file-snapshot payload)."""
        self._collect()
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: dict[str, Any] = {}
        for name, m in metrics:
            if isinstance(m, Histogram):
                samples = [{"labels": dict(k), "buckets": list(m.buckets),
                            "counts": c, "sum": s, "count": n}
                           for k, (c, s, n) in m._samples()]
            else:
                samples = [{"labels": dict(k), "value": v}
                           for k, v in m._samples()]
            out[name] = {"kind": m.kind, "help": m.help, "samples": samples}
        return out

    def write_snapshot(self, directory: str | None = None) -> str | None:
        """Atomically write ``metrics_rank<R>.json`` (+ ``.prom`` text)
        into ``directory`` (default ``SPARKNET_METRICS_SNAP``); returns
        the json path, or None when no directory is configured."""
        directory = directory or knobs.raw(ENV_SNAP_DIR)
        if not directory:
            return None
        os.makedirs(directory, exist_ok=True)
        corr = correlation_ids()
        doc = {"t": round(time.time(), 3), **corr, "pid": os.getpid(),
               "metrics": self.snapshot()}
        path = os.path.join(directory, f"metrics_rank{corr['rank']}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        ppath = os.path.join(directory, f"metrics_rank{corr['rank']}.prom")
        tmp = f"{ppath}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.render())
        os.replace(tmp, ppath)
        return path

    def maybe_snapshot(self) -> str | None:
        """Throttled :meth:`write_snapshot` — at most one write per
        ``SPARKNET_METRICS_SNAP_S`` seconds (default 2); a no-op when
        ``SPARKNET_METRICS_SNAP`` is unset.  The hot-loop-safe hook the
        trainer calls each round."""
        if not knobs.is_set(ENV_SNAP_DIR):
            return None
        try:
            min_s = float(knobs.raw(ENV_SNAP_S, "") or 2.0)
        except ValueError:
            min_s = 2.0
        now = time.monotonic()
        with self._lock:
            if now - self._last_snap < min_s:
                return None
            self._last_snap = now
        return self.write_snapshot()


class _NullRegistry:
    """The SPARKNET_TELEMETRY=0 registry: every ask returns the shared
    null metric, every export is empty, nothing is ever written."""

    def counter(self, name: str, help: str = "") -> _NullMetric:
        return NULL_METRIC

    def gauge(self, name: str, help: str = "") -> _NullMetric:
        return NULL_METRIC

    def histogram(self, name: str, help: str = "", buckets=None
                  ) -> _NullMetric:
        return NULL_METRIC

    def add_collector(self, fn) -> None:
        pass

    def render(self) -> str:
        return ""

    def snapshot(self) -> dict:
        return {}

    def write_snapshot(self, directory: str | None = None) -> None:
        return None

    def maybe_snapshot(self) -> None:
        return None


# ---------------------------------------------------------------------------
# Span tracer (Chrome trace events, JSONL shards)
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op context manager — the disabled-tracing span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()
NULL_METRIC = _NullMetric()


class Tracer:
    """Buffered Chrome-trace-event writer: one JSONL shard per process
    (``trace_<run>_rank<R>_<pid>.jsonl``), events flushed every
    ``flush_every`` events and at exit.  Thread-safe; timestamps are
    epoch microseconds so independent ranks merge clock-aligned."""

    def __init__(self, directory: str, flush_every: int = 256):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.corr = correlation_ids()
        safe_run = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in str(self.corr["run"]))[:48]
        self.path = os.path.join(
            directory,
            f"trace_{safe_run}_rank{self.corr['rank']}_{os.getpid()}.jsonl")
        self._lock = threading.Lock()
        self._buf: list[str] = []
        self._flush_every = max(int(flush_every), 1)
        label = f"rank{self.corr['rank']}"
        if self.corr.get("job"):
            label += f" {self.corr['job']}"
        if self.corr.get("inc"):
            label += f" inc{self.corr['inc']}"
        self.emit({"name": "process_name", "ph": "M", "pid": os.getpid(),
                   "tid": 0, "args": {"name": label}})

    def emit(self, event: dict) -> None:
        line = json.dumps(event, default=str)
        with self._lock:
            self._buf.append(line)
            if len(self._buf) < self._flush_every:
                return
            buf, self._buf = self._buf, []
        self._write(buf)

    def _write(self, lines: list[str]) -> None:
        try:
            with open(self.path, "a") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            pass   # an unwritable trace dir must never kill the workload

    def flush(self) -> None:
        with self._lock:
            buf, self._buf = self._buf, []
        if buf:
            self._write(buf)

    def complete(self, name: str, cat: str, ts_us: float, dur_us: float,
                 args: dict | None = None) -> None:
        ev_args = dict(self.corr)
        if args:
            ev_args.update(args)
        self.emit({"name": name, "cat": cat, "ph": "X",
                   "ts": int(ts_us), "dur": max(int(dur_us), 0),
                   "pid": os.getpid(), "tid": threading.get_ident() & 0xffff,
                   "args": ev_args})

    def instant(self, name: str, cat: str, args: dict | None = None) -> None:
        ev_args = dict(self.corr)
        if args:
            ev_args.update(args)
        self.emit({"name": name, "cat": cat, "ph": "i", "s": "p",
                   "ts": int(time.time() * 1e6),
                   "pid": os.getpid(), "tid": threading.get_ident() & 0xffff,
                   "args": ev_args})


class _Span:
    """Live tracing span: wall-clock anchored, perf_counter-measured."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0", "_p0")

    def __init__(self, tr: Tracer, name: str, cat: str, args: dict):
        self._tr, self._name, self._cat, self._args = tr, name, cat, args

    def __enter__(self):
        self._t0 = time.time()
        self._p0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._p0
        self._tr.complete(self._name, self._cat, self._t0 * 1e6,
                          dur * 1e6, self._args)
        return False


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of recent structured events — the crash black box.
    ``record`` is cheap (deque append + optional instant trace event);
    ``dump`` writes the tail as JSON into the trace dir (or an explicit
    directory) at the moment something went wrong, and returns the
    events so callers (fleet postmortems) can embed them."""

    def __init__(self, maxlen: int | None = None):
        if maxlen is None:
            try:
                maxlen = int(knobs.raw(ENV_FLIGHT, "") or 256)
            except ValueError:
                maxlen = 256
        self._events: collections.deque = collections.deque(
            maxlen=max(maxlen, 8))
        self._dump_seq = 0
        self._lock = threading.Lock()

    def record(self, kind: str, **fields) -> None:
        self._events.append(
            {"t": round(time.time(), 6), "kind": kind, **fields})
        tr = get_tracer()
        if tr is not None:
            tr.instant(f"flight.{kind}", "flight", fields)

    def tail(self, n: int | None = None) -> list[dict]:
        evs = list(self._events)
        return evs if n is None else evs[-n:]

    def dump(self, reason: str, directory: str | None = None) -> dict:
        """Snapshot the ring as ``{reason, t, <correlation>, events}``;
        written to ``flight_rank<R>_<seq>_<reason>.json`` when a dump
        directory resolves (explicit arg, else SPARKNET_TRACE_DIR)."""
        doc = {"reason": reason, "t": round(time.time(), 3),
               **correlation_ids(), "pid": os.getpid(),
               "events": self.tail()}
        directory = directory or knobs.raw(ENV_TRACE_DIR)
        if directory:
            with self._lock:
                seq = self._dump_seq
                self._dump_seq += 1
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)[:48]
            path = os.path.join(
                directory,
                f"flight_rank{doc['rank']}_{os.getpid()}_{seq:03d}_"
                f"{safe}.json")
            try:
                os.makedirs(directory, exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, default=str)
                os.replace(tmp, path)
            except OSError:
                pass   # best effort: the dump must never mask the fault
        return doc


class _NullRecorder:
    """SPARKNET_TELEMETRY=0 recorder: drops everything."""

    def record(self, kind: str, **fields) -> None:
        pass

    def tail(self, n: int | None = None) -> list:
        return []

    def dump(self, reason: str, directory: str | None = None) -> dict:
        return {"reason": reason, "events": []}


# ---------------------------------------------------------------------------
# Process-global accessors (reset()-able for tests)
# ---------------------------------------------------------------------------

_NULL_REGISTRY = _NullRegistry()
_NULL_RECORDER = _NullRecorder()
_state: dict[str, Any] = {"registry": None, "tracer": None,
                          "tracer_off": False, "recorder": None}
_state_lock = threading.Lock()


def get_registry() -> MetricsRegistry | _NullRegistry:
    reg = _state["registry"]
    if reg is None:
        with _state_lock:
            reg = _state["registry"]
            if reg is None:
                reg = (MetricsRegistry() if enabled() else _NULL_REGISTRY)
                _state["registry"] = reg
    return reg


def get_tracer() -> Tracer | None:
    """The process tracer, or None when tracing is off (telemetry
    disabled or no SPARKNET_TRACE_DIR)."""
    tr = _state["tracer"]
    if tr is not None:
        return tr
    if _state["tracer_off"]:
        return None
    with _state_lock:
        if _state["tracer"] is not None or _state["tracer_off"]:
            return _state["tracer"]
        directory = knobs.raw(ENV_TRACE_DIR)
        if not directory or not enabled():
            _state["tracer_off"] = True
            return None
        _state["tracer"] = Tracer(directory)
        return _state["tracer"]


def get_recorder() -> FlightRecorder | _NullRecorder:
    rec = _state["recorder"]
    if rec is None:
        with _state_lock:
            rec = _state["recorder"]
            if rec is None:
                rec = (FlightRecorder() if enabled() else _NULL_RECORDER)
                _state["recorder"] = rec
    return rec


def tracing() -> bool:
    return get_tracer() is not None


def span(name: str, cat: str = "app", **args):
    """Context manager tracing one span; the shared no-op when tracing
    is off — safe (and free) to leave on hot paths."""
    tr = get_tracer()
    if tr is None:
        return NULL_SPAN
    return _Span(tr, name, cat, args)


def note_span(name: str, seconds: float, cat: str = "app", **args) -> None:
    """Retroactive span: an operation that just finished and took
    ``seconds`` (the FeedStats hook — stage timings are measured by the
    pipeline already; tracing only has to transcribe them)."""
    tr = get_tracer()
    if tr is None:
        return
    tr.complete(name, cat, (time.time() - seconds) * 1e6, seconds * 1e6,
                args)


def instant(name: str, cat: str = "app", **args) -> None:
    tr = get_tracer()
    if tr is not None:
        tr.instant(name, cat, args)


def reset() -> None:
    """Drop every cached singleton (flushing the tracer first) so the
    next accessor re-reads the env — the test hook for flipping
    SPARKNET_TELEMETRY / SPARKNET_TRACE_DIR mid-process."""
    global _DERIVED_RUN
    with _state_lock:
        tr = _state["tracer"]
        if tr is not None:
            tr.flush()
        _state.update(registry=None, tracer=None, tracer_off=False,
                      recorder=None)
        _DERIVED_RUN = None


@atexit.register
def _at_exit() -> None:
    """Final flush: the trace shard's buffered tail and (when
    SPARKNET_METRICS_SNAP is set) one last metrics snapshot."""
    tr = _state["tracer"]
    if tr is not None:
        try:
            tr.flush()
        except Exception:
            pass
    reg = _state["registry"]
    if reg is not None:
        try:
            reg.write_snapshot()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Snapshot folding
# ---------------------------------------------------------------------------

def fold_snapshots(paths: Iterable[str]) -> dict[str, Any]:
    """Fold ``metrics_rank*.json`` snapshot files into one rollup:
    counters sum across files, gauges keep the newest file's value,
    histograms sum counts and sums.  Returns {} when nothing parses."""
    docs = []
    for p in paths:
        try:
            with open(p) as f:
                docs.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    docs.sort(key=lambda d: d.get("t", 0.0))
    out: dict[str, Any] = {}
    for doc in docs:
        for name, m in (doc.get("metrics") or {}).items():
            kind = m.get("kind")
            agg = out.setdefault(name, {"kind": kind, "samples": {}})
            for s in m.get("samples", ()):
                key = _label_key(s.get("labels") or {})
                if kind == "histogram":
                    cur = agg["samples"].get(key)
                    if cur is None:
                        agg["samples"][key] = {
                            "labels": s.get("labels") or {},
                            "sum": s.get("sum", 0.0),
                            "count": s.get("count", 0)}
                    else:
                        cur["sum"] += s.get("sum", 0.0)
                        cur["count"] += s.get("count", 0)
                elif kind == "counter":
                    cur = agg["samples"].setdefault(
                        key, {"labels": s.get("labels") or {}, "value": 0.0})
                    cur["value"] += s.get("value", 0.0)
                else:   # gauge: newest doc wins (docs are time-sorted)
                    agg["samples"][key] = {"labels": s.get("labels") or {},
                                           "value": s.get("value", 0.0)}
    for agg in out.values():
        agg["samples"] = list(agg["samples"].values())
    return out
