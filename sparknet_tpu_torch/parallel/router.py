"""Request router: one endpoint in front of N serving replicas.

The port's own copy of ``sparknet_tpu/parallel/router.py``.

:class:`~sparknet_tpu_torch.parallel.serving.InferenceEngine` saturates
one device; this module is the SparkNet move applied to inference — a
cluster of commodity replicas behind one coordinator instead of a
bigger box.  The router owns PLACEMENT and LIVENESS; the replicas own
batching, admission, and exactness (each one is a full PR-7 engine, so
every per-replica contract — typed rejections, bit-identical pad/demux,
never-hang death — still holds behind the router).

The moving parts:

**Placement — consistent hash by model, spill by depth.**  Every model
has a *home* replica: the highest rendezvous (HRW) hash of
``(model, replica_id)`` over the live replicas serving that model.
Hashing is stable under membership change (a replica joining or leaving
re-homes only the models that hashed to it), which keeps each model's
traffic on one replica while the fleet is calm — warm LRU, coherent
telemetry.  When the home replica's router-tracked outstanding work
reaches ``spill_depth``, the request spills to the least-loaded live
replica instead: depth, not randomness, decides, so a single hot model
recruits exactly as many replicas as its backlog needs.

**Failover — typed, bounded, never a hang.**  A replica that dies
mid-request (its engine reports :class:`EngineDead`, or its transport
drops) is marked DEAD, the request is resubmitted to the next live
replica, and a bounded number of such hops (``max_failovers``) separates
"a replica died" from "the fleet is gone": when no live replica remains
the caller gets a typed :class:`EngineDead` — the ``DecodePool``
contract, one level up.  Inference is idempotent, so a resubmitted
request that ALSO executed on the dying replica is merely wasted work,
never a wrong answer.

**Drain — scale-down without loss.**  ``start_drain`` fences a replica
out of placement; its already-routed work finishes normally;
``drained()`` turns true when the router's outstanding count for it
hits zero.  :class:`RouterDrainHook` adapts that pair to the fleet
scheduler's preemption path, so evicting a serving replica (autoscaler
scale-down OR priority preemption by a training tenant) routes through
drain before the SIGTERM ever fires — every admitted request completes.

**Replica transports.**  :class:`InProcessReplica` wraps an engine in
this process (the fast path for tests and single-process fleets);
:class:`HttpReplica` drives a remote ``sparknet_tpu_torch.tools.serve``
over its JSON wire, mapping HTTP answers back onto the engine's typed
errors (429 → ``Overloaded``, 404 → ``UnknownModel``, 503/transport →
``EngineDead``, 507 → ``OverBudget``) so the router's logic is
transport-blind.

**Rollout — weighted canary placement.**  A :class:`RolloutState`
installed via ``set_rollout`` splits one model's plain-name traffic
between its ``stable`` and ``canary`` versions by hash fraction of a
deterministic per-request key (replays land on the same side), while
version-pinned requests bypass the split entirely.  The state mirrors
the registry's channel file (:mod:`.registry`) — the rollout controller
(:mod:`.rollout`) keeps the two in sync.

**ServingFleet** glues the router to the fleet scheduler: serving
replicas are first-class ``JobSpec(kind="serve")`` tenants that the
``GangAllocator`` places and quotas arbitrate; each replica process
publishes its ephemeral endpoint (``endpoint.json`` in its job dir) and
the fleet's poll loop registers it with the router; scale decisions
(see :mod:`.autoscale`) submit or drain+release those jobs within the
same device budget the training tenants compete for.

Env knobs (defaults in :class:`RouterConfig`):
  SPARKNET_ROUTER_SPILL_DEPTH — outstanding work on the home replica
                                beyond which requests spill (16).
  SPARKNET_ROUTER_FAILOVERS   — max dead-replica hops per request (3).
  SPARKNET_ROUTER_DRAIN_S     — drain grace before a scale-down stops
                                waiting (30 s).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np

from ..utils import telemetry
from .registry import versioned
from .serving import (
    EngineDead,
    OverBudget,
    Overloaded,
    ServeResult,
    ServingError,
    UnknownModel,
    _env_float,
)

# replica lifecycle states
ACTIVE = "ACTIVE"
DRAINING = "DRAINING"
DEAD = "DEAD"
RELEASED = "RELEASED"


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    spill_depth: int = dataclasses.field(
        default_factory=lambda: int(_env_float(
            "SPARKNET_ROUTER_SPILL_DEPTH", 16)))
    max_failovers: int = dataclasses.field(
        default_factory=lambda: int(_env_float(
            "SPARKNET_ROUTER_FAILOVERS", 3)))
    drain_grace_s: float = dataclasses.field(
        default_factory=lambda: _env_float("SPARKNET_ROUTER_DRAIN_S", 30.0))

    def __post_init__(self):
        if self.spill_depth < 1:
            raise ValueError(f"spill_depth must be >= 1, "
                             f"got {self.spill_depth}")
        if self.max_failovers < 0:
            raise ValueError(f"max_failovers must be >= 0, "
                             f"got {self.max_failovers}")
        if self.drain_grace_s <= 0:
            raise ValueError(f"drain_grace_s must be > 0, "
                             f"got {self.drain_grace_s}")


class _ReadyFuture:
    """Future shim for synchronous transports (the HTTP round trip has
    already happened by the time submit returns)."""

    def __init__(self, value):
        self._value = value

    def done(self) -> bool:
        return True

    def result(self, timeout=None):
        return self._value


# ---------------------------------------------------------------------------
# Replica transports
# ---------------------------------------------------------------------------

class InProcessReplica:
    """One serving replica living in this process: an engine + its
    house.  ``models`` is live (hot-load/evict through the house shows
    up in routing on the next placement)."""

    def __init__(self, rid: str, engine):
        self.rid = rid
        self.engine = engine

    @property
    def models(self) -> frozenset[str]:
        return frozenset(self.engine.models.loaded())

    def submit(self, model: str, x: np.ndarray, tenant: str):
        return self.engine.submit(model, x, tenant=tenant)

    def alive(self) -> bool:
        return self.engine.alive

    def stats(self) -> dict[str, Any]:
        return self.engine.stats()

    def describe(self) -> dict[str, Any]:
        return {"transport": "in_process", "models": sorted(self.models)}

    def close(self) -> None:
        self.engine.stop()


class HttpReplica:
    """One serving replica behind a ``sparknet_tpu_torch.tools.serve``
    endpoint.  The HTTP round trip happens inside ``submit`` (closed-loop
    client threads provide the concurrency), and wire answers map back onto
    the engine's typed errors so the router never branches on
    transport: 429 → :class:`Overloaded`, 404 unknown model →
    :class:`UnknownModel`, 503 / connection death → :class:`EngineDead`
    (which the router treats as "fail this replica over"), 507 →
    :class:`OverBudget` (healthy replica, model cannot fit — typed,
    never a failover hop)."""

    def __init__(self, rid: str, url: str,
                 models: Sequence[str] | None = None,
                 pid: int | None = None, timeout_s: float = 30.0):
        from ..classify import http_json
        self.rid = rid
        self.url = url.rstrip("/")
        self.pid = pid
        self.timeout_s = timeout_s
        if models is None:
            models = sorted(http_json(f"{self.url}/v1/models",
                                      timeout=timeout_s)["models"])
        self.models = frozenset(models)

    def submit(self, model: str, x: np.ndarray, tenant: str):
        from ..classify import remote_classify
        try:
            d = remote_classify(self.url, model, x, tenant=tenant,
                                timeout=self.timeout_s)
        except RuntimeError as e:
            msg = str(e)
            if "HTTP 429" in msg:
                raise Overloaded(
                    "tenant_rate" if "tenant_rate" in msg else "queue_full",
                    msg) from None
            if "HTTP 404" in msg and "unknown_model" in msg:
                raise UnknownModel(msg) from None
            if "HTTP 503" in msg:
                raise EngineDead(f"replica {self.rid}: {msg}") from None
            if "HTTP 507" in msg:
                # out of HBM budget, NOT dead: a typed OverBudget must
                # never burn a failover hop on a healthy replica
                nums = re.findall(r"(\d+(?:\.\d+)?)\s*MB", msg)
                raise OverBudget(
                    model,
                    float(nums[0]) if nums else 0.0,
                    float(nums[1]) if len(nums) > 1 else 0.0) from None
            raise ServingError(msg) from None
        except (OSError, TimeoutError) as e:
            # connection refused/reset/timeout: the replica process is
            # gone (or wedged) — a transport death is a replica death
            raise EngineDead(
                f"replica {self.rid} unreachable at {self.url}: "
                f"{e!r}") from None
        return _ReadyFuture(ServeResult(
            model=d["model"],
            probs=np.asarray(d["probs"], np.float32),
            tenant=tenant, request_id=d["request_id"],
            queue_ms=d["queue_ms"], infer_ms=d["infer_ms"],
            total_ms=d["total_ms"], batch_n=d["batch_n"],
            padded_to=d["padded_to"]))

    def alive(self) -> bool:
        from ..classify import http_json
        try:
            return bool(http_json(f"{self.url}/healthz",
                                  timeout=self.timeout_s)["alive"])
        except (OSError, RuntimeError, ValueError, KeyError):
            return False

    def stats(self) -> dict[str, Any]:
        from ..classify import http_json
        try:
            return http_json(f"{self.url}/healthz", timeout=self.timeout_s)
        except (OSError, RuntimeError, ValueError, KeyError) as e:
            return {"alive": False, "error": repr(e)}

    def describe(self) -> dict[str, Any]:
        return {"transport": "http", "url": self.url, "pid": self.pid,
                "models": sorted(self.models)}

    def close(self) -> None:
        pass


class _Replica:
    """Router-side record of one replica (client + placement state)."""

    __slots__ = ("rid", "client", "state", "outstanding", "completed",
                 "failed", "joined_at", "note")

    def __init__(self, rid: str, client, joined_at: float):
        self.rid = rid
        self.client = client
        self.state = ACTIVE
        self.outstanding = 0       # routed, not yet settled
        self.completed = 0
        self.failed = 0
        self.joined_at = joined_at
        self.note = ""


def _hrw(model: str, rid: str) -> int:
    """Rendezvous weight: highest hash owns the model."""
    return int.from_bytes(
        hashlib.md5(f"{model}|{rid}".encode()).digest()[:8], "big")


@dataclasses.dataclass(frozen=True)
class RolloutState:
    """Weighted stable-vs-canary placement for one model (the router's
    in-memory mirror of the registry's channel file).

    ``target`` is a pure function of the route key — the same request
    replayed lands on the same version, so a rollout never makes replays
    flap — and the split is by HASH FRACTION, not a counter: ``weight``
    of the keyspace goes to the canary with no shared mutable state to
    race on.  Pinned requests (an explicit ``version=``) bypass this
    entirely and always hit their version bit-identically."""

    model: str
    stable: str
    canary: str | None = None
    weight: float = 0.0

    def __post_init__(self):
        if not self.stable:
            raise ValueError(f"rollout for {self.model!r} needs a "
                             f"stable version")
        if not 0.0 <= self.weight <= 1.0:
            raise ValueError(f"canary weight must be in [0, 1], "
                             f"got {self.weight}")
        if self.canary is None and self.weight > 0:
            raise ValueError(f"rollout for {self.model!r} has weight "
                             f"{self.weight} but no canary version")

    def target(self, rkey: str) -> str:
        """The versioned serving name this route key lands on."""
        if self.canary is None or self.weight <= 0.0:
            return versioned(self.model, self.stable)
        frac = int.from_bytes(
            hashlib.md5(f"rollout|{self.model}|{rkey}".encode())
            .digest()[:8], "big") / 2.0 ** 64
        if frac < self.weight:
            return versioned(self.model, self.canary)
        return versioned(self.model, self.stable)

    def to_doc(self) -> dict[str, Any]:
        return {"model": self.model, "stable": self.stable,
                "canary": self.canary, "weight": self.weight}


class RouterFuture:
    """One routed request.  ``result`` re-routes on replica death — the
    waiter sees a typed error only once every failover hop is spent or
    no live replica remains; it never hangs (every wait leg rides the
    replica future's own bounded polling)."""

    def __init__(self, router: "Router", rep: _Replica, inner,
                 model: str, x: np.ndarray, tenant: str):
        self._router = router
        self._rep = rep
        self._inner = inner
        self._model = model
        self._x = x
        self._tenant = tenant
        self._hops = 0

    def done(self) -> bool:
        return self._inner.done()

    def result(self, timeout: float | None = None) -> ServeResult:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            remaining = (None if deadline is None
                         else max(deadline - time.monotonic(), 0.001))
            try:
                res = self._inner.result(remaining)
            except EngineDead as e:
                self._router._settle(self._rep, ok=False)
                self._router.mark_dead(self._rep.rid, str(e))
                self._hops += 1
                if self._hops > self._router.cfg.max_failovers:
                    raise EngineDead(
                        f"request for {self._model!r} failed over "
                        f"{self._hops} time(s) without landing: "
                        f"{e}") from None
                self._router._count("failover")
                nxt = self._router.submit(self._model, self._x,
                                          self._tenant)
                self._rep, self._inner = nxt._rep, nxt._inner
                continue
            except BaseException:
                self._router._settle(self._rep, ok=False)
                raise
            self._router._settle(self._rep, ok=True)
            return res


class Router:
    """The one-endpoint front over N replicas (see module docstring).

    Thread-safe; placement state is one lock, request waits happen
    outside it.  ``submit`` returns a :class:`RouterFuture`; failover on
    a replica that dies BEFORE accepting the request happens inside
    ``submit`` (synchronously, bounded), failover on one that dies
    mid-request happens inside ``result``."""

    def __init__(self, cfg: RouterConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or RouterConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._replicas: dict[str, _Replica] = {}
        self._gone: dict[str, dict[str, Any]] = {}   # DEAD/RELEASED stubs
        self._rollouts: dict[str, RolloutState] = {}  # by base model
        self.counts = {"requests": 0, "spills": 0, "failovers": 0,
                       "rejections": 0, "deaths": 0, "drains": 0}
        reg = telemetry.get_registry()
        self._m_events = reg.counter(
            "router_events_total", "request router events by kind")
        reg.add_collector(self._publish_gauges)

    # -- membership -------------------------------------------------------
    def add_replica(self, rid: str, client) -> None:
        """Register (or replace — the restarted-replica path) ``rid``."""
        with self._lock:
            self._replicas[rid] = _Replica(rid, client, self._clock())
            self._gone.pop(rid, None)
        telemetry.get_recorder().record("router_join", rid=rid)
        self._count("join")

    def mark_dead(self, rid: str, note: str = "") -> None:
        with self._lock:
            rep = self._replicas.pop(rid, None)
            if rep is None:
                return
            rep.state = DEAD
            rep.note = note
            self.counts["deaths"] += 1
            self._gone[rid] = self._stub(rep)
        telemetry.get_recorder().record("router_dead", rid=rid, note=note)
        self._count("dead")

    def release(self, rid: str) -> None:
        """Forget a drained replica (idempotent)."""
        with self._lock:
            rep = self._replicas.pop(rid, None)
            if rep is None:
                return
            rep.state = RELEASED
            self._gone[rid] = self._stub(rep)
        self._count("release")

    # -- rollout (weighted stable/canary placement) -----------------------
    def set_rollout(self, state: RolloutState) -> None:
        """Install (or retune — weight changes are just re-installs) the
        stable/canary split for ``state.model``.  Plain-name requests for
        that model start resolving to versioned serving names."""
        with self._lock:
            self._rollouts[state.model] = state
        telemetry.get_recorder().record(
            "router_rollout", **state.to_doc())
        self._count("rollout_set")

    def clear_rollout(self, model: str) -> None:
        """Back to plain by-name routing for ``model`` (idempotent)."""
        with self._lock:
            if self._rollouts.pop(model, None) is not None:
                self._count("rollout_clear")

    def rollout(self, model: str) -> RolloutState | None:
        with self._lock:
            return self._rollouts.get(model)

    @staticmethod
    def _route_key(tenant: str, x: np.ndarray) -> str:
        """Deterministic per-request key: same tenant + same input bytes
        → same key → same rollout side, every replay."""
        h = hashlib.sha1(tenant.encode())
        h.update(np.ascontiguousarray(x).tobytes())
        return h.hexdigest()

    def _resolve(self, model: str, x: np.ndarray, tenant: str,
                 version: str | None, rkey: str | None) -> str:
        if version is not None:
            return versioned(model, version)    # pinned: no dice roll
        with self._lock:
            state = self._rollouts.get(model)
        if state is None:
            return model
        return state.target(rkey if rkey is not None
                            else self._route_key(tenant, x))

    def replica_ids(self, model: str | None = None,
                    live_only: bool = True) -> list[str]:
        with self._lock:
            return sorted(
                r.rid for r in self._replicas.values()
                if (not live_only or r.state == ACTIVE)
                and (model is None or model in r.client.models))

    # -- placement --------------------------------------------------------
    def home(self, model: str) -> str | None:
        """The model's home replica id (None when nothing serves it)."""
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.state == ACTIVE and model in r.client.models]
        if not cands:
            return None
        return max(cands, key=lambda r: _hrw(model, r.rid)).rid

    def _pick(self, model: str, exclude: set[str]) -> _Replica:
        with self._lock:
            cands = [r for r in self._replicas.values()
                     if r.state == ACTIVE and r.rid not in exclude
                     and model in r.client.models]
            if not cands:
                if any(model in r.client.models
                       for r in self._replicas.values()) or any(
                           model in (g.get("models") or ())
                           for g in self._gone.values()):
                    raise EngineDead(
                        f"no live replica for model {model!r} "
                        f"(live: {sorted(r.rid for r in self._replicas.values() if r.state == ACTIVE)}, "
                        f"gone: {sorted(self._gone)})")
                raise UnknownModel(
                    f"no replica serves model {model!r} "
                    f"(replicas: {sorted(self._replicas) or '[]'})")
            home = max(cands, key=lambda r: _hrw(model, r.rid))
            pick = home
            if (home.outstanding >= self.cfg.spill_depth
                    and len(cands) > 1):
                least = min(cands,
                            key=lambda r: (r.outstanding, r.rid))
                if least is not home \
                        and least.outstanding < home.outstanding:
                    pick = least
                    self.counts["spills"] += 1
                    self._m_events.inc(ev="spill")
            pick.outstanding += 1
            self.counts["requests"] += 1
            return pick

    def _settle(self, rep: _Replica, ok: bool) -> None:
        with self._lock:
            rep.outstanding = max(rep.outstanding - 1, 0)
            if ok:
                rep.completed += 1
            else:
                rep.failed += 1

    def _count(self, ev: str) -> None:
        self._m_events.inc(ev=ev)

    # -- the request path -------------------------------------------------
    def submit(self, model: str, x: np.ndarray, tenant: str = "anon",
               version: str | None = None,
               rkey: str | None = None) -> RouterFuture:
        """Route one request; returns a failover-aware future.  Raises
        the replica vocabulary synchronously: :class:`Overloaded` when
        the chosen replica (and the least-loaded alternative) reject,
        :class:`UnknownModel` / :class:`EngineDead` when nothing can
        take the model at all.

        ``version`` pins the request to one published version
        (``model@version`` placement, no rollout dice roll); otherwise
        an installed :class:`RolloutState` splits plain-name traffic
        stable-vs-canary by ``rkey`` (derived deterministically from
        tenant + input bytes when not given).  Failover hops keep the
        resolved version — a mid-request replica death never silently
        moves a request across the canary boundary."""
        model = self._resolve(model, x, tenant, version, rkey)
        excluded: set[str] = set()
        spilled_reject = False
        for _ in range(self.cfg.max_failovers + 2):
            rep = self._pick(model, excluded)     # raises typed when none
            try:
                inner = rep.client.submit(model, x, tenant)
            except Overloaded:
                self._settle(rep, ok=False)
                with self._lock:
                    self.counts["rejections"] += 1
                    alternatives = any(
                        r.state == ACTIVE and r.rid != rep.rid
                        and r.rid not in excluded
                        and model in r.client.models
                        for r in self._replicas.values())
                self._count("reject")
                if spilled_reject or not alternatives:
                    raise
                # the home queue is FULL, not merely deep: one spill
                # attempt at the least-loaded alternative, then the
                # rejection is the caller's typed answer
                spilled_reject = True
                excluded.add(rep.rid)
                continue
            except EngineDead as e:
                self._settle(rep, ok=False)
                self.mark_dead(rep.rid, str(e))
                self.counts["failovers"] += 1
                self._count("failover")
                excluded.add(rep.rid)
                continue
            except UnknownModel:
                # registered models drifted (hot-evict raced routing):
                # not a death — just not a candidate for this model
                self._settle(rep, ok=False)
                excluded.add(rep.rid)
                continue
            except OverBudget:
                # the replica is healthy, the model just cannot fit its
                # HBM budget: a typed answer for the caller, never a
                # failover hop and never a mark_dead
                self._settle(rep, ok=False)
                raise
            except ServingError:
                # any other typed serving error: settle the outstanding
                # count (it used to leak here) and let the caller see it
                self._settle(rep, ok=False)
                raise
            return RouterFuture(self, rep, inner, model, x, tenant)
        raise EngineDead(
            f"request for {model!r} exhausted "
            f"{self.cfg.max_failovers} failover hops")

    def classify(self, model: str, x: np.ndarray, tenant: str = "anon",
                 timeout: float | None = 30.0,
                 version: str | None = None,
                 rkey: str | None = None) -> ServeResult:
        return self.submit(model, x, tenant, version=version,
                           rkey=rkey).result(timeout)

    # -- drain (the lossless scale-down path) -----------------------------
    def start_drain(self, rid: str) -> None:
        """Fence ``rid`` out of placement; its routed work keeps
        completing (idempotent; unknown rid is a no-op)."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or rep.state != ACTIVE:
                return
            rep.state = DRAINING
            self.counts["drains"] += 1
        telemetry.get_recorder().record("router_drain", rid=rid)
        self._count("drain")

    def drained(self, rid: str) -> bool:
        """True when ``rid`` has no outstanding routed work (a forgotten
        or dead replica counts as drained — there is nothing to wait
        for)."""
        with self._lock:
            rep = self._replicas.get(rid)
            return rep is None or rep.outstanding <= 0

    def drain(self, rid: str, timeout_s: float | None = None) -> bool:
        """Blocking drain + release.  True = clean (outstanding hit
        zero), False = the grace expired with work still in flight (the
        replica is released regardless — the caller is tearing it
        down)."""
        grace = self.cfg.drain_grace_s if timeout_s is None else timeout_s
        self.start_drain(rid)
        deadline = time.monotonic() + grace
        clean = True
        while not self.drained(rid):
            if time.monotonic() > deadline:
                clean = False
                break
            time.sleep(0.01)
        self.release(rid)
        return clean

    # -- introspection ----------------------------------------------------
    def _stub(self, rep: _Replica) -> dict[str, Any]:
        return {"state": rep.state, "completed": rep.completed,
                "failed": rep.failed, "note": rep.note,
                "models": sorted(rep.client.models)}

    def outstanding(self, rid: str) -> int:
        with self._lock:
            rep = self._replicas.get(rid)
            return 0 if rep is None else rep.outstanding

    def stats(self) -> dict[str, Any]:
        with self._lock:
            reps = {
                r.rid: {"state": r.state, "outstanding": r.outstanding,
                        "completed": r.completed, "failed": r.failed,
                        "models": sorted(r.client.models),
                        **r.client.describe()}
                for r in self._replicas.values()}
            gone = dict(self._gone)
            counts = dict(self.counts)
            rollouts = {m: st.to_doc()
                        for m, st in self._rollouts.items()}
        models = sorted({m for r in reps.values() for m in r["models"]})
        return {"replicas": reps, "gone": gone, "counts": counts,
                "rollouts": rollouts,
                "by_model": {m: {"home": self.home(m),
                                 "replicas": self.replica_ids(m)}
                             for m in models}}

    def write_state(self, path: str) -> None:
        """Atomic snapshot for offline status views
        (``tools/fleet.py status`` reads this as ``router.json``)."""
        doc = {"t": time.time(), **self.stats()}
        tmp = f"{path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    def _publish_gauges(self) -> None:
        reg = telemetry.get_registry()
        with self._lock:
            live = sum(1 for r in self._replicas.values()
                       if r.state == ACTIVE)
            outstanding = sum(r.outstanding
                              for r in self._replicas.values())
        reg.gauge("router_replicas_live",
                  "replicas in ACTIVE placement").set(live)
        reg.gauge("router_outstanding",
                  "requests routed, not yet settled").set(outstanding)


class RouterDrainHook:
    """Adapter between the fleet scheduler's preempt/release path and
    the router's drain fence: ``start()`` stops new placements onto the
    replica, ``done()`` is true once its routed work has settled (and
    releases the replica from the table as a side effect, idempotent).
    The scheduler delays SIGTERM until ``done()`` or its drain grace
    expires — the "drain, then the SIGTERM path" contract."""

    def __init__(self, router: Router, rid: str):
        self.router = router
        self.rid = rid

    def start(self) -> None:
        self.router.start_drain(self.rid)

    def done(self) -> bool:
        if self.router.drained(self.rid):
            self.router.release(self.rid)
            return True
        return False


# ---------------------------------------------------------------------------
# ServingFleet — replicas as first-class fleet tenants
# ---------------------------------------------------------------------------

class ServingFleet:
    """Router + replica jobs + (optionally) an autoscaler over one
    :class:`~sparknet_tpu_torch.parallel.fleet.FleetScheduler`.

    Each replica is a ``JobSpec(kind="serve")`` the scheduler places
    onto the shared device budget exactly like a training gang: quotas
    arbitrate it, priorities can preempt it (through the registered
    :class:`RouterDrainHook`, so preemption drains before it signals),
    and its ResilientRunner restarts it on crashes.  The replica
    process (``sparknet_tpu_torch.tools.serve``) publishes its ephemeral
    endpoint into ``<job_dir>/endpoint.json``; :meth:`poll` registers
    ready endpoints with the router and prunes jobs that left RUNNING.

    ``run_background()`` drives scheduler steps + polling on a daemon
    thread (the long-lived ``serve --fleet`` posture); tests
    and harnesses may instead call ``step()`` themselves."""

    def __init__(self, workdir: str, devices: int, *,
                 tenant: str = "serving", priority: int = 0,
                 preemptible: bool = True, world: int = 1,
                 serve_env: Mapping[str, str] | None = None,
                 router_cfg: RouterConfig | None = None,
                 replica_timeout_s: float = 30.0,
                 scheduler=None, tick_s: float = 0.05, **sched_kw):
        from .fleet import FleetScheduler
        self.workdir = os.path.abspath(workdir)
        self.sched = scheduler or FleetScheduler(self.workdir, devices,
                                                 **sched_kw)
        self.router = Router(router_cfg)
        self.tenant = tenant
        self.priority = priority
        self.preemptible = preemptible
        self.world = world
        self.serve_env = dict(serve_env or {})
        self.replica_timeout_s = replica_timeout_s
        self.tick_s = tick_s
        self.autoscaler = None          # attach via attach_autoscaler()
        self._seq: dict[str, int] = {}
        self._model_of: dict[str, str] = {}      # job name -> model spec
        self._endpoints: dict[str, str] = {}     # job name -> url
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.poll_errors = 0
        self.last_poll_error: str | None = None

    # -- replica jobs -----------------------------------------------------
    def _slug(self, model: str) -> str:
        return model.replace(",", "+").replace("/", "_")

    def submit_replica(self, model: str) -> str:
        """Submit one serve-kind job for ``model`` (comma list allowed);
        returns the job name (= the replica id)."""
        from .fleet import JobSpec
        with self._lock:
            k = self._seq.get(model, 0)
            self._seq[model] = k + 1
        name = f"serve-{self._slug(model)}-{k}"
        spec = JobSpec(name=name, kind="serve", model=model,
                       tenant=self.tenant, priority=self.priority,
                       world=self.world, preemptible=self.preemptible,
                       timeout_s=None, env=self.serve_env)
        self.sched.submit(spec)
        self.sched.register_drain_hook(
            name, RouterDrainHook(self.router, name))
        self._model_of[name] = model
        return name

    def ensure(self, model: str, n: int) -> list[str]:
        """Submit replicas until ``model`` has ``n`` serve jobs that are
        neither terminal nor mid-release; returns all their names."""
        names = self.active_replica_jobs(model)
        while len(names) < n:
            names.append(self.submit_replica(model))
        return names

    def replica_jobs(self, model: str | None = None) -> list[str]:
        from .fleet import TERMINAL
        return [name for name, m in sorted(self._model_of.items())
                if (model is None or m == model)
                and name in self.sched.jobs
                and self.sched.jobs[name].state not in TERMINAL]

    def active_replica_jobs(self, model: str | None = None) -> list[str]:
        """Replica jobs that are (or will come back) serving: a job
        mid-release is already leaving and must not count toward the
        desired size — or be picked as a victim twice."""
        return [n for n in self.replica_jobs(model)
                if not self.sched.jobs[n].release_requested]

    # -- autoscaler callbacks (see autoscale.Autoscaler) ------------------
    def scale_up(self, model: str) -> bool:
        """One more replica for ``model`` iff the device budget has a
        free gang RIGHT NOW (the autoscaler must not stack a queue of
        unplaceable wishes — a blocked scale-up is a recorded fact)."""
        if self.sched.allocator.free_count < self.world:
            return False
        self.submit_replica(model)
        return True

    def scale_down(self, model: str, rid: str | None = None) -> str | None:
        """Drain + release one replica of ``model`` (the least-loaded
        live one unless ``rid`` names a victim).  Lossless: the
        release routes through the drain hook before any signal."""
        if rid is None:
            active = self.active_replica_jobs(model)
            live = [r for r in active
                    if r in self.router.replica_ids(live_only=True)]
            if not live:
                live = active
            if not live:
                return None
            rid = min(live, key=self.router.outstanding)
        self.sched.release_job(rid)
        return rid

    def attach_autoscaler(self, autoscaler) -> None:
        self.autoscaler = autoscaler

    # -- endpoint discovery ----------------------------------------------
    def _read_endpoint(self, job) -> dict | None:
        """The job's published endpoint, verified LIVE: the publishing
        pid must still exist and carry our fleet job tag — a dead
        replica's stale endpoint.json (its restart hasn't republished
        yet) must never route."""
        from .fleet import _pid_is_fleet_job
        path = os.path.join(job.job_dir, "endpoint.json")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if not (isinstance(doc, dict) and doc.get("url")
                and doc.get("pid")):
            return None
        if not _pid_is_fleet_job(int(doc["pid"]), job.name):
            return None
        return doc

    def poll(self) -> None:
        """Reconcile the router table with the scheduler's world: ready
        RUNNING replicas join (or re-join at a fresh URL after a
        restart), jobs that left RUNNING are pruned, and the state
        snapshots for offline status views are refreshed."""
        from .fleet import HOST_LOST, HOST_SUSPECT, PREEMPTING, RUNNING
        pool = getattr(self.sched, "pool", None)
        for name in list(self._model_of):
            job = self.sched.jobs.get(name)
            if job is None:
                continue
            registered = name in self.router.replica_ids(live_only=False)
            if job.state == RUNNING:
                # a replica behind a SUSPECT link is unroutable but NOT
                # dead: unroute it now (requests take bounded failover
                # to reachable replicas) and let the normal re-admission
                # below re-add it the poll after its host heals — its
                # process never stopped, its endpoint is still live
                if registered and pool is not None and any(
                        pool.state.get(h) == HOST_SUSPECT
                        for h in getattr(job, "hosts", ())):
                    self.router.mark_dead(name, "host suspect")
                    self._endpoints.pop(name, None)
                    continue
                ep = self._read_endpoint(job)
                if ep and (not registered
                           or self._endpoints.get(name) != ep["url"]):
                    try:
                        client = HttpReplica(
                            name, ep["url"], models=ep.get("models"),
                            pid=ep.get("pid"),
                            timeout_s=self.replica_timeout_s)
                    except (OSError, RuntimeError, ValueError,
                            KeyError):
                        continue     # endpoint up but not answering yet
                    self.router.add_replica(name, client)
                    self._endpoints[name] = ep["url"]
            elif job.state == PREEMPTING:
                # drain hook owns the fence — EXCEPT when the replica's
                # machine is LOST: a dead host cannot drain, so this is
                # bulk replica death.  Unroute it NOW; in-flight work
                # takes the typed bounded failover to survivors and the
                # scheduler requeues the replica onto a live host.
                if registered and pool is not None and any(
                        pool.state.get(h) == HOST_LOST
                        for h in getattr(job, "hosts", ())):
                    self.router.mark_dead(name, "host lost")
                    self._endpoints.pop(name, None)
            elif registered:
                # the job died / finished out from under the router
                self.router.mark_dead(name, f"job state {job.state}")
                self._endpoints.pop(name, None)
        self.router.write_state(os.path.join(self.workdir, "router.json"))

    def step(self) -> None:
        self.sched.step()
        self.poll()

    def wait_ready(self, model: str, n: int,
                   timeout_s: float = 120.0) -> list[str]:
        """Step until ``n`` replicas of ``model`` answer through the
        router; loud on timeout (a fleet that cannot place its replicas
        must fail, not spin)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._thread is None:
                self.step()
            live = [r for r in self.router.replica_ids(live_only=True)
                    if self._model_of.get(r) == model
                    or model in (self._model_of.get(r) or "").split(",")]
            if len(live) >= n:
                return sorted(live)
            time.sleep(self.tick_s)
        raise TimeoutError(
            f"{n} replica(s) of {model!r} not ready within {timeout_s}s "
            f"(router: {self.router.stats()['replicas']})")

    # -- lifecycle --------------------------------------------------------
    def run_background(self) -> None:
        if self._thread is not None:
            return
        if self.autoscaler is not None:
            self.autoscaler.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-fleet", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.step()
            except Exception as e:
                # one bad poll (torn endpoint file, slow scrape) must
                # not kill the fleet loop — park it where status() and
                # the postmortem can see it
                with self._lock:
                    self.poll_errors += 1
                    self.last_poll_error = f"{type(e).__name__}: {e}"

    def stop(self, grace_s: float | None = None) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.sched.shutdown(grace_s)
        try:
            self.router.write_state(
                os.path.join(self.workdir, "router.json"))
        except OSError:
            pass

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
