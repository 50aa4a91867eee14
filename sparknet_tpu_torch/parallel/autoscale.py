"""SLO-driven autoscaler: per-model replica counts from observed pain.

The port's own copy of ``sparknet_tpu/parallel/autoscale.py``.

:class:`~sparknet_tpu_torch.parallel.serving.SLOMonitor` can only
*report* a burn; this module closes the loop (ROADMAP item 3): it
samples each replica's queue depth, rejection counters, and SLO verdict
— the same facts the health beacons already carry — and turns them into
scale decisions inside the fleet's device budget.

The policy (deliberately boring, fully inspectable):

- **Scale up** one replica for a model when the fleet shows *pressure*:
  mean per-replica backlog (engine queue depth + router outstanding)
  reaches ``up_queue``, OR any replica's SLO is in breach, OR typed
  rejections grew since the last sample.  A scale-up that the device
  budget refuses is RECORDED (``up_blocked``) rather than queued — the
  budget is the training tenants' protection, not a suggestion.
- **Scale down** one replica when the model has been *idle* (zero
  backlog, zero new rejections) for ``down_idle_s`` — never below
  ``min_replicas``.  The victim is drained (see
  :class:`~sparknet_tpu_torch.parallel.router.RouterDrainHook`) before any
  signal, so scale-down is lossless by construction.
- **Cooldown** ``cooldown_s`` separates consecutive decisions per model
  so a launch's warm-up (compile!) can land before it is judged.

Every decision (including holds-with-reason like ``up_blocked``) is
kept as the model's ``last`` record and atomically persisted to
``autoscale.json`` so ``tools/fleet.py status`` shows the last scale
decision + reason with no live channel — the same offline-status
posture the fleet journal takes.

Env knobs (defaults in :class:`AutoscaleConfig`):
  SPARKNET_AUTOSCALE_MIN        — floor replicas per model (1).
  SPARKNET_AUTOSCALE_MAX        — ceiling replicas per model (4).
  SPARKNET_AUTOSCALE_UP_QUEUE   — mean per-replica backlog that means
                                  pressure (8).
  SPARKNET_AUTOSCALE_DOWN_IDLE_S— idle seconds before a scale-down (10).
  SPARKNET_AUTOSCALE_COOLDOWN_S — seconds between decisions per model (5).
  SPARKNET_AUTOSCALE_EVAL_S     — sampler period (1).

The sampler input is a plain callable (``stats_fn``) returning

    {model: [{"rid": ..., "queue_depth": int, "outstanding": int,
              "rejected_total": int, "slo_breach": bool}, ...]}

so the tests drive the policy with scripted stats and a fake clock, and
:class:`~sparknet_tpu_torch.parallel.router.ServingFleet` feeds it from
beacons + router state (see :func:`fleet_stats_fn`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Mapping

from ..utils import telemetry
from .serving import _env_float


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    min_replicas: int = dataclasses.field(
        default_factory=lambda: int(_env_float("SPARKNET_AUTOSCALE_MIN",
                                               1)))
    max_replicas: int = dataclasses.field(
        default_factory=lambda: int(_env_float("SPARKNET_AUTOSCALE_MAX",
                                               4)))
    up_queue: float = dataclasses.field(
        default_factory=lambda: _env_float("SPARKNET_AUTOSCALE_UP_QUEUE",
                                           8.0))
    down_idle_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "SPARKNET_AUTOSCALE_DOWN_IDLE_S", 10.0))
    cooldown_s: float = dataclasses.field(
        default_factory=lambda: _env_float(
            "SPARKNET_AUTOSCALE_COOLDOWN_S", 5.0))
    sample_every_s: float = dataclasses.field(
        default_factory=lambda: _env_float("SPARKNET_AUTOSCALE_EVAL_S",
                                           1.0))

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError(f"min_replicas must be >= 0, "
                             f"got {self.min_replicas}")
        if self.max_replicas < max(self.min_replicas, 1):
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"max(min_replicas, 1) ({max(self.min_replicas, 1)})")
        if self.up_queue <= 0:
            raise ValueError(f"up_queue must be > 0, got {self.up_queue}")
        if self.down_idle_s <= 0 or self.cooldown_s < 0 \
                or self.sample_every_s <= 0:
            raise ValueError(
                f"down_idle_s ({self.down_idle_s}) must be > 0, "
                f"cooldown_s ({self.cooldown_s}) >= 0, sample_every_s "
                f"({self.sample_every_s}) > 0")


class Autoscaler:
    """The decision loop (policy in the module docstring).

    ``scale_up(model) -> bool`` and ``scale_down(model) -> str | None``
    are the actuation callbacks (:class:`ServingFleet` wires its own);
    a ``False`` / ``None`` return means the action was refused (budget,
    no victim) and is recorded as a blocked decision."""

    def __init__(self, stats_fn: Callable[[], Mapping[str, list]],
                 scale_up: Callable[[str], bool],
                 scale_down: Callable[[str], Any],
                 cfg: AutoscaleConfig | None = None,
                 state_path: str | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or AutoscaleConfig()
        self.stats_fn = stats_fn
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.state_path = state_path
        self._clock = clock
        self._lock = threading.Lock()
        self.last: dict[str, dict[str, Any]] = {}    # model -> decision
        self.decisions: list[dict[str, Any]] = []    # bounded trail
        self._last_rejected: dict[str, int] = {}
        self._idle_since: dict[str, float] = {}
        self._last_action_at: dict[str, float] = {}
        self.evaluations = 0
        self.sample_errors = 0
        self.last_sample_error: str | None = None
        reg = telemetry.get_registry()
        self._m_dec = reg.counter(
            "autoscale_decisions_total", "autoscaler decisions by action")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- policy -----------------------------------------------------------
    def _decide_model(self, model: str, replicas: list[dict],
                      now: float) -> dict[str, Any] | None:
        n = len(replicas)
        backlog = sum(int(r.get("queue_depth") or 0)
                      + int(r.get("outstanding") or 0) for r in replicas)
        mean_backlog = backlog / n if n else 0.0
        rejected = sum(int(r.get("rejected_total") or 0)
                       for r in replicas)
        rej_delta = max(rejected - self._last_rejected.get(model, 0), 0)
        self._last_rejected[model] = rejected
        breach = any(r.get("slo_breach") for r in replicas)

        pressure = []
        if n and mean_backlog >= self.cfg.up_queue:
            pressure.append(f"backlog {mean_backlog:.1f}/replica >= "
                            f"{self.cfg.up_queue:g}")
        if breach:
            pressure.append("SLO breach")
        if rej_delta:
            pressure.append(f"+{rej_delta} rejections")

        if pressure:
            self._idle_since.pop(model, None)
        elif backlog == 0 and n:
            self._idle_since.setdefault(model, now)
        else:
            self._idle_since.pop(model, None)

        cooling = (now - self._last_action_at.get(model, -1e18)
                   < self.cfg.cooldown_s)
        if n < self.cfg.min_replicas and not cooling:
            # below the floor: replicas died faster than the fleet could
            # requeue them (bulk host loss).  Backfill onto surviving
            # hosts within budget — this is availability repair, so it
            # outranks the pressure/idle policy.
            ok = bool(self.scale_up(model))
            self._last_action_at[model] = now
            return {"action": "up" if ok else "up_blocked",
                    "reason": f"{n} < min_replicas "
                              f"{self.cfg.min_replicas} — backfill"
                              + ("" if ok else " blocked: device budget "
                                               "has no free gang"),
                    "replicas": n}
        if pressure and n < self.cfg.max_replicas and not cooling:
            ok = bool(self.scale_up(model))
            self._last_action_at[model] = now
            return {"action": "up" if ok else "up_blocked",
                    "reason": "; ".join(pressure)
                              + ("" if ok else " — device budget has no "
                                               "free gang"),
                    "replicas": n}
        if pressure and n >= self.cfg.max_replicas:
            # at the ceiling: the typed rejections ARE the absorption —
            # record it so status explains why nothing moved
            return {"action": "hold_at_max",
                    "reason": "; ".join(pressure)
                              + f" — at max_replicas {self.cfg.max_replicas}",
                    "replicas": n}
        idle_for = (now - self._idle_since[model]
                    if model in self._idle_since else 0.0)
        if (idle_for >= self.cfg.down_idle_s
                and n > self.cfg.min_replicas and not cooling):
            victim = self.scale_down(model)
            self._last_action_at[model] = now
            self._idle_since.pop(model, None)
            return {"action": "down" if victim else "down_blocked",
                    "reason": f"idle {idle_for:.1f}s >= "
                              f"{self.cfg.down_idle_s:g}s"
                              + (f" — draining {victim}" if victim
                                 else " — no victim"),
                    "replicas": n}
        return None

    def evaluate(self) -> list[dict[str, Any]]:
        """One policy pass over a fresh sample; returns (and records)
        the decisions it took."""
        now = self._clock()
        stats = self.stats_fn()
        out = []
        for model, replicas in sorted(stats.items()):
            dec = self._decide_model(model, list(replicas), now)
            if dec is None:
                continue
            dec.update(model=model, at=round(now, 3))
            out.append(dec)
            with self._lock:
                self.last[model] = dec
                self.decisions.append(dec)
                del self.decisions[:-64]
            self._m_dec.inc(action=dec["action"])
            telemetry.get_recorder().record(
                "autoscale", model=model, action=dec["action"],
                reason=dec["reason"])
        with self._lock:
            self.evaluations += 1
        self._persist(stats, now)
        return out

    # -- persistence (the offline-status channel) -------------------------
    def _persist(self, stats: Mapping[str, list], now: float) -> None:
        if not self.state_path:
            return
        with self._lock:
            doc = {
                "t": time.time(),
                "evaluations": self.evaluations,
                "config": dataclasses.asdict(self.cfg),
                "models": {
                    m: {"replicas": len(reps),
                        "backlog": sum(int(r.get("queue_depth") or 0)
                                       + int(r.get("outstanding") or 0)
                                       for r in reps),
                        "last": self.last.get(m)}
                    for m, reps in sorted(stats.items())},
            }
        tmp = f"{self.state_path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(self.state_path) or ".",
                    exist_ok=True)
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
            os.replace(tmp, self.state_path)
        except OSError:
            pass   # an unwritable state file must not kill the sampler

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.cfg.sample_every_s + 5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.sample_every_s):
            try:
                self.evaluate()
            except Exception as e:
                # a broken scrape must not kill the sampler — park it
                # for summary() instead of swallowing
                self.sample_errors += 1
                self.last_sample_error = f"{type(e).__name__}: {e}"


def fleet_stats_fn(fleet) -> Callable[[], dict[str, list]]:
    """Build the autoscaler's sampler over a
    :class:`~sparknet_tpu_torch.parallel.router.ServingFleet`: per replica,
    the engine-side backlog from its health beacon's serving extras
    (queue_depth, rejected, SLO state) joined with the router's own
    outstanding count — no extra channel, the beacons the fleet status
    table already reads."""

    def stats() -> dict[str, list]:
        out: dict[str, list] = {}
        for name, model in sorted(fleet._model_of.items()):
            job = fleet.sched.jobs.get(name)
            if job is None or job.state not in ("RUNNING", "PREEMPTING"):
                continue
            rec: dict[str, Any] = {
                "rid": name,
                "outstanding": fleet.router.outstanding(name),
                "queue_depth": 0, "rejected_total": 0,
                "slo_breach": False,
            }
            for _rank, beat in fleet.sched._heartbeats(job).items():
                extras = beat.get("extras") or {}
                if not extras.get("serving"):
                    continue
                rec["queue_depth"] = int(extras.get("queue_depth") or 0)
                rejected = extras.get("rejected") or {}
                rec["rejected_total"] = (
                    sum(rejected.values())
                    if isinstance(rejected, Mapping) else int(rejected))
                rec["slo_breach"] = ((extras.get("slo") or {}).get(
                    "state") == "breach")
                break
            out.setdefault(model, []).append(rec)
        return out

    return stats
