"""Canary rollout controller: promote on judged health, auto-roll back

The port's own copy of ``sparknet_tpu/parallel/rollout.py``.
on sustained SLO breach, survive our own death (WALKTHROUGH §6.20).

The deployment plane has three layers with one source of truth each:

- the **registry** (:mod:`.registry`) owns artifacts and the per-model
  ``channels.json`` (stable/canary pointers + canary weight);
- the **router** mirrors the channel file as a :class:`.router
  .RolloutState` — weighted, deterministic, pin-respecting placement;
- this controller owns the TRANSITIONS between channel states, and
  journals every transition to ``rollout.jsonl`` BEFORE applying it.

State machine per model (weight only ever non-zero inside CANARY)::

    STABLE --start_canary--> CANARY --promote---> STABLE (new version)
                               |
                               +--rollback-----> STABLE (old version)

The judge is the SLO monitor's burn-rate discipline applied per version: each
poll reads the canary's own :class:`~.serving.SLOMonitor` verdict (which
is already multi-window with a minimum-request floor — blips never
page); only ``breach_polls`` CONSECUTIVE breach verdicts trigger
rollback, and promotion requires ``judge_s`` of sustained health over at
least ``min_requests`` observed requests.  An optional ``bands`` hook
feeds perfwatch-style regression verdicts into the same judgment.

Rollback discipline, in order: canary traffic weight → 0 (router first —
stop the bleeding), channel pointer reverted (the durable truth), canary
replicas drained through the router's drain fences (admitted work still
completes), flight-recorder dump + ``rollout_events_total`` metrics.

**Crash consistency.**  Every transition is write-ahead journaled
(``*_begin`` line, fsync, apply, ``*_done`` line).  ``resume`` replays
the journal: a ``promote_begin`` without its ``done`` is re-applied to
completion (fully promoted), any other in-flight state rolls back to
fully stable — a dead controller means NOBODY is judging the canary, so
traffic must not keep flowing to it.  Either way a scheduler death
mid-rollout recovers to exactly one of {fully stable, fully promoted},
never a half-promoted fleet, and replaying twice is a no-op.

Env knobs (defaults in :class:`RolloutConfig`):
  SPARKNET_ROLLOUT_CANARY_FRACTION — traffic share a new canary starts
                                     with (0.1).
  SPARKNET_ROLLOUT_JUDGE_S         — sustained-health seconds before
                                     promote (8).
  SPARKNET_ROLLOUT_POLL_S          — judge poll interval (0.5).
  SPARKNET_ROLLOUT_MIN_REQUESTS    — observed-request floor before
                                     promote (20).
  SPARKNET_ROLLOUT_BREACH_POLLS    — consecutive breach verdicts that
                                     trigger rollback (2).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

from ..utils import knobs, telemetry
from .registry import ModelRegistry, versioned
from .router import RolloutState

__all__ = ["RolloutError", "RolloutConfig", "RolloutController",
           "replay", "status", "JOURNAL"]

JOURNAL = "rollout.jsonl"
_JOURNAL_VERSION = 1


class RolloutError(RuntimeError):
    """A rollout operation that cannot proceed (no stable baseline,
    canary == stable, no canary in flight, ...)."""


def _env_f(name: str, default: float) -> float:
    raw = knobs.raw(name)
    return float(raw) if raw else default


def _env_i(name: str, default: int) -> int:
    raw = knobs.raw(name)
    return int(raw) if raw else default


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    fraction: float = 0.1       # initial canary traffic share
    judge_s: float = 8.0        # sustained health before promote
    poll_s: float = 0.5         # judge poll interval
    min_requests: int = 20      # observed-request floor before promote
    breach_polls: int = 2       # consecutive breach verdicts -> rollback

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise ValueError(f"canary fraction must be in (0, 1], "
                             f"got {self.fraction}")
        if self.judge_s <= 0 or self.poll_s <= 0:
            raise ValueError("judge_s and poll_s must be > 0")
        if self.min_requests < 1 or self.breach_polls < 1:
            raise ValueError("min_requests and breach_polls must be >= 1")

    @classmethod
    def from_env(cls) -> "RolloutConfig":
        return cls(
            fraction=_env_f("SPARKNET_ROLLOUT_CANARY_FRACTION", 0.1),
            judge_s=_env_f("SPARKNET_ROLLOUT_JUDGE_S", 8.0),
            poll_s=_env_f("SPARKNET_ROLLOUT_POLL_S", 0.5),
            min_requests=_env_i("SPARKNET_ROLLOUT_MIN_REQUESTS", 20),
            breach_polls=_env_i("SPARKNET_ROLLOUT_BREACH_POLLS", 2))


class RolloutController:
    """Drives one registry's channel transitions (see module docstring).

    The fleet wiring is injected, so the controller is deployment-shape
    blind:

    ``ensure(name)``
        bring replicas serving versioned name ``name`` up (idempotent —
        resume re-ensures).
    ``retire(name)``
        drain replicas serving ``name`` through the router's drain
        fences and release them (idempotent; absent name is a no-op —
        resume retires versions whose replicas may never have existed).
    ``verdict(name)``
        the per-version SLO verdict doc for ``name`` (the
        ``SLOMonitor.evaluate()`` shape: ``{"state": "ok"|"breach",
        "windows": {...}, ...}``), or None when not yet measurable.
    ``bands(name)`` (optional)
        perfwatch-style band violations for ``name`` as a list of
        reason strings; non-empty judges as a breach poll.
    """

    def __init__(self, registry: ModelRegistry, workdir: str, *,
                 ensure: Callable[[str], Any],
                 retire: Callable[[str], Any],
                 verdict: Callable[[str], dict | None],
                 bands: Callable[[str], list] | None = None,
                 router=None, cfg: RolloutConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.workdir = os.path.abspath(workdir)
        self.path = os.path.join(self.workdir, JOURNAL)
        self.ensure = ensure
        self.retire = retire
        self.verdict = verdict
        self.bands = bands
        self.router = router
        self.cfg = cfg or RolloutConfig.from_env()
        self._clock = clock
        self._seq = sum(1 for _ in _read_journal(self.path))
        self._streak: dict[str, int] = {}        # consecutive breaches
        self._healthy_since: dict[str, float] = {}
        self._last_verdict: dict[str, Any] = {}  # last JOURNALED state
        self._m_events = telemetry.get_registry().counter(
            "rollout_events_total", "rollout decision-log events by kind")

    # -- the decision log -------------------------------------------------
    def _log(self, ev: str, model: str, **kw: Any) -> None:
        """Append one decision record — fsynced BEFORE the transition it
        describes is applied (write-ahead: resume must never learn less
        than the fleet already did)."""
        rec = {"v": _JOURNAL_VERSION, "seq": self._seq,
               "t": time.time(), "ev": ev, "model": model, **kw}
        self._seq += 1
        os.makedirs(self.workdir, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._m_events.inc(ev=ev)
        telemetry.get_recorder().record(f"rollout_{ev}", model=model,
                                        **{k: v for k, v in kw.items()
                                           if isinstance(v, (str, int,
                                                             float))})

    # -- transitions ------------------------------------------------------
    def start_canary(self, model: str, version: str,
                     weight: float | None = None) -> dict[str, Any]:
        """Open a canary: ``version`` takes ``weight`` of ``model``'s
        plain-name traffic (default SPARKNET_ROLLOUT_CANARY_FRACTION)."""
        ch = self.registry.channels(model)
        if ch["stable"] is None:
            raise RolloutError(
                f"model {model!r} has no stable version to canary "
                f"against — set the stable channel first (a canary with "
                f"no baseline has nothing to roll back TO)")
        if ch["stable"] == version:
            raise RolloutError(
                f"model {model!r}: version {version} IS the stable "
                f"version — nothing to roll out")
        if ch["canary"] is not None and ch["canary"] != version:
            raise RolloutError(
                f"model {model!r} already has canary {ch['canary']} in "
                f"flight — promote or roll it back first")
        self.registry.manifest(model, version)   # typed when unpublished
        w = self.cfg.fraction if weight is None else float(weight)
        self._log("canary_begin", model, version=version, weight=w,
                  stable=ch["stable"])
        self._apply_canary(model, ch["stable"], version, w)
        self._log("canary_live", model, version=version, weight=w,
                  stable=ch["stable"])
        self._streak[model] = 0
        self._healthy_since.pop(model, None)
        return {"model": model, "stable": ch["stable"], "canary": version,
                "weight": w}

    def _apply_canary(self, model: str, stable: str, canary: str,
                      weight: float) -> None:
        self.ensure(versioned(model, stable))
        self.ensure(versioned(model, canary))
        self.registry.set_channels(model, stable=stable, canary=canary,
                                   weight=weight)
        if self.router is not None:
            self.router.set_rollout(RolloutState(
                model=model, stable=stable, canary=canary, weight=weight))

    def judge(self, model: str) -> str:
        """One judge poll: ``"canary"`` (keep watching), ``"promote"``
        (sustained health), or ``"rollback"`` (sustained breach)."""
        ch = self.registry.channels(model)
        if ch["canary"] is None:
            raise RolloutError(f"model {model!r} has no canary in "
                               f"flight — nothing to judge")
        name = versioned(model, ch["canary"])
        v = self.verdict(name)
        violations = list(self.bands(name)) if self.bands else []
        state = "none" if v is None else v.get("state", "none")
        breach = state == "breach" or bool(violations)
        if self._last_verdict.get(model) != (state, bool(violations)):
            # journal verdict TRANSITIONS only (a long canary must not
            # grow the journal by poll count)
            self._last_verdict[model] = (state, bool(violations))
            self._log("judge", model, version=ch["canary"], state=state,
                      band_violations=len(violations))
        if breach:
            self._streak[model] = self._streak.get(model, 0) + 1
            self._healthy_since.pop(model, None)
            if self._streak[model] >= self.cfg.breach_polls:
                return "rollback"
            return "canary"
        self._streak[model] = 0
        now = self._clock()
        since = self._healthy_since.setdefault(model, now)
        windows = (v or {}).get("windows") or {}
        seen = max(int((windows.get("slow") or {}).get("requests", 0)),
                   int((windows.get("fast") or {}).get("requests", 0)))
        if now - since >= self.cfg.judge_s and seen >= self.cfg.min_requests:
            return "promote"
        return "canary"

    def promote(self, model: str) -> dict[str, Any]:
        """The canary becomes stable; the old stable drains away."""
        ch = self.registry.channels(model)
        if ch["canary"] is None:
            raise RolloutError(f"model {model!r} has no canary in "
                               f"flight — nothing to promote")
        self._log("promote_begin", model, version=ch["canary"],
                  stable=ch["stable"])
        self._apply_promote(model, ch["stable"], ch["canary"])
        self._log("promote_done", model, version=ch["canary"],
                  stable=ch["canary"])
        return self.registry.channels(model)

    def _apply_promote(self, model: str, old_stable: str | None,
                       canary: str) -> None:
        self.ensure(versioned(model, canary))  # before the pointer moves
        self.registry.set_channels(model, stable=canary, canary=None,
                                   weight=0.0)
        if self.router is not None:
            # stable-only state stays installed: in a fully versioned
            # fleet the plain name must keep resolving to SOME version
            self.router.set_rollout(RolloutState(model=model,
                                                 stable=canary))
        if old_stable and old_stable != canary:
            self.retire(versioned(model, old_stable))

    def rollback(self, model: str, reason: str) -> dict[str, Any]:
        """Traffic off, pointer reverted, canary drained, evidence kept
        (flight dump) — in that order."""
        ch = self.registry.channels(model)
        if ch["canary"] is None:
            raise RolloutError(f"model {model!r} has no canary in "
                               f"flight — nothing to roll back")
        self._log("rollback_begin", model, version=ch["canary"],
                  stable=ch["stable"], reason=reason)
        self._apply_rollback(model, ch["stable"], ch["canary"], reason)
        self._log("rollback_done", model, version=ch["canary"],
                  stable=ch["stable"], reason=reason)
        return self.registry.channels(model)

    def _apply_rollback(self, model: str, stable: str | None,
                        canary: str | None, reason: str) -> None:
        if self.router is not None:
            # stop the bleeding FIRST: pending placements go all-stable
            # before the durable pointer or the drain move (the
            # stable-only state stays installed so the plain name keeps
            # resolving in a fully versioned fleet)
            if stable:
                self.router.set_rollout(RolloutState(model=model,
                                                     stable=stable))
            else:
                self.router.clear_rollout(model)
        self.registry.set_channels(model, canary=None, weight=0.0)
        if canary:
            self.retire(versioned(model, canary))
        rec = telemetry.get_recorder()
        rec.record("rollout_rollback", model=model, version=canary,
                   reason=reason)
        rec.dump("rollout_rollback")   # the evidence survives us
        self._streak.pop(model, None)
        self._healthy_since.pop(model, None)

    # -- recovery ---------------------------------------------------------
    def resume(self) -> dict[str, str]:
        """Replay the journal to a consistent terminal state per model
        (see module docstring); returns ``{model: action}`` where action
        is ``"promoted"`` / ``"rolled_back"`` / ``"consistent"``."""
        out: dict[str, str] = {}
        for model, st in replay(self.path).items():
            if st["phase"] == "promoting":
                # the decision to promote was durably made: finish it
                self._apply_promote(model, st["stable"], st["canary"])
                self._log("promote_done", model, version=st["canary"],
                          stable=st["canary"], resumed=True)
                out[model] = "promoted"
            elif st["phase"] in ("canary_starting", "canary",
                                 "rolling_back"):
                # nobody was judging while we were dead — an unjudged
                # canary must not keep taking traffic
                reason = (st.get("last_rollback_reason")
                          or "controller death mid-canary")
                self._apply_rollback(model, st["stable"], st["canary"],
                                     reason)
                self._log("rollback_done", model, version=st["canary"],
                          stable=st["stable"], reason=reason,
                          resumed=True)
                out[model] = "rolled_back"
            else:
                out[model] = "consistent"
        return out

    # -- the closed loop --------------------------------------------------
    def run(self, model: str, version: str, weight: float | None = None,
            timeout_s: float | None = None) -> str:
        """start_canary + judge-poll until terminal.  Returns
        ``"promoted"`` or ``"rolled_back"``; a timeout rolls back (an
        undecidable canary is a failed canary)."""
        self.start_canary(model, version, weight)
        deadline = (None if timeout_s is None
                    else self._clock() + timeout_s)
        while True:
            d = self.judge(model)
            if d == "promote":
                self.promote(model)
                return "promoted"
            if d == "rollback":
                self.rollback(model,
                              reason=f"sustained SLO breach "
                                     f"({self.cfg.breach_polls} polls)")
                return "rolled_back"
            if deadline is not None and self._clock() > deadline:
                self.rollback(model, reason="judge timeout — canary "
                                            "never became promotable")
                return "rolled_back"
            time.sleep(self.cfg.poll_s)


# ---------------------------------------------------------------------------
# Journal replay (also the offline-status path: works with the
# controller dead, which is exactly when status matters most)
# ---------------------------------------------------------------------------

def _read_journal(path: str):
    try:
        f = open(path)
    except OSError:
        return
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                return   # torn tail: everything before it still counts
            if isinstance(rec, dict):
                yield rec


def replay(path: str) -> dict[str, dict[str, Any]]:
    """Fold ``rollout.jsonl`` into per-model channel state:
    ``{model: {phase, stable, canary, weight, last_verdict,
    last_rollback_reason, events}}``.  Unknown events are skipped (a
    newer controller's journal still replays for status)."""
    out: dict[str, dict[str, Any]] = {}
    for rec in _read_journal(path):
        m = rec.get("model")
        if not m:
            continue
        st = out.setdefault(m, {
            "phase": "idle", "stable": None, "canary": None,
            "weight": 0.0, "last_verdict": None,
            "last_rollback_reason": None, "events": 0})
        st["events"] += 1
        ev = rec.get("ev")
        if ev == "canary_begin":
            st.update(phase="canary_starting", canary=rec.get("version"),
                      stable=rec.get("stable", st["stable"]),
                      weight=rec.get("weight", 0.0))
        elif ev == "canary_live":
            st["phase"] = "canary"
        elif ev == "judge":
            st["last_verdict"] = rec.get("state")
        elif ev == "promote_begin":
            st["phase"] = "promoting"
        elif ev == "promote_done":
            st.update(phase="stable",
                      stable=rec.get("stable", st["canary"]),
                      canary=None, weight=0.0)
        elif ev == "rollback_begin":
            st["phase"] = "rolling_back"
            st["last_rollback_reason"] = rec.get("reason")
        elif ev == "rollback_done":
            st.update(phase="stable", canary=None, weight=0.0,
                      last_rollback_reason=rec.get(
                          "reason", st["last_rollback_reason"]))
    return out


def status(workdir: str) -> dict[str, dict[str, Any]] | None:
    """The rollout section for ``tools/fleet.py status``: journal-replayed
    per-model channel state, or None when this workdir never rolled
    anything out."""
    state = replay(os.path.join(os.path.abspath(workdir), JOURNAL))
    return state or None
