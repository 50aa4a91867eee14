"""Resilient job supervision: the recovery half of Spark's fault
tolerance.

The port's own copy of ``sparknet_tpu/parallel/resilience.py``.  The
reference inherited fail-fast from Spark (a dead executor fails the
stage; ``spark.task.maxFailures`` is pinned to 1 at CifarApp.scala:36)
and the driver's reschedule.  The launcher (``tools/launch.py``)
reproduces fail-fast; this module is the reschedule half, in two tiers.

**Restart**: ``ResilientRunner`` wraps ``launch_local`` (``nprocs=``) or
``launch_ssh`` (``hosts=``, over a host transport), watches the
worker set, and on any nonzero exit relaunches the whole job with
jittered exponential backoff under a bounded restart budget.  Recovery is
round-granular: the relaunched job finds the newest valid checkpoint
manifest (``DistributedTrainer``'s ``checkpoint_dir`` resume) and replays
from that round boundary.

**Re-form (elastic degraded mode)**: with an ``ElasticPolicy`` a job
whose restart budget is spent on the same failing rank drops the culprit
and relaunches on the survivors, a fresh *incarnation* with a fresh
budget and a smaller world, down to ``min_workers``; a ``rejoin_probe``
lets a dropped slot re-enter at the next relaunch boundary.  With a
``host_map`` (one host label per rank, the fleet's placement channel) a
whole host's death is one event: a ``host_down_probe`` (the HostPool's
marked state) or two distinct failed ranks on one multi-rank host drop
all of that host's ranks in one re-form.

Every (re)launch is stamped with SPARKNET_FAULT_ATTEMPT /
SPARKNET_RESTART_COUNT (a global attempt counter, so one-shot injected
faults stay one-shot across re-forms) and SPARKNET_INCARNATION, and, under
a fleet's SPARKNET_FENCE_BASE, the incarnation fence token.  Each attempt
runs with a per-rank log tee and a heartbeat dir, so the final failure
(``run_or_raise`` / ``.failure``) names the culprit rank with the tail of
its log and the age of its last heartbeat.

With ``hosts=`` each attempt runs one rank a host through ``launch_ssh``
(``transport=``, or the one the env names): the ssh wire format, beats
staged on the host and relayed, and lease discipline, so a partitioned
host is suspended rather than restarted; an elastic re-form drops the
host itself.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import random
import sys
import tempfile
import time
from typing import Callable

from ..tools.launch import EXIT_STRAGGLER, free_port, launch_local, launch_ssh
from ..utils import telemetry
from . import health

LOG_TAIL_BYTES = 2048


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Bounded restarts with jittered exponential backoff — the
    ``spark.task.maxFailures`` contract plus the backoff Spark's DAG
    scheduler applies between stage reattempts.  ``jitter`` spreads each
    delay over ±``jitter``·delay so simultaneously-dead jobs don't
    relaunch (and re-dial the coordinator) in lockstep; set 0.0 for
    deterministic schedules in tests."""

    max_restarts: int = 3          # total attempts = max_restarts + 1
    backoff_base: float = 1.0      # seconds before the first restart
    backoff_factor: float = 2.0
    backoff_max: float = 60.0
    jitter: float = 0.2

    def delay(self, restart_idx: int,
              rng: random.Random | None = None) -> float:
        """Sleep before restart #``restart_idx`` (0-based)."""
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter must be in [0, 1), got {self.jitter}")
        d = min(self.backoff_base * self.backoff_factor ** restart_idx,
                self.backoff_max)
        if self.jitter:
            r = (rng or random).random()
            d *= 1.0 + self.jitter * (2.0 * r - 1.0)
        return d


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """When to re-form instead of die.  ``enabled=False`` reproduces the
    pre-elastic contract exactly: budget exhausted → give up."""

    enabled: bool = False
    min_workers: int = 1           # never shrink below this many


@dataclasses.dataclass(frozen=True)
class Attempt:
    index: int                     # global attempt counter
    returncode: int
    duration_s: float
    incarnation: int = 0           # which world membership this ran under
    world: int = 0                 # worker count of that membership
    first_failure: int | None = None   # rank attribution (None = unknown)
    cause: str = ""                # "exit" | "straggler" | "timeout" | ...


class ResilienceError(RuntimeError):
    """A supervised job failed for good.  Carries the post-mortem: the
    culprit rank, its exit code and failure cause, the tail of its log,
    and the age of its last heartbeat when the job died."""

    def __init__(self, message: str, *, returncode: int,
                 rank: int | None = None, cause: str = "",
                 log_tail: str | None = None,
                 heartbeat_age: float | None = None):
        parts = [message]
        if heartbeat_age is not None:
            parts.append(f"last heartbeat {heartbeat_age:.1f}s before "
                         f"teardown")
        if log_tail:
            parts.append(f"--- tail of rank {rank} log ---\n{log_tail}")
        super().__init__("\n".join(parts))
        self.returncode = returncode
        self.rank = rank
        self.cause = cause
        self.log_tail = log_tail
        self.heartbeat_age = heartbeat_age


class ResilientRunner:
    """Launch a multi-process training job and keep it alive.

    Exactly one of ``nprocs`` (local mode) or ``hosts`` (ssh mode) must be
    given — the same split as ``tools.launch``.  ``run()`` returns the
    final exit code: 0 once any attempt completes, else the last failing
    code after the restart budget (and any elastic re-forms) are spent —
    with the post-mortem in ``.failure``.  ``run_or_raise()`` raises that
    post-mortem instead.  ``attempts`` records every try.

    ``round_deadline`` (seconds) arms the straggler detector: every
    attempt runs with a heartbeat dir, and a rank that beat once then
    went silent past the deadline is killed (exit ``EXIT_STRAGGLER``)
    and the job relaunched from checkpoint — a hung rank costs one
    deadline, not the global ``timeout``.
    """

    def __init__(self, cmd: list[str], *,
                 nprocs: int | None = None,
                 hosts: list[str] | None = None,
                 device: str | None = None,
                 local_devices: int | None = None,
                 cwd: str | None = None,
                 timeout: float | None = None,
                 policy: RestartPolicy | None = None,
                 elastic: ElasticPolicy | None = None,
                 rejoin_probe: Callable[[int | str], bool] | None = None,
                 round_deadline: float | None = None,
                 workdir: str | None = None,
                 extra_env: dict | None = None,
                 sleep: Callable[[float], None] = time.sleep,
                 jitter_rng: random.Random | None = None,
                 host_map: list | None = None,
                 host_down_probe: Callable[[str], bool] | None = None,
                 host_suspect_probe: Callable[[str], bool] | None = None,
                 transport=None,
                 on_spawn: Callable[[list], None] | None = None):
        if (nprocs is None) == (hosts is None):
            raise ValueError("exactly one of nprocs / hosts is required")
        self.cmd = list(cmd)
        self.nprocs = nprocs
        self.hosts = list(hosts) if hosts else None
        self.device = device
        self.local_devices = local_devices
        self.cwd = cwd
        self.timeout = timeout
        self.policy = policy or RestartPolicy()
        self.elastic = elastic or ElasticPolicy()
        self.rejoin_probe = rejoin_probe
        self.round_deadline = round_deadline
        self.extra_env = dict(extra_env or {})
        self._sleep = sleep
        self._rng = jitter_rng or random.Random()
        self.workdir = workdir or tempfile.mkdtemp(prefix="sparknet-job-")
        self.on_spawn = on_spawn
        self.attempts: list[Attempt] = []
        self.canceled = False
        self.incarnation = 0
        self.dropped: list[int | str] = []   # host names (ssh) / slots
        self.dropped_hosts: list[str] = []   # whole hosts out of the world
        self._drop_counts: dict[int | str, int] = {}
        self._host_members: dict[str, dict] = {}   # for bulk rejoin
        self._pending_host_drop: str | None = None
        self.host_map = [str(h) for h in host_map] if host_map else None
        self.host_down_probe = host_down_probe
        self.host_suspect_probe = host_suspect_probe
        self.transport = transport
        if self.host_map is not None and len(self.host_map) != \
                self.world_size():
            raise ValueError(
                f"host_map has {len(self.host_map)} entries for a world "
                f"of {self.world_size()}")
        self.failure: ResilienceError | None = None
        if self.elastic.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.elastic.min_workers}")

    # -- world membership -------------------------------------------------
    def world_size(self) -> int:
        return len(self.hosts) if self.hosts is not None else self.nprocs

    def _drop(self, culprit_rank: int) -> int | str:
        """Shrink the world by the culprit; returns the dropped slot."""
        if self.hosts is not None:
            slot: int | str = self.hosts.pop(culprit_rank)
        else:
            self.nprocs -= 1
            slot = self.nprocs          # local slots are fungible
        if self.host_map is not None:
            self.host_map.pop(culprit_rank)
        self.dropped.append(slot)
        self._drop_counts[slot] = self._drop_counts.get(slot, 0) + 1
        return slot

    def _drop_host(self, host: str) -> int:
        """Remove EVERY rank placed on ``host`` in one re-form; returns
        how many ranks left the world.  One host death is one membership
        event: it costs one drop-count strike (for the rejoin guard), not
        one per rank."""
        idxs = [i for i, h in enumerate(self.host_map) if h == host]
        members: dict = {"n": len(idxs)}
        if self.hosts is not None:
            members["addrs"] = [self.hosts[i] for i in idxs]
        for i in reversed(idxs):
            if self.hosts is not None:
                self.hosts.pop(i)
            self.host_map.pop(i)
        if self.hosts is None:
            self.nprocs -= len(idxs)
        self._host_members[host] = members
        self.dropped_hosts.append(host)
        self._drop_counts[host] = self._drop_counts.get(host, 0) + 1
        return len(idxs)

    def _rejoin_one(self, slot) -> bool:
        """Probe ``slot`` (a rank slot or a host label); True = readmit."""
        try:
            return bool(self.rejoin_probe(slot))
        except Exception as e:   # a probe that dies means "not yet"
            print(f"resilience: rejoin probe for {slot!r} failed: {e}",
                  file=sys.stderr, flush=True)
            return False

    def _maybe_rejoin(self) -> None:
        """Re-admit dropped slots/hosts whose probe passes — the relaunch
        boundary is the only membership boundary an SPMD job has, so a
        recovered host rejoins here, at the next incarnation.  A host
        dropped whole (``_drop_host``) rejoins whole: all its ranks come
        back in one membership change."""
        if self.rejoin_probe is None:
            return
        still_out = []
        for slot in self.dropped:
            if self._drop_counts.get(slot, 0) >= 2:
                # two strikes: a slot that failed again after rejoining is
                # out for good — an always-True probe against a still-broken
                # host must not livelock the drop/rejoin cycle
                still_out.append(slot)
                continue
            if self._rejoin_one(slot):
                print(f"resilience: {slot!r} rejoins the job",
                      file=sys.stderr, flush=True)
                if self.hosts is not None:
                    self.hosts.append(str(slot))
                else:
                    self.nprocs += 1
                if self.host_map is not None:
                    self.host_map.append(str(slot))
            else:
                still_out.append(slot)
        self.dropped = still_out
        still_out_hosts = []
        for host in self.dropped_hosts:
            if self._drop_counts.get(host, 0) >= 2:
                still_out_hosts.append(host)
                continue
            if self._rejoin_one(host):
                members = self._host_members.get(host, {"n": 1})
                if self.hosts is not None:
                    addrs = members.get("addrs") or [host]
                    self.hosts.extend(addrs)
                    self.host_map.extend([host] * len(addrs))
                else:
                    self.nprocs += members["n"]
                    self.host_map.extend([host] * members["n"])
                print(f"resilience: host {host!r} rejoins with "
                      f"{members['n']} rank(s)", file=sys.stderr, flush=True)
            else:
                still_out_hosts.append(host)
        self.dropped_hosts = still_out_hosts

    # -- one attempt ------------------------------------------------------
    def _attempt_dir(self, attempt: int) -> str:
        d = os.path.join(self.workdir, f"attempt_{attempt:03d}")
        os.makedirs(d, exist_ok=True)
        return d

    def _launch_once(self, attempt: int, report: dict) -> int:
        env = dict(self.extra_env)
        env["SPARKNET_FAULT_ATTEMPT"] = str(attempt)
        env["SPARKNET_RESTART_COUNT"] = str(attempt)
        env["SPARKNET_INCARNATION"] = str(self.incarnation)
        # incarnation fence token: fleet episode base + attempt, strictly
        # increasing across every relaunch of the same logical job — the
        # checkpoint layer uses it to refuse zombie writers (only when a
        # fleet-level base is present; standalone runners stay unfenced)
        base = self.extra_env.get("SPARKNET_FENCE_BASE")
        if base:
            env["SPARKNET_FENCE_TOKEN"] = str(int(base) + attempt)
        adir = self._attempt_dir(attempt)
        health_kw = dict(
            heartbeat_dir=os.path.join(adir, "hb"),
            round_deadline=self.round_deadline,
            log_dir=os.path.join(adir, "logs"),
            report=report,
            host_map=list(self.host_map) if self.host_map else None,
            on_spawn=self.on_spawn)
        if self.hosts is not None:
            return launch_ssh(self.cmd, self.hosts,
                              coordinator_port=free_port(),
                              cwd=self.cwd, timeout=self.timeout,
                              device=self.device,
                              local_devices=self.local_devices,
                              extra_env=env, transport=self.transport,
                              host_suspect_probe=self.host_suspect_probe,
                              host_down_probe=self.host_down_probe,
                              **health_kw)
        return launch_local(self.cmd, self.nprocs, device=self.device,
                            local_devices=self.local_devices,
                            coordinator=f"127.0.0.1:{free_port()}",
                            timeout=self.timeout, extra_env=env,
                            **health_kw)

    # -- post-mortem helpers ----------------------------------------------
    def _log_tail(self, attempt: int, rank: int) -> str | None:
        path = os.path.join(self._attempt_dir(attempt), "logs",
                            f"rank_{rank}.log")
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(size - LOG_TAIL_BYTES, 0))
                return f.read().decode(errors="replace")
        except OSError:
            return None

    def _heartbeat_age(self, attempt: int, rank: int) -> float | None:
        beat = health.read_beat(
            os.path.join(self._attempt_dir(attempt), "hb"), rank)
        return None if beat is None else beat.age()

    def _build_failure(self, rc: int) -> ResilienceError:
        last = self.attempts[-1]
        rank = last.first_failure
        cause = last.cause or "exit"
        what = {"straggler": "was killed as hung (missed the round "
                             "deadline)",
                "timeout": "hit the global job timeout"}.get(
            cause, f"exited rc={last.returncode}")
        msg = (f"job failed for good after {len(self.attempts)} attempts "
               f"across {self.incarnation + 1} incarnation(s); "
               + (f"rank {rank} {what}" if rank is not None
                  else f"last attempt {what} (no rank attribution)"))
        log_tail = hb_age = None
        if rank is not None:
            log_tail = self._log_tail(last.index, rank)
            hb_age = self._heartbeat_age(last.index, rank)
        return ResilienceError(msg, returncode=rc, rank=rank, cause=cause,
                               log_tail=log_tail, heartbeat_age=hb_age)

    def _culprit(self) -> int | None:
        """Rank attribution for the just-exhausted incarnation: the most
        frequently failing rank among its attempts (None when the
        launcher produced no attribution — e.g. a global timeout)."""
        ranks = [a.first_failure for a in self.attempts
                 if a.incarnation == self.incarnation
                 and a.first_failure is not None]
        if not ranks:
            return None
        return collections.Counter(ranks).most_common(1)[0][0]

    def _down_host(self, report: dict) -> str | None:
        """Host attribution for the attempt that just failed.  Primary
        channel: ``host_down_probe`` confirms the first-failing rank's
        host is down (the HostPool's marked state — authoritative after a
        single failed attempt).  Secondary, probe-less heuristic: two
        DISTINCT failed ranks in this incarnation on the same multi-rank
        host — exit codes can't separate a host-killed rank from a
        launcher-killed survivor (both -9), but two different first
        deaths on one host can't be a single bad rank."""
        if self.host_map is None:
            return None
        ff = report.get("first_failure")
        if (ff is not None and ff < len(self.host_map)
                and self.host_down_probe is not None):
            host = self.host_map[ff]
            try:
                if self.host_down_probe(host):
                    return host
            except Exception as e:   # a dead probe means "no verdict"
                print(f"resilience: host_down_probe({host!r}) failed: {e}",
                      file=sys.stderr, flush=True)
        ranks = {a.first_failure for a in self.attempts
                 if a.incarnation == self.incarnation
                 and a.first_failure is not None}
        if len(ranks) >= 2:
            hosts = {self.host_map[r] for r in ranks
                     if r < len(self.host_map)}
            if len(hosts) == 1:
                host = hosts.pop()
                if sum(1 for h in self.host_map if h == host) >= 2:
                    return host
        return None

    # -- cancellation (fleet preemption) ----------------------------------
    def cancel(self) -> None:
        """Stop supervising: no further restarts or re-forms after the
        current attempt exits (and none at all if called between
        attempts).  The runner does NOT kill the live workers itself — it
        has handed their handles to ``on_spawn`` and the canceling
        supervisor owns the signalling (SIGTERM for a graceful
        preemption, SIGKILL past the grace window).  After a cancel,
        ``run()`` returns the last attempt's code without building a
        post-mortem: a canceled job is preempted, not failed."""
        self.canceled = True

    # -- the supervision loop ---------------------------------------------
    def _run_incarnation(self, attempt_base: int) -> int:
        """One full restart budget at the current world size; returns the
        last exit code (0 = recovered)."""
        rc = 0
        for i in range(self.policy.max_restarts + 1):
            if self.canceled:
                return rc
            attempt = attempt_base + i
            report: dict = {}
            t0 = time.monotonic()
            rc = self._launch_once(attempt, report)
            self.attempts.append(Attempt(
                attempt, rc, time.monotonic() - t0,
                incarnation=self.incarnation, world=self.world_size(),
                first_failure=report.get("first_failure"),
                cause=report.get("cause", "")))
            if rc != 0:
                telemetry.get_recorder().record(
                    "restart", attempt=attempt, rc=rc,
                    cause=report.get("cause", "exit"),
                    rank=report.get("first_failure"),
                    incarnation=self.incarnation)
                telemetry.get_registry().counter(
                    "resilience_restarts_total",
                    "supervised job attempts that failed and restarted"
                ).inc(cause=report.get("cause") or "exit")
            if rc == 0:
                if attempt:
                    print(f"resilience: job recovered on attempt "
                          f"{attempt + 1}", file=sys.stderr, flush=True)
                return 0
            if self.canceled:
                return rc
            host = self._down_host(report)
            if host is not None:
                # the whole host died — burning the rest of this
                # incarnation's budget re-dialing a dead machine is waste
                # (and charging R ranks R units for one event is the
                # budget bug this guards): hand straight to run() for one
                # host-granular re-form
                self._pending_host_drop = host
                print(f"resilience: host {host!r} is down (attempt "
                      f"{attempt + 1}); skipping remaining restarts for a "
                      f"host-granular re-form", file=sys.stderr, flush=True)
                return rc
            if rc == EXIT_STRAGGLER:
                print(f"resilience: rank "
                      f"{report.get('first_failure', '?')} missed the "
                      f"round deadline; relaunching from checkpoint",
                      file=sys.stderr, flush=True)
            if i < self.policy.max_restarts:
                delay = self.policy.delay(i, self._rng)
                print(f"resilience: attempt {attempt + 1} failed rc={rc}; "
                      f"restarting from latest checkpoint in {delay:.2g}s "
                      f"({self.policy.max_restarts - i} restarts left in "
                      f"incarnation {self.incarnation})",
                      file=sys.stderr, flush=True)
                self._sleep(delay)
        return rc

    def run(self) -> int:
        """Supervise to completion.  Returns the final exit code; a
        nonzero return leaves the post-mortem in ``self.failure``."""
        while True:
            self._maybe_rejoin()
            rc = self._run_incarnation(len(self.attempts))
            if rc == 0:
                return 0
            if self.canceled:
                # preempted, not failed: no post-mortem, no re-form — the
                # canceling supervisor decides what happens to the job
                return rc
            host = self._pending_host_drop
            self._pending_host_drop = None
            if host is not None and self.elastic.enabled:
                n = sum(1 for h in (self.host_map or []) if h == host)
                if n and self.world_size() - n >= self.elastic.min_workers:
                    self._drop_host(host)
                    self.incarnation += 1
                    telemetry.get_recorder().record(
                        "reform", dropped=host, host=True, ranks=n,
                        world=self.world_size(),
                        incarnation=self.incarnation)
                    print(f"resilience: dropping host {host!r} ({n} "
                          f"rank(s)) in ONE re-form; continuing with "
                          f"{self.world_size()} survivors (incarnation "
                          f"{self.incarnation})", file=sys.stderr,
                          flush=True)
                    continue
            culprit = self._culprit()
            survivors = self.world_size() - 1
            if (self.elastic.enabled and culprit is not None
                    and survivors >= self.elastic.min_workers):
                slot = self._drop(culprit)
                self.incarnation += 1
                telemetry.get_recorder().record(
                    "reform", dropped=str(slot), world=self.world_size(),
                    incarnation=self.incarnation)
                print(f"resilience: restart budget exhausted on "
                      f"{slot!r}; re-forming with {self.world_size()} "
                      f"survivors (incarnation {self.incarnation}) — the "
                      f"average over the survivors is still a valid "
                      f"consensus", file=sys.stderr, flush=True)
                continue
            self.failure = self._build_failure(rc)
            rec = telemetry.get_recorder()
            rec.record("resilience_error", rc=rc, rank=self.failure.rank,
                       cause=self.failure.cause,
                       attempts=len(self.attempts),
                       incarnations=self.incarnation + 1)
            rec.dump("resilience_error")
            print(f"resilience: giving up rc={rc}: {self.failure}",
                  file=sys.stderr, flush=True)
            return rc

    def run_or_raise(self) -> int:
        """Like :meth:`run`, but a final failure raises the
        :class:`ResilienceError` post-mortem (culprit rank, log tail,
        heartbeat age) instead of returning an opaque exit code."""
        rc = self.run()
        if rc != 0:
            if self.failure is None:   # canceled mid-flight: no post-mortem
                raise ResilienceError(
                    f"job canceled with last exit rc={rc}", returncode=rc,
                    cause="canceled")
            raise self.failure   # always set on nonzero uncanceled return
        return rc
