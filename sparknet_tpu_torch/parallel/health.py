"""Liveness beacons: per-rank heartbeat files.

The port's own copy of the beacon half of ``sparknet_tpu/parallel/
health.py`` (:57-218).  A process publishes a small JSON heartbeat file
per rank (``hb_rank_<R>.json``), replaced atomically through a temporary
name and ``os.replace``, so a reader never sees a torn write.  The
serving engine beats from a thread of its own while
``SPARKNET_HEARTBEAT_DIR`` is set (``parallel/serving.py``), its extras
carrying queue depth, in-flight work, latency percentiles and the SLO
summary; ``read_all``/``read_hosts``/``rollup_hosts`` read a beacon tree
back, per-host subdirectories ``host_<name>/`` included.

Env contract (consumed by ``maybe_beat`` and the serving beacons):
  SPARKNET_HEARTBEAT_DIR: where to publish; unset = beacons off.
  SPARKNET_PROC_ID:       the rank stamped into the beat.
  SPARKNET_FAULT_ATTEMPT: the job attempt stamped into the beat.

Ages compare the reader's clock against the writer's.

The supervisor half turns beat ages into verdicts: ``StragglerMonitor``
names the live ranks whose last beat is older than a per-round deadline
(a rank that never beat is never flagged: startup is the job timeout's
business), ``LeaseMonitor`` calls a host SUSPECT when its newest beat
across all ranks is older than ``lease_window_s``, and ``GangHealth``
combines the two so a silent host's ranks are suspended rather than
killed.  ``tools/launch.py`` runs the straggler monitor; ``GangHealth``
serves a launcher over remote hosts (the pod half); the fleet's status
views read the lease window.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Callable

from ..utils import knobs

HB_PREFIX = "hb_rank_"
HOST_DIR_PREFIX = "host_"
ENV_DIR = "SPARKNET_HEARTBEAT_DIR"


@dataclasses.dataclass(frozen=True)
class Heartbeat:
    rank: int
    round: int
    phase: str          # "init" | "round_start" | "round_end" | "final"
                        # | "feed_stalled" (the prefetch watchdog's
                        # attribution beat: the worker is ALIVE, its data
                        # feed is the culprit — see data.prefetch)
    time: float         # writer's epoch seconds
    pid: int
    attempt: int
    # optional free-form telemetry riding the beat (JSON-serializable):
    # the trainer publishes its per-component host-stall accounting
    # (``stall_s``) and the feed pipeline's ``FeedStats`` snapshot here,
    # which is how the fleet status view sees inside a running job
    # without any extra channel.  Older beats simply lack it.
    extras: dict | None = None

    def age(self, now: float | None = None) -> float:
        return (time.time() if now is None else now) - self.time


def beat_path(directory: str, rank: int) -> str:
    return os.path.join(directory, f"{HB_PREFIX}{rank}.json")


def write_beat(directory: str, rank: int, round_idx: int, phase: str,
               attempt: int = 0, *, clock: Callable[[], float] = time.time,
               extras: dict | None = None) -> None:
    """Publish rank ``rank``'s beat — atomic replace, never a torn read."""
    os.makedirs(directory, exist_ok=True)
    beat = {"rank": rank, "round": round_idx, "phase": phase,
            "time": clock(), "pid": os.getpid(), "attempt": attempt}
    if extras:
        beat["extras"] = extras
    path = beat_path(directory, rank)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(beat, f)
    os.replace(tmp, path)


def read_beat(directory: str, rank: int) -> Heartbeat | None:
    """The newest beat for ``rank``, or None when absent/unreadable (a
    missing beacon is 'no data', never an exception — the monitor decides
    what silence means)."""
    try:
        with open(beat_path(directory, rank)) as f:
            d = json.load(f)
        extras = d.get("extras")
        return Heartbeat(rank=int(d["rank"]), round=int(d["round"]),
                         phase=str(d["phase"]), time=float(d["time"]),
                         pid=int(d["pid"]), attempt=int(d["attempt"]),
                         extras=extras if isinstance(extras, dict) else None)
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None


def _read_flat(directory: str) -> dict[int, Heartbeat]:
    beats: dict[int, Heartbeat] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return beats
    for name in names:
        if not (name.startswith(HB_PREFIX) and name.endswith(".json")):
            continue
        try:
            rank = int(name[len(HB_PREFIX):-len(".json")])
        except ValueError:
            continue
        beat = read_beat(directory, rank)
        if beat is not None:
            beats[rank] = beat
    return beats


def host_dir(root: str, host: str) -> str:
    """The per-host beacon subdirectory for ``host`` under ``root``."""
    return os.path.join(root, f"{HOST_DIR_PREFIX}{host}")


def read_all(directory: str) -> dict[int, Heartbeat]:
    """Every rank's newest beat under ``directory`` — flat beats plus any
    ``host_<name>/`` subdirectories a multi-host launch created.  Ranks
    are globally numbered across hosts, so folding is collision-free."""
    beats = _read_flat(directory)
    for hdir in host_beat_dirs(directory).values():
        beats.update(_read_flat(hdir))
    return beats


def host_beat_dirs(root: str) -> dict[str, str]:
    """host name -> its beacon subdirectory (only dirs that exist)."""
    out: dict[str, str] = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in sorted(names):
        if not name.startswith(HOST_DIR_PREFIX):
            continue
        path = os.path.join(root, name)
        if os.path.isdir(path):
            out[name[len(HOST_DIR_PREFIX):]] = path
    return out


def read_hosts(root: str) -> dict[str | None, dict[int, Heartbeat]]:
    """Beats grouped by host (the ``host_<name>/`` layout).  Flat beats —
    a single-host launch, or pre-pod attempts — land under the ``None``
    key; callers render that as the local/unplaced group."""
    out: dict[str | None, dict[int, Heartbeat]] = {}
    flat = _read_flat(root)
    if flat:
        out[None] = flat
    for host, hdir in host_beat_dirs(root).items():
        beats = _read_flat(hdir)
        if beats:
            out[host] = beats
    return out


def rollup_hosts(root: str, *, deadline_s: float | None = None,
                 now: float | None = None) -> dict[str, dict]:
    """Per-host liveness summary over the beacon tree: rank count, the
    newest/oldest beat ages, the round span, and — when ``deadline_s``
    is given — a ``silent`` verdict (every rank's beat is older than the
    deadline).  The fleet status views fold this per attempt; a host
    with no beats simply has no row (absence of evidence is not a
    verdict here — the HostPool's marked state is the authority)."""
    now = time.time() if now is None else now
    out: dict[str, dict] = {}
    for host, beats in read_hosts(root).items():
        ages = [b.age(now) for b in beats.values()]
        rounds = [b.round for b in beats.values()]
        entry: dict = {
            "ranks": sorted(beats),
            "newest_age_s": round(min(ages), 2),
            "oldest_age_s": round(max(ages), 2),
            "round_min": min(rounds),
            "round_max": max(rounds),
        }
        if deadline_s is not None:
            entry["silent"] = min(ages) > deadline_s
        out["local" if host is None else host] = entry
    return out


def maybe_beat(round_idx: int, phase: str = "round_start",
               extras: dict | None = None) -> None:
    """Worker-side hook: publish a beat iff SPARKNET_HEARTBEAT_DIR is set.
    Deliberately swallow-nothing-raise-nothing is NOT the contract — a
    beacon dir that exists but is unwritable should fail loudly (it means
    the supervisor will kill us as hung)."""
    directory = knobs.raw(ENV_DIR)
    if not directory:
        return
    write_beat(directory, knobs.get_int("SPARKNET_PROC_ID", 0),
               round_idx, phase,
               attempt=knobs.get_int("SPARKNET_FAULT_ATTEMPT", 0),
               extras=extras)


def lease_window_s(lease_s: float | None = None,
                   misses: int | None = None) -> float:
    """The lease window: SPARKNET_LEASE_S x SPARKNET_LEASE_MISSES seconds
    of whole-host beacon silence before a host is SUSPECT."""
    lease = knobs.get_float("SPARKNET_LEASE_S", 2.0) \
        if lease_s is None else lease_s
    n = knobs.get_int("SPARKNET_LEASE_MISSES", 3) if misses is None \
        else misses
    if lease <= 0:
        raise ValueError(f"SPARKNET_LEASE_S must be > 0, got {lease}")
    if n < 1:
        raise ValueError(f"SPARKNET_LEASE_MISSES must be >= 1, got {n}")
    return lease * n


LEASE_LIVE = "live"
LEASE_SUSPECT = "suspect"
LEASE_NO_BEATS = "no_beats"


class LeaseMonitor:
    """Per-host lease over the beacon tree: a host whose NEWEST beat
    (across all its ranks) is older than the lease window is SUSPECT —
    the whole-host-silent signature of a severed link.  A single stale
    rank on an otherwise-beating host is NOT a lease event (that is the
    per-rank straggler discipline's case).  The lease never says "lost":
    death is only ever confirmed out-of-band (``host_down_probe``)."""

    def __init__(self, directory: str, *, lease_s: float | None = None,
                 misses: int | None = None,
                 clock: Callable[[], float] = time.time):
        self.directory = directory
        self.window_s = lease_window_s(lease_s, misses)
        self._clock = clock

    def beat_age(self, host: str) -> float | None:
        """Age of ``host``'s newest beat across its ranks, or None."""
        beats = _read_flat(host_dir(self.directory, host))
        if not beats:
            return None
        now = self._clock()
        return min(b.age(now) for b in beats.values())

    def state(self, host: str) -> str:
        age = self.beat_age(host)
        if age is None:
            return LEASE_NO_BEATS
        return LEASE_SUSPECT if age > self.window_s else LEASE_LIVE

    def states(self, hosts) -> dict[str, str]:
        return {str(h): self.state(str(h)) for h in hosts}


class GangHealth:
    """Lease-aware gang monitor — the ``launch_ssh`` supervisor's check
    loop for remote transports.  Each tick it (1) pumps the transport's
    beat relay (staging dir -> supervisor ``host_<name>/`` dir; relay
    silence during a partition IS the signal), (2) classifies hosts:
    lease-expired or ``suspect_probe``-flagged hosts become SUSPECT and
    their ranks are *suspended* from straggler discipline — a partition
    must not kill a healthy gang — unless ``down_probe`` confirms the
    machine is actually dead, in which case straggler discipline
    proceeds and the resilience layer takes the lost-host path.  A host
    leaving suspension gets one round-deadline of grace before its ranks
    are judged again (its first post-heal beat may still be in flight).
    Drop-in monitor for ``tools.launch._wait_all`` (same ``check`` /
    ``deadline_s`` / ``last_age`` surface as StragglerMonitor)."""

    def __init__(self, directory: str, deadline_s: float, *, host_map,
                 transport=None, suspect_probe: Callable | None = None,
                 down_probe: Callable | None = None,
                 lease: LeaseMonitor | None = None,
                 clock: Callable[[], float] = time.time):
        self.straggler = StragglerMonitor(directory, deadline_s, clock)
        self.lease = lease or LeaseMonitor(directory, clock=clock)
        self.host_map = [str(h) for h in host_map]
        self.transport = transport
        self.suspect_probe = suspect_probe
        self.down_probe = down_probe
        self._clock = clock
        self.suspect_hosts: set[str] = set()
        self.ever_suspect: set[str] = set()
        self.confirmed_down: set[str] = set()
        self._grace_until: dict[str, float] = {}

    @property
    def deadline_s(self) -> float:
        return self.straggler.deadline_s

    @property
    def directory(self) -> str:
        return self.straggler.directory

    def _pump(self) -> None:
        if self.transport is None or self.transport.local:
            return
        for host in dict.fromkeys(self.host_map):
            stage = stage_dir(self.directory, host)
            try:
                self.transport.beat_sync(host, stage,
                                         host_dir(self.directory, host))
            except OSError:
                pass   # severed link: no beats arrive — that IS the data

    def check(self, live_ranks) -> list[int]:
        self._pump()
        now = self._clock()
        suspects: set[str] = set()
        # only hosts that still have live ranks can be suspects — a host
        # whose ranks all exited cleanly simply stops beating
        live_hosts = {self.host_map[r] for r in live_ranks
                      if r < len(self.host_map)}
        for host in (h for h in dict.fromkeys(self.host_map)
                     if h in live_hosts):
            flagged = (self.suspect_probe(host)
                       if self.suspect_probe else False)
            expired = self.lease.state(host) == LEASE_SUSPECT
            if not (flagged or expired):
                continue
            if self.down_probe is not None and self.down_probe(host):
                if host not in self.confirmed_down:
                    print(f"health: host {host} silent AND down-probe "
                          f"confirmed dead; escalating to lost-host "
                          f"path", file=sys.stderr, flush=True)
                self.confirmed_down.add(host)
                continue    # dead, not partitioned: straggler kill runs
            suspects.add(host)
        for host in sorted(suspects - self.suspect_hosts):
            print(f"health: host {host} lease expired "
                  f"({self.lease.window_s:.3g}s) — SUSPECT, suspending "
                  f"its ranks (partition != death; no restart burned)",
                  file=sys.stderr, flush=True)
        for host in sorted(self.suspect_hosts - suspects):
            print(f"health: host {host} beating again — healed, "
                  f"resuming straggler discipline after grace",
                  file=sys.stderr, flush=True)
            self._grace_until[host] = now + self.deadline_s
        self.suspect_hosts = suspects
        self.ever_suspect |= suspects
        shielded = set(suspects)
        for host, until in list(self._grace_until.items()):
            if now < until:
                shielded.add(host)
            else:
                del self._grace_until[host]
        ranks = [r for r in live_ranks
                 if self.host_map[r] not in shielded]
        return self.straggler.check(ranks)

    def last_age(self, rank: int) -> float | None:
        return self.straggler.last_age(rank)


def stage_dir(root: str, host: str) -> str:
    """Where a remote host's ranks beat locally before the relay moves
    them into the supervisor's ``host_<name>/`` dir.  In the fake-ssh CI
    rig this is a real local dir; a real deployment mounts it."""
    return os.path.join(root, f"stage_{host}")


class StragglerMonitor:
    """Supervisor side of the health plane: given the heartbeat dir and a
    per-round ``deadline_s``, :meth:`check` names the live ranks whose
    last beat is older than the deadline.  A rank with no beat yet is
    never flagged (startup grace — see module docstring); each rank is
    flagged at most once."""

    def __init__(self, directory: str, deadline_s: float,
                 clock: Callable[[], float] = time.time):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.directory = directory
        self.deadline_s = deadline_s
        self._clock = clock
        self._flagged: set[int] = set()

    def check(self, live_ranks) -> list[int]:
        """Ranks from ``live_ranks`` past the deadline (newly flagged)."""
        now = self._clock()
        beats = read_all(self.directory)
        out = []
        for rank in live_ranks:
            if rank in self._flagged:
                continue
            beat = beats.get(rank)
            if beat is not None and beat.age(now) > self.deadline_s:
                self._flagged.add(rank)
                out.append(rank)
        return out

    def last_age(self, rank: int) -> float | None:
        """Age of ``rank``'s last beat, or None if it never beat — the
        post-mortem datum ResilientRunner folds into its error report."""
        beat = read_beat(self.directory, rank)
        return None if beat is None else beat.age(self._clock())
