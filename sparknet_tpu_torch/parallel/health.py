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

Ages compare the reader's clock against the writer's.  The supervisor
half of the JAX module (``LeaseMonitor``, ``GangHealth``,
``StragglerMonitor``, :240-414) is not ported: it comes with the fleet,
ROADMAP A12.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
