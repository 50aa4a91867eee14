"""Multi-tenant training fleet: gang scheduling, preempt/resume, quotas.

The port's own copy of ``sparknet_tpu/parallel/fleet.py``.  It composes
the per-job machinery (``ResilientRunner``, the health plane, round
checkpoints) into a long-lived shared-device posture: a queue of
heterogeneous jobs, gang-scheduled onto a budget of device slices, each
supervised by its own ResilientRunner, all kept alive through faults and
through the death of the scheduler itself.

**JobSpec**: a JSON-serializable job: model / strategy / rounds / world
size (the gang, all-or-nothing), tenant, priority, restart budget, an
optional explicit ``cmd`` and an optional ``fault`` (the chaos
harness's injection channel).  ``kind="serve"`` is a serving replica.

**GangAllocator**: the device budget.  A gang is allocated atomically and
a freed gang is re-offerable at once.  On one card the slots are the
card's shares: a training gang of ``world`` slots runs as one process
with ``--local-devices world`` workers, and each serving replica is one
process, all on the same device.

**Quotas and fairness**: a job places only while its tenant is under
quota.  Queue order is effective priority (static priority plus
``aging_rate`` per waiting second), then tenant fair-share, then FIFO.

**Preempt/resume**: a higher-priority job that cannot place preempts the
cheapest set of strictly-lower-priority running jobs: ``runner.cancel()``,
SIGTERM (the driver's ``preemption_guard`` writes one final round
checkpoint and exits cleanly), SIGKILL past ``preempt_grace_s``.  The
preempted job is requeued and its next launch resumes from its
checkpoints, bit for bit the unpreempted run.

**Escalation**: a job that exhausts its restart budget is QUARANTINED
with a post-mortem next to its artifacts.

**Crash-safe state**: every transition is appended to a fsync'd JSONL
journal with the JAX package's records and field names (each package's
:func:`offline_status` reads the other's journal).  ``resume`` replays
it, kills recorded worker pids after the ``/proc/<pid>/environ`` identity
check, and requeues, so no job is launched twice and no orphan is left.

**Status**: ``status()`` folds the journal state, each job's newest
checkpoint manifest and the heartbeats of its live attempt (with the
trainer's ``stall_s`` and feed stats) into one view; ``format_status``
renders it as a table.

The built-in commands are module-level values (:data:`SERVE_CMD`,
:data:`DRIVER_CMD`), so a harness can wrap them; each built-in command
gets the scheduler's ``device`` as ``--device``.  Placement on remote
hosts (a host transport, checkpoint shipping) is the pod half: a
``HostPool`` with a remote address, or SPARKNET_SSH_CMD, makes the
scheduler raise (ROADMAP A12, pod half); a ``HostPool`` of local hosts
places gangs, every gang checkpointing into its job's ``ckpt/``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import queue
import signal
import sys
import threading
import time
from typing import Any, Callable, Iterable, Mapping

from ..utils import telemetry
from ..tools.launch import LOCAL_ADDRS
from .resilience import ResilientRunner, RestartPolicy

# job lifecycle states (journaled verbatim)
QUEUED = "QUEUED"
RUNNING = "RUNNING"
PREEMPTING = "PREEMPTING"
COMPLETED = "COMPLETED"
QUARANTINED = "QUARANTINED"
TERMINAL = (COMPLETED, QUARANTINED)

# the env tag every fleet-spawned worker carries — pid liveness checks
# verify it through /proc/<pid>/environ before signalling, so a recycled
# pid can never be mistaken for (and never killed as) a fleet worker
ENV_JOB_TAG = "SPARKNET_FLEET_JOB"

# the checkout's root: put on the children's PYTHONPATH so ``-m`` finds
# the port wherever the scheduler runs from
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the built-in commands (module-level, so a harness can wrap them)
DRIVER_CMD = [sys.executable, "-m",
              "sparknet_tpu_torch.tools.multihost_driver"]
SERVE_CMD = [sys.executable, "-m", "sparknet_tpu_torch.tools.serve"]
POD_HALF = "ROADMAP A12, pod half"

# models the built-in driver workload can train (the zoo driver trains
# lenet; anything else needs an explicit JobSpec.cmd)
DRIVER_MODELS = ("lenet",)

# job kinds: "train" runs to a completion artifact; "serve" is a
# long-lived serving replica — it never finishes on its own, the
# scheduler decides its end (release_job -> drain -> COMPLETED, or
# preemption -> drain -> requeue)
JOB_KINDS = ("train", "serve")


class FleetError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One training job, JSON-round-trippable (the journal stores it).

    Either describe a zoo driver workload (``model``/``strategy``/
    ``rounds``/``global_batch``) or pass an explicit ``cmd`` argv whose
    elements may use the placeholders ``{out}`` (completion artifact —
    REQUIRED: its existence is how the fleet distinguishes "finished"
    from "checkpointed and stopped"), ``{ckpt}`` (the job's checkpoint
    dir), ``{world}``, ``{rounds}`` and ``{endpoint}`` (the replica
    endpoint file serve-kind jobs publish).

    ``kind="serve"`` makes the job a serving replica: the built-in cmd
    launches :data:`SERVE_CMD` ``--models <model>`` on an ephemeral port
    publishing its endpoint into the job dir, the completion-artifact
    rule is waived (a replica never "finishes" — the scheduler's
    ``release_job`` ends it through the drain path), and ``model`` may
    be any zoo name or comma list (the replica process validates it
    loudly at load time)."""

    name: str
    kind: str = "train"
    tenant: str = "default"
    priority: int = 0
    world: int = 4                 # gang size in device slices
    model: str = "lenet"
    strategy: str = "sync"
    rounds: int = 4
    global_batch: int = 16
    cmd: tuple[str, ...] | None = None
    guard: bool = False            # arm the numerical-integrity guard
    audit_every: int = 0           # cross-replica audit cadence
    max_restarts: int = 2          # per launch episode (see FleetScheduler)
    timeout_s: float | None = 300.0   # per attempt (None = unbounded —
                                      # the serve-kind default: replicas
                                      # are long-lived by design)
    round_deadline_s: float | None = None   # straggler deadline
    preemptible: bool = True
    not_before_s: float = 0.0      # delay placement this long after submit
    fault: str | None = None       # SPARKNET_FAULT for the chaos harness
    env: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.name or any(c in self.name for c in "/\\ \t\n"):
            raise ValueError(f"bad job name {self.name!r} (must be "
                             f"non-empty, no slashes or whitespace)")
        if self.world < 1:
            raise ValueError(f"{self.name}: world must be >= 1, "
                             f"got {self.world}")
        if self.rounds < 1:
            raise ValueError(f"{self.name}: rounds must be >= 1")
        if self.max_restarts < 0:
            raise ValueError(f"{self.name}: max_restarts must be >= 0")
        if self.kind not in JOB_KINDS:
            raise ValueError(f"{self.name}: kind must be one of "
                             f"{JOB_KINDS}, got {self.kind!r}")
        if self.cmd is not None:
            object.__setattr__(self, "cmd", tuple(self.cmd))
            if self.kind == "train" \
                    and not any("{out}" in c for c in self.cmd):
                raise ValueError(
                    f"{self.name}: explicit cmd must reference {{out}} — "
                    f"the completion artifact is how the fleet tells a "
                    f"finished job from a preempted one (serve-kind jobs "
                    f"are exempt: the scheduler decides their end)")
        elif self.kind == "train" and self.model not in DRIVER_MODELS:
            raise ValueError(
                f"{self.name}: model {self.model!r} has no built-in "
                f"driver (known: {', '.join(DRIVER_MODELS)}); pass an "
                f"explicit cmd for zoo jobs outside the driver")
        object.__setattr__(self, "env", dict(self.env))

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["cmd"] = list(self.cmd) if self.cmd is not None else None
        return d

    @classmethod
    def from_json(cls, d: Mapping[str, Any]) -> "JobSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown JobSpec field(s) {sorted(extra)} "
                             f"(known: {sorted(known)})")
        d = dict(d)
        if d.get("cmd") is not None:
            d["cmd"] = tuple(d["cmd"])
        return cls(**d)


# host lifecycle states (journaled verbatim, host-control channel too)
HOST_LIVE = "live"
HOST_SUSPECT = "suspect"     # link silent, machine maybe alive: gangs keep
                             # running SUSPENDED (partition != death); the
                             # host just stops taking new placements
HOST_DRAINING = "draining"   # spot notice: evict gracefully, stop placing
HOST_LOST = "lost"           # dead: its gangs are already gone
HOST_STATES = (HOST_LIVE, HOST_SUSPECT, HOST_DRAINING, HOST_LOST)


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """One machine in the pod: a name, its device budget, and how to
    reach it.  ``addr`` in ``launch.LOCAL_ADDRS`` (the default) means
    "spawn here" — an inventory of all-local hosts is the simulated
    N-host rig that runs every cross-host path on one CPU box."""

    name: str
    devices: int
    addr: str = "local"

    def __post_init__(self):
        if not self.name or any(c in self.name for c in "/\\ \t\n,=@"):
            raise ValueError(f"bad host name {self.name!r}")
        if self.devices < 1:
            raise ValueError(f"host {self.name}: devices must be >= 1")


class HostPool:
    """The fleet's machine inventory + liveness state.  Hosts are
    ``live`` (placeable), ``draining`` (spot/preemption notice: existing
    gangs get the SNAPSHOT_STOP eviction, nothing new lands), or
    ``lost`` (dead — slots unplaceable until marked live again).

    Inventory sources: ``HostPool.parse("a=4,b=4@10.0.0.2")`` (inline,
    ``name=devices[@addr]``), a JSON file (``[{"name", "devices",
    "addr"}]``), or ``from_env()`` reading SPARKNET_FLEET_HOSTS (a path
    to such a file, or the inline form)."""

    def __init__(self, hosts: Iterable[HostSpec]):
        self._specs: dict[str, HostSpec] = {}
        for h in hosts:
            if h.name in self._specs:
                raise ValueError(f"duplicate host {h.name!r}")
            self._specs[h.name] = h
        if not self._specs:
            raise ValueError("empty host inventory")
        self.state: dict[str, str] = {n: HOST_LIVE for n in self._specs}

    # -- inventory --------------------------------------------------------
    def specs(self) -> list[HostSpec]:
        return list(self._specs.values())

    def spec(self, name: str) -> HostSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise FleetError(f"unknown host {name!r} (inventory: "
                             f"{sorted(self._specs)})") from None

    @property
    def total_devices(self) -> int:
        return sum(h.devices for h in self._specs.values())

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __len__(self) -> int:
        return len(self._specs)

    # -- liveness ---------------------------------------------------------
    def mark(self, name: str, state: str) -> None:
        if state not in HOST_STATES:
            raise FleetError(f"bad host state {state!r} "
                             f"(one of {HOST_STATES})")
        self.spec(name)   # loud on unknown hosts
        self.state[name] = state

    def placeable(self, name: str) -> bool:
        return self.state.get(name) == HOST_LIVE

    def lost(self) -> list[str]:
        return sorted(n for n, s in self.state.items() if s == HOST_LOST)

    # -- serialization (journaled in the "fleet" record) ------------------
    def to_json(self) -> list[dict]:
        return [{"name": h.name, "devices": h.devices, "addr": h.addr}
                for h in self._specs.values()]

    @classmethod
    def from_json(cls, rows: Iterable[Mapping]) -> "HostPool":
        return cls(HostSpec(name=str(r["name"]), devices=int(r["devices"]),
                            addr=str(r.get("addr", "local")))
                   for r in rows)

    @classmethod
    def parse(cls, text: str) -> "HostPool":
        """Inline inventory: ``name=devices[@addr]`` comma-separated."""
        specs = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad host entry {part!r} "
                                 f"(want name=devices[@addr])")
            name, rest = part.split("=", 1)
            addr = "local"
            if "@" in rest:
                rest, addr = rest.split("@", 1)
            specs.append(HostSpec(name=name.strip(),
                                  devices=int(rest), addr=addr.strip()))
        return cls(specs)

    @classmethod
    def from_spec(cls, spec: str) -> "HostPool":
        """A path to a JSON inventory file, else the inline form."""
        if os.path.exists(spec):
            with open(spec) as f:
                return cls.from_json(json.load(f))
        return cls.parse(spec)

    @classmethod
    def from_env(cls) -> "HostPool | None":
        from ..utils import knobs
        spec = knobs.get_str("SPARKNET_FLEET_HOSTS", "")
        return cls.from_spec(spec) if spec else None


class GangAllocator:
    """All-or-nothing slice allocation out of a fixed device budget.
    Slots are fungible integers — on the local rig they are virtual CPU
    devices, on a pod they are device indices of a slice.  With a
    ``pool``, slots map onto hosts (consecutive ranges in inventory
    order), only slots on LIVE hosts are offerable (draining/lost hosts
    take no new gangs), and allocation packs the fewest hosts that fit —
    a gang never spans more machines than it must.  Freeing is
    state-blind: a lost host's slots come back to the free set but stay
    unplaceable until the host is marked live again."""

    def __init__(self, total: int | None = None, *,
                 pool: HostPool | None = None):
        self.pool = pool
        self.slot_host: dict[int, str] = {}
        if pool is not None:
            i = 0
            for h in pool.specs():
                for _ in range(h.devices):
                    self.slot_host[i] = h.name
                    i += 1
            if total is not None and total != i:
                raise ValueError(f"total={total} contradicts the pool's "
                                 f"{i} devices")
            total = i
        if total is None or total < 1:
            raise ValueError(f"total devices must be >= 1, got {total}")
        self.total = total
        self._free = set(range(total))

    def _offerable(self) -> set[int]:
        if self.pool is None:
            return self._free
        return {s for s in self._free
                if self.pool.placeable(self.slot_host[s])}

    @property
    def free_count(self) -> int:
        return len(self._offerable())

    def allocate(self, n: int,
                 avoid: Iterable[str] = ()) -> tuple[int, ...] | None:
        """The gang, or None when it does not fit — never a partial.

        ``avoid`` is SOFT anti-affinity: the named hosts sort last, so a
        serving replica prefers a host its siblings are not already on
        (one host loss then kills some replicas, never the whole tier).
        It never blocks placement — when only avoided hosts have room,
        the gang still lands there."""
        free = self._offerable()
        if n > len(free):
            return None
        if self.pool is None:
            slots = tuple(sorted(free)[:n])
        else:
            shun = set(avoid)
            by_host: dict[str, list[int]] = {}
            for s in free:
                by_host.setdefault(self.slot_host[s], []).append(s)
            chosen: list[int] = []
            for host in sorted(by_host,
                               key=lambda h: (h in shun,
                                              -len(by_host[h]), h)):
                take = by_host[host][:n - len(chosen)]
                chosen.extend(take)
                if len(chosen) == n:
                    break
            slots = tuple(sorted(chosen))
        self._free.difference_update(slots)
        return slots

    def hosts_of(self, slots: Iterable[int]) -> tuple[str, ...]:
        """The (ordered, de-duplicated) hosts a gang spans; empty
        without a pool."""
        out: list[str] = []
        for s in slots:
            h = self.slot_host.get(s)
            if h is not None and h not in out:
                out.append(h)
        return tuple(out)

    def host_vector(self, slots: Iterable[int]) -> list[str]:
        """Per-slot host labels in slot order (the launcher's
        ``host_map`` shape); empty without a pool."""
        return [self.slot_host[s] for s in slots] if self.slot_host else []

    def free(self, slots: Iterable[int]) -> None:
        for s in slots:
            if s in self._free or not 0 <= s < self.total:
                raise FleetError(f"double free / bad slot {s}")
            self._free.add(s)


class FleetJournal:
    """Append-only fsync'd JSONL of every fleet state transition.
    Replayable (see ``FleetScheduler.resume``); writes are idempotent to
    re-apply because each carries the full fact, not a delta."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._seq = 0
        existing = self.read(path)
        if existing:
            self._seq = existing[-1]["seq"] + 1
        self._f = open(path, "a")

    def append(self, ev: str, **fields) -> None:
        with self._lock:
            rec = {"seq": self._seq, "t": round(time.time(), 3), "ev": ev}
            rec.update(fields)
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())
            self._seq += 1

    def close(self) -> None:
        with self._lock:
            self._f.close()

    @staticmethod
    def read(path: str) -> list[dict]:
        """Every parseable record (a torn final line — the scheduler died
        mid-append — is skipped, not fatal)."""
        out = []
        try:
            with open(path) as f:
                for line in f:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except OSError:
            pass
        return out


class FleetJob:
    """Runtime state of one submitted job (the mutable half; the spec is
    frozen)."""

    def __init__(self, spec: JobSpec, job_dir: str, seq: int,
                 submitted_at: float):
        self.spec = spec
        self.job_dir = job_dir
        self.seq = seq
        self.submitted_at = submitted_at
        self.state = QUEUED
        self.slots: tuple[int, ...] = ()
        self.hosts: tuple[str, ...] = ()   # the machines this gang spans
        self.episodes = 0            # launch episodes (fresh runner each)
        self.restarts_used = 0       # cumulative attempts across episodes
        self.preempt_count = 0
        self.started_at: float | None = None
        self.preempt_requested = False
        self.preempt_deadline: float | None = None
        self.release_requested = False       # scale-down, not eviction
        self.drain_deadline: float | None = None
        self.runner = None
        self.thread: threading.Thread | None = None
        self.procs: list = []        # live Popen handles (latest attempt)
        self.signaled_pids: set[int] = set()
        self.all_pids: set[int] = set()
        self.error: str | None = None

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def out_path(self) -> str:
        return os.path.join(self.job_dir, "out.npz")

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.job_dir, "ckpt")

    def ckpt_dirs(self) -> list[str]:
        """Every checkpoint dir this job has ever written (shared
        default + any per-host dirs), existing ones only."""
        out = [d for d in glob.glob(os.path.join(self.job_dir, "ckpt*"))
               if os.path.isdir(d)]
        return sorted(out)

    @property
    def endpoint_path(self) -> str:
        """Where a serve-kind replica publishes its ephemeral endpoint
        (url + pid + models) once its socket is up."""
        return os.path.join(self.job_dir, "endpoint.json")

    def completed_ok(self) -> bool:
        """The completion artifact exists — the ONLY signal that a clean
        exit was the job finishing rather than checkpoint-and-stop.
        Serve-kind jobs have no artifact: their end is a scheduler
        decision (release), never something the process proves."""
        if self.spec.kind == "serve":
            return False
        return os.path.exists(self.out_path)

    def build_cmd(self, device: str | None = None) -> list[str]:
        """The job's argv: the explicit ``cmd`` with its placeholders
        filled (``{device}`` too), else the built-in driver or replica
        command with ``--device device`` appended when given."""
        spec = self.spec
        ckpt = self.ckpt_dir
        os.makedirs(ckpt, exist_ok=True)
        if spec.cmd is not None:
            sub = {"out": self.out_path, "ckpt": ckpt,
                   "world": str(spec.world), "rounds": str(spec.rounds),
                   "endpoint": self.endpoint_path,
                   "device": device or "cuda"}
            return [c.format(**sub) for c in spec.cmd]
        dev = ["--device", device] if device else []
        if spec.kind == "serve":
            # a serving replica: ephemeral port, endpoint published into
            # the job dir (the ServingFleet poll loop registers it with
            # the router); SPARKNET_SERVE_* knobs ride spec.env.  A
            # stale endpoint from the previous attempt must not route —
            # the fresh attempt republishes once its socket is up.
            try:
                os.unlink(self.endpoint_path)
            except OSError:
                pass
            return [*SERVE_CMD, "--models", spec.model,
                    "--port", "0", "--endpoint-file", self.endpoint_path,
                    *dev]
        cmd = [*DRIVER_CMD, "--strategy", spec.strategy,
               "--out", self.out_path, "--ckpt-dir", ckpt,
               "--rounds", str(spec.rounds),
               "--global-batch", str(spec.global_batch),
               "--local-devices", str(spec.world),
               "--expect-devices", str(spec.world)]
        if spec.guard:
            cmd.append("--guard")
        if spec.audit_every:
            cmd += ["--audit-every", str(spec.audit_every)]
        return cmd + dev

    def newest_round(self) -> int | None:
        """Round progress from the newest checkpoint manifest across
        every checkpoint dir (None before the first checkpoint)."""
        best = None
        for m in glob.glob(os.path.join(self.job_dir, "ckpt*",
                                        "manifest_*.json")):
            stem = os.path.basename(m)
            try:
                r = int(stem[len("manifest_"):-len(".json")])
            except ValueError:
                continue
            best = r if best is None else max(best, r)
        return best


def _pid_is_fleet_job(pid: int, job_name: str) -> bool:
    """True only when /proc says ``pid`` is alive AND carries our env
    tag for ``job_name``.  Any doubt (dead, unreadable, recycled by a
    stranger) is False — the fleet must never signal a process it cannot
    prove it spawned."""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = f.read()
    except OSError:
        return False
    return f"{ENV_JOB_TAG}={job_name}".encode() in env.split(b"\0")


class FleetScheduler:
    """The long-lived supervisor.  Single-threaded scheduling core
    (``step()``) + one supervisor thread per running job (each blocked
    inside its ResilientRunner).  ``run()`` loops ``step`` until every
    job is terminal; tests drive ``step()`` directly for determinism."""

    def __init__(self, workdir: str, total_devices: int | None = None, *,
                 hosts: HostPool | None = None,
                 tenants: Mapping[str, int] | None = None,
                 aging_rate: float = 1.0 / 60.0,
                 preempt: bool = True,
                 preempt_grace_s: float = 10.0,
                 drain_grace_s: float | None = None,
                 max_preempts: int = 10,
                 device: str | None = "cuda",
                 backoff_base: float = 0.2,
                 extra_env: Mapping[str, str] | None = None,
                 runner_factory: Callable | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 _journal: bool = True):
        self.workdir = os.path.abspath(workdir)
        remote = [h.name for h in (hosts.specs() if hosts else ())
                  if h.addr not in LOCAL_ADDRS]
        from ..utils import knobs
        if remote or knobs.raw("SPARKNET_SSH_CMD"):
            # the JAX scheduler ships checkpoints to such hosts and
            # launches over ssh
            what = (f"hosts {remote} with remote addresses" if remote
                    else "SPARKNET_SSH_CMD")
            raise NotImplementedError(
                f"{what}: placement through a host transport is not "
                f"ported yet ({POD_HALF})")
        os.makedirs(self.workdir, exist_ok=True)
        self.pool = hosts
        self.allocator = GangAllocator(total_devices, pool=hosts)
        # operator channel for host state changes from OUTSIDE this
        # process (tools/fleet.py mark-host, chaos harnesses): appended
        # JSONL, polled at every step
        self._host_control_path = os.path.join(self.workdir,
                                               "host_control.jsonl")
        self._host_control_pos = 0
        self.tenants = dict(tenants or {})   # tenant -> slot quota
        for t, q in self.tenants.items():
            if q < 1:
                raise ValueError(f"tenant {t!r}: quota must be >= 1")
        self.aging_rate = aging_rate
        self.preempt_enabled = preempt
        self.preempt_grace_s = preempt_grace_s
        self.drain_grace_s = (preempt_grace_s if drain_grace_s is None
                              else drain_grace_s)
        self.max_preempts = max_preempts
        # job name -> drain hook (start() / done() -> bool): a stopping
        # job with a hook drains FIRST (no new work routed, queued work
        # finishes), then takes the SIGTERM path — how evicting a
        # serving replica stays lossless (see router.RouterDrainHook)
        self.drain_hooks: dict[str, Any] = {}
        self.device = device
        self.backoff_base = backoff_base
        self.extra_env = dict(extra_env or {})
        self.runner_factory = runner_factory or self._default_runner
        self._clock = clock
        self.jobs: dict[str, FleetJob] = {}
        # host -> transport kind of the most recent launch that placed
        # a gang there ("local"/"ssh"/"chaos+..."): the status view's
        # transport column, reconstructed offline from launch events
        self._host_transports: dict[str, str] = {}
        self._results: "queue.Queue" = queue.Queue()
        self._submit_seq = 0
        self.journal = FleetJournal(
            os.path.join(self.workdir, "fleet_journal.jsonl")) \
            if _journal else None
        self._journal_ev("fleet", devices=self.allocator.total,
                         tenants=self.tenants,
                         hosts=hosts.to_json() if hosts else None)

    # -- journal ----------------------------------------------------------
    def _journal_ev(self, ev: str, **fields) -> None:
        if self.journal is not None:
            self.journal.append(ev, **fields)
        # every scheduling decision also rides the telemetry plane: a
        # bounded flight-recorder trail (embedded into quarantine
        # postmortems) plus a per-kind counter — the journal stays the
        # durable source of truth, this is the observable echo
        telemetry.get_recorder().record(
            f"fleet_{ev}",
            **{k: v for k, v in fields.items()
               if k in ("job", "rc", "reason", "by", "episode",
                        "preempts", "recovered", "ok", "slots",
                        "host", "state")})
        telemetry.get_registry().counter(
            "fleet_events_total", "fleet scheduler events by kind"
        ).inc(ev=ev)

    # -- submission -------------------------------------------------------
    def job_dir(self, name: str) -> str:
        return os.path.join(self.workdir, "jobs", name)

    def submit(self, spec: JobSpec, *, _journal: bool = True) -> FleetJob:
        if spec.name in self.jobs:
            raise FleetError(f"duplicate job name {spec.name!r}")
        if spec.world > self.allocator.total:
            raise FleetError(
                f"{spec.name!r} wants a gang of {spec.world} but the "
                f"fleet budget is {self.allocator.total} devices — it "
                f"could never be placed")
        job = FleetJob(spec, self.job_dir(spec.name), self._submit_seq,
                       self._clock())
        self._submit_seq += 1
        os.makedirs(job.job_dir, exist_ok=True)
        self.jobs[spec.name] = job
        if _journal:
            self._journal_ev("submit", job=spec.name, spec=spec.to_json())
        if job.completed_ok():
            # idempotent re-submit of a finished job (resume path)
            job.state = COMPLETED
            self._journal_ev("complete", job=spec.name, recovered=True)
        return job

    # -- scheduling policy ------------------------------------------------
    def effective_priority(self, job: FleetJob) -> float:
        """Static priority plus starvation aging over QUEUED time."""
        if job.state != QUEUED:
            return float(job.spec.priority)
        wait = max(self._clock() - job.submitted_at, 0.0)
        return job.spec.priority + self.aging_rate * wait

    def _tenant_used(self, tenant: str) -> int:
        return sum(len(j.slots) for j in self.jobs.values()
                   if j.spec.tenant == tenant
                   and j.state in (RUNNING, PREEMPTING))

    def _quota_ok(self, job: FleetJob) -> bool:
        quota = self.tenants.get(job.spec.tenant)
        if quota is None:
            return True
        return self._tenant_used(job.spec.tenant) + job.spec.world <= quota

    def _fair_frac(self, job: FleetJob) -> float:
        quota = self.tenants.get(job.spec.tenant, self.allocator.total)
        return self._tenant_used(job.spec.tenant) / max(quota, 1)

    def _rank_key(self, job: FleetJob):
        # highest effective priority first — FLOORED, so aging promotes
        # in whole priority units and microsecond wait differences can't
        # defeat the tie-breaks; ties go to the tenant using the smallest
        # share of its quota (fair-share), then FIFO
        return (-int(self.effective_priority(job)),
                self._fair_frac(job), job.seq)

    def _placeable_now(self, job: FleetJob) -> bool:
        return (self._clock() - job.submitted_at) >= job.spec.not_before_s

    # -- launch -----------------------------------------------------------
    def _default_runner(self, job: FleetJob, cmd: list[str],
                        env: dict) -> ResilientRunner:
        # with a pool, the runner knows its placement (one supervised
        # process per gang → a 1-entry host_map on
        # the gang's primary host) and can ask the pool whether a host
        # is down — the authoritative channel for host-granular budget
        # accounting (one host death = one budget unit, see resilience).
        # A suspect mark is the OTHER answer: the monitor suspends the
        # host's ranks instead of killing them (partition != death).
        host_kw: dict = {}
        place_kw: dict = dict(nprocs=1)
        if job.hosts and self.pool is not None:
            pool = self.pool
            host_kw = dict(
                host_map=[job.hosts[0]],
                host_down_probe=lambda h: pool.state.get(h) == HOST_LOST,
                host_suspect_probe=(
                    lambda h: pool.state.get(h) == HOST_SUSPECT))
        return ResilientRunner(
            cmd,
            timeout=job.spec.timeout_s,
            policy=RestartPolicy(max_restarts=job.spec.max_restarts,
                                 backoff_base=self.backoff_base),
            round_deadline=job.spec.round_deadline_s,
            workdir=os.path.join(job.job_dir, "runner",
                                 f"ep_{job.episodes:03d}"),
            extra_env=env,
            on_spawn=lambda procs: self._on_spawn(job, procs),
            **place_kw, **host_kw)

    def _on_spawn(self, job: FleetJob, procs: list) -> None:
        """Runs on the supervisor thread at every (re)launch: record the
        gang's pids for preemption signalling + orphan accounting."""
        job.procs = procs
        pids = [p.pid for p in procs]
        job.all_pids.update(pids)
        job.restarts_used += 1
        self._journal_ev("pids", job=job.name, pids=pids)
        # a preemption requested while the previous attempt was dying
        # must reach the fresh gang too (cancel() already stops restarts,
        # but this attempt raced the cancel and spawned anyway)
        if job.preempt_requested:
            self._signal_job(job, signal.SIGTERM)

    def _launch(self, job: FleetJob, slots: tuple[int, ...]) -> None:
        job.slots = slots
        job.hosts = self.allocator.hosts_of(slots)
        job.state = RUNNING
        job.started_at = self._clock()
        job.preempt_requested = False
        job.preempt_deadline = None
        job.release_requested = False
        job.drain_deadline = None
        job.signaled_pids = set()
        job.procs = []
        job.episodes += 1
        cmd = job.build_cmd(self.device)
        env = dict(self.extra_env)
        env.update(job.spec.env)
        env[ENV_JOB_TAG] = job.name
        # ``-m sparknet_tpu_torch...`` resolves from any working directory
        path = env.get("PYTHONPATH", os.environ.get("PYTHONPATH", ""))
        if _REPO not in path.split(os.pathsep):
            env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, path) if p)
        # fence base: each launch episode fences off every earlier one
        # (the runner adds its attempt number — see resilience)
        env["SPARKNET_FENCE_BASE"] = str(job.episodes * 100000)
        if job.hosts:
            # placement facts ride the env: the gang's primary host tag
            # plus the full per-slot host vector (informational on the
            # simulated rig; a real pod launcher consumes the vector)
            env.setdefault("SPARKNET_FLEET_HOST", job.hosts[0])
            env.setdefault("SPARKNET_FLEET_HOSTVEC",
                           ",".join(self.allocator.host_vector(slots)))
        # telemetry: workers snapshot their metrics registry into the
        # job dir (throttled, atomic) so status views can fold them in
        # without a live channel; spec/env overrides win
        env.setdefault("SPARKNET_METRICS_SNAP",
                       os.path.join(job.job_dir, "metrics"))
        if job.spec.fault:
            env["SPARKNET_FAULT"] = job.spec.fault
        job.runner = self.runner_factory(job, cmd, env)
        for h in job.hosts:
            self._host_transports[h] = "local"
        self._journal_ev("launch", job=job.name, episode=job.episodes,
                         slots=list(slots), hosts=list(job.hosts), cmd=cmd,
                         transport="local")
        job.thread = threading.Thread(
            target=self._supervise, args=(job, job.runner),
            name=f"fleet-{job.name}", daemon=True)
        job.thread.start()

    def _supervise(self, job: FleetJob, runner) -> None:
        try:
            rc = runner.run()
        except BaseException as e:   # a broken runner is a job failure
            job.error = f"{type(e).__name__}: {e}"
            rc = -1
        self._results.put((job, rc))

    # -- preemption -------------------------------------------------------
    def _signal_job(self, job: FleetJob, sig: int,
                    only_new: bool = True) -> None:
        for p in job.procs:
            if p.poll() is not None:
                continue
            if only_new and sig == signal.SIGTERM \
                    and p.pid in job.signaled_pids:
                continue
            try:
                p.send_signal(sig)
                if sig == signal.SIGTERM:
                    job.signaled_pids.add(p.pid)
            except (ProcessLookupError, OSError):
                pass

    def register_drain_hook(self, name: str, hook) -> None:
        """Attach a drain fence to job ``name``: any stop (preemption,
        release, shutdown) will ``hook.start()`` first and hold the
        SIGTERM until ``hook.done()`` or ``drain_grace_s`` expires."""
        self.drain_hooks[name] = hook

    def _begin_stop(self, job: FleetJob, *, release: bool,
                    by: str = "") -> None:
        """Common preempt/release entry: stop the supervision loop, then
        either open the drain window (hooked jobs — SIGTERM is deferred
        to :meth:`_escalate_preemptions`) or SIGTERM immediately."""
        if job.state not in (RUNNING, PREEMPTING):
            return
        job.preempt_requested = True
        job.release_requested = job.release_requested or release
        job.state = PREEMPTING
        if job.runner is not None:
            job.runner.cancel()
        hook = self.drain_hooks.get(job.name)
        if hook is not None and job.preempt_deadline is None \
                and job.drain_deadline is None:
            try:
                hook.start()
                job.drain_deadline = self._clock() + self.drain_grace_s
                self._journal_ev("drain", job=job.name,
                                 release=release, by=by)
            except Exception as e:
                print(f"fleet: drain hook for {job.name!r} failed "
                      f"({e!r}); falling through to SIGTERM",
                      file=sys.stderr, flush=True)
                job.drain_deadline = None
        if job.drain_deadline is None and job.preempt_deadline is None:
            job.preempt_deadline = self._clock() + self.preempt_grace_s
            self._signal_job(job, signal.SIGTERM)

    def preempt_job(self, job: FleetJob, *, by: str = "") -> None:
        """Start a graceful preemption: stop the supervision loop, drain
        if hooked, open the SIGTERM grace window.  Harvest decides
        requeue-vs-complete when the runner returns."""
        if job.state not in (RUNNING, PREEMPTING):
            return
        self._begin_stop(job, release=False, by=by)
        self._journal_ev("preempt", job=job.name, by=by)
        print(f"fleet: preempting {job.name!r}"
              + (f" for {by!r}" if by else ""), file=sys.stderr, flush=True)

    def release_job(self, name: str) -> None:
        """Gracefully END a job by scheduler decision — the serving
        scale-down path: drain (via the registered hook), SIGTERM, and
        at harvest the job is COMPLETED, not requeued.  Loud on unknown
        names; a no-op on already-terminal jobs."""
        job = self.jobs.get(name)
        if job is None:
            raise FleetError(f"release of unknown job {name!r}")
        if job.state in TERMINAL:
            return
        if job.state == QUEUED:
            # never launched: nothing to drain or signal
            job.state = COMPLETED
            job.release_requested = True
            self._journal_ev("release", job=name, queued=True)
            self._journal_ev("complete", job=name, released=True)
            return
        self._begin_stop(job, release=True, by="release")
        self._journal_ev("release", job=name)
        print(f"fleet: releasing {job.name!r} (drain, then stop)",
              file=sys.stderr, flush=True)

    # -- host lifecycle ---------------------------------------------------
    def jobs_on_host(self, host: str) -> list[FleetJob]:
        """Non-terminal jobs whose gang touches ``host``."""
        return [j for j in self.jobs.values()
                if host in j.hosts and j.state in (RUNNING, PREEMPTING)]

    def mark_host(self, host: str, state: str, *, by: str = "") -> None:
        """Change a host's liveness and act on its gangs.  ``draining``
        (a spot/preemption notice) evicts each gang gracefully — drain
        fence, SIGTERM→SNAPSHOT_STOP, requeue — while placement stops
        offering the host's slots.  ``lost`` (the machine is gone) is
        the abrupt path: every touching gang is killed outright and
        requeued onto surviving hosts, checkpoint-resumed bit-identical.
        ``suspect`` (the LINK is silent but the machine may be alive —
        a lease expiry, not a death certificate) deliberately touches
        no gang: placement stops, the per-job health monitor suspends
        straggler discipline for the host's ranks, and nothing is
        killed or requeued until a down-probe confirms death or an
        operator marks it lost.  ``live`` readmits the host's slots to
        placement (for a suspect host, that is the heal)."""
        if self.pool is None:
            raise FleetError("mark_host needs a HostPool "
                             "(scheduler built with total_devices only)")
        self.pool.mark(host, state)   # loud on unknown host / bad state
        self._journal_ev("host", host=host, state=state, by=by)
        print(f"fleet: host {host!r} -> {state}"
              + (f" (by {by})" if by else ""), file=sys.stderr, flush=True)
        if state == HOST_DRAINING:
            for job in self.jobs_on_host(host):
                self.preempt_job(job, by=f"drain:{host}")
        elif state == HOST_LOST:
            for job in self.jobs_on_host(host):
                self._host_lost_stop(job, host)

    def _host_lost_stop(self, job: FleetJob, host: str) -> None:
        """A machine under ``job`` died.  No drain fence, no SIGTERM
        grace — a dead host cannot drain, and the launcher's fail-fast
        would tear the surviving ranks off a dead collective anyway.
        Kill the whole gang now (on the simulated rig this IS the host
        kill), requeue at harvest, resume from checkpoint."""
        if job.state not in (RUNNING, PREEMPTING):
            return
        job.preempt_requested = True
        job.state = PREEMPTING
        if job.runner is not None:
            job.runner.cancel()
        job.drain_deadline = None
        job.preempt_deadline = self._clock()   # escalation owes no grace
        self._signal_job(job, signal.SIGKILL, only_new=False)
        self._journal_ev("host_kill", job=job.name, host=host)

    def _poll_host_control(self) -> None:
        """Apply host state changes appended to ``host_control.jsonl``
        by OTHER processes (tools/fleet.py mark-host, chaos harnesses).
        Torn trailing lines are retried next step, bad records are loud
        but not fatal."""
        if self.pool is None:
            return
        try:
            with open(self._host_control_path, "rb") as f:
                f.seek(self._host_control_pos)
                chunk = f.read()
        except OSError:
            return
        for line in chunk.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break   # torn append: re-read once the writer finishes
            self._host_control_pos += len(line)
            try:
                rec = json.loads(line)
                self.mark_host(str(rec["host"]), str(rec["state"]),
                               by=str(rec.get("by", "control")))
            except (ValueError, KeyError, FleetError) as e:
                print(f"fleet: bad host-control record {line!r}: {e}",
                      file=sys.stderr, flush=True)

    def _escalate_preemptions(self) -> None:
        now = self._clock()
        for job in self.jobs.values():
            if job.state != PREEMPTING:
                continue
            if job.drain_deadline is not None:
                # drain window: no signals while the hook drains — the
                # queued work this stop must not lose is still finishing
                hook = self.drain_hooks.get(job.name)
                try:
                    done = True if hook is None else bool(hook.done())
                except Exception:
                    done = True      # a broken hook must not wedge a stop
                if done or now > job.drain_deadline:
                    self._journal_ev("drain_done", job=job.name,
                                     ok=bool(done))
                    job.drain_deadline = None
                    job.preempt_deadline = now + self.preempt_grace_s
                    self._signal_job(job, signal.SIGTERM)
                continue
            # catch workers spawned after the first SIGTERM volley
            self._signal_job(job, signal.SIGTERM)
            if job.preempt_deadline is not None \
                    and now > job.preempt_deadline:
                self._signal_job(job, signal.SIGKILL, only_new=False)

    def _maybe_preempt(self) -> None:
        """At most one preemption decision per step: for the single
        highest-ranked queued job that quota allows but capacity blocks,
        evict the cheapest set of strictly-lower-priority running jobs
        that frees its gang."""
        if not self.preempt_enabled:
            return
        queued = sorted(
            (j for j in self.jobs.values()
             if j.state == QUEUED and self._placeable_now(j)),
            key=self._rank_key)
        for cand in queued:
            if not self._quota_ok(cand):
                continue
            deficit = cand.spec.world - self.allocator.free_count
            if deficit <= 0:
                return   # placeable — no preemption needed
            victims = sorted(
                (j for j in self.jobs.values()
                 if j.state == RUNNING and j.spec.preemptible
                 and j.spec.priority < cand.spec.priority),
                key=lambda j: (j.spec.priority, -(j.started_at or 0.0)))
            chosen, freed = [], 0
            for v in victims:
                if freed >= deficit:
                    break
                chosen.append(v)
                freed += len(v.slots)
            if freed < deficit:
                continue   # even evicting everything eligible won't fit
            for v in chosen:
                self.preempt_job(v, by=cand.name)
            return

    # -- harvest ----------------------------------------------------------
    def _harvest(self) -> None:
        while True:
            try:
                job, rc = self._results.get_nowait()
            except queue.Empty:
                return
            if job.thread is not None:
                job.thread.join(timeout=5)
            if job.slots:
                self.allocator.free(job.slots)
                job.slots = ()
            job.hosts = ()
            job.procs = []
            self._journal_ev("exit", job=job.name, rc=rc,
                             episode=job.episodes)
            if job.completed_ok():
                job.state = COMPLETED
                self._journal_ev("complete", job=job.name)
                print(f"fleet: {job.name!r} completed", file=sys.stderr,
                      flush=True)
            elif job.release_requested:
                # a scheduler-decided end (serving scale-down): the
                # drain already emptied it, the exit IS the completion
                job.state = COMPLETED
                job.drain_deadline = None
                self._journal_ev("complete", job=job.name, released=True)
                print(f"fleet: {job.name!r} released", file=sys.stderr,
                      flush=True)
            elif job.preempt_requested or rc == 0:
                # a clean exit WITHOUT the completion artifact is a
                # checkpoint-and-stop (our preemption, or the job's own
                # SIGTERM — e.g. the injected `preempt` fault); requeue
                # to resume from the checkpoint.  Bounded: a job that
                # keeps stopping cleanly without finishing quarantines
                # after max_preempts.
                job.preempt_count += 1
                if job.preempt_count > self.max_preempts:
                    self._quarantine(job, rc,
                                     reason="preempt/requeue loop "
                                            f"exceeded {self.max_preempts}")
                else:
                    job.state = QUEUED
                    job.submitted_at = self._clock()  # aging restarts
                    job.preempt_requested = False
                    job.preempt_deadline = None
                    job.drain_deadline = None
                    self._journal_ev("requeue", job=job.name,
                                     preempts=job.preempt_count)
            else:
                self._quarantine(job, rc)

    def _quarantine(self, job: FleetJob, rc: int,
                    reason: str = "") -> None:
        """Out of the rotation for good, with the post-mortem on disk —
        never retried forever, never silently dropped."""
        job.state = QUARANTINED
        failure = getattr(job.runner, "failure", None)
        post = {
            "job": job.name, "rc": rc,
            "reason": reason or (str(failure) if failure else
                                 job.error or f"exit rc={rc}"),
            "episodes": job.episodes,
            "attempts": job.restarts_used,
            "preempts": job.preempt_count,
        }
        if failure is not None:
            post.update(cause=failure.cause, rank=failure.rank,
                        heartbeat_age=failure.heartbeat_age,
                        log_tail=failure.log_tail)
        # the flight-recorder tail: the scheduling decisions (and any
        # restarts this process supervised) that led here — the black
        # box a post-mortem reader wants next to the exit code.  The
        # verdict itself is recorded BEFORE the tail is captured (the
        # journal echo lands after this file is written).
        telemetry.get_recorder().record(
            "fleet_quarantine", job=job.name, rc=rc,
            reason=post["reason"])
        post["flight_recorder"] = telemetry.get_recorder().tail(64)
        path = os.path.join(job.job_dir, "postmortem.json")
        with open(path, "w") as f:
            json.dump(post, f, indent=1)
        self._journal_ev("quarantine", job=job.name, rc=rc,
                         reason=post["reason"])
        print(f"fleet: {job.name!r} QUARANTINED ({post['reason']}); "
              f"post-mortem at {path}", file=sys.stderr, flush=True)

    # -- placement --------------------------------------------------------
    def _place(self) -> None:
        queued = sorted(
            (j for j in self.jobs.values()
             if j.state == QUEUED and self._placeable_now(j)),
            key=self._rank_key)
        for job in queued:
            if not self._quota_ok(job):
                continue
            slots = self.allocator.allocate(
                job.spec.world, avoid=self._replica_hosts(job))
            if slots is None:
                continue   # backfill: smaller jobs behind may still fit
            self._launch(job, slots)

    def _replica_hosts(self, job: FleetJob) -> set[str]:
        """Hosts already carrying a live replica of the same served
        model — serve gangs prefer a fresh host (soft anti-affinity in
        :meth:`GangAllocator.allocate`) so one host loss never takes
        every replica of a model at once."""
        if self.pool is None or job.spec.kind != "serve":
            return set()
        return {h for j in self.jobs.values()
                if j is not job and j.spec.kind == "serve"
                and j.spec.model == job.spec.model
                and j.state not in TERMINAL
                for h in j.hosts}

    # -- the loop ---------------------------------------------------------
    def step(self) -> None:
        """One scheduling pass: apply external host state changes,
        harvest exits, escalate overdue preemptions, decide at most one
        new preemption, place."""
        self._poll_host_control()
        self._harvest()
        self._escalate_preemptions()
        self._maybe_preempt()
        self._place()

    def done(self) -> bool:
        return all(j.state in TERMINAL for j in self.jobs.values())

    def run(self, *, tick_s: float = 0.2, timeout_s: float | None = None,
            status_every_s: float = 0.0) -> int:
        """Schedule until every job is terminal.  Returns 0 when all
        completed, 3 when any quarantined.  ``timeout_s`` bounds the
        whole fleet (everything still live is killed and quarantined —
        a wedged fleet must fail loudly, not hang CI forever)."""
        t0 = self._clock()
        last_status = t0
        while not self.done():
            self.step()
            now = self._clock()
            if status_every_s and now - last_status >= status_every_s:
                print(format_status(self.status()), flush=True)
                last_status = now
            if timeout_s is not None and now - t0 > timeout_s:
                self.shutdown()
                for j in self.jobs.values():
                    if j.state not in TERMINAL:
                        self._quarantine(j, -1, reason="fleet timeout")
                self._journal_ev("done", ok=False, timeout=True)
                return 3
            time.sleep(tick_s)
        ok = all(j.state == COMPLETED for j in self.jobs.values())
        self._journal_ev("done", ok=ok)
        return 0 if ok else 3

    def shutdown(self, grace_s: float | None = None) -> None:
        """Cancel and kill everything still running (used on operator
        interrupt and fleet timeout).  Jobs stay requeue-able: their
        checkpoints survive, only the processes die."""
        grace = self.preempt_grace_s if grace_s is None else grace_s
        live = [j for j in self.jobs.values()
                if j.state in (RUNNING, PREEMPTING)]
        for j in live:
            if j.runner is not None:
                j.runner.cancel()
            self._signal_job(j, signal.SIGTERM)
        deadline = time.monotonic() + grace
        for j in live:
            if j.thread is not None:
                j.thread.join(timeout=max(deadline - time.monotonic(), 0.1))
        for j in live:
            self._signal_job(j, signal.SIGKILL, only_new=False)
            if j.thread is not None:
                j.thread.join(timeout=5)
        self._harvest()
        self._journal_ev("shutdown")

    # -- orphan accounting ------------------------------------------------
    def live_worker_pids(self) -> dict[str, list[int]]:
        """Every recorded worker pid still alive AND provably ours —
        the soak harness's zero-orphans check."""
        out: dict[str, list[int]] = {}
        for job in self.jobs.values():
            alive = [p for p in sorted(job.all_pids)
                     if _pid_is_fleet_job(p, job.name)]
            if alive:
                out[job.name] = alive
        return out

    # -- status -----------------------------------------------------------
    def _heartbeats(self, job: FleetJob) -> dict[int, dict]:
        """Per-rank beats of the job's newest attempt (with the
        trainer's stall_s / FeedStats telemetry when present)."""
        from . import health
        if job.runner is None:
            return {}
        workdir = getattr(job.runner, "workdir", None)
        if not workdir:
            return {}
        attempts = sorted(glob.glob(os.path.join(workdir, "attempt_*")))
        if not attempts:
            return {}
        beats = health.read_all(os.path.join(attempts[-1], "hb"))
        return {rank: {"round": b.round, "phase": b.phase,
                       "age_s": round(b.age(), 2),
                       **({"extras": b.extras} if b.extras else {})}
                for rank, b in beats.items()}

    def status(self) -> dict[str, Any]:
        jobs = []
        for job in sorted(self.jobs.values(), key=lambda j: j.seq):
            round_done = job.newest_round()
            metrics = job_metrics(job.job_dir)
            jobs.append({
                "job": job.name,
                "kind": job.spec.kind,
                "model": job.spec.model,
                "tenant": job.spec.tenant,
                "state": job.state,
                "priority": job.spec.priority,
                "eff_priority": round(self.effective_priority(job), 2),
                "world": job.spec.world,
                "slots": list(job.slots),
                "episodes": job.episodes,
                "attempts": job.restarts_used,
                "preempts": job.preempt_count,
                "round": (job.spec.rounds if job.state == COMPLETED
                          else round_done),
                "rounds_target": job.spec.rounds,
                "hosts": list(job.hosts),
                "heartbeats": self._heartbeats(job),
                "metrics": metrics,
                "metrics_note": metrics_note(metrics),
            })
        by_tenant = {}
        for t in sorted({j.spec.tenant for j in self.jobs.values()}):
            by_tenant[t] = {"used": self._tenant_used(t),
                            "quota": self.tenants.get(t)}
        out = {"devices": {"total": self.allocator.total,
                           "free": self.allocator.free_count},
               "tenants": by_tenant, "jobs": jobs}
        if self.pool is not None:
            out["hosts"] = hosts_view(
                self.pool, jobs,
                beat_ages=host_beat_ages(self.workdir, jobs),
                transports=self._host_transports)
        serving = serving_status(self.workdir, jobs)
        if serving:
            out["serving"] = serving
        return out

    # -- crash recovery ---------------------------------------------------
    @classmethod
    def resume(cls, workdir: str, **kwargs) -> "FleetScheduler":
        """Rebuild a scheduler from ``workdir``'s journal after a
        scheduler death.  Completed/quarantined jobs stay terminal; a
        job that finished while unsupervised (out artifact on disk) is
        recognized as completed; everything else has its recorded
        worker pids killed (after the /proc environ identity check)
        and is requeued to resume from its checkpoints — no job is
        ever double-launched."""
        path = os.path.join(os.path.abspath(workdir),
                            "fleet_journal.jsonl")
        events = FleetJournal.read(path)
        if not events:
            raise FleetError(f"no journal to resume at {path}")
        devices = None
        tenants: dict[str, int] = {}
        pool: HostPool | None = None
        host_states: dict[str, str] = {}
        specs: dict[str, JobSpec] = {}
        terminal: dict[str, str] = {}
        pids: dict[str, set[int]] = {}
        counters: dict[str, dict[str, int]] = {}
        for ev in events:
            kind = ev.get("ev")
            name = ev.get("job")
            if kind == "fleet":
                devices = ev.get("devices", devices)
                tenants = dict(ev.get("tenants") or {})
                if ev.get("hosts"):
                    pool = HostPool.from_json(ev["hosts"])
            elif kind == "host":
                host_states[ev.get("host")] = ev.get("state")
            elif kind == "submit":
                specs[name] = JobSpec.from_json(ev["spec"])
                counters.setdefault(name, {"episodes": 0, "preempts": 0,
                                           "attempts": 0})
            elif kind == "launch":
                c = counters.setdefault(name, {"episodes": 0,
                                               "preempts": 0,
                                               "attempts": 0})
                c["episodes"] = ev.get("episode", c["episodes"] + 1)
            elif kind == "pids":
                pids.setdefault(name, set()).update(ev.get("pids", []))
                counters.setdefault(name, {"episodes": 0, "preempts": 0,
                                           "attempts": 0})["attempts"] += 1
            elif kind == "requeue":
                c = counters.setdefault(name, {"episodes": 0,
                                               "preempts": 0,
                                               "attempts": 0})
                c["preempts"] = ev.get("preempts", c["preempts"] + 1)
            elif kind in ("complete", "quarantine"):
                terminal[name] = (COMPLETED if kind == "complete"
                                  else QUARANTINED)
        if devices is None:
            raise FleetError(f"journal at {path} has no fleet record")
        kwargs.setdefault("tenants", tenants)
        if pool is not None and "hosts" not in kwargs:
            # re-apply the journaled host states so a host that was
            # draining/lost when the scheduler died stays unplaceable
            for host, st in host_states.items():
                if host in pool and st in HOST_STATES:
                    pool.mark(host, st)
            kwargs["hosts"] = pool
        sched = cls(workdir, devices if kwargs.get("hosts") is None
                    else None, **kwargs)
        try:
            # host-control records from before the death are already
            # reflected in the journaled host states replayed above —
            # re-applying them would re-fire their side effects
            sched._host_control_pos = os.path.getsize(
                sched._host_control_path)
        except OSError:
            pass
        for name, spec in specs.items():
            # reap survivors of the dead scheduler FIRST: resuming the
            # job while its old gang still trains is the double-launch
            # this journal exists to prevent
            if terminal.get(name) != COMPLETED:
                sched._reap(name, pids.get(name, set()))
            job = sched.submit(spec, _journal=False)
            c = counters.get(name, {})
            job.episodes = c.get("episodes", 0)
            job.restarts_used = c.get("attempts", 0)
            job.preempt_count = c.get("preempts", 0)
            job.all_pids = set(pids.get(name, set()))
            if terminal.get(name) == QUARANTINED:
                job.state = QUARANTINED
            elif terminal.get(name) == COMPLETED \
                    and spec.kind == "serve":
                # a released replica has no out artifact; the journal's
                # word is the only (and sufficient) completion proof
                job.state = COMPLETED
            # submit() already flipped state to COMPLETED when the out
            # artifact exists — covering jobs that finished unsupervised
            if job.state == QUEUED:
                sched._journal_ev("recover", job=name)
        sched._journal_ev("resumed", jobs=len(specs))
        return sched

    def _reap(self, job_name: str, pids: set[int]) -> None:
        """Kill recorded workers of ``job_name`` that are still alive
        (identity-checked): SIGTERM, short grace, SIGKILL."""
        alive = [p for p in sorted(pids)
                 if _pid_is_fleet_job(p, job_name)]
        if not alive:
            return
        print(f"fleet: resume reaping {len(alive)} surviving worker(s) "
              f"of {job_name!r}: {alive}", file=sys.stderr, flush=True)
        for p in alive:
            try:
                os.kill(p, signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline:
            if not any(_pid_is_fleet_job(p, job_name) for p in alive):
                return
            time.sleep(0.05)
        for p in alive:
            if _pid_is_fleet_job(p, job_name):
                try:
                    os.kill(p, signal.SIGKILL)
                except OSError:
                    pass


def host_beat_ages(workdir: str, jobs: list[dict]) -> dict[str, float]:
    """Newest relayed-beat age per host, scanned from each running
    job's newest attempt heartbeat tree.  Remote-transport gangs write
    (via the relay) into ``host_<name>`` subdirs, so attribution is
    direct; a single-host gang's flat rank beats are attributed to its
    only host.  Powers the lease column of the status host rows — live
    and offline read the same files."""
    from . import health
    ages: dict[str, float] = {}

    def fold(host: str, beats: dict) -> None:
        if not beats:
            return
        age = min(b.age() for b in beats.values())
        if host not in ages or age < ages[host]:
            ages[host] = age

    for j in jobs:
        hosts = j.get("hosts") or []
        if not hosts or j.get("state") not in (RUNNING, PREEMPTING):
            continue
        attempts = sorted(glob.glob(os.path.join(
            os.path.abspath(workdir), "jobs", j["job"],
            "runner", "ep_*", "attempt_*", "hb")))
        if not attempts:
            continue
        for host, beats in health.read_hosts(attempts[-1]).items():
            if host is None:
                if len(hosts) == 1:
                    fold(hosts[0], beats)
            elif host in hosts:
                fold(host, beats)
    return ages


def hosts_view(pool: HostPool, jobs: list[dict], *,
               beat_ages: Mapping[str, float] | None = None,
               transports: Mapping[str, str] | None = None
               ) -> dict[str, dict]:
    """The hosts section of a status view: per-host liveness state,
    device budget/usage, which gangs sit on it — computed the same
    way live and offline (slot→host is deterministic: consecutive
    ranges in inventory order) — plus, when the caller supplies them,
    the network-liveness columns: ``beat_age_s`` (newest relayed beat,
    see :func:`host_beat_ages`), ``transport`` (kind of the last launch
    that placed a gang there), and ``lease`` — the operator state
    verbatim when not live, else ``suspect`` iff a hosted gang's beats
    have gone silent past the lease window, else ``live``.  A live host
    with gangs but no beats yet is still ``live`` (startup grace,
    mirroring the in-gang LeaseMonitor)."""
    slot_host: dict[int, str] = {}
    i = 0
    for h in pool.specs():
        for _ in range(h.devices):
            slot_host[i] = h.name
            i += 1
    out: dict[str, dict] = {}
    for h in pool.specs():
        out[h.name] = {"state": pool.state.get(h.name, HOST_LIVE),
                       "addr": h.addr, "devices": h.devices,
                       "used": 0, "gangs": []}
    for j in jobs:
        for s in j.get("slots") or []:
            host = slot_host.get(s)
            if host is not None:
                out[host]["used"] += 1
        for host in j.get("hosts") or []:
            if host in out and j["job"] not in out[host]["gangs"]:
                out[host]["gangs"].append(j["job"])
    window: float | None = None
    for name, row in out.items():
        age = (beat_ages or {}).get(name)
        if age is not None:
            row["beat_age_s"] = round(age, 2)
        row["transport"] = (transports or {}).get(name, "local")
        if row["state"] != HOST_LIVE:
            row["lease"] = row["state"]
        elif row["gangs"] and age is not None:
            if window is None:
                from .health import lease_window_s
                window = lease_window_s()
            row["lease"] = ("suspect" if age > window else "live")
        else:
            row["lease"] = "live"
    return out


def request_mark_host(workdir: str, host: str, state: str,
                      by: str = "") -> None:
    """Ask the (possibly remote, possibly separate-process) scheduler
    owning ``workdir`` to mark ``host`` — appended to the host-control
    channel it polls every step.  Validation of the host NAME happens at
    apply time (the scheduler owns the inventory); the state is checked
    here so a typo fails at the operator's prompt, not in the log."""
    if state not in HOST_STATES:
        raise FleetError(f"bad host state {state!r} (one of {HOST_STATES})")
    path = os.path.join(os.path.abspath(workdir), "host_control.jsonl")
    rec = {"host": host, "state": state, "by": by,
           "t": round(time.time(), 3)}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())


def job_metrics(job_dir: str) -> dict[str, Any]:
    """Fold the registry snapshots a job's workers wrote into
    ``<job_dir>/metrics`` (see telemetry.MetricsRegistry.maybe_snapshot;
    the scheduler points workers there via SPARKNET_METRICS_SNAP).
    Empty when the job never snapshotted — older jobs simply lack it."""
    paths = glob.glob(os.path.join(job_dir, "metrics",
                                   "metrics_rank*.json"))
    if not paths:
        return {}
    return telemetry.fold_snapshots(sorted(paths))


def metrics_note(metrics: Mapping[str, Any]) -> str:
    """One compact table cell out of a job's folded registry snapshot."""
    if not metrics:
        return ""

    def total(name: str) -> float:
        agg = metrics.get(name)
        if not agg:
            return 0.0
        return sum(s.get("value", s.get("count", 0)) or 0
                   for s in agg.get("samples", ()))

    parts = []
    rounds = total("trainer_rounds_total")
    if rounds:
        parts.append(f"rounds {int(rounds)}")
    trips = total("trainer_guard_trips_total")
    if trips:
        parts.append(f"guard {int(trips)}")
    audits = total("trainer_audit_trips_total")
    if audits:
        parts.append(f"audit {int(audits)}")
    batches = total("feed_batches_total")
    if batches:
        parts.append(f"feed {int(batches)}b")
    served = total("serve_completed_total")
    if served:
        parts.append(f"served {int(served)}")
    return " ".join(parts)


def offline_status(workdir: str) -> dict[str, Any]:
    """The fleet status view reconstructed from ``workdir``'s journal
    alone — no scheduler process, nothing launched, nothing signalled.
    The data source for ``tools/fleet.py --status [--json]``: external
    scrapers get the same facts the live table shows (journal state,
    newest checkpoint manifests, per-rank heartbeats, folded registry
    snapshots) without parsing the human rendering."""
    path = os.path.join(os.path.abspath(workdir), "fleet_journal.jsonl")
    events = FleetJournal.read(path)
    if not events:
        raise FleetError(f"no journal to read at {path}")
    devices = 0
    tenants: dict[str, int] = {}
    pool: HostPool | None = None
    order: list[str] = []
    specs: dict[str, JobSpec] = {}
    state: dict[str, str] = {}
    slots: dict[str, list[int]] = {}
    job_hosts: dict[str, list[str]] = {}
    host_transports: dict[str, str] = {}
    counters: dict[str, dict[str, int]] = {}
    for ev in events:
        kind = ev.get("ev")
        name = ev.get("job")
        c = counters.setdefault(name, {"episodes": 0, "attempts": 0,
                                       "preempts": 0}) if name else None
        if kind == "fleet":
            devices = ev.get("devices", devices)
            tenants = dict(ev.get("tenants") or {})
            if ev.get("hosts"):
                pool = HostPool.from_json(ev["hosts"])
        elif kind == "host":
            if pool is not None and ev.get("host") in pool \
                    and ev.get("state") in HOST_STATES:
                pool.mark(ev["host"], ev["state"])
        elif kind == "submit":
            specs[name] = JobSpec.from_json(ev["spec"])
            order.append(name)
            state[name] = QUEUED
        elif kind == "launch":
            state[name] = RUNNING
            slots[name] = list(ev.get("slots", []))
            job_hosts[name] = list(ev.get("hosts") or [])
            for h in job_hosts[name]:
                host_transports[h] = ev.get("transport", "local")
            c["episodes"] = ev.get("episode", c["episodes"] + 1)
        elif kind == "pids":
            c["attempts"] += 1
        elif kind == "preempt":
            state[name] = PREEMPTING
        elif kind == "release":
            # scale-down in flight: draining, then stopping; the
            # matching "complete" (released=True) lands at harvest
            if state.get(name) not in TERMINAL:
                state[name] = PREEMPTING
        elif kind == "requeue":
            state[name] = QUEUED
            slots.pop(name, None)
            job_hosts.pop(name, None)
            c["preempts"] = ev.get("preempts", c["preempts"] + 1)
        elif kind == "exit":
            if state.get(name) not in TERMINAL:
                state[name] = "EXITED"
            slots.pop(name, None)
            job_hosts.pop(name, None)
        elif kind == "complete":
            state[name] = COMPLETED
            slots.pop(name, None)
            job_hosts.pop(name, None)
        elif kind == "quarantine":
            state[name] = QUARANTINED
            slots.pop(name, None)
            job_hosts.pop(name, None)
        elif kind == "recover":
            state[name] = QUEUED
    jobs = []
    used_by_tenant: dict[str, int] = {}
    free = devices
    for name in order:
        spec = specs[name]
        job_dir = os.path.join(os.path.abspath(workdir), "jobs", name)
        probe = FleetJob(spec, job_dir, 0, 0.0)
        st = state.get(name, QUEUED)
        if st not in TERMINAL and probe.completed_ok():
            st = COMPLETED   # finished after the journal's last word
        job_slots = slots.get(name, []) if st in (RUNNING,
                                                  PREEMPTING) else []
        host_list = (job_hosts.get(name, []) if st in (RUNNING, PREEMPTING)
                     else [])
        if job_slots:
            free -= len(job_slots)
            used_by_tenant[spec.tenant] = (
                used_by_tenant.get(spec.tenant, 0) + len(job_slots))
        # newest attempt's heartbeat dir, scanned without a runner handle
        beats: dict[int, dict] = {}
        attempts = sorted(glob.glob(os.path.join(
            job_dir, "runner", "ep_*", "attempt_*", "hb")))
        if attempts:
            from . import health
            beats = {rank: {"round": b.round, "phase": b.phase,
                            "age_s": round(b.age(), 2),
                            **({"extras": b.extras} if b.extras else {})}
                     for rank, b in health.read_all(attempts[-1]).items()}
        metrics = job_metrics(job_dir)
        c = counters.get(name, {})
        jobs.append({
            "job": name, "kind": spec.kind, "model": spec.model,
            "tenant": spec.tenant,
            "state": st,
            "priority": spec.priority,
            "eff_priority": float(spec.priority),  # no live clock offline
            "world": spec.world, "slots": job_slots,
            "episodes": c.get("episodes", 0),
            "attempts": c.get("attempts", 0),
            "preempts": c.get("preempts", 0),
            "round": (spec.rounds if st == COMPLETED
                      else probe.newest_round()),
            "rounds_target": spec.rounds,
            "hosts": host_list,
            "heartbeats": beats,
            "metrics": metrics,
            "metrics_note": metrics_note(metrics),
        })
    by_tenant = {t: {"used": used_by_tenant.get(t, 0),
                     "quota": tenants.get(t)}
                 for t in sorted({j["tenant"] for j in jobs} |
                                 set(tenants))}
    out = {"devices": {"total": devices, "free": max(free, 0)},
           "tenants": by_tenant, "jobs": jobs}
    if pool is not None:
        out["hosts"] = hosts_view(
            pool, jobs, beat_ages=host_beat_ages(workdir, jobs),
            transports=host_transports)
    serving = serving_status(os.path.abspath(workdir), jobs)
    if serving:
        out["serving"] = serving
    return out


def serving_status(workdir: str, jobs: list[dict]) -> dict[str, Any]:
    """The serving-fleet half of a status view: per-model replica
    counts (from serve-kind job rows), the autoscaler's last decision +
    reason (``autoscale.json``), and the router table
    (``router.json``) — both written atomically by the live fleet, so
    this works on a dead one too.  Empty when the workdir never served."""
    out: dict[str, Any] = {}
    serve_jobs = [j for j in jobs if j.get("kind") == "serve"]
    if serve_jobs:
        models: dict[str, dict[str, int]] = {}
        for j in serve_jobs:
            key = j.get("model") or j["job"].rsplit("-", 1)[0]
            m = models.setdefault(key, {"replicas": 0, "running": 0})
            m["replicas"] += 1
            if j["state"] in (RUNNING, PREEMPTING):
                m["running"] += 1
        out["models"] = models
    for fname, key in (("autoscale.json", "autoscale"),
                       ("router.json", "router")):
        try:
            with open(os.path.join(workdir, fname)) as f:
                out[key] = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
    try:
        # journal-replayed channel state: works with the rollout
        # controller dead, which is exactly when status matters most
        from .rollout import status as rollout_status
        ro = rollout_status(workdir)
        if ro:
            out["rollout"] = ro
    except (OSError, ValueError):
        pass
    return out


def format_status(status: Mapping[str, Any]) -> str:
    """Render ``FleetScheduler.status()`` as a fixed-width table."""
    dev = status["devices"]
    lines = [f"fleet: devices {dev['total'] - dev['free']}/{dev['total']} "
             f"in use | tenants: "
             + ", ".join(f"{t} {v['used']}/{v['quota'] or '∞'}"
                         for t, v in status["tenants"].items())]
    hdr = (f"{'JOB':<16} {'TENANT':<8} {'STATE':<11} {'PRI':>5} "
           f"{'EFF':>6} {'GANG':>4} {'ROUND':>7} {'EP':>3} {'PRE':>3}  "
           f"HEARTBEAT")
    lines.append(hdr)
    for j in status["jobs"]:
        rnd = "-" if j["round"] is None else str(j["round"])
        hb = ""
        for rank, b in sorted(j["heartbeats"].items()):
            hb = (f"r{rank} {b['phase']}@{b['round']} "
                  f"({b['age_s']:.1f}s ago)")
            extras = b.get("extras") or {}
            stall = extras.get("stall_s")
            if stall:
                hb += f" stall {sum(stall.values()):.2f}s"
            if extras.get("serving"):
                # a serving job's beat: fold queue/latency telemetry the
                # way training jobs fold stall_s
                hb += (f" q{extras.get('queue_depth', 0)}"
                       f"+{extras.get('in_flight', 0)} "
                       f"p50 {extras.get('p50_ms', 0):.0f}ms "
                       f"p99 {extras.get('p99_ms', 0):.0f}ms")
                slo = extras.get("slo") or {}
                if slo.get("state") == "breach":
                    hb += f" SLO:BREACH({slo.get('breaches', 0)})"
                elif slo.get("state"):
                    hb += " SLO:ok"
            break   # first rank is enough for the one-liner
        note = j.get("metrics_note")
        if note:
            hb = f"{hb} [{note}]" if hb else f"[{note}]"
        lines.append(
            f"{j['job']:<16} {j['tenant']:<8} {j['state']:<11} "
            f"{j['priority']:>5} {j['eff_priority']:>6.1f} "
            f"{j['world']:>4} {rnd:>3}/{j['rounds_target']:<3} "
            f"{j['episodes']:>3} {j['preempts']:>3}  {hb}")
    for hname, h in (status.get("hosts") or {}).items():
        gangs = ",".join(h.get("gangs") or []) or "-"
        extra = ""
        if h.get("lease"):
            extra += f" lease={h['lease']}"
        if h.get("beat_age_s") is not None:
            extra += f" beat={h['beat_age_s']:.1f}s"
        if h.get("transport") and h["transport"] != "local":
            extra += f" via={h['transport']}"
        lines.append(f"host:    {hname:<16} {h.get('state', '?'):<9} "
                     f"{h.get('used', 0)}/{h.get('devices', 0)} devices "
                     f"@{h.get('addr', '?')} gangs={gangs}{extra}")
    serving = status.get("serving") or {}
    auto = (serving.get("autoscale") or {}).get("models") or {}
    for model, m in sorted((serving.get("models") or {}).items()):
        line = (f"serving: {model:<20} replicas "
                f"{m['running']}/{m['replicas']}")
        rec = auto.get(model) or {}
        last = rec.get("last")
        if rec.get("backlog") is not None:
            line += f" backlog {rec['backlog']}"
        if last:
            age = time.time() - (serving.get("autoscale") or {}).get(
                "t", time.time())
            line += (f" | last {last['action']} ({last['reason']})"
                     + (f" {age:.0f}s ago" if age >= 1 else ""))
        lines.append(line)
    router = serving.get("router") or {}
    for rid, r in sorted((router.get("replicas") or {}).items()):
        lines.append(f"router:  {rid:<20} {r.get('state', '?'):<9} "
                     f"out={r.get('outstanding', 0)} "
                     f"done={r.get('completed', 0)} "
                     f"fail={r.get('failed', 0)} "
                     f"models={','.join(r.get('models') or [])}")
    counts = router.get("counts")
    if counts:
        lines.append("router:  " + " ".join(
            f"{k}={v}" for k, v in sorted(counts.items())))
    for model, ro in sorted((serving.get("rollout") or {}).items()):
        line = (f"rollout: {model:<20} {ro.get('phase', '?'):<14} "
                f"stable={ro.get('stable') or '-'}")
        if ro.get("canary"):
            line += (f" canary={ro['canary']}"
                     f"@{ro.get('weight', 0.0):g}")
        if ro.get("last_verdict"):
            line += f" verdict={ro['last_verdict']}"
        if ro.get("last_rollback_reason"):
            line += f" | rolled back: {ro['last_rollback_reason']}"
        lines.append(line)
    return "\n".join(lines)
