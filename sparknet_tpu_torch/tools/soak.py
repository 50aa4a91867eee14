"""Chaos soak runner: supervised training runs and fleets under seeded
fault schedules, each checked for exact recovery, with a JSON verdict.

The port's own copy of the root ``tools/soak.py`` (its restart, fleet and
rollout modes), with the port's ``--device`` (cuda unless the caller asks
for the CPU).  The randomness comes from ``--seed`` alone, so a red
verdict replays with the same command line.

Restart mode (default): ``--runs`` times, pick a fault schedule (crash,
torn checkpoint write, corrupt checkpoint, NaN poison, straggle and
crash) with a seeded round, run the 4-round lenet driver
(``sparknet_tpu_torch.tools.multihost_driver``, 4 workers on the device)
under ResilientRunner supervision, and require the finished params to
equal the fault-free baseline bit for bit.  The JAX tool's
``bitflip_params`` schedule (multihost_driver's ``--audit-every``) is not in
the menu yet: it comes with the pod soak (ROADMAP A, order 3b).

Fleet mode (``--fleet N``): N seeded jobs, each with its own injected
crash / preempt / nan / straggle schedule, run concurrently under one
``FleetScheduler``, with a late high-priority job sized to the whole
device budget that preempts everything running.  ``--fleet-kill``
SIGKILLs the scheduler process mid-run and resumes it from its journal.
The verdict needs every job at its target round with params bit for bit
its fault-free baseline, and no orphaned worker process.

Rollout mode (``--rollout``): the deployment plane in one process over a
real registry, router and per-version engines: a healthy canary earns
promotion, a poisoned canary (``bad_canary``) is rolled back with no
damage to stable traffic, and a controller killed mid-rollout resumes to
a consistent fleet.

Net mode (``--net``): the network chaos legs over the ssh wire format
(``SshTransport`` through a local fake-ssh shim, or a caller-supplied
SPARKNET_SSH_CMD) wrapped in a ``ChaosTransport``: (1) partition, suspend,
heal: the beat relay to a gang in mid-round is severed; the lease must
mark the host SUSPECT (no straggler kill, no restart), the heal lift the
suspension, and the params finish bit for bit the fault-free baseline;
(2) fenced zombie ship: an incarnation checkpoints on one host, its
requeue on a checkpoint-less host pulls the newest valid round over a
link that tears the first transfer (the retry resumes the torn prefix,
crc-verified), resumes bit for bit, and the fenced-off incarnation's
return is refused at the fence; (3, full runs only) slow link: a delayed
relay is not silence (no suspect, no kill, bit for bit).  ``--net-slice``
runs legs 1 and 2.  The gangs are one driver process of 4 workers on the
device (``--device`` rides the remote command line).  The JAX leg 1 holds
its gang in mid-round while XLA compiles its first round; the port's
driver has nothing to compile, so leg 1 holds it with a straggle
(``PARTITION_HOLD``) longer than the round deadline, which only the
suspension keeps from a straggler kill.

``--pod`` (multi-process training gangs over simulated hosts beside a
served tenant) raises: it is the next slice (ROADMAP A12, pod half;
ROADMAP A, order 3b).

Usage:
  python -m sparknet_tpu_torch.tools.soak --runs 8 --seed 0 [--device cpu]
  python -m sparknet_tpu_torch.tools.soak --fleet 4 --fleet-kill --seed 0
  python -m sparknet_tpu_torch.tools.soak --rollout --seed 0
  python -m sparknet_tpu_torch.tools.soak --net --net-slice [--device cpu]

Exit code 0 iff every run recovered exactly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

POD_HALF = "ROADMAP A12, pod half"


def _schedules(rng):
    """One randomized-but-seeded fault schedule menu: (name,
    SPARKNET_FAULT value, extra driver flags).  Rounds land in [1, 3) so
    the 4-round workload always has a checkpoint before and rounds after
    the fault."""
    r = int(rng.integers(1, 3))
    return [
        ("crash", f"crash@round:{r}", []),
        ("crash_in_ckpt", f"crash_in_ckpt@round:{r}", []),
        ("corrupt_ckpt", f"corrupt_ckpt@round:{r}", []),
        ("nan_inject", f"nan_inject@round:{r}", ["--guard"]),
        ("straggle+crash",
         f"straggle:0.5s@round:{r},crash@round:{r}@attempt:0", []),
    ]


# telemetry env survives the scrub, so a traced soak yields one timeline
_KEEP_ENV = ("SPARKNET_TELEMETRY", "SPARKNET_TRACE_DIR",
             "SPARKNET_METRICS_SNAP", "SPARKNET_METRICS_SNAP_S",
             "SPARKNET_RUN_ID", "SPARKNET_FLIGHT_EVENTS")


def _clean_env():
    for k in list(os.environ):
        if k.startswith("SPARKNET_") and k not in _KEEP_ENV:
            os.environ.pop(k)


def _child_env() -> dict:
    """``-m sparknet_tpu_torch...`` resolves from any directory."""
    from ..parallel.fleet import _REPO
    path = os.environ.get("PYTHONPATH", "")
    return {"PYTHONPATH": os.pathsep.join(p for p in (_REPO, path) if p)}


def _run_driver(out, ckpt, flags, fault=None, max_restarts=2,
                local_devices=4, rounds=4, device="cuda"):
    from ..parallel.fleet import DRIVER_CMD
    from ..parallel.resilience import ResilientRunner, RestartPolicy
    cmd = [*DRIVER_CMD, "--strategy", "sync", "--out", out,
           "--local-devices", str(local_devices),
           "--expect-devices", str(local_devices),
           "--rounds", str(rounds), "--device", device] + flags
    if ckpt:
        cmd += ["--ckpt-dir", ckpt]
    env = _child_env()
    if fault:
        env["SPARKNET_FAULT"] = fault
    runner = ResilientRunner(
        cmd, nprocs=1, timeout=300,
        policy=RestartPolicy(max_restarts=max_restarts, backoff_base=0.2),
        extra_env=env)
    rc = runner.run()
    return rc, len(runner.attempts)


def _params_match(base_npz, out_npz):
    import numpy as np
    a, b = np.load(base_npz), np.load(out_npz)
    for k in a.files:
        if k.startswith("__"):
            continue
        if not np.array_equal(a[k], b[k]):
            return False, k
    return True, None


# ---------------------------------------------------------------------------
# Net chaos legs (--net): partition vs death, fenced checkpoint shipping,
# and slow-link attribution over the ssh wire format (SshTransport through
# a fake-ssh shim) with ChaosTransport injecting the network faults
# ---------------------------------------------------------------------------

NET_ROUNDS = 8
# leg 1's gang: a straggle at round 1, longer than the 3 s round deadline,
# keeps the driver in mid-round while the link is severed
PARTITION_HOLD = "straggle:3.5s@round:1"
ROUND_DEADLINE_S = 3.0


def _fake_ssh_shim(workdir: str) -> str:
    """Write the fake-ssh shim: it runs the remote command string
    locally with the exact argv ssh receives (``$4`` is the remote string
    after ``-o BatchMode=yes <host>``), so the wire format, env contract
    and stdio plumbing are the production path with no sshd.  ``exec``
    keeps the worker pid the Popen pid."""
    path = os.path.join(workdir, "fake-ssh")
    with open(path, "w") as f:
        f.write('#!/bin/bash\nexec bash -c "$4"\n')
    os.chmod(path, 0o755)
    return path


class _TornOnceInjector:
    """Minimal injector for ChaosTransport: tear the first ``torn`` ship
    attempts (each leaves a half-written temporary the retry must resume
    past), then run clean.  Duck-typed to the injector surface the
    transport consumes."""

    def __init__(self, torn: int = 1):
        self.torn = torn
        self.specs = ()

    def net_specs(self):
        return []

    def drop_ship(self, seq):
        return False

    def torn_ship(self):
        if self.torn > 0:
            self.torn -= 1
            return True
        return False


def _net_knobs(workdir: str) -> None:
    """The net legs' env: the fake-ssh wire (unless the caller supplied a
    real SPARKNET_SSH_CMD), a tight lease so a partition is suspected
    within about 1 s, and small ship chunks so a torn transfer's resume
    moves a real whole-chunk prefix.  The ssh-spawned workers inherit
    this process's env through the shim."""
    os.environ.setdefault("SPARKNET_SSH_CMD", _fake_ssh_shim(workdir))
    os.environ.setdefault("SPARKNET_LEASE_S", "0.5")
    os.environ.setdefault("SPARKNET_LEASE_MISSES", "2")
    os.environ.setdefault("SPARKNET_SHIP_CHUNK_MB", "0.0625")


def _wire_driver(out, rounds, *, host, device, ckpt=None, extra_env=None,
                 transport=None, heartbeat_dir=None, round_deadline=None,
                 report=None) -> int:
    """One driver run over the ssh wire: a single rank of 4 workers on
    the fake remote host (SPARKNET_NUM_PROCS=1, the gang shape the fleet
    places).  ``host`` is the host label (beat staging and lease
    identity); the transport address stays 127.0.0.1, the name-vs-addr
    split a HostPool inventory makes."""
    from ..parallel.fleet import _REPO, DRIVER_CMD
    from .launch import free_port, launch_ssh
    cmd = [*DRIVER_CMD, "--strategy", "sync", "--out", out,
           "--local-devices", "4", "--expect-devices", "4",
           "--rounds", str(rounds)]
    if ckpt:
        cmd += ["--ckpt-dir", ckpt]
    return launch_ssh(cmd, hosts=["127.0.0.1"], host_map=[host],
                      coordinator_port=free_port(), device=device,
                      cwd=_REPO, timeout=300,
                      extra_env={**_child_env(), **(extra_env or {})},
                      transport=transport, heartbeat_dir=heartbeat_dir,
                      round_deadline=round_deadline, report=report)


def _net_partition_episode(workdir, baseline, rounds, *, device,
                           slow_ms: float | None = None) -> dict:
    """Symmetric partition in mid-round (or, with ``slow_ms``, a degraded
    link): sever the beat relay to a healthy gang.  The lease must mark
    the host SUSPECT and suspend its rank (no straggler kill, no restart)
    and lift the suspension on heal, and the params must finish bit for
    bit the baseline.  The slow-link variant holds the opposite: delay is
    not silence, so no suspect and no kill."""
    import threading

    from ..parallel import health
    from ..parallel.transport import ChaosTransport, SshTransport

    name = "slow_link_attribution" if slow_ms else "partition_suspend_heal"
    epdir = os.path.join(workdir, name)
    os.makedirs(epdir, exist_ok=True)
    out = os.path.join(epdir, "out.npz")
    hb = os.path.join(epdir, "hb")
    host = "hostb"
    chaos = ChaosTransport(SshTransport(), injector=_TornOnceInjector(0))
    flap: dict = {}

    def flapper():
        # wait until the first beat has been relayed (the monitor has the
        # host's liveness on file: a partition before any relayed beat is
        # startup grace, not a lease event), then flap the link
        hdir = health.host_dir(hb, host)
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if health._read_flat(hdir):
                break
            time.sleep(0.05)
        else:
            flap["error"] = "no beat ever relayed"
            return
        if slow_ms:
            chaos.set_slow(host, slow_ms)
            flap["slow_ms"] = slow_ms
            time.sleep(3.0)
            chaos.set_slow(host, 0)
            flap["restored"] = True
        else:
            chaos.partition(host)
            flap["partitioned"] = time.time()   # the lease monitor's clock
            time.sleep(4.0)   # 4x the 1 s lease window, > round deadline
            chaos.heal(host)
            flap["healed"] = time.time()

    th = threading.Thread(target=flapper, daemon=True)
    th.start()
    report: dict = {}
    t0 = time.monotonic()
    rc = _wire_driver(out, rounds, host=host, device=device,
                      transport=chaos, heartbeat_dir=hb,
                      round_deadline=ROUND_DEADLINE_S, report=report,
                      extra_env=None if slow_ms
                      else {"SPARKNET_FAULT": PARTITION_HOLD})
    th.join(timeout=15.0)
    match, bad = False, None
    if rc == 0:
        match, bad = _params_match(baseline, out)
    lease: dict = {}
    if "healed" in flap:
        cut, healed = flap.pop("partitioned"), flap.pop("healed")
        flap["partition_s"] = round(healed - cut, 3)
        flap["healed"] = True
        since = (report.get("suspect_since") or {}).get(host)
        if since is not None:
            # partition -> SUSPECT (the lease's detection), SUSPECT -> heal
            lease = {"lease_detect_s": round(since - cut, 3),
                     "suspect_to_heal_s": round(healed - since, 3)}
    row = {"episode": name, "rc": rc, "cause": report.get("cause"),
           "transport": report.get("transport"),
           "suspects": report.get("suspect_hosts"),
           "confirmed_down": report.get("confirmed_down"),
           "stragglers": report.get("stragglers"), "flap": flap,
           **lease,
           "match": match, "elapsed_s": round(time.monotonic() - t0, 1)}
    if bad:
        row["diverged_at"] = bad
    if slow_ms:
        row["ok"] = bool(rc == 0 and match
                         and report.get("cause") == "clean"
                         and not report.get("suspect_hosts")
                         and not report.get("stragglers")
                         and flap.get("restored"))
    else:
        row["hold"] = PARTITION_HOLD
        row["ok"] = bool(rc == 0 and match
                         and report.get("cause") == "clean"
                         and report.get("suspect_hosts") == [host]
                         and not report.get("confirmed_down")
                         and not report.get("stragglers")
                         and flap.get("healed"))
    return row


def _net_fenced_ship_episode(workdir, baseline, rounds, *, device) -> dict:
    """Fenced, resumable checkpoint shipping end to end: incarnation 1
    (fence token 100001) trains half the rounds checkpointing on hosta;
    its requeue lands on checkpoint-less hostb, which pulls the newest
    valid round over a link that tears the first transfer (the retry must
    resume the torn whole-chunk prefix and land crc-verified).
    Incarnation 2 (token 200002) resumes from the shipped files and must
    finish bit for bit the uninterrupted baseline.  Then the fenced-off
    incarnation returns from behind the partition and tries to reclaim
    the dir: a typed refusal at the fence, no state touched."""
    import glob

    from ..parallel.transport import (ChaosTransport, SshTransport,
                                      newest_valid_round,
                                      ship_latest_checkpoint)
    from ..utils.checkpoint import (CheckpointFencedError, advance_fence,
                                    read_fence)

    epdir = os.path.join(workdir, "fenced_zombie_ship")
    os.makedirs(epdir, exist_ok=True)
    ck_a = os.path.join(epdir, "ckpt_host_hosta")
    ck_b = os.path.join(epdir, "ckpt_host_hostb")
    out = os.path.join(epdir, "out.npz")
    t0 = time.monotonic()
    row: dict = {"episode": "fenced_zombie_ship"}

    rc1 = _wire_driver(os.path.join(epdir, "half.npz"), rounds // 2,
                       host="hosta", device=device, ckpt=ck_a,
                       extra_env={"SPARKNET_FENCE_TOKEN": "100001"})
    row["rc_first"] = rc1

    chaos = ChaosTransport(SshTransport(), injector=_TornOnceInjector())
    try:
        rec = ship_latest_checkpoint(chaos, "hostb", ck_a, ck_b)
    except (OSError, RuntimeError, ValueError) as e:  # ShipError is OSError
        rec = None
        row["ship_error"] = f"{type(e).__name__}: {e}"
    row["ship"] = rec

    rc2 = _wire_driver(out, rounds, host="hostb", device=device, ckpt=ck_b,
                       extra_env={"SPARKNET_FENCE_TOKEN": "200002"})
    row["rc_resume"] = rc2
    match, bad = False, None
    if rc2 == 0:
        match, bad = _params_match(baseline, out)
    if bad:
        row["diverged_at"] = bad

    zombie: dict = {"refused": False}
    try:
        advance_fence(ck_b, 100002)
    except CheckpointFencedError as e:
        zombie = {"refused": True, "error": type(e).__name__,
                  "token": e.token, "fence": e.fence}
    torn_left = glob.glob(os.path.join(ck_b, "*.tmp*"))
    row.update(
        zombie=zombie, fence=read_fence(ck_b),
        newest_round=newest_valid_round(ck_b), match=match,
        elapsed_s=round(time.monotonic() - t0, 1),
        ok=bool(rc1 == 0 and rc2 == 0 and match and rec
                and rec.get("round") == rounds // 2
                and rec.get("resumed_bytes", 0) > 0
                and zombie.get("refused")
                and zombie.get("fence") == read_fence(ck_b)
                and not torn_left))
    if torn_left:
        row["torn_leftovers"] = torn_left
    return row


def _net_episodes(workdir, baseline, rounds, *, net_slice: bool,
                  device: str) -> list:
    """The net chaos leg set."""
    episodes = [
        _net_partition_episode(workdir, baseline, rounds, device=device),
        _net_fenced_ship_episode(workdir, baseline, rounds, device=device),
    ]
    if not net_slice:
        episodes.append(_net_partition_episode(
            workdir, baseline, rounds, device=device, slow_ms=250.0))
    for e in episodes:
        print(f"net-soak: {e['episode']} -> "
              f"{'OK' if e['ok'] else 'FAIL'} ({e['elapsed_s']}s)",
              flush=True)
    return episodes


def net_soak(args) -> int:
    from ..parallel.health import lease_window_s
    from ..utils.device import resolve_device

    device = resolve_device(args.device).type
    _clean_env()
    own_tmp = args.workdir is None
    workdir = args.workdir or tempfile.mkdtemp(prefix="sparknet_net_")
    os.makedirs(workdir, exist_ok=True)
    _net_knobs(workdir)
    t0 = time.monotonic()
    rounds = NET_ROUNDS
    base = os.path.join(workdir, "base.npz")
    rc, _ = _run_driver(base, None, [], rounds=rounds, device=device)
    if rc != 0:
        raise RuntimeError(f"fault-free baseline failed rc={rc}")
    episodes = _net_episodes(workdir, base, rounds,
                             net_slice=args.net_slice, device=device)
    passed = sum(1 for e in episodes if e["ok"])
    report = {"mode": "net", "seed": args.seed, "device": device,
              "slice": bool(args.net_slice), "rounds": rounds,
              "lease_window_s": lease_window_s(), "episodes": episodes,
              "passed": passed, "failed": len(episodes) - passed,
              "elapsed_s": round(time.monotonic() - t0, 1),
              "ok": bool(episodes) and passed == len(episodes)}
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"net-soak: verdict written to {args.out} "
              f"({passed}/{len(episodes)} episode(s) passed)")
    else:
        print(text)
    if own_tmp and report["ok"]:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    elif not report["ok"]:
        print(f"net-soak: scratch kept at {workdir} for post-mortem",
              file=sys.stderr)
    return 0 if report["ok"] else 1


# ---------------------------------------------------------------------------
# Fleet chaos soak (--fleet N): concurrent jobs, one scheduler, injected
# crash/straggle/preempt/nan schedules + fleet-level priority preemption
# (+ optional scheduler kill/resume), verified bit-identical and orphan-free
# ---------------------------------------------------------------------------

def _fleet_schedules(rng, i):
    """Seeded fault schedule for fleet job ``i``.  The first FOUR jobs
    are pinned to the crash / preempt / nan / straggle families in that
    order, so a 2-job smoke always covers
    the preempt/resume/crash triangle and any >= 4-job acceptance run
    covers all four; later jobs draw seeded from the full menu (the
    round numbers stay seeded for every job)."""
    r = int(rng.integers(1, 3))
    menu = [
        ("crash", f"crash@round:{r}", False),
        ("preempt", f"preempt@round:{r}", False),
        ("nan_inject", f"nan_inject@round:{r}", True),
        ("straggle+crash",
         f"straggle:0.5s@round:{r},crash@round:{r}@attempt:0", False),
        ("crash_in_ckpt", f"crash_in_ckpt@round:{r}", False),
        ("corrupt_ckpt", f"corrupt_ckpt@round:{r}", False),
    ]
    if i < 4:
        return menu[i]
    return menu[int(rng.integers(0, len(menu)))]


def _journal_pids(workdir):
    """Every worker pid the fleet journal ever recorded."""
    from ..parallel.fleet import FleetJournal
    pids = {}
    path = os.path.join(workdir, "fleet_journal.jsonl")
    for ev in FleetJournal.read(path):
        if ev.get("ev") == "pids":
            pids.setdefault(ev["job"], set()).update(ev.get("pids", []))
    return pids


def fleet_soak(args) -> int:
    import numpy as np

    from ..parallel.fleet import (
        FleetScheduler, JobSpec, _pid_is_fleet_job, format_status,
    )
    from ..utils.device import resolve_device

    device = resolve_device(args.device).type
    _clean_env()
    rng = np.random.default_rng(args.seed)
    own_tmp = args.workdir is None
    workdir = args.workdir or tempfile.mkdtemp(prefix="sparknet_fleet_")
    os.makedirs(workdir, exist_ok=True)
    fleet_dir = os.path.join(workdir, "fleet")
    devices = args.fleet_devices
    t0 = time.monotonic()

    # -- job set: N faulted jobs + the late high-priority preemptor ------
    specs, meta = [], {}
    for i in range(args.fleet):
        name, fault, guard = _fleet_schedules(rng, i)
        spec = JobSpec(
            name=f"job{i}", tenant=("acme", "beta")[i % 2],
            priority=i % 2, world=args.fleet_world, rounds=4, guard=guard,
            fault=fault,
            max_restarts=2, timeout_s=300.0)
        specs.append(spec)
        meta[spec.name] = {"schedule": name, "fault": fault}
    preemptor = JobSpec(
        name="preemptor", tenant="ops", priority=99, world=devices,
        rounds=3, not_before_s=args.fleet_preempt_after,
        preemptible=False, timeout_s=300.0)
    specs.append(preemptor)
    meta[preemptor.name] = {"schedule": "clean-high-priority", "fault": None}

    # -- fault-free baselines, one per distinct job shape ----------------
    baselines: dict[tuple, str] = {}

    def baseline_for(spec):
        key = (spec.world, spec.rounds, spec.guard)
        if key not in baselines:
            path = os.path.join(workdir, f"base_{len(baselines)}.npz")
            ck = os.path.join(workdir, f"base_ck_{len(baselines)}")
            flags = ["--guard"] if spec.guard else []
            rc, _ = _run_driver(path, ck if flags else None, flags,
                                local_devices=spec.world,
                                rounds=spec.rounds, device=device)
            if rc != 0:
                raise RuntimeError(f"fault-free baseline failed rc={rc} "
                                   f"(shape={key})")
            baselines[key] = path
        return baselines[key]

    for spec in specs:
        baseline_for(spec)

    # -- run the fleet (optionally killing the scheduler mid-run) --------
    killed = False
    if args.fleet_kill:
        jobs_json = os.path.join(workdir, "jobs.json")
        with open(jobs_json, "w") as f:
            json.dump([s.to_json() for s in specs], f)
        import signal
        import subprocess
        proc = subprocess.Popen(
            [sys.executable, "-m", "sparknet_tpu_torch.tools.fleet",
             "--workdir", fleet_dir, "--devices", str(devices),
             "--jobs", jobs_json, "--status-every", "0",
             "--device", device],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env={**os.environ, **_child_env()})
        time.sleep(args.fleet_kill_after)
        proc.send_signal(signal.SIGKILL)   # no grace: the worst case
        proc.wait()
        killed = True
        print(f"fleet-soak: scheduler SIGKILLed after "
              f"{args.fleet_kill_after}s; resuming from the journal",
              flush=True)
        fleet = FleetScheduler.resume(fleet_dir, device=device)
    else:
        fleet = FleetScheduler(fleet_dir, devices,
                               tenants={"acme": devices, "beta": devices},
                               device=device)
        for spec in specs:
            fleet.submit(spec)
    rc = fleet.run(tick_s=0.1, timeout_s=args.fleet_timeout)

    # -- verdict ---------------------------------------------------------
    jobs = []
    for spec in specs:
        job = fleet.jobs[spec.name]
        verdict = dict(meta[spec.name], job=spec.name, state=job.state,
                       episodes=job.episodes, attempts=job.restarts_used,
                       preempts=job.preempt_count)
        if job.state == "COMPLETED":
            match, bad = _params_match(baseline_for(spec), job.out_path)
            verdict.update(match=match,
                           **({"diverged_at": bad} if not match else {}))
        else:
            verdict.update(match=False)
        verdict["ok"] = job.state == "COMPLETED" and verdict["match"]
        jobs.append(verdict)

    # zero-orphans: every pid the journal ever recorded must be dead (or
    # provably not ours anymore)
    orphans = {name: sorted(p for p in pids
                            if _pid_is_fleet_job(p, name))
               for name, pids in _journal_pids(fleet_dir).items()}
    orphans = {k: v for k, v in orphans.items() if v}
    preempt_seen = any(j["preempts"] > 0 for j in jobs)

    passed = sum(1 for j in jobs if j["ok"])
    report = {"mode": "fleet", "seed": args.seed, "devices": devices,
              "device": device,
              "killed_scheduler": killed, "jobs": jobs,
              "passed": passed, "failed": len(jobs) - passed,
              "orphans": orphans, "preemption_exercised": preempt_seen,
              "elapsed_s": round(time.monotonic() - t0, 1),
              "ok": (rc == 0 and passed == len(jobs) and not orphans
                     and preempt_seen)}
    print(format_status(fleet.status()), flush=True)
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"fleet-soak: verdict written to {args.out} "
              f"({passed}/{len(jobs)} passed"
              f"{', orphans!' if orphans else ''})")
    else:
        print(text)
    if own_tmp and report["ok"]:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    elif not report["ok"]:
        print(f"fleet-soak: scratch kept at {workdir} for post-mortem",
              file=sys.stderr)
    return 0 if report["ok"] else 1


# ---------------------------------------------------------------------------
# Rollout chaos legs (--rollout): the deployment plane end to end — a
# healthy canary must promote, a poisoned canary must auto-roll back
# with zero client-visible damage on stable traffic, and a controller
# killed mid-rollout must resume to a consistent fleet.


class _RolloutFleet:
    """In-process serving tier keyed by VERSIONED name: the rollout
    controller's ensure/retire/verdict wiring.  Every versioned name
    gets its own house + engine (whose built-in per-version SLOMonitor
    is the judge's verdict source) behind one real Router — the same
    shape ``serve --fleet`` runs, minus the HTTP hop."""

    def __init__(self, registry, cfg, router, device="cuda"):
        self.registry = registry
        self.cfg = cfg
        self.device = device
        self.router = router
        self.live: dict = {}      # versioned name -> (rid, engine)

    def ensure(self, name: str) -> None:
        if name in self.live:
            return
        from ..parallel.router import InProcessReplica
        from ..parallel.serving import InferenceEngine, ModelHouse
        model, _, version = name.partition("@")
        house = ModelHouse(self.cfg, device=self.device)
        house.load_version(model, version, registry=self.registry)
        eng = InferenceEngine(house, self.cfg)
        rid = f"r-{version}"
        self.router.add_replica(rid, InProcessReplica(rid, eng))
        self.live[name] = (rid, eng)

    def retire(self, name: str) -> None:
        ent = self.live.pop(name, None)
        if ent is None:
            return
        rid, eng = ent
        self.router.drain(rid, timeout_s=30.0)
        eng.stop()

    def verdict(self, name: str):
        ent = self.live.get(name)
        if ent is None:
            return None
        return ent[1].slo.evaluate()

    def close(self) -> None:
        for name in list(self.live):
            self.retire(name)


def _rollout_promote_episode(ctl, fleet, reg, router, inputs, refs,
                             v1, v2) -> dict:
    """A HEALTHY canary must earn promotion: sustained green verdicts
    over the request floor, old stable drained, pinned-canary answers
    bit-identical across the pointer flip."""
    import numpy as np
    from ..parallel.registry import versioned
    from ..parallel.serving import ServingError

    t0 = time.monotonic()
    reg.set_channels("lenet", stable=v1)
    fleet.ensure(versioned("lenet", v1))
    ctl.start_canary("lenet", v2, weight=0.5)
    pins = inputs[:4]
    pre = [router.classify("lenet", x, version=v2, timeout=60).probs
           for x in pins]

    errors = mism = iters = 0
    decision = "canary"
    deadline = time.monotonic() + 120.0
    while decision == "canary" and time.monotonic() < deadline:
        for i, x in enumerate(inputs):
            try:
                res = router.classify("lenet", x, tenant="rollsoak",
                                      timeout=60)
            except ServingError:
                errors += 1      # untyped errors crash the episode: bug
            else:
                if not np.array_equal(res.probs, refs[res.padded_to][i]):
                    mism += 1
        iters += 1
        decision = ctl.judge("lenet")
        time.sleep(0.05)

    promoted = decision == "promote"
    if promoted:
        ctl.promote("lenet")
    post = [router.classify("lenet", x, version=v2, timeout=60).probs
            for x in pins]
    ch = reg.channels("lenet")
    pin_ok = all(np.array_equal(a, b) for a, b in zip(pre, post))
    old_gone = (versioned("lenet", v1) not in fleet.live
                and f"r-{v1}" not in router.replica_ids())
    return {"episode": "canary_promote", "stable": v1, "canary": v2,
            "promoted": promoted, "iters": iters,
            "stable_errors": errors, "mismatches": mism,
            "pin_identical": pin_ok, "old_stable_drained": old_gone,
            "channels": ch,
            "elapsed_s": round(time.monotonic() - t0, 1),
            "ok": bool(promoted and errors == 0 and mism == 0
                       and pin_ok and old_gone
                       and ch["stable"] == v2 and ch["canary"] is None)}


def _rollout_bad_canary_episode(ctl, fleet, reg, router, inputs, refs,
                                stable, trace_dir) -> dict:
    """A POISONED canary (planted ``bad_canary`` fault: the model head
    emits NaNs) must be caught by the judge and auto-rolled back: zero
    errors on stable-pinned traffic, zero non-finite rows ever served,
    channel reverted, canary drained, flight dump on disk, and the
    journal resuming as consistent with pinned answers bit-identical
    across the recovery."""
    import glob

    import numpy as np

    from ..parallel.registry import versioned
    from ..parallel.rollout import RolloutController
    from ..parallel.serving import ServingError

    t0 = time.monotonic()
    v3 = reg.publish("lenet", notes="rollout soak v3 (to be poisoned)")
    pins = inputs[:4]
    pre = [router.classify("lenet", x, version=stable, timeout=60).probs
           for x in pins]
    dumps_before = len(glob.glob(os.path.join(
        trace_dir, "*rollout_rollback*")))

    # the canary is born bad: every batch of the poisoned version
    # produces NaNs (the engine must fail them TYPED, never serve them)
    os.environ["SPARKNET_FAULT"] = f"bad_canary:{v3}"
    stable_errors = typed = untyped = served_bad = mism = 0
    try:
        ctl.start_canary("lenet", v3, weight=0.5)
        t_live = time.monotonic()
        decision = "canary"
        deadline = time.monotonic() + 120.0
        while decision == "canary" and time.monotonic() < deadline:
            for i, x in enumerate(inputs):
                try:
                    res = router.classify("lenet", x, tenant="rollsoak",
                                          timeout=60)
                except ServingError:
                    typed += 1       # the canary failing loudly is fine
                # measuring untyped leakage IS this episode's job: the
                # soak asserts this counter stays zero
                except Exception:  # sparklint: disable=CD003
                    untyped += 1     # anything untyped is not
                else:
                    if not np.isfinite(res.probs).all():
                        served_bad += 1   # NaN reached a client: red
                    elif not np.array_equal(res.probs,
                                            refs[res.padded_to][i]):
                        mism += 1
            # stable-PINNED traffic must never feel the canary at all
            try:
                router.classify("lenet", inputs[0], version=stable,
                                timeout=60)
            except ServingError:
                stable_errors += 1   # untyped here crashes the episode
            decision = ctl.judge("lenet")
            time.sleep(0.05)
        rolled_back = decision == "rollback"
        detect_s = round(time.monotonic() - t_live, 2)
        if rolled_back:
            ctl.rollback("lenet", reason="sustained SLO breach "
                                         "(bad canary)")
    finally:
        os.environ.pop("SPARKNET_FAULT", None)

    ch = reg.channels("lenet")
    ro = router.rollout("lenet")
    drained = (versioned("lenet", v3) not in fleet.live
               and f"r-{v3}" not in router.replica_ids())
    dumped = len(glob.glob(os.path.join(
        trace_dir, "*rollout_rollback*"))) > dumps_before
    post = [router.classify("lenet", x, version=stable, timeout=60).probs
            for x in pins]
    pin_ok = all(np.array_equal(a, b) for a, b in zip(pre, post))
    # a fresh controller over the same journal must find nothing to fix
    resumed = RolloutController(
        reg, ctl.workdir, ensure=fleet.ensure, retire=fleet.retire,
        verdict=fleet.verdict, router=router, cfg=ctl.cfg).resume()
    post2 = [router.classify("lenet", x, version=stable,
                             timeout=60).probs for x in pins]
    pin_ok = pin_ok and all(np.array_equal(a, b)
                            for a, b in zip(pre, post2))
    return {"episode": "bad_canary_rollback", "stable": stable,
            "canary": v3, "rolled_back": rolled_back,
            "detect_s": detect_s, "stable_errors": stable_errors,
            "canary_typed_failures": typed, "untyped_errors": untyped,
            "served_bad": served_bad, "mismatches": mism,
            "drained": drained, "flight_dump": dumped,
            "pin_identical": pin_ok,
            "resume": resumed.get("lenet", "consistent"),
            "channels": ch,
            "elapsed_s": round(time.monotonic() - t0, 1),
            "ok": bool(rolled_back and stable_errors == 0 and typed > 0
                       and untyped == 0 and served_bad == 0
                       and mism == 0 and drained and dumped and pin_ok
                       and ch["stable"] == stable
                       and ch["canary"] is None and ch["weight"] == 0.0
                       and ro is not None and ro.canary is None
                       and resumed.get("lenet",
                                       "consistent") == "consistent")}


def _rollout_resume_episode(workdir) -> dict:
    """Kill the controller at BOTH dangerous points — after the canary
    went live (before any judgment) and between ``promote_begin`` and
    its ``done`` — and prove resume lands on exactly one of {fully
    stable, fully promoted}, idempotently, with no orphan replicas."""
    from ..parallel.registry import ModelRegistry, versioned
    from ..parallel.rollout import RolloutConfig, RolloutController

    t0 = time.monotonic()
    cfg = RolloutConfig(fraction=0.25, judge_s=0.5, poll_s=0.05,
                        min_requests=1, breach_polls=1)

    class _Killed(Exception):
        pass

    def rig(tag):
        d = os.path.join(workdir, tag)
        reg = ModelRegistry(os.path.join(d, "registry"))
        up: set = set()
        retired: list = []

        def retire(name):
            retired.append(name)
            up.discard(name)

        a = reg.publish("demo", notes="a")
        b = reg.publish("demo", notes="b")
        reg.set_channels("demo", stable=a)
        kw = dict(ensure=up.add, retire=retire,
                  verdict=lambda name: None, cfg=cfg)
        return d, reg, up, retired, a, b, kw

    # -- kill after canary_live: nobody is judging -> must roll back ---
    d, reg, up, retired, a, b, kw = rig("mid_canary")
    RolloutController(reg, d, **kw).start_canary("demo", b)
    res1 = RolloutController(reg, d, **kw).resume()
    ch = reg.channels("demo")
    mid_canary_ok = (res1 == {"demo": "rolled_back"}
                     and ch["stable"] == a and ch["canary"] is None
                     and versioned("demo", b) in retired
                     and up == {versioned("demo", a)})
    res1b = RolloutController(reg, d, **kw).resume()
    idem1 = res1b == {"demo": "consistent"}

    # -- kill between promote_begin and done: the decision is durable
    # -> resume must FINISH the promote, not un-decide it --------------
    class _DiesApplying(RolloutController):
        def _apply_promote(self, *args, **kwargs):
            raise _Killed()

    d, reg, up, retired, a, b, kw = rig("mid_promote")
    ctl = _DiesApplying(reg, d, **kw)
    ctl.start_canary("demo", b)
    try:
        ctl.promote("demo")
    except _Killed:
        pass
    res2 = RolloutController(reg, d, **kw).resume()
    ch = reg.channels("demo")
    mid_promote_ok = (res2 == {"demo": "promoted"}
                      and ch["stable"] == b and ch["canary"] is None
                      and versioned("demo", a) in retired
                      and up == {versioned("demo", b)})
    res2b = RolloutController(reg, d, **kw).resume()
    idem2 = res2b == {"demo": "consistent"}

    return {"episode": "controller_kill_resume",
            "mid_canary": res1.get("demo"),
            "mid_promote": res2.get("demo"),
            "idempotent": bool(idem1 and idem2),
            "elapsed_s": round(time.monotonic() - t0, 1),
            "ok": bool(mid_canary_ok and mid_promote_ok
                       and idem1 and idem2)}


def rollout_soak(args) -> int:
    import numpy as np

    from ..parallel.registry import ModelRegistry, versioned
    from ..parallel.rollout import RolloutConfig, RolloutController
    from ..parallel.router import Router, RouterConfig
    from ..parallel.serving import (
        ModelHouse, ServeConfig, solo_references,
    )
    from ..utils.device import resolve_device

    device = resolve_device(args.device).type
    _clean_env()
    rng = np.random.default_rng(args.seed)
    own_tmp = args.workdir is None
    workdir = args.workdir or tempfile.mkdtemp(prefix="sparknet_rollout_")
    os.makedirs(workdir, exist_ok=True)
    trace_dir = os.environ.setdefault(
        "SPARKNET_TRACE_DIR", os.path.join(workdir, "trace"))
    os.makedirs(trace_dir, exist_ok=True)
    regdir = os.path.join(workdir, "registry")
    os.environ["SPARKNET_REGISTRY_DIR"] = regdir
    t0 = time.monotonic()

    reg = ModelRegistry(regdir)
    # small fast SLO windows so a ~30 s leg sees real multi-window
    # burn-rate judgments, not just the defaults' opening blur
    cfg = ServeConfig(batch_shapes=(1, 4), seed=0,
                      slo_fast_window_s=1.5, slo_window_s=6.0,
                      slo_min_requests=4, slo_reject_budget=0.05,
                      slo_sample_every_s=0.1)
    router = Router(RouterConfig(spill_depth=8))
    fleet = _RolloutFleet(reg, cfg, router, device=device)
    ctl = RolloutController(
        reg, workdir, ensure=fleet.ensure, retire=fleet.retire,
        verdict=fleet.verdict, router=router,
        cfg=RolloutConfig(fraction=0.5, judge_s=1.5, poll_s=0.05,
                          min_requests=10, breach_polls=2))

    v1 = reg.publish("lenet", slo={"p99_ms": 2000.0},
                     notes="rollout soak v1")
    v2 = reg.publish("lenet", slo={"p99_ms": 2000.0},
                     notes="rollout soak v2")
    # zoo-init versions share seed 0, so one solo house is the
    # bit-identity oracle for BOTH sides of the split
    lm = ModelHouse(cfg, device=device).load("lenet")
    inputs = [rng.normal(size=lm.in_shape).astype(np.float32)
              for _ in range(16)]
    refs = solo_references(lm, inputs)

    episodes = []
    try:
        episodes.append(_rollout_promote_episode(
            ctl, fleet, reg, router, inputs, refs, v1, v2))
        if episodes[-1]["ok"]:
            episodes.append(_rollout_bad_canary_episode(
                ctl, fleet, reg, router, inputs, refs, v2, trace_dir))
        episodes.append(_rollout_resume_episode(
            os.path.join(workdir, "resume")))
    finally:
        fleet.close()

    for e in episodes:
        print(f"rollout-soak: {e['episode']} -> "
              f"{'OK' if e['ok'] else 'FAIL'} ({e['elapsed_s']}s)",
              flush=True)
    passed = sum(1 for e in episodes if e["ok"])
    report = {"mode": "rollout", "seed": args.seed, "device": device,
              "episodes": episodes, "passed": passed,
              "failed": len(episodes) - passed,
              "elapsed_s": round(time.monotonic() - t0, 1),
              "ok": len(episodes) == 3 and passed == len(episodes)}
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"rollout-soak: verdict written to {args.out} "
              f"({passed}/{len(episodes)} episode(s) passed)")
    else:
        print(text)
    if own_tmp and report["ok"]:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    elif not report["ok"]:
        print(f"rollout-soak: scratch kept at {workdir} for post-mortem "
              "(rollout.jsonl + flight dumps)", file=sys.stderr)
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chaos soak runner")
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write the JSON verdict here (default: stdout)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a TemporaryDirectory)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="fleet mode: N concurrent seeded chaos jobs + a "
                         "late whole-budget preemptor under one "
                         "FleetScheduler (0 = classic per-run soak)")
    ap.add_argument("--fleet-devices", type=int, default=8)
    ap.add_argument("--fleet-kill", action="store_true",
                    help="SIGKILL the scheduler mid-run and resume it "
                         "from its journal")
    ap.add_argument("--fleet-kill-after", type=float, default=6.0)
    ap.add_argument("--fleet-preempt-after", type=float, default=5.0,
                    help="delay before the high-priority preemptor "
                         "arrives")
    ap.add_argument("--fleet-timeout", type=float, default=420.0)
    ap.add_argument("--fleet-world", type=int, default=4,
                    help="gang size (workers) of each fleet soak job")
    ap.add_argument("--pod", type=int, default=0, metavar="N",
                    help=f"pod mode (not ported: {POD_HALF})")
    ap.add_argument("--net", action="store_true",
                    help="net mode: the partition/fenced-ship/slow-link "
                         "chaos legs over the fake-ssh ChaosTransport")
    ap.add_argument("--net-slice", action="store_true",
                    help="partition-suspend-heal and fenced-zombie legs "
                         "only (skips slow-link)")
    ap.add_argument("--rollout", action="store_true",
                    help="rollout mode: canary-promote, bad-canary "
                         "auto-rollback, and controller-kill-resume "
                         "legs over the registry + rollout controller")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.pod:
        raise NotImplementedError(
            f"soak --pod: the pod soak (gangs over simulated hosts beside "
            f"a served tenant, host kills) is not ported yet ({POD_HALF}; "
            f"ROADMAP A, order 3b)")
    if args.net:
        return net_soak(args)
    if args.rollout:
        return rollout_soak(args)
    if args.fleet:
        return fleet_soak(args)

    import numpy as np

    from ..utils.device import resolve_device
    device = resolve_device(args.device).type
    _clean_env()
    rng = np.random.default_rng(args.seed)

    own_tmp = args.workdir is None
    workdir = args.workdir or tempfile.mkdtemp(prefix="sparknet_soak_")
    os.makedirs(workdir, exist_ok=True)

    baselines: dict[tuple[str, ...], str] = {}

    def baseline_for(flags):
        """Fault-free reference run per flag set (cached — the guard and
        audit change checkpoint traffic but not the training math, so
        matching flags keeps the comparison honest)."""
        key = tuple(flags)
        if key not in baselines:
            path = os.path.join(workdir, f"base_{len(baselines)}.npz")
            ck = os.path.join(workdir, f"base_ck_{len(baselines)}")
            rc, _ = _run_driver(path, ck if flags else None, list(flags),
                                device=device)
            if rc != 0:
                raise RuntimeError(f"fault-free baseline failed rc={rc} "
                                   f"(flags={flags})")
            baselines[key] = path
        return baselines[key]

    runs = []
    t0 = time.monotonic()
    for i in range(args.runs):
        options = _schedules(rng)
        name, fault, flags = options[int(rng.integers(0, len(options)))]
        out = os.path.join(workdir, f"run_{i}.npz")
        ck = os.path.join(workdir, f"ck_{i}")
        verdict = {"run": i, "schedule": name, "fault": fault,
                   "flags": flags}
        try:
            base = baseline_for(flags)
            rc, attempts = _run_driver(out, ck, list(flags), fault=fault,
                                       device=device)
            verdict.update(rc=rc, attempts=attempts)
            if rc == 0:
                match, bad_key = _params_match(base, out)
                verdict.update(match=match,
                               **({"diverged_at": bad_key}
                                  if not match else {}))
            else:
                verdict.update(match=False)
        except Exception as e:   # a broken run is a red verdict, not a crash
            verdict.update(rc=-1, attempts=0, match=False, error=str(e))
        verdict["ok"] = bool(verdict.get("rc") == 0 and verdict["match"])
        runs.append(verdict)
        print(f"soak: run {i} [{fault}] -> "
              f"{'OK' if verdict['ok'] else 'FAIL'} "
              f"(rc={verdict.get('rc')}, attempts="
              f"{verdict.get('attempts')})", flush=True)

    passed = sum(1 for r in runs if r["ok"])
    report = {"seed": args.seed, "device": device, "runs": runs,
              "passed": passed,
              "failed": len(runs) - passed,
              "elapsed_s": round(time.monotonic() - t0, 1),
              "ok": passed == len(runs)}
    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"soak: verdict written to {args.out} "
              f"({passed}/{len(runs)} passed)")
    else:
        print(text)
    if own_tmp and report["ok"]:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    elif not report["ok"]:
        print(f"soak: scratch kept at {workdir} for post-mortem",
              file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
