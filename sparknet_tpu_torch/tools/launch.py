"""Multi-process launcher: the spark-submit analog.

The port's own copy of ``sparknet_tpu/tools/launch.py``.  The reference
launches one driver and N executor JVMs through spark-submit (reference:
SETUP.md:45, README.md:60); here the launcher only places processes and
carries no tensor traffic.  Every spawned process gets the
SPARKNET_COORDINATOR / SPARKNET_NUM_PROCS / SPARKNET_PROC_ID env contract
that ``parallel/cluster.py`` reads.  The port's entry points take their
device and their number of workers on the command line (``--device``,
``--local-devices``), so ``device`` and ``local_devices`` are appended to
the command rather than carried in the environment; a child left to its
default device runs on the card and raises where there is none.

Modes:
  local  spawn N processes on this machine.  The port trains with one
         process per gang (the workers of a round share the card), so a
         training command is launched with ``nprocs=1``; ``parallel/
         cluster.py`` refuses a world of more than one process.
  ssh    run the command on each host of ``--hosts`` through a host
         transport (``parallel/transport.py``), process i on host i; a
         host transport places processes, it carries no tensor traffic.
         Each remote process gets ``--device``/``--local-devices`` on its
         command line like a local one.

Health plane: with ``heartbeat_dir`` set the children get
SPARKNET_HEARTBEAT_DIR (workers publish per-round beats through
``parallel.health.maybe_beat``), and with ``round_deadline`` the
supervisor also runs a ``StragglerMonitor`` over those beats: a rank that
beat once and then went silent past the deadline is declared hung,
killed, and the job torn down with exit code ``EXIT_STRAGGLER`` (125), so
the resilience layer relaunches from a checkpoint instead of waiting out
the global timeout.  ``log_dir`` tees every rank's output to
``rank_<i>.log`` (the post-mortem ResilientRunner quotes), and a
caller-provided ``report`` dict receives per-rank exit codes, the first
failing rank and any straggler kills.

Usage:
  python -m sparknet_tpu_torch.tools.launch --nprocs 1 --device cpu \
      -- python -m sparknet_tpu_torch.tools.multihost_driver \
      --local-devices 2 --out /tmp/out.npz --ckpt-dir /tmp/ckpt
  SPARKNET_SSH_CMD=./fake-ssh python -m sparknet_tpu_torch.tools.launch \
      --hosts 127.0.0.1 --device cpu -- python -m \
      sparknet_tpu_torch.tools.multihost_driver --local-devices 2 ...
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time


EXIT_STRAGGLER = 125   # a rank was killed for missing the round deadline

# ssh-mode addresses that mean "spawn here, not over ssh" — the
# simulated N-host pod rig runs every 'host' on one CPU box with these
LOCAL_ADDRS = ("local", "localhost", "127.0.0.1")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _proc_env(base: dict, coordinator: str, nprocs: int, pid: int,
              extra_env: dict | None = None) -> dict:
    env = dict(base)
    env["SPARKNET_COORDINATOR"] = coordinator
    env["SPARKNET_NUM_PROCS"] = str(nprocs)
    env["SPARKNET_PROC_ID"] = str(pid)
    if extra_env:
        env.update({k: str(v) for k, v in extra_env.items()})
    return env


def device_args(cmd: list[str], device: str | None,
                local_devices: int | None) -> list[str]:
    """``cmd`` with ``--device`` and ``--local-devices`` appended where
    given and not already on it: how the port's entry points take the
    device and the number of workers that share it."""
    cmd = list(cmd)
    if device and "--device" not in cmd:
        cmd += ["--device", str(device)]
    if local_devices and "--local-devices" not in cmd:
        cmd += ["--local-devices", str(local_devices)]
    return cmd


def _wait_all(procs: list, timeout: float | None,
              poll_interval: float = 0.05, monitor=None,
              report: dict | None = None) -> int:
    """Supervise the worker set: returns 0 when every process exits clean.
    The FIRST nonzero exit tears the whole round down — remaining workers
    are killed immediately rather than left hanging on a dead collective
    until the timeout (the stage-abort half of Spark's task supervision;
    the reschedule half lives in ``parallel.resilience``).  A timeout
    kills everything and returns 124.

    ``monitor`` (a ``parallel.health.StragglerMonitor``) is polled with
    the still-live rank set; any rank it flags is killed and the job
    torn down with EXIT_STRAGGLER — a hung rank costs one round-deadline,
    not the whole timeout.  ``report`` (if given) is filled with the
    post-mortem: per-rank exit codes, the first failing rank, straggler
    kills, and the failure cause."""
    deadline = time.monotonic() + timeout if timeout else None
    rc = 0
    rcs: dict[int, int | None] = {i: None for i in range(len(procs))}
    first_failure: int | None = None
    stragglers: list[int] = []
    cause = ""
    pending = dict(enumerate(procs))
    while pending and rc == 0:
        for rank, p in list(pending.items()):
            r = p.poll()
            if r is None:
                continue
            del pending[rank]
            rcs[rank] = r
            if r != 0:
                rc, first_failure, cause = r, rank, "exit"
                break
        if rc == 0 and pending:
            if monitor is not None:
                hung = monitor.check(sorted(pending))
                if hung:
                    rc, first_failure, cause = (
                        EXIT_STRAGGLER, hung[0], "straggler")
                    stragglers = hung
                    for rank in hung:
                        print(f"launch: rank {rank} missed the round "
                              f"deadline ({monitor.deadline_s:.3g}s); "
                              f"killing as hung", file=sys.stderr,
                              flush=True)
                        pending[rank].kill()
                    break
            if deadline is not None and time.monotonic() > deadline:
                rc, cause = 124, "timeout"
                break
            time.sleep(poll_interval)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover
            pass
        if rcs.get(rank) is None:
            rcs[rank] = p.poll()
    if rc == 0:
        cause = "clean"
    if report is not None:
        report.update(rcs=rcs, first_failure=first_failure,
                      stragglers=stragglers, cause=cause)
    return rc


def _stream(prefix: str, pipe, log_path: str | None = None) -> None:
    log = open(log_path, "ab") if log_path else None
    try:
        for line in iter(pipe.readline, b""):
            sys.stderr.write(f"[{prefix}] {line.decode(errors='replace')}")
            sys.stderr.flush()
            if log is not None:
                log.write(line)
                log.flush()
    finally:
        if log is not None:
            log.close()


def _make_monitor(heartbeat_dir: str | None, round_deadline: float | None,
                  *, host_map: list | None = None, transport=None,
                  host_suspect_probe=None, host_down_probe=None):
    if not (heartbeat_dir and round_deadline):
        return None
    # lazy import: the health plane is optional and the launcher should
    # stay importable without it on minimal rigs
    from ..parallel.health import GangHealth, StragglerMonitor
    os.makedirs(heartbeat_dir, exist_ok=True)
    # lease-aware gang monitor when beats ride a remote transport (the
    # relay is part of the tick) or the fleet can mark hosts suspect —
    # either way partition-vs-death discipline applies
    if host_map is not None and (
            (transport is not None and not transport.local)
            or host_suspect_probe is not None):
        return GangHealth(heartbeat_dir, round_deadline, host_map=host_map,
                          transport=transport,
                          suspect_probe=host_suspect_probe,
                          down_probe=host_down_probe)
    return StragglerMonitor(heartbeat_dir, round_deadline)


def _rank_hb_dir(heartbeat_dir: str | None,
                 host_map: list | None, rank: int) -> str | None:
    """Rank ``rank``'s beacon dir: the per-host ``host_<name>/`` subdir
    when a host placement is given (so supervisors can roll liveness up
    per host — health.read_hosts), else the flat root."""
    if not heartbeat_dir:
        return None
    if not host_map:
        return heartbeat_dir
    from ..parallel.health import host_dir
    return host_dir(heartbeat_dir, str(host_map[rank]))


def _check_host_map(host_map: list | None, n: int) -> None:
    if host_map is not None and len(host_map) != n:
        raise ValueError(f"host_map has {len(host_map)} entries for "
                         f"{n} ranks — one host label per rank required")


def launch_local(cmd: list[str], nprocs: int, *, device: str | None = None,
                 local_devices: int | None = None,
                 coordinator: str | None = None,
                 timeout: float | None = None,
                 extra_env: dict | None = None,
                 heartbeat_dir: str | None = None,
                 round_deadline: float | None = None,
                 log_dir: str | None = None,
                 report: dict | None = None,
                 host_map: list | None = None,
                 on_spawn=None) -> int:
    """Spawn ``nprocs`` copies of ``cmd`` locally; returns the first
    non-zero exit code, else 0.  Output is streamed with [p<i>] prefixes.
    The first worker death kills the remaining workers immediately
    (see ``_wait_all``).  ``extra_env`` adds per-job vars to every child
    (the ResilientRunner's attempt-stamping channel); ``heartbeat_dir`` /
    ``round_deadline`` / ``log_dir`` / ``report`` are the health plane
    (module docstring).  ``host_map`` (one host label per rank) stamps
    SPARKNET_FLEET_HOST on each child and routes its beacons into the
    per-host ``host_<name>/`` subdir — the simulated-pod rig's placement
    channel.  ``on_spawn`` (if given) receives the list of
    ``subprocess.Popen`` handles once the full gang is up — an external
    supervisor's only safe channel to the worker pids (for preemption
    signals and orphan accounting; see ``parallel.fleet``).  ``device``
    and ``local_devices`` ride the command line (:func:`device_args`)."""
    _check_host_map(host_map, nprocs)
    cmd = device_args(cmd, device, local_devices)
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    monitor = _make_monitor(heartbeat_dir, round_deadline)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    procs = []
    threads = []
    for pid in range(nprocs):
        env = _proc_env(os.environ, coordinator, nprocs, pid, extra_env)
        hb = _rank_hb_dir(heartbeat_dir, host_map, pid)
        if hb:
            env["SPARKNET_HEARTBEAT_DIR"] = hb
        if host_map:
            env["SPARKNET_FLEET_HOST"] = str(host_map[pid])
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        log = os.path.join(log_dir, f"rank_{pid}.log") if log_dir else None
        t = threading.Thread(target=_stream, args=(f"p{pid}", p.stdout, log),
                             daemon=True)
        t.start()
        procs.append(p)
        threads.append(t)
    if on_spawn is not None:
        on_spawn(list(procs))
    rc = _wait_all(procs, timeout, monitor=monitor, report=report)
    for t in threads:
        t.join(timeout=5)
    return rc


def launch_ssh(cmd: list[str], hosts: list[str], *,
               coordinator_port: int | None = None,
               cwd: str | None = None,
               timeout: float | None = None,
               extra_env: dict | None = None,
               heartbeat_dir: str | None = None,
               round_deadline: float | None = None,
               log_dir: str | None = None,
               report: dict | None = None,
               device: str | None = None,
               local_devices: int | None = None,
               host_map: list | None = None,
               on_spawn=None,
               transport=None,
               host_suspect_probe=None,
               host_down_probe=None) -> int:
    """Run ``cmd`` on every host through the host transport; host 0 is
    the coordinator.  ``transport`` (a ``parallel.transport.
    HostTransport``) is the exec/ship/beat seam; when omitted it comes
    from the env: ssh when ``SPARKNET_SSH_CMD`` is set or any address is
    remote, local otherwise, chaos-wrapped when network faults are
    active.  Addresses in ``LOCAL_ADDRS`` are spawned directly only under
    a local transport; with SPARKNET_SSH_CMD set even ``localhost`` rides
    the ssh wire format (the fake-ssh rig: the argv, env and stdio
    plumbing are the production path, no sshd).

    Health plane: under a local transport ranks beat straight into the
    shared ``heartbeat_dir``; under a remote one each rank beats into a
    host-local staging dir and the monitor relays the beats back over
    the transport each tick, with lease discipline on top: a whole-host
    beacon silence marks the host SUSPECT and suspends its ranks (a
    partition must not kill a healthy gang or burn restart budget)
    unless ``host_down_probe`` confirms real death, in which case the
    straggler kill proceeds and the resilience layer takes the lost-host
    path.  ``host_suspect_probe`` lets the fleet feed suspicion it knows
    of into the same suspension.

    ``device`` and ``local_devices`` ride every rank's command line
    (:func:`device_args`), a remote rank's too, so a driver launched
    over ssh runs on the device the caller named.  ``host_map`` gives
    each rank its host label (default: its address) for beacon routing
    and the SPARKNET_FLEET_HOST tag.  ``on_spawn`` receives the local
    ``Popen`` handles (signalling an ssh one ends its remote command
    through the ssh session, so preemption still works host by host)."""
    _check_host_map(host_map, len(hosts))
    if host_map is None:
        host_map = [str(h) for h in hosts]
    if transport is None:
        from ..parallel.transport import default_transport
        transport = default_transport(hosts)
    cmd = device_args(cmd, device, local_devices)
    all_local = all(h in LOCAL_ADDRS for h in hosts)
    port = coordinator_port or (free_port() if all_local else 9876)
    addr0 = "127.0.0.1" if hosts[0] in LOCAL_ADDRS else hosts[0]
    coordinator = f"{addr0}:{port}"
    cwd = cwd or os.getcwd()
    monitor = _make_monitor(heartbeat_dir, round_deadline,
                            host_map=host_map, transport=transport,
                            host_suspect_probe=host_suspect_probe,
                            host_down_probe=host_down_probe)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    procs = []
    threads = []
    for pid, host in enumerate(hosts):
        direct = host in LOCAL_ADDRS and transport.local
        if direct:
            hb = _rank_hb_dir(heartbeat_dir, host_map, pid)
            env = _proc_env(os.environ, coordinator, len(hosts), pid,
                            extra_env)
            if hb:
                os.makedirs(hb, exist_ok=True)
                env["SPARKNET_HEARTBEAT_DIR"] = hb
            env["SPARKNET_FLEET_HOST"] = str(host_map[pid])
            p = subprocess.Popen(cmd, env=env, cwd=cwd,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
        else:
            pairs = [
                ("SPARKNET_COORDINATOR", coordinator),
                ("SPARKNET_NUM_PROCS", str(len(hosts))),
                ("SPARKNET_PROC_ID", str(pid)),
                ("SPARKNET_FLEET_HOST", str(host_map[pid])),
            ]
            if heartbeat_dir:
                # remote ranks beat into host-local staging; the
                # monitor's relay moves beats into host_<name>/ — the
                # shared-filesystem assumption stops at the supervisor
                from ..parallel.health import stage_dir
                pairs.append(("SPARKNET_HEARTBEAT_DIR",
                              stage_dir(heartbeat_dir,
                                        str(host_map[pid]))))
            if extra_env:
                pairs.extend((k, str(v)) for k, v in extra_env.items())
            p = transport.popen(host, cmd, env_pairs=pairs, cwd=cwd)
        log = os.path.join(log_dir, f"rank_{pid}.log") if log_dir else None
        tag = host_map[pid] if direct else host
        t = threading.Thread(target=_stream, args=(tag, p.stdout, log),
                             daemon=True)
        t.start()
        procs.append(p)
        threads.append(t)
    if on_spawn is not None:
        on_spawn(list(procs))
    rc = _wait_all(procs, timeout, monitor=monitor, report=report)
    for t in threads:
        t.join(timeout=5)
    if report is not None:
        report["transport"] = transport.kind
        if monitor is not None and hasattr(monitor, "ever_suspect"):
            report["suspect_hosts"] = sorted(monitor.ever_suspect)
            report["suspect_since"] = dict(monitor.suspect_since)
            report["confirmed_down"] = sorted(monitor.confirmed_down)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="spark-submit analog: place N framework processes")
    ap.add_argument("--nprocs", type=int, default=None,
                    help="local mode: number of processes")
    ap.add_argument("--hosts", default=None,
                    help="ssh mode: comma-separated host list")
    ap.add_argument("--platform", default=None,
                    help="the JAX tool's name for --device: passed to the "
                         "children as --device")
    ap.add_argument("--devices-per-proc", type=int, default=None,
                    help="workers per process: passed to the children as "
                         "--local-devices")
    ap.add_argument("--device", default=None,
                    help="device for the children (--device on their "
                         "command line; they default to cuda)")
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("--heartbeat-dir", default=None,
                    help="shared dir for worker liveness beacons")
    ap.add_argument("--round-deadline", type=float, default=None,
                    help="seconds of beacon silence before a rank is "
                         "declared hung and killed (needs --heartbeat-dir)")
    ap.add_argument("--log-dir", default=None,
                    help="tee each rank's output to rank_<i>.log here")
    ap.add_argument("--feed-workers", type=int, default=None,
                    help="decode-pool width per worker (exported as "
                         "SPARKNET_FEED_WORKERS; 0 = serial feed path)")
    ap.add_argument("--feed-depth", type=int, default=None,
                    help="prefetch depth per worker (exported as "
                         "SPARKNET_FEED_DEPTH)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to run (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given")
    if args.round_deadline and not args.heartbeat_dir:
        ap.error("--round-deadline requires --heartbeat-dir")
    if args.feed_workers is not None and args.feed_workers < 0:
        ap.error("--feed-workers must be >= 0")
    if args.feed_depth is not None and args.feed_depth < 1:
        ap.error("--feed-depth must be >= 1")
    # feed-pipeline knobs ride the same env contract every other
    # per-process setting uses (consumed by data.pipeline at feed build)
    feed_env = {}
    if args.feed_workers is not None:
        feed_env["SPARKNET_FEED_WORKERS"] = args.feed_workers
    if args.feed_depth is not None:
        feed_env["SPARKNET_FEED_DEPTH"] = args.feed_depth
    health = dict(heartbeat_dir=args.heartbeat_dir,
                  round_deadline=args.round_deadline, log_dir=args.log_dir,
                  extra_env=feed_env or None)
    place = dict(device=args.device or args.platform,
                 local_devices=args.devices_per_proc, timeout=args.timeout)
    if args.hosts:
        return launch_ssh(cmd, args.hosts.split(","), **place, **health)
    if not args.nprocs:
        ap.error("--nprocs or --hosts required")
    return launch_local(cmd, args.nprocs, **place, **health)


if __name__ == "__main__":
    sys.exit(main())
