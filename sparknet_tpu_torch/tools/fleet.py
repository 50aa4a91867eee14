"""Fleet scheduler CLI: run a multi-tenant queue of jobs on the card.

The port's own copy of the root ``tools/fleet.py``, with the port's
``--device`` (cuda unless the caller asks for the CPU).  A thin shell
over ``sparknet_tpu_torch.parallel.fleet.FleetScheduler``: load job specs
from JSON, schedule them onto a device budget with per-tenant quotas and
priority preemption, supervise each through its ResilientRunner, and
keep a crash-safe journal, so a killed scheduler resumes with
``--resume`` (surviving workers are reaped first: no double launch, no
orphans).  The built-in lenet job is
``python -m sparknet_tpu_torch.tools.multihost_driver``, started with
``--local-devices <world> --device <device>``.

Job file: a JSON list of JobSpec objects, e.g.

    [{"name": "lenet-a", "tenant": "acme", "priority": 0, "world": 2,
      "rounds": 4},
     {"name": "urgent",  "tenant": "beta", "priority": 50, "world": 4,
      "rounds": 4, "not_before_s": 6.0}]

Usage:
  python -m sparknet_tpu_torch.tools.fleet --devices 4 --workdir /tmp/fl \\
      --jobs jobs.json --quota acme=2 [--device cpu]
  python -m sparknet_tpu_torch.tools.fleet --hosts 'a=2,b=2' \\
      --workdir /tmp/fl --jobs jobs.json
  python -m sparknet_tpu_torch.tools.fleet --workdir /tmp/fl --resume
  python -m sparknet_tpu_torch.tools.fleet status --workdir /tmp/fl [--json]
  python -m sparknet_tpu_torch.tools.fleet mark-host b lost --workdir /tmp/fl

``--hosts`` takes an inline inventory (``name=devices[@addr]``) or a
JSON file path; SPARKNET_FLEET_HOSTS supplies it when the flag is absent.
A host with a remote address (or any host while SPARKNET_SSH_CMD is set)
places its gangs through a host transport, with checkpoint shipping.
``mark-host <host> live|suspect|draining|lost`` appends to the
host-control channel the running scheduler polls.  ``status`` reads the
journal, the heartbeats and the metrics snapshots the workers wrote,
with no scheduler process; it reads a journal the JAX package wrote too.
A workdir of a serving fleet (``serve --fleet``) adds the serving and
rollout rows.

Exit code 0 when every job completed; 3 when any was quarantined (each
leaves a ``postmortem.json`` in its job dir); 4 when a worker outlived
the fleet.  ``--render-proxy-figure`` renders the accuracy-vs-wall-clock
chart (``tools/plot_learning_proxy.py``) after the fleet drains.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_specs(path: str):
    from ..parallel.fleet import JobSpec
    with open(path) as f:
        raw = json.load(f)
    if not isinstance(raw, list):
        raise SystemExit(f"{path}: expected a JSON list of job specs")
    return [JobSpec.from_json(d) for d in raw]


def parse_quotas(pairs):
    quotas = {}
    for p in pairs or ():
        name, _, val = p.partition("=")
        if not name or not val:
            raise SystemExit(f"bad --quota {p!r} (want tenant=slots)")
        try:
            quotas[name] = int(val)
        except ValueError:
            raise SystemExit(f"bad --quota {p!r}: {val!r} is not an int")
    return quotas


def _mark_host(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="fleet mark-host",
        description="request a host state change (the running scheduler "
                    "applies it at its next step)")
    ap.add_argument("host")
    ap.add_argument("state",
                    choices=("live", "suspect", "draining", "lost"))
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--by", default="operator")
    args = ap.parse_args(argv)
    from ..parallel.fleet import request_mark_host
    request_mark_host(args.workdir, args.host, args.state, by=args.by)
    print(f"requested {args.host} -> {args.state} "
          f"(host_control.jsonl in {args.workdir})")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "status":   # subcommand spelling of --status
        argv = ["--status"] + argv[1:]
    if argv and argv[0] == "mark-host":
        return _mark_host(argv[1:])
    ap = argparse.ArgumentParser(
        description="multi-tenant training fleet scheduler")
    ap.add_argument("--workdir", required=True,
                    help="fleet state dir (journal, per-job artifacts)")
    ap.add_argument("--status", action="store_true",
                    help="print the fleet status reconstructed from the "
                         "journal (+ heartbeats + metrics snapshots) and "
                         "exit — works on a live OR dead fleet")
    ap.add_argument("--json", action="store_true",
                    help="with --status: emit one machine-readable JSON "
                         "document instead of the table")
    ap.add_argument("--jobs", default=None,
                    help="JSON list of job specs (required unless "
                         "--resume)")
    ap.add_argument("--devices", type=int, default=8,
                    help="total device slices in the budget")
    ap.add_argument("--hosts", default=None,
                    help="host inventory: 'name=devices[@addr],...' or a "
                         "JSON file path; overrides --devices (falls "
                         "back to SPARKNET_FLEET_HOSTS)")
    ap.add_argument("--quota", action="append", default=[],
                    metavar="TENANT=SLOTS",
                    help="per-tenant slot quota (repeatable)")
    ap.add_argument("--resume", action="store_true",
                    help="rebuild the queue from the journal after a "
                         "scheduler death (reaps surviving workers; "
                         "never double-launches)")
    ap.add_argument("--aging", type=float, default=1.0 / 60.0,
                    help="starvation aging: priority gained per queued "
                         "second (default 1/60)")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable priority preemption")
    ap.add_argument("--preempt-grace", type=float, default=10.0,
                    help="seconds between SIGTERM and SIGKILL")
    ap.add_argument("--tick", type=float, default=0.2)
    ap.add_argument("--timeout", type=float, default=None,
                    help="bound the whole fleet run (seconds)")
    ap.add_argument("--status-every", type=float, default=5.0,
                    help="print the fleet status table this often "
                         "(0 = silent)")
    ap.add_argument("--render-proxy-figure", action="store_true",
                    help="after the fleet drains, render the "
                         "accuracy-vs-wall-clock figure "
                         "(tools/plot_learning_proxy.py)")
    ap.add_argument("--device", default="cuda",
                    help="device of the built-in jobs: cuda (default) or "
                         "cpu")
    args = ap.parse_args(argv)

    from ..parallel.fleet import (FleetScheduler, HostPool, format_status,
                                  offline_status)

    if args.status:
        st = offline_status(args.workdir)
        if args.json:
            print(json.dumps(st, indent=1))
        else:
            print(format_status(st))
        return 0

    from ..utils.device import resolve_device
    device = resolve_device(args.device).type
    if args.resume:
        # the journal carries the host inventory and its marked states
        fleet = FleetScheduler.resume(
            args.workdir, aging_rate=args.aging,
            preempt=not args.no_preempt,
            preempt_grace_s=args.preempt_grace, device=device)
    else:
        if not args.jobs:
            ap.error("--jobs is required (or --resume)")
        pool = (HostPool.from_spec(args.hosts) if args.hosts
                else HostPool.from_env())
        fleet = FleetScheduler(
            args.workdir, None if pool else args.devices, hosts=pool,
            tenants=parse_quotas(args.quota),
            aging_rate=args.aging, preempt=not args.no_preempt,
            preempt_grace_s=args.preempt_grace, device=device)
        for spec in load_specs(args.jobs):
            fleet.submit(spec)

    try:
        rc = fleet.run(tick_s=args.tick, timeout_s=args.timeout,
                       status_every_s=args.status_every)
    except KeyboardInterrupt:
        print("fleet: interrupted — shutting the fleet down "
              "(journal keeps the queue; rerun with --resume)",
              file=sys.stderr, flush=True)
        fleet.shutdown()
        return 130
    print(format_status(fleet.status()), flush=True)
    orphans = fleet.live_worker_pids()
    if orphans:
        print(f"fleet: ERROR — orphaned workers survived: {orphans}",
              file=sys.stderr, flush=True)
        return 4
    if args.render_proxy_figure and rc == 0:
        from . import plot_learning_proxy
        rc = plot_learning_proxy.main([]) or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
