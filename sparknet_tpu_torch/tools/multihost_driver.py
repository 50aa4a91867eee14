"""The fleet's built-in lenet training job, resumable by round.

The port's own copy of the JAX package's ``tests/multihost_driver.py``,
with all of its flags and the port's ``--device`` (cuda unless the caller
asks for the CPU).  It trains a fixed lenet workload through the port's
``DistributedTrainer`` with ``--local-devices N`` workers sharing the
device, and process 0 writes the final params, the per-round losses, the
guard's and the audit's trips and the test scores to ``--out`` (npz, the
JAX driver's keys).  Launched as a gang of P processes (``tools/launch.py
--nprocs P``, the env contract), each process joins the gloo group
(``parallel/cluster.py``), runs its ``--local-devices`` workers of the
P·N and feeds them its ``local_batch_slice`` of every batch;
``hierarchical`` then takes the P processes as its hosts (alone, two
virtual hosts).  The partition knobs ``SPARKNET_SHARD`` and
``SPARKNET_SHARD_CKPT`` (and the codec's) reach the trainer through
``comm_config_from_env``; the round stays τ=2.

Resilience: ``--ckpt-dir`` turns on round checkpoints and a relaunched
driver resumes from the newest valid manifest.  Every round start passes
the fault-injection hook (``SPARKNET_FAULT=crash@round:N`` etc.,
``utils/faults.py``).  Each round's batch is a pure function of the
round index (:func:`round_batch`, numpy), so a resumed round refeeds
exactly the batch the lost round would have seen.  ``--elastic`` lets a
checkpoint of another worker count resume, ``--guard`` arms the
numerical guard, ``--audit-every K`` the cross-replica audit, and the loop
follows ``tr.round``, so a guard or audit rollback replays the dropped
round.  Heartbeats are published while the launcher
sets SPARKNET_HEARTBEAT_DIR.  SIGTERM/SIGINT give one final round
checkpoint and a clean exit (the preemption contract,
``utils/signals.py``).

Usage:
  python -m sparknet_tpu_torch.tools.multihost_driver --out out.npz \\
      --local-devices 2 --rounds 3 --ckpt-dir ckpt [--device cpu]
  python -m sparknet_tpu_torch.tools.launch --nprocs 2 --device cpu -- \\
      python -m sparknet_tpu_torch.tools.multihost_driver --out out.npz \\
      --local-devices 2 --strategy hierarchical
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

TAU = 2


def round_batch(r, tau, global_batch):
    """Deterministic per-round lenet batch, a pure function of the round
    index: the property that makes round-granular resume exact (the JAX
    driver's, draw for draw)."""
    rng = np.random.default_rng(1000 + r)
    y = rng.integers(0, 10, size=(tau, global_batch))
    x = rng.normal(scale=0.3, size=(tau, global_batch, 1, 28, 28)
                   ).astype(np.float32)
    for t in range(tau):
        for i, k in enumerate(y[t]):
            x[t, i, :, int(k) % 28, :] += 2.0
    return x, y


def eval_batch(global_batch):
    erng = np.random.default_rng(2000)
    eval_y = erng.integers(0, 10, size=(global_batch,))
    eval_x = erng.normal(scale=0.3, size=(global_batch, 1, 28, 28)
                         ).astype(np.float32)
    return eval_x, eval_y


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="the fleet's lenet training job (round checkpoints, "
                    "resume, preemption)")
    ap.add_argument("--strategy", default="sync")
    ap.add_argument("--out", required=True)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="this process's workers of the round, sharing "
                         "the device (default 1)")
    ap.add_argument("--expect-devices", type=int, default=4,
                    help="worker count the whole layout must have "
                         "(0 = don't check — elastic worlds vary)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None,
                    help="round-granular checkpoint/auto-resume directory")
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--elastic", action="store_true",
                    help="allow resuming a checkpoint from a different "
                         "worker count (degraded-mode re-form)")
    ap.add_argument("--guard", action="store_true",
                    help="arm the numerical-integrity guard (needs "
                         "--ckpt-dir)")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="cross-replica parameter audit cadence in rounds "
                         "(0 = off; needs --ckpt-dir)")
    ap.add_argument("--harvest-lag", type=int, default=0,
                    help="zero-stall outer loop: keep up to K rounds in "
                         "flight, harvesting loss/guard verdicts up to K "
                         "rounds late (0 = synchronous)")
    ap.add_argument("--fail-rank", type=int, default=None,
                    help="failure-path mode: this rank dies (exit 3) after "
                         "the first round")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from ..models import lenet
    from ..parallel import DistributedTrainer, TrainerConfig, make_mesh, \
        make_pod_mesh
    from ..parallel import cluster
    from ..parallel.trainer import comm_config_from_env
    from ..proto import load_solver_prototxt_with_net
    from ..utils import faults
    from ..utils.device import resolve_device
    from ..utils.signals import SolverAction, preemption_guard

    dev = resolve_device(args.device)
    distributed = cluster.init_cluster_from_env()
    procs, rank = cluster.process_count(), cluster.process_index()
    n_workers = (args.local_devices or 1) * procs
    if args.strategy == "hierarchical":
        # the processes are the hosts (the weight average crosses the
        # process boundary); alone, the JAX driver's two virtual hosts
        n_hosts = procs if procs > 1 else 2
        if n_workers % n_hosts:
            raise ValueError(f"hierarchical needs a worker count "
                             f"divisible by {n_hosts} hosts, got "
                             f"{n_workers}")
        layout = make_pod_mesh(n_hosts, n_workers // n_hosts)
    else:
        layout = make_mesh(n_workers)
    if args.expect_devices:
        assert n_workers == args.expect_devices, (
            f"expected {args.expect_devices} workers, got {n_workers}")

    global_batch = args.global_batch
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\n',
        lenet(global_batch, global_batch))
    cfg = TrainerConfig(strategy=args.strategy, tau=TAU,
                        checkpoint_dir=args.ckpt_dir,
                        checkpoint_every=args.ckpt_every,
                        elastic=args.elastic,
                        guard_numerics=args.guard,
                        audit_every=args.audit_every,
                        harvest_lag=args.harvest_lag)
    cfg = dataclasses.replace(comm_config_from_env(cfg), tau=TAU)
    tr = DistributedTrainer(sp, layout, cfg, seed=0, device=dev)
    rows = cluster.local_batch_slice(global_batch)
    injector = faults.get_injector()
    if tr.resumed:
        print(f"driver: resumed at round {tr.round} (attempt "
              f"{injector.attempt})", flush=True)

    losses = []
    preempted = False
    with preemption_guard() as guard:
        # driven by tr.round: a guard rollback rewinds it and the loop
        # replays the dropped round; the outer loop replays rounds a
        # late verdict dropped during drain()
        while True:
            while tr.round < args.rounds:
                action = guard.check()
                if action in (SolverAction.SNAPSHOT,
                              SolverAction.SNAPSHOT_STOP):
                    if args.ckpt_dir:
                        print(f"driver: signal checkpoint at round "
                              f"{tr.round}", flush=True)
                        tr.drain()
                        tr.save_round_checkpoint()
                        tr.flush_checkpoints()   # durable before the exit
                if action in (SolverAction.STOP,
                              SolverAction.SNAPSHOT_STOP):
                    print(f"driver: preempted; stopped cleanly at round "
                          f"boundary {tr.round}", flush=True)
                    preempted = True
                    break
                r = tr.round
                injector.on_round(r, rank=rank)
                x, y = round_batch(r, TAU, global_batch)
                loss = tr.train_round(
                    {"data": x[:, rows],
                     "label": y[:, rows].astype(np.float32)})
                losses.append(loss)
                print(f"driver: round {r} done loss={loss:.4f}",
                      flush=True)
                if r == 0 and args.fail_rank is not None \
                        and rank == args.fail_rank:
                    print(f"driver: rank {args.fail_rank} dying "
                          f"(failure-path test)", flush=True)
                    os._exit(3)
            if preempted:
                break
            tr.drain()
            if tr.round >= args.rounds:
                break
    tr.flush_checkpoints()
    if preempted:
        return 0   # clean exit: the relaunch resumes from the checkpoint

    if args.harvest_lag:
        losses = [tr.round_losses[r] for r in range(args.rounds)]

    eval_x, eval_y = eval_batch(global_batch)
    feed = iter([{"data": eval_x[rows],
                  "label": eval_y[rows].astype(np.float32)}] * 2)
    scores = tr.test(feed, num_steps=2)   # totals, as the JAX driver keeps

    if rank == 0:
        flat = {}
        for lname, blobs in tr.params.items():
            for i, b in enumerate(blobs):
                flat[f"{lname}/{i}"] = b.detach().cpu().numpy()
        flat["__losses__"] = np.asarray(losses)
        flat["__guard_trips__"] = np.asarray(tr.guard_trips)
        flat["__audit_trips__"] = np.asarray(tr.audit_trips)
        flat["__scores__"] = np.asarray(
            [scores.get("loss", 0.0), scores.get("accuracy", 0.0)])
        tmp = f"{args.out}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, args.out)   # the completion artifact appears whole
    print(f"driver ok: distributed={distributed} procs={procs} "
          f"workers={n_workers} device={dev} losses={losses}", flush=True)
    cluster.shutdown_cluster()
    return 0


if __name__ == "__main__":
    sys.exit(main())
