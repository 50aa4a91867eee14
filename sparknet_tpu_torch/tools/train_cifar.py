"""CIFAR-10 trajectory-reproduction harness.

The port's own copy of ``sparknet_tpu/tools/train_cifar.py``: the same
flags, data, feeds and trajectory JSON, through the port's ``Solver``
and ``DistributedTrainer`` on ``--device`` (cuda unless the caller asks
for the CPU).  On the card every MAX pool's backward is the hand kernel
``max_pool_bwd`` (cifar10_quick's pool1 is MAX 3x3 stride 2: one launch
a worker iteration; its test passes launch none).

Trains the *reference configs verbatim* — solver prototxt
(e.g. caffe/examples/cifar10/cifar10_quick_solver.prototxt: lr 0.001,
fixed policy, 4000 iters, test every 500) and its ``net:`` train_test
prototxt, batch sizes taken from the original Data layers — and records
the accuracy-vs-iteration / wall-clock trajectory to JSON, for comparison
against the published band (~71-75% quick, ~75% full; reference:
caffe/examples/cifar10/readme.md:81 and the quick solver comments).

With real CIFAR-10 binaries (``--data-dir`` holding data_batch_*.bin /
test_batch.bin) the run is the published experiment.  Without them (this
rig has no dataset and no egress) ``--synthetic`` fabricates a
format-exact stand-in so the harness itself is exercised end-to-end; the
output JSON is labeled accordingly — synthetic accuracy says nothing
about the published band.

Run:
  python -m sparknet_tpu_torch.tools.train_cifar --data-dir /data/cifar10
  python -m sparknet_tpu_torch.tools.train_cifar --synthetic --max-iter 300
  python -m sparknet_tpu_torch.tools.train_cifar --synthetic --workers 8 \
      --strategy local_sgd            # 8-way parameter averaging
  (each with --solver S.prototxt where the reference tree is absent, and
  --device cpu off the card)
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

REFERENCE_CAFFE = "/root/reference/caffe"
DEFAULT_SOLVER = os.path.join(
    REFERENCE_CAFFE, "examples/cifar10/cifar10_quick_solver.prototxt")


def _resolve_net_path(sp, solver_path: str) -> str:
    """Shared resolver, additionally probing the reference caffe root
    (zoo solvers reference nets as examples/cifar10/...)."""
    from ..proto.caffe_pb import resolve_net_path
    try:
        return resolve_net_path(sp, solver_path,
                                extra_bases=(REFERENCE_CAFFE,))
    except FileNotFoundError as e:
        raise SystemExit(str(e))


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _data_batch_sizes(net) -> tuple[int, int]:
    """batch_size of the original TRAIN/TEST Data layers (100/100 for the
    cifar10 zoo nets)."""
    from ..proto.caffe_pb import Phase
    train_b = test_b = 100
    for lp in net.layer:
        for pname in ("data_param", "memory_data_param", "image_data_param"):
            b = lp.sub(pname).get("batch_size")
            if b is not None:
                phases = [r.phase for r in lp.include] or [lp.phase]
                if Phase.TEST in phases:
                    test_b = int(b)
                else:
                    train_b = int(b)
    return train_b, test_b


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Reproduce the Caffe CIFAR-10 trajectory")
    ap.add_argument("--solver", default=DEFAULT_SOLVER,
                    help="reference solver prototxt (quick or full)")
    ap.add_argument("--data-dir", default=None,
                    help="dir with data_batch_*.bin / test_batch.bin")
    ap.add_argument("--synthetic", action="store_true",
                    help="format-exact synthetic stand-in (no dataset rig)")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="override solver max_iter (bounded-time runs)")
    ap.add_argument("--test-interval", type=int, default=None)
    ap.add_argument("--workers", type=int, default=0,
                    help="N>0: N-way parameter-averaging DistributedTrainer")
    ap.add_argument("--strategy", choices=["local_sgd", "sync"],
                    default="local_sgd")
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--out", default="cifar_trajectory.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..proto import (load_net_prototxt, load_solver_prototxt,
                         load_solver_prototxt_with_net, replace_data_layers)

    sp0 = load_solver_prototxt(args.solver)
    net_path = _resolve_net_path(sp0, args.solver)
    raw_net = load_net_prototxt(net_path)
    train_b, test_b = _data_batch_sizes(raw_net)

    if args.synthetic or not args.data_dir:
        if not args.synthetic:
            raise SystemExit("no --data-dir; pass --synthetic to run the "
                             "harness on a labeled stand-in dataset")
        data_kind = "synthetic"
        from ..apps.cifar_app import synthetic_cifar
        train_x, train_y = synthetic_cifar(10000, seed=1)
        test_x, test_y = synthetic_cifar(2000, seed=2)
    else:
        data_kind = "cifar10"
        from ..data import load_cifar10_binary
        train_files = sorted(glob.glob(
            os.path.join(args.data_dir, "data_batch_*.bin")))
        train_x, train_y = load_cifar10_binary(train_files, shuffle=True)
        test_x, test_y = load_cifar10_binary(
            os.path.join(args.data_dir, "test_batch.bin"))

    # mean subtraction — the train_test prototxt's transform_param
    # mean_file path (compute_image_mean output); recomputed here
    from ..data import compute_mean_image
    mean = compute_mean_image(train_x)
    train_x = train_x - mean
    test_x = test_x - mean

    max_iter = args.max_iter or sp0.max_iter or 4000
    test_interval = args.test_interval or sp0.test_interval or 500
    test_iter = (sp0.test_iter[0] if sp0.test_iter else
                 max(1, len(test_y) // test_b))
    test_iter = min(test_iter, len(test_y) // test_b)

    traj = {
        "solver": os.path.relpath(args.solver, REFERENCE_CAFFE)
        if args.solver.startswith(REFERENCE_CAFFE) else args.solver,
        "net": os.path.basename(net_path),
        "data": data_kind,
        "batch": train_b, "max_iter": max_iter,
        "workers": args.workers, "strategy":
        args.strategy if args.workers else "single",
        "points": [],  # {iter, seconds, loss, accuracy}
    }
    t0 = time.perf_counter()

    def record(it, loss, acc):
        traj["points"].append({
            "iter": it, "seconds": round(time.perf_counter() - t0, 2),
            "loss": None if loss is None else round(float(loss), 4),
            "accuracy": None if acc is None else round(float(acc), 4)})
        print(f"iter {it:6d}  t={traj['points'][-1]['seconds']:8.1f}s  "
              f"loss={loss if loss is not None else '-'}  "
              f"acc={acc if acc is not None else '-'}", flush=True)

    rng = np.random.default_rng(5)

    if args.workers:
        _run_distributed(args, sp0, raw_net, train_b, test_b, train_x,
                         train_y, test_x, test_y, test_iter, max_iter,
                         test_interval, record, rng)
    else:
        net = replace_data_layers(raw_net, train_b, test_b, 3, 32, 32)
        sp = load_solver_prototxt_with_net(_read(args.solver), net)
        if args.max_iter:
            sp.max_iter = args.max_iter
        from ..solvers import Solver
        solver = Solver(sp, seed=0, device=args.device)

        def feed():
            n = len(train_y)
            while True:
                idx = rng.integers(0, n, size=train_b)
                yield {"data": train_x[idx].astype(np.float32),
                       "label": train_y[idx].astype(np.float32)}

        def test_feed():
            for i in range(test_iter):
                s = slice(i * test_b, (i + 1) * test_b)
                yield {"data": test_x[s].astype(np.float32),
                       "label": test_y[s].astype(np.float32)}

        solver.set_train_data(feed())
        solver.set_test_data(lambda: test_feed())
        it = 0
        while it < max_iter:
            n = min(test_interval, max_iter - it)
            loss = solver.step(n)
            it += n
            acc = solver.test(test_iter).get("accuracy", 0.0) / test_iter
            record(it, loss, acc)

    traj["final_accuracy"] = traj["points"][-1]["accuracy"]
    traj["total_seconds"] = traj["points"][-1]["seconds"]
    if data_kind == "cifar10":
        traj["published_band"] = [0.71, 0.75]
    with open(args.out, "w") as f:
        json.dump(traj, f, indent=1)
    print(f"wrote {args.out}: final accuracy "
          f"{traj['final_accuracy']} ({data_kind})")
    return traj


def _run_distributed(args, sp0, raw_net, train_b, test_b, train_x, train_y,
                     test_x, test_y, test_iter, max_iter, test_interval,
                     record, rng):
    """N-way parameter-averaging run (SparkNet CifarApp semantics: τ local
    steps then average, reference CifarApp.scala:87-128)."""
    from ..data.partition import PartitionedDataset
    from ..parallel.trainer import DistributedTrainer, TrainerConfig
    from ..proto import load_solver_prototxt_with_net, replace_data_layers
    from ..apps.common import RoundFeed, eval_feed

    workers = args.workers
    net = replace_data_layers(raw_net, train_b * workers, test_b * workers,
                              3, 32, 32)
    sp = load_solver_prototxt_with_net(_read(args.solver), net)
    trainer = DistributedTrainer(
        sp, workers, TrainerConfig(strategy=args.strategy, tau=args.tau),
        seed=0, device=args.device)
    train_ds = PartitionedDataset.from_items(
        list(zip(train_x, train_y)), workers)
    test_ds = PartitionedDataset.from_items(
        list(zip(test_x, test_y)), workers)
    feed = RoundFeed(train_ds, train_b, trainer.batches_per_round, seed=3)
    test_factory, test_steps = eval_feed(test_ds, test_b)
    it = 0
    while it < max_iter:
        rounds = max(1, test_interval // args.tau)
        loss = None
        for _ in range(rounds):
            if it >= max_iter:
                break
            loss = trainer.train_round(feed.next_round())
            it += args.tau
        totals = trainer.test(test_factory(), test_steps)
        from ..apps.common import normalize_scores
        acc = normalize_scores(totals, test_steps).get("accuracy", 0.0)
        record(it, loss, acc)


if __name__ == "__main__":
    main()
