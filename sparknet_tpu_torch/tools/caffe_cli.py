"""The ``caffe`` command-line tool: train / test / time / device_query.

The port's counterpart of ``sparknet_tpu/tools/caffe_cli.py`` (reference:
caffe/tools/caffe.cpp: the brew-function registry at :55, train at :153,
test at :222, time at :290, device_query at :110).

Usage:
  python -m sparknet_tpu_torch.tools.caffe_cli train --solver S.prototxt \\
      [--snapshot X.solverstate | --weights W.caffemodel] \\
      [--devices N [--strategy sync|local_sgd] [--tau T]] [--device cpu]
  python -m sparknet_tpu_torch.tools.caffe_cli test --model M.prototxt \\
      --weights W.caffemodel [--iterations 50]
  python -m sparknet_tpu_torch.tools.caffe_cli time --model M.prototxt \\
      [--iterations 50] [--per-layer]
  python -m sparknet_tpu_torch.tools.caffe_cli device_query

Every action runs on the card (``--device cuda``, the default) and raises
without one; ``--device cpu`` runs on the CPU when asked.  ``Data``
layers feed themselves from their LMDB or LevelDB, ``ImageData`` from
its list of image files and ``WindowData`` from its window file
(``data/db.py::feed_for_net``), JPEGs decoded on the run's device,
through the prefetching ``data/prefetch.py::device_feed``.  ``--devices
N`` trains N workers on the one card through ``DistributedTrainer``;
``--strategy hierarchical`` (ROADMAP A5) and ``--hosts`` (ROADMAP A12)
raise.  ``train`` ends with one ``Train feed:`` log line: the feed's host
seconds per batch (decode, transform, copy to the device) and the
Solver's wait for it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Iterator, Mapping


class TimedFeed:
    """An iterator that sums the seconds its consumer waits in
    ``next()``: the Solver's wait for the feed."""

    def __init__(self, it: Iterator[Mapping[str, Any]]):
        self._it = it
        self.wait_s = 0.0
        self.pulls = 0

    def __iter__(self) -> "TimedFeed":
        return self

    def __next__(self) -> Mapping[str, Any]:
        t0 = time.perf_counter()
        item = next(self._it)
        self.wait_s += time.perf_counter() - t0
        self.pulls += 1
        return item


def _refuse_distributed(args) -> None:
    if args.strategy == "hierarchical":
        raise NotImplementedError(
            "--strategy hierarchical is not ported yet (ROADMAP A5)")
    if args.hosts is not None:
        raise NotImplementedError(
            "--hosts (multi-host training) is not ported yet (ROADMAP A12)")


def _train(args) -> int:
    from ..data.db import feed_for_net
    from ..data.pipeline import FeedStats
    from ..data.prefetch import device_feed
    from ..proto import Phase, load_solver_prototxt
    from ..solvers import Solver
    from ..utils.device import resolve_device
    from ..utils.glog import log_line

    _refuse_distributed(args)
    dev = resolve_device(args.device)
    sp = load_solver_prototxt(args.solver)
    _resolve_solver_net(sp, args.solver)
    if _device_count(args) > 1:
        return _train_multi(args, sp, dev)
    if args.strategy != "sync" or args.tau != 1:
        # distributed flags without --devices must not silently run the
        # single-device path as if the strategy had been honored
        raise SystemExit("--strategy/--tau require --devices N (>1)")
    solver = Solver(sp, seed=0, device=dev)
    if args.weights:
        solver.load_weights(args.weights)
        print(f"Finetuning from {args.weights}")
    if args.snapshot:
        solver.restore_caffe(args.snapshot)
        print(f"Resuming from {args.snapshot} (iter {solver.iter})")

    net_param = sp.net_param or sp.train_net_param
    # test feeds come from the nets the Solver evaluates: every dedicated
    # test_net definition when present, else the shared net
    for i, ts in enumerate(list(sp.test_net_param) or [net_param]):
        if not solver.test_nets[i].input_blobs:
            continue
        try:
            # finds the data layer
            feed_for_net(ts, Phase.TEST, device=dev).close()
        except ValueError as e:
            print(f"WARNING: test net #{i} feed unavailable, skipping "
                  f"eval for it: {e}", file=sys.stderr)
            continue
        solver.set_test_data(lambda ts=ts: feed_for_net(ts, Phase.TEST,
                                                         device=dev),
                             net_id=i)

    host_stats, put_stats = FeedStats(), FeedStats()
    feed = None
    if solver.train_net.input_blobs:
        feed = device_feed(feed_for_net(net_param, Phase.TRAIN,
                                        stats=host_stats, device=dev), dev,
                           stats=put_stats)
    timed = TimedFeed(feed) if feed is not None else None
    try:
        if timed is not None:
            solver.set_train_data(timed)
        t0 = time.perf_counter()
        solver.solve()
        solve_s = time.perf_counter() - t0
    finally:
        if feed is not None:
            feed.close()
    # Solver::Solve's final snapshot, unless the schedule just wrote one
    # (reference: solver.cpp:302-305)
    if sp.snapshot_prefix and not (sp.snapshot
                                   and solver.iter % sp.snapshot == 0):
        model, _state = solver.snapshot_caffe()
        print(f"Snapshotting to {model}")
    if timed is not None:
        per = host_stats.per_batch()
        summary = {
            "host_batches": host_stats.batches,
            "decode_s_per_batch": per["decode_s"],
            "transform_s_per_batch": per["transform_s"],
            "device_put_s_per_batch": put_stats.per_batch()["device_put_s"],
            "solver_pulls": timed.pulls,
            "solver_wait_s": round(timed.wait_s, 6),
            "solver_wait_s_per_pull": round(timed.wait_s
                                            / max(timed.pulls, 1), 6),
            "solve_s": round(solve_s, 6)}
        log_line("Train feed: " + json.dumps(summary), tag="caffe_cli.py")
    return 0


def _device_count(args) -> int:
    """--devices N | --devices all: the number of workers, which the port
    runs on the one device (``all``: the CUDA device count)."""
    spec = getattr(args, "devices", None)
    if spec is None:
        return 1
    if spec == "all":
        import torch
        return max(torch.cuda.device_count(), 1)
    try:
        n = int(spec)
    except ValueError:
        raise SystemExit(f"--devices must be an integer or 'all', "
                         f"got {spec!r}")
    if n < 1:
        raise SystemExit(f"--devices must be >= 1, got {n}")
    return n


def _train_multi(args, sp, dev) -> int:
    """N workers, the P2PSync path `caffe train --gpu 0,1,...` spins up
    (reference: caffe/tools/caffe.cpp:208-211 -> parallel.cpp
    P2PSync::Run), all on the one card.  "sync" is per-step gradient
    averaging; "local_sgd" is SparkNet's τ-step weight averaging
    (ImageNetApp.scala:100-182).  As in Caffe's multi-GPU mode, the
    prototxt batch stays per worker: each step takes one feed minibatch
    per worker (parallel.cpp:390-415)."""
    import math

    import numpy as np

    from ..data.db import feed_for_net
    from ..parallel import DistributedTrainer, TrainerConfig
    from ..proto import Phase
    from ..solvers.solver import load_weights_into
    from ..utils.glog import log_line

    n = _device_count(args)
    trainer = DistributedTrainer(
        sp, n, TrainerConfig(strategy=args.strategy, tau=args.tau),
        seed=0, device=dev)
    print(f"Multi-device training: {n} workers on {dev}, "
          f"strategy={args.strategy}, tau={args.tau}")
    if args.weights:
        trainer.params = load_weights_into(trainer.train_net, trainer.params,
                                           args.weights)
        print(f"Finetuning from {args.weights}")
    if args.snapshot:
        with open(args.snapshot, "rb") as f:
            if f.read(2) != b"PK":  # npz (zip): the trainer's format
                raise SystemExit(
                    f"{args.snapshot}: --devices resume needs the npz "
                    f"snapshot a --devices run writes; .solverstate "
                    f"files are single-device (per-worker optimizer "
                    f"state is not convertible)")
        trainer.restore(args.snapshot)
        print(f"Resuming from {args.snapshot} (iter {trainer.iter})")

    net_param = sp.net_param or sp.train_net_param
    feed = feed_for_net(net_param, Phase.TRAIN, device=dev)
    bpr = trainer.batches_per_round

    def host_rounds():
        while True:
            steps = []
            for _ in range(bpr):
                bs = [dict(next(feed)) for _ in range(n)]
                steps.append(
                    {k: np.concatenate([np.asarray(b[k]) for b in bs])
                     for k in bs[0]})
            yield {k: np.stack([s[k] for s in steps]) for k in steps[0]}

    # eval runs on the trainer's shared-definition test net; dedicated
    # test_net definitions have no distributed analog (the reference
    # tests on the root solver only in multi-GPU mode, solver.cpp Solve)
    test_feed_src = None
    if sp.test_interval:
        if sp.test_net_param:
            print("WARNING: dedicated test_net definitions are evaluated "
                  "on the shared net's definition in --devices mode",
                  file=sys.stderr)
        try:
            feed_for_net(net_param, Phase.TEST, device=dev).close()
            test_feed_src = lambda: feed_for_net(net_param, Phase.TEST,
                                                 device=dev)
        except ValueError as e:
            print(f"WARNING: test feed unavailable, skipping eval: {e}",
                  file=sys.stderr)

    def eval_pass():
        ti = sp.test_iter[0] if sp.test_iter else 50
        steps = math.ceil(ti / n)  # each step scores n reference batches
        tfeed = test_feed_src()

        def gen():
            while True:
                bs = [dict(next(tfeed)) for _ in range(n)]
                yield {k: np.concatenate([np.asarray(b[k]) for b in bs])
                       for k in bs[0]}
        totals = trainer.test(gen(), steps)
        tfeed.close()
        denom = totals.pop("__test_batches__", steps * n) or 1
        log_line(f"Iteration {trainer.iter}, Testing net (#0)")
        for k, v in totals.items():
            arr = np.asarray(v, np.float64) / denom
            for i, x in enumerate(arr.reshape(-1)):
                idx = f"[{i}]" if arr.ndim else ""
                log_line(f"    Test net output: {k}{idx} = {float(x):.6f}")

    max_iter = sp.max_iter or 100
    if (max_iter - trainer.iter) % args.tau:
        print(f"WARNING: max_iter {max_iter} is not a multiple of "
              f"tau={args.tau} from iter {trainer.iter}; training runs "
              f"to the next round boundary "
              f"({math.ceil((max_iter - trainer.iter) / args.tau) * args.tau + trainer.iter})",
              file=sys.stderr)
    with trainer.input_feed(host_rounds()) as rounds:
        while trainer.iter < max_iter:
            prev = trainer.iter
            loss = trainer.train_round(next(rounds))
            if (sp.display
                    and prev // sp.display != trainer.iter // sp.display):
                log_line(f"Iteration {trainer.iter}, loss = {loss:.6f}")
            if (test_feed_src is not None and sp.test_interval
                    and prev // sp.test_interval
                    != trainer.iter // sp.test_interval):
                eval_pass()
    feed.close()
    if sp.snapshot_prefix:
        path = f"{sp.snapshot_prefix}_iter_{trainer.iter}.npz"
        trainer.snapshot(path)
        print(f"Snapshotting to {path}")
    print("Optimization Done.")
    return 0


def run_test_net(model: str, weights: str | None, iterations: int,
                    device: str = "cuda",
                    blobs: list[str] | None = None
                    ) -> Iterator[dict[str, torch.Tensor]]:
    """``iterations`` forward passes of the TEST-phase net of ``model`` on
    ``weights``, fed from its data layer (a net whose data layers make
    their own tops, as DummyData does, takes no feed).  Yields the named
    ``blobs`` of each pass, the net's output blobs by default.  f32 nets
    run in full f32, as the Solver's test passes do."""
    import torch

    from ..data.db import feed_for_net
    from ..graph.net import Net
    from ..proto import NetState, Phase, load_net_prototxt
    from ..solvers.solver import load_weights_into
    from ..utils.device import full_f32, resolve_device

    dev = resolve_device(device)
    net_param = load_net_prototxt(model)
    net = Net(net_param, NetState(Phase.TEST))
    for b in blobs or ():
        if b not in net.blob_shapes:
            raise SystemExit(f"unknown blob {b!r} "
                             f"(extract_features.cpp CHECK has_blob)")
    params = net.init(torch.Generator().manual_seed(0), device=dev)
    if weights:
        params = load_weights_into(net, params, weights)
    gen = torch.Generator().manual_seed(2)
    feed = (feed_for_net(net_param, Phase.TEST, device=dev)
            if net.input_blobs else None)
    try:
        for _ in range(iterations):
            with torch.no_grad(), full_f32():
                batch = ({k: torch.from_numpy(v).to(dev)
                          for k, v in next(feed).items()} if feed else {})
                out = net.apply(params, batch, blobs=blobs, generator=gen,
                                device=dev)
            yield out
    finally:
        if feed is not None:
            feed.close()


def score(model: str, weights: str | None, iterations: int,
          device: str = "cuda") -> dict[str, list[float]]:
    """Each output blob's mean per batch over ``iterations`` TEST passes
    of ``model`` on ``weights`` (caffe.cpp test())."""
    import collections
    per_batch: dict[str, list[float]] = collections.defaultdict(list)
    for out in run_test_net(model, weights, iterations, device):
        for k, v in out.items():
            per_batch[k].append(float(v.double().mean()))
    return dict(per_batch)


def _test(args) -> int:
    per_batch = score(args.model, args.weights, args.iterations,
                      args.device)
    for i in range(args.iterations):
        print(f"Batch {i}, " + ", ".join(f"{k} = {v[i]:.4f}"
                                          for k, v in per_batch.items()))
    for k, v in per_batch.items():
        print(f"{k} = {sum(v) / args.iterations:.6f}")
    return 0


def _time(args) -> int:
    from .time_net import main as time_main
    argv = ["--prototxt", args.model, "--iterations", str(args.iterations),
            "--device", args.device]
    if args.per_layer:
        argv.append("--per-layer")
    return time_main(argv)


def _device_query(args) -> int:
    import torch

    from ..utils.profiling import device_memory_summary
    if not torch.cuda.is_available():
        print("device_query: no CUDA device", file=sys.stderr)
        return 1
    for row in device_memory_summary():
        print(f"Device:                        {row['device']}")
        print(f"Device kind:                   {row['kind']}")
        for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_free",
                    "bytes_limit"):
            print(f"{key + ':':<30} {row[key]}")
    return 0


def _resolve_solver_net(sp, solver_path: str) -> None:
    """Load the solver's net:/train_net:/test_net: file references into
    *_net_param (Solver::InitTrainNet/InitTestNets path resolution)."""
    from ..proto.caffe_pb import resolve_solver_nets
    try:
        resolve_solver_nets(sp, solver_path)
    except FileNotFoundError as e:
        raise SystemExit(str(e))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="caffe",
                                 description="caffe.cpp CLI analog")
    sub = ap.add_subparsers(dest="action", required=True)
    p = sub.add_parser("train")
    p.add_argument("--solver", required=True)
    p.add_argument("--snapshot", default=None)
    p.add_argument("--weights", default=None)
    p.add_argument("--devices", default=None, metavar="N|all",
                   help="train N workers data-parallel on the one device "
                        "(the `caffe train --gpu 0,1,...` analog, "
                        "caffe.cpp:81-103); prototxt batch is per worker")
    p.add_argument("--strategy",
                   choices=["sync", "local_sgd", "hierarchical"],
                   default="sync",
                   help="sync: per-step gradient averaging (P2PSync "
                        "semantics); local_sgd: tau-step weight averaging "
                        "(SparkNet rounds); hierarchical: not ported "
                        "(ROADMAP A5)")
    p.add_argument("--tau", type=int, default=1,
                   help="steps per round for local_sgd")
    p.add_argument("--hosts", type=int, default=None,
                   help="multi-host training: not ported (ROADMAP A12)")
    p.set_defaults(fn=_train)
    p = sub.add_parser("test")
    p.add_argument("--model", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--iterations", type=int, default=50)
    p.set_defaults(fn=_test)
    p = sub.add_parser("time")
    p.add_argument("--model", required=True)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--per-layer", action="store_true")
    p.set_defaults(fn=_time)
    p = sub.add_parser("device_query")
    p.set_defaults(fn=_device_query)
    for p in sub.choices.values():
        p.add_argument("--device", default="cuda",
                       help="cuda (default; raises without one) or cpu")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
