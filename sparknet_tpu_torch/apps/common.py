"""The outer training loop the apps run.

The port's copy of ``sparknet_tpu/apps/common.py``.  The reference's
Spark round loop (reference: src/main/scala/apps/ImageNetApp.scala:
100-182): broadcast weights -> each worker trains τ local steps on
minibatches from its partition -> collect and average -> every
``test_interval`` rounds, a distributed eval whose per-worker scores are
summed (:138-140).  The averaging lives in the trainer's round; the loop
here takes each round from the trainer's device feed and logs.  Rounds
are assembled lazily (only each round's sampled slice of every partition
is stacked) on a prefetch thread and copied to the card ahead of use
(``data/prefetch.py``), so the host's work on round r+1 overlaps round
r on the card.  Signals snapshot and stop at round boundaries
(``utils/signals.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..data.partition import PartitionedDataset
from ..parallel.trainer import DistributedTrainer
from ..utils.signals import SignalGuard, SolverAction
from ..utils.timing import PhaseLogger


@dataclasses.dataclass
class TrainingRun:
    """What an app's ``main`` leaves: the last eval's scores, the trainer
    (params, per-worker params of the last round, losses, timings), the
    round feed (its host seconds per round), and per round of the loop,
    on the host clock, its seconds (the wait for the feed plus
    ``train_round``, the interval the loop logs) and the wait for the
    feed alone."""

    scores: dict[str, Any]
    trainer: DistributedTrainer
    feed: "RoundFeed"
    loop_seconds: list[float] = dataclasses.field(default_factory=list)
    feed_wait_seconds: list[float] = dataclasses.field(default_factory=list)


class RoundFeed:
    """Assembles [τ·iter_size, N·batch, ...] round feeds from a
    partitioned dataset: one partition per worker, a contiguous run of
    minibatches per round per partition from a random start
    (MinibatchSampler's semantics, reference:
    src/main/scala/libs/MinibatchSampler.scala:18-19), each minibatch put
    through ``preprocess`` (the setTrainData closure, reference:
    src/main/scala/libs/Net.scala:79-84).  Only the sampled slice of each
    partition is stacked.  ``seconds`` holds each round's host time, in
    the order the rounds were built."""

    def __init__(self, dataset: PartitionedDataset, per_worker_batch: int,
                 batches_per_round: int,
                 preprocess: Callable[[np.ndarray], np.ndarray] | None = None,
                 seed: int = 0):
        self.batches_per_round = batches_per_round
        self.batch = per_worker_batch
        self.preprocess = preprocess
        self._rng = np.random.default_rng(seed)
        self._parts = dataset.partitions
        self.seconds: list[float] = []
        # drop-remainder batch counts (ScaleAndConvert.makeMinibatchRDD,
        # reference: ScaleAndConvert.scala:30-55)
        self._n_batches = [len(p) // per_worker_batch for p in self._parts]
        for nb in self._n_batches:
            if nb < batches_per_round:
                raise ValueError(
                    f"partition has {nb} minibatches < batches_per_round="
                    f"{batches_per_round}")

    def next_round(self) -> dict[str, np.ndarray]:
        """The next round, as numpy arrays.  Each minibatch's images are
        written straight into their slot of the round (one copy, by
        torch, which releases the interpreter lock while it copies: the
        round is built on the feed's thread while the main thread
        launches the card's work); a ``preprocess`` output is copied in
        the same way."""
        t0 = time.perf_counter()
        starts = [int(self._rng.integers(0, nb - self.batches_per_round + 1))
                  for nb in self._n_batches]
        b, steps = self.batch, self.batches_per_round
        data = labels = None
        for t in range(steps):
            for w, (part, start) in enumerate(zip(self._parts, starts)):
                lo = (start + t) * b
                recs = part[lo:lo + b]
                if self.preprocess is None:
                    imgs = [torch.as_tensor(np.asarray(r[0])) for r in recs]
                    shape, dtype = imgs[0].shape, imgs[0].dtype
                else:
                    x = torch.as_tensor(np.ascontiguousarray(
                        self.preprocess(np.stack([r[0] for r in recs]))))
                    shape, dtype = x.shape[1:], x.dtype
                if data is None:
                    data = torch.empty((steps, len(self._parts) * b)
                                       + tuple(shape), dtype=dtype)
                    labels = np.empty((steps, len(self._parts) * b),
                                      np.float32)
                slot = data[t, w * b:(w + 1) * b]
                if self.preprocess is None:
                    torch.stack(imgs, out=slot)
                else:
                    slot.copy_(x)
                labels[t, w * b:(w + 1) * b] = [r[1] for r in recs]
        out = {"data": data.numpy(), "label": labels}
        self.seconds.append(time.perf_counter() - t0)
        return out

    def rounds(self) -> Iterator[dict[str, np.ndarray]]:
        """An endless round stream, for ``DistributedTrainer.input_feed``
        (the JAX package's ``RoundFeed.rounds``, apps/common.py:91-95)."""
        while True:
            yield self.next_round()


def eval_feed(dataset: PartitionedDataset, per_worker_batch: int,
              preprocess: Callable[[np.ndarray], np.ndarray] | None = None):
    """``(factory, steps)``: ``factory()`` yields global test minibatches
    spanning all partitions (the zipPartitions test pass, reference:
    ImageNetApp.scala:108-137).  Every worker contributes all of its full
    batches; where partitions are uneven, lockstep steps run to the
    largest partition's count and exhausted workers feed their first
    batch again, flagged invalid in ``"__valid__"``."""
    parts = dataset.partitions
    per_part_steps = [len(p) // per_worker_batch for p in parts]
    steps = max(per_part_steps)
    if min(per_part_steps) == 0:
        raise ValueError(
            f"eval would run 0 steps on a worker: smallest test partition "
            f"has {min(dataset.partition_sizes())} items < per-worker "
            f"batch {per_worker_batch}")
    uneven = steps != min(per_part_steps)

    def factory():
        for t in range(steps):
            imgs, labs, valid = [], [], []
            for p, n in zip(parts, per_part_steps):
                tt = t if t < n else 0
                recs = p[tt * per_worker_batch:(tt + 1) * per_worker_batch]
                x = np.stack([np.asarray(r[0]) for r in recs])
                y = np.asarray([r[1] for r in recs], np.float32)
                if preprocess is not None:
                    x = preprocess(x)
                valid.append(1.0 if t < n else 0.0)
                imgs.append(x)
                labs.append(y)
            batch = {"data": np.concatenate(imgs),
                     "label": np.concatenate(labs)}
            if uneven:
                batch["__valid__"] = np.asarray(valid, np.float32)
            yield batch

    return factory, steps


def normalize_scores(totals: dict, test_steps: int) -> dict:
    """The reference's score normalization: worker-batch sums divided by
    the number of worker-batches scored (ImageNetApp.scala:139-140)."""
    nb = float(totals.get("__test_batches__", test_steps)) or 1.0
    return {k: v / nb for k, v in totals.items()
            if k != "__test_batches__"}


def run_training(trainer: DistributedTrainer, feed: RoundFeed,
                 test_factory, test_steps: int, *, rounds: int,
                 test_interval: int = 10,
                 logger: PhaseLogger | None = None,
                 snapshot_path: str | None = None,
                 prefetch_depth: int | None = None) -> TrainingRun:
    """The outer loop (reference: CifarApp.scala:87-128; the JAX
    package's apps/common.py:152-211), bounded by ``rounds``: an eval
    before every ``test_interval``-th round after the first, and one at
    the end.  Rounds come through ``trainer.input_feed`` (prefetched
    ``prefetch_depth`` rounds ahead, default ``SPARKNET_FEED_DEPTH`` when
    set, else 1).  SIGHUP snapshots to ``snapshot_path`` and goes on;
    SIGINT and SIGTERM stop at the next round boundary after a snapshot
    (the SignalHandler to Solver::Step contract, reference:
    caffe/src/caffe/util/signal_handler.cpp, solver.cpp:270-281).  Must
    run on the main thread, where signal handlers are installed."""
    log = logger or PhaseLogger()
    run = TrainingRun({}, trainer, feed)

    def maybe_snapshot(reason: str) -> None:
        if snapshot_path:
            trainer.snapshot(snapshot_path)
            log.log(f"snapshot ({reason}) -> {snapshot_path}")

    # the handlers go in before the feed's threads start, so a signal
    # raised while the first round is built already meets them
    with SignalGuard() as guard, trainer.input_feed(
            feed.rounds(), depth=prefetch_depth) as round_iter:
        for r in range(rounds):
            action = guard.check()
            if action == SolverAction.SNAPSHOT:
                maybe_snapshot("SIGHUP")
            elif action in (SolverAction.STOP, SolverAction.SNAPSHOT_STOP):
                why = ("SIGTERM/preemption"
                       if action == SolverAction.SNAPSHOT_STOP else "SIGINT")
                log.log(f"stop requested ({why}); halting at round boundary")
                maybe_snapshot("stop")
                return run
            if test_interval and r % test_interval == 0 and r > 0:
                log.log("testing")
                run.scores = normalize_scores(
                    trainer.test(test_factory(), test_steps), test_steps)
                log.log(f"round {r}: eval {run.scores}")
            t0 = time.perf_counter()
            batches = next(round_iter)
            run.feed_wait_seconds.append(time.perf_counter() - t0)
            loss = trainer.train_round(batches)
            run.loop_seconds.append(time.perf_counter() - t0)
            log.log(f"round {r}: tau={trainer.config.tau} loss={loss:.4f} "
                    f"({run.loop_seconds[-1]:.2f}s, feed wait "
                    f"{run.feed_wait_seconds[-1]:.2f}s)")
        log.log(f"feed: {round_iter.pinned_bytes} pinned staging bytes, "
                f"{trainer.feed_stats.snapshot()}")
    run.scores = normalize_scores(trainer.test(test_factory(), test_steps),
                                  test_steps)
    log.log(f"final eval: {run.scores}")
    return run
