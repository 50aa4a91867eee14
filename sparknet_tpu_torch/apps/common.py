"""The outer training loop the apps run.

The port's copy of ``sparknet_tpu/apps/common.py``.  The reference's
Spark round loop (reference: src/main/scala/apps/ImageNetApp.scala:
100-182): broadcast weights -> each worker trains τ local steps on
minibatches from its partition -> collect and average -> every
``test_interval`` rounds, a distributed eval whose per-worker scores are
summed (:138-140).  The averaging lives in the trainer's round; the loop
here assembles each round's feed, runs it and logs.  Rounds are built on
the host one after another (no prefetch thread), and snapshots and
signal handling are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from ..data.partition import PartitionedDataset
from ..parallel.trainer import DistributedTrainer
from ..utils.timing import PhaseLogger


@dataclasses.dataclass
class TrainingRun:
    """What an app's ``main`` leaves: the last eval's scores, the trainer
    (params, per-worker params of the last round, losses, timings) and
    the round feed (its host seconds per round)."""

    scores: dict[str, Any]
    trainer: DistributedTrainer
    feed: "RoundFeed"


class RoundFeed:
    """Assembles [τ·iter_size, N·batch, ...] round feeds from a
    partitioned dataset: one partition per worker, a contiguous run of
    minibatches per round per partition from a random start
    (MinibatchSampler's semantics, reference:
    src/main/scala/libs/MinibatchSampler.scala:18-19), each minibatch put
    through ``preprocess`` (the setTrainData closure, reference:
    src/main/scala/libs/Net.scala:79-84).  Only the sampled slice of each
    partition is stacked.  ``seconds`` holds each round's host time."""

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

    def _minibatch(self, part, batch_idx: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        lo = batch_idx * self.batch
        recs = part[lo:lo + self.batch]
        x = np.stack([r[0] for r in recs])
        y = np.asarray([r[1] for r in recs], np.float32)
        if self.preprocess is not None:
            x = self.preprocess(x)
        return x, y

    def next_round(self) -> dict[str, np.ndarray]:
        t0 = time.perf_counter()
        starts = [int(self._rng.integers(0, nb - self.batches_per_round + 1))
                  for nb in self._n_batches]
        data_steps, label_steps = [], []
        for t in range(self.batches_per_round):
            imgs, labs = [], []
            for part, start in zip(self._parts, starts):
                x, y = self._minibatch(part, start + t)
                imgs.append(x)
                labs.append(y)
            data_steps.append(np.concatenate(imgs))
            label_steps.append(np.concatenate(labs))
        out = {"data": np.stack(data_steps), "label": np.stack(label_steps)}
        self.seconds.append(time.perf_counter() - t0)
        return out


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
                 logger: PhaseLogger | None = None) -> dict[str, Any]:
    """The outer loop (reference: CifarApp.scala:87-128), bounded by
    ``rounds``: an eval before every ``test_interval``-th round after the
    first, and one at the end.  Returns the last eval's scores."""
    log = logger or PhaseLogger()
    last_scores: dict[str, Any] = {}
    for r in range(rounds):
        if test_interval and r % test_interval == 0 and r > 0:
            log.log("testing")
            last_scores = normalize_scores(
                trainer.test(test_factory(), test_steps), test_steps)
            log.log(f"round {r}: eval {last_scores}")
        t0 = time.perf_counter()
        batches = feed.next_round()
        feed_s = feed.seconds[-1]
        loss = trainer.train_round(batches)
        log.log(f"round {r}: tau={trainer.config.tau} loss={loss:.4f} "
                f"({time.perf_counter() - t0:.2f}s, feed {feed_s:.2f}s)")
    last_scores = normalize_scores(trainer.test(test_factory(), test_steps),
                                   test_steps)
    log.log(f"final eval: {last_scores}")
    return last_scores
