"""ImageNetApp: AlexNet/CaffeNet with τ-step local SGD (reference:
src/main/scala/apps/ImageNetApp.scala).

The port's counterpart of ``sparknet_tpu/apps/imagenet_app.py``, with
synthetic data only: ``--synthetic`` fabricates 256x256 images (the
reference's force-resize, :84-95), their mean image is computed on the
host (ComputeMean, :84), and the model trains in rounds of τ local steps
per worker (:144) with random-crop-227 + mirror + mean-subtract train
preprocessing (:155-169), center-crop test preprocessing (:117-131) and
an eval every ``--test-interval`` rounds aggregated across workers
(:106-141).  All workers share one card and run one after another.

Run:  python -m sparknet_tpu_torch.apps.imagenet_app --synthetic \\
          --model caffenet --workers 2 --batch 64 --tau 5 --rounds 2
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Any

import numpy as np

from ..data.partition import PartitionedDataset
from ..data.transforms import center_crop, random_crop_mirror
from ..models import alexnet, caffenet
from ..parallel.trainer import DistributedTrainer, TrainerConfig
from ..proto import load_solver_prototxt_with_net
from ..utils.timing import PhaseLogger
from .common import RoundFeed, eval_feed, run_training

# bvlc_reference_caffenet's solver, less its snapshot and display fields
SOLVER = """
base_lr: 0.01
momentum: 0.9
weight_decay: 0.0005
lr_policy: "step"
gamma: 0.1
stepsize: 100000
"""

MODELS = {"alexnet": alexnet, "caffenet": caffenet}


@dataclasses.dataclass
class TrainingRun:
    """What ``main`` leaves: the last eval's scores and the trainer
    (params, per-worker params of the last round, losses, timings)."""

    scores: dict[str, Any]
    trainer: DistributedTrainer


def synthetic_imagenet(n: int, size: int, classes: int, seed: int = 0):
    """``n`` resized-looking images (3, size, size) in [0, 255] with a
    class-dependent stripe, and their labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, size=n)
    x = rng.normal(scale=30.0, size=(n, 3, size, size)).astype(
        np.float32) + 120
    for i in range(n):
        k = labels[i]
        x[i, k % 3, (7 * k) % size, :] += 80.0
    return np.clip(x, 0, 255), labels.astype(np.int32)


def mean_image(dataset: PartitionedDataset, chunk: int = 64) -> np.ndarray:
    """Per-pixel mean over every partition, summed in float64 chunk by
    chunk (the distributed ComputeMean, one partition at a time)."""
    acc, count = None, 0
    for p in dataset.partitions:
        for i in range(0, len(p), chunk):
            imgs = np.stack([x for x, _ in p[i:i + chunk]])
            part = imgs.sum(axis=0, dtype=np.float64)
            acc = part if acc is None else acc + part
        count += len(p)
    return (acc / max(count, 1)).astype(np.float32)


def main(argv=None) -> TrainingRun:
    ap = argparse.ArgumentParser(
        description="ImageNet parameter-averaging app (synthetic data)")
    ap.add_argument("--synthetic", action="store_true",
                    help="fabricate the data (the only source ported)")
    ap.add_argument("--model", choices=sorted(MODELS), default="caffenet")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32,
                    help="per-worker minibatch size")
    ap.add_argument("--tau", type=int, default=50,
                    help="local steps per round (ImageNetApp.scala:144)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--test-interval", type=int, default=10)
    ap.add_argument("--resize", type=int, default=256)
    ap.add_argument("--crop", type=int, default=227)
    ap.add_argument("--base-lr", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.synthetic:
        raise NotImplementedError(
            "only --synthetic data is ported (no tar or record loaders)")

    log = PhaseLogger()
    workers = args.workers
    log.log("using synthetic ImageNet-like data")
    need = args.batch * workers * (args.tau + 2)
    train_x, train_y = synthetic_imagenet(need, args.resize, args.classes, 1)
    test_x, test_y = synthetic_imagenet(
        max(args.batch * workers * 2, 64), args.resize, args.classes, 2)
    train_ds = PartitionedDataset.from_items(list(zip(train_x, train_y)),
                                             workers)
    test_ds = PartitionedDataset.from_items(list(zip(test_x, test_y)),
                                            workers)
    log.log(f"train/test partitions: {train_ds.partition_sizes()} / "
            f"{test_ds.partition_sizes()}")
    mean = mean_image(train_ds)
    log.log("computed mean image")

    net = MODELS[args.model](args.batch * workers, args.batch * workers,
                             crop=args.crop)
    sp = load_solver_prototxt_with_net(SOLVER, net)
    if args.base_lr is not None:
        sp.base_lr = args.base_lr
    trainer = DistributedTrainer(sp, workers,
                                 TrainerConfig(strategy="local_sgd",
                                               tau=args.tau),
                                 seed=0, device=args.device)
    log.log(f"built {args.model} for {workers} workers on "
            f"{trainer.device} (local_sgd, tau={args.tau}, crop={args.crop})")
    train_pre = functools.partial(random_crop_mirror, crop=args.crop,
                                  rng=np.random.default_rng(7), mean=mean)
    feed = RoundFeed(train_ds, args.batch, trainer.batches_per_round,
                     preprocess=train_pre, seed=3)
    test_factory, test_steps = eval_feed(
        test_ds, args.batch,
        preprocess=functools.partial(center_crop, crop=args.crop, mean=mean))
    scores = run_training(trainer, feed, test_factory, test_steps,
                          rounds=args.rounds,
                          test_interval=args.test_interval, logger=log)
    return TrainingRun(scores, trainer)


if __name__ == "__main__":
    main()
