"""ImageNetApp: AlexNet, CaffeNet, GoogLeNet or VGG-16 with τ-step local
SGD (reference: src/main/scala/apps/ImageNetApp.scala).

The port's counterpart of ``sparknet_tpu/apps/imagenet_app.py``.
``--tar-dir`` reads tar archives of JPEGs with a ``--label-file`` map
(ImageNetLoader, :84-95), decoded and force-resized to ``--resize`` on
access, on the run's device (nvJPEG and the resize kernel on the card:
``data/imagenet.py``, ``data/jpeg.py``); ``--synthetic``, or no
``--tar-dir``, fabricates resized-looking images instead.  The mean
image is computed on the host (ComputeMean, :84), in float64 chunk by
chunk over the train partitions, and the model trains in rounds of τ
local steps per worker (:144), or synchronous SGD with ``--strategy
sync``, with random-crop + mirror + mean-subtract train preprocessing
(:155-169) on the host or, with ``--device-preprocess``, on the card
(the host then ships raw full-size images), center-crop test
preprocessing (:117-131) and an eval every ``--test-interval`` rounds
aggregated across workers (:106-141).  The crop is 227 for AlexNet and
CaffeNet and 224 for GoogLeNet and VGG-16, as their published nets
take.  All workers share
one card and run one after another.  ``--snapshot PATH`` writes the
trainer's state there at the end (and on SIGHUP, SIGINT or SIGTERM);
``--log-dir`` also appends the log to ``training_log_<ts>.txt`` there.

Run:  python -m sparknet_tpu_torch.apps.imagenet_app --synthetic \\
          --model caffenet --workers 2 --batch 64 --tau 5 --rounds 2 \\
          --device-preprocess
      python -m sparknet_tpu_torch.apps.imagenet_app --tar-dir TARS \\
          --label-file train.txt --test-tar-dir VAL --test-label-file \\
          val.txt --workers 2 --batch 64 --tau 5 --device-preprocess
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np

from ..data.imagenet import load_imagenet
from ..data.partition import PartitionedDataset
from ..data.transforms import center_crop, random_crop_mirror
from ..models import alexnet, caffenet, googlenet, vgg16
from ..parallel.trainer import (DistributedTrainer, TrainerConfig,
                                device_crop_mirror_mean)
from ..proto import load_solver_prototxt_with_net
from ..utils.timing import PhaseLogger
from .common import RoundFeed, TrainingRun, eval_feed, run_training

# bvlc_reference_caffenet's solver, less its snapshot and display fields
SOLVER = """
base_lr: 0.01
momentum: 0.9
weight_decay: 0.0005
lr_policy: "step"
gamma: 0.1
stepsize: 100000
"""

MODELS = {"alexnet": alexnet, "caffenet": caffenet, "googlenet": googlenet,
          "vgg16": vgg16}


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
    """Per-pixel mean over every partition (the distributed ComputeMean,
    one partition at a time), read ``chunk`` records at a time so a lazy
    partition never decodes whole, each image added in turn to a float64
    sum, as the JAX package's native ``accumulate_mean`` adds them."""
    acc, count = None, 0
    for p in dataset.partitions:
        for i in range(0, len(p), chunk):
            for x, _ in p[i:i + chunk]:
                if acc is None:
                    acc = np.zeros(np.shape(x), np.float64)
                acc += x
        count += len(p)
    return (acc / max(count, 1)).astype(np.float32)


def main(argv=None) -> TrainingRun:
    ap = argparse.ArgumentParser(
        description="ImageNet parameter-averaging app")
    ap.add_argument("--tar-dir", default=None,
                    help="directory of .tar archives of JPEGs")
    ap.add_argument("--label-file", default=None, help="train.txt label map")
    ap.add_argument("--test-tar-dir", default=None,
                    help="the test tars (default: --tar-dir)")
    ap.add_argument("--test-label-file", default=None,
                    help="the test label map (default: --label-file)")
    ap.add_argument("--synthetic", action="store_true",
                    help="fabricate the data (also without --tar-dir)")
    ap.add_argument("--model", choices=sorted(MODELS), default="caffenet")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32,
                    help="per-worker minibatch size")
    ap.add_argument("--tau", type=int, default=50,
                    help="local steps per round (ImageNetApp.scala:144)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--test-interval", type=int, default=10)
    ap.add_argument("--strategy", choices=["local_sgd", "sync"],
                    default="local_sgd")
    ap.add_argument("--resize", type=int, default=256)
    ap.add_argument("--crop", type=int, default=None,
                    help="default 227 (alexnet, caffenet), else 224")
    ap.add_argument("--base-lr", type=float, default=None)
    ap.add_argument("--device-preprocess", action="store_true",
                    help="random crop, mirror and mean on the device (the "
                         "host ships raw full-size images)")
    ap.add_argument("--snapshot", default=None)
    ap.add_argument("--log-dir", default=None,
                    help="also append the log to training_log_<ts>.txt here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    crop = args.crop or (227 if args.model in ("alexnet", "caffenet")
                         else 224)

    log = PhaseLogger(None if args.log_dir is None else os.path.join(
        args.log_dir, f"training_log_{int(time.time())}.txt"))
    workers = args.workers
    if args.synthetic or args.tar_dir is None:
        log.log("using synthetic ImageNet-like data")
        need = args.batch * workers * (args.tau + 2)
        train_x, train_y = synthetic_imagenet(need, args.resize,
                                              args.classes, 1)
        test_x, test_y = synthetic_imagenet(
            max(args.batch * workers * 2, 64), args.resize, args.classes, 2)
        train_ds = PartitionedDataset.from_items(
            list(zip(train_x, train_y)), workers)
        test_ds = PartitionedDataset.from_items(list(zip(test_x, test_y)),
                                                workers)
    else:
        if args.label_file is None:
            raise SystemExit("--tar-dir needs --label-file")
        log.log(f"loading tars from {args.tar_dir}")
        train_ds = load_imagenet(args.tar_dir, args.label_file, workers,
                                 size=args.resize, device=args.device)
        test_ds = load_imagenet(args.test_tar_dir or args.tar_dir,
                                args.test_label_file or args.label_file,
                                workers, size=args.resize,
                                device=args.device)
    log.log(f"train/test partitions: {train_ds.partition_sizes()} / "
            f"{test_ds.partition_sizes()}")
    mean = mean_image(train_ds)
    log.log("computed mean image")

    net = MODELS[args.model](args.batch * workers, args.batch * workers,
                             crop=crop)
    sp = load_solver_prototxt_with_net(SOLVER, net)
    if args.base_lr is not None:
        sp.base_lr = args.base_lr
    if args.device_preprocess:
        train_pre = None    # the host ships raw images; the card crops
        device_pre = device_crop_mirror_mean(crop, mirror=True, mean=mean)
    else:
        train_pre = functools.partial(random_crop_mirror, crop=crop,
                                      rng=np.random.default_rng(7),
                                      mean=mean)
        device_pre = None
    trainer = DistributedTrainer(
        sp, workers, TrainerConfig(strategy=args.strategy, tau=args.tau,
                                   device_preprocess=device_pre),
        seed=0, device=args.device)
    log.log(f"built {args.model} for {workers} workers on "
            f"{trainer.device} ({args.strategy}, tau={args.tau}, "
            f"crop={crop}, {'device' if device_pre else 'host'} "
            f"preprocess)")
    feed = RoundFeed(train_ds, args.batch, trainer.batches_per_round,
                     preprocess=train_pre, seed=3)
    test_factory, test_steps = eval_feed(
        test_ds, args.batch,
        preprocess=functools.partial(center_crop, crop=crop, mean=mean))
    run = run_training(trainer, feed, test_factory, test_steps,
                       rounds=args.rounds, test_interval=args.test_interval,
                       logger=log, snapshot_path=args.snapshot)
    if args.snapshot:
        trainer.snapshot(args.snapshot)
        log.log(f"snapshot -> {args.snapshot}")
    return run


if __name__ == "__main__":
    main()
