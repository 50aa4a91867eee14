"""The port's ImageNet app, on the CPU at a tiny size, and its feed
against the JAX package's.

``imagenet_app.main`` runs end to end on the CPU (``--device cpu``) with
CaffeNet's layers at a 67x67 crop of 72x72 synthetic images, and with
full-width GoogLeNet at batch 1 and its default 224 crop.  For the
same seeds the port's synthetic data, partitions, mean image, train
rounds (the ``RoundFeed`` with ``random_crop_mirror``) and test batches
(``eval_feed`` with ``center_crop``) equal the JAX package's byte for
byte.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import pytest
import torch

from sparknet_tpu import native
from sparknet_tpu.apps.common import RoundFeed as JaxRoundFeed
from sparknet_tpu.apps.common import eval_feed as jax_eval_feed
from sparknet_tpu.apps.imagenet_app import (
    synthetic_imagenet as jax_synthetic)
from sparknet_tpu.data.partition import (
    PartitionedDataset as JaxPartitionedDataset)
from sparknet_tpu.data import transforms as jax_transforms
from sparknet_tpu_torch.apps import imagenet_app
from sparknet_tpu_torch.apps.common import RoundFeed, eval_feed
from sparknet_tpu_torch.data import (PartitionedDataset, center_crop,
                                     compute_mean_image, random_crop_mirror)

TINY = ["--synthetic", "--device", "cpu", "--workers", "2", "--batch", "2",
        "--tau", "2", "--rounds", "2", "--test-interval", "1",
        "--resize", "72", "--crop", "67", "--classes", "10"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes on the CPU, and torch's thread pools, one per process and
    each as wide as the machine, oversubscribe it (full-width GoogLeNet's
    app run took 183 s under six workers against 4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def test_imagenet_app_runs_end_to_end_on_the_cpu():
    run = imagenet_app.main(TINY)
    tr = run.trainer
    assert tr.round == 2 and tr.iter == 4 and tr.n_workers == 2
    assert all(math.isfinite(v) for v in tr.round_losses.values())
    assert set(run.scores) == {"loss", "accuracy"}
    assert math.isfinite(run.scores["loss"])
    assert 0.0 <= run.scores["accuracy"] <= 1.0
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            torch.testing.assert_close(
                b, torch.stack([p[k][i] for p in tr.worker_params]).mean(0),
                rtol=0, atol=0, msg=f"{k}[{i}]")


def test_imagenet_app_refuses_to_leave_the_card_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imagenet_app.main(argv)


GOOGLENET_TINY = ["--synthetic", "--device", "cpu", "--model", "googlenet",
                  "--workers", "2", "--batch", "1", "--tau", "1",
                  "--rounds", "1", "--resize", "232", "--classes", "10"]


def test_imagenet_app_trains_googlenet_at_224_on_the_cpu():
    """GoogLeNet through the app: the crop defaults to 224 (227 only for
    AlexNet and CaffeNet), the TRAIN net carries the two auxiliary heads,
    and the eval scores are the TEST net's outputs."""
    run = imagenet_app.main(GOOGLENET_TINY)
    tr = run.trainer
    assert tr.train_net.blob_shapes["data"] == (2, 3, 224, 224)
    assert tr.train_net.output_blobs == ["loss1/loss1", "loss2/loss1",
                                         "loss3/loss3"]
    assert math.isfinite(tr.round_losses[0])
    assert set(run.scores) == {"loss3/loss3", "loss3/top-1", "loss3/top-5"}
    assert 0.0 <= run.scores["loss3/top-1"] <= run.scores["loss3/top-5"]
    assert "loss1/classifier" in tr.params


def test_imagenet_app_googlenet_refuses_to_leave_the_card_unasked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in GOOGLENET_TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imagenet_app.main(argv)


def test_imagenet_app_has_synthetic_data_only():
    with pytest.raises(NotImplementedError, match="synthetic"):
        imagenet_app.main(TINY[1:])


def test_feed_equals_the_jax_feed_byte_for_byte():
    workers, batch, rounds_per_feed, crop = 2, 3, 4, 61
    x, y = imagenet_app.synthetic_imagenet(workers * batch * 5, 64, 10, 1)
    jx, jy = jax_synthetic(workers * batch * 5, 64, 10, 1)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)

    ds = PartitionedDataset.from_items(list(zip(x, y)), workers)
    jds = JaxPartitionedDataset.from_items(list(zip(jx, jy)), workers)
    assert ds.partition_sizes() == jds.partition_sizes()
    mean = imagenet_app.mean_image(ds)
    acc = np.zeros(x.shape[1:], np.float64)
    for p in jds.partitions:   # the JAX app's mean, imagenet_app.py:140-149
        native.accumulate_mean(np.stack([r[0] for r in p]), acc)
    np.testing.assert_array_equal(mean, (acc / len(x)).astype(np.float32))

    feed = RoundFeed(ds, batch, rounds_per_feed, seed=3, preprocess=(
        functools.partial(random_crop_mirror, crop=crop,
                          rng=np.random.default_rng(7), mean=mean)))
    jfeed = JaxRoundFeed(jds, batch, rounds_per_feed, seed=3, preprocess=(
        functools.partial(jax_transforms.random_crop_mirror, crop=crop,
                          rng=np.random.default_rng(7), mean=mean)))
    for _ in range(2):
        got, want = feed.next_round(), jfeed.next_round()
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
    assert got["data"].shape == (rounds_per_feed, workers * batch, 3, crop,
                                 crop)

    factory, steps = eval_feed(ds, batch, functools.partial(
        center_crop, crop=crop, mean=mean))
    jfactory, jsteps = jax_eval_feed(jds, batch, functools.partial(
        jax_transforms.center_crop, crop=crop, mean=mean))
    assert steps == jsteps
    for got, want in zip(factory(), jfactory()):
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k


def test_mirror_and_crop_offsets_follow_the_generator():
    batch = np.arange(2 * 1 * 4 * 5, dtype=np.float32).reshape(2, 1, 4, 5)
    rng = np.random.default_rng(11)
    ys, xs = rng.integers(0, 2, size=2), rng.integers(0, 3, size=2)
    flips = rng.integers(0, 2, size=2)
    out = random_crop_mirror(batch, 3, np.random.default_rng(11))
    for i in range(2):
        want = batch[i, :, ys[i]:ys[i] + 3, xs[i]:xs[i] + 3]
        np.testing.assert_array_equal(
            out[i], want[:, :, ::-1] if flips[i] else want)


def test_partitions_and_mean_image_match_jax():
    items = list(range(11))
    ds = PartitionedDataset.from_items(items, 3)
    jds = JaxPartitionedDataset.from_items(items, 3)
    assert ds.partitions == jds.partitions
    assert ds.partition_sizes() == jds.partition_sizes() == [4, 4, 3]
    assert ds.count() == jds.count() == 11
    assert ds.map(lambda v: 2 * v).partitions == \
        jds.map(lambda v: 2 * v).partitions
    imgs = np.random.default_rng(12).uniform(0, 255, (5, 3, 4, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(compute_mean_image(imgs),
                                  jax_transforms.compute_mean_image(imgs))
