"""The port's ImageNet app, on the CPU at a tiny size, and its feed
against the JAX package's.

``imagenet_app.main`` runs end to end on the CPU (``--device cpu``) with
CaffeNet's layers at a 67x67 crop of 72x72 synthetic images, with and
without ``--device-preprocess``, ``--strategy sync``, ``--snapshot`` and
``--log-dir``, and with full-width GoogLeNet at batch 1 and its default
224 crop.  For the same seeds the port's synthetic data, partitions, mean
image, train rounds (the ``RoundFeed`` with ``random_crop_mirror``) and
test batches (``eval_feed`` with ``center_crop``) equal the JAX
package's byte for byte.  ``run_training``'s signals: a SIGHUP raised
while a round is built snapshots and the run goes on; a SIGINT stops it
at the next round boundary after a snapshot.
"""

from __future__ import annotations

import functools
import math
import os
import signal

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
from sparknet_tpu_torch.apps.common import RoundFeed, eval_feed, run_training
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


@pytest.mark.parametrize("strategy", ["local_sgd", "sync"])
def test_imagenet_app_device_preprocess_snapshot_and_log(strategy, tmp_path):
    """``--device-preprocess``: the host ships raw 72x72 images, the
    trainer crops them to 67 on the device; ``--strategy``,
    ``--snapshot`` (a file the next trainer restores) and ``--log-dir``
    (the log file) through the same run."""
    snap = str(tmp_path / "caffenet.npz")
    run = imagenet_app.main(TINY + [
        "--device-preprocess", "--strategy", strategy, "--snapshot", snap,
        "--log-dir", str(tmp_path), "--rounds", "3"])
    tr = run.trainer
    assert tr.round == 3 and tr.config.strategy == strategy
    assert tr.config.device_preprocess is not None
    assert tr.train_net.blob_shapes["data"][-1] == 67
    assert all(math.isfinite(v) for v in tr.round_losses.values())
    assert math.isfinite(run.scores["loss"])
    assert len(run.loop_seconds) == len(run.feed_wait_seconds) == 3
    assert all(w <= t for w, t in zip(run.feed_wait_seconds,
                                      run.loop_seconds))
    assert tr.feed_stats.snapshot()["batches"] == 3
    # the host built raw rounds: no crop ran there
    assert run.feed.preprocess is None
    back = imagenet_app.DistributedTrainer(
        tr.sp, 2, imagenet_app.TrainerConfig(strategy=strategy),
        device="cpu")
    back.restore(snap)
    assert back.iter == tr.iter == 6
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            assert torch.equal(b, back.params[k][i]), f"{k}[{i}]"
    (log,) = [f for f in os.listdir(tmp_path) if f.startswith("training_log")]
    text = (tmp_path / log).read_text()
    assert "device preprocess" in text and f"snapshot -> {snap}" in text


def _signal_run(tmp_path, sig, rounds):
    """A lenet run_training whose feed raises ``sig`` while it builds the
    first round (on the feed's thread)."""
    from sparknet_tpu_torch.models import lenet
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\n', lenet(8, 8))
    tr = DistributedTrainer(sp, 2, TrainerConfig(tau=1), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 1, 28, 28)).astype(np.float32)
    ds = PartitionedDataset.from_items(
        list(zip(x, rng.integers(0, 10, 40))), 2)
    raised = []

    def hook(batch):
        if not raised:
            raised.append(True)
            os.kill(os.getpid(), sig)
        return batch

    feed = RoundFeed(ds, 4, tr.batches_per_round, preprocess=hook)
    test_factory, test_steps = eval_feed(ds, 4)
    snap = str(tmp_path / "sig.npz")
    run = run_training(tr, feed, test_factory, test_steps, rounds=rounds,
                       test_interval=0, snapshot_path=snap)
    return run, snap


def test_sighup_while_a_round_is_built_snapshots_and_runs_on(tmp_path):
    run, snap = _signal_run(tmp_path, signal.SIGHUP, rounds=4)
    assert run.trainer.round == 4 and len(run.loop_seconds) == 4
    assert os.path.exists(snap)
    assert set(run.scores) == {"loss", "accuracy"}
    assert signal.getsignal(signal.SIGHUP) == signal.SIG_DFL


def test_sigint_stops_at_the_next_round_boundary_with_a_snapshot(tmp_path):
    previous = signal.getsignal(signal.SIGINT)
    run, snap = _signal_run(tmp_path, signal.SIGINT, rounds=6)
    tr = run.trainer
    # the first round is built on the feed's thread while the loop starts:
    # the handler has run by the boundary before round 1 at the latest
    assert tr.round <= 1 and run.scores == {}
    from sparknet_tpu_torch.utils.checkpoint import load_checkpoint
    assert int(load_checkpoint(snap)["round"]) == tr.round
    assert signal.getsignal(signal.SIGINT) is previous


def test_signal_guard_maps_signals_as_the_jax_guard_does():
    """``SignalGuard`` and ``preemption_guard`` map the three signals to
    the JAX package's actions, queue them for ``check`` and restore the
    previous handlers on exit."""
    import time

    from sparknet_tpu.utils import signals as jax_signals
    from sparknet_tpu_torch.utils.signals import (SignalGuard, SolverAction,
                                                  preemption_guard)
    assert SignalGuard()._actions == jax_signals.SignalGuard()._actions
    assert preemption_guard()._actions == \
        jax_signals.preemption_guard()._actions
    before = signal.getsignal(signal.SIGHUP)
    with SignalGuard() as guard:
        assert guard.check() == SolverAction.NONE
        os.kill(os.getpid(), signal.SIGHUP)
        deadline = time.monotonic() + 5.0
        while not guard._pending and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.check() == SolverAction.SNAPSHOT
        assert guard.check() == SolverAction.NONE
    assert signal.getsignal(signal.SIGHUP) == before
