"""The CIFAR app and its nets in the port against the JAX package, on the
CPU.

- ``local_sgd`` rounds of ``cifar10_quick`` (AVE pooling) and
  ``cifar10_full`` (AVE pooling and WITHIN_CHANNEL LRN) with the app's
  solver, 2 workers, from the same weights (the JAX trainer draws them,
  ``convert.params_from_jax`` carries them across) on the same
  mean-subtracted pixel batches: round losses and averaged params at rtol
  2e-4, atol 2e-5, the bound of tests/test_parallel.py:128-129.
- ``cifar_app.main`` end to end at a tiny size with ``--device cpu``, its
  refusal to leave the card unasked, and ``--strategy sync`` and
  ``--snapshot``.
- The app's data: ``synthetic_cifar``, ``load_cifar10_binary`` on a
  written fixture, the mean image, the round feed and the eval feed equal
  the JAX package's byte for byte.
- The served ``cifar10_full`` and ``cifar10_quick`` against the JAX
  package's ``LoadedModel`` on the same weights, f32 at rtol 1e-4, atol
  1e-6.
"""

from __future__ import annotations

import math
import os

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.apps import cifar_app as jax_cifar_app
from sparknet_tpu.apps.common import RoundFeed as JaxRoundFeed
from sparknet_tpu.apps.common import eval_feed as jax_eval_feed
from sparknet_tpu.data import cifar as jax_cifar
from sparknet_tpu.data import transforms as jax_transforms
from sparknet_tpu.data.partition import (
    PartitionedDataset as JaxPartitionedDataset)
from sparknet_tpu.models import cifar10_full as jax_cifar10_full
from sparknet_tpu.models import cifar10_quick as jax_cifar10_quick
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.parallel.serving import LoadedModel as JaxLoadedModel
from sparknet_tpu.parallel.serving import ServeConfig as JaxServeConfig
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu_torch.apps import cifar_app
from sparknet_tpu_torch.apps.common import RoundFeed, eval_feed
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.data import (PartitionedDataset, compute_mean_image,
                                     load_cifar10_binary,
                                     write_cifar10_binary)
from sparknet_tpu_torch.models import cifar10_full, cifar10_quick
from sparknet_tpu_torch.parallel.serving import (LoadedModel, ServeConfig,
                                                 zoo_models)
from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                 TrainerConfig)
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net

RTOL, ATOL = 2e-4, 2e-5
NETS = {"quick": (cifar10_quick, jax_cifar10_quick),
        "full": (cifar10_full, jax_cifar10_full)}
TINY = ["--synthetic", "--device", "cpu", "--workers", "2", "--batch", "4",
        "--tau", "2", "--rounds", "2", "--test-interval", "1"]


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


def _rounds(seed, rounds, steps, global_batch):
    """Mean-subtracted synthetic CIFAR pixels, as the app feeds them."""
    x, y = cifar_app.synthetic_cifar(rounds * steps * global_batch, seed)
    x = x - compute_mean_image(x)
    shape = (rounds, steps, global_batch)
    x = x.reshape(shape + x.shape[1:])
    y = y.astype(np.float32).reshape(shape)
    return [{"data": x[r], "label": y[r]} for r in range(rounds)]


@pytest.mark.parametrize("model", ["quick", "full"])
def test_local_sgd_cifar_tracks_jax(model):
    port_fn, jax_fn = NETS[model]
    jtr = JaxTrainer(jax_solver(cifar_app.SOLVER, jax_fn(4, 4)),
                     make_mesh(2), JaxConfig(strategy="local_sgd", tau=3),
                     seed=0)
    tr = DistributedTrainer(
        load_solver_prototxt_with_net(cifar_app.SOLVER, port_fn(4, 4)), 2,
        TrainerConfig(tau=3), seed=0, device="cpu")
    tr.params = params_from_jax(jax.device_get(jtr.params), tr.train_net,
                                device="cpu")
    first = tr.params["conv1"][0].clone()
    for r, batches in enumerate(_rounds(1, rounds=2, steps=3,
                                        global_batch=8)):
        jloss = jtr.train_round(batches)
        loss = tr.train_round(batches)
        np.testing.assert_allclose(loss, jloss, rtol=RTOL,
                                   err_msg=f"round {r} loss")
        want = jax.device_get(jtr.params)
        for k, blobs in tr.params.items():
            for i, b in enumerate(blobs):
                np.testing.assert_allclose(
                    b.numpy(), np.asarray(want[k][i]), rtol=RTOL, atol=ATOL,
                    err_msg=f"round {r} {k}[{i}]")
    assert tr.iter == jtr.iter == 6
    assert not torch.equal(first, tr.params["conv1"][0])


@pytest.mark.parametrize("model", ["quick", "full"])
def test_cifar_app_runs_end_to_end_on_the_cpu(model, tmp_path):
    run = cifar_app.main(TINY + ["--model", model,
                                 "--log-dir", str(tmp_path)])
    tr = run.trainer
    assert tr.round == 2 and tr.iter == 4 and tr.n_workers == 2
    assert all(math.isfinite(v) for v in tr.round_losses.values())
    assert set(run.scores) == {"loss", "accuracy"}
    assert 0.0 <= run.scores["accuracy"] <= 1.0
    assert tr.train_net.blob_shapes["data"] == (8, 3, 32, 32)
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            torch.testing.assert_close(
                b, torch.stack([p[k][i] for p in tr.worker_params]).mean(0),
                rtol=0, atol=0, msg=f"{k}[{i}]")
    (log,) = os.listdir(tmp_path)
    assert "final eval" in (tmp_path / log).read_text()


def test_cifar_app_trains_on_the_binaries(tmp_path):
    """``--data-dir``: the train batches shuffled, the test batch as
    written, the mean of the train images subtracted."""
    x, y = cifar_app.synthetic_cifar(24, seed=3)
    write_cifar10_binary(str(tmp_path / "data_batch_1.bin"), x[:10], y[:10])
    write_cifar10_binary(str(tmp_path / "data_batch_2.bin"), x[10:16],
                         y[10:16])
    write_cifar10_binary(str(tmp_path / "test_batch.bin"), x[16:], y[16:])
    argv = [a for a in TINY if a != "--synthetic"]
    run = cifar_app.main(argv + ["--data-dir", str(tmp_path)])
    assert run.trainer.round == 2
    assert set(run.scores) == {"loss", "accuracy"}
    # 8 test images over 2 workers at batch 4: one batch each
    assert run.scores["accuracy"] in {k / 8 for k in range(9)}


def test_cifar_app_refuses_to_leave_the_card_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cifar_app.main(argv)


@pytest.mark.parametrize("extra", [["--strategy", "sync"],
                                   ["--snapshot", "cifar.npz"]],
                         ids=["sync", "snapshot"])
def test_cifar_app_runs_sync_and_snapshots(extra, tmp_path):
    """``--strategy sync``: one shared solver state, no per-worker params;
    ``--snapshot``: the file holds the trainer's params, iter and round."""
    extra = [str(tmp_path / a) if a.endswith(".npz") else a for a in extra]
    run = cifar_app.main(TINY + ["--model", "quick"] + extra)
    tr = run.trainer
    assert tr.round == 2 and tr.iter == 4
    assert all(math.isfinite(v) for v in tr.round_losses.values())
    if "sync" in extra:
        assert tr.config.strategy == "sync" and isinstance(tr.state, dict)
        assert tr.worker_params == []
    else:
        from sparknet_tpu_torch.utils.checkpoint import load_checkpoint
        blob = load_checkpoint(extra[1])
        assert int(blob["iter"]) == 4 and int(blob["round"]) == 2
        np.testing.assert_array_equal(blob["params"]["conv1"][0],
                                      tr.params["conv1"][0].numpy())


def test_cifar_data_equals_the_jax_apps_byte_for_byte(tmp_path):
    x, y = cifar_app.synthetic_cifar(60, seed=1)
    jx, jy = jax_cifar_app.synthetic_cifar(60, seed=1)
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()

    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"data_batch_{i + 1}.bin"))
        write_cifar10_binary(paths[-1], x[30 * i:30 * (i + 1)],
                             y[30 * i:30 * (i + 1)])
    jax_cifar.write_cifar10_binary(str(tmp_path / "jax.bin"), x[:30], y[:30])
    assert (tmp_path / "jax.bin").read_bytes() == open(paths[0],
                                                       "rb").read()
    for shuffle in (False, True):
        got = load_cifar10_binary(paths, shuffle=shuffle, seed=4)
        want = jax_cifar.load_cifar10_binary(paths, shuffle=shuffle, seed=4)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(
        load_cifar10_binary(paths[0])[0], x[:30].astype(np.uint8))
    with pytest.raises(FileNotFoundError):
        load_cifar10_binary(str(tmp_path / "absent.bin"))

    mean = compute_mean_image(x)
    assert mean.tobytes() == jax_transforms.compute_mean_image(x).tobytes()
    x, jx = x - mean, jx - mean
    ds = PartitionedDataset.from_items(list(zip(x, y)), 2)
    jds = JaxPartitionedDataset.from_items(list(zip(jx, jy)), 2)
    feed = RoundFeed(ds, 4, 3, seed=3)
    jfeed = JaxRoundFeed(jds, 4, 3, seed=3)
    for _ in range(2):
        got, want = feed.next_round(), jfeed.next_round()
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), k
    factory, steps = eval_feed(ds, 4)
    jfactory, jsteps = jax_eval_feed(jds, 4)
    assert steps == jsteps
    for got, want in zip(factory(), jfactory()):
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("model", ["cifar10_quick", "cifar10_full"])
def test_served_cifar_matches_jax_loaded_model(model):
    jax_fn = {"cifar10_quick": jax_cifar10_quick,
              "cifar10_full": jax_cifar10_full}[model]
    jlm = JaxLoadedModel(model, jax_fn(1, 1),
                         JaxServeConfig(batch_shapes=(1, 4), dtype="f32"))
    tlm = LoadedModel(model, zoo_models()[model](),
                      ServeConfig(batch_shapes=(1, 4), dtype="f32"),
                      device="cpu", params=jax.device_get(jlm.params))
    assert tlm.in_shape == tuple(jlm.in_shape) == (3, 32, 32)
    assert tlm.classes == jlm.classes == 10
    batch = (40.0 * np.random.default_rng(5).normal(
        size=(4, 3, 32, 32))).astype(np.float32)
    got, want = tlm.infer(batch), jlm.infer(batch)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
