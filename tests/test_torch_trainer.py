"""The port's trainer against the JAX package's, on the CPU.

Both trainers run ``local_sgd`` or ``sync`` with 2 workers from the same
weights (the JAX trainer draws them, ``convert.params_from_jax`` carries
them across) on the same numpy batches.  Round losses and the params agree at
rtol 2e-4, atol 2e-5, the bound of tests/test_parallel.py:128-129: the
two frameworks sum convolutions and products in other orders, and the
differences grow over the steps.  The nets have no stochastic layer, or
Dropout at ratio 0 (the identity in both packages), since the JAX
package's masks come from ``jax.random`` and the port's from a
``torch.Generator``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                 TrainerConfig)
from sparknet_tpu_torch.proto import (load_net_prototxt,
                                      load_solver_prototxt_with_net)
from test_torch_net import NARROW_CAFFENET

RTOL, ATOL = 2e-4, 2e-5
SOLVER_TXT = 'base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\n'
# the app's CaffeNet solver with a step every 4 iterations, so the policy
# and the weight decay (and its decay_mult of 0 on biases) both act
CAFFENET_SOLVER = ('base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
                   'lr_policy: "step"\ngamma: 0.1\nstepsize: 4\n')
NARROW_NO_DROPOUT = NARROW_CAFFENET.replace("dropout_ratio: 0.5",
                                            "dropout_ratio: 0.0")


def _lenet_rounds(seed, rounds, steps, global_batch, classes=10):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        labels = rng.integers(0, classes, size=(steps, global_batch))
        x = rng.normal(scale=0.3, size=(steps, global_batch, 1, 28, 28))
        for k in range(classes):
            x[labels == k, :, k % 28, :] += 2.0
        out.append({"data": x.astype(np.float32),
                    "label": labels.astype(np.float32)})
    return out


def _narrow_rounds(seed, rounds, steps, global_batch):
    rng = np.random.default_rng(seed)
    return [{"data": (30.0 * rng.normal(size=(steps, global_batch, 3, 67,
                                              67))).astype(np.float32),
             "label": rng.integers(0, 16, size=(steps, global_batch))
             .astype(np.float32)} for _ in range(rounds)]


def _pair(jax_sp, sp, tau, n_workers=2):
    jtr = JaxTrainer(jax_sp, make_mesh(n_workers),
                     JaxConfig(strategy="local_sgd", tau=tau), seed=0)
    tr = DistributedTrainer(sp, n_workers, TrainerConfig(tau=tau), seed=0,
                            device="cpu")
    tr.params = params_from_jax(jax.device_get(jtr.params), tr.train_net,
                                device="cpu")
    return jtr, tr


def _assert_params_close(tr, jtr):
    want = jax.device_get(jtr.params)
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            np.testing.assert_allclose(b.numpy(), np.asarray(want[k][i]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}[{i}]")


def _train_both(jtr, tr, rounds):
    for r, batches in enumerate(rounds):
        jloss = jtr.train_round(batches)
        loss = tr.train_round(batches)
        np.testing.assert_allclose(loss, jloss, rtol=RTOL,
                                   err_msg=f"round {r} loss")
        _assert_params_close(tr, jtr)
    return jloss


def test_local_sgd_lenet_tracks_jax():
    jtr, tr = _pair(jax_solver(SOLVER_TXT, jax_lenet(8, 8)),
                    load_solver_prototxt_with_net(SOLVER_TXT, lenet(8, 8)),
                    tau=3)
    first = tr.params["conv1"][0].clone()
    _train_both(jtr, tr, _lenet_rounds(0, rounds=3, steps=3,
                                       global_batch=16))
    assert tr.iter == jtr.iter == 9
    assert not torch.equal(first, tr.params["conv1"][0])


def test_local_sgd_narrow_caffenet_tracks_jax():
    """The narrow CaffeNet of test_torch_net.py, Dropout at ratio 0, with
    the CaffeNet solver's momentum, weight decay and step policy: the
    training path's LRN and MAX-pool backward (the plain versions on the
    CPU) against the JAX package's."""
    jtr, tr = _pair(
        jax_solver(CAFFENET_SOLVER, jax_load_net(
            NARROW_NO_DROPOUT)),
        load_solver_prototxt_with_net(CAFFENET_SOLVER,
                                      load_net_prototxt(NARROW_NO_DROPOUT)),
        tau=3)
    loss = _train_both(jtr, tr, _narrow_rounds(1, rounds=3, steps=3,
                                               global_batch=4))
    assert np.isfinite(loss)


def test_local_sgd_iter_size_2_tracks_jax():
    txt = SOLVER_TXT + "iter_size: 2\nweight_decay: 0.001\n"
    jtr, tr = _pair(jax_solver(txt, jax_lenet(4, 4)),
                    load_solver_prototxt_with_net(txt, lenet(4, 4)), tau=2)
    assert tr.batches_per_round == jtr.batches_per_round == 4
    _train_both(jtr, tr, _lenet_rounds(2, rounds=2, steps=4,
                                       global_batch=8))


def test_local_sgd_master_is_mean_of_independent_workers():
    """After one round of τ=3 the master params equal the mean of what
    each worker computes alone on its shard from the same start, with its
    own solver state (the WeightCollection.add / scalarDivide invariant of
    tests/test_parallel.py:84-129), replayed in the port alone."""
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(8, 8))
    tr = DistributedTrainer(sp, 2, TrainerConfig(tau=3), seed=0,
                            device="cpu")
    start = {k: [b.clone() for b in v] for k, v in tr.params.items()}
    (batches,) = _lenet_rounds(3, rounds=1, steps=3, global_batch=16)
    tr.train_round(batches)
    alone = []
    for w in range(2):
        solo = DistributedTrainer(sp, 1, TrainerConfig(tau=3), seed=0,
                                  device="cpu")
        solo.params = {k: [b.clone() for b in v] for k, v in start.items()}
        solo.train_round({k: v[:, 8 * w:8 * (w + 1)]
                          for k, v in batches.items()})
        alone.append(solo.params)
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            want = (alone[0][k][i] + alone[1][k][i]) / 2
            np.testing.assert_allclose(b.numpy(), want.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k}[{i}]")
            torch.testing.assert_close(
                b, torch.stack([p[k][i] for p in tr.worker_params]).mean(0),
                rtol=0, atol=0)


def test_momentum_history_persists_across_rounds():
    """Each worker keeps its SGD history between rounds (JAX state is
    stacked per worker, trainer.py:659 and :687): after a second round of
    one step the history is momentum x the first round's plus the new
    step's lr x gradient, which a worker starting with no history from
    the same params computes alone."""
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(4, 4))
    tr = DistributedTrainer(sp, 1, TrainerConfig(tau=1), seed=0,
                            device="cpu")
    r0, r1 = _lenet_rounds(4, rounds=2, steps=1, global_batch=4)
    tr.train_round(r0)
    first = {k: [h.clone() for h in v]
             for k, v in tr.state[0]["history"].items()}
    fresh = DistributedTrainer(sp, 1, TrainerConfig(tau=1), seed=0,
                               device="cpu")
    fresh.params = {k: [b.clone() for b in v] for k, v in tr.params.items()}
    tr.train_round(r1)
    fresh.train_round(r1)
    for k, hs in tr.state[0]["history"].items():
        for i, h in enumerate(hs):
            want = 0.9 * first[k][i] + fresh.state[0]["history"][k][i]
            np.testing.assert_allclose(h.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k}[{i}]")
    assert float(first["ip2"][0].abs().max()) > 0
    assert tr.iter == 2


def test_distributed_test_sums_worker_batches():
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(8, 8))
    tr = DistributedTrainer(sp, 2, TrainerConfig(tau=1), seed=0,
                            device="cpu")
    (b,) = _lenet_rounds(5, rounds=1, steps=2, global_batch=16)
    feed = iter([{k: v[t] for k, v in b.items()} for t in range(2)])
    scores = tr.test(feed, num_steps=2)
    assert scores["__test_batches__"] == 4   # 2 workers x 2 steps
    assert 0.0 <= scores["accuracy"] / 4 <= 1.0
    assert np.isfinite(scores["loss"])


@pytest.mark.parametrize("config,error,match", [
    # hierarchical over a flat layout: it needs make_pod_mesh's
    (TrainerConfig(strategy="hierarchical"), ValueError, "make_pod_mesh"),
    (TrainerConfig(strategy="sync", comm_codec="int8"), ValueError,
     "gradients"),
    # a partition rule table that is not there
    (TrainerConfig(shard="no_such_table.json"), FileNotFoundError,
     "no_such_table"),
    (TrainerConfig(checkpoint_dir="ckpt", checkpoint_every=0), ValueError,
     "checkpoint_every"),
    (TrainerConfig(guard_numerics=True), ValueError, "checkpoint_dir"),
    (TrainerConfig(audit_every=1), ValueError, "audit_every needs"),
    # the audit's cadence against the retention (sharded checkpoints)
    (TrainerConfig(shard_checkpoint=True, checkpoint_dir="ckpt",
                   audit_every=5, checkpoint_keep=2), ValueError,
     "outruns the checkpoint"),
    (TrainerConfig(remat=True), NotImplementedError, "A5"),
    (TrainerConfig(comm_codec="int9"), ValueError, "unknown comm codec")],
    ids=["hierarchical", "codec", "shard", "checkpoint", "guard", "audit",
         "shard_checkpoint", "remat", "unknown_codec"])
def test_unported_settings_raise(config, error, match):
    """Only ``remat`` is refused as not ported, naming its ROADMAP item;
    the other cases are the JAX package's own errors
    (sparknet_tpu/parallel/trainer.py:327-347, :473-530), the partition
    table's and the audit's among them."""
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(4, 4))
    with pytest.raises(error, match=match):
        # two workers: one shard would resolve no plan and read no table
        DistributedTrainer(sp, 2, config, device="cpu")


def _sync_pair(jax_sp, sp, tau, n_workers=2):
    jtr = JaxTrainer(jax_sp, make_mesh(n_workers),
                     JaxConfig(strategy="sync", tau=tau), seed=0)
    tr = DistributedTrainer(sp, n_workers,
                            TrainerConfig(strategy="sync", tau=tau), seed=0,
                            device="cpu")
    tr.params = params_from_jax(jax.device_get(jtr.params), tr.train_net,
                                device="cpu")
    return jtr, tr


@pytest.mark.parametrize("iter_size", [1, 2])
def test_sync_lenet_tracks_jax(iter_size):
    """``sync`` (JAX make_psum_step/sync_body, trainer.py:577-617): per
    step the workers' accumulated gradients and losses are averaged,
    ``preprocess_grads`` runs on the average and one update moves one
    shared state.  Per-round losses and the params against the JAX
    trainer on a 2-device mesh, τ=2, with weight decay acting."""
    txt = SOLVER_TXT + f"iter_size: {iter_size}\nweight_decay: 0.001\n"
    jtr, tr = _sync_pair(jax_solver(txt, jax_lenet(8, 8)),
                         load_solver_prototxt_with_net(txt, lenet(8, 8)),
                         tau=2)
    first = tr.params["conv1"][0].clone()
    _train_both(jtr, tr, _lenet_rounds(6, rounds=3, steps=2 * iter_size,
                                       global_batch=8))
    assert tr.iter == jtr.iter == 6
    assert isinstance(tr.state, dict) and tr.worker_params == []
    assert not torch.equal(first, tr.params["conv1"][0])


def test_sync_step_is_one_update_with_the_workers_mean_gradient():
    """One sync step of 2 workers equals one step of 1 worker whose
    gradient is the mean of the two halves' gradients, which for a
    mean-reduced loss is one worker over the whole batch (up to the
    order of the sums): the same state moves once."""
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(8, 8))
    two = DistributedTrainer(sp, 2, TrainerConfig(strategy="sync", tau=1),
                             seed=0, device="cpu")
    one = DistributedTrainer(sp, 1, TrainerConfig(strategy="sync", tau=1),
                             seed=0, device="cpu")
    (batches,) = _lenet_rounds(7, rounds=1, steps=1, global_batch=8)
    loss2, loss1 = two.train_round(batches), one.train_round(batches)
    np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
    for k, blobs in two.params.items():
        for i, b in enumerate(blobs):
            np.testing.assert_allclose(b.numpy(), one.params[k][i].numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{k}[{i}]")
            np.testing.assert_allclose(
                two.state["history"][k][i].numpy(),
                one.state["history"][k][i].numpy(), rtol=1e-4, atol=1e-6)


def test_trainer_refuses_to_leave_the_card_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(4, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedTrainer(sp, 1)
