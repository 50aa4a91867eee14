"""The port's snapshots (``utils/checkpoint.py``,
``DistributedTrainer.snapshot``/``restore``) on the CPU, and across the
two packages.

- Round trip, bit for bit: params, per-worker (``local_sgd``) or shared
  (``sync``) solver state, iter, round and the generators; the restored
  trainer's next round equals the original's exactly, Dropout on.
- ``restore`` refuses another strategy or worker count (the JAX
  package's tests/test_parallel.py:157-170).
- Snapshot on schedule: ``<snapshot_prefix>_iter_<n>.npz`` when a round
  crosses the solver's ``snapshot`` interval.
- The file format: the JAX package's loader reads the port's files and
  its checksum agrees; a corrupt file raises ``CheckpointError``.
- Interop: a file written by the JAX trainer restores into the port, and
  the next round tracks the JAX trainer's next round at rtol 2e-4, atol
  2e-5 (tests/test_torch_trainer.py's bound); a file written by the port
  restores into the JAX trainer the same way.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu.utils import checkpoint as jax_checkpoint
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                 TrainerConfig,
                                                 device_crop_mirror_mean)
from sparknet_tpu_torch.proto import (load_net_prototxt,
                                      load_solver_prototxt_with_net)
from sparknet_tpu_torch.utils.checkpoint import (CheckpointError,
                                                 load_checkpoint,
                                                 save_checkpoint)
from test_torch_net import NARROW_CAFFENET

RTOL, ATOL = 2e-4, 2e-5
SOLVER_TXT = 'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n'


def _rounds(seed, rounds, steps, global_batch, size=28):
    rng = np.random.default_rng(seed)
    return [{"data": rng.normal(scale=0.5, size=(steps, global_batch, 1,
                                                 size, size))
             .astype(np.float32),
             "label": rng.integers(0, 10, size=(steps, global_batch))
             .astype(np.float32)} for _ in range(rounds)]


def _trainer(strategy, n_workers=2, tau=2, seed=0, txt=SOLVER_TXT,
             net=None, pre=None):
    sp = load_solver_prototxt_with_net(txt, net or lenet(8, 8))
    return DistributedTrainer(sp, n_workers, TrainerConfig(
        strategy=strategy, tau=tau, device_preprocess=pre), seed=seed,
        device="cpu")


def _assert_same(a, b):
    for k, blobs in a.params.items():
        for i, p in enumerate(blobs):
            assert torch.equal(p, b.params[k][i]), f"{k}[{i}]"
    sa = a.state if isinstance(a.state, list) else [a.state]
    sb = b.state if isinstance(b.state, list) else [b.state]
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        for k, blobs in x["history"].items():
            for i, h in enumerate(blobs):
                assert torch.equal(h, y["history"][k][i]), f"state {k}[{i}]"
    assert (a.iter, a.round) == (b.iter, b.round)


@pytest.mark.parametrize("strategy", ["local_sgd", "sync"])
def test_snapshot_round_trip_is_exact_and_continues_exactly(strategy,
                                                            tmp_path):
    """A net with Dropout (its masks drawn from the worker generators)
    and a device-side random crop (its offsets from the crop
    generators): the restored trainer is the original, and its next round
    is the original's next round, bit for bit."""
    net = load_net_prototxt(NARROW_CAFFENET)
    shape = (2, 4, 3, 72, 72)
    rng = np.random.default_rng(3)
    rounds = [{"data": rng.normal(scale=30.0, size=shape).astype(np.float32),
               "label": rng.integers(0, 16, shape[:2]).astype(np.float32)}
              for _ in range(2)]
    pre = device_crop_mirror_mean(67)
    tr = _trainer(strategy, net=net, pre=pre)
    tr.train_round(rounds[0])
    path = str(tmp_path / "s.npz")
    tr.snapshot(path)
    back = _trainer(strategy, seed=9, net=net, pre=pre)
    back.restore(path)
    _assert_same(tr, back)
    for g, h in zip(tr.generators + tr.crop_generators,
                    back.generators + back.crop_generators):
        assert torch.equal(g.get_state(), h.get_state())
    assert tr.train_round(rounds[1]) == back.train_round(rounds[1])
    _assert_same(tr, back)
    blob = load_checkpoint(path)
    assert str(blob["strategy"]) == strategy and int(blob["n_workers"]) == 2
    lead = blob["state"]["history"]["conv1"][0].shape
    assert lead == ((2,) if strategy == "local_sgd" else ()) + tuple(
        tr.params["conv1"][0].shape)


def test_restore_refuses_another_strategy_or_worker_count(tmp_path):
    path = str(tmp_path / "sync.npz")
    _trainer("sync").snapshot(path)
    with pytest.raises(ValueError, match="strategy"):
        _trainer("local_sgd").restore(path)
    with pytest.raises(ValueError, match="workers"):
        _trainer("sync", n_workers=4).restore(path)


def test_snapshot_on_schedule_names_the_iteration(tmp_path):
    prefix = str(tmp_path / "lenet")
    sp = load_solver_prototxt_with_net(SOLVER_TXT + "snapshot: 3\n",
                                       lenet(8, 8), snapshot_prefix=prefix)
    assert sp.snapshot == 3 and sp.snapshot_prefix == prefix
    tr = DistributedTrainer(sp, 2, TrainerConfig(tau=2), device="cpu")
    for batches in _rounds(1, rounds=3, steps=2, global_batch=8):
        tr.train_round(batches)
    # iters 2, 4, 6: the rounds ending at 4 and 6 crossed a multiple of 3
    assert sorted(os.listdir(tmp_path)) == ["lenet_iter_4.npz",
                                            "lenet_iter_6.npz"]
    assert int(load_checkpoint(prefix + "_iter_6.npz")["iter"]) == 6
    # without a prefix the interval is cleared, as the JAX loader does
    assert load_solver_prototxt_with_net(SOLVER_TXT + "snapshot: 3\n",
                                         lenet(8, 8)).snapshot == 0


def test_jax_reads_the_ports_files_and_a_corrupt_file_raises(tmp_path):
    tr = _trainer("local_sgd")
    tr.train_round(_rounds(2, rounds=1, steps=2, global_batch=8)[0])
    path = str(tmp_path / "p.npz")
    tr.snapshot(path)
    blob = jax_checkpoint.load_checkpoint(path)      # checksum verified
    np.testing.assert_array_equal(blob["params"]["conv1"][0],
                                  tr.params["conv1"][0].numpy())
    tree = {"a": [np.arange(3.0), torch.ones(2)], "b": {"c": np.int64(4)}}
    save_checkpoint(str(tmp_path / "t.npz"), tree)
    jax_checkpoint.save_checkpoint(str(tmp_path / "j.npz"),
                                   {"a": [np.arange(3.0), np.ones(2,
                                                                 np.float32)],
                                    "b": {"c": np.int64(4)}})
    mine, theirs = (load_checkpoint(str(tmp_path / f)) for f in
                    ("t.npz", "j.npz"))
    assert mine["a"][1].tobytes() == theirs["a"][1].tobytes()
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(CheckpointError):
        load_checkpoint(path)
    with pytest.raises(CheckpointError):
        load_checkpoint(str(tmp_path / "absent.npz"))


def _assert_tracks(tr, jtr, loss, jloss):
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    want = jax.device_get(jtr.params)
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            np.testing.assert_allclose(b.numpy(), np.asarray(want[k][i]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}[{i}]")


@pytest.mark.parametrize("strategy", ["local_sgd", "sync"])
def test_snapshots_restore_across_the_two_packages(strategy, tmp_path):
    """JAX writes after a round, the port restores and both run the next
    round; then the port writes and the JAX trainer restores, and both
    run one more."""
    r0, r1, r2 = _rounds(4, rounds=3, steps=2, global_batch=8)
    jtr = JaxTrainer(jax_solver(SOLVER_TXT, jax_lenet(8, 8)), make_mesh(2),
                     JaxConfig(strategy=strategy, tau=2), seed=0)
    jtr.train_round(r0)
    jpath = str(tmp_path / "from_jax.npz")
    jtr.snapshot(jpath)
    tr = _trainer(strategy, seed=5)
    tr.restore(jpath)
    assert (tr.iter, tr.round) == (2, 1)
    _assert_tracks(tr, jtr, tr.train_round(r1), jtr.train_round(r1))

    ppath = str(tmp_path / "from_port.npz")
    tr.snapshot(ppath)
    jback = JaxTrainer(jax_solver(SOLVER_TXT, jax_lenet(8, 8)), make_mesh(2),
                       JaxConfig(strategy=strategy, tau=2), seed=7)
    jback.restore(ppath)
    assert (jback.iter, jback.round) == (4, 2)
    want_state = jax.device_get(jback.state)["history"]["conv1"][0]
    got_state = (tr.state["history"]["conv1"][0] if strategy == "sync"
                 else torch.stack([s["history"]["conv1"][0]
                                   for s in tr.state]))
    np.testing.assert_array_equal(np.asarray(want_state), got_state.numpy())
    _assert_tracks(tr, jback, tr.train_round(r2), jback.train_round(r2))


RULE_TXT = {
    "Adam": ('type: "Adam"\nbase_lr: 0.001\nmomentum: 0.9\n'
             'momentum2: 0.999\ndelta: 1e-8\nlr_policy: "fixed"\n'),
    "AdaDelta": ('type: "AdaDelta"\nbase_lr: 1.0\nmomentum: 0.95\n'
                 'delta: 1e-6\nlr_policy: "fixed"\n'),
}


@pytest.mark.parametrize("rule", sorted(RULE_TXT))
def test_two_slot_rules_restore_across_the_two_packages(rule, tmp_path):
    """``local_sgd`` with Adam (``m``, ``v``) and AdaDelta (``sq_grad``,
    ``sq_update``): each slot stacked per worker in the JAX layout.  A
    JAX snapshot restores into the port with every slot bit for bit, and
    the next round tracks the JAX trainer's; the port's snapshot restores
    into a fresh JAX trainer with every slot bit for bit."""
    txt = RULE_TXT[rule]
    r0, r1 = _rounds(6, rounds=2, steps=2, global_batch=8)
    jtr = JaxTrainer(jax_solver(txt, jax_lenet(8, 8)), make_mesh(2),
                     JaxConfig(strategy="local_sgd", tau=2), seed=0)
    jtr.train_round(r0)
    jpath = str(tmp_path / "from_jax.npz")
    jtr.snapshot(jpath)
    tr = _trainer("local_sgd", seed=5, txt=txt)
    tr.restore(jpath)
    slots = sorted(tr.state[0])
    assert slots == sorted(jax.device_get(jtr.state))
    assert len(slots) == 2
    want = jax.device_get(jtr.state)
    for s in slots:
        for k, blobs in tr.state[0][s].items():
            for i in range(len(blobs)):
                got = torch.stack([st[s][k][i] for st in tr.state]).numpy()
                assert got.tobytes() == np.asarray(want[s][k][i]).tobytes()
    _assert_tracks(tr, jtr, tr.train_round(r1), jtr.train_round(r1))

    ppath = str(tmp_path / "from_port.npz")
    tr.snapshot(ppath)
    jback = JaxTrainer(jax_solver(txt, jax_lenet(8, 8)), make_mesh(2),
                       JaxConfig(strategy="local_sgd", tau=2), seed=7)
    jback.restore(ppath)
    back = jax.device_get(jback.state)
    for s in slots:
        for k, blobs in tr.state[0][s].items():
            for i in range(len(blobs)):
                got = torch.stack([st[s][k][i] for st in tr.state]).numpy()
                assert got.tobytes() == np.asarray(back[s][k][i]).tobytes()
