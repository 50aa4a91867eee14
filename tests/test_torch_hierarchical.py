"""The port's ``hierarchical`` strategy against the JAX trainer's, on the
CPU.

The JAX trainer runs on ``make_pod_mesh(2, 2)`` over conftest's virtual
CPU devices; the port on ``make_pod_mesh(2, 2)``, four logical workers
on the CPU, from the same weights (``convert.params_from_jax``) on the
same numpy rounds.  Per step each host averages its two chips'
gradients and losses and updates with its own solver state; at the τ
boundary the params are averaged over the hosts.  Round losses and
params agree at tests/test_torch_trainer.py's rtol 2e-4, atol 2e-5, on
lenet and on the narrow CaffeNet (Dropout 0, so the training path's LRN
and MAX-pool backward run in their plain versions), and with
``iter_size`` 2.  The solver state is stacked on hosts, not workers.
Within the port, 1 host x 2 chips is ``sync`` and 2 hosts x 1 chip is
``local_sgd``, bit for bit.  ``caffe_cli train --devices 4 --strategy
hierarchical --hosts 2`` matches the JAX CLI's losses and test outputs
within 1e-4 relative (tests/test_torch_caffe_cli.py's bound).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_pod_mesh as jax_pod_mesh
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu.tools import caffe_cli as jax_cli
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import (DistributedTrainer, TrainerConfig,
                                         make_mesh, make_pod_mesh)
from sparknet_tpu_torch.proto import (load_net_prototxt,
                                      load_solver_prototxt_with_net)
from sparknet_tpu_torch.tools import caffe_cli
from test_torch_caffe_cli import (_assert_same_numbers, _numbers, _run,
                                  _solver, tool)  # noqa: F401 (fixture)
from test_torch_trainer import (CAFFENET_SOLVER, NARROW_NO_DROPOUT,
                                SOLVER_TXT, _assert_params_close,
                                _lenet_rounds, _narrow_rounds, _train_both)
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _pair(jax_sp, sp, tau, hosts=2, chips=2):
    jtr = JaxTrainer(jax_sp, jax_pod_mesh(hosts, chips),
                     JaxConfig(strategy="hierarchical", tau=tau), seed=0)
    tr = DistributedTrainer(sp, make_pod_mesh(hosts, chips),
                            TrainerConfig(strategy="hierarchical", tau=tau),
                            seed=0, device="cpu")
    tr.params = params_from_jax(jax.device_get(jtr.params), tr.train_net,
                                device="cpu")
    return jtr, tr


def _assert_state_close(tr, jtr):
    """Per-host momentum history against the JAX trainer's stacked
    per-host state, row for row."""
    want = jax.device_get(jtr.state)["history"]
    assert len(tr.state) == tr.n_hosts
    for k, blobs in want.items():
        for i, b in enumerate(blobs):
            b = np.asarray(b)
            assert b.shape[0] == tr.n_hosts
            for h in range(tr.n_hosts):
                np.testing.assert_allclose(
                    tr.state[h]["history"][k][i].numpy(), b[h], rtol=2e-4,
                    atol=2e-5, err_msg=f"host {h} {k}[{i}]")


def test_hierarchical_lenet_tracks_jax():
    jtr, tr = _pair(jax_solver(SOLVER_TXT, jax_lenet(4, 4)),
                    load_solver_prototxt_with_net(SOLVER_TXT, lenet(4, 4)),
                    tau=2)
    assert (tr.n_hosts, tr.n_chips, tr.n_workers) == (2, 2, 4)
    first = tr.params["conv1"][0].clone()
    _train_both(jtr, tr, _lenet_rounds(10, rounds=3, steps=2,
                                       global_batch=16))
    assert tr.iter == jtr.iter == 6
    assert not torch.equal(first, tr.params["conv1"][0])
    _assert_state_close(tr, jtr)


def test_hierarchical_narrow_caffenet_tracks_jax():
    """The narrow CaffeNet (Dropout 0) with CaffeNet's solver: B1, B3 and
    B5's plain versions on the hierarchical path."""
    jtr, tr = _pair(
        jax_solver(CAFFENET_SOLVER, jax_load_net(NARROW_NO_DROPOUT)),
        load_solver_prototxt_with_net(CAFFENET_SOLVER,
                                      load_net_prototxt(NARROW_NO_DROPOUT)),
        tau=2)
    loss = _train_both(jtr, tr, _narrow_rounds(11, rounds=2, steps=2,
                                               global_batch=4))
    assert np.isfinite(loss)
    _assert_state_close(tr, jtr)


def test_hierarchical_iter_size_2_tracks_jax():
    txt = SOLVER_TXT + "iter_size: 2\nweight_decay: 0.001\n"
    jtr, tr = _pair(jax_solver(txt, jax_lenet(2, 2)),
                    load_solver_prototxt_with_net(txt, lenet(2, 2)), tau=2)
    assert tr.batches_per_round == jtr.batches_per_round == 4
    _train_both(jtr, tr, _lenet_rounds(12, rounds=2, steps=4,
                                       global_batch=8))


def test_state_is_stacked_on_hosts_in_the_checkpoint_blob(tmp_path):
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(4, 4))
    tr = DistributedTrainer(sp, make_pod_mesh(2, 3),
                            TrainerConfig(strategy="hierarchical", tau=1),
                            device="cpu")
    (batches,) = _lenet_rounds(13, rounds=1, steps=1, global_batch=24)
    tr.train_round(batches)
    assert len(tr.state) == 2 and tr.worker_params == []
    # the two hosts saw other rows, so their momentum differs
    assert not torch.equal(tr.state[0]["history"]["conv1"][0],
                           tr.state[1]["history"]["conv1"][0])
    blob = tr._host_blob()
    assert blob["n_hosts"] == 2 and blob["n_workers"] == 6
    assert blob["state"]["history"]["conv1"][0].shape[0] == 2
    tr.snapshot(str(tmp_path / "h.npz"))
    back = DistributedTrainer(sp, make_pod_mesh(2, 3),
                              TrainerConfig(strategy="hierarchical", tau=1),
                              seed=5, device="cpu")
    back.restore(str(tmp_path / "h.npz"))
    for h in range(2):
        assert torch.equal(back.state[h]["history"]["ip2"][0],
                           tr.state[h]["history"]["ip2"][0])


@pytest.mark.parametrize("hosts,chips,flat", [(1, 2, "sync"),
                                              (2, 1, "local_sgd")])
def test_hierarchical_collapses_to_the_flat_strategies(hosts, chips, flat):
    """One host is ``sync`` over its chips; one chip per host is
    ``local_sgd`` over hosts: params and losses bit for bit."""
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(4, 4))
    h = DistributedTrainer(sp, make_pod_mesh(hosts, chips),
                           TrainerConfig(strategy="hierarchical", tau=2),
                           device="cpu")
    f = DistributedTrainer(sp, make_mesh(hosts * chips),
                           TrainerConfig(strategy=flat, tau=2),
                           device="cpu")
    for batches in _lenet_rounds(14, rounds=2, steps=2, global_batch=8):
        assert h.train_round(batches) == f.train_round(batches)
    for k, blobs in h.params.items():
        for i, b in enumerate(blobs):
            assert torch.equal(b, f.params[k][i]), f"{k}[{i}]"


def test_layouts_must_fit_the_strategy():
    sp = load_solver_prototxt_with_net(SOLVER_TXT, lenet(4, 4))
    with pytest.raises(ValueError, match="make_pod_mesh"):
        DistributedTrainer(sp, make_mesh(4),
                           TrainerConfig(strategy="hierarchical"),
                           device="cpu")
    with pytest.raises(ValueError, match="flat layout"):
        DistributedTrainer(sp, make_pod_mesh(2, 2), TrainerConfig(),
                           device="cpu")
    with pytest.raises(ValueError, match="n_hosts"):
        make_pod_mesh(0, 2)
    assert make_pod_mesh(2, 3).shape == {"host": 2, "chip": 3}
    assert make_mesh(3).shape == {"data": 3, "model": 1}


def test_caffe_cli_hierarchical_matches_the_jax_cli(tool, capsys):
    d, model, _ = tool
    args = ["--devices", "4", "--strategy", "hierarchical", "--hosts", "2",
            "--tau", "2", "--weights", str(d / "init.caffemodel")]
    kw = dict(max_iter=4, display=1, test_interval=2, snapshot=0)
    ours = _run(capsys, caffe_cli.main,
                ["train", "--solver", _solver(d, model, "hier", **kw)]
                + args + ["--device", "cpu"])
    theirs = _run(capsys, jax_cli.main,
                  ["train", "--solver", _solver(d, model, "jhier", **kw)]
                  + args)
    assert "2x2 pod" in ours and "strategy=hierarchical" in ours
    _assert_same_numbers(ours, theirs)
    assert [i for i, _ in _numbers(ours)["loss"]] == [2, 4]
