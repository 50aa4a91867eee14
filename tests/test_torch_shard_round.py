"""The port's tensor-sharded round against its replicated round and
against the JAX package's sharded round, on the CPU.

Under ``shard="auto"`` lenet's ``ip1`` weight lives as one tile a
position (``local_sgd`` and ``sync`` over 4 positions, ``hierarchical``
over a host's 2 chips).  Within the port the sharded round is the
replicated one bit for bit (losses and gathered params, exact equality)
for the three strategies and with the int8 exchange.  Against the JAX
trainer on the same weights (the JAX trainer's init written as a
``.caffemodel`` and read by the port) and the same numpy rounds, losses
and params agree within rtol 1e-5, atol 1e-6 over 3 rounds.  The
trainer stamps its ``shard_plan_id`` (the JAX trainer's) on itself, the
blob and the manifest.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh as jax_mesh
from sparknet_tpu.parallel import make_pod_mesh as jax_pod_mesh
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu.proto.caffemodel import save_caffemodel
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import (DistributedTrainer, TrainerConfig,
                                         make_pod_mesh)
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from sparknet_tpu_torch.solvers.solver import load_weights_into
from sparknet_tpu_torch.utils.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

SOLVER_TXT = 'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n'
RTOL, ATOL = 1e-5, 1e-6     # the port's sharded round against the JAX one


def _sp():
    return load_solver_prototxt_with_net(SOLVER_TXT, lenet(16, 16))


def _batch(r, tau=2, gb=16):
    rng = np.random.default_rng(900 + r)
    return {"data": rng.normal(size=(tau, gb, 1, 28, 28)).astype(np.float32),
            "label": rng.integers(0, 10, size=(tau, gb)).astype(np.float32)}


def _layout(strategy):
    return make_pod_mesh(2, 2) if strategy == "hierarchical" else 4


def _host(tr) -> dict:
    return {k: [b.detach().cpu().numpy() for b in v]
            for k, v in tr.params.items()}


def _train(tr, rounds=3):
    return [tr.train_round(_batch(r)) for r in range(rounds)]


@pytest.mark.parametrize("strategy,codec", [
    ("local_sgd", "none"), ("sync", "none"), ("hierarchical", "none"),
    ("local_sgd", "int8"), ("hierarchical", "int8")])
def test_sharded_round_is_the_replicated_round_bit_for_bit(strategy, codec):
    runs = {}
    for shard in ("off", "auto"):
        tr = DistributedTrainer(_sp(), _layout(strategy), TrainerConfig(
            strategy=strategy, tau=2, shard=shard, comm_codec=codec),
            seed=0, device="cpu")
        runs[shard] = (tr, _train(tr))
    dp, sh = runs["off"][0], runs["auto"][0]
    assert dp.shard_plan is None and dp._resident is None
    assert sh.shard_plan is not None
    if strategy == "hierarchical":     # 2 chips: ip2's 10 rows divide
        assert sh.shard_plan.dims_dict() == {"ip1/0": 0, "ip2/0": 0}
    else:
        assert sh.shard_plan.dims_dict() == {"ip1/0": 0}
        assert "ip2/0" in sh.shard_plan.fallbacks   # 10 rows % 4
    assert runs["off"][1] == runs["auto"][1]        # exact
    for k, blobs in _host(dp).items():
        for i, b in enumerate(blobs):
            assert b.tobytes() == _host(sh)[k][i].tobytes(), (k, i)


def test_positions_keep_their_own_tiles():
    """Four positions on a flat layout hold tiles 0-3 of ip1's weight;
    on the 2x2 pod a host's chip c holds tile c, the same tile as the
    other host's chip c.  Their concatenation is the logical leaf."""
    flat = DistributedTrainer(_sp(), 4, TrainerConfig(tau=2, shard="auto"),
                              seed=0, device="cpu")
    pod = DistributedTrainer(_sp(), make_pod_mesh(2, 2), TrainerConfig(
        strategy="hierarchical", tau=2, shard="auto"), seed=0, device="cpu")
    for tr in (flat, pod):
        _train(tr, rounds=1)
    full = flat.params["ip1"][0]
    tiles = [flat._resident[w]["ip1"][0] for w in range(4)]
    assert [tuple(t.shape) for t in tiles] == [(125, 800)] * 4
    assert torch.equal(torch.cat(tiles), full)
    assert all(torch.equal(flat._resident[w]["conv1"][0],
                           flat.params["conv1"][0]) for w in range(4))
    ptiles = [pod._resident[w]["ip1"][0] for w in range(4)]
    assert [tuple(t.shape) for t in ptiles] == [(250, 800)] * 4
    assert torch.equal(ptiles[0], ptiles[2]) and \
        torch.equal(ptiles[1], ptiles[3])
    assert torch.equal(torch.cat(ptiles[:2]), pod.params["ip1"][0])
    assert pod.shard_plan.axis == "chip" and pod.shard_plan.n_shards == 2
    assert flat.shard_plan.axis == "data" and flat.shard_plan.n_shards == 4


@pytest.mark.parametrize("strategy", ["local_sgd", "sync", "hierarchical"])
def test_sharded_round_tracks_the_jax_sharded_round(strategy, tmp_path):
    mesh = jax_pod_mesh(2, 2) if strategy == "hierarchical" \
        else jax_mesh(4)
    jsp = jax_solver(SOLVER_TXT, jax_lenet(16, 16))
    jtr = JaxTrainer(jsp, mesh, JaxConfig(strategy=strategy, tau=2,
                                          shard="auto"), seed=0)
    tr = DistributedTrainer(_sp(), _layout(strategy), TrainerConfig(
        strategy=strategy, tau=2, shard="auto"), seed=0, device="cpu")
    assert tr.shard_plan_id == jtr.shard_plan_id
    assert tr.shard_plan.dims == jtr.shard_plan.dims
    path = str(tmp_path / "init.caffemodel")
    save_caffemodel(path, jax.device_get(jtr.params), jsp.net_param)
    tr.params = load_weights_into(tr.train_net, tr.params, path)
    for r in range(3):
        jloss = jtr.train_round(_batch(r))
        loss = tr.train_round(_batch(r))
        np.testing.assert_allclose(loss, jloss, rtol=RTOL,
                                   err_msg=f"round {r} loss")
        want = jax.device_get(jtr.params)
        for k, blobs in _host(tr).items():
            for i, b in enumerate(blobs):
                np.testing.assert_allclose(
                    b, np.asarray(want[k][i]), rtol=RTOL, atol=ATOL,
                    err_msg=f"round {r} {k}[{i}]")


def test_the_plan_id_rides_the_blob_and_the_manifest(tmp_path):
    tr = DistributedTrainer(_sp(), 4, TrainerConfig(
        tau=2, shard="auto", checkpoint_dir=str(tmp_path),
        async_checkpoint=False), seed=0, device="cpu")
    _train(tr, rounds=1)
    with open(tmp_path / "manifest_00000001.json") as f:
        manifest = json.load(f)
    assert manifest["shard_plan"] == tr.shard_plan_id
    assert "shards" not in manifest           # shard_checkpoint is off
    blob = load_checkpoint(os.path.join(tmp_path, manifest["file"]))
    assert str(blob["shard_plan"]) == tr.shard_plan_id
    # the blob's params are the full logical leaves
    assert tuple(blob["params"]["ip1"][0].shape) == (500, 800)
    dp = DistributedTrainer(_sp(), 4, TrainerConfig(), seed=0, device="cpu")
    assert dp.shard_plan_id == "dp" and "shard_plan" not in dp._host_blob()
