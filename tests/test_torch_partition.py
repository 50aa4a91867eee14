"""The port's partition rule tables, sharded split and join, sharded
exchange bytes and the gang's join against the JAX package's, on the CPU.

``sparknet_tpu_torch/parallel/partition.py`` resolves the same plans as
``sparknet_tpu/parallel/partition.py`` on the same shapes: first match,
scalars, fallbacks, holes, table versions (the cases of JAX
tests/test_partition.py:65-160), with ``plan_id`` equal digit for digit
and the boundary bytes equal, on lenet's and CaffeNet's shapes (243,860,896
bytes a position replicated, 67,995,040 at 4 shards).  ``gather`` and
``take_shard`` move data only: a leaf taken apart and gathered is the
leaf, bit for bit.  ``split_sharded_tree``/``join_sharded_tree`` equal the
JAX functions bit for bit; ``sharded_exchange_bytes`` equals the JAX
function for every codec (exact integers).  The jittered backoff equals
the JAX schedule for the same random draws, and a gang member whose
coordinator never answers fails typed within its timeout.
"""

from __future__ import annotations

import json
import random

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.parallel import comms as j_comms
from sparknet_tpu.parallel import partition as j_part
from sparknet_tpu.utils import checkpoint as j_ckpt
from sparknet_tpu.utils import retry as j_retry
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.models.alexnet import caffenet
from sparknet_tpu_torch.parallel import cluster, comms, partition
from sparknet_tpu_torch.proto.caffe_pb import NetState, Phase
from sparknet_tpu_torch.utils import checkpoint, retry
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _leaves(**shapes):
    return {name: [np.zeros(s, np.float32) for s in blobs]
            for name, blobs in shapes.items()}


def _shapes(net_param) -> dict:
    net = Net(net_param, NetState(Phase.TRAIN))
    return {k: [torch.empty(s, device="meta") for s in v]
            for k, v in net.param_shapes().items()}


def _as_np(tree) -> dict:
    return {k: [np.zeros(tuple(b.shape), np.float32) for b in v]
            for k, v in tree.items()}


RULE_CASES = {
    "first_match": (((r"(^|/)ip1/0$", 0), (r"(^|/)ip", 1), (r".*", None)),
                    dict(ip1=[(8, 4), (8,)], ip2=[(4, 8), (4,)]), 2),
    "scalar": (((r".*", 0),), dict(bn1=[()]), 2),
    "not_divisible": (j_part.DEFAULT_RULES, dict(ip1=[(10, 4)]), 4),
    "holes": (((r"(^|/)ip1/0$", 0),),
              dict(conv1=[(4, 1, 5, 5), (4,)], ip1=[(8, 4)]), 2),
    "zoo_default": (j_part.DEFAULT_RULES,
                    dict(conv1=[(20, 1, 5, 5), (20,)], ip1=[(500, 800),
                                                            (500,)],
                         fc8=[(16, 64), (16,)], classifier=[(8, 4)]), 4),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_matching_equals_jax(case):
    rules, shapes, n = RULE_CASES[case]
    leaves = _leaves(**shapes)
    ours = partition.match_partition_rules(rules, leaves, n)
    theirs = j_part.match_partition_rules(rules, leaves, n)
    assert ours == theirs
    # tensors resolve as arrays do: only the shape is read
    as_tensors = {k: [torch.zeros(s) for s in v] for k, v in shapes.items()}
    assert partition.match_partition_rules(rules, as_tensors, n) == ours


def test_defaults_and_versions_are_the_jax_packages():
    assert partition.DEFAULT_RULES == j_part.DEFAULT_RULES
    assert partition.RULE_TABLE_VERSION == j_part.RULE_TABLE_VERSION


@pytest.mark.parametrize("mode", ["", "off", "dp", "0", "auto"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_resolve_plan_and_plan_id_equal_jax(mode, n):
    leaves = _leaves(ip1=[(8, 4), (8,)], conv1=[(4, 1, 5, 5)])
    ours = partition.resolve_plan(mode, leaves, axis="data", n_shards=n)
    theirs = j_part.resolve_plan(mode, leaves, axis="data", n_shards=n)
    assert (ours is None) == (theirs is None)
    assert partition.shard_plan_id(ours) == j_part.shard_plan_id(theirs)
    if ours is not None:
        assert ours.dims == theirs.dims
        assert ours.fallbacks == theirs.fallbacks
        assert ours.table_id == theirs.table_id


def test_json_tables_holes_and_versions_as_jax(tmp_path):
    leaves = _leaves(ip1=[(8, 4)], conv1=[(4, 1, 5, 5)])
    good = tmp_path / "t.json"
    good.write_text(json.dumps({"version": 1, "rules": [
        {"pattern": r"(^|/)ip[^/]*/0$", "dim": 0},
        {"pattern": ".*", "dim": None}]}))
    ours = partition.resolve_plan(str(good), leaves, axis="chip",
                                  n_shards=4)
    theirs = j_part.resolve_plan(str(good), leaves, axis="chip", n_shards=4)
    assert ours.plan_id() == theirs.plan_id()
    assert ours.table_id == theirs.table_id
    assert partition.load_rule_table(str(good)) == \
        j_part.load_rule_table(str(good))
    holey = tmp_path / "holey.json"
    holey.write_text(json.dumps(
        {"version": 1, "rules": [{"pattern": r"(^|/)ip1/0$", "dim": 0}]}))
    for mod in (partition, j_part):
        with pytest.raises(ValueError, match="conv1/0"):
            mod.resolve_plan(str(holey), leaves, axis="data", n_shards=4)
    future = tmp_path / "v2.json"
    future.write_text(json.dumps({"version": 2, "rules": [
        {"pattern": ".*", "dim": None}]}))
    for mod in (partition, j_part):
        with pytest.raises(ValueError, match="version 2"):
            mod.load_rule_table(str(future))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "rules": [
        {"pattern": "(unclosed", "dim": None}]}))
    with pytest.raises(Exception):
        partition.load_rule_table(str(bad))


@pytest.mark.parametrize("model,n,dp_bytes,sharded_bytes", [
    ("lenet", 4, 1_724_320, 524_320),
    ("caffenet", 4, 243_860_896, 67_995_040),
    ("caffenet", 8, 243_860_896, 38_684_064)])
def test_boundary_bytes_and_plan_id_equal_jax(model, n, dp_bytes,
                                              sharded_bytes):
    ours_shapes = _shapes(lenet(16, 16) if model == "lenet"
                          else caffenet(8, 8))
    theirs_shapes = _as_np(ours_shapes)
    ours = partition.resolve_plan("auto", ours_shapes, axis="data",
                                  n_shards=n)
    theirs = j_part.resolve_plan("auto", theirs_shapes, axis="data",
                                 n_shards=n)
    assert ours.plan_id() == theirs.plan_id()
    assert partition.boundary_bytes_per_chip(ours_shapes, None) == \
        j_part.boundary_bytes_per_chip(theirs_shapes, None) == dp_bytes
    assert partition.boundary_bytes_per_chip(ours_shapes, ours) == \
        j_part.boundary_bytes_per_chip(theirs_shapes, theirs) == \
        sharded_bytes


def test_spec_tree_gather_and_take_shard_move_data_only():
    gen = torch.Generator().manual_seed(3)
    params = {"conv1": [torch.randn(4, 1, 5, 5, generator=gen),
                        torch.randn(4, generator=gen)],
              "ip1": [torch.randn(8, 6, generator=gen),
                      torch.randn(8, generator=gen)]}
    plan = partition.resolve_plan("auto", params, axis="chip", n_shards=4)
    assert plan.spec_tree(params) == {"conv1": [(), ()],
                                      "ip1": [("chip",), ()]}
    tiles = [plan.take_shard(params, i) for i in range(4)]
    assert tiles[1]["ip1"][0].shape == (2, 6)
    assert tiles[1]["conv1"][0] is params["conv1"][0]
    back = plan.gather(tiles[2], tiles)
    for k, blobs in params.items():
        for i, b in enumerate(blobs):
            assert torch.equal(back[k][i], b)
    # dim 1 too: the columns of the leaf, in position order
    col = partition.ShardPlan(axis="data", n_shards=3, table_id="t",
                              dims=(("ip1/0", 1),))
    parts = [col.take_shard(params, i) for i in range(3)]
    assert torch.equal(col.gather(parts[0], parts)["ip1"][0],
                       params["ip1"][0])


def test_split_and_join_equal_jax_bit_for_bit(tmp_path):
    rng = np.random.default_rng(7)
    params = {"conv1": [rng.normal(size=(4, 1, 5, 5)).astype(np.float32),
                        rng.normal(size=(4,)).astype(np.float32)],
              "ip1": [rng.normal(size=(8, 6)).astype(np.float32),
                      rng.normal(size=(8,)).astype(np.float32)],
              "ip2": [rng.normal(size=(6, 8)).astype(np.float32)]}
    dims = {"ip1/0": 0, "ip2/0": 1}
    common, parts = checkpoint.split_sharded_tree(params, dims, 2)
    jcommon, jparts = j_ckpt.split_sharded_tree(params, dims, 2)
    assert jax.tree_util.tree_structure(common) == \
        jax.tree_util.tree_structure(jcommon)
    for a, b in zip(jax.tree_util.tree_leaves((common, parts)),
                    jax.tree_util.tree_leaves((jcommon, jparts))):
        assert a.tobytes() == b.tobytes() and a.shape == b.shape
    # the port's split takes tensors too; each package joins the other's
    tensors = {k: [torch.from_numpy(b) for b in v] for k, v in params.items()}
    tcommon, tparts = checkpoint.split_sharded_tree(tensors, dims, 2)
    for joined in (checkpoint.join_sharded_tree(jcommon, jparts, dims),
                   j_ckpt.join_sharded_tree(tcommon, tparts, dims),
                   checkpoint.join_sharded_tree(common, parts, dims)):
        for k, blobs in params.items():
            for i, b in enumerate(blobs):
                assert joined[k][i].tobytes() == b.tobytes()
    # tiles written at 2 shards join at any world: the files round-trip
    checkpoint.save_checkpoint(str(tmp_path / "c.npz"), common)
    for i, part in enumerate(parts):
        checkpoint.save_checkpoint(str(tmp_path / f"s{i}.npz"), part)
    loaded = j_ckpt.join_sharded_tree(
        j_ckpt.load_checkpoint(str(tmp_path / "c.npz")),
        [j_ckpt.load_checkpoint(str(tmp_path / f"s{i}.npz"))
         for i in range(2)], dims)
    assert loaded["ip2"][0].tobytes() == params["ip2"][0].tobytes()
    with pytest.raises(checkpoint.CheckpointError, match="not divisible"):
        checkpoint.split_sharded_tree(params, {"ip1/0": 0}, 3)
    with pytest.raises(checkpoint.CheckpointError, match="shard_dims"):
        checkpoint.join_sharded_tree(common, parts, {})


@pytest.mark.parametrize("codec", ["none", "bf16", "int8", "int8_channel"])
@pytest.mark.parametrize("n_tier", [2, 4])
def test_sharded_exchange_bytes_equal_jax(codec, n_tier):
    shapes = _shapes(lenet(16, 16))
    plan = partition.resolve_plan("auto", shapes, axis="data", n_shards=4)
    jplan = j_part.resolve_plan("auto", _as_np(shapes), axis="data",
                                n_shards=4)
    ours = comms.sharded_exchange_bytes(comms.get_codec(codec), shapes,
                                        n_tier, plan)
    theirs = j_comms.sharded_exchange_bytes(j_comms.get_codec(codec),
                                            _as_np(shapes), n_tier, jplan)
    assert ours == theirs
    assert comms.sharded_exchange_bytes(comms.get_codec(codec), shapes,
                                        n_tier, None) == \
        comms.exchange_bytes(comms.get_codec(codec), shapes, n_tier)
    if codec == "none":
        assert ours < comms.exchange_bytes(comms.get_codec(codec), shapes,
                                           n_tier)


@pytest.mark.parametrize("jitter", [0.0, 0.25, 0.5])
def test_jittered_backoff_equals_jax(jitter):
    ours = list(retry.backoff_delays(5, 0.5, jitter=jitter,
                                     rng=random.Random(11)))
    theirs = list(j_retry.backoff_delays(5, 0.5, jitter=jitter,
                                         rng=random.Random(11)))
    assert ours == theirs and len(ours) == 4
    with pytest.raises(ValueError, match="jitter"):
        list(retry.backoff_delays(3, 0.5, jitter=1.0))


def test_a_join_nobody_answers_fails_typed_and_fast(monkeypatch):
    import time
    monkeypatch.setenv("SPARKNET_CONNECT_RETRIES", "2")
    monkeypatch.setenv("SPARKNET_CONNECT_BACKOFF", "0.05")
    t0 = time.monotonic()
    with pytest.raises(cluster.ClusterConnectError,
                       match="after 2 attempt"):
        cluster.init_cluster("127.0.0.1:1", 2, 1, timeout_s=1.0)
    assert time.monotonic() - t0 < 30
    # alone, nothing is joined and the world is this process
    cluster.init_cluster("127.0.0.1:1", 1, 0)
    assert (cluster.process_count(), cluster.process_index()) == (1, 0)
    assert cluster.local_batch_slice(16) == slice(0, 16)
    assert cluster.all_gather_objects(3) == [3]
    assert cluster.global_max(5) == 5
    t = [torch.arange(3)]
    assert cluster.all_gather_tensors(t)[0][0] is t[0]
    cluster.barrier()
    cluster.shutdown_cluster()
