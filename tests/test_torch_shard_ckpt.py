"""Sharded round checkpoints across the two packages, on the CPU.

With ``shard="auto"`` and ``shard_checkpoint=True`` each package writes
``ckpt_round_%08d.npz`` (the common leaves and the rest of the state),
one ``ckpt_round_%08d.shardNN.npz`` tile a shard and a manifest naming
every file's sha256, ``shard_dims`` and ``shard_plan``, the same names and
fields.  A checkpoint written by either package resumes in the other with
params and solver state bit for bit (exact equality).  A tile with one
byte changed fails its checkpoint and resume takes the one before; tiles
written at world 4 re-tile onto world 2 bit for bit (``elastic``); pruning
and the lag's drop sweep the tiles with their checkpoint.
"""

from __future__ import annotations

import glob
import json
import os

import jax
import numpy as np
import pytest

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh as jax_mesh
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import DistributedTrainer, TrainerConfig
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

TXT = 'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n'


@pytest.fixture(autouse=True)
def _sync_writes(monkeypatch):
    monkeypatch.setenv("SPARKNET_ASYNC_CKPT", "0")
    monkeypatch.delenv("SPARKNET_FENCE_TOKEN", raising=False)


def _batch(r):
    rng = np.random.default_rng(300 + r)
    return {"data": rng.normal(size=(2, 16, 1, 28, 28)).astype(np.float32),
            "label": rng.integers(0, 10, size=(2, 16)).astype(np.float32)}


def _cfg(d, **kw):
    return dict(strategy="local_sgd", tau=2, shard="auto",
                shard_checkpoint=True, checkpoint_dir=str(d), **kw)


def _port(d, workers=4, **kw):
    return DistributedTrainer(
        load_solver_prototxt_with_net(TXT, lenet(16, 16)), workers,
        TrainerConfig(**_cfg(d, **kw)), seed=0, device="cpu")


def _jax(d, **kw):
    return JaxTrainer(jax_solver(TXT, jax_lenet(16, 16)), jax_mesh(4),
                      JaxConfig(**_cfg(d, **kw)), seed=0)


def _np(tree) -> dict:
    return {k: [np.asarray(b.detach().cpu().numpy() if hasattr(b, "detach")
                           else b) for b in v] for k, v in tree.items()}


def _assert_bits(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert x.shape == y.shape and x.tobytes() == y.tobytes(), k


def _files(d) -> list[str]:
    return sorted(os.path.basename(p) for p in glob.glob(str(d / "*")))


def _manifest(d, r) -> dict:
    with open(d / f"manifest_{r:08d}.json") as f:
        return json.load(f)


def test_the_packages_write_the_same_files_and_fields(tmp_path):
    jd, pd = tmp_path / "j", tmp_path / "p"
    jtr, tr = _jax(jd), _port(pd)
    for r in range(2):
        jtr.train_round(_batch(r))
        tr.train_round(_batch(r))
    jtr.drain()
    assert _files(jd) == _files(pd)
    assert "ckpt_round_00000002.shard03.npz" in _files(pd)
    jm, pm = _manifest(jd, 2), _manifest(pd, 2)
    assert set(jm) == set(pm)
    for key in ("round", "iter", "file", "mesh_shape", "strategy",
                "n_workers", "tau", "shard_plan", "shard_dims"):
        assert jm[key] == pm[key], key
    assert [s["file"] for s in jm["shards"]] == \
        [s["file"] for s in pm["shards"]]
    assert pm["shard_plan"] == tr.shard_plan_id == jtr.shard_plan_id


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_resumes_the_others_tiles(tmp_path, writer):
    d = tmp_path / "ck"
    first = _jax(d) if writer == "jax" else _port(d)
    for r in range(2):
        first.train_round(_batch(r))
    if writer == "jax":
        first.drain()
    want = _np(jax.device_get(first.params) if writer == "jax"
               else first.params)
    second = _port(d) if writer == "jax" else _jax(d)
    assert second.round == 2 and second.iter == 4
    got = _np(jax.device_get(second.params) if writer == "port"
              else second.params)
    _assert_bits(got, want)
    # the per-worker momentum rows too
    if writer == "jax":
        jstate = jax.device_get(first.state)["history"]
        for w in range(4):
            for k, blobs in second.state[w]["history"].items():
                for i, b in enumerate(blobs):
                    assert b.numpy().tobytes() == \
                        np.asarray(jstate[k][i])[w].tobytes(), (w, k, i)


def test_a_changed_tile_fails_its_checkpoint(tmp_path, capsys):
    d = tmp_path / "ck"
    tr = _port(d, checkpoint_keep=4)
    for r in range(2):
        tr.train_round(_batch(r))
    tile = d / "ckpt_round_00000002.shard01.npz"
    raw = bytearray(tile.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    tile.write_bytes(bytes(raw))
    back = _port(d, checkpoint_keep=4)
    assert back.resumed["round"] == 1
    assert "shard sha256 mismatch" in capsys.readouterr().err
    # and the JAX package refuses it the same way
    assert _jax(d, checkpoint_keep=4).round == 1


def test_tiles_of_world_4_retile_onto_world_2(tmp_path):
    d = tmp_path / "ck"
    tr = _port(d, elastic=True)
    for r in range(2):
        tr.train_round(_batch(r))
    half = _port(d, workers=2, elastic=True)
    assert half.round == 2
    _assert_bits(_np(half.params), _np(tr.params))
    assert half.shard_plan.n_shards == 2
    assert tuple(half._resident[1]["ip1"][0].shape) == (250, 800)
    loss = half.train_round(_batch(2))
    assert np.isfinite(loss)


def test_pruning_and_the_lags_drop_sweep_the_tiles(tmp_path):
    d = tmp_path / "ck"
    tr = _port(d, checkpoint_keep=2)
    for r in range(4):
        tr.train_round(_batch(r))
    assert {f.split(".")[0] for f in _files(d)} == {
        "ckpt_round_00000003", "ckpt_round_00000004", "manifest_00000003",
        "manifest_00000004"}
    assert len([f for f in _files(d) if ".shard" in f]) == 8
    tr._drop_checkpoints_after(3)
    assert not [f for f in _files(d) if "00000004" in f]
