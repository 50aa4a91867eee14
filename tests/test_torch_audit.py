"""The port's cross-replica audit against the JAX package's, on the CPU.

Fingerprints: on the same weights (the JAX trainer's init moved through
a ``.caffemodel``) the port's ``audit_params()`` equals the JAX trainer's
exactly, uint32 for uint32: ``[n]`` without a plan, ``[n, 2]`` under one,
healthy and with bit 22 of one position's first f32 leaf flipped in both
(``_inject_bitflip``), with the same culprits.  A leaf's sum is its
uint32 bit patterns summed mod 2**32 (checked against numpy on values
with the top bit set, -0.0 and integers).  A planted flip is caught and
rolled back as JAX tests/test_integrity.py:597-690 ask: ``local_sgd``
with ``audit_every=1`` drops exactly one round and finishes bit for bit
the fault-free run; ``sync`` with ``audit_every=2`` catches a flip of
round 3 at round 4 and rolls back to round 2; the lagged audit trips at
harvest; no checkpoint to roll back to raises.  The config checks carry
the JAX package's messages.  Exact equality everywhere: no tolerance.
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
from sparknet_tpu.parallel import make_mesh as jax_mesh
from sparknet_tpu.parallel import make_pod_mesh as jax_pod_mesh
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu.proto.caffemodel import save_caffemodel
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import (DistributedTrainer, TrainerConfig,
                                         TrainingDivergedError,
                                         make_pod_mesh)
from sparknet_tpu_torch.parallel.trainer import _leaf_bits
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from sparknet_tpu_torch.solvers.solver import load_weights_into
from sparknet_tpu_torch.utils import faults, telemetry
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _txt(lr=0.05):
    return f'base_lr: {lr}\nmomentum: 0.9\nlr_policy: "fixed"\n'


def _batch(r):
    rng = np.random.default_rng(100 + r)
    return {"data": rng.normal(size=(2, 16, 1, 28, 28)).astype(np.float32),
            "label": rng.integers(0, 10, size=(2, 16)).astype(np.float32)}


def _trainer(ckpt_dir, strategy="local_sgd", lr=0.05, layout=4, **kw):
    sp = load_solver_prototxt_with_net(_txt(lr), lenet(16, 16))
    cfg = TrainerConfig(strategy=strategy, tau=2,
                        checkpoint_dir=str(ckpt_dir) if ckpt_dir else None,
                        **kw)
    return DistributedTrainer(sp, layout, cfg, seed=0, device="cpu")


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch):
    monkeypatch.delenv("SPARKNET_FAULT", raising=False)
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    faults.reset_injector()
    yield
    faults.reset_injector()


def test_leaf_sums_are_uint32_bit_patterns_mod_2_32():
    f = np.array([-0.0, 1.5, -2.25, 3e38, -1e-40, np.inf], np.float32)
    want = int(f.view(np.uint32).astype(np.uint64).sum()) % 2**32
    assert int(_leaf_bits(torch.from_numpy(f))) % 2**32 == want
    i = np.array([-1, 7, -2**31], np.int32)
    want = int(i.astype(np.uint32).astype(np.uint64).sum()) % 2**32
    assert int(_leaf_bits(torch.from_numpy(i))) % 2**32 == want
    d = torch.tensor([0.1, -0.7], dtype=torch.float64)   # cast to f32
    want = int(d.float().numpy().view(np.uint32).astype(np.uint64).sum())
    assert int(_leaf_bits(d)) == want
    assert _leaf_bits(torch.tensor([True])) is None


@pytest.mark.parametrize("strategy,shard", [
    ("local_sgd", "off"), ("local_sgd", "auto"), ("hierarchical", "auto")])
def test_fingerprints_and_culprits_equal_jax(strategy, shard, tmp_path):
    pod = strategy == "hierarchical"
    jsp = jax_solver(_txt(), jax_lenet(16, 16))
    jtr = JaxTrainer(jsp, jax_pod_mesh(2, 2) if pod else jax_mesh(4),
                     JaxConfig(strategy=strategy, tau=2, shard=shard,
                               audit_every=1,
                               checkpoint_dir=str(tmp_path / "j")), seed=0)
    tr = _trainer(tmp_path / "p", strategy, shard=shard, audit_every=1,
                  layout=make_pod_mesh(2, 2) if pod else 4)
    path = str(tmp_path / "w.caffemodel")
    save_caffemodel(path, jax.device_get(jtr.params), jsp.net_param)
    tr.params = load_weights_into(tr.train_net, tr.params, path)
    theirs = np.asarray(jtr.audit_params())
    ours = tr.audit_params()
    assert ours.dtype == np.uint32
    assert ours.shape == theirs.shape == ((4,) if shard == "off" else (4, 2))
    assert np.array_equal(ours, theirs)
    assert tr._audit_ok(ours)
    # position 3: a replicated leaf without a plan, and on the pod the
    # host-1 copy of chip 1's tile
    jtr._inject_bitflip(3)
    tr._inject_bitflip(3)
    theirs, ours = np.asarray(jtr.audit_params()), tr.audit_params()
    assert np.array_equal(ours, theirs)
    assert tr._audit_culprits(ours) == jtr._audit_culprits(theirs) == [3]
    assert tr._audit_groups() == jtr._audit_groups()
    # the flip is finite: the numerical guard cannot see it
    assert bool(tr._finite(tr.params))


def test_bitflip_audit_acceptance_bit_for_bit(tmp_path, monkeypatch):
    """bitflip_params@rank:1@round:3 with audit_every=1 is caught at round
    3, before the average folds it in, rolled back with its generators
    replayed, and the run finishes bit for bit the fault-free run."""
    clean = _trainer(tmp_path / "clean", audit_every=1)
    while clean.round < 4:
        clean.train_round(_batch(clean.round))
    assert clean.audit_trips == 0
    monkeypatch.setenv("SPARKNET_FAULT", "bitflip_params@rank:1@round:3")
    faults.reset_injector()
    trips = telemetry.get_registry().counter(
        "trainer_audit_trips_total", "cross-replica audit rollbacks")
    before = trips.value()
    tr = _trainer(tmp_path / "chaos", audit_every=1)
    losses = []
    while tr.round < 4:
        losses.append(tr.train_round(_batch(tr.round)))
    assert tr.audit_trips == 1 and tr.guard_trips == 1
    assert sum(1 for v in losses if not np.isfinite(v)) == 1
    assert tr.stall_s["audit_fetch"] > 0
    for name in tr.params:
        for a, b in zip(tr.params[name], clean.params[name]):
            assert torch.equal(a, b), name
    events = [e for e in telemetry.get_recorder().tail()
              if e.get("kind") == "audit_mismatch"]
    assert events[-1]["culprits"] == [1] and events[-1]["round"] == 3
    assert trips.value() == before + 1


def test_bitflip_detected_within_audit_interval_sync(tmp_path, monkeypatch):
    """sync keeps a rotted copy resident: a flip at round 3 is caught by
    the round-4 audit and rolled back to round 2, the last audit that
    passed; the run finishes bit for bit the fault-free one."""
    clean = _trainer(tmp_path / "clean", "sync", lr=0.005, audit_every=2)
    while clean.round < 6:
        clean.train_round(_batch(clean.round))
    monkeypatch.setenv("SPARKNET_FAULT", "bitflip_params@rank:2@round:3")
    faults.reset_injector()
    tr = _trainer(tmp_path / "chaos", "sync", lr=0.005, audit_every=2)
    rolled_back_to = []
    while tr.round < 6:
        before = tr.round
        tr.train_round(_batch(tr.round))
        if tr.round < before:
            rolled_back_to.append(tr.round)
    assert tr.audit_trips == 1
    assert rolled_back_to == [2]
    for name in tr.params:
        for a, b in zip(tr.params[name], clean.params[name]):
            assert torch.equal(a, b), name


def test_lagged_audit_trips_at_harvest(tmp_path, monkeypatch):
    clean = _trainer(tmp_path / "clean", audit_every=1, harvest_lag=1,
                     checkpoint_keep=4)
    while True:
        while clean.round < 4:
            clean.train_round(_batch(clean.round))
        clean.drain()
        if clean.round >= 4:
            break
    monkeypatch.setenv("SPARKNET_FAULT", "bitflip_params@rank:2@round:2")
    faults.reset_injector()
    tr = _trainer(tmp_path / "chaos", audit_every=1, harvest_lag=1,
                  checkpoint_keep=4)
    while True:
        while tr.round < 4:
            tr.train_round(_batch(tr.round))
        tr.drain()
        if tr.round >= 4:
            break
    assert tr.audit_trips == 1
    for name in tr.params:
        for a, b in zip(tr.params[name], clean.params[name]):
            assert torch.equal(a, b), name


def test_audit_trip_without_rollback_target_raises(tmp_path):
    tr = _trainer(tmp_path / "ck", audit_every=1)
    tr.train_round(_batch(0))
    for f in os.listdir(tmp_path / "ck"):
        os.remove(tmp_path / "ck" / f)
    tr._inject_bitflip(1)
    with pytest.raises(TrainingDivergedError, match="no\\s+checkpoint"):
        tr.train_round(_batch(tr.round))


@pytest.mark.parametrize("kw,match", [
    (dict(audit_every=1, ckpt=False), "audit_every needs"),
    (dict(audit_every=5, checkpoint_keep=2), "outruns the checkpoint"),
    (dict(audit_every=-1), "audit_every must be >= 0"),
    (dict(audit_every=2, harvest_lag=2, checkpoint_keep=3),
     "harvest_lag=2 outruns")])
def test_config_checks_carry_the_jax_messages(tmp_path, kw, match):
    kw = dict(kw)
    ckpt = kw.pop("ckpt", True)
    for make in (
            lambda: _trainer(tmp_path / "p" if ckpt else None, **kw),
            lambda: JaxTrainer(jax_solver(_txt(), jax_lenet(16, 16)),
                               jax_mesh(4), JaxConfig(
                                   tau=2, checkpoint_dir=str(tmp_path / "j")
                                   if ckpt else None, **kw), seed=0)):
        with pytest.raises(ValueError, match=match):
            make()


def test_a_healthy_audit_writes_a_baseline_and_counts_nothing(tmp_path):
    tr = _trainer(tmp_path / "ck", audit_every=1)
    assert tr._resident is not None
    tr.flush_checkpoints()     # the baseline rides the async writer
    assert os.path.exists(tmp_path / "ck" / "manifest_00000000.json")
    for _ in range(2):
        tr.train_round(_batch(tr.round))
    assert tr.audit_trips == 0 and tr._last_audit_ok == 1
    assert tr._beat_extras()["audit_trips"] == 0
