"""Round checkpoints, resume, elastic re-forming, the numerical guard,
the harvest lag and the asynchronous writer in the port, on the CPU.

The recipes are the JAX package's (tests/test_resilience.py:473-543,
:826-1059, :1113-1200; tests/test_comms.py:322-400), run on the port:
lenet, 4 workers (or 3, 2 after an elastic re-form), τ=2, 16 rows a
round.  Where the JAX test passes as an oracle, the JAX trainer runs the
same recipe and the port is held against it (the files it keeps, the
round it resumes, the rows it re-tiers).  Two JAX tests are no oracle
here (ROADMAP C): ``test_nan_inject_rolls_back_and_matches_fault_free``
(its fault-free run at base_lr 0.05 itself goes NaN at round 3, so the
port's version runs at 0.005) and the stall-key assertion of
``test_async_pipelined_loop_matches_sync_bit_for_bit`` (it predates the
``comm_*`` keys).  Round checkpoints cross between the packages both
ways: params, state, residuals, ``iter``, ``round`` and ``lr_scale``
bit for bit.  Every equality here is exact.
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
from sparknet_tpu.utils import faults as jfaults
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import (DistributedTrainer, TrainerConfig,
                                         TrainingDivergedError, make_mesh,
                                         make_pod_mesh)
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from sparknet_tpu_torch.utils import checkpoint as ckpt
from sparknet_tpu_torch.utils import faults
from sparknet_tpu_torch.utils.checkpoint import load_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for k in ("SPARKNET_FAULT", "SPARKNET_FAULT_ATTEMPT",
              "SPARKNET_ASYNC_CKPT", "SPARKNET_FENCE_TOKEN"):
        monkeypatch.delenv(k, raising=False)
    faults.reset_injector()
    jfaults.reset_injector()
    yield
    faults.reset_injector()
    jfaults.reset_injector()


def _solver_txt(lr):
    return f'base_lr: {lr}\nmomentum: 0.9\nlr_policy: "fixed"\n'


def _layout(strategy, workers):
    return make_pod_mesh(2, workers // 2) if strategy == "hierarchical" \
        else make_mesh(workers)


def _make(ckpt_dir, seed=0, every=1, keep=3, *, strategy="local_sgd",
          batch=16, workers=4, lr=0.05, **cfg_kw):
    """tests/test_resilience.py's ``_make_trainer``, on the port."""
    sp = load_solver_prototxt_with_net(_solver_txt(lr), lenet(batch, batch))
    cfg = TrainerConfig(strategy=strategy, tau=2,
                        checkpoint_dir=str(ckpt_dir) if ckpt_dir else None,
                        checkpoint_every=every, checkpoint_keep=keep,
                        **cfg_kw)
    return DistributedTrainer(sp, _layout(strategy, workers), cfg,
                              seed=seed, device="cpu")


def _make_jax(ckpt_dir, seed=0, every=1, keep=3, *, strategy="local_sgd",
              batch=16, workers=4, lr=0.05, **cfg_kw):
    sp = jax_solver(_solver_txt(lr), jax_lenet(batch, batch))
    cfg = JaxConfig(strategy=strategy, tau=2,
                    checkpoint_dir=str(ckpt_dir) if ckpt_dir else None,
                    checkpoint_every=every, checkpoint_keep=keep, **cfg_kw)
    mesh = jax_pod_mesh(2, workers // 2) if strategy == "hierarchical" \
        else jax_mesh(workers)
    return JaxTrainer(sp, mesh, cfg, seed=seed)


def _batch(r, batch=16):
    """tests/test_resilience.py's ``_batch``."""
    rng = np.random.default_rng(100 + r)
    return {"data": rng.normal(size=(2, batch, 1, 28, 28)).astype(np.float32),
            "label": rng.integers(0, 10, size=(2, batch)).astype(np.float32)}


def _manifests(d) -> list[int]:
    return sorted(int(f[len("manifest_"):-len(".json")])
                  for f in os.listdir(d) if f.startswith("manifest_"))


def _assert_params_equal(a, b):
    for k, blobs in a.params.items():
        for i, x in enumerate(blobs):
            assert torch.equal(x, b.params[k][i]), f"{k}[{i}]"


def _rows(tr) -> np.ndarray:
    """The first stacked solver-state leaf, one row per tier."""
    return np.stack([s["history"]["conv1"][0].numpy() for s in tr.state])


# ---------------------------------------------------------------------------
# resume, pruning, corruption (tests/test_resilience.py:473-543, :826-960)
# ---------------------------------------------------------------------------

def test_round_checkpoint_resume_is_exact(tmp_path):
    d = tmp_path / "ck"
    tr = _make(d)
    for r in range(3):
        tr.data_cursor = {"next_round": r + 1}
        tr.train_round(_batch(r))
    tr2 = _make(d, seed=99)
    assert tr2.resumed is not None
    assert tr2.round == 3 and tr2.iter == 6
    assert tr2.data_cursor == {"next_round": 3}
    _assert_params_equal(tr2, tr)
    # one more round on both: bit-identical (generators restored too)
    assert tr.train_round(_batch(3)) == tr2.train_round(_batch(3))
    _assert_params_equal(tr2, tr)


@pytest.mark.parametrize("strategy,codec", [("local_sgd", "int8"),
                                            ("hierarchical", "bf16")])
def test_resume_with_dropout_and_device_crop_continues_exactly(
        tmp_path, strategy, codec):
    """The narrow CaffeNet (Dropout 0.5, masks from the worker
    generators) with the crop on the device (offsets from the crop
    generators): a trainer resumed from the round checkpoint runs the
    next round bit for bit as the original."""
    from sparknet_tpu_torch.parallel import device_crop_mirror_mean
    from sparknet_tpu_torch.proto import load_net_prototxt
    from test_torch_net import NARROW_CAFFENET
    shape = (2, 4, 3, 72, 72)
    rng = np.random.default_rng(5)
    rounds = [{"data": rng.normal(scale=30.0, size=shape).astype(np.float32),
               "label": rng.integers(0, 16, shape[:2]).astype(np.float32)}
              for _ in range(3)]

    def make(seed):
        sp = load_solver_prototxt_with_net(
            _solver_txt(0.001), load_net_prototxt(NARROW_CAFFENET))
        return DistributedTrainer(
            sp, _layout(strategy, 4), TrainerConfig(
                strategy=strategy, tau=2, comm_codec=codec,
                device_preprocess=device_crop_mirror_mean(67),
                checkpoint_dir=str(tmp_path / "ck")),
            seed=seed, device="cpu")

    tr = make(0)
    for b in rounds[:2]:
        tr.train_round(b)
    tr.flush_checkpoints()
    back = make(9)
    assert back.round == 2
    assert tr.train_round(rounds[2]) == back.train_round(rounds[2])
    _assert_params_equal(back, tr)
    for k, v in tr.comm_residual.items():
        for i, x in enumerate(v):
            assert torch.equal(x, back.comm_residual[k][i])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_checkpoint_every_and_pruning(tmp_path, pkg):
    d = tmp_path / "ck"
    tr = (_make if pkg == "port" else _make_jax)(d, every=2, keep=2)
    for r in range(8):
        tr.train_round(_batch(r))
    tr.flush_checkpoints()
    assert _manifests(d) == [6, 8]
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == \
        ["ckpt_round_00000006.npz", "ckpt_round_00000008.npz"]


def test_pruning_keeps_exactly_checkpoint_keep_newest(tmp_path):
    d = tmp_path / "ck"
    tr = _make(d, keep=2)
    for r in range(5):
        tr.train_round(_batch(r))
    tr.flush_checkpoints()
    assert _manifests(d) == [4, 5]
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == \
        ["ckpt_round_00000004.npz", "ckpt_round_00000005.npz"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_corrupt_checkpoint_falls_back_to_previous_manifest(tmp_path, pkg,
                                                            capfd):
    d = tmp_path / "ck"
    make = _make if pkg == "port" else _make_jax
    tr = make(d)
    for r in range(3):
        tr.train_round(_batch(r))
    tr.flush_checkpoints()
    faults.scribble(str(d / "ckpt_round_00000003.npz"))
    tr2 = make(d, seed=99)
    assert tr2.resumed is not None and tr2.round == 2
    assert tr2.resumed["file"] == "ckpt_round_00000002.npz"
    assert "resume: skipping manifest_00000003.json" in capfd.readouterr().err


def test_corrupt_ckpt_fault_injection_end_to_end(tmp_path, monkeypatch):
    d = tmp_path / "ck"
    monkeypatch.setenv("SPARKNET_FAULT", "corrupt_ckpt@round:3")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    tr = _make(d)
    for r in range(3):
        tr.train_round(_batch(r))
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "1")  # the restarted job
    tr2 = _make(d, seed=99)
    assert tr2.resumed is not None and tr2.round == 2
    tr2.train_round(_batch(2))
    tr2.flush_checkpoints()
    blob = load_checkpoint(str(d / "ckpt_round_00000003.npz"))
    assert int(blob["round"]) == 3


def test_layout_mismatch_raises_not_skips(tmp_path):
    d = tmp_path / "ck"
    _make(d).train_round(_batch(0))
    with pytest.raises(ValueError, match="mesh shape|workers"):
        _make(d, workers=8)


def test_resume_latest_empty_and_missing_dir(tmp_path):
    tr = _make(tmp_path / "empty")
    assert tr.resumed is None and tr.round == 0
    assert tr.resume_latest(str(tmp_path / "never_created")) is None


def test_resume_latest_all_manifests_corrupt(tmp_path):
    d = tmp_path / "ck"
    tr = _make(d)
    for r in range(2):
        tr.train_round(_batch(r))
    tr.flush_checkpoints()
    for f in os.listdir(d):
        if f.startswith("manifest_"):
            (d / f).write_text("{ not json at all")
    tr2 = _make(d, seed=99)
    assert tr2.resumed is None and tr2.round == 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_resume_latest_mixed_valid_and_corrupt(tmp_path, pkg):
    d = tmp_path / "ck"
    make = _make if pkg == "port" else _make_jax
    tr = make(d)
    for r in range(3):
        tr.train_round(_batch(r))
    tr.flush_checkpoints()
    (d / "manifest_00000003.json").write_text("!!")
    m2 = json.loads((d / "manifest_00000002.json").read_text())
    m2["file"] = "ckpt_round_99999999.npz"
    (d / "manifest_00000002.json").write_text(json.dumps(m2))
    tr2 = make(d, seed=99)
    assert tr2.resumed is not None and tr2.round == 1
    assert tr2.resumed["file"] == "ckpt_round_00000001.npz"


def test_kill_during_npz_write_leaves_no_referenced_garbage(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("SPARKNET_ASYNC_CKPT", "0")
    d = tmp_path / "ck"
    tr = _make(d)
    for r in range(2):
        tr.train_round(_batch(r))

    class _Killed(BaseException):
        pass

    real_replace = os.replace

    def killed_replace(src, dst):
        if dst.endswith(".npz"):
            raise _Killed()
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", killed_replace)
    with pytest.raises(_Killed):
        tr.train_round(_batch(2))
    monkeypatch.setattr(os, "replace", real_replace)
    names = set(os.listdir(d))
    assert "ckpt_round_00000003.npz" not in names
    assert "manifest_00000003.json" not in names
    assert any(".tmp." in n for n in names)
    tr2 = _make(d, seed=99)
    assert tr2.resumed is not None and tr2.round == 2
    tr2.train_round(_batch(2))              # sweeps the orphan temp
    assert not any(".tmp." in n for n in os.listdir(d))


class _Killed(BaseException):
    pass


def _fake_exit(code):
    raise _Killed()


@pytest.mark.parametrize("writer", ["sync", "async"])
def test_crash_between_npz_and_manifest_is_invisible_to_resume(
        tmp_path, monkeypatch, writer):
    """``crash_in_ckpt`` dies in the torn-write window: npz durable, no
    manifest.  On the asynchronous writer the death is on the writer's
    thread and surfaces at the next flush."""
    if writer == "sync":
        monkeypatch.setenv("SPARKNET_ASYNC_CKPT", "0")
    d = tmp_path / "ck"
    monkeypatch.setenv("SPARKNET_FAULT", "crash_in_ckpt@round:3")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    monkeypatch.setattr(faults.get_injector(), "_exit", _fake_exit)
    tr = _make(d)
    tr.train_round(_batch(0))
    tr.train_round(_batch(1))
    with pytest.raises(_Killed):
        tr.train_round(_batch(2))
        tr.flush_checkpoints()
    names = set(os.listdir(d))
    assert "ckpt_round_00000003.npz" in names
    assert "manifest_00000003.json" not in names
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "1")
    tr2 = _make(d, seed=99)
    assert tr2.resumed is not None and tr2.round == 2
    tr2.train_round(_batch(2))
    tr2.flush_checkpoints()
    blob = load_checkpoint(str(d / "ckpt_round_00000003.npz"))
    assert int(blob["round"]) == 3


# ---------------------------------------------------------------------------
# elastic re-forming (tests/test_resilience.py:961-1058)
# ---------------------------------------------------------------------------

def test_elastic_resume_shrink_preserves_consensus_params(tmp_path):
    d = tmp_path / "ck"
    a = _make(d, strategy="sync", batch=24, workers=4, lr=0.005)
    for r in range(2):
        a.train_round(_batch(r, 24))
    b = _make(d, seed=99, strategy="sync", batch=24, workers=3, lr=0.005,
              elastic=True)
    assert b.resumed is not None and b.round == 2 and b.iter == a.iter
    _assert_params_equal(b, a)
    assert np.isfinite(b.train_round(_batch(2, 24)))


def test_elastic_resume_without_flag_still_raises(tmp_path):
    d = tmp_path / "ck"
    _make(d, strategy="sync", batch=24, workers=4,
          lr=0.005).train_round(_batch(0, 24))
    with pytest.raises(ValueError, match="elastic"):
        _make(d, seed=99, strategy="sync", batch=24, workers=3, lr=0.005)


def test_elastic_retier_local_sgd_state_shrink_and_grow(tmp_path):
    """Per-worker state re-tiers as the JAX trainer's does: survivor i
    inherits saved row i mod saved_n."""
    d, jd = tmp_path / "ck", tmp_path / "jck"
    a = _make(d, batch=24, workers=4, lr=0.005)
    ja = _make_jax(jd, batch=24, workers=4, lr=0.005)
    for r in range(2):
        a.train_round(_batch(r, 24))
        ja.train_round(_batch(r, 24))
    ja.flush_checkpoints()
    a_rows = _rows(a)
    assert a_rows.shape[0] == 4
    b = _make(d, seed=99, batch=24, workers=3, lr=0.005, elastic=True)
    jb = _make_jax(jd, seed=99, batch=24, workers=3, lr=0.005, elastic=True)
    np.testing.assert_array_equal(_rows(b), a_rows[:3])
    jrows = np.asarray(jax.tree_util.tree_leaves(jb.state)[0])
    assert jrows.shape[0] == _rows(b).shape[0] == 3
    assert np.isfinite(b.train_round(_batch(2, 24)))
    c = _make(d, seed=7, batch=24, workers=4, lr=0.005, elastic=True)
    c_rows = _rows(c)
    assert c_rows.shape[0] == 4
    np.testing.assert_array_equal(c_rows[3], c_rows[0])   # from row 0
    assert np.isfinite(c.train_round(_batch(c.round, 24)))


def test_elastic_reform_matches_native_3worker_run_bit_for_bit(tmp_path):
    """From the re-form point, 4 workers' checkpoint resumed on 3 workers
    is bit for bit the 3-worker run from the same state, restored from a
    checkpoint rewritten as a true 3-worker one."""
    d4 = tmp_path / "ck4"
    a = _make(d4, batch=24, workers=4, lr=0.005)
    for r in range(2):
        a.train_round(_batch(r, 24))
    a.flush_checkpoints()
    b = _make(d4, seed=99, batch=24, workers=3, lr=0.005, elastic=True)
    assert b.resumed is not None and b.round == 2
    blob = load_checkpoint(str(d4 / "ckpt_round_00000002.npz"))
    blob["n_workers"] = np.int64(3)
    blob["state"] = {name: {k: [np.asarray(x)[:3] for x in v]
                            for k, v in tree.items()}
                     for name, tree in blob["state"].items()}
    c = _make(None, seed=7, batch=24, workers=3, lr=0.005)
    c._apply_blob(blob)
    c.round = 2
    for r in range(2, 4):
        assert b.train_round(_batch(r, 24)) == c.train_round(_batch(r, 24))
    _assert_params_equal(b, c)


def test_elastic_hierarchical_retiers_hosts(tmp_path):
    d = tmp_path / "ck"
    a = _make(d, strategy="hierarchical", batch=24, workers=4, lr=0.005)
    a.train_round(_batch(0, 24))
    a.flush_checkpoints()
    with pytest.raises(ValueError, match="elastic"):
        _make(d, strategy="hierarchical", batch=24, workers=6, lr=0.005)
    b = _make(d, strategy="hierarchical", batch=24, workers=6, lr=0.005,
              elastic=True)
    assert len(b.state) == 2    # 2 hosts x 3 chips: the hosts' state kept
    np.testing.assert_array_equal(_rows(b), _rows(a))


# ---------------------------------------------------------------------------
# residuals are trainer state (tests/test_comms.py:322-400)
# ---------------------------------------------------------------------------

def _res(tr) -> list[np.ndarray]:
    return [b.numpy() for v in tr.comm_residual.values() for b in v]


def _codec_trainer(workers=4, codec="int8", seed=0, **kw):
    return _make(None, seed=seed, workers=workers, lr=0.005,
                 comm_codec=codec, **kw)


def test_residual_checkpoint_resume_bit_exact(tmp_path):
    a = _codec_trainer()
    for r in range(2):
        a.train_round(_batch(r))
    assert any(np.abs(r).max() > 0 for r in _res(a))
    a.snapshot(str(tmp_path / "snap"))
    b = _codec_trainer(seed=1)
    b.restore(str(tmp_path / "snap"))
    for ra, rb in zip(_res(a), _res(b)):
        np.testing.assert_array_equal(ra, rb)
    assert a.train_round(_batch(2)) == b.train_round(_batch(2))
    _assert_params_equal(a, b)


def test_residual_elastic_retier(tmp_path):
    a = _codec_trainer()
    for r in range(2):
        a.train_round(_batch(r))
    a.snapshot(str(tmp_path / "snap"))
    b = _codec_trainer(workers=2, elastic=True)
    b.restore(str(tmp_path / "snap"))
    for rb, ra in zip(_res(b), _res(a)):
        assert rb.shape[0] == 2
        np.testing.assert_array_equal(rb, ra[:2])
    assert np.isfinite(b.train_round(_batch(2)))


def test_codec_change_resets_residuals(tmp_path, capfd):
    a = _codec_trainer()
    for r in range(2):
        a.train_round(_batch(r))
    a.snapshot(str(tmp_path / "snap"))
    b = _codec_trainer(codec="bf16")
    b.restore(str(tmp_path / "snap"))
    assert all(not r.any() for r in _res(b))
    assert "resetting error feedback" in capfd.readouterr().err


# ---------------------------------------------------------------------------
# the numerical guard (tests/test_resilience.py:1113-1190)
# ---------------------------------------------------------------------------

def _checkpoints_finite(d) -> None:
    for f in sorted(os.listdir(d)):
        if f.endswith(".npz"):
            blob = load_checkpoint(str(d / f))
            for v in blob["params"].values():
                for leaf in v:
                    assert np.all(np.isfinite(leaf)), f"NaN survived in {f}"


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_nan_inject_rolls_back_and_matches_fault_free(tmp_path, monkeypatch,
                                                      codec):
    """nan_inject at round 2 trips the guard, the poisoned round is
    dropped, every checkpoint left is finite, and the run ends on the
    fault-free params bit for bit (params, state, residuals and
    generators roll back).  base_lr 0.005: at the JAX test's 0.05 the
    fault-free lenet itself goes NaN by round 3."""
    clean = _make(tmp_path / "clean", lr=0.005, guard_numerics=True,
                  comm_codec=codec)
    clean_losses = [clean.train_round(_batch(r)) for r in range(4)]
    assert clean.guard_trips == 0
    monkeypatch.setenv("SPARKNET_FAULT", "nan_inject@round:2")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    faults.reset_injector()
    tr = _make(tmp_path / "chaos", lr=0.005, guard_numerics=True,
               comm_codec=codec)
    losses = []
    while tr.round < 4:
        losses.append(tr.train_round(_batch(tr.round)))
    tr.flush_checkpoints()
    assert tr.guard_trips == 1
    assert sum(1 for x in losses if not np.isfinite(x)) == 1
    _checkpoints_finite(tmp_path / "chaos")
    _assert_params_equal(tr, clean)
    assert [x for x in losses if np.isfinite(x)] == clean_losses


def test_guard_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="guard_numerics"):
        _make(None, guard_numerics=True)


def test_guard_loss_spike_detection(tmp_path):
    tr = _make(tmp_path / "ck", guard_numerics=True, loss_spike_factor=3.0)
    tr._loss_history = [1.0, 1.1, 0.9]
    assert tr._poison_reason(10.0) is not None
    assert tr._poison_reason(2.0) is None
    assert tr._poison_reason(float("inf")) is not None
    assert tr._poison_reason(float("nan")) is not None
    tr._loss_history = [1.0, 1.0]     # fewer than 3: no spike verdict
    assert tr._poison_reason(10.0) is None


def test_guard_lr_backoff_applies_and_checkpoints(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_FAULT", "nan_inject@round:1")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    faults.reset_injector()
    d = tmp_path / "ck"
    tr = _make(d, guard_numerics=True, guard_lr_backoff=0.5, lr=0.005)
    while tr.round < 3:
        tr.train_round(_batch(tr.round))
    assert tr.guard_trips == 1
    assert tr.lr_scale == 0.5
    monkeypatch.setenv("SPARKNET_FAULT", "")
    tr.flush_checkpoints()
    tr2 = _make(d, seed=99, guard_numerics=True, lr=0.005)
    assert tr2.lr_scale == 0.5


def test_guard_max_trips_raises_training_diverged(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_FAULT", "nan_inject@round:1")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    faults.reset_injector()
    tr = _make(tmp_path / "ck", guard_numerics=True, guard_max_trips=0)
    tr.train_round(_batch(0))
    with pytest.raises(TrainingDivergedError, match="guard_max_trips"):
        tr.train_round(_batch(1))


# ---------------------------------------------------------------------------
# the harvest lag and the asynchronous writer (:1227-1330)
# ---------------------------------------------------------------------------

def test_harvest_lag_retention_validation(tmp_path):
    with pytest.raises(ValueError, match="harvest_lag must be >= 0"):
        _make(tmp_path / "ck", harvest_lag=-1)
    with pytest.raises(ValueError, match="outruns the checkpoint"):
        _make(tmp_path / "ck", keep=2, guard_numerics=True, harvest_lag=2)
    _make(tmp_path / "ck2", keep=3, guard_numerics=True, harvest_lag=2)
    _make(None, harvest_lag=3)


def test_harvest_lag_2_matches_lag_0_bit_for_bit(tmp_path):
    kw = dict(lr=0.005, keep=4, guard_numerics=True)
    sync = _make(tmp_path / "sync", async_checkpoint=False, **kw)
    sync_losses = [sync.train_round(_batch(r)) for r in range(5)]
    sync.drain()
    tr = _make(tmp_path / "lag", harvest_lag=2, **kw)
    assert np.isnan(tr.train_round(_batch(0)))
    while tr.round < 5:
        tr.train_round(_batch(tr.round))
    losses = tr.drain()
    assert [losses[r] for r in range(5)] == sync_losses
    _assert_params_equal(tr, sync)
    a = load_checkpoint(str(tmp_path / "sync" / "ckpt_round_00000005.npz"))
    b = load_checkpoint(str(tmp_path / "lag" / "ckpt_round_00000005.npz"))
    for k in a["params"]:
        for x, y in zip(a["params"][k], b["params"][k]):
            assert x.tobytes() == y.tobytes()
    assert tr.stall_s.keys() == sync.stall_s.keys()


def test_lagged_guard_trip_replays_bit_for_bit(tmp_path, monkeypatch):
    kw = dict(lr=0.005, keep=4, guard_numerics=True)
    clean = _make(tmp_path / "clean", **kw)
    for r in range(5):
        clean.train_round(_batch(r))
    monkeypatch.setenv("SPARKNET_FAULT", "nan_inject@round:2")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    faults.reset_injector()
    tr = _make(tmp_path / "lag", harvest_lag=2, **kw)
    while True:
        while tr.round < 5:
            tr.train_round(_batch(tr.round))
        tr.drain()
        if tr.round == 5:
            break
    assert tr.guard_trips == 1
    _assert_params_equal(tr, clean)
    _checkpoints_finite(tmp_path / "lag")


def _content(path) -> dict:
    import zipfile
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_async_writer_equals_the_synchronous_one(tmp_path, monkeypatch):
    """The same rounds written by the background writer and
    synchronously: every array of every checkpoint equal byte for byte
    (the zip's entries; only its timestamps differ), and the manifests
    equal but for nothing."""
    runs = {}
    for mode in ("sync", "async"):
        if mode == "sync":
            monkeypatch.setenv("SPARKNET_ASYNC_CKPT", "0")
        else:
            monkeypatch.delenv("SPARKNET_ASYNC_CKPT")
        tr = _make(tmp_path / mode, lr=0.005, comm_codec="int8")
        for r in range(3):
            tr.train_round(_batch(r))
        assert (tr._ckpt_writer is None) == (mode == "sync")
        tr.flush_checkpoints()
        runs[mode] = tmp_path / mode
    for r in (1, 2, 3):
        name = f"ckpt_round_{r:08d}.npz"
        assert _content(runs["sync"] / name) == _content(runs["async"] / name)
        ms, ma = (json.loads((runs[m] / f"manifest_{r:08d}.json")
                             .read_text()) for m in ("sync", "async"))
        assert ms == ma


def test_async_writer_parks_errors_until_submit_or_flush():
    w = ckpt.AsyncCheckpointWriter(depth=1)
    done = []

    def bad():
        raise OSError("disk full")

    w.submit(bad)
    w.submit(lambda: done.append(1))      # later jobs still run...
    with pytest.raises(OSError, match="disk full"):
        w.flush()                         # ...and the error surfaces here
    assert done == [1]
    w.submit(bad)
    w.flush(raise_errors=False)
    with pytest.raises(OSError, match="disk full"):
        w.submit(lambda: None)            # or at the next submit
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(lambda: None)


def test_snapshot_tree_copies_are_alias_free():
    t = {"p": [torch.ones(3)], "n": 5}
    snap = ckpt.snapshot_tree(t)
    t["p"][0].add_(1.0)                  # the next round, in place
    got = snap.wait()
    assert torch.equal(got["p"][0], torch.ones(3)) and got["n"] == 5


def test_fenced_off_writer_is_refused(tmp_path, monkeypatch):
    d = tmp_path / "ck"
    monkeypatch.setenv("SPARKNET_FENCE_TOKEN", "7")
    tr = _make(d)
    tr.train_round(_batch(0))
    tr.flush_checkpoints()
    assert ckpt.read_fence(str(d)) == 7
    # a successor claims the directory; the zombie's next write is refused
    ckpt.advance_fence(str(d), 9)
    with pytest.raises(ckpt.CheckpointFencedError, match="fence 9"):
        tr.train_round(_batch(1))
    assert _manifests(d) == [1]
    with pytest.raises(ckpt.CheckpointFencedError):
        ckpt.advance_fence(str(d), 8)


# ---------------------------------------------------------------------------
# round checkpoints cross between the packages
# ---------------------------------------------------------------------------

def _assert_blob_equal(a: dict, b: dict, keys=("params", "state",
                                               "comm_residual")):
    for key in keys:
        if key not in a:
            assert key not in b
            continue
        fa = jax.tree_util.tree_leaves(a[key])
        fb = jax.tree_util.tree_leaves(b[key])
        assert len(fa) == len(fb) > 0, key
        for x, y in zip(fa, fb):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.tobytes() == y.tobytes(), key
    for key in ("iter", "round", "lr_scale", "strategy", "n_workers"):
        assert np.asarray(a[key]).tolist() == np.asarray(b[key]).tolist(), key


CROSS = [("local_sgd", "int8"), ("hierarchical", "bf16"), ("sync", "none")]


@pytest.mark.parametrize("strategy,codec", CROSS)
def test_jax_round_checkpoint_resumes_in_the_port(tmp_path, strategy,
                                                  codec):
    d = tmp_path / "ck"
    kw = dict(strategy=strategy, lr=0.005, comm_codec=codec,
              guard_numerics=True, guard_lr_backoff=0.5)
    ja = _make_jax(d, **kw)
    for r in range(2):
        ja.train_round(_batch(r))
    ja.lr_scale = 0.25
    ja.save_round_checkpoint()
    ja.flush_checkpoints()
    tr = _make(d, seed=9, **kw)
    assert tr.resumed is not None and tr.round == 2 and tr.iter == 4
    assert tr.lr_scale == 0.25
    want = load_checkpoint(str(d / "ckpt_round_00000002.npz"))
    _assert_blob_equal(tr._host_blob(), want)


@pytest.mark.parametrize("strategy,codec", CROSS)
def test_port_round_checkpoint_resumes_in_jax(tmp_path, strategy, codec):
    d = tmp_path / "ck"
    kw = dict(strategy=strategy, lr=0.005, comm_codec=codec,
              guard_numerics=True, guard_lr_backoff=0.5)
    tr = _make(d, **kw)
    for r in range(2):
        tr.train_round(_batch(r))
    tr.lr_scale = 0.25
    tr.save_round_checkpoint()
    tr.flush_checkpoints()
    ja = _make_jax(d, seed=9, **kw)
    assert ja.resumed is not None and ja.round == 2 and ja.iter == 4
    assert ja.lr_scale == 0.25
    blob = jax.device_get(ja._host_blob())
    _assert_blob_equal(blob, load_checkpoint(
        str(d / "ckpt_round_00000002.npz")))
