"""The port's fault injector (``utils/faults.py``) against the JAX
package's, on the CPU, and its hooks in the port.

- ``parse_faults`` gives the JAX package's specs (field for field) on the
  grammar strings of tests/test_resilience.py:36-197 and on every kind,
  and rejects that file's bad specs with the same message.
- The injector decides as the JAX package's does, hook by hook, on the
  same specs, attempts and ranks (crash/perma_crash/straggle/hang/preempt
  at round start, nan_inject once per process, crash_in_ckpt,
  corrupt_ckpt, corrupt_record's coin, feeder events, drop/torn ship,
  bad_canary, bitflip); ``corrupt_bytes`` and ``scribble`` write the
  same bytes.
- The port's hooks: ``db.corrupt_record`` rots the JAX package's records
  under ``corrupt_record:<p>``; ``PrefetchIterator`` restarts a feeder
  killed by ``feeder_die@round:N`` with nothing lost; the trainer refuses
  ``bitflip_params`` naming ROADMAP A12.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from sparknet_tpu.utils import faults as jfaults
from sparknet_tpu_torch.data import db
from sparknet_tpu_torch.data.prefetch import PrefetchIterator
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import DistributedTrainer, TrainerConfig
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from sparknet_tpu_torch.utils import faults
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

GRAMMAR = [
    "crash@round:3@rank:1, slow_feed:200ms, corrupt_ckpt@round:2,"
    "hang@round:5@attempt:2",
    "perma_crash@rank:3, straggle:1.5s@round:2, nan_inject@round:4,"
    "crash_in_ckpt@round:1",
    "slow_feed:1.5s", "slow_feed:2", "corrupt_record:0.25",
    "feeder_die@round:3, feeder_hang:2s@round:5",
    "bitflip_params@rank:1@round:3", "preempt@round:2",
    "partition@host:h1, heal@host:h1@round:4, slow_link:50ms@host:h2",
    "drop_ship:0.5, torn_ship", "bad_canary:mv-abc123",
    "corrupt_ckpt", " , crash@round:0 ,",
]
REJECTS = [
    ("explode@round:1", "unknown fault kind"),
    ("crash", "needs @round"),
    ("crash@round:x", "not an integer"),
    ("crash@rnd:1", "bad modifier"),
    ("slow_feed", "needs a duration"),
    ("slow_feed:fast", "bad duration"),
    ("crash:3@round:1", "takes no ':' arg"),
    ("straggle@round:1", "needs a duration"),
    ("nan_inject", "needs @round"),
    ("crash_in_ckpt", "needs @round"),
    ("perma_crash", "needs @rank"),
    ("bitflip_params@round:1", "needs @rank"),
    ("partition", "needs @host"),
    ("crash@round:1@host:h", "takes no @host"),
    ("corrupt_record:2", "must be in"),
    ("corrupt_record", "needs a probability"),
    ("bad_canary", "needs a model"),
]


def _fields(spec) -> dict:
    return dataclasses.asdict(spec)


@pytest.mark.parametrize("text", GRAMMAR)
def test_parse_faults_equals_jax(text):
    ours, theirs = faults.parse_faults(text), jfaults.parse_faults(text)
    assert [_fields(s) for s in ours] == [_fields(s) for s in theirs]
    assert len(ours) > 0


def test_kinds_are_the_jax_kinds():
    assert faults.KINDS == jfaults.KINDS
    assert faults.NET_KINDS == jfaults.NET_KINDS


@pytest.mark.parametrize("bad,msg", REJECTS)
def test_parse_faults_rejects_as_jax(bad, msg):
    with pytest.raises(ValueError, match=msg) as ours:
        faults.parse_faults(bad)
    with pytest.raises(ValueError) as theirs:
        jfaults.parse_faults(bad)
    assert str(ours.value) == str(theirs.value)


class _Exit(Exception):
    pass


def _pair(spec, attempt=0, rank=0):
    """The port's and the JAX package's injectors on ``spec``, each
    recording its exits, sleeps and kills instead of acting."""
    out = []
    for mod in (faults, jfaults):
        calls = {"exit": [], "sleep": [], "kill": []}

        def exit_(code, calls=calls):
            calls["exit"].append(code)
            raise _Exit()

        def sleep(s, calls=calls):
            calls["sleep"].append(s)
            raise _Exit()

        def kill(pid, sig, calls=calls):
            calls["kill"].append(sig)

        out.append((mod.FaultInjector(mod.parse_faults(spec),
                                      attempt=attempt, rank=rank,
                                      _exit=exit_, _sleep=sleep, _kill=kill),
                    calls))
    return out


def _outcome(fn):
    try:
        return ("ok", fn())
    except _Exit:
        return ("exit", None)


@pytest.mark.parametrize("spec,attempt,rank", [
    ("crash@round:3@rank:1", 0, 1), ("crash@round:3@rank:1", 0, 0),
    ("crash@round:1", 1, 0), ("perma_crash@rank:2", 5, 2),
    ("perma_crash@rank:2", 5, 1), ("straggle:2.5s@round:1", 0, 0),
    ("straggle:2.5s@round:1", 1, 0), ("hang@round:2@attempt:1", 1, 0),
    ("preempt@round:1", 0, 0)])
def test_on_round_decides_as_jax(spec, attempt, rank):
    (ours, oc), (theirs, tc) = _pair(spec, attempt, rank)
    for r in range(4):
        assert _outcome(lambda: ours.on_round(r)) == \
            _outcome(lambda: theirs.on_round(r)), r
    assert oc == tc


@pytest.mark.parametrize("spec,attempt,rank", [
    ("nan_inject@round:2", 0, 0), ("nan_inject@round:2@rank:1", 0, 0),
    ("nan_inject@round:2", 1, 0), ("corrupt_ckpt@round:2", 0, 0),
    ("corrupt_ckpt@round:2", 1, 0), ("corrupt_ckpt", 0, 0),
    ("crash_in_ckpt@round:3", 0, 0), ("crash_in_ckpt@round:3", 1, 0),
    ("slow_feed:50ms", 3, 0), ("slow_feed:50ms@rank:1", 0, 0),
    ("feeder_die@round:2, feeder_hang:3s@round:4", 0, 0),
    ("bitflip_params@rank:1@round:2", 0, 0),
    ("bad_canary:mv-abc", 0, 0), ("drop_ship:0.3, torn_ship", 0, 0),
    ("partition@host:h1, slow_link:20ms@host:h2", 0, 0)])
def test_hooks_decide_as_jax(spec, attempt, rank):
    (ours, oc), (theirs, tc) = _pair(spec, attempt, rank)
    for r in range(5):
        # twice each: the once-per-process kinds fire on the first only
        for _ in range(2):
            assert ours.nan_inject(r) == theirs.nan_inject(r)
            assert ours.corrupt_checkpoint(r) == theirs.corrupt_checkpoint(r)
            assert ours.feeder_event(r) == theirs.feeder_event(r)
            assert ours.bitflip_rank(r) == theirs.bitflip_rank(r)
            assert ours.torn_ship() == theirs.torn_ship()
        assert _outcome(lambda: ours.on_checkpoint_write(r)) == \
            _outcome(lambda: theirs.on_checkpoint_write(r))
    assert ours.feed_delay() == theirs.feed_delay()
    assert [ours.drop_ship(s) for s in range(64)] == \
        [theirs.drop_ship(s) for s in range(64)]
    for m in ("mv-abc", "resnet@mv-abc", "other"):
        assert ours.bad_canary(m) == theirs.bad_canary(m)
    assert [_fields(s) for s in ours.net_specs()] == \
        [_fields(s) for s in theirs.net_specs()]
    assert oc == tc


def test_corrupt_record_coin_and_bytes_equal_jax():
    (ours, _), (theirs, _) = _pair("corrupt_record:0.3")
    picks = [s for s in range(400) if ours.corrupt_record(s)]
    assert picks == [s for s in range(400) if theirs.corrupt_record(s)]
    assert 60 < len(picks) < 180
    raw = bytes(range(256)) * 3
    for seq in picks[:10]:
        assert faults.corrupt_bytes(raw, seq) == \
            jfaults.corrupt_bytes(raw, seq)
    assert faults.corrupt_bytes(b"", 1) == b""


def test_scribble_writes_the_jax_bytes(tmp_path):
    data = bytes(np.random.default_rng(0).integers(0, 256, 5000,
                                                   dtype=np.uint8))
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_bytes(data)
    b.write_bytes(data)
    faults.scribble(str(a))
    jfaults.scribble(str(b))
    assert a.read_bytes() == b.read_bytes() != data


def test_get_injector_tracks_env_and_resets(monkeypatch):
    monkeypatch.setenv("SPARKNET_FAULT", "slow_feed:10ms,nan_inject@round:1")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    faults.reset_injector()
    inj = faults.get_injector()
    assert inj.feed_delay() == pytest.approx(0.01)
    assert inj.nan_inject(1) and not faults.get_injector().nan_inject(1)
    faults.reset_injector()
    assert faults.get_injector().nan_inject(1)    # re-armed
    monkeypatch.setenv("SPARKNET_PROC_ID", "3")
    assert faults.get_injector().rank == 3
    monkeypatch.setenv("SPARKNET_FAULT", "")
    assert faults.get_injector().feed_delay() == 0.0
    faults.reset_injector()


def test_db_seam_rots_the_jax_records(monkeypatch):
    monkeypatch.setenv("SPARKNET_FAULT", "corrupt_record:0.5")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    faults.reset_injector()
    jfaults.reset_injector()
    raw = bytes(range(200))
    try:
        for seq in range(40):
            want = (jfaults.corrupt_bytes(raw, seq)
                    if jfaults.get_injector().corrupt_record(seq) else None)
            assert db.corrupt_record(seq, raw) == want
    finally:
        monkeypatch.delenv("SPARKNET_FAULT")
        faults.reset_injector()
        jfaults.reset_injector()
    assert db.corrupt_record(3, raw) is None


def test_feeder_die_is_restarted_with_nothing_lost(monkeypatch):
    monkeypatch.setenv("SPARKNET_FAULT", "feeder_die@round:5")
    monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    faults.reset_injector()
    try:
        it = PrefetchIterator(iter(range(20)), depth=2)
        assert list(it) == list(range(20))
        assert len(it.threads()) == 2      # the first feeder and its heir
    finally:
        monkeypatch.delenv("SPARKNET_FAULT")
        faults.reset_injector()


def test_trainer_refuses_bitflip_naming_a12(monkeypatch):
    """``bitflip_params`` is no longer refused: the trainer flips bit 22
    of position 1's copy of conv1's weight at round 0 (finite, so no
    guard sees it), position 1 trains from it and the round's average
    differs from a clean run's by that position's share; the fault fires
    once."""
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.01\nlr_policy: "fixed"\n', lenet(2, 2))
    batch = {"data": np.zeros((1, 4, 1, 28, 28), np.float32),
             "label": np.zeros((1, 4), np.float32)}
    clean = DistributedTrainer(sp, 2, TrainerConfig(), device="cpu")
    clean.train_round(batch)
    tr = DistributedTrainer(sp, 2, TrainerConfig(), device="cpu")
    monkeypatch.setenv("SPARKNET_FAULT", "bitflip_params@rank:1@round:0")
    faults.reset_injector()
    try:
        tr.train_round(batch)
        got = tr.params["conv1"][0].reshape(-1)
        want = clean.params["conv1"][0].reshape(-1)
        assert not np.array_equal(got.numpy(), want.numpy())
        assert np.isfinite(got.numpy()).all()
        assert faults.get_injector().bitflip_rank(0) is None   # fired once
    finally:
        monkeypatch.delenv("SPARKNET_FAULT")
        faults.reset_injector()
