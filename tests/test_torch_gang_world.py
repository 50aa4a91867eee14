"""Larger and failing gangs of the port's driver, on the CPU.

A gang of four processes x two workers under ``sync`` equals the port's
one-process eight-worker run bit for bit and tracks the JAX one-process
driver on eight devices within rtol 1e-5, atol 1e-6 (JAX
tests/test_multihost.py:93-114).  A ``local_sgd`` gang with
``--audit-every 1`` catches ``bitflip_params@rank:3@round:2`` (position 3
lives in process 1) once and ends bit for bit the fault-free run.  A rank
that dies after its first round ends the gang with a non-zero code long
before the launcher's timeout (tests/test_multihost.py:117).
"""

from __future__ import annotations

import os
import time

import pytest

import gang_helpers as gh


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    gh.clean_env(monkeypatch)


def test_four_process_sync_gang_equals_one_process(tmp_path):
    start = gh.jax_start(tmp_path, "sync", 8)
    one = gh.port_one(tmp_path, start, "sync", 8)
    rc, gang, report = gh.port_gang(tmp_path, start, "sync", 4, 2)
    assert rc == 0, report
    gh.assert_bits(gang, one)
    gh.assert_tracks_jax(one, gh.jax_one(tmp_path, start, "sync", 8))


def test_the_audit_catches_a_flip_in_the_other_process(tmp_path):
    args = ["--ckpt-dir", None, "--audit-every", "1"]

    def gang(name, env=None):
        d = str(tmp_path / name)
        os.makedirs(d)
        rc, out, report = gh.port_gang(
            tmp_path / name, None, "local_sgd", 2, 2, rounds=4,
            extra=[a if a is not None else os.path.join(d, "ck")
                   for a in args], env=env)
        assert rc == 0, report
        return out

    clean = gang("clean")
    flip = gang("flip", {"SPARKNET_FAULT": "bitflip_params@rank:3@round:2"})
    assert int(clean["__audit_trips__"]) == 0
    assert int(flip["__audit_trips__"]) == 1
    for k in clean.files:
        if not k.startswith("__"):
            assert clean[k].tobytes() == flip[k].tobytes(), k


def test_a_dead_rank_is_reported_not_hung(tmp_path):
    t0 = time.monotonic()
    rc, _, report = gh.port_gang(tmp_path, None, "sync", 2, 2,
                                 extra=["--fail-rank", "1"], timeout=150)
    assert rc != 0, "a worker's death must fail the gang"
    assert report["first_failure"] in (0, 1)
    assert time.monotonic() - t0 < 120, "the gang hung toward its timeout"
