"""Gangs of the ``hierarchical`` strategy, on the CPU: two processes are
the two hosts of the 2x2 pod, the per-step gradient mean stays in a
process and the τ-boundary weight mean crosses the process boundary.

The gang equals the port's one-process 2x2 run bit for bit and tracks
the JAX package's one-process driver within rtol 1e-5, atol 1e-6 (scores
atol 1e-5), from the JAX driver's round-0 checkpoint (JAX
tests/test_multihost.py:40-90).  Under ``SPARKNET_SHARD=auto`` and
``SPARKNET_SHARD_CKPT=1`` (each chip column's tiles, a sharded checkpoint
a round) the gang writes the one-process run's tile files and ends with
its params bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import gang_helpers as gh


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    gh.clean_env(monkeypatch)


def test_sharded_hierarchical_gang_equals_one_process(tmp_path):
    env = {"SPARKNET_SHARD": "auto", "SPARKNET_SHARD_CKPT": "1"}
    ck1, ck2 = str(tmp_path / "one_ck"), str(tmp_path / "gang_ck")
    from sparknet_tpu_torch.tools.launch import launch_local
    one = str(tmp_path / "one.npz")
    assert launch_local(
        [*gh.PORT_DRIVER, "--strategy", "hierarchical", "--rounds", "3",
         "--ckpt-dir", ck1, "--out", one], 1, device="cpu",
        local_devices=4, timeout=240, extra_env=env) == 0
    rc, gang, report = gh.port_gang(
        tmp_path, None, "hierarchical", 2, 2, rounds=3,
        extra=["--ckpt-dir", ck2], env=env)
    assert rc == 0, report
    gh.assert_bits(gang, np.load(one))
    tiles = sorted(f for f in os.listdir(ck2) if ".shard" in f)
    assert tiles and tiles == sorted(f for f in os.listdir(ck1)
                                     if ".shard" in f)


def test_two_process_hierarchical_gang_equals_one_process(tmp_path):
    start = gh.jax_start(tmp_path, "hierarchical", 4)
    one = gh.port_one(tmp_path, start, "hierarchical", 4)
    rc, gang, report = gh.port_gang(tmp_path, start, "hierarchical", 2, 2)
    assert rc == 0, report
    gh.assert_bits(gang, one)
    gh.assert_tracks_jax(one, gh.jax_one(tmp_path, start, "hierarchical",
                                         4))
