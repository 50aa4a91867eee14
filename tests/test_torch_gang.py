"""Gangs of two processes of the port's lenet driver, on the CPU.

``tools/launch.py::launch_local(nprocs=2)`` starts two processes of
``tools/multihost_driver.py`` with two workers each; they join one gloo
group (``parallel/cluster.py``), each feeds its ``local_batch_slice`` and
runs its two positions, and every mean over positions is taken over the
positions' trees all-gathered in position order.  For ``sync`` and
``local_sgd`` (``hierarchical`` in tests/test_torch_gang_pod.py) the
gang's params, losses and test scores equal the port's
one-process four-worker run bit for bit, and track the JAX package's
one-process driver (tests/multihost_driver.py) within rtol 1e-5, atol
1e-6 (scores atol 1e-5), every run resuming the JAX driver's round-0
checkpoint so the three start from the same weights (JAX
tests/test_multihost.py:40-116).
"""

from __future__ import annotations

import pytest

import gang_helpers as gh


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    gh.clean_env(monkeypatch)


@pytest.mark.parametrize("strategy", ["sync", "local_sgd"])
def test_two_process_gang_equals_one_process(tmp_path, strategy):
    start = gh.jax_start(tmp_path, strategy, 4)
    one = gh.port_one(tmp_path, start, strategy, 4)
    rc, gang, report = gh.port_gang(tmp_path, start, strategy, 2, 2)
    assert rc == 0, report
    gh.assert_bits(gang, one)
    gh.assert_tracks_jax(one, gh.jax_one(tmp_path, start, strategy, 4))
