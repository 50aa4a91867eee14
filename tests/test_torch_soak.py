"""The port's chaos soak (``python -m sparknet_tpu_torch.tools.soak``)
at its smallest sizes on the CPU: the restart soak (one seeded schedule
under ResilientRunner), the fleet soak (one seeded job and the
whole-budget preemptor under one FleetScheduler, each job bit for bit
its fault-free baseline, no orphan) and the rollout soak (canary
promote, bad-canary rollback, controller kill and resume).  ``--pod``
and ``--net`` raise naming the pod half.
"""

from __future__ import annotations

import json
import os

import pytest

from sparknet_tpu_torch.tools import soak
from sparknet_tpu_torch.utils import faults
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("SPARKNET_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    faults.reset_injector()
    yield
    faults.reset_injector()


def _verdict(path):
    with open(path) as f:
        return json.load(f)


def test_fleet_soak_one_schedule_recovers_exactly(tmp_path):
    """The preemptor arrives 1 s after submission: the seeded job is
    placed at the first step and needs longer than that for its 4
    rounds, a crash and a restart, so under any load it is running when
    the preemptor comes."""
    out = str(tmp_path / "fleet.json")
    rc = soak.main(["--fleet", "1", "--fleet-devices", "2",
                    "--fleet-world", "2", "--fleet-preempt-after", "1",
                    "--seed", "0", "--device", "cpu", "--out", out,
                    "--workdir", str(tmp_path / "w")])
    rep = _verdict(out)
    assert rc == 0 and rep["ok"], rep
    assert [j["schedule"] for j in rep["jobs"]] == [
        "crash", "clean-high-priority"]
    assert all(j["match"] for j in rep["jobs"])
    assert rep["jobs"][0]["preempts"] >= 1
    assert rep["orphans"] == {} and rep["preemption_exercised"]


def test_restart_soak_one_run_recovers_exactly(tmp_path):
    out = str(tmp_path / "soak.json")
    rc = soak.main(["--runs", "1", "--seed", "3", "--device", "cpu",
                    "--out", out, "--workdir", str(tmp_path / "w")])
    rep = _verdict(out)
    assert rc == 0 and rep["ok"], rep
    (run,) = rep["runs"]
    assert run["match"] and run["attempts"] >= 2, run


def test_rollout_soak_three_legs(tmp_path):
    out = str(tmp_path / "rollout.json")
    rc = soak.main(["--rollout", "--seed", "0", "--device", "cpu",
                    "--out", out, "--workdir", str(tmp_path / "w")])
    rep = _verdict(out)
    assert rc == 0 and rep["ok"], rep
    assert [e["episode"] for e in rep["episodes"]] == [
        "canary_promote", "bad_canary_rollback", "controller_kill_resume"]
    bad = rep["episodes"][1]
    assert bad["rolled_back"] and bad["served_bad"] == 0
    assert bad["stable_errors"] == 0 and bad["canary_typed_failures"] > 0


@pytest.mark.parametrize("flag", [["--pod", "3"], ["--net"]])
def test_pod_and_net_raise_naming_the_pod_half(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP A12, pod half"):
        soak.main(flag + ["--device", "cpu"])
