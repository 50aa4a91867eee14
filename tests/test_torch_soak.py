"""The port's chaos soak (``python -m sparknet_tpu_torch.tools.soak``)
at its smallest sizes on the CPU: the restart soak (one seeded schedule
under ResilientRunner), the fleet soak (one seeded job and the
whole-budget preemptor under one FleetScheduler, each job bit for bit
its fault-free baseline, no orphan) and the rollout soak (canary
promote, bad-canary rollback, controller kill and resume) and the net
soak's slice (partition-suspend-heal and the fenced zombie ship over the
fake-ssh wire, each bit for bit its baseline), whose report both
packages' ledgers read alike.  ``--pod`` raises naming the pod half, with
``--net`` too.
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


@pytest.mark.parametrize("flag", [["--pod", "3"], ["--net", "--pod", "2"]])
def test_pod_and_net_raise_naming_the_pod_half(flag):
    """The pod half's tensors (order 3) still raise, a ``--net`` run asked
    for beside them too; ``--net`` alone runs (below)."""
    with pytest.raises(NotImplementedError, match="ROADMAP A12, pod half"):
        soak.main(flag + ["--device", "cpu"])


def test_net_soak_slice_legs_pass_bit_for_bit(tmp_path, monkeypatch):
    from sparknet_tpu.utils import perfledger as j_ledger
    from sparknet_tpu_torch.utils import perfledger as p_ledger
    # the soak sets these in this process's env: undone after the test
    for k in ("SPARKNET_SSH_CMD", "SPARKNET_LEASE_S",
              "SPARKNET_LEASE_MISSES", "SPARKNET_SHIP_CHUNK_MB"):
        monkeypatch.setenv(k, "")
    out = str(tmp_path / "net.json")
    rc = soak.main(["--net", "--net-slice", "--device", "cpu", "--out",
                    out, "--workdir", str(tmp_path / "w")])
    rep = _verdict(out)
    assert rc == 0 and rep["ok"], rep
    assert rep["mode"] == "net" and rep["lease_window_s"] == 1.0
    part, fenced = rep["episodes"]
    assert part["episode"] == "partition_suspend_heal"
    assert part["transport"] == "chaos(ssh)" and part["match"]
    assert part["suspects"] == ["hostb"] and part["stragglers"] == []
    assert part["flap"]["healed"] and part["flap"]["partition_s"] >= 4.0
    assert fenced["episode"] == "fenced_zombie_ship" and fenced["match"]
    assert fenced["ship"]["round"] == 4
    assert 0 < fenced["ship"]["resumed_bytes"] < fenced["ship"]["bytes"]
    assert fenced["zombie"]["refused"] and fenced["newest_round"] == 8
    assert "torn_leftovers" not in fenced
    ours = p_ledger.entries_from_any(rep, "SOAK_net_r21.json")
    theirs = j_ledger.entries_from_any(rep, "SOAK_net_r21.json")
    assert len(ours) == len(theirs) == 1
    assert ours[0]["metrics"] == theirs[0]["metrics"]
    assert set(ours[0]["metrics"]) == {"netsoak_partition_recovery_s",
                                       "netsoak_fenced_resume_s",
                                       "netsoak_ship_mb_per_s"}
