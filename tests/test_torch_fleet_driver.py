"""The port's lenet fleet driver, its heartbeats and the supervisor
half of the health plane against the JAX package's, on the CPU.

``python -m sparknet_tpu_torch.tools.multihost_driver`` runs 2 workers
for 3 rounds from the JAX driver's own round-0 checkpoint (its
``--guard`` baseline; round checkpoints cross between the packages) and
its params track the JAX driver's ``--local-devices 2`` output within
1e-5 relative.  A run preempted at round boundary 2 under the fleet (the
``preempt`` fault: SIGTERM, one final checkpoint, a clean exit, a
requeue) and resumed equals the unpreempted run bit for bit, and its
trainer's round beats carry the JAX trainer's extras.  The straggler
and lease monitors give the JAX package's verdicts on the same beat
trees, the launcher kills a rank that stops beating, and a prefetch
feed past its restart budget beats ``feed_stalled`` as the JAX one
does.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from sparknet_tpu.data import prefetch as j_prefetch
from sparknet_tpu.parallel import health as j_health
from sparknet_tpu.utils import faults as j_faults
from sparknet_tpu_torch.data import prefetch as p_prefetch
from sparknet_tpu_torch.parallel import fleet as p_fleet
from sparknet_tpu_torch.parallel import health as p_health
from sparknet_tpu_torch.tools import launch
from sparknet_tpu_torch.utils import faults as p_faults
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DRIVER = os.path.join(ROOT, "tests", "multihost_driver.py")
PORT_DRIVER = [sys.executable, "-m",
               "sparknet_tpu_torch.tools.multihost_driver"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("SPARKNET_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p))
    p_faults.reset_injector()
    j_faults.reset_injector()
    yield
    p_faults.reset_injector()
    j_faults.reset_injector()


def _run(cmd, timeout=240):
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


DRIVER_ARGS = ["--local-devices", "2", "--expect-devices", "2"]


def test_driver_tracks_the_jax_driver_within_1e5(tmp_path):
    ck0 = tmp_path / "ck0"
    _run([sys.executable, JAX_DRIVER, *DRIVER_ARGS, "--rounds", "0",
          "--guard", "--ckpt-dir", str(ck0), "--out",
          str(tmp_path / "j0.npz")])
    shutil.copytree(ck0, tmp_path / "ckj")
    shutil.copytree(ck0, tmp_path / "ckp")
    _run([sys.executable, JAX_DRIVER, *DRIVER_ARGS, "--rounds", "3",
          "--guard", "--ckpt-dir", str(tmp_path / "ckj"), "--out",
          str(tmp_path / "j.npz")])
    log = _run([*PORT_DRIVER, *DRIVER_ARGS, "--rounds", "3", "--guard",
                "--ckpt-dir", str(tmp_path / "ckp"), "--out",
                str(tmp_path / "p.npz"), "--device", "cpu"])
    assert "driver: resumed at round 0" in log
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "p.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        rel = np.abs(a[k] - b[k]).max() / max(np.abs(a[k]).max(), 1e-30)
        assert rel <= 1e-5, (k, rel)
    assert len(b["__losses__"]) == 3


def test_preempted_and_resumed_run_equals_the_unpreempted(tmp_path):
    base = str(tmp_path / "base.npz")
    rc = launch.launch_local(
        [*PORT_DRIVER, "--strategy", "sync", "--out", base, "--rounds",
         "3", "--global-batch", "16", "--expect-devices", "2"], 1,
        device="cpu", local_devices=2, timeout=240)
    assert rc == 0
    fleet = p_fleet.FleetScheduler(str(tmp_path / "fleet"), 2,
                                   preempt_grace_s=60, device="cpu",
                                   extra_env={"OMP_NUM_THREADS": "1"})
    # SIGTERM at the start of round 1: the driver finishes that round
    # and stops at round boundary 2 with a checkpoint
    job = fleet.submit(p_fleet.JobSpec(name="pre", world=2, rounds=3,
                                       fault="preempt@round:1"))
    assert fleet.run(tick_s=0.05, timeout_s=240) == 0
    assert job.state == p_fleet.COMPLETED and job.preempt_count == 1
    assert fleet.live_worker_pids() == {}
    a, b = np.load(base), np.load(job.out_path)
    for k in a.files:
        if not k.startswith("__"):
            assert np.array_equal(a[k], b[k]), f"param {k} diverged"
    assert np.array_equal(a["__losses__"][2:], b["__losses__"][-1:])
    # the resumed episode's trainer beat round_end with the JAX extras
    hb = sorted((tmp_path / "fleet" / "jobs" / "pre" / "runner").glob(
        "ep_*/attempt_*/hb"))[-1]
    beat = p_health.read_beat(str(hb), 0)
    assert beat.phase == "round_end" and beat.round == 2
    assert set(beat.extras) >= {"stall_s", "guard_trips", "audit_trips"}
    assert "checkpoint" in beat.extras["stall_s"]
    view = p_fleet.offline_status(str(tmp_path / "fleet"))
    (row,) = view["jobs"]
    assert row["round"] == 3 and row["preempts"] == 1


def test_audit_and_multi_process_worlds_are_refused(tmp_path):
    """``--audit-every`` is live: multihost_driver audits every round, writes
    the trainer's audit trips (0 on a healthy run) and ends with the
    params of the run without the audit."""
    from sparknet_tpu_torch.tools import multihost_driver
    outs = {}
    for audit in ("0", "1"):
        out = str(tmp_path / f"o{audit}.npz")
        assert multihost_driver.main(
            ["--out", out, "--audit-every", audit, "--local-devices", "4",
             "--ckpt-dir", str(tmp_path / f"ck{audit}"),
             "--device", "cpu"]) == 0
        outs[audit] = np.load(out)
    assert int(outs["1"]["__audit_trips__"]) == 0
    for k in outs["0"].files:
        if not k.startswith("__"):
            np.testing.assert_array_equal(outs["0"][k], outs["1"][k])


# ---------------------------------------------------------------------------
# The supervisor half of the health plane
# ---------------------------------------------------------------------------

def _beat_tree(root, now):
    """Hosts a (two ranks, one stale), b (silent), c (fresh) and a flat
    rank 9."""
    for mod in (j_health, p_health):
        assert mod.host_dir(root, "a") == os.path.join(root, "host_a")
    spec = {("a", 0): now - 1.0, ("a", 1): now - 50.0, ("b", 2): now - 30.0,
            ("c", 3): now - 0.5}
    for (host, rank), t in spec.items():
        p_health.write_beat(p_health.host_dir(root, host), rank, 4,
                            "round_end", clock=lambda t=t: t)
    p_health.write_beat(root, 9, 2, "round_start", clock=lambda: now - 20)


def test_monitors_give_the_jax_verdicts(tmp_path):
    now = 1_000_000.0
    root = str(tmp_path / "hb")
    _beat_tree(root, now)
    clock = lambda: now   # noqa: E731
    verdicts = {}
    for name, mod in (("jax", j_health), ("port", p_health)):
        lease = mod.LeaseMonitor(root, lease_s=2.0, misses=3, clock=clock)
        strag = mod.StragglerMonitor(root, 10.0, clock)
        gang = mod.GangHealth(root, 10.0, host_map=["a", "a", "b", "c"],
                              suspect_probe=lambda h: h == "c",
                              down_probe=lambda h: False, clock=clock)
        verdicts[name] = (
            lease.states(["a", "b", "c", "z"]), lease.window_s,
            strag.check([0, 1, 2, 3, 9]), strag.check([0, 1, 2, 3, 9]),
            strag.last_age(1), gang.check([0, 1, 2, 3]),
            sorted(gang.suspect_hosts), mod.rollup_hosts(root, deadline_s=5,
                                                         now=now),
            mod.stage_dir(root, "b"))
    assert verdicts["port"] == verdicts["jax"]
    assert verdicts["port"][2] == [1, 2, 9]
    with pytest.raises(ValueError, match="SPARKNET_LEASE_S"):
        p_health.lease_window_s(lease_s=0)


def test_launcher_kills_a_rank_that_stops_beating(tmp_path):
    hb = str(tmp_path / "hb")
    code = ("from sparknet_tpu_torch.parallel import health\n"
            "import time\n"
            "health.maybe_beat(0, 'round_start')\n"
            "time.sleep(120)\n")
    report = {}
    t0 = time.monotonic()
    rc = launch.launch_local([sys.executable, "-c", code], 1, timeout=100,
                             heartbeat_dir=hb, round_deadline=1.0,
                             report=report)
    assert rc == launch.EXIT_STRAGGLER
    assert report["cause"] == "straggler" and report["stragglers"] == [0]
    assert time.monotonic() - t0 < 90
    assert launch.main(["--nprocs", "1", "--device", "cpu", "--",
                        sys.executable, "-c",
                        "import sys; assert sys.argv[-2:] == "
                        "['--device', 'cpu']"]) == 0


def test_a_stalled_feed_beats_feed_stalled_as_the_jax_feed_does(
        tmp_path, monkeypatch):
    beats = {}
    for name, mod, fl in (("jax", j_prefetch, j_faults),
                          ("port", p_prefetch, p_faults)):
        d = str(tmp_path / name)
        monkeypatch.setenv("SPARKNET_HEARTBEAT_DIR", d)
        monkeypatch.setenv("SPARKNET_PROC_ID", "3")
        monkeypatch.setenv("SPARKNET_FAULT", "feeder_die@round:2")
        fl.reset_injector()
        it = mod.PrefetchIterator(iter(range(10)), depth=1, restarts=0)
        got = []
        with pytest.raises(mod.FeedStalled):
            for v in it:
                got.append(v)
        it.close()
        beat = (j_health if name == "jax" else p_health).read_beat(d, 3)
        beats[name] = (got, beat.phase, beat.round, beat.rank)
    assert beats["port"] == beats["jax"]
    assert beats["port"][1] == "feed_stalled"
    monkeypatch.delenv("SPARKNET_HEARTBEAT_DIR")
    p_health.maybe_beat(0, "init")        # no dir: a no-op


def test_prune_keeps_this_process_in_flight_temporaries(tmp_path):
    """Under a fleet the runner sets SPARKNET_FENCE_TOKEN: the main
    thread claims each round's fence through ``FENCE.json.tmp.<pid>``
    while the previous round's asynchronous write prunes the directory.
    The prune removes a dead writer's temporaries and never this
    process's (removing the fence's killed a driver on the card)."""
    from sparknet_tpu_torch.models import lenet
    from sparknet_tpu_torch.parallel import DistributedTrainer, TrainerConfig
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\n', lenet(4, 4))
    tr = DistributedTrainer(sp, 1, TrainerConfig(
        checkpoint_dir=str(tmp_path)), device="cpu")
    own = tmp_path / f"FENCE.json.tmp.{os.getpid()}"
    dead = tmp_path / "manifest_00000001.json.tmp.999999999"
    for p in (own, dead):
        p.write_text("{}")
    tr._prune_checkpoints(str(tmp_path))
    assert own.exists() and not dead.exists()
