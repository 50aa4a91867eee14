"""The port's fleet scheduler, its journal and status views, and the
rollout decision log against the JAX package's, on the CPU.

The scheduling scenarios of tests/test_fleet.py:69-502 (gang allocation,
quotas and fair share, starvation aging, priority preemption, the
non-preemptible, quarantine with its post-mortem, the requeue bound,
status) run on each package through fake runners and manual
``step()``s, with the same assertions.  ``JobSpec`` JSON round-trips
equal across the packages, each package's ``offline_status`` reads the
other's journal to the same document and ``format_status`` renders it
to the same text, and a rollout journal replays to the same
``status()`` in both.  The port's scheduler then runs real stub
subprocesses (no torch, no JAX): completion and journal replay, the
reaping of a dead scheduler's survivor, the pid identity check,
preemption and resume from the stub's checkpoint, and no orphan at the
end.  Every wait polls toward a deadline; nothing sleeps a fixed time
and then asserts.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import types

import pytest

from sparknet_tpu.parallel import fleet as j_fleet
from sparknet_tpu.parallel import registry as j_registry
from sparknet_tpu.parallel import rollout as j_rollout
from sparknet_tpu_torch.parallel import cluster
from sparknet_tpu_torch.parallel import fleet as p_fleet
from sparknet_tpu_torch.parallel import registry as p_registry
from sparknet_tpu_torch.parallel import resilience
from sparknet_tpu_torch.parallel import rollout as p_rollout
from sparknet_tpu_torch.tools import launch
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

PKGS = {"jax": j_fleet, "port": p_fleet}


@pytest.fixture(params=sorted(PKGS))
def F(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def until(cond, timeout=30.0, step=None):
    """Poll ``cond`` (calling ``step`` between polls) toward a deadline."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if step is not None:
            step()
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("condition never held")


# ---------------------------------------------------------------------------
# JobSpec and the gang allocator
# ---------------------------------------------------------------------------

SPEC = dict(name="j1", tenant="acme", priority=3, world=8, rounds=6,
            guard=True, fault="crash@round:2",
            cmd=("prog", "--out", "{out}", "--ck", "{ckpt}"),
            env={"K": "v"})


def test_jobspec_json_roundtrips_equal_across_packages():
    doc_j = j_fleet.JobSpec(**SPEC).to_json()
    doc_p = p_fleet.JobSpec(**SPEC).to_json()
    assert doc_p == doc_j
    wire = json.loads(json.dumps(doc_j))
    assert p_fleet.JobSpec.from_json(wire) == p_fleet.JobSpec(**SPEC)
    assert j_fleet.JobSpec.from_json(json.loads(json.dumps(doc_p))) == \
        j_fleet.JobSpec(**SPEC)
    serve = dict(name="serve-lenet-0", kind="serve", model="lenet",
                 world=1, timeout_s=None)
    assert p_fleet.JobSpec(**serve).to_json() == \
        j_fleet.JobSpec(**serve).to_json()


@pytest.mark.parametrize("kw,msg", [
    (dict(name="bad name"), "bad job name"),
    (dict(name="j", world=0), "world"),
    (dict(name="j", rounds=0), "rounds"),
    (dict(name="j", cmd=("prog", "--x")), "{out}"),
    (dict(name="j", model="resnet50"), "no built-in driver"),
    (dict(name="j", kind="batch"), "kind"),
])
def test_jobspec_validation(F, kw, msg):
    with pytest.raises(ValueError, match=msg):
        F.JobSpec(**kw)
    with pytest.raises(ValueError, match="unknown JobSpec field"):
        F.JobSpec.from_json({"name": "j", "wrold": 4})


def test_gang_allocator_all_or_nothing(F):
    a = F.GangAllocator(8)
    g1 = a.allocate(5)
    assert len(g1) == 5 and a.free_count == 3
    assert a.allocate(4) is None and a.free_count == 3
    g2 = a.allocate(3)
    a.free(g1)
    assert a.free_count == 5 and a.allocate(5) is not None
    with pytest.raises(Exception):
        a.free(g2 + g2)
    pool = F.HostPool.parse("a=2,b=2")
    b = F.GangAllocator(pool=pool)
    assert b.hosts_of(b.allocate(3)) == ("a", "b")


def test_built_in_commands_launch_the_port_on_the_device(tmp_path):
    serve = p_fleet.FleetJob(p_fleet.JobSpec(
        name="serve-lenet-0", kind="serve", model="lenet", world=1),
        str(tmp_path / "s"), 0, 0.0)
    cmd = serve.build_cmd("cpu")
    assert cmd[:len(p_fleet.SERVE_CMD)] == p_fleet.SERVE_CMD
    assert "sparknet_tpu_torch.tools.serve" in cmd
    assert cmd[cmd.index("--endpoint-file") + 1] == serve.endpoint_path
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert serve.completed_ok() is False
    train = p_fleet.FleetJob(p_fleet.JobSpec(name="t", world=2),
                             str(tmp_path / "t"), 0, 0.0)
    cmd = train.build_cmd("cuda")
    assert cmd[:len(p_fleet.DRIVER_CMD)] == p_fleet.DRIVER_CMD
    assert cmd[cmd.index("--local-devices") + 1] == "2"
    assert cmd[cmd.index("--device") + 1] == "cuda"
    stub = p_fleet.FleetJob(p_fleet.JobSpec(
        name="x", cmd=("p", "{out}", "{device}")), str(tmp_path / "x"),
        0, 0.0)
    assert stub.build_cmd("cpu")[2] == "cpu"


# ---------------------------------------------------------------------------
# The scheduling core on each package (fake runners, manual steps)
# ---------------------------------------------------------------------------

class FakeRunner:
    """Blocks until released, then returns: "complete" writes the
    artifact (rc 0), "stop" returns 0 without it, ("fail", n) returns
    n."""

    def __init__(self, job, behavior):
        self.job = job
        self.behavior = behavior
        self.release = threading.Event()
        self.canceled = False
        self.failure = None
        self.workdir = os.path.join(job.job_dir, "runner")

    def cancel(self):
        self.canceled = True
        self.release.set()

    def run(self):
        assert self.release.wait(timeout=60), "fake runner never released"
        b = self.behavior
        if b == "complete" and not self.canceled:
            with open(self.job.out_path, "w") as f:
                f.write("done")
            return 0
        if isinstance(b, tuple) and b[0] == "fail" and not self.canceled:
            return b[1]
        return 0


class FakeFleet:
    def __init__(self, F, tmp_path, devices=8, **kw):
        self.F = F
        self.behaviors = {}
        self.runners = {}

        def factory(job, cmd, env):
            r = FakeRunner(job, self.behaviors.get(job.name, "complete"))
            self.runners.setdefault(job.name, []).append(r)
            return r

        self.sched = F.FleetScheduler(str(tmp_path / "fleet"), devices,
                                      runner_factory=factory, **kw)

    def submit(self, behavior="complete", **kw):
        self.behaviors[kw["name"]] = behavior
        return self.sched.submit(self.F.JobSpec(**kw))

    def release(self, name):
        self.runners[name][-1].release.set()

    def settle(self, cond, timeout=30.0):
        until(cond, timeout, step=self.sched.step)


def test_gang_scheduling_and_quota(F, tmp_path):
    f = FakeFleet(F, tmp_path, devices=8, tenants={"acme": 4})
    a1 = f.submit(name="a1", tenant="acme", world=4)
    a2 = f.submit(name="a2", tenant="acme", world=4)
    b1 = f.submit(name="b1", tenant="beta", world=4)
    f.sched.step()
    assert (a1.state, a2.state, b1.state) == (F.RUNNING, F.QUEUED,
                                              F.RUNNING)
    assert f.sched.allocator.free_count == 0
    f.release("a1")
    f.settle(lambda: a1.state == F.COMPLETED and a2.state == F.RUNNING)
    f.release("a2")
    f.release("b1")
    f.settle(f.sched.done)
    assert {j.state for j in f.sched.jobs.values()} == {F.COMPLETED}


def test_fair_share_decides_placement_under_contention(F, tmp_path):
    f = FakeFleet(F, tmp_path, devices=8, tenants={"acme": 8, "beta": 8})
    f.submit(name="hold", tenant="acme", world=4)
    f.sched.step()
    qa = f.submit(name="qa", tenant="acme", world=4)
    qb = f.submit(name="qb", tenant="beta", world=4)
    qa2 = f.submit(name="qa2", tenant="acme", world=4)
    assert sorted([qa2, qa], key=f.sched._rank_key)[0] is qa   # FIFO
    f.sched.step()
    assert qb.state == F.RUNNING and qa.state == F.QUEUED
    for name in ("hold", "qb"):
        f.release(name)
    f.settle(lambda: qa.state == F.RUNNING)
    f.release("qa")
    f.settle(lambda: qa2.state == F.RUNNING)
    f.release("qa2")
    f.settle(f.sched.done)


def test_starvation_aging_reorders_but_never_preempts(F, tmp_path):
    now = [0.0]
    f = FakeFleet(F, tmp_path, devices=4, aging_rate=1.0,
                  clock=lambda: now[0])
    hi = f.submit(name="hi", priority=5, world=4)
    low = f.submit(name="low", priority=0, world=4)
    f.sched.step()
    now[0] = 100.0
    assert f.sched.effective_priority(low) == pytest.approx(100.0)
    f.sched.step()
    assert hi.state == F.RUNNING and low.state == F.QUEUED
    mid = f.submit(name="mid", priority=0, world=4)
    assert sorted([low, mid], key=f.sched._rank_key)[0] is low
    f.release("hi")
    f.settle(lambda: low.state == F.RUNNING)
    f.release("low")
    f.settle(lambda: mid.state == F.RUNNING)
    f.release("mid")
    f.settle(f.sched.done)


def test_priority_preemption_frees_the_gang(F, tmp_path):
    f = FakeFleet(F, tmp_path, devices=8, preempt_grace_s=30)
    v1 = f.submit(name="v1", priority=0, world=4)
    v2 = f.submit(name="v2", priority=1, world=4)
    f.sched.step()
    urgent = f.submit(name="urgent", priority=50, world=8)
    f.sched.step()
    assert v1.state == F.PREEMPTING and v2.state == F.PREEMPTING
    f.settle(lambda: v1.state == F.QUEUED and v2.state == F.QUEUED
             and urgent.state == F.RUNNING)
    assert v1.preempt_count == 1
    f.release("urgent")
    f.settle(lambda: v1.state == F.RUNNING and v2.state == F.RUNNING)
    f.release("v1")
    f.release("v2")
    f.settle(f.sched.done)
    assert v1.state == F.COMPLETED and v2.state == F.COMPLETED


def test_no_preemption_of_equal_priority_or_the_pinned(F, tmp_path):
    f = FakeFleet(F, tmp_path, devices=4, preempt_grace_s=30)
    v = f.submit(name="v", priority=5, world=4, preemptible=False)
    f.sched.step()
    peer = f.submit(name="peer", priority=5, world=4)
    urgent = f.submit(name="urgent", priority=99, world=4)
    f.sched.step()
    f.sched.step()
    assert v.state == F.RUNNING
    assert peer.state == F.QUEUED and urgent.state == F.QUEUED
    f.release("v")
    f.settle(lambda: urgent.state == F.RUNNING)
    f.release("urgent")
    f.settle(lambda: peer.state == F.RUNNING)
    f.release("peer")
    f.settle(f.sched.done)


def test_quarantine_writes_postmortem_and_reoffers_gang(F, tmp_path):
    f = FakeFleet(F, tmp_path, devices=4)
    bad = f.submit(name="bad", world=4, behavior=("fail", 7))
    good = f.submit(name="good", world=4)
    f.sched.step()
    f.release("bad")
    f.settle(lambda: bad.state == F.QUARANTINED
             and good.state == F.RUNNING)
    post = json.load(open(os.path.join(bad.job_dir, "postmortem.json")))
    assert post["rc"] == 7 and post["job"] == "bad"
    kinds = [e["kind"] for e in post["flight_recorder"]]
    assert "fleet_quarantine" in kinds and "fleet_launch" in kinds
    f.release("good")
    f.settle(f.sched.done)
    assert f.sched.run(tick_s=0.01) == 3


def test_clean_stop_without_artifact_requeues_then_bounds(F, tmp_path):
    f = FakeFleet(F, tmp_path, devices=4, max_preempts=2)
    j = f.submit(name="stopper", world=4, behavior="stop")
    released = set()

    def step():
        f.sched.step()
        runners = f.runners.get("stopper", [])
        if runners and runners[-1] not in released and \
                j.state == F.RUNNING:
            released.add(runners[-1])
            runners[-1].release.set()

    until(lambda: j.state == F.QUARANTINED, 30.0, step=step)
    assert j.preempt_count == 3
    post = json.load(open(os.path.join(j.job_dir, "postmortem.json")))
    assert "requeue loop" in post["reason"]
    with pytest.raises(Exception, match="duplicate"):
        f.submit(name="stopper", world=1)
    with pytest.raises(Exception, match="never be placed"):
        f.submit(name="huge", world=8)


def _scenario(F, tmp_path) -> str:
    """Preemption, a quarantine and a completion on one package's
    scheduler; returns its workdir (journal + job dirs)."""
    f = FakeFleet(F, tmp_path, devices=8, tenants={"acme": 8},
                  preempt_grace_s=30)
    f.submit(name="v1", tenant="acme", priority=0, world=4)
    bad = f.submit(name="bad", tenant="beta", priority=1, world=4,
                   behavior=("fail", 7))
    f.sched.step()
    f.release("bad")
    f.settle(lambda: bad.state == F.QUARANTINED)
    urgent = f.submit(name="urgent", tenant="ops", priority=50, world=8)
    f.settle(lambda: urgent.state == F.RUNNING)
    assert f.sched.jobs["v1"].preempt_count == 1
    f.release("urgent")
    f.settle(lambda: f.sched.jobs["v1"].state == F.RUNNING)
    f.submit(name="late", tenant="acme", world=2)
    f.settle(lambda: f.sched.jobs["late"].state == F.RUNNING)
    f.release("v1")
    f.settle(lambda: f.sched.jobs["v1"].state == F.COMPLETED)
    f.sched.journal.close()
    return str(tmp_path / "fleet")


def test_each_package_reads_the_others_journal(tmp_path, monkeypatch):
    """``offline_status`` of either package on either package's journal
    gives the same document, and ``format_status`` the same text."""
    dirs = {}
    for name, F in PKGS.items():
        (tmp_path / name).mkdir()
        dirs[name] = _scenario(F, tmp_path / name)
    monkeypatch.setattr(time, "time", lambda: 2_000_000_000.0)
    for name, wd in dirs.items():
        want = j_fleet.offline_status(wd)
        got = p_fleet.offline_status(wd)
        assert got == want, name
        assert p_fleet.format_status(got) == j_fleet.format_status(want)
        assert {r["job"]: r["state"] for r in got["jobs"]} == {
            "v1": "COMPLETED", "bad": "QUARANTINED", "urgent": "COMPLETED",
            "late": "RUNNING"}
    # the journals themselves carry the same records and field names
    shape = {}
    for name, wd in dirs.items():
        shape[name] = [(e["ev"], sorted(e)) for e in p_fleet.FleetJournal
                       .read(os.path.join(wd, "fleet_journal.jsonl"))
                       if e["ev"] != "launch"]
    assert shape["port"] == shape["jax"]


def test_a_rollout_journal_replays_to_the_same_status(tmp_path):
    for name, reg_mod, ro in (("jax", j_registry, j_rollout),
                              ("port", p_registry, p_rollout)):
        d = tmp_path / name
        reg = reg_mod.ModelRegistry(str(d / "registry"))
        a = reg.publish("demo", notes="a")
        b = reg.publish("demo", notes="b")
        c = reg.publish("demo", notes="c")
        reg.set_channels("demo", stable=a)
        up = set()
        ctl = ro.RolloutController(
            reg, str(d), ensure=up.add, retire=up.discard,
            verdict=lambda n: None,
            cfg=ro.RolloutConfig(fraction=0.25, judge_s=0.01, poll_s=0.01,
                                 min_requests=1, breach_polls=1))
        ctl.start_canary("demo", b)
        ctl.promote("demo")
        ctl.start_canary("demo", c)
        ctl.rollback("demo", reason="planted")
    for name in ("jax", "port"):
        wd = str(tmp_path / name)
        want = j_rollout.status(wd)
        assert p_rollout.status(wd) == want
        assert want["demo"]["last_rollback_reason"] == "planted"
        assert want["demo"]["canary"] is None


# ---------------------------------------------------------------------------
# The port's scheduler over real stub processes
# ---------------------------------------------------------------------------

STUB = (
    "import os, signal, sys, time\n"
    "state, rounds, tick, out = (sys.argv[1], int(sys.argv[2]),\n"
    "                            float(sys.argv[3]), sys.argv[4])\n"
    "stop = []\n"
    "signal.signal(signal.SIGTERM, lambda *a: stop.append(1))\n"
    "r = int(open(state).read()) if os.path.exists(state) else 0\n"
    "while r < rounds:\n"
    "    if stop:\n"
    "        sys.exit(0)\n"
    "    time.sleep(tick)\n"
    "    r += 1\n"
    "    with open(state + '.tmp', 'w') as f:\n"
    "        f.write(str(r))\n"
    "    os.replace(state + '.tmp', state)\n"
    "with open(out, 'w') as f:\n"
    "    f.write('done')\n")


def _stub_spec(tmp_path, name, rounds=10, tick=0.02, **kw):
    path = tmp_path / "stub.py"
    path.write_text(STUB)
    return p_fleet.JobSpec(
        name=name, rounds=rounds,
        cmd=(sys.executable, str(path), "{ckpt}/state.txt", "{rounds}",
             str(tick), "{out}"), **kw)


def _round(job) -> int:
    try:
        return int(open(os.path.join(job.ckpt_dir, "state.txt")).read())
    except (OSError, ValueError):
        return 0


def test_stub_fleet_completes_and_journal_replays(tmp_path):
    wd = str(tmp_path / "fleet")
    fleet = p_fleet.FleetScheduler(wd, 4, preempt_grace_s=5,
                                   device="cpu")
    fleet.submit(_stub_spec(tmp_path, "s1", world=2))
    fleet.submit(_stub_spec(tmp_path, "s2", world=2))
    assert fleet.run(tick_s=0.02, timeout_s=120) == 0
    events = [e["ev"] for e in p_fleet.FleetJournal.read(
        os.path.join(wd, "fleet_journal.jsonl"))]
    for ev in ("fleet", "submit", "launch", "pids", "exit", "complete",
               "done"):
        assert ev in events

    def exploding_factory(job, cmd, env):
        raise AssertionError(f"double launch of {job.name}!")

    again = p_fleet.FleetScheduler.resume(
        wd, runner_factory=exploding_factory, device="cpu")
    assert all(j.state == p_fleet.COMPLETED for j in again.jobs.values())
    assert again.run(tick_s=0.01) == 0
    assert j_fleet.offline_status(wd)["jobs"] == \
        p_fleet.offline_status(wd)["jobs"]


def test_resume_reaps_survivor_and_requeues(tmp_path):
    wd = str(tmp_path / "fleet")
    spec = _stub_spec(tmp_path, "lone", rounds=40, tick=0.01, world=2)
    sched = p_fleet.FleetScheduler(wd, 4, device="cpu")
    job = sched.submit(spec)
    os.makedirs(job.ckpt_dir, exist_ok=True)
    proc = subprocess.Popen(
        [c.format(out=job.out_path, ckpt=job.ckpt_dir, world="2",
                  rounds="100000") for c in spec.cmd],
        env={**os.environ, p_fleet.ENV_JOB_TAG: "lone"})
    sched.journal.append("launch", job="lone", episode=1, slots=[0, 1])
    sched.journal.append("pids", job="lone", pids=[proc.pid])
    sched.journal.close()
    until(lambda: p_fleet._pid_is_fleet_job(proc.pid, "lone")
          and _round(job) >= 2)
    fleet = p_fleet.FleetScheduler.resume(wd, device="cpu")
    assert proc.wait(timeout=20) is not None
    job2 = fleet.jobs["lone"]
    assert job2.state == p_fleet.QUEUED
    resumed_from = _round(job2)
    assert resumed_from >= 2
    assert fleet.run(tick_s=0.02, timeout_s=120) == 0
    assert job2.completed_ok() and _round(job2) == 40
    assert fleet.live_worker_pids() == {}


def test_pid_identity_check_never_kills_strangers(tmp_path):
    stranger = subprocess.Popen([sys.executable, "-c",
                                 "import time; time.sleep(60)"])
    try:
        assert not p_fleet._pid_is_fleet_job(stranger.pid, "anyjob")
        wd = str(tmp_path / "fleet")
        sched = p_fleet.FleetScheduler(wd, 4, device="cpu")
        sched.submit(_stub_spec(tmp_path, "ghost", rounds=1, world=1))
        sched.journal.append("pids", job="ghost", pids=[stranger.pid])
        sched.journal.close()
        fleet = p_fleet.FleetScheduler.resume(wd, device="cpu")
        assert fleet.run(tick_s=0.02, timeout_s=120) == 0
        assert stranger.poll() is None          # untouched
    finally:
        stranger.kill()
        stranger.wait()


def test_stub_preempt_resume_e2e(tmp_path):
    """A higher-priority arrival preempts a running stub (SIGTERM: the
    stub keeps its state file and exits 0); the fleet requeues it and
    it resumes from that state, losing nothing.  The arrival is
    submitted once the victim has made progress, not after a fixed
    delay."""
    wd = str(tmp_path / "fleet")
    fleet = p_fleet.FleetScheduler(wd, 4, preempt_grace_s=10,
                                   device="cpu")
    victim = fleet.submit(_stub_spec(tmp_path, "victim", rounds=300,
                                     tick=0.01, world=4, priority=0))
    until(lambda: _round(victim) >= 3, 60.0, step=fleet.step)
    urgent = fleet.submit(_stub_spec(tmp_path, "urgent", rounds=5,
                                     tick=0.01, world=4, priority=50))
    until(lambda: urgent.state == p_fleet.RUNNING, 60.0, step=fleet.step)
    at_preempt = _round(victim)
    assert victim.state == p_fleet.QUEUED and victim.preempt_count == 1
    assert fleet.run(tick_s=0.02, timeout_s=120) == 0
    assert victim.state == p_fleet.COMPLETED
    assert urgent.state == p_fleet.COMPLETED
    assert _round(victim) == 300 and at_preempt >= 3
    assert fleet.live_worker_pids() == {}


# ---------------------------------------------------------------------------
# The launcher, the runner and the pod-half refusals
# ---------------------------------------------------------------------------

def test_launch_local_sets_the_contract_and_on_spawn(tmp_path):
    seen, report = [], {}
    code = ("import os, sys\n"
            "sys.exit(0 if os.environ['SPARKNET_NUM_PROCS'] == '1' and "
            "sys.argv[1:] == ['--device', 'cpu', '--local-devices', '3'] "
            "else 9)\n")
    rc = launch.launch_local([sys.executable, "-c", code], 1,
                             device="cpu", local_devices=3, timeout=60,
                             on_spawn=seen.append, report=report)
    assert rc == 0 and len(seen) == 1 and report["cause"] == "clean"
    rc = launch.launch_local(
        [sys.executable, "-c", "import sys; sys.exit(5)"], 2, timeout=60,
        report=report)
    assert rc == 5 and report["cause"] == "exit"


def test_runner_restarts_then_recovers_and_cancel_stops(tmp_path):
    flag = tmp_path / "once"
    code = ("import os, sys\n"
            f"p = {str(flag)!r}\n"
            "if not os.path.exists(p):\n"
            "    open(p, 'w').close(); sys.exit(3)\n")
    r = resilience.ResilientRunner(
        [sys.executable, "-c", code], nprocs=1, timeout=60,
        policy=resilience.RestartPolicy(max_restarts=2, backoff_base=0.0,
                                        jitter=0.0),
        workdir=str(tmp_path / "w"))
    assert r.run() == 0 and [a.returncode for a in r.attempts] == [3, 0]
    r2 = resilience.ResilientRunner(
        [sys.executable, "-c", "import sys; sys.exit(4)"], nprocs=1,
        timeout=60, policy=resilience.RestartPolicy(max_restarts=5,
                                                    backoff_base=0.0),
        workdir=str(tmp_path / "w2"), sleep=lambda s: r2.cancel())
    with pytest.raises(resilience.ResilienceError, match="canceled"):
        r2.run_or_raise()
    assert len(r2.attempts) == 1


def test_the_pod_half_raises_by_name(monkeypatch, tmp_path):
    """What is left of the pod half (a world of several processes,
    order 3) raises by name; its hosts-and-network part is ported: a
    remote address or SPARKNET_SSH_CMD places over a host transport
    (tests/test_torch_transport.py runs them)."""
    from sparknet_tpu_torch.parallel import transport
    monkeypatch.delenv("SPARKNET_SSH_CMD", raising=False)
    r = resilience.ResilientRunner(["true"], hosts=["h1"])
    assert r.hosts == ["h1"] and r.world_size() == 1
    pool = p_fleet.HostPool.parse("a=2@10.0.0.2")
    sched = p_fleet.FleetScheduler(str(tmp_path / "f"), hosts=pool)
    job = sched.submit(p_fleet.JobSpec(name="j", world=2))
    job.hosts = ("a",)
    assert sched._job_transport(job).kind == "ssh"
    monkeypatch.setenv("SPARKNET_SSH_CMD", "/bin/false")
    assert isinstance(transport.default_transport(["127.0.0.1"]),
                      transport.SshTransport)
    p_fleet.FleetScheduler(str(tmp_path / "g"), 2)
    monkeypatch.delenv("SPARKNET_SSH_CMD")
    assert launch.launch_ssh([sys.executable, "-c", "pass"],
                             ["127.0.0.1"], timeout=60) == 0
    monkeypatch.setenv("SPARKNET_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SPARKNET_PROC_ID", "0")
    monkeypatch.setenv("SPARKNET_NUM_PROCS", "1")
    assert cluster.init_cluster_from_env() is True
    assert cluster.local_batch_slice(16) == slice(0, 16)
    monkeypatch.setenv("SPARKNET_NUM_PROCS", "2")
    with pytest.raises(NotImplementedError, match="ROADMAP A12, pod half"):
        cluster.init_cluster_from_env()
    monkeypatch.delenv("SPARKNET_COORDINATOR")
    with pytest.raises(ValueError, match="SPARKNET_COORDINATOR"):
        cluster.init_cluster_from_env()


def test_local_hosts_place_gangs_and_mark_host(tmp_path):
    pool = p_fleet.HostPool.parse("a=2,b=2")
    f = types.SimpleNamespace(runners={})

    def factory(job, cmd, env):
        r = FakeRunner(job, "complete")
        f.runners.setdefault(job.name, []).append(r)
        return r

    sched = p_fleet.FleetScheduler(str(tmp_path / "f"), hosts=pool,
                                   runner_factory=factory, device="cpu")
    j1 = sched.submit(p_fleet.JobSpec(name="j1", world=2))
    sched.step()
    assert j1.state == p_fleet.RUNNING and len(j1.hosts) == 1
    first = j1.hosts[0]
    sched.mark_host(first, p_fleet.HOST_DRAINING)
    until(lambda: j1.state == p_fleet.RUNNING
          and f.runners["j1"][-1] is not f.runners["j1"][0],
          30.0, step=sched.step)
    # evicted from the draining host, requeued onto the other one
    assert j1.preempt_count == 1 and first not in j1.hosts
    f.runners["j1"][-1].release.set()
    until(sched.done, 30.0, step=sched.step)
    view = p_fleet.offline_status(str(tmp_path / "f"))
    assert {h: r["state"] for h, r in view["hosts"].items()} == {
        first: "draining", ({"a", "b"} - {first}).pop(): "live"}
    assert view == j_fleet.offline_status(str(tmp_path / "f"))
