"""The port's host transport (``parallel/transport.py``) and what rides
on it, against the JAX package's, on the CPU.

The 15 cases of tests/test_transport.py run on the port: the ssh wire
format and env contract of ``launch_ssh`` under a fake-ssh shim, teardown
on the first death, the lease states, partition-suspend-heal and the
down-probe's escalation, the torn-prefix resume, chaos drops and torn
ships, the partitioned refusal, ``ship_latest_checkpoint`` (newest valid,
empty source), the fence and the zombie refused at the manifest rename,
and the hosts view's lease and transport columns.  Then parity with the
JAX package: ``_verified_copy`` and ``ship_latest_checkpoint`` give the
same records on the same files, and ``SshTransport.popen`` hands ssh the
same remote string.  Then the remote placements, each over the shim: a
rank launched over ssh gets ``--device`` on its command line,
``ResilientRunner(hosts=["127.0.0.1"])`` restarts a crashed lenet driver
that then finishes bit for bit a clean run, and a ``FleetScheduler`` job
on a ``HostPool`` host at 127.0.0.1, requeued onto a checkpoint-less host,
resumes from a shipped checkpoint bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from sparknet_tpu.parallel import transport as j_transport
from sparknet_tpu.utils import faults as j_faults
from sparknet_tpu_torch.parallel import fleet as p_fleet
from sparknet_tpu_torch.parallel import health
from sparknet_tpu_torch.parallel import transport as p_transport
from sparknet_tpu_torch.parallel.resilience import (ResilientRunner,
                                                    RestartPolicy)
from sparknet_tpu_torch.tools.launch import launch_local, launch_ssh
from sparknet_tpu_torch.utils import faults
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = [sys.executable, "-m", "sparknet_tpu_torch.tools.multihost_driver"]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("SPARKNET_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p))
    faults.reset_injector()
    yield
    faults.reset_injector()


def _make_shim(tmp_path):
    """The fake-ssh shim: logs the exact wire argv, then runs the remote
    command string locally (argv[4] is the ``cd .. && env .. cmd``
    string, what sshd hands the remote shell)."""
    log = tmp_path / "ssh.log"
    shim = tmp_path / "fake-ssh"
    shim.write_text("#!/bin/bash\n"
                    f"echo \"ARGS:$*\" >> {log}\n"
                    "exec bash -c \"$4\"\n")
    shim.chmod(0o755)
    return shim, log


def _wire_lines(log):
    return [line for line in log.read_text().strip().splitlines()
            if line.startswith("ARGS:")]


# -- ssh wire format / env contract ---------------------------------------

def test_launch_ssh_wire_format_and_env_contract(tmp_path, monkeypatch):
    shim, log = _make_shim(tmp_path)
    monkeypatch.setenv("SPARKNET_SSH_CMD", str(shim))
    out = tmp_path / "out"
    out.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import json, os\n"
        "keys = ['SPARKNET_COORDINATOR', 'SPARKNET_NUM_PROCS',\n"
        "        'SPARKNET_PROC_ID', 'SPARKNET_FLEET_HOST', 'WIRE_EXTRA']\n"
        "rec = {k: os.environ.get(k) for k in keys}\n"
        "dst = os.path.join(os.environ['WIRE_OUT'],\n"
        "                   os.environ['SPARKNET_PROC_ID'] + '.json')\n"
        "with open(dst, 'w') as f:\n"
        "    json.dump(rec, f)\n")
    report = {}
    rc = launch_ssh(
        [sys.executable, str(worker)], hosts=["hosta", "hostb"],
        cwd=str(tmp_path), timeout=120, report=report,
        extra_env={"WIRE_OUT": str(out), "WIRE_EXTRA": "rode-the-wire"})
    assert rc == 0, f"fake-ssh launch failed rc={rc}"
    assert report["transport"] == "ssh"
    args = _wire_lines(log)
    assert len(args) == 2
    assert any(" hosta " in a for a in args)
    assert any(" hostb " in a for a in args)
    for a in args:
        assert "-o BatchMode=yes" in a
        assert f"cd {tmp_path}" in a
        assert "SPARKNET_COORDINATOR=" in a
        assert "SPARKNET_NUM_PROCS='2'" in a
    for pid, host in ((0, "hosta"), (1, "hostb")):
        with open(out / f"{pid}.json") as f:
            rec = json.load(f)
        assert rec["SPARKNET_PROC_ID"] == str(pid)
        assert rec["SPARKNET_NUM_PROCS"] == "2"
        assert rec["SPARKNET_FLEET_HOST"] == host
        assert rec["SPARKNET_COORDINATOR"].startswith("hosta:")
        assert rec["WIRE_EXTRA"] == "rode-the-wire"


def test_launch_ssh_teardown_on_first_death(tmp_path, monkeypatch):
    shim, _ = _make_shim(tmp_path)
    monkeypatch.setenv("SPARKNET_SSH_CMD", str(shim))
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import os, sys, time\n"
        "if os.environ.get('SPARKNET_PROC_ID') == '1':\n"
        "    sys.exit(3)\n"
        "time.sleep(300)\n")
    report = {}
    t0 = time.monotonic()
    rc = launch_ssh([sys.executable, str(worker)],
                    hosts=["hosta", "hostb"], cwd=str(tmp_path),
                    timeout=120, report=report)
    elapsed = time.monotonic() - t0
    assert rc == 3, f"remote exit code must surface verbatim, got {rc}"
    assert elapsed < 60, f"teardown took {elapsed:.0f}s"
    assert report["cause"] == "exit"
    assert report["first_failure"] == 1


def test_launch_ssh_puts_the_device_on_the_remote_command_line(
        tmp_path, monkeypatch):
    """The JAX remote branch carves no device; the port's puts
    ``--device``/``--local-devices`` on every rank's argv, so a driver
    launched over ssh runs where the caller said."""
    shim, log = _make_shim(tmp_path)
    monkeypatch.setenv("SPARKNET_SSH_CMD", str(shim))
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import json, sys\n"
        f"json.dump(sys.argv[1:], open({str(tmp_path / 'argv.json')!r}, "
        "'w'))\n")
    rc = launch_ssh([sys.executable, str(worker)], hosts=["127.0.0.1"],
                    cwd=str(tmp_path), timeout=120, device="cpu",
                    local_devices=2)
    assert rc == 0
    assert json.loads((tmp_path / "argv.json").read_text()) == [
        "--device", "cpu", "--local-devices", "2"]
    (wire,) = _wire_lines(log)
    assert wire.endswith(" --device cpu --local-devices 2")


# -- lease-based liveness -------------------------------------------------

def test_lease_monitor_states(tmp_path):
    root = str(tmp_path / "hb")
    t = {"now": 1000.0}
    health.write_beat(health.host_dir(root, "a"), 0, 5, "round_start",
                      clock=lambda: t["now"])
    mon = health.LeaseMonitor(root, lease_s=1.0, misses=2,
                              clock=lambda: t["now"])
    assert mon.state("a") == health.LEASE_LIVE
    assert mon.state("never-beat") == health.LEASE_NO_BEATS
    t["now"] = 1003.0   # 3s silence > 1.0 x 2 window
    assert mon.state("a") == health.LEASE_SUSPECT
    assert mon.states(["a", "b"]) == {"a": health.LEASE_SUSPECT,
                                      "b": health.LEASE_NO_BEATS}


class _StubInjector:
    """The three hooks ChaosTransport consumes, programmable."""

    def __init__(self, drop_seqs=(), torn_count=0):
        self.drop_seqs = set(drop_seqs)
        self.torn_left = torn_count
        self.specs = []

    def net_specs(self):
        return []

    def drop_ship(self, seq):
        return seq in self.drop_seqs

    def torn_ship(self):
        if self.torn_left > 0:
            self.torn_left -= 1
            return True
        return False


def test_gang_health_partition_suspends_then_heals(tmp_path):
    root = str(tmp_path / "hb")
    t = {"now": 1000.0}
    clk = lambda: t["now"]  # noqa: E731
    chaos = p_transport.ChaosTransport(p_transport.SshTransport(),
                                       injector=_StubInjector())
    lease = health.LeaseMonitor(root, lease_s=1.0, misses=2, clock=clk)
    gh = health.GangHealth(root, 5.0, host_map=["a", "b"],
                           transport=chaos, lease=lease, clock=clk)

    def beat(rank, host):
        health.write_beat(health.stage_dir(root, host), rank, 1,
                          "round_start", clock=clk)

    beat(0, "a")
    beat(1, "b")
    assert gh.check([0, 1]) == []
    assert gh.suspect_hosts == set()
    chaos.partition("b")
    t["now"] = 1003.0
    beat(0, "a")
    assert gh.check([0, 1]) == []
    assert gh.suspect_hosts == {"b"}
    # deep into straggler territory (7s > 5s deadline): rank 1 is
    # shielded by the suspension
    t["now"] = 1007.0
    beat(0, "a")
    assert gh.check([0, 1]) == []
    chaos.heal("b")
    beat(1, "b")
    beat(0, "a")
    assert gh.check([0, 1]) == []
    assert gh.suspect_hosts == set()
    assert gh.ever_suspect == {"b"}


def test_gang_health_down_probe_escalates_to_kill(tmp_path):
    root = str(tmp_path / "hb")
    t = {"now": 1000.0}
    clk = lambda: t["now"]  # noqa: E731
    chaos = p_transport.ChaosTransport(p_transport.SshTransport(),
                                       injector=_StubInjector())
    lease = health.LeaseMonitor(root, lease_s=1.0, misses=2, clock=clk)
    gh = health.GangHealth(root, 5.0, host_map=["a", "b"],
                           transport=chaos, lease=lease, clock=clk,
                           down_probe=lambda h: h == "b")
    health.write_beat(health.stage_dir(root, "a"), 0, 1, "round_start",
                      clock=clk)
    health.write_beat(health.stage_dir(root, "b"), 1, 1, "round_start",
                      clock=clk)
    assert gh.check([0, 1]) == []
    chaos.partition("b")
    t["now"] = 1007.0   # past the lease window and the round deadline
    health.write_beat(health.stage_dir(root, "a"), 0, 1, "round_start",
                      clock=clk)
    assert gh.check([0, 1]) == [1]
    assert gh.confirmed_down == {"b"}
    assert gh.suspect_hosts == set()


# -- verified, resumable shipping -----------------------------------------

DATA = bytes(range(256)) * 20   # 5120 bytes = 5 x 1024-byte chunks


def test_verified_copy_resumes_torn_prefix(tmp_path):
    src = tmp_path / "blob.bin"
    src.write_bytes(DATA)
    dst = tmp_path / "landed" / "blob.bin"
    # a torn earlier transfer: two good chunks and a corrupt partial tail
    os.makedirs(dst.parent)
    (dst.parent / "blob.bin.tmp.ship").write_bytes(
        DATA[:2048] + b"\xff" * 500)
    rec = p_transport._verified_copy(str(src), str(dst), chunk=1024)
    assert rec["resumed_bytes"] == 2048
    assert rec["bytes"] == len(DATA)
    assert dst.read_bytes() == DATA


def test_chaos_ship_drop_retries_then_lands(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_SHIP_RETRIES", "3")
    src = tmp_path / "a.bin"
    src.write_bytes(b"payload" * 512)
    dst = tmp_path / "remote" / "a.bin"
    chaos = p_transport.ChaosTransport(
        p_transport.LocalTransport(), injector=_StubInjector(drop_seqs={0}))
    rec = chaos.ship(str(src), "hostb", str(dst))
    assert rec["bytes"] == len(b"payload" * 512)
    assert dst.read_bytes() == src.read_bytes()


def test_chaos_torn_ship_resumes_on_retry(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_SHIP_RETRIES", "3")
    monkeypatch.setenv("SPARKNET_SHIP_CHUNK_MB", "0.0009765625")  # 1 KiB
    src = tmp_path / "a.bin"
    src.write_bytes(DATA)
    dst = tmp_path / "remote" / "a.bin"
    chaos = p_transport.ChaosTransport(
        p_transport.LocalTransport(), injector=_StubInjector(torn_count=1))
    rec = chaos.ship(str(src), "hostb", str(dst))
    assert rec["resumed_bytes"] == 2048   # the torn half, whole chunks
    assert dst.read_bytes() == DATA


def test_chaos_partitioned_ship_and_exec_refuse(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_SHIP_RETRIES", "2")
    src = tmp_path / "a.bin"
    src.write_bytes(b"x" * 100)
    chaos = p_transport.ChaosTransport(p_transport.LocalTransport(),
                                       injector=_StubInjector())
    chaos.partition("hostb")
    with pytest.raises(p_transport.PartitionedError):
        chaos.ship(str(src), "hostb", str(tmp_path / "dst" / "a.bin"))
    with pytest.raises(p_transport.PartitionedError):
        chaos.popen("hostb", ["true"], env_pairs=[])
    assert chaos.beat_sync("hostb", str(tmp_path), str(tmp_path)) == 0
    chaos.heal("hostb")
    chaos.popen("hostb", [sys.executable, "-c", "pass"],
                env_pairs=[]).wait(timeout=30)


# -- checkpoint shipping --------------------------------------------------

def _fake_ckpt(directory, round_idx, payload):
    os.makedirs(directory, exist_ok=True)
    name = f"ckpt_round_{round_idx:08d}.npz"
    path = os.path.join(directory, name)
    with open(path, "wb") as f:
        f.write(payload)
    man = {"file": name, "round": round_idx,
           "sha256": hashlib.sha256(payload).hexdigest()}
    with open(os.path.join(directory, f"manifest_{round_idx:08d}.json"),
              "w") as f:
        json.dump(man, f)
    return path


def test_ship_latest_checkpoint_picks_newest_valid(tmp_path):
    src = str(tmp_path / "src")
    dst = str(tmp_path / "dst")
    _fake_ckpt(src, 3, b"round-three" * 100)
    # round 7 is torn on the source: the manifest's sha no longer matches
    p7 = _fake_ckpt(src, 7, b"round-seven" * 100)
    with open(p7, "ab") as f:
        f.write(b"corruption")
    assert p_transport.newest_valid_round(src) == 3
    rec = p_transport.ship_latest_checkpoint(
        p_transport.LocalTransport(), "hostb", src, dst)
    assert rec["round"] == 3
    assert p_transport.newest_valid_round(dst) == 3
    again = p_transport.ship_latest_checkpoint(
        p_transport.LocalTransport(), "hostb", src, dst)
    assert again["skipped"] == "up to date"


def test_ship_latest_checkpoint_empty_source(tmp_path):
    assert p_transport.ship_latest_checkpoint(
        p_transport.LocalTransport(), "hostb", str(tmp_path / "nothing"),
        str(tmp_path / "dst")) is None


# -- incarnation fencing --------------------------------------------------

def test_fence_monotonic_advance_and_typed_refusal(tmp_path):
    from sparknet_tpu_torch.utils.checkpoint import (
        CheckpointError, CheckpointFencedError, advance_fence, check_fence,
        read_fence)
    d = str(tmp_path / "ckpt")
    assert read_fence(d) == 0
    assert advance_fence(d, 100001) == 100001
    check_fence(d, 100001)
    assert advance_fence(d, 200001) == 200001
    with pytest.raises(CheckpointFencedError) as ei:
        check_fence(d, 100001)
    assert ei.value.token == 100001
    assert ei.value.fence == 200001
    assert isinstance(ei.value, CheckpointError)
    with pytest.raises(CheckpointFencedError):
        advance_fence(d, 100001)
    assert read_fence(d) == 200001
    assert read_fence(str(tmp_path / "absent")) == 0


def _make_trainer(ckpt_dir, seed=0):
    from sparknet_tpu_torch.models import lenet
    from sparknet_tpu_torch.parallel import DistributedTrainer, TrainerConfig
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\n',
        lenet(16, 16))
    cfg = TrainerConfig(strategy="local_sgd", tau=2,
                        checkpoint_dir=str(ckpt_dir), checkpoint_every=1,
                        checkpoint_keep=3, async_checkpoint=False)
    return DistributedTrainer(sp, 4, cfg, seed=seed, device="cpu")


def _batch(r, batch=16):
    rng = np.random.default_rng(100 + r)
    return {"data": rng.normal(size=(2, batch, 1, 28, 28)).astype(np.float32),
            "label": rng.integers(0, 10, size=(2, batch)).astype(np.float32)}


def test_zombie_writer_refused_at_manifest_rename(tmp_path, monkeypatch):
    """A save whose incarnation is fenced off while its npz is in flight
    is refused at the manifest rename with a typed error and nothing new
    left behind; the successor resumes from the zombie's last good
    round."""
    import sparknet_tpu_torch.utils.checkpoint as ckpt_mod
    d = tmp_path / "ck"
    monkeypatch.setenv("SPARKNET_FENCE_TOKEN", "100001")
    tr = _make_trainer(d)
    tr.train_round(_batch(0))          # round 1 lands under token 100001
    w1 = tr.params["conv1"][0].detach().clone()
    real_save = ckpt_mod.save_checkpoint

    def racing_save(path, tree):
        real_save(path, tree)
        ckpt_mod.advance_fence(str(d), 200002)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", racing_save)
    with pytest.raises(ckpt_mod.CheckpointFencedError) as ei:
        tr.train_round(_batch(1))
    assert ei.value.token == 100001
    assert ei.value.fence == 200002
    monkeypatch.setattr(ckpt_mod, "save_checkpoint", real_save)
    leftovers = [n for n in os.listdir(d)
                 if "00000002" in n or ".tmp." in n]
    assert leftovers == []
    assert ckpt_mod.read_fence(str(d)) == 200002
    monkeypatch.setenv("SPARKNET_FENCE_TOKEN", "200002")
    tr2 = _make_trainer(d, seed=99)
    assert tr2.resumed is not None
    assert tr2.round == 1
    assert tr2.params["conv1"][0].equal(w1)


# -- status view columns --------------------------------------------------

def test_hosts_view_lease_and_transport_columns():
    pool = p_fleet.HostPool.from_spec("a=2,b=2,c=2")
    pool.mark("c", p_fleet.HOST_DRAINING)
    jobs = [{"job": "j1", "state": p_fleet.RUNNING, "slots": [0, 1],
             "hosts": ["a"]},
            {"job": "j2", "state": p_fleet.RUNNING, "slots": [2, 3],
             "hosts": ["b"]}]
    view = p_fleet.hosts_view(pool, jobs,
                              beat_ages={"a": 99.0, "b": 0.2},
                              transports={"a": "ssh", "b": "ssh"})
    assert view["a"]["lease"] == "suspect"     # 99s > default 6s window
    assert view["a"]["beat_age_s"] == 99.0
    assert view["a"]["transport"] == "ssh"
    assert view["b"]["lease"] == "live"
    assert view["c"]["lease"] == p_fleet.HOST_DRAINING
    assert view["c"]["transport"] == "local"


def test_mark_host_suspect_accepted(tmp_path):
    p_fleet.request_mark_host(str(tmp_path), "b", "suspect", by="test")
    with open(tmp_path / "host_control.jsonl") as f:
        rec = json.loads(f.read().strip())
    assert rec["state"] == "suspect"
    with pytest.raises(p_fleet.FleetError):
        p_fleet.request_mark_host(str(tmp_path), "b", "wedged")


# -- parity with the JAX package ------------------------------------------

@pytest.mark.parametrize("torn", [None, 2048 + 300, 5000])
def test_verified_copy_records_equal_the_jax_packages(tmp_path, torn):
    recs, landed = [], []
    for pkg, mod in (("jax", j_transport), ("port", p_transport)):
        src = tmp_path / pkg / "blob.bin"
        os.makedirs(src.parent)
        src.write_bytes(DATA)
        dst = tmp_path / pkg / "landed" / "blob.bin"
        if torn is not None:
            os.makedirs(dst.parent)
            bad = bytearray(DATA[:torn])
            bad[-1] ^= 0xFF     # the tail chunk of the prefix is torn
            (dst.parent / "blob.bin.tmp.ship").write_bytes(bytes(bad))
        recs.append(mod._verified_copy(str(src), str(dst), chunk=1024))
        landed.append(dst.read_bytes())
    assert recs[0] == recs[1]
    assert landed[0] == landed[1] == DATA


def test_ship_latest_checkpoint_records_equal_the_jax_packages(
        tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_SHIP_CHUNK_MB", "0.0009765625")  # 1 KiB
    payload = bytes(np.random.default_rng(3).integers(0, 256, 7000,
                                                      dtype=np.uint8))
    out = {}
    for pkg, mod in (("jax", j_transport), ("port", p_transport)):
        src, dst = str(tmp_path / pkg / "src"), str(tmp_path / pkg / "dst")
        _fake_ckpt(src, 2, b"older" * 50)
        _fake_ckpt(src, 5, payload)
        os.makedirs(dst)
        # a torn earlier ship of the npz: 3 whole chunks and a half
        with open(os.path.join(dst, "ckpt_round_00000005.npz.tmp.ship"),
                  "wb") as f:
            f.write(payload[:3500])
        rec = mod.ship_latest_checkpoint(mod.LocalTransport(), "hostb",
                                         src, dst)
        again = mod.ship_latest_checkpoint(mod.LocalTransport(), "hostb",
                                           src, dst)
        rec.pop("wall_s")
        with open(os.path.join(dst, "ckpt_round_00000005.npz"), "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        out[pkg] = (rec, again, sha, sorted(os.listdir(dst)))
    assert out["jax"] == out["port"]
    assert out["port"][0]["resumed_bytes"] == 3072
    assert out["port"][2] == hashlib.sha256(payload).hexdigest()


def test_ssh_popen_hands_ssh_the_jax_remote_string(monkeypatch):
    seen = []

    class _Fake:
        def __init__(self, argv, **kwargs):
            seen.append(argv)

    monkeypatch.setattr(subprocess, "Popen", _Fake)
    cmd = [sys.executable, "-m", "sparknet_tpu_torch.tools.multihost_driver",
           "--out", "/tmp/o.npz", "--rounds", "3"]
    pairs = [("SPARKNET_PROC_ID", "0"), ("PYTHONPATH", "/a:/b"),
             ("SPARKNET_FAULT", "straggle:3.5s@round:1")]
    for mod in (j_transport, p_transport):
        mod.SshTransport("my-ssh").popen("hostb", cmd, env_pairs=pairs,
                                         cwd="/srv/w")
    assert seen[0] == seen[1]
    assert seen[1][:4] == ["my-ssh", "-o", "BatchMode=yes", "hostb"]


def test_default_transport_follows_the_env_as_the_jax_one(monkeypatch):
    for addrs, ssh, net in ((["127.0.0.1"], None, None),
                            (["10.0.0.2"], None, None),
                            (["localhost"], "/bin/fake", None),
                            (["local"], None, "partition@host:b")):
        for k, v in (("SPARKNET_SSH_CMD", ssh), ("SPARKNET_FAULT", net)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        kinds = []
        for mod, fmod in ((j_transport, j_faults), (p_transport, faults)):
            fmod.reset_injector()
            kinds.append(mod.default_transport(addrs).kind)
        assert kinds[0] == kinds[1], (addrs, ssh, net, kinds)


# -- remote placements over the shim --------------------------------------

def _params_equal(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    return [k for k in a.files if not k.startswith("__")
            and not np.array_equal(a[k], b[k])]


def _driver_args(out, rounds, ckpt=None):
    args = ["--strategy", "sync", "--out", out, "--rounds", str(rounds),
            "--local-devices", "2", "--expect-devices", "2"]
    return args + (["--ckpt-dir", ckpt] if ckpt else [])


def test_resilient_runner_over_ssh_restarts_a_crash_bit_for_bit(
        tmp_path, monkeypatch):
    """The port's counterpart of tests/test_resilience.py:1450: a lenet
    driver on "127.0.0.1" over the fake-ssh wire crashes at round 2, is
    relaunched over the wire and resumes from its checkpoint, and its
    params equal a clean run's bit for bit."""
    base = str(tmp_path / "base.npz")
    assert launch_local([*DRIVER, *_driver_args(base, 3)], 1,
                        device="cpu", timeout=240) == 0
    shim, log = _make_shim(tmp_path)
    monkeypatch.setenv("SPARKNET_SSH_CMD", str(shim))
    out = str(tmp_path / "out.npz")
    runner = ResilientRunner(
        [*DRIVER, *_driver_args(out, 3, str(tmp_path / "ck"))],
        hosts=["127.0.0.1"], device="cpu", cwd=ROOT, timeout=240,
        policy=RestartPolicy(max_restarts=2, backoff_base=0.0, jitter=0.0),
        workdir=str(tmp_path / "w"),
        extra_env={"SPARKNET_FAULT": "crash@round:2"})
    assert runner.run() == 0
    assert [a.returncode for a in runner.attempts][-1] == 0
    assert len(runner.attempts) == 2
    wire = _wire_lines(log)
    assert len(wire) == 2 and all("--device cpu" in w for w in wire)
    assert _params_equal(base, out) == []


def test_fleet_requeue_on_a_checkpointless_host_resumes_from_a_ship(
        tmp_path, monkeypatch):
    """A job on host a (at 127.0.0.1, over the ssh wire) preempts itself
    at round boundary 2 while a is suspect; the requeue lands on host b,
    whose checkpoint dir is empty, ships round 2 from a's dir and
    finishes bit for bit an unpreempted run."""
    base = str(tmp_path / "base.npz")
    assert launch_local([*DRIVER, *_driver_args(base, 4)], 1,
                        device="cpu", timeout=240) == 0
    shim, log = _make_shim(tmp_path)
    monkeypatch.setenv("SPARKNET_SSH_CMD", str(shim))
    wd = str(tmp_path / "fleet")
    sched = p_fleet.FleetScheduler(
        wd, hosts=p_fleet.HostPool.parse("a=2@127.0.0.1,b=2@127.0.0.1"),
        device="cpu", preempt_grace_s=60,
        extra_env={"OMP_NUM_THREADS": "1"})
    job = sched.submit(p_fleet.JobSpec(name="t", world=2, rounds=4,
                                       fault="preempt@round:1"))
    sched.step()
    assert job.state == p_fleet.RUNNING and job.hosts == ("a",)
    sched.mark_host("a", p_fleet.HOST_SUSPECT, by="test")
    assert sched.run(tick_s=0.05, timeout_s=240) == 0
    assert job.state == p_fleet.COMPLETED and job.preempt_count == 1
    evs = p_fleet.FleetJournal.read(os.path.join(wd, "fleet_journal.jsonl"))
    launches = [(e["hosts"], e["transport"]) for e in evs
                if e["ev"] == "launch"]
    assert launches == [(["a"], "ssh"), (["b"], "ssh")]
    (ship,) = [e for e in evs if e["ev"] == "ship"]
    assert ship["host"] == "b" and ship["round"] == 2 and ship["bytes"] > 0
    assert p_transport.newest_valid_round(job.host_ckpt_dir("b")) == 4
    assert _params_equal(base, job.out_path) == []
    assert len(_wire_lines(log)) == 2
    view = p_fleet.offline_status(wd)
    assert {h: r["transport"] for h, r in view["hosts"].items()} == {
        "a": "ssh", "b": "ssh"}
