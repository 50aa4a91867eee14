"""The port's serving fleet on the CPU: ``serve --fleet`` and
``serveload --fleet`` (lenet, ``--device cpu``).

``python -m sparknet_tpu_torch.tools.serve --fleet 2`` places two
replica processes through the fleet scheduler and answers through the
request router: every answer bit for bit its solo reference at its
padded shape, ``/healthz`` the router table with two live replicas and
the device budget, ``/fleet`` the scheduler's status; after SIGTERM no
process of the fleet is left.  ``run_fleet_report`` at a CPU size has
the JAX report's keys and verdict names (read from the root
``tools/serveload.py``) and passes every verdict; its scaling gate is
off and says why (the replicas share one device).
"""

from __future__ import annotations

import ast
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from sparknet_tpu_torch.classify import http_json, remote_classify
from sparknet_tpu_torch.parallel import fleet as p_fleet
from sparknet_tpu_torch.parallel import serving
from sparknet_tpu_torch.tools import serveload
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("SPARKNET_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _orphans(workdir: str) -> list[int]:
    pids = {}
    for ev in p_fleet.FleetJournal.read(
            os.path.join(workdir, "fleet_journal.jsonl")):
        if ev.get("ev") == "pids":
            pids.setdefault(ev["job"], set()).update(ev["pids"])
    return [p for job, ps in pids.items() for p in ps
            if p_fleet._pid_is_fleet_job(p, job)]


def test_serve_fleet_answers_bit_for_bit_and_leaves_no_orphan(tmp_path):
    wd = str(tmp_path / "fleet")
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.serve",
         "--models", "lenet", "--fleet", "2", "--port", "0",
         "--device", "cpu", "--dtype", "f32", "--shapes", "1,4",
         "--fleet-workdir", wd], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ready = proc.stdout.readline().strip()
        assert ready.startswith("serving on http://"), ready
        url = ready.split()[2]
        health = http_json(f"{url}/healthz")
        assert health["alive"] and health["devices"] == {"total": 2,
                                                         "free": 0}
        assert sorted(health["router"]["replicas"]) == [
            "serve-lenet-0", "serve-lenet-1"]
        assert all(r["state"] == "ACTIVE"
                   for r in health["router"]["replicas"].values())
        cfg = serving.ServeConfig(batch_shapes=(1, 4), dtype="f32")
        lm = serving.ModelHouse(cfg, device="cpu").load("lenet")
        rng = np.random.default_rng(0)
        inputs = [rng.normal(size=(1, 28, 28)).astype(np.float32)
                  for _ in range(8)]
        refs = serving.solo_references(lm, inputs)
        answers = [None] * 32

        def client(k):
            for i in range(k, 32, 4):
                answers[i] = remote_classify(url, "lenet", inputs[i % 8],
                                             tenant=f"t{k}")

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for i, res in enumerate(answers):
            want = refs[res["padded_to"]][i % 8]
            assert np.array_equal(np.asarray(res["probs"], np.float32),
                                  want), i
        status = http_json(f"{url}/fleet")
        assert {r["job"] for r in status["jobs"]} == {"serve-lenet-0",
                                                      "serve-lenet-1"}
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(120)
    assert rc == 0
    assert _orphans(wd) == []


def _jax_report_keys() -> tuple[set, set]:
    """The keys the root tools/serveload.py's run_fleet_report writes
    into its report and into its verdicts."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "serveload.py"))
                     .read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "run_fleet_report")
    top, verdicts = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and isinstance(
                node.value, ast.Dict) and getattr(node.target, "id",
                                                  "") == "report":
            top |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and getattr(
                        t.value, "id", "") == "report":
                    top.add(t.slice.value)
                    if t.slice.value == "verdicts":
                        verdicts |= {k.value for k in node.value.keys}
    return top, verdicts


def test_fleet_report_has_the_jax_keys_and_passes(tmp_path):
    rep = serveload.run_fleet_report(
        model="lenet", replicas=2, devices=3, shapes=(1, 4), clients=2,
        seconds=0.6, inputs_n=6, dtype="f32",
        isolation_model="cifar10_quick",
        workdir=str(tmp_path / "fleet"), device="cpu")
    top, verdicts = _jax_report_keys()
    assert {"solo", "saturation", "paced", "chaos", "drain", "verdicts",
            "device", "provenance"} <= top
    assert top <= set(rep), top - set(rep)
    assert verdicts <= set(rep["verdicts"])
    v = rep["verdicts"]
    assert v["scaling_gated"] is False and v["fleet_scales_0p8N"] is None
    assert "share one device" in v["scaling_gate_reason"]
    assert v["fleet_scaling_x"] == rep["value"] > 0
    assert serveload.fleet_failures(rep) == []
    assert v["exact_mismatches"] == 0 and v["chaos_failover_engaged"]
    assert rep["device"] == "cpu/cpu"
    assert v["bystander_slo_ok"] and v["bystander_errors"] == 0
    assert v["hot_model_reacted"]
    assert _orphans(str(tmp_path / "fleet")) == []
