"""Shared steps of the gang tests (tests/test_torch_gang.py,
tests/test_torch_gang_world.py): the JAX driver's round-0 checkpoint as
the common start, the JAX one-process driver, the port's one-process
driver and the port's gang through ``launch_local``, each in a process
of its own with one OpenMP thread."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DRIVER = os.path.join(ROOT, "tests", "multihost_driver.py")
PORT_DRIVER = [sys.executable, "-m",
               "sparknet_tpu_torch.tools.multihost_driver"]
# the port against the JAX driver on the same start: the JAX multihost
# test's own bounds (tests/test_multihost.py:82-90)
RTOL, ATOL, SCORE_ATOL = 1e-5, 1e-6, 1e-5


def clean_env(monkeypatch) -> None:
    for k in list(os.environ):
        if k.startswith("SPARKNET_"):
            monkeypatch.delenv(k)
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("JAX_PLATFORM_NAME", "cpu")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p))


def run(cmd, timeout=240) -> str:
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


def jax_start(tmp_path, strategy: str, devices: int) -> str:
    """The JAX driver's baseline checkpoint (round 0) in a directory of
    its own: the start every run below resumes."""
    d = str(tmp_path / "start")
    run([sys.executable, JAX_DRIVER, "--strategy", strategy,
         "--local-devices", str(devices), "--expect-devices", str(devices),
         "--rounds", "0", "--guard", "--ckpt-dir", d,
         "--out", str(tmp_path / "j0.npz")])
    return d


def fork(start: str, tmp_path, name: str) -> str:
    d = str(tmp_path / name)
    shutil.copytree(start, d)
    return d


def jax_one(tmp_path, start, strategy, devices, rounds=2) -> np.lib.npyio.NpzFile:
    out = str(tmp_path / "jax.npz")
    run([sys.executable, JAX_DRIVER, "--strategy", strategy,
         "--local-devices", str(devices), "--expect-devices", str(devices),
         "--rounds", str(rounds), "--guard",
         "--ckpt-dir", fork(start, tmp_path, "ck_jax"), "--out", out])
    return np.load(out)


def port_one(tmp_path, start, strategy, devices, rounds=2):
    out = str(tmp_path / "one.npz")
    run([*PORT_DRIVER, "--strategy", strategy, "--local-devices",
         str(devices), "--expect-devices", str(devices), "--rounds",
         str(rounds), "--guard", "--ckpt-dir",
         fork(start, tmp_path, "ck_one"), "--out", out, "--device", "cpu"])
    return np.load(out)


def port_gang(tmp_path, start, strategy, procs, local, rounds=2,
              extra=(), env=None, timeout=240):
    from sparknet_tpu_torch.tools.launch import launch_local
    out = str(tmp_path / "gang.npz")
    cmd = [*PORT_DRIVER, "--strategy", strategy, "--expect-devices",
           str(procs * local), "--rounds", str(rounds), "--out", out,
           *extra]
    if start is not None:
        cmd += ["--guard", "--ckpt-dir", fork(start, tmp_path, "ck_gang")]
    report: dict = {}
    rc = launch_local(cmd, procs, device="cpu", local_devices=local,
                      timeout=timeout, extra_env=env, report=report)
    return rc, (np.load(out) if rc == 0 else None), report


def assert_bits(a, b) -> None:
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k


def assert_tracks_jax(port, jax) -> None:
    assert sorted(port.files) == sorted(jax.files)
    for k in port.files:
        if k in ("__guard_trips__", "__audit_trips__"):
            assert int(port[k]) == int(jax[k]) == 0, k
            continue
        np.testing.assert_allclose(
            port[k], jax[k], rtol=RTOL,
            atol=SCORE_ATOL if k == "__scores__" else ATOL, err_msg=k)
