"""The port's obs tool (``sparknet_tpu_torch/tools/obs.py``) against the
root ``tools/obs.py``, on the CPU.

The same trace shards, written once by the JAX package's tracer and once
by the port's, go through both tools' ``merge_events``,
``trace_rollup`` and ``check_trace`` and give equal results (exact
equality of the merged documents); ``parse_prometheus`` of both
registries' text and ``fold_metrics_dir`` of both packages' snapshots
are equal; a shard whose span lacks its correlation IDs fails ``merge
--check`` in both tools; and ``obs smoke --device cpu`` passes."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

from sparknet_tpu.utils import telemetry as jtel
from sparknet_tpu_torch.tools import obs
from sparknet_tpu_torch.utils import telemetry as tel

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_obs():
    spec = importlib.util.spec_from_file_location(
        "jax_obs", ROOT / "tools" / "obs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jobs = _jax_obs()
TELEMETRY = {"jax": jtel, "port": tel}


def _write_shards(mod, directory, monkeypatch, ranks=(0, 1)) -> None:
    """Two ranks' shards of one run from ``mod``'s tracer: rounds, a
    feed stage, a flight event, each at fixed epoch microseconds."""
    monkeypatch.setenv("SPARKNET_RUN_ID", "obs-parity")
    for rank in ranks:
        monkeypatch.setenv("SPARKNET_TELEMETRY_RANK", str(rank))
        tr = mod.Tracer(str(directory / f"r{rank}"))
        base = 1_700_000_000_000_000 + 1000 * rank
        for r in range(3):
            tr.complete("trainer.round", "trainer", base + 5000 * r, 4000,
                        {"round": r})
            tr.complete("feed.decode", "feed", base + 5000 * r + 10, 700)
        tr.emit({"name": "slo_breach", "cat": "flight", "ph": "i", "s": "p",
                 "ts": base + 20000, "pid": 1, "tid": 1,
                 "args": dict(tr.corr)})
        tr.flush()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_tools_merge_roll_up_and_check_alike(tmp_path, monkeypatch,
                                                  writer):
    _write_shards(TELEMETRY[writer], tmp_path, monkeypatch)
    ev_p, shards_p = obs.load_shards(str(tmp_path))
    ev_j, shards_j = jobs.load_shards(str(tmp_path))
    assert ev_p == ev_j and shards_p == shards_j and len(shards_p) == 2
    merged = obs.merge_events(ev_p)
    assert merged == jobs.merge_events(ev_j)
    roll = obs.trace_rollup(merged["traceEvents"])
    assert roll == jobs.trace_rollup(merged["traceEvents"])
    assert roll["spans"]["trainer.round"]["count"] == 6
    assert roll["runs"] == ["obs-parity"] and roll["flight_events"] == 2
    for expect in (1, 2, 3):
        assert obs.check_trace(merged["traceEvents"], roll, expect) == \
            jobs.check_trace(merged["traceEvents"], roll, expect)
    assert obs.check_trace(merged["traceEvents"], roll, 2) == []
    assert merged["traceEvents"][-1]["ts"] >= 0


def _merge_cli(mod, directory, capsys) -> tuple[int, str]:
    rc = mod.main(["merge", str(directory), "--check", "--expect-ranks",
                   "2", "--out", str(directory / "merged.json")])
    cap = capsys.readouterr()
    return rc, cap.out + cap.err


def test_merge_check_passes_then_fails_on_a_span_without_its_ids(
        tmp_path, monkeypatch, capsys):
    _write_shards(tel, tmp_path, monkeypatch)
    for mod in (obs, jobs):
        rc, out = _merge_cli(mod, tmp_path, capsys)
        assert rc == 0 and "check OK (2 ranks" in out, out
    # planted: one span of rank 1 loses its run id
    shard = next((tmp_path / "r1").glob("trace_*.jsonl"))
    lines = shard.read_text().splitlines()
    ev = json.loads(lines[1])
    assert ev["ph"] == "X"
    del ev["args"]["run"]
    lines[1] = json.dumps(ev)
    shard.write_text("\n".join(lines) + "\n")
    results = [_merge_cli(mod, tmp_path, capsys) for mod in (obs, jobs)]
    for rc, out in results:
        assert rc == 1 and "1 span(s) missing run/rank" in out, out


def test_merge_of_an_empty_dir_and_a_torn_line(tmp_path, monkeypatch,
                                               capsys):
    assert obs.main(["merge", str(tmp_path)]) == 2
    _write_shards(tel, tmp_path, monkeypatch, ranks=(0,))
    shard = next(tmp_path.rglob("trace_*.jsonl"))
    with open(shard, "a") as f:
        f.write('{"name": "torn", "ts": 1')      # the process died mid-flush
    events, _ = obs.load_shards(str(tmp_path))
    assert events == jobs.load_shards(str(tmp_path))[0]
    assert all(e.get("name") != "torn" for e in events)


def _registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serve_completed_total", "answered").inc(3, model="lenet")
    reg.gauge("serve_queue_depth", "queued").set(2.0)
    h = reg.histogram("serve_request_seconds", "latency")
    for v in (0.001, 0.02, 0.3):
        h.observe(v, model="lenet")
    return reg


def test_parse_prometheus_of_both_registries_is_equal():
    texts = {name: _registry(mod).render()
             for name, mod in TELEMETRY.items()}
    assert texts["jax"] == texts["port"]
    got = obs.parse_prometheus(texts["port"])
    assert got == jobs.parse_prometheus(texts["jax"])
    assert got["serve_completed_total"] == [('{model="lenet"}', 3.0)]
    assert "serve_request_seconds_bucket" in got
    for mod in (obs, jobs):
        with pytest.raises(ValueError, match="not Prometheus text"):
            mod.parse_prometheus("serve_ok 1\nthis is not a sample\n")


def test_fold_metrics_dir_of_both_packages_is_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_RUN_ID", "fold")
    for rank, (name, mod) in enumerate(TELEMETRY.items()):
        monkeypatch.setenv("SPARKNET_TELEMETRY_RANK", str(rank))
        _registry(mod).write_snapshot(str(tmp_path / name))
    folded = obs.fold_metrics_dir(str(tmp_path))
    assert folded == jobs.fold_metrics_dir(str(tmp_path))
    assert folded["serve_completed_total"]["samples"][0]["value"] == 6.0


def test_obs_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "verdict.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SPARKNET_")}
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run(
        [sys.executable, "-m", "sparknet_tpu_torch.tools.obs", "smoke",
         "--device", "cpu", "--out", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    verdict = json.loads(out.read_text())
    assert verdict["ok"] and verdict["ranks"] == ["0", "1", "9"]
    assert verdict["spans"]["trainer.round"] == 4
    assert verdict["metrics_families"] > 0 and verdict["metrics_rollup"]
