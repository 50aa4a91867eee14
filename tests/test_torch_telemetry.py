"""The port's telemetry plane against the JAX package's, on the CPU.

- The module: the same sequence of registry, tracer and recorder calls
  through ``sparknet_tpu_torch.utils.telemetry`` and
  ``sparknet_tpu.utils.telemetry`` gives the same Prometheus text, the
  same metrics snapshot after ``fold_snapshots`` (each package folds the
  other's files alike), the same span names, cats and arg keys in the
  trace shards and the same flight dump.  Exact equality throughout.
- The trainer's seams: a lenet ``local_sgd`` round loop (2 workers,
  τ=2, 2 rounds through ``input_feed``) through each package's trainer
  with the same config emits the same metric names, label sets and span
  counts; ``trainer_rounds_total`` and the FeedStats counts are equal.
  The cross-replica audit's ``trainer_audit_trips_total`` and its
  ``audit_fetch`` stall component are among them.
- The plane off (``SPARKNET_TELEMETRY=0``): the port's params after two
  rounds are bit for bit those of the run with the plane on and a trace
  directory; the trainer's per-round publishing retains no memory.
- Serving: answers served with the plane on and off are bit for bit
  equal, and the engine's spans and counters are written with it on.
"""

from __future__ import annotations

import glob
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh as jax_mesh
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu.utils import telemetry as jtel
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import DistributedTrainer, TrainerConfig
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from sparknet_tpu_torch.utils import telemetry as tel
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

_ENV = ("SPARKNET_TELEMETRY", "SPARKNET_TRACE_DIR", "SPARKNET_METRICS_SNAP",
        "SPARKNET_METRICS_SNAP_S", "SPARKNET_FLIGHT_EVENTS",
        "SPARKNET_RUN_ID", "SPARKNET_TELEMETRY_RANK", "SPARKNET_PROC_ID",
        "SPARKNET_INCARNATION", "SPARKNET_FLEET_JOB",
        "SPARKNET_FAULT_ATTEMPT")


@pytest.fixture(autouse=True)
def _fresh_planes(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SPARKNET_RUN_ID", "parity-run")
    tel.reset()
    jtel.reset()
    yield
    tel.reset()
    jtel.reset()


def _switch(monkeypatch, trace_dir=None, on=True):
    """Point both planes at a fresh env and drop their singletons."""
    monkeypatch.setenv("SPARKNET_TELEMETRY", "1" if on else "0")
    if trace_dir is None:
        monkeypatch.delenv("SPARKNET_TRACE_DIR", raising=False)
    else:
        monkeypatch.setenv("SPARKNET_TRACE_DIR", str(trace_dir))
    tel.reset()
    jtel.reset()


def _drive(t, snap_dir: str) -> str:
    """One fixed sequence of plane calls; returns the Prometheus text."""
    reg = t.get_registry()
    c = reg.counter("rounds_total", "rounds run")
    c.inc()
    c.inc(2.5, stage="a")
    g = reg.gauge("queue_depth", "jobs queued")
    g.set(3, comp="x")
    g.inc(comp="y")
    g.dec(0.5, comp="x")
    h = reg.histogram("stage_seconds", "stage latency")
    for v in (0.0003, 0.02, 0.02, 7.0, 30.0):
        h.observe(v, stage="decode")
    h.observe(0.5)
    with t.span("trainer.round", cat="trainer", round=1):
        pass
    t.note_span("feed.decode", 0.01, cat="feed")
    t.instant("mark", cat="app", k=1)
    rec = t.get_recorder()
    rec.record("guard_trip", round=1, reason="nan")
    rec.dump("guard_trip")
    reg.write_snapshot(snap_dir)
    t.get_tracer().flush()
    return reg.render()


def _trace_events(d) -> list[tuple]:
    out = []
    for path in sorted(glob.glob(os.path.join(str(d), "trace_*.jsonl"))):
        with open(path) as f:
            for line in f:
                ev = json.loads(line)
                out.append((ev["name"], ev.get("cat"), ev["ph"],
                            tuple(sorted(ev.get("args", {})))))
    return out


def test_same_calls_same_text_snapshots_and_spans(tmp_path, monkeypatch):
    outs = {}
    for name, t in (("port", tel), ("jax", jtel)):
        d = tmp_path / name
        _switch(monkeypatch, d / "trace")
        text = _drive(t, str(d / "snap"))
        flight = sorted(glob.glob(str(d / "trace" / "flight_*.json")))
        assert len(flight) == 1
        with open(flight[0]) as f:
            doc = json.load(f)
        outs[name] = {
            "text": text,
            "files": sorted(glob.glob(str(d / "snap" / "*.json"))),
            "spans": _trace_events(d / "trace"),
            "flight": (doc["reason"], sorted(doc),
                       [(e["kind"], sorted(e)) for e in doc["events"]])}
    port, jax = outs["port"], outs["jax"]
    assert port["text"] == jax["text"]
    assert "stage_seconds_bucket" in port["text"]
    assert port["spans"] == jax["spans"]
    assert {s[0] for s in port["spans"]} >= {
        "trainer.round", "feed.decode", "mark", "flight.guard_trip"}
    assert port["flight"] == jax["flight"]
    # each package folds its own snapshots and the other's alike
    folded = tel.fold_snapshots(port["files"])
    assert folded == jtel.fold_snapshots(jax["files"])
    assert folded == tel.fold_snapshots(jax["files"])
    assert folded == jtel.fold_snapshots(port["files"])
    assert folded["rounds_total"]["samples"]


# ---------------------------------------------------------------------------
# the trainer's seams
# ---------------------------------------------------------------------------

_SOLVER = 'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n'
_ROUNDS = 2


def _rounds():
    rng = np.random.default_rng(7)
    for _ in range(_ROUNDS):
        yield {"data": rng.normal(size=(2, 8, 1, 28, 28)).astype(np.float32),
               "label": rng.integers(0, 10, size=(2, 8)).astype(np.float32)}


def _run_port(snap_dir=None):
    tr = DistributedTrainer(
        load_solver_prototxt_with_net(_SOLVER, lenet(4, 4)), 2,
        TrainerConfig(strategy="local_sgd", tau=2), seed=0, device="cpu")
    with tr.input_feed(_rounds()) as feed:
        for batches in feed:
            tr.train_round(batches)
    tr.drain()
    if snap_dir is not None:
        tel.get_registry().write_snapshot(snap_dir)
        tel.get_tracer().flush()
    return tr


def _run_jax(snap_dir):
    tr = JaxTrainer(jax_solver(_SOLVER, jax_lenet(4, 4)), jax_mesh(2),
                    JaxConfig(strategy="local_sgd", tau=2), seed=0)
    with tr.input_feed(_rounds()) as feed:
        for batches in feed:
            tr.train_round(batches)
    tr.drain()
    jtel.get_registry().write_snapshot(snap_dir)
    jtel.get_tracer().flush()
    return tr


def _labels(folded) -> dict[str, set]:
    return {name: {tuple(sorted(s["labels"].items()))
                   for s in m["samples"]}
            for name, m in folded.items()}


def _counts(spans) -> dict[str, int]:
    out: dict[str, int] = {}
    for s in spans:
        if s[2] == "X":
            out[s[0]] = out.get(s[0], 0) + 1
    return out


def test_trainer_seams_emit_the_jax_names_and_counts(tmp_path, monkeypatch):
    _switch(monkeypatch, tmp_path / "port_trace")
    port = _run_port(str(tmp_path / "port_snap"))
    _switch(monkeypatch, tmp_path / "jax_trace")
    jax = _run_jax(str(tmp_path / "jax_snap"))
    pf = tel.fold_snapshots(glob.glob(str(tmp_path / "port_snap/*.json")))
    jf = jtel.fold_snapshots(glob.glob(str(tmp_path / "jax_snap/*.json")))
    # the cross-replica audit's counter and stall too, as in the JAX plane
    assert _labels(pf) == _labels(jf)
    for name in ("trainer_rounds_total", "feed_batches_total"):
        assert pf[name] == jf[name]
    assert pf["trainer_rounds_total"]["samples"][0]["value"] == _ROUNDS
    stages = {s["labels"]["stage"]: s["count"]
              for s in pf["feed_stage_seconds"]["samples"]}
    assert stages == {s["labels"]["stage"]: s["count"]
                      for s in jf["feed_stage_seconds"]["samples"]}
    assert port.feed_stats.batches == jax.feed_stats.batches == _ROUNDS
    pc = _counts(_trace_events(tmp_path / "port_trace"))
    jc = _counts(_trace_events(tmp_path / "jax_trace"))
    assert pc == jc
    assert pc["trainer.round"] == _ROUNDS
    assert pc["feed.device_put"] == _ROUNDS


def test_plane_off_changes_no_bit_and_allocates_nothing(tmp_path,
                                                         monkeypatch):
    _switch(monkeypatch, tmp_path / "trace")
    on = _run_port()
    _switch(monkeypatch, on=False)
    off = _run_port()
    for k, blobs in on.params.items():
        for a, b in zip(blobs, off.params[k]):
            assert torch.equal(a, b), k
    assert glob.glob(str(tmp_path / "trace" / "trace_*.jsonl"))
    assert tel.get_registry().render() == ""

    def one_round(i):
        off._publish_round()
        with tel.span("trainer.round", cat="trainer", round=i):
            pass
        tel.note_span("feed.decode", 0.001, cat="feed")
        off.feed_stats.note("decode", 0.001)

    for i in range(1000):   # warm lazy interpreter caches
        one_round(i)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        for i in range(1000):
            one_round(i)
        after, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # one retained object a round would be >= 28 KB over 1000 rounds
    assert after - before < 2048


def test_serving_answers_equal_with_the_plane_on_and_off(tmp_path,
                                                         monkeypatch):
    from sparknet_tpu_torch.parallel.serving import (InferenceEngine,
                                                     ModelHouse, ServeConfig)
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(1, 28, 28)).astype(np.float32) for _ in range(6)]
    served = {}
    for on in (True, False):
        _switch(monkeypatch, tmp_path / "trace" if on else None, on=on)
        cfg = ServeConfig(batch_shapes=(1, 4), max_delay_ms=2.0, seed=0)
        house = ModelHouse(cfg, device="cpu")
        house.load("lenet")
        with InferenceEngine(house, cfg) as eng:
            futs = [eng.submit("lenet", x) for x in xs]
            served[on] = [f.result(30).probs for f in futs]
            if on:
                reg = tel.get_registry()
                assert reg.counter("serve_completed_total").value() == len(xs)
                assert "serve_queue_depth" in reg.render()
        if on:
            tel.get_tracer().flush()
    for a, b in zip(served[True], served[False]):
        assert np.array_equal(a, b)
    names = {s[0] for s in _trace_events(tmp_path / "trace")}
    assert {"serve.dispatch", "serve.batch", "serve.queue"} <= names
