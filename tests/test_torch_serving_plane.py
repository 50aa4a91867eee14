"""The serving plane's host half against the JAX package's, on the CPU:
the model registry (``parallel/registry.py``), the liveness beacons
(``parallel/health.py``), the SLO monitor, the engine's beacons and SLO
wiring, ``ModelHouse.load_version`` and the ``bad_canary`` guard
(``parallel/serving.py``).

- Registry: the same publish, channel and resolve calls give the same
  version ids, equal manifests (``published_at`` and ``provenance``
  aside) and equal channel files, and each package reads the directory
  the other wrote, weights included; a rotted bundle and a drifted
  manifest are refused by both.
- Beacons: the same calls under the same clock write equal beat files
  and read back equal trees (``read_all``, ``read_hosts``,
  ``rollup_hosts``).
- ``SLOMonitor``: the same scripted counter stream under the same
  injected clock gives equal ``evaluate()``/``summary()`` dicts at every
  sample (the cases of tests/test_perfwatch.py:476-660), and a breach
  dumps the port's flight recorder.
- ``load_version``: tests/test_rollout.py:580-600 on a registry the JAX
  package published, its probabilities within 1e-5 of the JAX engine's
  f32 rows for the same ``.caffemodel``.
- ``bad_canary``: a planted version fails typed and returns no NaN.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from sparknet_tpu.parallel import health as jax_health
from sparknet_tpu.parallel import registry as jax_registry
from sparknet_tpu.parallel import serving as jax_serving
from sparknet_tpu.utils import faults as jax_faults
from sparknet_tpu.utils import telemetry as jax_telemetry
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.parallel import health, registry, serving
from sparknet_tpu_torch.proto import NetState, Phase
from sparknet_tpu_torch.proto.caffemodel import save_caffemodel
from sparknet_tpu_torch.utils import faults, knobs, telemetry

from torch_threads import one_torch_thread  # noqa: F401

PROB_TOL = 1e-5


@pytest.fixture
def tel(monkeypatch):
    for k in ("SPARKNET_TELEMETRY", "SPARKNET_TRACE_DIR",
              "SPARKNET_METRICS_SNAP", "SPARKNET_HEARTBEAT_DIR",
              "SPARKNET_REGISTRY_DIR", "SPARKNET_FAULT"):
        monkeypatch.delenv(k, raising=False)
    telemetry.reset()
    jax_telemetry.reset()
    faults.reset_injector()
    jax_faults.reset_injector()
    yield monkeypatch
    telemetry.reset()
    jax_telemetry.reset()
    faults.reset_injector()
    jax_faults.reset_injector()


@pytest.fixture(scope="module")
def lenet_weights(tmp_path_factory):
    """A .caffemodel of lenet's deploy net drawn by the port: both
    packages serve it."""
    cfg = serving.ServeConfig(batch_shapes=(1,))
    deploy, _ = serving.deploy_from(lenet(1, 1), 1)
    net = Net(deploy, NetState(Phase.TEST))
    params = net.init(torch.Generator().manual_seed(3), device="cpu")
    path = tmp_path_factory.mktemp("w") / "lenet.caffemodel"
    save_caffemodel(str(path), {k: [b.numpy() for b in v]
                                for k, v in params.items()})
    assert cfg.batch_shapes == (1,)
    return str(path)


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

def test_slice_knobs_are_declared_with_the_jax_defaults(tel):
    for name in ("SPARKNET_SLO_P99_MS", "SPARKNET_SLO_REJECT_BUDGET",
                 "SPARKNET_SLO_WINDOW_S", "SPARKNET_SLO_FAST_S",
                 "SPARKNET_REGISTRY_DIR", "SPARKNET_HEARTBEAT_DIR",
                 "SPARKNET_FAULT_ATTEMPT"):
        assert name in knobs.KNOBS
    mine, theirs = serving.ServeConfig(), jax_serving.ServeConfig()
    for f in ("slo_p99_ms", "slo_reject_budget", "slo_window_s",
              "slo_fast_window_s", "slo_burn_fast", "slo_burn_slow",
              "slo_min_requests", "slo_sample_every_s", "beat_every_s"):
        assert getattr(mine, f) == getattr(theirs, f), f
    tel.setenv("SPARKNET_SLO_P99_MS", "12.5")
    tel.setenv("SPARKNET_SLO_FAST_S", "2")
    assert serving.ServeConfig().slo_p99_ms == 12.5
    assert serving.ServeConfig().slo_fast_window_s == 2.0
    assert knobs.get_float("SPARKNET_SLO_FAST_S", 5.0) == 2.0
    tel.setenv("SPARKNET_SLO_WINDOW_S", "x")
    with pytest.raises(knobs.InvalidKnobValue):
        knobs.get_float("SPARKNET_SLO_WINDOW_S", 60.0)


@pytest.mark.parametrize("kw", [
    {"slo_reject_budget": 0.0}, {"slo_reject_budget": 1.5},
    {"slo_p99_ms": -5.0}, {"slo_window_s": 1.0, "slo_fast_window_s": 5.0},
    {"slo_fast_window_s": 0.0}])
def test_serve_config_slo_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        jax_serving.ServeConfig(**kw)
    with pytest.raises(ValueError):
        serving.ServeConfig(**kw)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _strip(doc: dict) -> dict:
    return {k: v for k, v in doc.items()
            if k not in ("published_at", "provenance", "t")}


@pytest.mark.parametrize("with_weights", [True, False])
def test_registry_publishes_the_same_versions(tmp_path, lenet_weights,
                                              with_weights):
    mine = registry.ModelRegistry(str(tmp_path / "port"))
    theirs = jax_registry.ModelRegistry(str(tmp_path / "jax"))
    kw = dict(weights=lenet_weights if with_weights else None,
              slo={"p99_ms": 80.0}, notes="n", tuning_table="tt")
    a, b = mine.publish("lenet", **kw), theirs.publish("lenet", **kw)
    assert a == b and a.startswith("mv-")
    assert _strip(mine.manifest("lenet", a)) == \
        _strip(theirs.manifest("lenet", b))
    with pytest.raises(registry.DuplicateVersion) as e:
        mine.publish("lenet", **kw)
    assert e.value.version == a
    v2 = mine.publish("lenet", notes="second")
    assert theirs.publish("lenet", notes="second") == v2
    assert mine.versions("lenet") == theirs.versions("lenet") \
        == sorted([a, v2])
    for reg in (mine, theirs):
        reg.set_channels("lenet", stable=a, canary=v2, weight=0.25)
    assert _strip(json.load(open(tmp_path / "port/lenet/channels.json"))) \
        == _strip(json.load(open(tmp_path / "jax/lenet/channels.json")))
    assert mine.channels("lenet") == theirs.channels("lenet")
    assert mine.resolve("lenet", "canary") == v2
    assert mine.channel_of("lenet", a) == "stable"
    assert mine.channel_of("lenet", "mv-none") is None
    assert registry.versioned("lenet", a) == jax_registry.versioned(
        "lenet", a)
    assert registry.split_versioned(f"lenet@{a}") == ("lenet", a)
    assert registry.split_versioned("lenet") == ("lenet", None)


def test_each_package_reads_the_others_registry(tmp_path, lenet_weights):
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    vj = jax_registry.ModelRegistry(jax_root).publish(
        "lenet", weights=lenet_weights, slo={"p99_ms": 40.0})
    jax_registry.ModelRegistry(jax_root).set_channels("lenet", stable=vj)
    vp = registry.ModelRegistry(port_root).publish(
        "caffenet", weights=lenet_weights)
    registry.ModelRegistry(port_root).set_channels(
        "caffenet", stable=vp, canary=vp, weight=0.5)
    # the port reads the JAX package's directory ...
    mine = registry.ModelRegistry(jax_root)
    assert mine.resolve("lenet") == vj
    assert mine.manifest("lenet", vj)["slo"] == {"p99_ms": 40.0}
    with open(mine.weights_path("lenet", vj), "rb") as f, \
            open(lenet_weights, "rb") as g:
        assert f.read() == g.read()
    # ... and the JAX package the port's
    theirs = jax_registry.ModelRegistry(port_root)
    assert theirs.channels("caffenet") == {"stable": vp, "canary": vp,
                                           "weight": 0.5}
    assert theirs.weights_path("caffenet", vp).endswith(".caffemodel")


def test_registry_refusals_match_jax(tmp_path, lenet_weights):
    for mod in (registry, jax_registry):
        root = tmp_path / mod.__name__.split(".")[0]
        reg = mod.ModelRegistry(str(root))
        v = reg.publish("lenet", weights=lenet_weights)
        with pytest.raises(mod.UnknownVersion):
            reg.manifest("lenet", "mv-ghost")
        with pytest.raises(mod.UnknownVersion):
            reg.resolve("lenet")
        with pytest.raises(ValueError, match="reserved"):
            reg.publish("a@b")
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            reg.set_channels("lenet", weight=2.0)
        with pytest.raises(mod.UnknownVersion):
            reg.set_channels("lenet", stable="mv-ghost")
        # a rotted bundle
        with open(root / "lenet" / v / "weights.caffemodel", "ab") as f:
            f.write(b"x")
        with pytest.raises(ValueError, match="sha256"):
            reg.weights_path("lenet", v)
        # a manifest from a newer build
        m = root / "lenet" / v / "manifest.json"
        doc = json.load(open(m))
        doc["version"] = 99
        m.write_text(json.dumps(doc))
        with pytest.raises(ValueError, match="newer"):
            reg.manifest("lenet", v)


def test_active_registry_reads_the_knob(tel, tmp_path):
    assert registry.active_registry() is None
    tel.setenv("SPARKNET_REGISTRY_DIR", str(tmp_path))
    assert registry.active_registry().root == str(tmp_path)


# ---------------------------------------------------------------------------
# beacons
# ---------------------------------------------------------------------------

def _beats(mod, root, clock):
    mod.write_beat(str(root), 0, 3, "round_end", attempt=1, clock=clock,
                   extras={"stall_s": 0.25})
    mod.write_beat(mod.host_dir(str(root), "h1"), 1, 4, "serving",
                   clock=lambda: clock() - 7.0)
    mod.write_beat(mod.host_dir(str(root), "h2"), 2, 5, "final",
                   clock=lambda: clock() - 1.0)
    (root / "hb_rank_x.json").write_text("{}")      # not a rank
    (root / "hb_rank_9.json").write_text("{torn")  # unreadable


def test_beat_files_and_trees_equal_jax(tmp_path):
    clock = lambda: 1000.0  # noqa: E731
    _beats(health, tmp_path / "port", clock)
    _beats(jax_health, tmp_path / "jax", clock)
    for rel in ("hb_rank_0.json", "host_h1/hb_rank_1.json",
                "host_h2/hb_rank_2.json"):
        assert json.load(open(tmp_path / "port" / rel)) == \
            json.load(open(tmp_path / "jax" / rel))
    for root in ("port", "jax"):
        # each package reads both trees
        d = str(tmp_path / root)
        assert {r: vars(b) for r, b in health.read_all(d).items()} == \
            {r: vars(b) for r, b in jax_health.read_all(d).items()}
        assert health.rollup_hosts(d, deadline_s=5.0, now=1001.0) == \
            jax_health.rollup_hosts(d, deadline_s=5.0, now=1001.0)
        assert sorted(health.read_hosts(d), key=str) == \
            sorted(jax_health.read_hosts(d), key=str)
    assert health.read_beat(str(tmp_path / "port"), 9) is None
    assert health.read_beat(str(tmp_path / "port"), 0).age(1002.0) == 2.0
    assert health.host_beat_dirs(str(tmp_path / "none")) == {}


def test_maybe_beat_follows_the_env(tel, tmp_path):
    health.maybe_beat(1)                     # no dir: nothing, no error
    tel.setenv("SPARKNET_HEARTBEAT_DIR", str(tmp_path))
    tel.setenv("SPARKNET_PROC_ID", "3")
    tel.setenv("SPARKNET_FAULT_ATTEMPT", "2")
    health.maybe_beat(7, "round_start", extras={"k": 1})
    b = jax_health.read_beat(str(tmp_path), 3)
    assert (b.round, b.phase, b.attempt, b.extras) == (7, "round_start", 2,
                                                       {"k": 1})


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


class _Stats:
    """Scripted engine counters the monitors sample."""

    def __init__(self):
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.p99 = 10.0

    def __call__(self):
        return {"completed": self.completed,
                "rejected": {"queue_full": self.rejected},
                "failed": self.failed, "p99_ms": self.p99}


def _healthy(st, clock, i):
    st.completed += 100


def _overload(st, clock, i):
    st.completed += 50
    st.rejected += 50


def _blip(st, clock, i):
    if i < 110:
        st.completed += 100
    else:
        st.rejected += 200
        st.completed += 60


def _failures(st, clock, i):
    st.completed += 80
    st.failed += 20 if 5 <= i < 30 else 0


def _latency(st, clock, i):
    st.completed += 100
    st.p99 = 250.0 if i < 4 else 20.0
    if i == 4:
        clock.t += 61.0


def _tiny(st, clock, i):
    st.rejected += 5 if i == 0 else 0


SCENARIOS = {"healthy": (_healthy, 20, None),
             "overload": (_overload, 20, None),
             "blip": (_blip, 111, None),
             "failures": (_failures, 60, None),
             "latency": (_latency, 6, 100.0),
             "latency_undeclared": (_latency, 6, None),
             "tiny_sample": (_tiny, 3, None)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_slo_monitor_verdicts_equal_jax(tel, tmp_path, name):
    tel.setenv("SPARKNET_TRACE_DIR", str(tmp_path))
    telemetry.reset()
    jax_telemetry.reset()
    step, n, p99 = SCENARIOS[name]
    clock, st = _Clock(), _Stats()
    kw = dict(slo_reject_budget=0.02, slo_window_s=60.0,
              slo_fast_window_s=5.0)
    mine = serving.SLOMonitor(st, serving.ServeConfig(**kw), clock=clock)
    theirs = jax_serving.SLOMonitor(st, jax_serving.ServeConfig(**kw),
                                    clock=clock)
    mine.p99_ms = theirs.p99_ms = p99
    states = []
    for i in range(n):
        clock.t += 0.5
        step(st, clock, i)
        a, b = mine.evaluate(), theirs.evaluate()
        assert a == b, (i, a, b)
        assert mine.summary() == theirs.summary()
        states.append(a["state"])
    assert (mine.breaches, mine.dumps) == (theirs.breaches, theirs.dumps)
    # each breach transition dumped the flight recorder (both packages
    # name the file alike: the one there holds a slo_breach event)
    assert mine.dumps == mine.breaches
    dumps = [p for p in os.listdir(tmp_path) if p.startswith("flight_")]
    assert bool(dumps) == bool(mine.breaches) == ("breach" in states)
    for p in dumps:
        events = json.load(open(tmp_path / p))["events"]
        assert any(e["kind"] == "slo_breach" for e in events)
    mine.reset()
    theirs.reset()
    assert mine.summary() == theirs.summary() == {
        "state": "ok", "breaches": mine.breaches}


def test_slo_sampler_thread_parks_a_broken_scrape(tel):
    def broken():
        raise KeyError("scrape")
    cfg = serving.ServeConfig(slo_sample_every_s=0.01)
    mon = serving.SLOMonitor(broken, cfg)
    mon.start()
    mon.start()                       # idempotent
    deadline = time.monotonic() + 10.0
    while mon.sample_errors == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    mon.stop()
    assert not mon._thread.is_alive()
    s = mon.summary()
    assert s["sample_errors"] >= 1 and "KeyError" in s["last_sample_error"]


# ---------------------------------------------------------------------------
# the engine: SLO wiring, beacons, load_version, bad_canary
# ---------------------------------------------------------------------------

def _cfg(mod, **kw):
    kw.setdefault("batch_shapes", (1, 4))
    return mod.ServeConfig(dtype="f32", max_delay_ms=2.0, **kw)


def test_engine_beacons_and_slo_match_jax(tel, tmp_path):
    """Both engines beat into a directory while they serve and a last
    ``final`` beat when they stop; each package reads the other's beat
    with the same extras keys and the same SLO summary in ``stats``."""
    x = np.random.default_rng(0).normal(size=(1, 28, 28)).astype(np.float32)
    extras = {}
    for name, mod, kw in (("port", serving, {"device": "cpu"}),
                          ("jax", jax_serving, {})):
        d = tmp_path / name
        tel.setenv("SPARKNET_HEARTBEAT_DIR", str(d))
        tel.setenv("SPARKNET_PROC_ID", "0")
        house = mod.ModelHouse(_cfg(mod, beat_every_s=0.05), **kw)
        house.load("lenet")
        eng = mod.InferenceEngine(house)
        try:
            res = eng.classify("lenet", x)
            assert res.top == int(np.argmax(res.probs))
            deadline = time.monotonic() + 20.0
            while jax_health.read_beat(str(d), 0) is None \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert eng.stats()["slo"] == {"state": "ok", "breaches": 0}
            assert eng.slo.evaluate()["state"] == "ok"
        finally:
            eng.stop()
        assert eng._beacon is not None and not eng._beacon.is_alive()
        assert not eng.slo._thread.is_alive()
        other = jax_health if name == "port" else health
        beat = other.read_beat(str(d), 0)
        assert beat.phase == "final"
        extras[name] = beat.extras
    assert set(extras["port"]) == set(extras["jax"])
    for k in ("serving", "completed", "models", "slo", "rejected"):
        assert extras["port"][k] == extras["jax"][k], k


def test_no_beacon_without_the_knob(tel):
    house = serving.ModelHouse(_cfg(serving), device="cpu")
    house.load("lenet")
    with serving.InferenceEngine(house) as eng:
        assert eng._beacon is None


def test_load_version_from_a_jax_published_registry(tel, tmp_path,
                                                    lenet_weights):
    """tests/test_rollout.py:580-600, the registry published by the JAX
    package; the version serves the .caffemodel within 1e-5 of the JAX
    engine's f32 rows."""
    reg_dir = str(tmp_path / "reg")
    vid = jax_registry.ModelRegistry(reg_dir).publish(
        "lenet", weights=lenet_weights, slo={"p99_ms": 80.0})
    house = serving.ModelHouse(_cfg(serving, batch_shapes=(1,)),
                               device="cpu")
    with pytest.raises(ValueError, match="SPARKNET_REGISTRY_DIR"):
        house.load_version("lenet", "mv-x")
    reg = registry.ModelRegistry(reg_dir)
    with pytest.raises(registry.UnknownVersion):
        house.load_version("lenet", "mv-ghost", registry=reg)
    lm = house.load_version("lenet", vid, registry=reg)
    assert lm.name == registry.versioned("lenet", vid)
    assert lm.version == vid and lm.info()["version"] == vid
    assert lm.declared_slo == {"p99_ms": 80.0}
    assert house.load_version("lenet", vid, registry=reg) is lm
    # by the knob, and served under the versioned key
    tel.setenv("SPARKNET_REGISTRY_DIR", reg_dir)
    assert house.load_version("lenet", vid) is lm
    jhouse = jax_serving.ModelHouse(_cfg(jax_serving, batch_shapes=(1,)))
    jlm = jhouse.load_version("lenet", vid)
    x = np.random.default_rng(5).normal(size=(1, 1, 28, 28)).astype(
        np.float32)
    np.testing.assert_allclose(lm.infer(x), jlm.infer(x), rtol=0,
                               atol=PROB_TOL)
    with serving.InferenceEngine(house) as eng:
        res = eng.classify(registry.versioned("lenet", vid), x[0])
        assert res.model == f"lenet@{vid}"
        np.testing.assert_array_equal(res.probs, lm.infer(x)[0])


@pytest.mark.parametrize("spec", ["version", "base"])
def test_bad_canary_fails_typed_and_returns_no_nan(tel, tmp_path,
                                                   lenet_weights, spec):
    reg = registry.ModelRegistry(str(tmp_path / "reg"))
    vid = reg.publish("lenet", weights=lenet_weights)
    # the fault's ':' arg names the version id or the base model ('@' is
    # the fault grammar's modifier separator)
    arg = {"version": vid, "base": "lenet"}[spec]
    tel.setenv("SPARKNET_FAULT", f"bad_canary:{arg}")
    faults.reset_injector()
    house = serving.ModelHouse(_cfg(serving), device="cpu")
    house.load_version("lenet", vid, registry=reg)
    house.load("cifar10_quick")
    x = np.zeros((1, 28, 28), np.float32)
    with serving.InferenceEngine(house) as eng:
        for _ in range(3):
            with pytest.raises(serving.ServingError, match="non-finite"):
                eng.classify(f"lenet@{vid}", x)
        # another model serves on
        ok = eng.classify("cifar10_quick", np.zeros((3, 32, 32),
                                                    np.float32))
        assert np.isfinite(ok.probs).all()
        st = eng.stats()
        assert st["failed"] == 3 and st["completed"] == 1
        # the availability burn reaches the monitor
        assert eng.slo.evaluate()["windows"]["fast"]["bad"] >= 0
