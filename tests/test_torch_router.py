"""The port's request router and autoscaler against the JAX package's,
on the CPU.

The router's placement is a pure function of the replica set: the same
rendezvous homes (the first 8 bytes of md5 over ``"{model}|{rid}"``) and
the same spill decisions come out of both packages for 200 seeded
``(model, replica set, load)`` draws.  The JAX router tests'
scriptable-stub scenarios (tests/test_router.py:99-363: home, spill,
typed failover, all dead, overload, drain, the autoscaler's policy)
run on each package with the same assertions, and the autoscaler's
decisions on the same sequence of stats are equal.  Typed failover,
all-dead and overload then run on the port's in-process lenet engines,
each answer bit for bit its solo reference.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import types

import numpy as np
import pytest

from sparknet_tpu.parallel import autoscale as j_autoscale
from sparknet_tpu.parallel import router as j_router
from sparknet_tpu.parallel import serving as j_serving
from sparknet_tpu_torch.parallel import autoscale as p_autoscale
from sparknet_tpu_torch.parallel import router as p_router
from sparknet_tpu_torch.parallel import serving as p_serving
from torch_threads import one_torch_thread  # noqa: F401 (fixture)


def _ns(router, autoscale, serving):
    return types.SimpleNamespace(
        Router=router.Router, RouterConfig=router.RouterConfig,
        RouterDrainHook=router.RouterDrainHook, hrw=router._hrw,
        Autoscaler=autoscale.Autoscaler,
        AutoscaleConfig=autoscale.AutoscaleConfig,
        EngineDead=serving.EngineDead, Overloaded=serving.Overloaded,
        UnknownModel=serving.UnknownModel)


PKGS = {"jax": _ns(j_router, j_autoscale, j_serving),
        "port": _ns(p_router, p_autoscale, p_serving)}


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


class StubFuture:
    def __init__(self, value=None, error=None, gate=None):
        self.value, self.error, self.gate = value, error, gate

    def done(self):
        return self.gate is None or self.gate.is_set()

    def result(self, timeout=None):
        if self.gate is not None and not self.gate.wait(
                timeout if timeout is not None else 30.0):
            raise TimeoutError("stub future never released")
        if self.error is not None:
            raise self.error
        return self.value


class StubClient:
    def __init__(self, rid, models=("m",), behavior=None):
        self.rid = rid
        self.models = frozenset(models)
        self.behavior = behavior
        self.calls = 0

    def submit(self, model, x, tenant):
        self.calls += 1
        if self.behavior is not None:
            return self.behavior(model, x, tenant)
        return StubFuture(value=(self.rid, float(np.sum(x))))

    def alive(self):
        return True

    def describe(self):
        return {"transport": "stub"}


def router_with(P, clients, **cfg):
    r = P.Router(P.RouterConfig(**cfg))
    for c in clients:
        r.add_replica(c.rid, c)
    return r


def _raise(err):
    def behavior(m, x, t):
        raise err
    return behavior


# ---------------------------------------------------------------------------
# The same homes and spills from both packages
# ---------------------------------------------------------------------------

def test_hrw_is_the_jax_hash_bit_for_bit():
    rng = np.random.default_rng(7)
    for _ in range(200):
        model = f"m{int(rng.integers(0, 50))}@v{int(rng.integers(0, 5))}"
        rid = f"serve-{int(rng.integers(0, 10**6))}"
        want = int.from_bytes(hashlib.md5(
            f"{model}|{rid}".encode()).digest()[:8], "big")
        assert p_router._hrw(model, rid) == j_router._hrw(model, rid) \
            == want


def _placements(P, draw_seed: int) -> list:
    """One seeded draw: a replica set, a few dead, a held load per
    replica, then where each of 12 requests lands (home or spill)."""
    rng = np.random.default_rng(draw_seed)
    n = int(rng.integers(1, 7))
    gate = threading.Event()
    clients = [StubClient(f"r{int(rng.integers(0, 10**4))}-{i}",
                          models=("a", "b"),
                          behavior=lambda m, x, t: StubFuture(
                              value="held", gate=gate))
               for i in range(n)]
    r = router_with(P, clients, spill_depth=int(rng.integers(1, 5)))
    for c in clients[:int(rng.integers(0, n))]:
        r.mark_dead(c.rid, "draw")
    out = []
    try:
        for i in range(12):
            model = ("a", "b")[int(rng.integers(0, 2))]
            try:
                fut = r.submit(model, np.ones(2))
                out.append((model, r.home(model), fut._rep.rid))
            except P.EngineDead:
                out.append((model, None, "dead"))
        out.append(dict(r.counts))
    finally:
        gate.set()
    return out


def test_the_same_homes_and_spills_for_200_draws():
    for seed in range(200):
        assert _placements(PKGS["port"], seed) == \
            _placements(PKGS["jax"], seed), seed


# ---------------------------------------------------------------------------
# The JAX router tests' stub scenarios, on each package
# ---------------------------------------------------------------------------

def test_home_is_stable_and_rehomes_only_on_membership_change(P):
    clients = [StubClient(f"r{i}") for i in range(4)]
    r = router_with(P, clients)
    home = r.home("m")
    assert home == max((c.rid for c in clients),
                       key=lambda rid: P.hrw("m", rid))
    bystander = next(c.rid for c in clients if c.rid != home)
    r.mark_dead(bystander, "test")
    assert r.home("m") == home
    r.mark_dead(home, "test")
    survivors = [c.rid for c in clients if c.rid not in (home, bystander)]
    assert r.home("m") == max(survivors, key=lambda rid: P.hrw("m", rid))


def test_requests_ride_home_until_spill_depth_then_least_loaded(P):
    gate = threading.Event()
    clients = [StubClient(f"r{i}", behavior=lambda m, x, t: StubFuture(
        value="held", gate=gate)) for i in range(3)]
    r = router_with(P, clients, spill_depth=4)
    home = r.home("m")
    futs = [r.submit("m", np.ones(2)) for _ in range(4)]
    assert r.outstanding(home) == 4 and r.counts["spills"] == 0
    spilled = [r.submit("m", np.ones(2)) for _ in range(3)]
    assert r.counts["spills"] == 3 and r.outstanding(home) == 4
    gate.set()
    for f in futs + spilled:
        f.result(5.0)
    assert r.outstanding(home) == 0


def _home_first(P, a, b):
    return (a, b) if P.hrw("m", a) > P.hrw("m", b) else (b, a)


def test_typed_failover_and_mid_request_death(P):
    bad, ok = _home_first(P, "a", "b")
    r = router_with(P, [StubClient(bad, behavior=_raise(P.EngineDead("x"))),
                        StubClient(ok)])
    for _ in range(6):
        assert r.classify("m", np.ones(2), timeout=5.0)[0] == ok
    assert r.stats()["gone"][bad]["state"] == "DEAD"
    assert r.counts["failovers"] >= 1
    flaky = StubClient(bad, behavior=lambda m, x, t: StubFuture(
        error=P.EngineDead("died mid-request")))
    r2 = router_with(P, [flaky, StubClient(ok)])
    assert r2.submit("m", np.ones(2)).result(10.0)[0] == ok
    assert r2.counts["deaths"] >= 1 and flaky.calls == 1


def test_all_dead_is_typed_and_overload_spills_once(P):
    r = router_with(P, [StubClient(rid, behavior=_raise(
        P.EngineDead(f"{rid} down"))) for rid in "abc"], max_failovers=5)
    t0 = time.monotonic()
    with pytest.raises(P.EngineDead):
        r.classify("m", np.ones(2), timeout=10.0)
    assert time.monotonic() - t0 < 5.0 and r.replica_ids() == []
    full = [StubClient(rid, behavior=_raise(P.Overloaded("queue_full",
                                                         rid)))
            for rid in "ab"]
    r2 = router_with(P, full)
    with pytest.raises(P.Overloaded):
        r2.submit("m", np.ones(2))
    assert [c.calls for c in full] == [1, 1]
    r3 = router_with(P, [StubClient("full", behavior=_raise(
        P.Overloaded("queue_full", "full"))), StubClient("free")])
    assert r3.classify("m", np.ones(2), timeout=5.0)[0] == "free"
    with pytest.raises(P.UnknownModel):
        r3.submit("nope", np.ones(2))


def test_drain_fences_placement_and_waits_for_outstanding(P):
    gate = threading.Event()
    mk = lambda rid: StubClient(rid, behavior=lambda m, x, t: StubFuture(
        value=rid, gate=gate))
    r = router_with(P, [mk("a"), mk("b")])
    victim = r.home("m")
    other = "a" if victim == "b" else "b"
    held = r.submit("m", np.ones(2))
    hook = P.RouterDrainHook(r, victim)
    hook.start()
    fenced = [r.submit("m", np.ones(2)) for _ in range(4)]
    assert all(f._rep.rid == other for f in fenced)
    assert hook.done() is False
    gate.set()
    for f in [held] + fenced:
        f.result(5.0)
    assert hook.done() is True
    assert r.stats()["gone"][victim]["state"] == "RELEASED"


# ---------------------------------------------------------------------------
# The autoscaler: the same decisions from the same stats
# ---------------------------------------------------------------------------

def _rep(rid, queue=0, outstanding=0, rejected=0, breach=False):
    return {"rid": rid, "queue_depth": queue, "outstanding": outstanding,
            "rejected_total": rejected, "slo_breach": breach}


def _decisions(P, tmp_path, seed: int) -> list:
    """A seeded script of stats over a fake clock through one package's
    autoscaler: every decision, and the persisted state at the end."""
    rng = np.random.default_rng(seed)
    clock = {"now": 0.0}
    stats = {"m": [_rep("r0")], "n": [_rep("s0")]}
    acts: list = []
    up_ok = {"v": True}
    auto = P.Autoscaler(
        lambda: stats,
        lambda m: (acts.append(("up", m)), up_ok["v"])[1],
        lambda m: (acts.append(("down", m)), f"{m}-victim")[1],
        cfg=P.AutoscaleConfig(min_replicas=1, max_replicas=3, up_queue=8.0,
                              down_idle_s=5.0, cooldown_s=4.0,
                              sample_every_s=1.0),
        state_path=str(tmp_path / "autoscale.json"),
        clock=lambda: clock["now"])
    out = []
    rejected = 0
    for _ in range(40):
        clock["now"] += float(rng.uniform(0.5, 3.0))
        up_ok["v"] = bool(rng.random() < 0.8)
        for m in ("m", "n"):
            k = int(rng.integers(1, 4))
            rejected += int(rng.integers(0, 3))
            stats[m] = [_rep(f"{m}{i}", queue=int(rng.integers(0, 30))
                             * int(rng.random() < 0.5),
                             outstanding=int(rng.integers(0, 4)),
                             rejected=rejected,
                             breach=bool(rng.random() < 0.1))
                        for i in range(k)]
        out.append([{k: v for k, v in d.items() if k != "t"}
                    for d in auto.evaluate()])
    doc = json.load(open(tmp_path / "autoscale.json"))
    for m in doc["models"].values():
        m.get("last", {}).pop("t", None)
    doc.pop("t", None)
    return [out, acts, doc]


def test_autoscale_decisions_equal_the_jax_package(tmp_path):
    for seed in range(6):
        (tmp_path / "j").mkdir(exist_ok=True)
        (tmp_path / "p").mkdir(exist_ok=True)
        want = _decisions(PKGS["jax"], tmp_path / "j", seed)
        got = _decisions(PKGS["port"], tmp_path / "p", seed)
        assert got == want, seed
        assert any(d for d in want[0]), "the script made no decision"


def test_autoscale_up_on_backlog_then_down_after_idle(P, tmp_path):
    now = {"t": 0.0}
    stats = {"m": [_rep("r0", queue=20)]}
    ups, downs = [], []
    auto = P.Autoscaler(
        lambda: stats, lambda m: (ups.append(m), True)[1],
        lambda m: (downs.append(m), "r0")[1],
        cfg=P.AutoscaleConfig(min_replicas=1, max_replicas=3, up_queue=8.0,
                              down_idle_s=5.0, cooldown_s=4.0,
                              sample_every_s=1.0),
        state_path=str(tmp_path / "a.json"), clock=lambda: now["t"])
    (dec,) = auto.evaluate()
    assert dec["action"] == "up" and "backlog" in dec["reason"]
    now["t"] = 2.0
    assert auto.evaluate() == []          # cooldown
    stats["m"] = [_rep(f"r{i}") for i in range(3)]
    for t in (10.0, 13.0):
        now["t"] = t
        assert auto.evaluate() == []
    now["t"] = 16.0
    (dec,) = auto.evaluate()
    assert dec["action"] == "down" and downs == ["m"]
    with pytest.raises(ValueError, match="max_replicas"):
        P.AutoscaleConfig(min_replicas=4, max_replicas=2)


def test_router_config_reads_the_port_knobs(monkeypatch):
    monkeypatch.setenv("SPARKNET_ROUTER_SPILL_DEPTH", "7")
    monkeypatch.setenv("SPARKNET_ROUTER_FAILOVERS", "5")
    cfg = p_router.RouterConfig()
    assert (cfg.spill_depth, cfg.max_failovers) == (7, 5)
    with pytest.raises(ValueError, match="spill_depth"):
        p_router.RouterConfig(spill_depth=0)


# ---------------------------------------------------------------------------
# In-process lenet engines of the port: failover, all dead, overload
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lenet_house():
    cfg = p_serving.ServeConfig(batch_shapes=(1, 4, 8), max_delay_ms=3.0,
                                max_queue=64, dtype="f32",
                                beat_every_s=10.0)
    house = p_serving.ModelHouse(cfg, device="cpu")
    house.load("lenet")
    return house


def two_replica_router(house, **cfg):
    r = p_router.Router(p_router.RouterConfig(
        **{"spill_depth": 8, "max_failovers": 3, **cfg}))
    engines = []
    for i in range(2):
        eng = p_serving.InferenceEngine(house, house.cfg)
        engines.append(eng)
        r.add_replica(f"rep{i}", p_router.InProcessReplica(f"rep{i}", eng))
    return r, engines


def test_replica_death_under_load_typed_failover_exact(lenet_house):
    rng = np.random.default_rng(0)
    inputs = [rng.normal(size=(1, 28, 28)).astype(np.float32)
              for _ in range(8)]
    refs = p_serving.solo_references(lenet_house.get("lenet"), inputs)
    r, engines = two_replica_router(lenet_house)
    victim = int(r.home("lenet")[-1])
    killed = threading.Event()

    def submit(idx, x):
        fut = r.submit("lenet", x, tenant="chaos")
        if r.counts["requests"] >= 20 and not killed.is_set():
            killed.set()
            engines[victim].stop()
        return fut

    try:
        rep = p_serving.run_closed_loop(
            None, "lenet", inputs, clients=4, window=2, duration_s=1.5,
            refs=refs, timeout_s=15.0, submit=submit)
        assert killed.is_set()
        assert rep["errors"] == 0 and rep["exact_mismatches"] == 0
        assert rep["completed"] > 0
        st = r.stats()
        assert st["counts"]["deaths"] >= 1
        assert st["gone"][f"rep{victim}"]["state"] == "DEAD"
        res = r.classify("lenet", inputs[0], timeout=10.0)
        assert np.array_equal(res.probs, refs[res.padded_to][0])
    finally:
        for eng in engines:
            eng.stop()


def test_both_replicas_dead_is_typed_not_a_hang(lenet_house):
    r, engines = two_replica_router(lenet_house)
    x = np.zeros((1, 28, 28), np.float32)
    r.classify("lenet", x, timeout=10.0)
    for eng in engines:
        eng.stop()
    t0 = time.monotonic()
    with pytest.raises(p_serving.EngineDead):
        r.classify("lenet", x, timeout=10.0)
    assert time.monotonic() - t0 < 8.0


def test_overloaded_engines_reject_typed_through_the_router():
    cfg = p_serving.ServeConfig(batch_shapes=(1,), max_delay_ms=0.0,
                                dtype="f32", beat_every_s=10.0,
                                tenant_qps={"burst": 1.0})
    house = p_serving.ModelHouse(cfg, device="cpu")
    house.load("lenet")
    r, engines = two_replica_router(house)
    x = np.zeros((1, 28, 28), np.float32)
    futs, rejected = [], 0
    try:
        for _ in range(64):
            try:
                futs.append(r.submit("lenet", x, tenant="burst"))
            except p_serving.Overloaded:
                rejected += 1
        assert rejected > 0, "a 1 QPS quota never rejected"
        # each rejection the caller saw was offered to both replicas
        assert r.counts["rejections"] >= 2 * rejected
        for f in futs:
            f.result(30.0)
    finally:
        for eng in engines:
            eng.stop()
