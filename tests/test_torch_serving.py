"""The port's serving plane on the CPU (``device="cpu"``).

- the port's ``LoadedModel`` against the JAX package's on lenet and on the
  narrow CaffeNet of test_torch_net.py, with the same weights, in f32
  (rtol 1e-4, atol 1e-6, as the net test);
- pad-and-mask: a request batched with strangers gets bit-identical
  probabilities to its solo run padded to the same shape;
- admission and lifetime: typed Overloaded, UnknownModel, OverBudget, LRU
  eviction, a dead engine as a typed EngineDead;
- no fallback: without CUDA the default device raises.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel.serving import LoadedModel as JaxLoadedModel
from sparknet_tpu.parallel.serving import ServeConfig as JaxServeConfig
from sparknet_tpu.proto import load_net_prototxt as jax_load
from sparknet_tpu_torch.graph import Net
from sparknet_tpu_torch.models import lenet
from sparknet_tpu_torch.ops import cuda_kernels as ck
from sparknet_tpu_torch.parallel.serving import (
    EngineDead,
    InferenceEngine,
    LoadedModel,
    ModelHouse,
    Overloaded,
    OverBudget,
    ServeConfig,
    ServingError,
    UnknownModel,
    deploy_from,
    run_closed_loop,
    solo_references,
    zoo_models,
)
from sparknet_tpu_torch.proto import load_net_prototxt
from sparknet_tpu_torch.utils import knobs
from test_torch_net import NARROW_CAFFENET

pytestmark = pytest.mark.serving


@pytest.fixture(scope="module")
def lenet_house():
    cfg = ServeConfig(batch_shapes=(1, 4, 8), max_delay_ms=30.0,
                      max_queue=64, dtype="f32")
    house = ModelHouse(cfg, device="cpu")
    house.load("lenet")
    return house


def engine_for(house, **overrides) -> InferenceEngine:
    return InferenceEngine(house, dataclasses.replace(house.cfg, **overrides))


def lenet_inputs(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 28, 28)).astype(np.float32)
            for _ in range(n)]


class _StubModel:
    """House-injectable model with scriptable behavior."""

    def __init__(self, fn=None, shapes=(1, 2, 4), param_bytes=128):
        self.name = "stub"
        self.in_shape = (2,)
        self.classes = 3
        self.batch_shapes = tuple(shapes)
        self.param_bytes = param_bytes
        self.last_used = 0.0
        self.fn = fn

    def pad_shape(self, n: int) -> int:
        return next((s for s in self.batch_shapes if s >= n),
                    self.batch_shapes[-1])

    def infer_async(self, batch):
        if self.fn is not None:
            return self.fn(batch)
        return np.tile(batch.sum(axis=1, keepdims=True),
                       (1, self.classes)).astype(np.float32)

    @staticmethod
    def harvest(handle):
        return handle

    def info(self):
        return {"name": self.name, "stub": True}


def stub_house(stub: _StubModel, **cfg_over) -> ModelHouse:
    cfg_over.setdefault("batch_shapes", stub.batch_shapes)
    cfg_over.setdefault("dtype", "f32")
    house = ModelHouse(ServeConfig(**cfg_over), device="cpu")
    house._models["stub"] = stub
    return house


# ---------------------------------------------------------------------------
# The port against the JAX engine's model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["lenet", "narrow_caffenet"])
def test_loaded_model_matches_jax(model):
    if model == "lenet":
        jax_param, port_param = jax_lenet(1, 1), lenet(1, 1)
        in_shape = (1, 28, 28)
    else:
        jax_param = jax_load(NARROW_CAFFENET)
        port_param = load_net_prototxt(NARROW_CAFFENET)
        in_shape = (3, 67, 67)
    jlm = JaxLoadedModel(model, jax_param,
                         JaxServeConfig(batch_shapes=(1, 4), dtype="f32"))
    tlm = LoadedModel(model, port_param,
                      ServeConfig(batch_shapes=(1, 4), dtype="f32"),
                      device="cpu", params=jax.device_get(jlm.params))
    assert tlm.in_shape == tuple(jlm.in_shape) == in_shape
    assert tlm.classes == jlm.classes
    assert tlm.param_bytes == jlm.param_bytes
    batch = np.random.default_rng(3).normal(
        size=(4,) + in_shape).astype(np.float32)
    got, want = tlm.infer(batch), jlm.infer(batch)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_lenet_flops_per_image_counted_from_shapes(lenet_house):
    # conv1 20x(1x5x5) over 24x24, conv2 50x(20x5x5) over 8x8, ip1, ip2
    want = 2 * (20 * 25 * 24 * 24 + 50 * 500 * 8 * 8 + 800 * 500 + 500 * 10)
    assert lenet_house.get("lenet").flops_per_image == want


def test_deploy_from_matches_layer_names_and_head():
    deploy, in_shape = deploy_from(lenet(64, 100), 8)
    assert in_shape == (1, 28, 28)
    assert deploy.input == ["data"] and deploy.input_shape[0].dim == [8, 1,
                                                                      28, 28]
    names = [lp.name for lp in deploy.layer]
    assert names[-1] == "prob" and "loss" not in names
    assert "accuracy" not in names


def test_zoo_holds_only_models_whose_layers_are_ported():
    assert set(zoo_models()) == {"lenet", "cifar10_quick", "cifar10_full",
                                 "alexnet", "caffenet", "googlenet", "vgg16"}
    for factory in zoo_models().values():
        deploy, _ = deploy_from(factory(), 1)
        Net(deploy)       # every layer type resolves in the port


# ---------------------------------------------------------------------------
# Pad-and-mask bit-identity
# ---------------------------------------------------------------------------

def test_batched_with_strangers_bit_identical_to_solo(lenet_house):
    xs = lenet_inputs(6)
    lm = lenet_house.get("lenet")
    refs = solo_references(lm, xs)
    with engine_for(lenet_house, max_delay_ms=200.0) as eng:
        futs = [eng.submit("lenet", x) for x in xs]
        res = [f.result(20.0) for f in futs]
    assert {r.padded_to for r in res} == {8}
    assert all(r.batch_n == 6 for r in res)
    for i, r in enumerate(res):
        assert np.array_equal(r.probs, refs[8][i]), f"row {i} differs"


def test_closed_loop_exact_and_live(lenet_house):
    xs = lenet_inputs(5, seed=4)
    refs = solo_references(lenet_house.get("lenet"), xs)
    with engine_for(lenet_house, max_delay_ms=2.0) as eng:
        out = run_closed_loop(eng, "lenet", xs, clients=3, window=2,
                              duration_s=0.5, refs=refs)
        stats = eng.stats()
    assert out["completed"] > 0 and out["errors"] == 0
    assert out["exact_mismatches"] == 0
    assert stats["completed"] == out["completed"]
    assert sum(v["batches"] for v in stats["batch_ms"].values()) \
        == stats["dispatches"]


def test_cpu_engine_launches_no_kernel(lenet_house):
    ck.reset_launch_counts()
    with engine_for(lenet_house, max_delay_ms=0.0) as eng:
        eng.classify("lenet", lenet_inputs(1)[0])
    assert ck.launch_counts == dict.fromkeys(ck.launch_counts, 0)
    assert "lrn_across_channels" in ck.launch_counts


def test_two_requests_pad_to_middle_shape(lenet_house):
    with engine_for(lenet_house, max_delay_ms=150.0) as eng:
        futs = [eng.submit("lenet", x) for x in lenet_inputs(2)]
        res = [f.result(20.0) for f in futs]
    assert all(r.batch_n == 2 and r.padded_to == 4 for r in res)
    assert res[0].total_ms >= res[0].infer_ms >= 0


def test_full_batch_dispatches_before_deadline(lenet_house):
    with engine_for(lenet_house, max_delay_ms=5000.0) as eng:
        t0 = time.monotonic()
        res = [f.result(20.0) for f in
               [eng.submit("lenet", x) for x in lenet_inputs(8)]]
        elapsed = time.monotonic() - t0
    assert elapsed < 2.0
    assert all(r.padded_to == 8 and r.batch_n == 8 for r in res)


# ---------------------------------------------------------------------------
# Admission control and model lifetime
# ---------------------------------------------------------------------------

def test_queue_bound_rejects_typed_and_recovers():
    stub = _StubModel(fn=lambda b: (time.sleep(0.05),
                                    np.ones((b.shape[0], 3), np.float32))[1],
                      shapes=(1,))
    house = stub_house(stub, max_delay_ms=0.0, max_queue=4)
    accepted, rejected = [], 0
    with InferenceEngine(house, house.cfg) as eng:
        for _ in range(25):
            try:
                accepted.append(eng.submit("stub", np.ones(2, np.float32)))
            except Overloaded as e:
                assert e.reason == "queue_full"
                rejected += 1
        assert rejected > 0
        for f in accepted:
            f.result(20.0)
        assert eng.rejected["queue_full"] == rejected


def test_tenant_qps_cap_rejects_only_that_tenant():
    house = stub_house(_StubModel(), max_delay_ms=0.0,
                       tenant_qps={"acme": 2.0})
    with InferenceEngine(house, house.cfg) as eng:
        capped = 0
        for _ in range(10):
            try:
                eng.submit("stub", np.ones(2, np.float32), tenant="acme")
            except Overloaded as e:
                assert e.reason == "tenant_rate"
                capped += 1
        assert capped >= 6
        for _ in range(5):
            eng.submit("stub", np.ones(2, np.float32), tenant="other")
        assert eng.rejected["tenant_rate"] == capped


def test_unknown_model_and_wrong_shape_are_typed(lenet_house):
    with engine_for(lenet_house) as eng:
        with pytest.raises(UnknownModel, match="not loaded"):
            eng.submit("caffenet", np.zeros((3, 227, 227), np.float32))
        with pytest.raises(ServingError, match="expects input"):
            eng.submit("lenet", np.zeros((3, 10, 10), np.float32))
    with pytest.raises(UnknownModel, match="not in the zoo"):
        lenet_house.load("resnet50")
    assert "caffenet" not in lenet_house.loaded()


def test_over_budget_model_is_refused_before_warm_up():
    cfg = ServeConfig(batch_shapes=(1,), dtype="f32", hbm_budget_mb=1.0)
    with pytest.raises(OverBudget) as err:
        ModelHouse(cfg, device="cpu").load("lenet")
    assert err.value.param_mb > 1.0
    forced = ModelHouse(cfg, device="cpu").load("lenet", force=True)
    assert forced.param_bytes > 2**20


def test_lru_eviction_under_budget():
    cfg = ServeConfig(batch_shapes=(1,), dtype="f32")
    lenet_bytes = ModelHouse(cfg, device="cpu").load("lenet").param_bytes
    stub = _StubModel(param_bytes=lenet_bytes)
    house = stub_house(stub, batch_shapes=(1,),
                       hbm_budget_mb=lenet_bytes * 1.5 / 2**20)
    house.load("lenet")              # stub (older) + lenet > budget
    assert set(house.loaded()) == {"lenet"} and house.evictions == 1
    assert house.evict("lenet") is True and house.evict("lenet") is False


def test_stop_fails_queued_requests_typed():
    house = stub_house(_StubModel(), max_delay_ms=10_000.0)
    eng = InferenceEngine(house, house.cfg)
    fut = eng.submit("stub", np.ones(2, np.float32))
    eng.stop()
    with pytest.raises(EngineDead):
        fut.result(5.0)
    with pytest.raises(EngineDead):
        eng.submit("stub", np.ones(2, np.float32))


def test_model_failure_fails_batch_but_engine_survives():
    calls = []

    def fn(batch):
        calls.append(batch.shape[0])
        if len(calls) == 1:
            raise RuntimeError("boom")
        return np.ones((batch.shape[0], 3), np.float32)

    house = stub_house(_StubModel(fn=fn), max_delay_ms=0.0)
    with InferenceEngine(house, house.cfg) as eng:
        with pytest.raises(ServingError, match="boom"):
            eng.classify("stub", np.ones(2, np.float32), timeout=5.0)
        assert eng.classify("stub", np.ones(2, np.float32),
                            timeout=5.0).probs.shape == (3,)
        assert eng.failed == 1 and eng.alive


def test_non_finite_rows_are_refused():
    house = stub_house(_StubModel(fn=lambda b: np.full((b.shape[0], 3),
                                                       np.nan, np.float32)),
                       max_delay_ms=0.0)
    with InferenceEngine(house, house.cfg) as eng:
        with pytest.raises(ServingError, match="non-finite"):
            eng.classify("stub", np.ones(2, np.float32), timeout=5.0)


# ---------------------------------------------------------------------------
# Configuration and devices
# ---------------------------------------------------------------------------

def test_config_validation_and_env(monkeypatch):
    with pytest.raises(ValueError):
        ServeConfig(batch_shapes=(0, 4))
    with pytest.raises(ValueError):
        ServeConfig(dtype="f16")
    with pytest.raises(ValueError):
        ServeConfig(inflight_batches=0)
    assert ServeConfig(batch_shapes=(8, 1, 4)).batch_shapes == (1, 4, 8)
    monkeypatch.setenv("SPARKNET_SERVE_SHAPES", "2,32")
    monkeypatch.setenv("SPARKNET_SERVE_DTYPE", "f32")
    monkeypatch.setenv("SPARKNET_SERVE_QUOTAS", "acme=5")
    cfg = ServeConfig()
    assert cfg.batch_shapes == (2, 32) and cfg.dtype == "f32"
    assert dict(cfg.tenant_qps) == {"acme": 5.0}
    with pytest.raises(knobs.UnknownKnob):
        knobs.raw("SPARKNET_SERVE_TYPO")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ServeConfig(batch_shapes=(1,), dtype="f32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelHouse(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LoadedModel("lenet", lenet(1, 1), cfg)
    deploy, _ = deploy_from(lenet(1, 1), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Net(deploy).init()
