"""The port's lowering tuner (``sparknet_tpu_torch/graph/tuner.py``) and
its seams in ``ops/vision.py``, on the CPU.

Held equal to the JAX package (``sparknet_tpu/graph/tuner.py``): the key
grammar, the table schema and ``table_id``, the refusal of newer,
drifted, unparseable and wrong-backend tables, the ``SPARKNET_TUNE``
modes, the staleness check's verdicts, the ledger entries of a table,
the geometry predicates of the s2d and patches lowerings, and the key
strings of ``keys_for_net`` on CaffeNet and GoogLeNet, but for the
``relu+lrn`` difference: the port keys GoogLeNet's conv2 chain as
``lrn_epilogue/.../s5:relu1``, what its epilogue consults, where the
JAX function keys a plain ``lrn`` (ROADMAP C).  The port's own rules:
the bit-parity rule, a candidate that takes a hand kernel off the path
never winning on ``cuda``, each table pin reaching its layer (the
lowerings within rtol 1e-5 of the default on f32), unknown lowerings
refused, the table latched at Net construction, and
``tools/tune.py tunebench``.
"""

from __future__ import annotations

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from sparknet_tpu.graph import tuner as jtuner
from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.ops import vision as jvision
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu.proto import load_net_prototxt as jax_load
from sparknet_tpu_torch.graph import tuner
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.ops import vision
from sparknet_tpu_torch.ops.registry import get_layer_impl
from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt
from sparknet_tpu_torch.tools import tune
from sparknet_tpu_torch.utils import perfledger as pl
from sparknet_tpu_torch.utils.profiling import record_tuning
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

FAST = {"reps": 3, "target_s": 0.005, "warmup": 1, "device": "cpu"}
TINY_LRN = tuner.TuneKey("lrn", (2, 8, 6, 6), "f32", tuner.lrn_extra(5))


@pytest.fixture(autouse=True)
def _clean_tuner_state(monkeypatch):
    monkeypatch.delenv("SPARKNET_TUNE", raising=False)
    tuner._clear_caches()
    yield
    tuner.clear_extra_candidates()
    tuner._clear_caches()


_MEASURED: dict = {}


def _measured(key=TINY_LRN):
    s = str(key)
    if s not in _MEASURED:
        _MEASURED[s] = tuner.measure_key(key, **FAST)
    return _MEASURED[s]


def _tiny_table():
    # a copy: a test that mutates the table's document must not reach
    # the shared measurement
    return tuner.TuningTable("cpu", [json.loads(json.dumps(_measured()))])


def _pin_table(tmp_path, pins: dict, name="pins.json",
               backend="cpu") -> str:
    path = tmp_path / name
    tuner.TuningTable(backend, [{"key": k, "winner": w, "timings": {}}
                                for k, w in pins.items()]).save(str(path))
    return str(path)


# ---------------------------------------------------------------------------
# keys, registry, geometry predicates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", [
    TINY_LRN,
    tuner.TuneKey("conv", (4, 3, 9, 9), "bf16",
                  tuner.conv_extra(3, 3, 1, 1, 1, 1, 1, 1, 8, 2)),
    tuner.TuneKey("pool", (4, 8, 9, 9), "f32",
                  tuner.pool_extra(3, 3, 2, 2, 0, 0)),
    tuner.TuneKey("lrn_epilogue", (4, 8, 9, 9), "f32",
                  tuner.epilogue_extra(5, True)),
])
def test_key_strings_equal_the_jax_grammar_and_roundtrip(key):
    assert tuner.parse_key(str(key)) == key
    jkey = jtuner.TuneKey(key.op, key.shape, key.dtype, key.extra)
    assert str(key) == str(jkey)
    assert tuner.key_str(key.op, key.shape, tuner.torch_dtype(key.dtype),
                         key.extra) == jtuner.key_str(
        key.op, key.shape, jtuner.np_dtype(key.dtype), key.extra)


def test_registry_names_the_ports_lowerings():
    assert tuner.ops() == ["conv", "lrn", "lrn_epilogue", "pool"]
    names = {op: {c.name for c in tuner.candidates_for(op)}
             for op in tuner.ops()}
    assert names == {"lrn": {"cuda", "plain", "cumsum"},
                     "conv": {"native", "s2d", "im2col"},
                     "pool": {"cuda_bwd", "patches_max"},
                     "lrn_epilogue": {"cuda", "per_layer", "plain"}}
    off = {(op, c.name) for op in tuner.ops()
           for c in tuner.candidates_for(op) if c.off_kernel}
    assert off == {("lrn", "plain"), ("lrn", "cumsum"),
                   ("pool", "patches_max"), ("lrn_epilogue", "plain")}


def test_geometry_predicates_equal_the_jax_packages():
    for c in (3, 4, 16, 96):
        for k in (1, 2, 3, 7, 11):
            for s in (1, 2, 4):
                for p in (0, 1, 3):
                    for g in (1, 2):
                        args = (c, k, k, s, s, p, p, 1, 1, g)
                        assert vision.s2d_geometry_ok(*args) == \
                            jvision._s2d_geometry_ok(*args)
                    for h in (6, 13, 27):
                        pa = (h, h, k, k, s, s, p, p)
                        assert vision.patches_pool_ok(*pa) == \
                            jvision._patches_pool_ok(*pa)


# ---------------------------------------------------------------------------
# measure_key and the eligibility rules
# ---------------------------------------------------------------------------

def test_measure_key_shape_and_typed_cuda_skip():
    e = _measured()
    assert e["key"] == str(TINY_LRN) and e["op"] == "lrn"
    assert e["default"] == "plain"
    win = e["timings"][e["winner"]]
    assert "ms" in win and "disqualified" not in win
    assert "ineligible" not in win
    assert e["flip"] == (e["winner"] != e["default"])
    assert e["timings"]["cuda"]["skipped"].startswith("requires cuda")
    assert 0.05 <= e["noise_band"]


def test_numerics_failing_candidate_is_disqualified_never_wins():
    def bad_factory(key, prob):
        base = prob.fns["plain"]
        return lambda x: base(x) * 1.001
    tuner.register_candidate("lrn", tuner.Candidate("planted_bad"),
                             bad_factory)
    e = tuner.measure_key(TINY_LRN, **FAST)
    rec = e["timings"]["planted_bad"]
    assert "disqualified" in rec and "ms" in rec
    assert e["winner"] != "planted_bad"


def test_raising_candidate_records_typed_skip_and_run_continues():
    def raising(key, prob):
        raise RuntimeError("no such backend\nsecond line")
    tuner.register_candidate("lrn", tuner.Candidate("planted_raise"),
                             raising)
    e = tuner.measure_key(TINY_LRN, **FAST)
    assert e["timings"]["planted_raise"]["skipped"] == (
        "RuntimeError: no such backend")


def test_inexact_candidate_is_ineligible_unless_allowed():
    def off_factory(key, prob):
        base = prob.fns["plain"]
        return lambda x: base(x) * (1.0 + 1e-6)
    tuner.register_candidate(
        "lrn", tuner.Candidate("planted_inexact", exact=False, rtol=1e-4),
        off_factory)
    e = tuner.measure_key(TINY_LRN, **FAST)
    assert "ineligible" in e["timings"]["planted_inexact"]
    e2 = tuner.measure_key(TINY_LRN, allow_inexact=True, **FAST)
    assert "ineligible" not in e2["timings"]["planted_inexact"]


def test_off_kernel_candidates_never_win_on_cuda():
    """measure_key on a stand-in card: the candidates run on the CPU and
    the timer is stubbed, the eligibility rule is the real one."""
    class Card:
        type = "cuda"

    real_build = tuner._REGISTRY["lrn"].build

    def build(key, dev):
        prob = real_build(key, torch.device("cpu"))
        prob.fns["cuda"] = prob.fns["plain"]   # the card's default
        return prob

    def fake_time(calls, reps, target_s, warmup, device):
        for call in calls.values():
            call()
        return {name: (1.0, 0.0) for name in calls}

    spec = tuner._REGISTRY["lrn"]
    with mock.patch("sparknet_tpu_torch.utils.device.resolve_device",
                    return_value=Card()), \
            mock.patch.dict(tuner._REGISTRY, {"lrn": tuner.OpSpec(
                "lrn", spec.candidates, build, spec.default)}), \
            mock.patch.object(tuner, "_time_interleaved", fake_time):
        card = tuner.measure_key(TINY_LRN, allow_inexact=True, **FAST)
    assert card["default"] == card["winner"] == "cuda"
    for name in ("plain", "cumsum"):
        assert "hand-written kernel off the path" in \
            card["timings"][name]["ineligible"]


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

def test_table_roundtrip_and_id_equal_the_jax_packages(tmp_path):
    t = _tiny_table()
    p = str(tmp_path / "tuning.json")
    t.save(p)
    back = tuner.TuningTable.load(p)
    assert back.table_id() == t.table_id()
    assert back.winner(str(TINY_LRN)) == t.winner(str(TINY_LRN))
    assert back.winner("lrn/9x9x9x9/f32/s5") is None
    assert t.table_id() == jtuner.TuningTable("cpu", t.entries).table_id()
    assert jtuner.TuningTable.load(p).table_id() == t.table_id()


OFF_KERNEL = [("lrn", "plain"), ("lrn", "cumsum"), ("pool", "patches_max"),
              ("lrn_epilogue", "plain")]
OFF_KERNEL_EXTRA = {"lrn": "s5", "pool": tuner.pool_extra(3, 3, 2, 2, 0, 0),
                    "lrn_epilogue": "s5:relu1"}


def test_off_kernel_list_is_the_registrys():
    assert sorted(OFF_KERNEL) == sorted(
        (op, c.name) for op in tuner.ops()
        for c in tuner.candidates_for(op) if c.off_kernel)


@pytest.mark.parametrize("op, winner", OFF_KERNEL)
def test_cuda_table_naming_an_off_kernel_winner_is_refused(
        tmp_path, monkeypatch, op, winner):
    """A hand-edited or stale ``cuda`` table may not move a hand kernel's
    work to plain PyTorch: refused at load, by path and through
    ``SPARKNET_TUNE``; the same pin in a ``cpu`` table loads."""
    key = tuner.key_str(op, (2, 8, 13, 13), "f32", OFF_KERNEL_EXTRA[op])
    path = _pin_table(tmp_path, {key: winner}, backend="cuda")
    with pytest.raises(ValueError, match="off_kernel candidate never wins"):
        tuner.TuningTable.load(path)
    monkeypatch.setenv("SPARKNET_TUNE", path)
    with pytest.raises(ValueError, match="off_kernel candidate never wins"):
        tuner.active_table()
    cpu = tuner.TuningTable.load(_pin_table(tmp_path, {key: winner},
                                            name="cpu.json"))
    assert cpu.winner(key) == winner


@pytest.mark.parametrize("op, winner", OFF_KERNEL)
def test_seam_refuses_an_off_kernel_lowering_on_a_cuda_tensor(op, winner):
    """The seam's own check, on a stand-in CUDA tensor (the layers on a
    real one are held in ``test_torch_cuda_kernels.py``): a lowering its
    Net or the table hands it that takes the hand kernel off the path
    raises; the built-in lowering and a CPU tensor pass."""
    class OnCard:
        is_cuda = True
        shape = (2, 8, 13, 13)
        dtype = torch.float32

    with pytest.raises(ValueError, match="off_kernel candidate never wins"):
        vision._lowering(op, OnCard(), winner, None)
    assert vision._lowering(op, OnCard(), tuner.BUILTIN[op], None) == \
        tuner.BUILTIN[op]
    assert vision._lowering(op, torch.zeros(1), winner, None) == winner


@pytest.mark.parametrize("mutate, hint", [
    (lambda d: d.update(kind="op_table"), "not a tuning table"),
    (lambda d: d.update(version="one"), "no integer schema version"),
    (lambda d: d.update(version=tuner.TABLE_VERSION + 1), "newer"),
    (lambda d: d.pop("backend"), "refusing a drifted file"),
    (lambda d: d["entries"][0].pop("winner"), "refusing a drifted file"),
])
def test_drifted_table_refused_loudly(tmp_path, mutate, hint):
    doc = _tiny_table().to_doc()
    mutate(doc)
    p = str(tmp_path / "tuning.json")
    with open(p, "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match=hint):
        tuner.TuningTable.load(p)


def test_unparseable_and_cross_backend_tables_refused(tmp_path,
                                                      monkeypatch):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    with pytest.raises(ValueError, match="unparseable"):
        tuner.TuningTable.load(str(p))
    monkeypatch.setenv("SPARKNET_TUNE",
                       _pin_table(tmp_path, {str(TINY_LRN): "cuda"},
                                  backend="cuda"))
    with pytest.raises(ValueError, match="do not transfer across backends"):
        tuner.active_table()


def test_auto_finds_no_cpu_table_and_never_the_root_one(monkeypatch):
    assert os.path.isfile(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "profiles", "cpu", "tuning.json"))
    assert not os.path.exists(tuner.default_table_path("cpu"))
    monkeypatch.setenv("SPARKNET_TUNE", "auto")
    assert tuner.active_table() is None
    assert tuner.active_plan_id() == "off"


def test_resolve_modes_and_a_loud_typo(tmp_path, monkeypatch):
    t = _tiny_table()
    p = str(tmp_path / "tuning.json")
    t.save(p)
    monkeypatch.setenv("SPARKNET_TUNE", "off")
    assert tuner.active_table() is None
    assert tuner.resolve_lowering("lrn", TINY_LRN.shape, torch.float32,
                                  extra="s5") is None
    monkeypatch.setenv("SPARKNET_TUNE", p)
    assert tuner.active_plan_id() == t.table_id()
    assert tuner.resolve_lowering("lrn", TINY_LRN.shape, torch.float32,
                                  extra="s5") == t.winner(str(TINY_LRN))
    assert tuner.resolve_lowering("lrn", (1, 2, 3, 3), torch.float32,
                                  extra="s5") is None
    monkeypatch.setenv("SPARKNET_TUNE", "/no/such/tuning.json")
    with pytest.raises(ValueError, match="typo"):
        tuner.active_table()
    with pytest.raises(ValueError, match="typo"):
        Net(load_net_prototxt(_NET), NetState(Phase.TRAIN))


# ---------------------------------------------------------------------------
# pins reach the layers
# ---------------------------------------------------------------------------

def _lp(text: str):
    return load_net_prototxt(f'name: "x"\n{text}').layer[0]


LRN_LP = ('layer { name: "n" type: "LRN" bottom: "x" top: "y" lrn_param { '
          'local_size: 5 alpha: 0.0001 beta: 0.75 } }')
POOL_LP = ('layer { name: "p" type: "Pooling" bottom: "x" top: "y" '
           'pooling_param { pool: MAX kernel_size: 3 stride: 2 } }')


def _conv_lp(k, s, p, g, n=8):
    return _lp(f'layer {{ name: "c" type: "Convolution" bottom: "x" '
               f'top: "y" convolution_param {{ num_output: {n} '
               f'kernel_size: {k} stride: {s} pad: {p} group: {g} }} }}')


def _apply_with(tmp_path, monkeypatch, key, winner, layer, lp, params, x):
    monkeypatch.setenv("SPARKNET_TUNE", _pin_table(
        tmp_path, {key: winner}, name=f"{winner}.json"))
    tuner._clear_caches()
    x = x.detach().clone().requires_grad_(True)
    y = get_layer_impl(layer).apply(lp, params, [x], True)[0]
    y.float().sum().backward()
    return y.detach(), x.grad


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


@pytest.mark.parametrize("winner", ["plain", "cumsum", "cuda"])
def test_lrn_pins_reach_the_layer(tmp_path, monkeypatch, winner):
    x = _rand(2, 9, 5, 5)
    key = tuner.key_str("lrn", x.shape, x.dtype, "s5")
    ref = _apply_with(tmp_path, monkeypatch, key, "cuda", "LRN", _lp(LRN_LP),
                      [], x)
    with mock.patch.object(vision, "lrn_cumsum",
                           wraps=vision.lrn_cumsum) as cs:
        got = _apply_with(tmp_path, monkeypatch, key, winner, "LRN",
                          _lp(LRN_LP), [], x)
    assert cs.called == (winner == "cumsum")
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("winner, geom", [
    ("s2d", (4, 4, 0, 1)), ("s2d", (11, 4, 0, 1)), ("s2d", (3, 2, 1, 1)),
    ("im2col", (3, 1, 1, 2)), ("native", (3, 2, 1, 1))])
def test_conv_pins_reach_the_layer(tmp_path, monkeypatch, winner, geom):
    k, s, p, g = geom
    lp = _conv_lp(k, s, p, g)
    x = _rand(2, 4, 13, 13)
    params = [_rand(8, 4 // g, k, k, seed=1) * 0.1, _rand(8, seed=2)]
    key = tuner.key_str("conv", x.shape, x.dtype,
                        tuner.conv_extra(k, k, s, s, p, p, 1, 1, 8, g))
    y, dx = _apply_with(tmp_path, monkeypatch, key, winner, "Convolution",
                        lp, params, x)
    xr = x.clone().requires_grad_(True)
    want = torch.nn.functional.conv2d(xr, params[0], params[1], stride=s,
                                      padding=p, groups=g)
    want.sum().backward()
    np.testing.assert_allclose(y.numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_patches_pool_pin_is_bit_exact_and_refused_where_padded(
        tmp_path, monkeypatch):
    x = _rand(2, 3, 13, 13)
    key = tuner.key_str("pool", x.shape, x.dtype,
                        tuner.pool_extra(3, 3, 2, 2, 0, 0))
    got = _apply_with(tmp_path, monkeypatch, key, "patches_max", "Pooling",
                      _lp(POOL_LP), [], x)
    ref = _apply_with(tmp_path, monkeypatch, key, "cuda_bwd", "Pooling",
                      _lp(POOL_LP), [], x)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    x14 = _rand(2, 3, 14, 14)        # a ceil-mode remainder
    key = tuner.key_str("pool", x14.shape, x14.dtype,
                        tuner.pool_extra(3, 3, 2, 2, 0, 0))
    with pytest.raises(ValueError, match="drifted table"):
        _apply_with(tmp_path, monkeypatch, key, "patches_max", "Pooling",
                    _lp(POOL_LP), [], x14)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("winner", ["per_layer", "plain", "cuda"])
def test_epilogue_pins(tmp_path, monkeypatch, winner, relu):
    x = _rand(2, 8, 4, 4)
    monkeypatch.setenv("SPARKNET_TUNE", _pin_table(tmp_path, {
        tuner.key_str("lrn_epilogue", x.shape, x.dtype,
                      tuner.epilogue_extra(5, relu)): winner}))
    tuner._clear_caches()
    xr = x.clone().requires_grad_(True)
    y = vision.lrn_chain_epilogue(xr, 5, 1e-2, 0.75, 1.0, relu=relu)
    torch.sin(y).sum().backward()
    x2 = x.clone().requires_grad_(True)
    want = vision.relu_lrn(torch.relu(x2) if relu else x2, 5, 1e-2, 0.75,
                           1.0)
    torch.sin(want).sum().backward()
    assert torch.equal(y, want)
    np.testing.assert_allclose(xr.grad.numpy(), x2.grad.numpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("op, layer, lp", [
    ("lrn", "LRN", LRN_LP), ("pool", "Pooling", POOL_LP)])
def test_unknown_lowerings_are_refused(tmp_path, monkeypatch, op, layer, lp):
    x = _rand(2, 3, 13, 13)
    extra = "s5" if op == "lrn" else tuner.pool_extra(3, 3, 2, 2, 0, 0)
    key = tuner.key_str(op, x.shape, x.dtype, extra)
    with pytest.raises(ValueError, match="drifted table"):
        _apply_with(tmp_path, monkeypatch, key, "reduce_window", layer,
                    _lp(lp), [], x)
    conv_key = tuner.key_str("conv", x.shape, x.dtype,
                             tuner.conv_extra(3, 3, 1, 1, 1, 1, 1, 1, 8, 1))
    with pytest.raises(ValueError, match="drifted table"):
        _apply_with(tmp_path, monkeypatch, conv_key, "winograd",
                    "Convolution", _conv_lp(3, 1, 1, 1),
                    [_rand(8, 3, 3, 3), _rand(8)], x)
    with pytest.raises(ValueError, match="cannot express"):
        _apply_with(tmp_path, monkeypatch, conv_key, "s2d", "Convolution",
                    _conv_lp(3, 1, 1, 1), [_rand(8, 3, 3, 3), _rand(8)], x)
    monkeypatch.setenv("SPARKNET_TUNE", _pin_table(tmp_path, {
        tuner.key_str("lrn_epilogue", x.shape, x.dtype, "s5:relu1"):
            "reference"}, name="epi.json"))
    tuner._clear_caches()
    with pytest.raises(ValueError, match="drifted table"):
        vision.lrn_chain_epilogue(x, 5, 1e-4, 0.75, 1.0, relu=True)


# ---------------------------------------------------------------------------
# keys_for_net, against the JAX package, and the Net's latch
# ---------------------------------------------------------------------------

_NET = ('name: "t"\nlayer { name: "data" type: "Input" top: "data" '
        'top: "label" input_param { shape { dim: 2 dim: 3 dim: 12 dim: 12 }'
        ' shape { dim: 2 } } }\n'
        'layer { name: "c1" type: "Convolution" bottom: "data" top: "c1" '
        'convolution_param { num_output: 8 kernel_size: 3 pad: 1 '
        'weight_filler { type: "gaussian" std: 0.05 } } }\n'
        'layer { name: "r1" type: "ReLU" bottom: "c1" top: "c1" }\n'
        'layer { name: "p1" type: "Pooling" bottom: "c1" top: "p1" '
        'pooling_param { pool: MAX kernel_size: 2 stride: 2 } }\n'
        'layer { name: "n1" type: "LRN" bottom: "p1" top: "n1" lrn_param { '
        'local_size: 5 alpha: 0.0001 beta: 0.75 } }\n'
        'layer { name: "ip" type: "InnerProduct" bottom: "n1" top: "ip" '
        'inner_product_param { num_output: 5 weight_filler { '
        'type: "gaussian" std: 0.01 } } }\n'
        'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" '
        'bottom: "label" top: "loss" }\n')


def _nets(text_or_param, fuse):
    with mock.patch.dict(os.environ, {"SPARKNET_FUSE": fuse}):
        if isinstance(text_or_param, str):
            return (Net(load_net_prototxt(text_or_param),
                        NetState(Phase.TRAIN)),
                    JaxNet(jax_load(text_or_param),
                           JaxNetState(JaxPhase.TRAIN)))
        tp, jp = text_or_param
        return (Net(tp, NetState(Phase.TRAIN)),
                JaxNet(jp, JaxNetState(JaxPhase.TRAIN)))


def test_keys_for_net_unfused_and_lrn_epilogue_fused():
    net, jnet = _nets(_NET, "off")
    keys = [str(k) for k in tuner.keys_for_net(net)]
    assert keys == [str(k) for k in jtuner.keys_for_net(jnet)]
    by_op = {k.op: k for k in tuner.keys_for_net(net)}
    assert set(by_op) == {"conv", "pool", "lrn"}
    assert by_op["lrn"].shape == (2, 8, 6, 6)
    net, jnet = _nets(_NET, "all")
    keys = tuner.keys_for_net(net)
    assert [str(k) for k in keys] == [str(k)
                                      for k in jtuner.keys_for_net(jnet)]
    epi = next(k for k in keys if k.op == "lrn_epilogue")
    assert epi.extra == tuner.epilogue_extra(5, False)
    assert "lrn" not in [k.op for k in keys]


@pytest.mark.parametrize("model", ["caffenet", "googlenet"])
def test_zoo_keys_equal_the_jax_packages_but_for_relu_lrn(model):
    from sparknet_tpu import models as jm
    from sparknet_tpu_torch import models as tm
    pair = (getattr(tm, model)(4, 4), getattr(jm, model)(4, 4))
    net, jnet = _nets(pair, "off")
    assert [str(k) for k in tuner.keys_for_net(net)] == \
        [str(k) for k in jtuner.keys_for_net(jnet)]
    net, jnet = _nets(pair, "all")
    got = [str(k) for k in tuner.keys_for_net(net)]
    want = [str(k) for k in jtuner.keys_for_net(jnet)]
    if model == "caffenet":
        assert got == want      # its chains put the pool before the LRN
        return
    norm2 = "lrn/4x192x56x56/f32/s5"
    relu1 = "lrn_epilogue/4x192x56x56/f32/s5:relu1"
    assert norm2 in want and relu1 not in want
    assert relu1 in got and norm2 not in got
    assert [k for k in got if k != relu1] == [k for k in want if k != norm2]


def test_net_latches_its_table_and_record_tuning_copies_it(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("SPARKNET_TUNE", "off")
    assert Net(load_net_prototxt(_NET), NetState(Phase.TRAIN)
               ).tune_plan_id() == "off"
    x = torch.zeros(2, 8, 6, 6)
    key = tuner.key_str("lrn", x.shape, x.dtype, "s5")
    path = _pin_table(tmp_path, {key: "cumsum"})
    monkeypatch.setenv("SPARKNET_TUNE", path)
    net = Net(load_net_prototxt(_NET), NetState(Phase.TRAIN))
    table_id = tuner.TuningTable.load(path).table_id()
    assert net.tune_plan_id() == table_id == record_tuning(net)
    record_tuning(net, str(tmp_path))
    assert tuner.TuningTable.load(
        str(tmp_path / "tuning.json")).table_id() == table_id
    # the env changed after construction: the net keeps its table
    monkeypatch.setenv("SPARKNET_TUNE", "off")
    params = net.init(device="cpu")
    ins = {"data": _rand(2, 3, 12, 12), "label": torch.zeros(2)}
    with mock.patch.object(vision, "lrn_cumsum",
                           wraps=vision.lrn_cumsum) as cs:
        net.forward(params, ins)
    assert cs.call_count == 1


def test_net_resolves_lowerings_at_construction(tmp_path, monkeypatch):
    """Each seam node keeps what the table names for it at construction:
    a table of only built-in winners leaves every node with nothing to
    look up, and no run formats a key or reads the table; a pin reaches
    its node alone."""
    x = torch.zeros(2, 8, 6, 6)
    lrn_key = tuner.key_str("lrn", x.shape, x.dtype, "s5")
    conv_key = tuner.key_str("conv", (2, 3, 12, 12), "f32",
                             tuner.conv_extra(3, 3, 1, 1, 1, 1, 1, 1, 8, 1))
    pool_key = tuner.key_str("pool", (2, 8, 12, 12), "f32",
                             tuner.pool_extra(2, 2, 2, 2, 0, 0))
    monkeypatch.setenv("SPARKNET_TUNE", _pin_table(tmp_path, {
        lrn_key: "cuda", conv_key: "native", pool_key: "cuda_bwd"}))
    net = Net(load_net_prototxt(_NET), NetState(Phase.TRAIN))
    seams = {n.lp.name: n.tune for n in net.nodes if n.tune is not None}
    assert seams == {"c1": {}, "p1": {}, "n1": {}}
    params = net.init(device="cpu")
    ins = {"data": _rand(2, 3, 12, 12), "label": torch.zeros(2)}
    with mock.patch.object(tuner, "key_str", side_effect=AssertionError), \
            mock.patch.object(tuner, "active_table",
                              side_effect=AssertionError):
        net.forward(params, ins)
    monkeypatch.setenv("SPARKNET_TUNE", _pin_table(
        tmp_path, {lrn_key: "cumsum"}, name="cumsum.json"))
    net = Net(load_net_prototxt(_NET), NetState(Phase.TRAIN))
    assert {n.lp.name: n.tune for n in net.nodes if n.tune} == {
        "n1": {((2, 8, 6, 6), torch.float32): "cumsum"}}


# ---------------------------------------------------------------------------
# staleness, the ledger, tunebench
# ---------------------------------------------------------------------------

def test_staleness_fresh_table_passes_and_planted_rot_fails():
    e = _measured()
    fresh = tuner.staleness_check(tuner.TuningTable("cpu", [e]),
                                  budget_s=30.0, **FAST)
    assert fresh["ok"] and fresh["checked"] == 1
    rot_e = json.loads(json.dumps(e))
    rot_e["winner"] = "__gone__"
    rot = tuner.staleness_check(tuner.TuningTable("cpu", [rot_e]),
                                budget_s=30.0, **FAST)
    assert not rot["ok"]
    assert rot["rotten"][0]["fresh_timings"]


@pytest.mark.parametrize("second_ms, rotten", [(1.0, False), (2.0, True)])
def test_staleness_needs_rot_in_two_probes(second_ms, rotten):
    """A winner flagged once (a load burst on one candidate's timing) is
    probed again and is rotten only if that probe flags it too."""
    probes = iter([2.0, second_ms])

    def fake_measure(key, **kw):
        return {"winner": "b", "noise_band": 0.05, "timings": {
            "a": {"ms": next(probes)}, "b": {"ms": 1.0}}}

    entry = {"key": str(TINY_LRN), "op": "lrn", "winner": "a",
             "margin": 0.5, "noise_band": 0.05, "timings": {}}
    with mock.patch.object(tuner, "measure_key", fake_measure):
        rep = tuner.staleness_check(tuner.TuningTable("cpu", [entry]),
                                    budget_s=30.0, device="cpu")
    assert rep["ok"] is not rotten and rep["checked"] == 1
    (res,) = rep["results"]
    assert ("rotten" in res) is rotten and ("reprobed" in res) is not rotten


def test_entries_from_tuning_table_equal_the_jax_packages():
    from sparknet_tpu.utils import perfledger as jpl
    doc = _tiny_table().to_doc()
    got = pl.entries_from_any(doc, "x/tuning.json", round_tag="r18",
                              t=1.0)
    want = jpl.entries_from_any(doc, "x/tuning.json", round_tag="r18",
                                t=1.0)
    assert got and [e["metrics"] for e in got] == [e["metrics"]
                                                    for e in want]
    assert got[0]["fp"]["tune_plan"] == _tiny_table().table_id()
    assert got[0]["source"] == "tuning"
    assert pl.entries_from_tuning_table({"kind": "bench"}, "x") == []


def test_tunebench_passes_on_the_cpu(tmp_path):
    out = str(tmp_path / "tb.json")
    assert tune.main(["tunebench", "--device", "cpu", "--json", out]) == 0
    with open(out) as f:
        rep = json.load(f)
    assert rep["ok"] and rep["staleness_planted_caught"]
    assert rep["planted_bad"].startswith("declared exact")


def test_bench_keys_take_the_nets_plans():
    with mock.patch.dict(os.environ, {"SPARKNET_FUSE": "all"}):
        keys = [str(k) for k in tune.bench_keys(("googlenet",), batch=2)]
    assert "lrn_epilogue/2x192x56x56/f32/s5:relu1" in keys
    assert "lrn_epilogue/2x64x56x56/f32/s5:relu0" in keys
    assert sum(k.startswith("conv/") for k in keys) > 50
