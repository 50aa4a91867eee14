"""The port's fusion pass (``sparknet_tpu_torch/graph/fusion.py``, the
horizontal and vertical fusion of ``graph/net.py``, the
``lrn_chain_epilogue`` of ``ops/vision.py``) against the JAX package's,
on the CPU.

Held equal to the JAX package:
- ``chain_candidates`` of every zoo net (members, kind, epilogue);
- ``fusion_worklist`` on the same ``op_table`` documents, but for the
  note on an LRN row (the JAX note cites a TPU finding; ROADMAP C);
- the ``plan_id`` of ``plan_from_profile`` on the same document.
Held within the tolerances of the port's net tests (rtol 1e-4, atol
1e-6 forward; the trainer's 2e-4/2e-5 for gradients): the fused forward
(``SPARKNET_FUSE=all``, horizontal fusion on) against the JAX fused
forward, on fusebench's synthetic net and a narrowed GoogLeNet.
The port against itself: fused against per-layer, the forward bit for
bit and gradients within rtol 1e-5 (f32); horizontal fusion against
``SPARKNET_NO_HFUSE=1``, the forward bit for bit and the gradients
within rtol 1e-6: on the CPU the wider convolution gives each output
channel the same bits, and the input's gradient sums the members'
contributions in another order (measured 3.4e-7 on fusebench's net).
Also: the plan sources (off, all, a plan file, ``auto`` reading only
the port's own captures), legality refusals, the unfused-run counter
and its instant event, and fusebench's gate with its planted faults.
"""

from __future__ import annotations

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.graph import fusion as jfusion
from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu.proto import load_net_prototxt as jax_load
from sparknet_tpu_torch import bench
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.graph import fusion
from sparknet_tpu_torch.graph import net as netmod
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.ops import vision
from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt
from sparknet_tpu_torch.tools import fusebench
from sparknet_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# nets as prototxt, parsed by each package
# ---------------------------------------------------------------------------

def _conv(name, bottom, n, k, pad=0, stride=1):
    return (f'layer {{ name: "{name}" type: "Convolution" bottom: '
            f'"{bottom}" top: "{name}" convolution_param {{ num_output: {n} '
            f'kernel_size: {k} pad: {pad} stride: {stride} weight_filler {{ '
            f'type: "gaussian" std: 0.1 }} bias_filler {{ type: "constant" '
            f'value: 0.1 }} }} }}\n')


def _relu(name, blob, slope=None):
    extra = (f" relu_param {{ negative_slope: {slope} }}"
             if slope is not None else "")
    return (f'layer {{ name: "{name}" type: "ReLU" bottom: "{blob}" '
            f'top: "{blob}"{extra} }}\n')


def _pool(name, bottom, k, s, pad=0, pool="MAX"):
    return (f'layer {{ name: "{name}" type: "Pooling" bottom: "{bottom}" '
            f'top: "{name}" pooling_param {{ pool: {pool} kernel_size: {k} '
            f'stride: {s} pad: {pad} }} }}\n')


def _lrn(name, bottom, within=False):
    region = " norm_region: WITHIN_CHANNEL" if within else ""
    return (f'layer {{ name: "{name}" type: "LRN" bottom: "{bottom}" '
            f'top: "{name}" lrn_param {{ local_size: 5 alpha: 0.001 '
            f'beta: 0.75{region} }} }}\n')


_INPUT = ('layer { name: "data" type: "Input" top: "data" top: "label" '
          'input_param { shape { dim: 2 dim: 3 dim: %d dim: %d } '
          'shape { dim: 2 } } }\n')
_HEAD = ('layer { name: "ip" type: "InnerProduct" bottom: "%s" top: "ip" '
         'inner_product_param { num_output: 5 weight_filler { '
         'type: "gaussian" std: 0.05 } } }\n'
         'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" '
         'bottom: "label" top: "loss" }\n')


def chain_net(*, pool=False, lrn=False, leaky=False, within=False) -> str:
    """conv -> relu [-> pool] [-> lrn] -> ip -> loss (the JAX
    test_fusion.py net)."""
    text = 'name: "chain"\n' + _INPUT % (10, 10) + _conv("conv", "data", 8,
                                                         3, pad=1)
    text += _relu("relu", "conv", 0.1 if leaky else None)
    head = "conv"
    if pool:
        text += _pool("pool", head, 2, 2)
        head = "pool"
    if lrn:
        text += _lrn("norm", head, within)
        head = "norm"
    return text + _HEAD % head


def _inception(p, bottom, n1, n3r, n3, n5r, n5, npool) -> str:
    t = ""
    for name, src, n, k, pad in ((f"{p}/1x1", bottom, n1, 1, 0),
                                 (f"{p}/3x3_reduce", bottom, n3r, 1, 0),
                                 (f"{p}/3x3", f"{p}/3x3_reduce", n3, 3, 1),
                                 (f"{p}/5x5_reduce", bottom, n5r, 1, 0),
                                 (f"{p}/5x5", f"{p}/5x5_reduce", n5, 5, 2)):
        t += _conv(name, src, n, k, pad) + _relu(f"{name}/relu", name)
    t += _pool(f"{p}/pool", bottom, 3, 1, pad=1)
    t += _conv(f"{p}/pool_proj", f"{p}/pool", npool, 1)
    t += _relu(f"{p}/pool_proj/relu", f"{p}/pool_proj")
    t += (f'layer {{ name: "{p}/output" type: "Concat" bottom: "{p}/1x1" '
          f'bottom: "{p}/3x3" bottom: "{p}/5x5" bottom: "{p}/pool_proj" '
          f'top: "{p}/output" }}\n')
    return t


def narrow_googlenet() -> str:
    """GoogLeNet's stem (the conv1 chain with the pool before its LRN,
    the conv2 chain with its ReLU folded into the LRN) and two narrow
    inception modules (a horizontal group each), on 32x32 inputs."""
    t = 'name: "GoogleNet"\n' + _INPUT % (32, 32)
    t += _conv("conv1/7x7_s2", "data", 8, 7, pad=3, stride=2)
    t += _relu("conv1/relu_7x7", "conv1/7x7_s2")
    t += _pool("pool1/3x3_s2", "conv1/7x7_s2", 3, 2)
    t += _lrn("pool1/norm1", "pool1/3x3_s2")
    t += _conv("conv2/3x3_reduce", "pool1/norm1", 8, 1)
    t += _relu("conv2/relu_3x3_reduce", "conv2/3x3_reduce")
    t += _conv("conv2/3x3", "conv2/3x3_reduce", 12, 3, pad=1)
    t += _relu("conv2/relu_3x3", "conv2/3x3")
    t += _lrn("conv2/norm2", "conv2/3x3")
    t += _pool("pool2/3x3_s2", "conv2/norm2", 3, 2)
    t += _inception("inception_3a", "pool2/3x3_s2", 4, 4, 6, 2, 3, 3)
    t += _inception("inception_3b", "inception_3a/output", 6, 4, 6, 2, 4, 4)
    t += _pool("pool5", "inception_3b/output", 4, 1, pool="AVE")
    return t + _HEAD % "pool5"


def _port(text: str, fuse: str = "off", *, hfuse: bool = True,
          dtype=None) -> Net:
    env = {"SPARKNET_FUSE": fuse}
    if not hfuse:
        env["SPARKNET_NO_HFUSE"] = "1"
    with mock.patch.dict(os.environ, env):
        return Net(load_net_prototxt(text), NetState(Phase.TRAIN),
                   compute_dtype=dtype)


def _jax(text: str, fuse: str = "off") -> JaxNet:
    with mock.patch.dict(os.environ, {"SPARKNET_FUSE": fuse}):
        return JaxNet(jax_load(text), JaxNetState(JaxPhase.TRAIN))


def _inputs(net: Net, seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    return {"data": r.normal(size=net.input_blobs["data"]).astype(
        np.float32),
        "label": r.integers(0, 5, size=net.input_blobs["label"]).astype(
            np.float32)}


def _run(net: Net, params: dict, ins: dict, grads: bool = True):
    """(loss, output blobs, {layer: [grad]}) of one forward (+backward)."""
    p = {k: [b.detach().clone().requires_grad_(grads) for b in v]
         for k, v in params.items()}
    out = net.forward(p, {k: torch.from_numpy(v) for k, v in ins.items()})
    if not grads:
        return out.loss.detach(), out.blobs, None
    out.loss.backward()
    return out.loss.detach(), out.blobs, {k: [b.grad for b in v]
                                          for k, v in p.items()}


def _max_rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)


# ---------------------------------------------------------------------------
# Legality and the worklist against the JAX package
# ---------------------------------------------------------------------------

def _zoo(name):
    from sparknet_tpu import models as jm
    from sparknet_tpu_torch import models as tm
    args = {"lenet": (4, 4), "cifar10_quick": (4, 4), "cifar10_full": (4, 4),
            "alexnet": (2, 2), "caffenet": (2, 2), "googlenet": (2, 2),
            "vgg16": (2, 2)}[name]
    return getattr(jm, name)(*args), getattr(tm, name)(*args)


@pytest.mark.parametrize("name", ["lenet", "cifar10_quick", "cifar10_full",
                                  "alexnet", "caffenet", "googlenet",
                                  "vgg16"])
def test_zoo_chain_candidates_equal_the_jax_packages(name):
    jp, tp = _zoo(name)
    with mock.patch.dict(os.environ, {"SPARKNET_FUSE": "off"}):
        jnet = JaxNet(jp, JaxNetState(JaxPhase.TRAIN))
        tnet = Net(tp, NetState(Phase.TRAIN))
    want = [(c.members, c.kind, c.epilogue)
            for c in jfusion.chain_candidates(jnet)]
    got = [(c.members, c.kind, c.epilogue)
           for c in fusion.chain_candidates(tnet)]
    assert got == want
    assert set(tnet._hfuse_first) == set(jnet._hfuse_first)
    if name == "googlenet":
        assert ("conv2/3x3", "relu+lrn") in {(m[0], e) for m, _, e in got}
        assert len(tnet._hfuse_first) == 9


def _strip_notes(wl: dict) -> dict:
    return {**wl, "candidates": [{k: v for k, v in c.items() if k != "note"}
                                 for c in wl["candidates"]]}


@pytest.mark.parametrize("model", ["googlenet", "googlenet_bf16", "caffenet",
                                   "caffenet_cpu"])
def test_worklist_and_plan_id_equal_the_jax_packages(model):
    # the JAX package's committed captures as documents only
    with open(os.path.join(REPO, "profiles", model, "op_table.json")) as f:
        doc = json.load(f)
    assert (_strip_notes(fusion.fusion_worklist(doc))
            == _strip_notes(jfusion.fusion_worklist(doc)))
    base = model.split("_")[0]
    jp, tp = _zoo(base)
    with mock.patch.dict(os.environ, {"SPARKNET_FUSE": "off"}):
        jnet = JaxNet(jp, JaxNetState(JaxPhase.TRAIN))
        tnet = Net(tp, NetState(Phase.TRAIN))
    jplan = jfusion.plan_from_profile(jnet, doc, source="x")
    tplan = fusion.plan_from_profile(tnet, doc, source="x")
    assert tplan.plan_id() == jplan.plan_id()
    assert tplan.to_doc() == jplan.to_doc()


def test_worklist_skips_the_ports_unattributed_row():
    doc = {"by_layer": [
        {"op": "norm", "total_ms": 30.0, "pct": 20.0, "gb_per_s": 500.0,
         "gflops_per_s": 100.0},
        {"op": "(unattributed)", "total_ms": 30.0, "pct": 20.0,
         "gb_per_s": 100.0},
        {"op": "a+b", "total_ms": 20.0, "pct": 10.0, "gb_per_s": 1000.0}]}
    wl = fusion.fusion_worklist(doc)
    assert [c["chain"] for c in wl["candidates"]] == ["norm"]
    assert wl["fused_chains"][0]["at_ref_band"] is True


@pytest.mark.parametrize("kw, members, epilogue", [
    ({"pool": True, "lrn": True}, ["conv", "relu", "pool", "norm"], "lrn"),
    ({"lrn": True}, ["conv", "relu", "norm"], "relu+lrn"),
    ({}, ["conv", "relu"], "none"),
    ({"lrn": True, "leaky": True}, ["conv", "relu", "norm"], "lrn"),
    ({"lrn": True, "within": True}, ["conv", "relu", "norm"], "none"),
])
def test_chain_legality_equals_the_jax_packages(kw, members, epilogue):
    text = chain_net(**kw)
    (c,) = fusion.chain_candidates(_port(text))
    (j,) = jfusion.chain_candidates(_jax(text))
    assert (c.members, c.kind, c.epilogue) == (j.members, j.kind,
                                               j.epilogue)
    assert (c.members, c.epilogue) == (members, epilogue)


def test_fanout_inplace_reread_and_rng_members_are_refused():
    fan = ('name: "fan"\nlayer { name: "data" type: "Input" top: "data" '
           'input_param { shape { dim: 1 dim: 3 dim: 6 dim: 6 } } }\n'
           + _conv("conv", "data", 4, 3, pad=1)
           + 'layer { name: "relu" type: "ReLU" bottom: "conv" top: "r" }\n'
           'layer { name: "cat" type: "Concat" bottom: "conv" bottom: "r" '
           'top: "out" }\n')
    assert fusion.chain_candidates(_port(fan)) == []
    reread = ('name: "ver"\nlayer { name: "data" type: "Input" top: "data" '
              'input_param { shape { dim: 1 dim: 3 dim: 6 dim: 6 } } }\n'
              + _conv("conv", "data", 4, 3, pad=1)
              + _conv("side", "conv", 4, 3, pad=1) + _relu("relu", "conv")
              + 'layer { name: "cat" type: "Concat" bottom: "conv" '
              'bottom: "side" top: "out" }\n')
    assert fusion.chain_candidates(_port(reread)) == []
    drop = chain_net().replace(
        'layer { name: "ip"',
        'layer { name: "drop" type: "Dropout" bottom: "conv" top: "conv" }'
        '\nlayer { name: "ip"')
    (c,) = fusion.chain_candidates(_port(drop))
    assert c.members == ["conv", "relu"]


def test_hfuse_members_are_off_limits_to_vertical_chains():
    net = _port(narrow_googlenet(), "all")
    hf = {m.lp.name for ms in net._hfuse_first.values() for m in ms}
    assert hf == {f"inception_{b}/{n}" for b in ("3a", "3b")
                  for n in ("1x1", "3x3_reduce", "5x5_reduce")}
    assert not hf & (set(net._vfuse_head) | net._vfuse_member)


# ---------------------------------------------------------------------------
# Plan sources
# ---------------------------------------------------------------------------

def test_off_all_and_a_stable_plan_id():
    assert _port(chain_net(lrn=True), "off").fuse_plan_id() == "off"
    a = _port(chain_net(lrn=True), "all")
    b = _port(chain_net(lrn=True), "all")
    c = _port(chain_net(pool=True, lrn=True), "all")
    assert list(a._vfuse_head) == ["conv"]
    assert a.fuse_plan_id() == b.fuse_plan_id() != c.fuse_plan_id()
    assert a.fuse_plan_id() == _jax(chain_net(lrn=True), "all").fuse_plan_id()


def test_plan_file_roundtrip_drift_refusal_and_version_gate(tmp_path):
    net = _port(chain_net(pool=True, lrn=True), "all")
    path = str(tmp_path / "fusion_plan.json")
    net._fuse_plan.save(path)
    replay = _port(chain_net(pool=True, lrn=True), path)
    assert replay.fuse_plan_id() == net.fuse_plan_id()
    assert replay._fuse_plan.source == f"file:{path}"
    drifted = _port(chain_net(lrn=True), path)
    assert drifted._vfuse_head == {}
    assert any("not legal" in r["reason"]
               for r in drifted._fuse_plan.refused)
    future = tmp_path / "future.json"
    future.write_text(json.dumps({"version": fusion.PLAN_VERSION + 1}))
    with pytest.raises(ValueError, match="newer"):
        fusion.FusionPlan.load(str(future))
    with pytest.raises(ValueError, match="SPARKNET_FUSE"):
        _port(chain_net(), "onn")


def test_profile_plan_fuses_worklist_hits_and_refuses_misses():
    table = {"by_layer": [
        {"op": "norm", "total_ms": 50.0, "pct": 40.0, "gb_per_s": 500.0,
         "gflops_per_s": 100.0},
        {"op": "ghost", "total_ms": 20.0, "pct": 20.0, "gb_per_s": 300.0},
        {"op": "ip", "total_ms": 30.0, "pct": 30.0, "gb_per_s": 1100.0},
    ]}
    plan = fusion.plan_from_profile(_port(chain_net(pool=True, lrn=True)),
                                    table, source="auto:test")
    assert [c.members for c in plan.chains] == [
        ["conv", "relu", "pool", "norm"]]
    assert plan.chains[0].source["reclaimable_ms"] is not None
    assert [r["candidate"] for r in plan.refused] == ["ghost"]


def test_auto_without_a_port_capture_plans_nothing():
    # VGG-16 has a JAX capture (profiles/vgg16, TPU) and no port capture
    from sparknet_tpu_torch.models import vgg16
    assert os.path.isfile(os.path.join(REPO, "profiles", "vgg16",
                                       "op_table.json"))
    assert not os.path.exists(os.path.join(
        REPO, "sparknet_tpu_torch", "profiles", "vgg16"))
    with mock.patch.dict(os.environ, {"SPARKNET_FUSE": "auto"}):
        net = Net(vgg16(2, 2), NetState(Phase.TRAIN))
    assert net._fuse_plan.source == "auto:no-profile"
    assert net.fuse_plan_id() == "off" and fusion.chain_candidates(net)


def test_the_committed_captures_drive_the_auto_plans():
    """The port's captures, taken on the card, rank GoogLeNet's conv1
    chain (the pool before its LRN) and its conv2 chain (the ReLU folded
    into the LRN), and CaffeNet's conv1 and conv2 chains."""
    from sparknet_tpu_torch.models import caffenet, googlenet
    want = {"googlenet": {"conv1/7x7_s2": "lrn", "conv2/3x3": "relu+lrn"},
            "caffenet": {"conv1": "lrn", "conv2": "lrn"}}
    for name, build in (("googlenet", googlenet), ("caffenet", caffenet)):
        with mock.patch.dict(os.environ, {"SPARKNET_FUSE": "auto"}):
            net = Net(build(2, 2), NetState(Phase.TRAIN))
        assert net._fuse_plan.source == (
            f"auto:sparknet_tpu_torch/profiles/{name}/op_table.json")
        assert {h: c.epilogue for h, c in net._vfuse_head.items()} == \
            want[name]
        recorded = fusion.FusionPlan.load(os.path.join(
            REPO, "sparknet_tpu_torch", "profiles", name,
            "fusion_plan.json"))
        assert recorded.plan_id() == net.fuse_plan_id()
        with open(os.path.join(REPO, "sparknet_tpu_torch", "profiles", name,
                               "op_table.json")) as f:
            device = json.load(f)["summary"]["device"]
        assert device.startswith("cuda/NVIDIA H100")


def test_auto_reads_only_the_ports_own_captures(tmp_path):
    # the root profiles/googlenet/op_table.json (a TPU capture of the JAX
    # package) exists, and the JAX auto plan reads it ...
    assert os.path.isfile(os.path.join(REPO, "profiles", "googlenet",
                                       "op_table.json"))
    text = narrow_googlenet()
    assert _jax(text, "auto")._fuse_plan.source.startswith(
        "auto:profiles/googlenet")
    # ... the port's never does: with no capture of its own, no profile
    with mock.patch.object(fusion, "_PKG_ROOT", str(tmp_path)):
        net = _port(text, "auto")
    assert net._fuse_plan.source == "auto:no-profile"
    assert net.fuse_plan_id() == "off"
    # a capture of the port's own drives it
    cap = tmp_path / "profiles" / "googlenet"
    cap.mkdir(parents=True)
    (cap / "op_table.json").write_text(json.dumps({"by_layer": [
        {"op": "conv2/norm2", "total_ms": 5.0, "pct": 5.0,
         "gb_per_s": 400.0, "gflops_per_s": 10.0},
        {"op": "conv2/relu_3x3", "total_ms": 5.0, "pct": 5.0,
         "gb_per_s": 2000.0, "gflops_per_s": 1.0}]}))
    with mock.patch.object(fusion, "_PKG_ROOT", str(tmp_path)):
        net = _port(text, "auto")
    assert net._fuse_plan.source == (
        f"auto:{os.path.basename(tmp_path)}/profiles/googlenet/"
        f"op_table.json")
    assert [c.scope() for c in net._fuse_plan.chains] == [
        "conv2/3x3+conv2/relu_3x3+conv2/norm2"]


# ---------------------------------------------------------------------------
# Execution: fused against per-layer, and against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["relu", "pool", "lrn", "pool_lrn",
                                   "leaky_lrn", "within_lrn"])
def test_fused_chain_forward_bit_for_bit_gradients_1e5(shape):
    text = chain_net(pool="pool" in shape, lrn="lrn" in shape,
                     leaky="leaky" in shape, within="within" in shape)
    off, fused = _port(text, "off"), _port(text, "all")
    assert fused._vfuse_head
    params = off.init(device="cpu")
    ins = _inputs(off)
    l0, _, g0 = _run(off, params, ins)
    l1, _, g1 = _run(fused, params, ins)
    assert torch.equal(l0, l1)
    for k in g0:
        for a, b in zip(g0[k], g1[k]):
            assert _max_rel(b, a) <= 1e-5, k


def test_fused_forward_bit_for_bit_under_bf16():
    text = chain_net(pool=True, lrn=True)
    params = _port(text).init(device="cpu")
    ins = _inputs(_port(text))
    l0 = _run(_port(text, "off", dtype=torch.bfloat16), params, ins, False)
    l1 = _run(_port(text, "all", dtype=torch.bfloat16), params, ins, False)
    assert torch.equal(l0[0], l1[0])


def test_hfuse_against_per_layer_on_the_narrow_googlenet():
    text = narrow_googlenet()
    per_layer, hfused = _port(text, hfuse=False), _port(text)
    assert len(hfused._hfuse_first) == 2 and not per_layer._hfuse_enabled
    params = hfused.init(device="cpu")
    ins = _inputs(hfused)
    l0, b0, g0 = _run(per_layer, params, ins)
    l1, b1, g1 = _run(hfused, params, ins)
    assert torch.equal(l0, l1)
    assert all(torch.equal(b0[k], b1[k]) for k in b0)
    worst = max(_max_rel(b, a) for k in g0 for a, b in zip(g0[k], g1[k]))
    assert worst <= 1e-6


@pytest.mark.parametrize("which", ["fusebench", "narrow_googlenet"])
def test_fused_forward_against_the_jax_fused_forward(which):
    if which == "fusebench":
        from sparknet_tpu_torch.models.dsl import net_param
        from sparknet_tpu_torch.proto import save_net_prototxt
        text = save_net_prototxt(net_param(
            "fusebench", fusebench._build_layers(2)))
    else:
        text = narrow_googlenet()
    jnet, tnet = _jax(text, "all"), _port(text, "all")
    assert (sorted(c.scope() for c in jnet._fuse_plan.chains)
            == sorted(c.scope() for c in tnet._fuse_plan.chains))
    assert tnet._hfuse_first and tnet._vfuse_head
    jparams = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, tnet, device="cpu")
    r = np.random.default_rng(0)
    ins = {"data": r.normal(size=tnet.input_blobs["data"]).astype(
        np.float32),
        "label": r.integers(0, 5, size=tnet.input_blobs["label"]).astype(
            np.float32)}
    jins = {k: jnp.asarray(v) for k, v in ins.items()}
    rng = jax.random.PRNGKey(1)
    jl, jg = jax.value_and_grad(
        lambda p: jnet.apply(p, jins, rng=rng).loss)(jparams)
    tl, _, tg = _run(tnet, tparams, ins)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4, atol=1e-6)
    for k in jg:
        for a, b in zip(tg[k], jg[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                       atol=2e-5, err_msg=k)


def test_lrn_chain_epilogue_folds_the_relu_as_relu_then_lrn_does():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, 3, 3)).astype(np.float32)).requires_grad_(True)
    y = vision.lrn_chain_epilogue(x, 5, 1e-2, 0.75, 1.0, relu=True)
    x2 = x.detach().clone().requires_grad_(True)
    y2 = vision.relu_lrn(torch.relu(x2), 5, 1e-2, 0.75, 1.0)
    assert torch.equal(y, y2)
    (torch.sin(y).sum()).backward()
    (torch.sin(y2).sum()).backward()
    assert torch.equal(x.grad, x2.grad)


def test_apply_all_and_apply_of_intermediates_run_per_layer():
    text = chain_net(lrn=True)
    net = _port(text, "all")
    params = net.init(device="cpu")
    ins = {k: torch.from_numpy(v) for k, v in _inputs(net).items()}
    blobs = net.apply_all(params, ins)
    assert "conv" in blobs and "norm" in blobs
    assert torch.equal(net.apply(params, ins, blobs=["norm"])["norm"],
                       blobs["norm"])
    assert torch.equal(net.forward(params, ins).loss, blobs["loss"])


# ---------------------------------------------------------------------------
# The unfused-run counter and its instant event
# ---------------------------------------------------------------------------

@pytest.fixture
def traced(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKNET_TELEMETRY", "1")
    monkeypatch.setenv("SPARKNET_TRACE_DIR", str(tmp_path))
    telemetry.reset()
    yield tmp_path
    telemetry.reset()


def _unfused_samples() -> dict:
    fam = telemetry.get_registry().snapshot().get(
        "fusion_unfused_runs_total") or {}
    return {tuple(sorted((s.get("labels") or {}).items())): s["value"]
            for s in fam.get("samples") or []}


def test_unfused_runs_are_counted_with_one_instant_per_reason(traced):
    net = _port(chain_net(lrn=True), "all")
    params = net.init(device="cpu")
    ins = {k: torch.from_numpy(v) for k, v in _inputs(net).items()}
    net.apply_all(params, ins, upto="relu")          # ranged
    net.apply_all(params, ins, upto="relu")          # same reason
    net.apply_all(params, ins)                       # introspect
    net.apply_all(params, ins, eps={"conv": torch.zeros(2, 8, 10, 10)})
    by_reason = _unfused_samples()
    assert by_reason[(("reason", "ranged"),)] == 2.0
    assert by_reason[(("reason", "introspect"),)] == 1.0
    assert by_reason[(("reason", "eps"),)] == 1.0
    telemetry.get_tracer().flush()
    names = []
    for fn in os.listdir(traced):
        if fn.startswith("trace_"):
            with open(traced / fn) as f:
                names += [json.loads(line)["name"] for line in f
                          if line.strip()]
    assert names.count("fusion.unfused_run") == 3


def test_a_full_fused_run_and_an_unfusable_net_count_nothing(traced):
    net = _port(chain_net(lrn=True), "all")
    params = net.init(device="cpu")
    ins = {k: torch.from_numpy(v) for k, v in _inputs(net).items()}
    net.forward(params, ins)
    plain = _port(chain_net(lrn=True), "off", hfuse=False)
    plain.apply_all(params, ins, upto="relu")
    assert not _unfused_samples()


# ---------------------------------------------------------------------------
# fusebench, its planted faults, and BENCH_FUSE
# ---------------------------------------------------------------------------

def _fusebench(tmp_path) -> tuple[int, dict]:
    out = str(tmp_path / "fb.json")
    rc = fusebench.main(["--device", "cpu", "--batch", "2", "--iters", "0",
                         "--out", out])
    with open(out) as f:
        return rc, json.load(f)


def test_fusebench_gate_passes(tmp_path):
    rc, rep = _fusebench(tmp_path)
    assert rc == 0, rep["failures"]
    assert rep["chains"] == fusebench.EXPECTED_CHAINS
    assert rep["hfuse_groups"] == fusebench.EXPECTED_HFUSE
    assert rep["grad_max_rel"] < 1e-5 and rep["hfuse_grad_max_rel"] < 1e-5


def test_fusebench_refuses_a_dropped_fold_and_swapped_slices(tmp_path):
    real = vision.lrn_chain_epilogue
    with mock.patch.object(
            vision, "lrn_chain_epilogue",
            lambda x, *a, relu, **kw: real(x, *a, relu=False, **kw)):
        rc, rep = _fusebench(tmp_path)
    assert rc == 1 and "f32 forward not bit-identical" in rep["failures"][0]
    with mock.patch.object(netmod, "_split_channels",
                           lambda y, sizes: tuple(reversed(
                               torch.split(y, list(sizes), dim=1)))):
        rc, rep = _fusebench(tmp_path)
    assert rc == 1 and "horizontal fusion" in rep["failures"][0]


def test_bench_fuse_reaches_the_childs_nets(monkeypatch):
    seen = {}
    monkeypatch.setenv("BENCH_FUSE", "all")
    # set, so that the teardown takes back what run_child writes
    monkeypatch.setenv("SPARKNET_FUSE", "off")
    monkeypatch.setattr(bench, "run", lambda cfg, device: seen.update(
        fuse=os.environ.get("SPARKNET_FUSE")) or {"metric": "m"})
    assert bench.run_child("cpu") == 0
    assert seen["fuse"] == "all"
    bench.BenchConfig.from_env()   # a plan source it accepts
