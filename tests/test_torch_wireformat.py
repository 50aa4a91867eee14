"""The port's Caffe wire format and weight files against the JAX package's,
on the CPU.

- Bytes: ``encode`` of the same message gives identical bytes in both
  packages (NetParameter, SolverParameter, SolverState, BlobProto packed
  and unpacked), and each package decodes the other's bytes to equal
  messages.  Unknown field numbers are skipped; packed and unpacked floats
  both decode; a packed float record decodes to a view of the input
  bytes, not a copy.
- Files: ``.caffemodel`` (V2, and V1 ``layers`` as the BVLC zoo ships
  them), ``.solverstate`` and mean ``binaryproto`` files written by either
  package load in the other with bit-equal blobs; a legacy 4-d blob goes
  into an InnerProduct through either package's ``Solver``.
- The V1 upgrade: enum types, ``blobs_lr``/``weight_decay`` into
  ``ParamSpec``, old data-transformation fields into ``transform_param``,
  the same in both packages.

Every comparison here is exact: the codec moves f32 bits and integers.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sparknet_tpu.proto import caffemodel as jax_cm
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver_sp
from sparknet_tpu.proto import textformat as jax_tf
from sparknet_tpu.proto import wireformat as jax_wf
from sparknet_tpu.proto.caffe_pb import NetParameter as JaxNetParameter
from sparknet_tpu.proto.caffe_pb import SolverParameter as JaxSolverParameter
from sparknet_tpu.solvers import Solver as JaxSolver
from sparknet_tpu_torch.proto import (NetParameter, SolverParameter,
                                      caffemodel, load_solver_prototxt_with_net,
                                      textformat, wireformat)
from sparknet_tpu_torch.solvers import Solver
from test_torch_net import NARROW_CAFFENET

SOLVER_TEXT = """
net: "models/x/train_val.prototxt"
test_iter: 2 test_iter: 3
test_interval: 10
test_initialization: false
base_lr: 0.01
display: 20
average_loss: 4
max_iter: 450000
lr_policy: "multistep"
stepvalue: 100 stepvalue: 200
gamma: 0.1
momentum: 0.9
weight_decay: 0.0005
snapshot: 10000
snapshot_prefix: "models/x/caffe_x_train"
solver_mode: GPU
random_seed: -1
type: "Adam"
delta: 1e-6
momentum2: 0.995
rms_decay: 0.9
clip_gradients: -1.0
snapshot_format: BINARYPROTO
train_state { level: 2 stage: "a" }
test_state { stage: "b" }
"""

BLOB_TEXT = ("num: 1 channels: 2 height: 1 width: 3\n"
             "data: 1.5 data: -2.25 data: 3e-8 data: 4 data: 0 data: -0.0\n")


def _norm(v):
    """A decoded value as plain Python, for comparing messages of the two
    packages: numbers and arrays as lists of floats by their bits."""
    if hasattr(v, "items") and hasattr(v, "get_all"):
        out = {}
        for k, x in v.items():
            out.setdefault(k, []).append(_norm(x))
        return out
    if isinstance(v, np.ndarray):
        return ("array", str(v.dtype), v.tobytes())
    if isinstance(v, float):
        return ("float", np.float64(v).tobytes())
    return (type(v).__name__ if not isinstance(v, str) else "str", v)


def _both(text: str):
    return jax_tf.parse(text), textformat.parse(text)


def _state_msg(pm_cls, rng):
    m = pm_cls()
    m.add("iter", 1234)
    m.add("learned_net", "snap_iter_1234.caffemodel")
    m.add("current_step", 2)
    for shape in ((4, 3, 2, 2), (4,), (10, 16)):
        arr = rng.normal(size=shape).astype(np.float32)
        h = pm_cls()
        s = pm_cls()
        s.add("dim", np.asarray(shape, np.int64))
        h.add("shape", s)
        h.add("data", arr.ravel())
        m.add("history", h)
    return m


@pytest.mark.parametrize("kind", ["NetParameter", "SolverParameter",
                                  "SolverState", "BlobProto_packed",
                                  "BlobProto_unpacked"])
def test_encode_gives_the_same_bytes_and_each_decodes_the_others(kind):
    if kind == "NetParameter":
        jm, pm = _both(NARROW_CAFFENET)
    elif kind == "SolverParameter":
        jm, pm = _both(SOLVER_TEXT)
    elif kind == "SolverState":
        jm = _state_msg(jax_tf.PMessage, np.random.default_rng(0))
        pm = _state_msg(textformat.PMessage, np.random.default_rng(0))
    elif kind == "BlobProto_packed":
        arr = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)
        jm, pm = jax_tf.PMessage(), textformat.PMessage()
        for m in (jm, pm):
            m.add("data", arr.ravel())
            m.add("diff", arr.ravel() * 2)
            m.add("num", 3)
            m.add("channels", 5)
    else:   # text-parsed scalars: one packed record per float
        jm, pm = _both(BLOB_TEXT)
    msg_type = kind.split("_")[0]
    jb, pb = jax_wf.encode(jm, msg_type), wireformat.encode(pm, msg_type)
    assert pb == jb and len(pb) > 0
    assert _norm(wireformat.decode(jb, msg_type)) == \
        _norm(jax_wf.decode(jb, msg_type))
    assert _norm(jax_wf.decode(pb, msg_type)) == \
        _norm(wireformat.decode(pb, msg_type))
    # re-encoding the decoded message is byte-stable in both
    assert wireformat.encode(wireformat.decode(pb, msg_type), msg_type) == \
        jax_wf.encode(jax_wf.decode(pb, msg_type), msg_type)


def test_solver_parameter_fields_survive_the_wire():
    raw = wireformat.encode(textformat.parse(SOLVER_TEXT), "SolverParameter")
    sp = SolverParameter.from_pmsg(wireformat.decode(raw, "SolverParameter"))
    jsp = JaxSolverParameter.from_pmsg(jax_wf.decode(raw, "SolverParameter"))
    for field in ("net", "test_iter", "test_interval", "test_initialization",
                  "display", "average_loss", "max_iter", "lr_policy",
                  "stepvalue", "snapshot", "snapshot_prefix", "random_seed",
                  "solver_type", "snapshot_format", "debug_info"):
        assert getattr(sp, field) == getattr(jsp, field), field
    for field in ("base_lr", "gamma", "momentum", "weight_decay", "delta",
                  "momentum2", "rms_decay", "clip_gradients"):
        assert np.float32(getattr(sp, field)) == np.float32(
            getattr(jsp, field)), field
    assert sp.solver_type == "ADAM" and sp.test_iter == [2, 3]
    assert sp.train_state.phase.name == "TRAIN" and sp.train_state.level == 2
    assert [(s.phase.name, s.stage) for s in sp.test_state] == [
        ("TEST", ["b"])]


def test_unknown_fields_are_skipped_and_unpacked_floats_decode():
    arr = np.asarray([1.5, -2.0, 7.25], np.float32)
    m = textformat.PMessage()
    m.add("data", arr)
    raw = bytearray(wireformat.encode(m, "BlobProto"))

    def tag(num, wire):   # a two-byte varint key (fields 16-2047)
        key = num << 3 | wire
        return bytes([key & 0x7F | 0x80, key >> 7])

    # unknown fields 97-99: a varint, a fixed32, a length-delimited and a
    # fixed64 record
    raw += tag(99, 0) + bytes([0x96, 0x01])
    raw += tag(99, 5) + b"abcd"
    raw += tag(98, 2) + bytes([2]) + b"zz"
    raw += tag(97, 1) + bytes(8)
    # the same floats unpacked: one fixed32 record each (field 5, wire 5)
    for v in arr:
        raw += bytes([5 << 3 | 5]) + np.float32(v).tobytes()
    raw = bytes(raw)
    for dec in (wireformat.decode, jax_wf.decode):
        got = caffemodel.blob_to_array(dec(raw, "BlobProto"))
        np.testing.assert_array_equal(got, np.concatenate([arr, arr]))


def test_packed_floats_decode_as_a_view_of_the_bytes():
    arr = np.arange(1000, dtype=np.float32)
    m = textformat.PMessage()
    m.add("data", arr)
    raw = wireformat.encode(m, "BlobProto")
    got = wireformat.decode(raw, "BlobProto").get("data")
    assert not got.flags.owndata and not got.flags.writeable
    np.testing.assert_array_equal(got, arr)


def _params(rng):
    return {"conv1": [rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
                      rng.normal(size=(4,)).astype(np.float32)],
            "fc1": [rng.normal(size=(10, 36)).astype(np.float32)],
            "empty_shape": [np.zeros((0,), np.float32)]}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_caffemodel_written_by_either_loads_in_the_other(writer, tmp_path):
    params = _params(np.random.default_rng(2))
    net = JaxNetParameter(name="net") if writer == "jax" else \
        NetParameter(name="net")
    path = str(tmp_path / "w.caffemodel")
    if writer == "jax":
        jax_cm.save_caffemodel(path, params, net)
    else:   # tensors are written as they are
        caffemodel.save_caffemodel(
            path, {k: [torch.from_numpy(b) for b in v]
                   for k, v in params.items()}, net)
    for loaded in (caffemodel.load_caffemodel(path),
                   jax_cm.load_caffemodel(path)):
        assert list(loaded) == ["conv1", "fc1", "empty_shape"]
        for k, blobs in params.items():
            for a, b in zip(blobs, loaded[k]):
                assert a.shape == b.shape and a.tobytes() == b.tobytes()
    assert caffemodel.load_net_binaryproto(path).name == "net"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_solverstate_and_mean_written_by_either_load_in_the_other(
        writer, tmp_path):
    rng = np.random.default_rng(3)
    hist = [rng.normal(size=s).astype(np.float32)
            for s in ((4, 3, 3, 3), (4,), (10, 36))]
    mean = rng.normal(scale=50, size=(3, 8, 6)).astype(np.float32)
    st, mp = str(tmp_path / "s.solverstate"), str(tmp_path / "m.binaryproto")
    mod = jax_cm if writer == "jax" else caffemodel
    mod.save_solverstate(st, 42, hist, learned_net="m.caffemodel",
                         current_step=7)
    mod.save_mean_binaryproto(mp, mean)
    for reader in (caffemodel, jax_cm):
        back = reader.load_solverstate(st)
        assert (back["iter"], back["current_step"], back["learned_net"]) == \
            (42, 7, "m.caffemodel")
        for a, b in zip(hist, back["history"]):
            assert a.shape == b.shape and a.tobytes() == b.tobytes()
        got = reader.load_mean_binaryproto(mp)
        assert got.shape == mean.shape and got.tobytes() == mean.tobytes()


def test_both_packages_write_identical_files(tmp_path):
    params = _params(np.random.default_rng(4))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax_cm.save_caffemodel(a, params, JaxNetParameter(name="n"))
    caffemodel.save_caffemodel(b, params, NetParameter(name="n"))
    assert open(a, "rb").read() == open(b, "rb").read()
    hist = params["conv1"] + params["fc1"]
    jax_cm.save_solverstate(a, 9, hist, learned_net="x")
    caffemodel.save_solverstate(b, 9, hist, learned_net="x")
    assert open(a, "rb").read() == open(b, "rb").read()


def _v1_net_bytes(pm_cls, encode, w, b):
    """A V1 ``layers`` net as the BVLC zoo files carry (the construction
    of tests/test_wireformat.py:151-173), with blobs_lr/weight_decay and
    an old-style data layer."""
    def blob(arr):
        m = pm_cls()
        s = pm_cls()
        s.add("dim", np.asarray(arr.shape, np.int64))
        m.add("shape", s)
        m.add("data", arr.ravel())
        return m

    data = pm_cls()
    data.add("name", "data")
    data.add("type", "DATA")
    data.add("top", "data")
    dp = pm_cls()
    dp.add("source", "train_lmdb")
    dp.add("crop_size", 227)
    dp.add("mirror", True)
    data.add("data_param", dp)
    ip = pm_cls()
    for k, v in (("name", "ip1"), ("type", "INNER_PRODUCT"),
                 ("bottom", "data"), ("top", "ip1")):
        ip.add(k, v)
    ip.add("blobs", blob(w))
    ip.add("blobs", blob(b))
    for lr, wd in ((1.0, 1.0), (2.0, 0.0)):
        ip.add("blobs_lr", lr)
        ip.add("weight_decay", wd)
    relu = pm_cls()
    for k, v in (("name", "relu1"), ("type", "RELU"), ("bottom", "ip1"),
                 ("top", "ip1")):
        relu.add(k, v)
    net = pm_cls()
    net.add("name", "v1net")
    for l in (data, ip, relu):
        net.add("layers", l)
    return encode(net, "NetParameter")


def test_v1_caffemodel_upgrades_the_same_in_both(tmp_path):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(2, 3)).astype(np.float32)
    b = rng.normal(size=(2,)).astype(np.float32)
    raw = _v1_net_bytes(textformat.PMessage, wireformat.encode, w, b)
    assert raw == _v1_net_bytes(jax_tf.PMessage, jax_wf.encode, w, b)
    net = caffemodel.load_net_binaryproto(raw)
    jnet = jax_cm.load_net_binaryproto(raw)
    assert [(l.name, l.type) for l in net.layer] == \
        [(l.name, l.type) for l in jnet.layer] == [
            ("data", "Data"), ("ip1", "InnerProduct"), ("relu1", "ReLU")]
    ip, jip = net.layer[1], jnet.layer[1]
    assert [(p.lr_mult, p.decay_mult, p.raw_lr_mult, p.raw_decay_mult)
            for p in ip.param] == \
        [(p.lr_mult, p.decay_mult, p.raw_lr_mult, p.raw_decay_mult)
         for p in jip.param] == [(1.0, 1.0, 1.0, 1.0), (2.0, 0.0, 2.0, 0.0)]
    tp = net.layer[0].sub("transform_param")
    assert (int(tp.get("crop_size")), bool(tp.get("mirror"))) == (227, True)
    assert not net.layer[0].sub("data_param").has("crop_size")
    path = tmp_path / "v1.caffemodel"
    path.write_bytes(raw)
    for loaded in (caffemodel.load_caffemodel(str(path)),
                   jax_cm.load_caffemodel(str(path))):
        assert list(loaded) == ["ip1"]
        assert loaded["ip1"][0].tobytes() == w.tobytes()
        assert loaded["ip1"][1].tobytes() == b.tobytes()


LEGACY_NET = """
name: "legacy"
layer { name: "in" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 2 dim: 5 } shape { dim: 2 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
"""


def test_legacy_4d_blob_loads_into_an_inner_product_in_both(tmp_path):
    """A (num, channels, height, width) = (1, 1, 4, 5) BlobProto, the
    legacy spelling of an InnerProduct weight (tests/test_wireformat.py:
    130-148), goes into the (4, 5) weight through either Solver; a
    transposed (5, 4) weight of the same size raises in both."""
    from sparknet_tpu.proto import load_net_prototxt as jax_load_net
    from sparknet_tpu_torch.proto import load_net_prototxt
    w = np.arange(20, dtype=np.float32) / 7.0
    bias = np.float32([0.5, -1, 2, 3])
    m = textformat.PMessage()
    for k, v in zip(("num", "channels", "height", "width"), (1, 1, 4, 5)):
        m.add(k, v)
    m.add("data", w)
    b = textformat.PMessage()
    b.add("data", bias)
    layer = textformat.PMessage()
    layer.add("name", "ip")
    layer.add("blobs", m)
    layer.add("blobs", b)
    net = textformat.PMessage()
    net.add("layer", layer)
    path = str(tmp_path / "legacy.caffemodel")
    with open(path, "wb") as f:
        f.write(wireformat.encode(net, "NetParameter"))
    assert caffemodel.load_caffemodel(path)["ip"][0].shape == (1, 1, 4, 5)
    txt = 'base_lr: 0.1\nlr_policy: "fixed"\n'
    port = Solver(load_solver_prototxt_with_net(
        txt, load_net_prototxt(LEGACY_NET)), device="cpu")
    jax = JaxSolver(jax_solver_sp(txt, jax_load_net(LEGACY_NET)), seed=0)
    port.load_weights(path)
    jax.load_weights(path)
    for got in (port.params["ip"][0].numpy(),
                np.asarray(jax.params["ip"][0])):
        assert got.shape == (4, 5)
        assert got.tobytes() == w.reshape(4, 5).tobytes()
    before = port.params["ip"][0].clone()
    bad = {"ip": [w.reshape(5, 4), bias]}
    with pytest.raises(ValueError, match="incompatible"):
        port.copy_trained_layers_from(bad)
    with pytest.raises(ValueError, match="incompatible"):
        jax.copy_trained_layers_from(bad)
    assert torch.equal(port.params["ip"][0], before)
