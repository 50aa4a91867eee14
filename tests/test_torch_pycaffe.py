"""The port's ``caffe`` module shim (``pycaffe_compat``) and ``NetSpec``
(``pycaffe_netspec``) against the JAX package's, on the CPU
(``caffe.set_mode_cpu()``).

- ``NetSpec``: byte-identical prototxt text for tests/test_pycaffe_net.py's
  nets and for lenet and CaffeNet built the pycaffe way, and the same
  refusals.
- ``caffe.Net``: the cases of tests/test_pycaffe_net.py run as scripts
  against each shim, the weights carried by one ``.caffemodel`` (written
  by ``net.save`` on one side and read by ``weights=``/``copy_from`` on the
  other): forward blobs and backward diffs within 1e-5, surgery, save and
  reload, ``reshape``, ``start=``/``end=``, ranged backward,
  ``set_input_arrays``, ``forward_all``/``forward_backward_all``, shared
  params, a self-feeding LMDB net, and the same errors.  Dropout draws
  cannot match ``jax.random`` (ROADMAP), so nets with Dropout are held
  to the port's own replay of its masks.
- ``get_solver``: 10 steps of a Dropout-free net from an LMDB, losses and
  params against the JAX shim's, and the pycaffe workflow (shared
  mirrors, surgery reaching the test pass).
- pyloss through ``import caffe`` (tests/test_python_layer.py:189):
  the user layer subclasses the port's ``caffe.Layer``.

Both shims register themselves as ``sys.modules["caffe"]``; every test
here runs with ``caffe``, ``caffe.proto`` and ``caffe.proto.caffe_pb2``
saved and restored, so neither package's layer picks up the other's.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from sparknet_tpu import pycaffe_compat as jax_caffe
from sparknet_tpu_torch import pycaffe_compat as caffe
from sparknet_tpu_torch import pycaffe_pb2

from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-5

NET = """
name: "pynet"
input: "data"
input_shape { dim: 4 dim: 1 dim: 6 dim: 6 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 2 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.5 } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "ip" type: "InnerProduct" bottom: "conv" top: "ip"
  inner_product_param { num_output: 3
    weight_filler { type: "xavier" } } }
"""

LOSS_NET = """
name: "l"
input: "data"
input_shape { dim: 4 dim: 3 }
input: "label"
input_shape { dim: 4 }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
layer { name: "aux" type: "InnerProduct" bottom: "data" top: "aux"
  loss_weight: 0.4
  inner_product_param { num_output: 1 weight_filler { type: "xavier" } } }
"""

INPUT_LAYER_NET = """
name: "inp"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 2 dim: 3 dim: 8 dim: 8 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3 pad: 1
    weight_filler { type: "xavier" } } }
layer { name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param { local_size: 3 alpha: 0.1 beta: 0.75 } }
layer { name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "pool1" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
"""

SHARED_NET = """
name: "siamese"
input: "a"
input_shape { dim: 2 dim: 3 }
input: "b"
input_shape { dim: 2 dim: 3 }
layer { name: "ip_a" type: "InnerProduct" bottom: "a" top: "fa"
  param { name: "w" } param { name: "bias" }
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "ip_b" type: "InnerProduct" bottom: "b" top: "fb"
  param { name: "w" } param { name: "bias" }
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
"""

MEMORY_NET = """
name: "mem"
layer { name: "data" type: "MemoryData" top: "data" top: "label"
  memory_data_param { batch_size: 2 channels: 1 height: 3 width: 3 } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
"""

DROP_NET = """
name: "2drop"
input: "data"
input_shape { dim: 8 dim: 6 }
layer { name: "drop1" type: "Dropout" bottom: "data" top: "d1"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "ip1" type: "InnerProduct" bottom: "d1" top: "h"
  inner_product_param { num_output: 6 weight_filler { type: "xavier" } } }
layer { name: "drop2" type: "Dropout" bottom: "h" top: "d2"
  dropout_param { dropout_ratio: 0.5 } }
layer { name: "ip2" type: "InnerProduct" bottom: "d2" top: "out"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
"""


@pytest.fixture(autouse=True)
def isolated_caffe(monkeypatch):
    """Neither shim's ``caffe`` binding outlives a test, and the port's
    nets run on the CPU."""
    for name in ("caffe", "caffe.proto", "caffe.proto.caffe_pb2"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setattr(caffe, "_mode", {"cpu": True, "device_id": 0})
    monkeypatch.setattr(caffe, "_random_seed", None)
    monkeypatch.setattr(jax_caffe, "_random_seed", None)
    yield


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture
def weights(tmp_path):
    """weights(text, phase) -> a .caffemodel for that net, written by the
    JAX shim's ``net.save`` (its filler draw)."""
    def make(text, phase=jax_caffe.TEST):
        path = tmp_path / f"w{len(list(tmp_path.glob('w*')))}.caffemodel"
        jax_caffe.Net(text, phase=phase).save(str(path))
        return str(path)
    return make


def _same(a, b, where=""):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)) and a and not isinstance(a[0], str):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape, (where, a.shape, b.shape)
        np.testing.assert_allclose(a, np.asarray(b, a.dtype), rtol=RTOL,
                                   atol=ATOL, err_msg=where)
    else:
        assert a == b, (where, a, b)


def _err(fn) -> str:
    try:
        fn()
    except (ValueError, RuntimeError, KeyError, TypeError) as e:
        return type(e).__name__
    return "no error"


# -- scripts: each runs against one shim and returns what it saw ----------

def s_forward(c, w):
    net = c.Net(NET, weights=w(NET), phase=c.TEST)
    out = {"names": net._layer_names, "inputs": net.inputs,
           "outputs": net.outputs,
           "types": [l.type for l in net.layers],
           "shapes": {k: list(b.shape) for k, b in net.blobs.items()},
           "params": {k: [b.data for b in v] for k, v in net.params.items()}}
    x = _x(0, 4, 1, 6, 6)
    out["fwd"] = dict(net.forward(data=x))
    out["conv"] = net.blobs["conv"].data.copy()
    out["data"] = net.blobs["data"].data.copy()
    net.blobs["data"].data[...] = 0.0
    out["fwd_mirror"] = dict(net.forward())
    out["end"] = sorted(net.forward(end="conv", data=x))
    out["blobs_extra"] = sorted(net.forward(blobs=["conv"], data=x))
    out["end_blobs"] = sorted(net.forward(blobs=["data"], end="conv",
                                          data=x))
    out["errors"] = [
        _err(lambda: net.forward(data=np.zeros((2, 1, 6, 6), np.float32))),
        _err(lambda: net.forward(conv=np.zeros((4, 2, 4, 4), np.float32))),
        _err(lambda: net.forward(end="nope", data=x)),
        _err(lambda: net.forward(blobs=["ip"], end="conv", data=x)),
        _err(lambda: net.forward(blobs=["nope"])),
    ]
    return out


def s_backward(c, w):
    net = c.Net(NET, weights=w(NET), phase=c.TEST)
    net.forward(data=_x(1, 4, 1, 6, 6))
    dy = _x(2, 4, 3)
    out = {"diffs": net.backward(ip=dy),
           "pdiff": {k: [b.diff.copy() for b in v]
                     for k, v in net.params.items()}}
    net.blobs["ip"].diff[...] = dy
    out["mirror_seed"] = net.backward()
    out["intermediate"] = net.backward(diffs=["conv"], ip=dy)
    out["input_listed"] = net.backward(diffs=["data"], ip=dy)
    out["errors"] = [_err(lambda: net.backward(nope=dy)),
                     _err(lambda: net.backward(diffs=["nope"], ip=dy))]
    return out


def s_surgery(c, w, tmp):
    net = c.Net(NET, weights=w(NET), phase=c.TEST)
    x = _x(3, 4, 1, 6, 6)
    out = {"base": net.forward(data=x)["ip"].copy()}
    net.params["ip"][0].data[...] *= 2.0
    out["doubled"] = net.forward(data=x)["ip"].copy()
    path = str(tmp / f"surgery_{c.__name__.split('.')[0]}.caffemodel")
    net.save(path)
    out["path"] = path
    x0 = x.copy()
    net.blobs["data"].data[...] = 7.0
    out["caller_untouched"] = bool(np.array_equal(x, x0))
    return out


def s_reshape(c, w):
    net = c.Net(NET, weights=w(NET), phase=c.TEST)
    x4 = _x(4, 4, 1, 6, 6)
    out = {"base": net.forward(data=x4)["ip"].copy()}
    net.blobs["data"].reshape(1, 1, 6, 6)
    net.blobs["data"].data[...] = x4[:1]
    out["one"] = net.forward()["ip"].copy()
    out["conv1_shape"] = list(net.blobs["conv"].data.shape)
    net.blobs["data"].reshape(2, 1, 6, 6)
    net.reshape()
    out["ip2_shape"] = list(net.blobs["ip"].data.shape)
    net.blobs["data"].reshape(4, 1, 6, 6)
    net.blobs["data"].data[...] = x4
    out["back"] = net.forward()["ip"].copy()
    net.blobs["data"].reshape(4, 1, 8, 8)
    out["refused"] = _err(net.reshape)
    return out


def s_start(c, w):
    net = c.Net(NET, weights=w(NET), phase=c.TEST)
    x = _x(5, 4, 1, 6, 6)
    out = {"base": net.forward(data=x)["ip"].copy()}
    act = net.blobs["conv"].data.copy()
    out["again"] = net.forward(start="ip")["ip"].copy()
    net.blobs["conv"].data[...] = act * 2.0
    out["edited"] = net.forward(start="ip")["ip"].copy()
    out["kwargs"] = net.forward(start="ip", end="ip", conv=act)["ip"].copy()
    out["errors"] = [_err(lambda: net.forward(start="ip", end="conv")),
                     _err(lambda: net.forward(start="ip", data=x))]
    net2 = c.Net(INPUT_LAYER_NET, weights=w(INPUT_LAYER_NET), phase=c.TEST)
    xi = _x(6, 2, 3, 8, 8)
    out["input_base"] = net2.forward(data=xi)["ip"].copy()
    out["input_start0"] = net2.forward(start="data")["ip"].copy()
    out["input_start1"] = net2.forward(start="conv1")["ip"].copy()
    out["input_blobs"] = {k: b.data.copy() for k, b in net2.blobs.items()}
    return out


def s_backward_ranged(c, w):
    net = c.Net(NET, weights=w(NET), phase=c.TEST)
    net.forward(data=_x(7, 4, 1, 6, 6))
    dy = _x(8, 4, 3)
    out = {"full": net.backward(ip=dy)}
    out["one_layer"] = net.backward(start="ip", end="ip", ip=dy)
    out["conv_w_untouched"] = net.params["conv"][0].diff.copy()
    out["conv_range"] = net.backward(start="conv", end="conv",
                                     conv=_x(9, 4, 2, 4, 4), diffs=["conv"])
    net.blobs["ip"].diff[...] = dy
    out["deepdream"] = net.backward(start="ip")
    out["pdiff"] = {k: [b.diff.copy() for b in v]
                    for k, v in net.params.items()}
    out["errors"] = [
        _err(lambda: net.backward(start="conv", end="ip", ip=dy)),
        _err(lambda: net.backward(start="ip", end="ip",
                                  conv=np.zeros((4, 2, 4, 4), np.float32)))]
    # through LRN and MAX pooling
    net2 = c.Net(INPUT_LAYER_NET, weights=w(INPUT_LAYER_NET), phase=c.TEST)
    net2.forward(data=_x(10, 2, 3, 8, 8))
    out["lrn_pool"] = net2.backward(diffs=["conv1", "norm1"],
                                    ip=_x(11, 2, 3))
    out["lrn_pool_pdiff"] = {k: [b.diff.copy() for b in v]
                             for k, v in net2.params.items()}
    return out


def s_loss_and_batches(c, w):
    net = c.Net(LOSS_NET, weights=w(LOSS_NET, c.TRAIN), phase=c.TRAIN)
    out = {"weights": dict(net.blob_loss_weights)}
    data, label = _x(12, 10, 3), np.arange(10, dtype=np.float32) % 2
    out["all"] = net.forward_all(data=data, label=label)
    out["all_blobs"] = net.forward_all(blobs=["ip"], data=data, label=label)
    out["fwd"] = dict(net.forward(data=data[:4], label=label[:4]))
    out["bwd"] = net.backward()    # the loss tops' .diff mirrors: zeros
    out["bwd_seeded"] = net.backward(loss=np.float32(1.0),
                                     aux=np.full((4, 1), 0.4, np.float32))
    out["pdiff"] = {k: [b.diff.copy() for b in v]
                    for k, v in net.params.items()}
    plain = c.Net(NET, weights=w(NET), phase=c.TEST)
    x, dy = _x(13, 6, 1, 6, 6), _x(14, 6, 3)
    out["fb_all"] = plain.forward_backward_all(data=x, ip=dy)
    out["fwd_all_plain"] = plain.forward_all(blobs=["conv"], data=x)
    return out


def s_memory_and_shared(c, w):
    net = c.Net(MEMORY_NET, weights=w(MEMORY_NET), phase=c.TEST)
    data, labels = _x(15, 4, 1, 3, 3), np.arange(4, dtype=np.float32)
    net.set_input_arrays(data, labels)
    out = {"m": [dict(net.forward(blobs=["label"])) for _ in range(3)]}
    out["errors"] = [_err(lambda: net.set_input_arrays(data[:3],
                                                       labels[:3])),
                     _err(lambda: c.Net(NET, phase=c.TEST)
                          .set_input_arrays(data, labels))]
    sh = c.Net(SHARED_NET, weights=w(SHARED_NET), phase=c.TEST)
    layers = dict(zip(sh._layer_names, sh.layers))
    out["alias"] = layers["ip_b"].blobs[0] is layers["ip_a"].blobs[0]
    x = _x(16, 2, 3)
    out["shared_fwd"] = dict(sh.forward(a=x, b=x * 2))
    out["shared_bwd"] = sh.backward(fa=_x(17, 2, 4), fb=_x(18, 2, 4))
    out["shared_pdiff"] = {k: [b.diff.copy() for b in v]
                           for k, v in sh.params.items()}
    return out


def _lmdb(path, n=12, shape=(1, 4, 4)):
    from sparknet_tpu_torch.data.db import array_to_datum
    from sparknet_tpu_torch.data.lmdb_io import write_lmdb
    rng = np.random.default_rng(0)
    write_lmdb(str(path), [
        (f"{i:08d}".encode(),
         array_to_datum(rng.integers(0, 255, size=shape).astype(np.uint8),
                        label=i % 3)) for i in range(n)])
    return str(path)


def s_self_feed(c, w, db):
    text = f"""
layer {{ name: "data" type: "Data" top: "data" top: "label"
  data_param {{ source: "{db}" backend: LMDB batch_size: 2 }} }}
layer {{ name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param {{ num_output: 3 weight_filler {{ type: "xavier" }} }} }}
"""
    net = c.Net(text, weights=w(text), phase=c.TEST)
    return {"steps": [{"out": dict(net.forward()),
                       "label": net.blobs["label"].data.copy()}
                      for _ in range(3)]}


SCRIPTS = {"forward": s_forward, "backward": s_backward,
           "reshape": s_reshape, "start": s_start,
           "backward_ranged": s_backward_ranged,
           "loss_and_batches": s_loss_and_batches,
           "memory_and_shared": s_memory_and_shared}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_net_script_equals_the_jax_shim(name, weights):
    """Each script on one .caffemodel: the port's shim sees what the JAX
    shim sees, arrays within 1e-5."""
    cache = {}

    def w(text, phase=jax_caffe.TEST):
        if (text, phase) not in cache:
            cache[text, phase] = weights(text, phase)
        return cache[text, phase]
    _same(SCRIPTS[name](caffe, w), SCRIPTS[name](jax_caffe, w), name)


def test_surgery_save_and_reload_across_packages(weights, tmp_path):
    """net.save on one side, weights=/copy_from on the other, both ways."""
    cache = {}

    def w(text, phase=jax_caffe.TEST):
        return cache.setdefault((text, phase), weights(text, phase))
    mine = s_surgery(caffe, w, tmp_path)
    theirs = s_surgery(jax_caffe, w, tmp_path)
    _same({k: v for k, v in mine.items() if k != "path"},
          {k: v for k, v in theirs.items() if k != "path"})
    assert mine["caller_untouched"]
    x = _x(3, 4, 1, 6, 6)
    for saved, mod in ((theirs["path"], caffe), (mine["path"], jax_caffe)):
        by_weights = mod.Net(NET, weights=saved, phase=mod.TEST)
        copied = mod.Net(NET, phase=mod.TEST)
        held = copied.params["ip"][0]
        copied.copy_from(saved)
        assert copied.params["ip"][0] is held   # buffers kept, refilled
        for net in (by_weights, copied):
            np.testing.assert_allclose(net.forward(data=x)["ip"],
                                       mine["doubled"], rtol=RTOL,
                                       atol=ATOL)


def test_self_feeding_lmdb_net_equals_the_jax_shim(weights, tmp_path):
    db = _lmdb(tmp_path / "lmdb")
    cache = {}

    def w(text, phase=jax_caffe.TEST):
        return cache.setdefault((text, phase), weights(text, phase))
    mine = s_self_feed(caffe, w, db)
    _same(mine, s_self_feed(jax_caffe, w, db))
    assert [list(s["label"]) for s in mine["steps"]] == [[0, 1], [2, 0],
                                                         [1, 2]]


def test_dropout_backward_replays_the_forwards_masks():
    """Draws cannot match jax.random: the port's TRAIN backward is held to
    its own forward's masks, ranged and full, and a ranged forward past
    the dropouts does not advance the stream."""
    net = caffe.Net(DROP_NET, phase=caffe.TRAIN)
    x = _x(8, 8, 6)
    out = net.forward(data=x)["out"].copy()
    d1 = net.blobs["d1"].data.copy()
    mask1 = (d1 != 0)
    np.testing.assert_allclose(d1, x * mask1 * 2.0, rtol=1e-6)
    dy = _x(9, 8, 3)
    full = net.backward(diffs=["d1"], out=dy)
    # d(loss)/d(data) is d1's cotangent through drop1's mask
    np.testing.assert_allclose(full["data"], full["d1"] * mask1 * 2.0,
                               rtol=1e-5, atol=1e-6)
    ip1_diff = net.params["ip1"][0].diff.copy()
    ranged = net.backward(start="ip2", end="ip1", out=dy)
    np.testing.assert_allclose(ranged["d1"], full["d1"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(net.params["ip1"][0].diff, ip1_diff,
                               rtol=1e-5, atol=1e-6)
    net.forward(start="ip2")
    again = net.backward(start="ip2", end="ip1", out=dy)
    np.testing.assert_allclose(again["d1"], full["d1"], rtol=1e-5,
                               atol=1e-6)
    # the next full forward draws fresh masks
    assert not np.array_equal(net.forward(data=x)["out"], out)
    with pytest.raises(ValueError, match="not produced in the backward"):
        net.backward(start="ip2", end="ip1", data=dy)
    with pytest.raises(ValueError, match="outside the backward range"):
        net.backward(start="ip2", end="ip1", out=dy, diffs=["data"])


# -- get_solver ------------------------------------------------------------

SOLVER_NET = """
name: "s"
layer {{ name: "data" type: "Data" top: "data" top: "label"
  transform_param {{ scale: 0.00390625 }}
  data_param {{ source: "{db}" backend: LMDB batch_size: 4 }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param {{ num_output: 4 kernel_size: 3
    weight_filler {{ type: "gaussian" std: 0.1 }} }} }}
layer {{ name: "norm1" type: "LRN" bottom: "conv1" top: "norm1"
  lrn_param {{ local_size: 3 alpha: 0.1 beta: 0.75 }} }}
layer {{ name: "pool1" type: "Pooling" bottom: "norm1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "ip" type: "InnerProduct" bottom: "pool1" top: "ip"
  inner_product_param {{ num_output: 3 weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }}
"""


@pytest.mark.parametrize("rule", ["SGD", "Adam"])
def test_get_solver_ten_steps_equal_the_jax_shim(tmp_path, rule):
    """get_solver on a Dropout-free net fed by an LMDB: both shims start
    from one .caffemodel (solver.net.copy_from) and step 10 times; the
    losses and params agree within 1e-5."""
    db = _lmdb(tmp_path / "lmdb", n=24, shape=(3, 9, 9))
    (tmp_path / "train.prototxt").write_text(SOLVER_NET.format(db=db))
    lr = "0.01\nmomentum: 0.9" if rule == "SGD" else "0.001"
    (tmp_path / "solver.prototxt").write_text(
        f'net: "train.prototxt"\ntype: "{rule}"\nbase_lr: {lr}\n'
        'lr_policy: "fixed"\nweight_decay: 0.0005\nrandom_seed: 3\n')
    solver_path = str(tmp_path / "solver.prototxt")
    theirs = jax_caffe.get_solver(solver_path)
    w = str(tmp_path / "init.caffemodel")
    theirs.net.save(w)
    mine = caffe.get_solver(solver_path)
    mine.net.copy_from(w)
    losses = [(mine.step(1), theirs.step(1)) for _ in range(10)]
    assert mine.iter == theirs.iter == 10
    np.testing.assert_allclose([a for a, _ in losses],
                               [b for _, b in losses], rtol=RTOL, atol=ATOL)
    _same({k: [b.data for b in v] for k, v in mine.net.params.items()},
          {k: [b.data for b in v] for k, v in theirs.net.params.items()})
    assert losses[-1][0] < losses[0][0]


def test_get_solver_pycaffe_workflow(tmp_path):
    """tests/test_pycaffe_net.py:336-540 on the port: shared mirrors,
    surgery reaching training and the test pass, file references and a
    test-net-only layer."""
    (tmp_path / "train.prototxt").write_text("""
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 8 dim: 4 } shape { dim: 8 }
    data_filler { type: "gaussian" std: 1.0 }
    data_filler { type: "constant" value: 1.0 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
""")
    (tmp_path / "test.prototxt").write_text("""
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 2 dim: 4 } shape { dim: 2 }
    data_filler { type: "gaussian" std: 1.0 }
    data_filler { type: "constant" value: 1.0 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "probe" type: "InnerProduct" bottom: "ip" top: "probe"
  inner_product_param { num_output: 1
    weight_filler { type: "constant" value: 1.0 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
""")
    sf = tmp_path / "solver.prototxt"
    sf.write_text('train_net: "train.prototxt"\ntest_net: "test.prototxt"\n'
                  'base_lr: 0.1\nmomentum: 0.9\ntest_iter: 1\n')
    solver = caffe.SGDSolver(str(sf))
    tn = solver.test_nets[0]
    assert tn.params["ip"][0] is solver.net.params["ip"][0]
    assert "probe" not in solver.net.params and "probe" in tn.params
    w0 = solver.net.params["ip"][0].data.copy()
    l0 = solver.step(5)
    assert solver.iter == 5
    assert not np.allclose(solver.net.params["ip"][0].data, w0)
    assert solver.step(30) < l0
    solver.net.params["ip"][0].data[...] = 0.0
    solver.net.params["ip"][1].data[...] = 0.0
    assert solver.step(1) == pytest.approx(np.log(2), rel=0.05)
    tn.params["probe"][0].data[...] = 0.0
    tn.params["probe"][1].data[...] = 0.0
    solver.step(1)
    scores = solver._solver.test(1)
    assert float(np.sum(scores["probe"])) == 0.0
    assert "loss" in tn.forward()
    solver._solver.sp.snapshot_prefix = str(tmp_path / "snap")
    solver.snapshot()
    state = sorted(tmp_path.glob("snap_iter_*.solverstate"))
    again = caffe.get_solver(str(sf))
    again.restore(str(state[-1]))
    assert again.iter == solver.iter
    np.testing.assert_array_equal(again.net.params["ip"][0].data,
                                  solver.net.params["ip"][0].data)


# -- NetSpec ---------------------------------------------------------------

def ns_lenet_style(c):
    L, P = c.layers, c.params
    n = c.NetSpec()
    n.data = L.Input(input_param=dict(shape=dict(dim=[2, 1, 12, 12])))
    n.conv1 = L.Convolution(n.data, kernel_size=3, num_output=4,
                            weight_filler=dict(type="xavier"))
    n.relu1 = L.ReLU(n.conv1, in_place=True)
    n.pool1 = L.Pooling(n.relu1, kernel_size=2, stride=2,
                        pool=P.Pooling.MAX)
    n.score = L.InnerProduct(n.pool1, num_output=3,
                             weight_filler=dict(type="xavier"))
    return n


def ns_multi_top(c):
    L = c.layers
    n = c.NetSpec()
    n.data, n.label = L.DummyData(
        dummy_data_param=dict(shape=[dict(dim=[4, 1, 6, 6]),
                                     dict(dim=[4])]), ntop=2)
    n.ip = L.InnerProduct(n.data, num_output=2,
                          weight_filler=dict(type="constant", value=0.1))
    n.loss = L.SoftmaxWithLoss(n.ip, n.label, loss_weight=2.0)
    n.acc = L.Accuracy(n.ip, n.label, include=dict(phase="TEST"))
    n.split_a, n.split_b = L.Split(n.ip, ntop=2)
    return n


def ns_lenet(c):
    """examples/01-learning-lenet.ipynb's lenet(lmdb, batch_size)."""
    L, P = c.layers, c.params
    n = c.NetSpec()
    n.data, n.label = L.Data(batch_size=64, backend=P.Data.LMDB,
                             source="mnist_train_lmdb",
                             transform_param=dict(scale=1. / 255), ntop=2)
    n.conv1 = L.Convolution(n.data, kernel_size=5, num_output=20,
                            weight_filler=dict(type="xavier"))
    n.pool1 = L.Pooling(n.conv1, kernel_size=2, stride=2,
                        pool=P.Pooling.MAX)
    n.conv2 = L.Convolution(n.pool1, kernel_size=5, num_output=50,
                            weight_filler=dict(type="xavier"))
    n.pool2 = L.Pooling(n.conv2, kernel_size=2, stride=2,
                        pool=P.Pooling.MAX)
    n.fc1 = L.InnerProduct(n.pool2, num_output=500,
                           weight_filler=dict(type="xavier"))
    n.relu1 = L.ReLU(n.fc1, in_place=True)
    n.score = L.InnerProduct(n.relu1, num_output=10,
                             weight_filler=dict(type="xavier"))
    n.loss = L.SoftmaxWithLoss(n.score, n.label)
    return n


def caffenet_spec(c, batch: int = 1, include_data: bool = False):
    """CaffeNet the pycaffe way (caffe/examples/pycaffe/caffenet.py):
    its deploy form with an Input top, full width."""
    L, P = c.layers, c.params
    frozen = [dict(lr_mult=1, decay_mult=1), dict(lr_mult=2, decay_mult=0)]

    def conv_relu(bottom, ks, nout, stride=1, pad=0, group=1):
        conv = L.Convolution(bottom, kernel_size=ks, stride=stride,
                             num_output=nout, pad=pad, group=group,
                             param=frozen,
                             weight_filler=dict(type="gaussian", std=0.01),
                             bias_filler=dict(type="constant", value=0))
        return conv, L.ReLU(conv, in_place=True)

    def fc_relu(bottom, nout):
        fc = L.InnerProduct(bottom, num_output=nout, param=frozen,
                            weight_filler=dict(type="gaussian", std=0.005),
                            bias_filler=dict(type="constant", value=1))
        return fc, L.ReLU(fc, in_place=True)

    n = c.NetSpec()
    n.data = L.Input(shape=dict(dim=[batch, 3, 227, 227]))
    n.conv1, n.relu1 = conv_relu(n.data, 11, 96, stride=4)
    n.pool1 = L.Pooling(n.relu1, pool=P.Pooling.MAX, kernel_size=3,
                        stride=2)
    n.norm1 = L.LRN(n.pool1, local_size=5, alpha=1e-4, beta=0.75)
    n.conv2, n.relu2 = conv_relu(n.norm1, 5, 256, pad=2, group=2)
    n.pool2 = L.Pooling(n.relu2, pool=P.Pooling.MAX, kernel_size=3,
                        stride=2)
    n.norm2 = L.LRN(n.pool2, local_size=5, alpha=1e-4, beta=0.75)
    n.conv3, n.relu3 = conv_relu(n.norm2, 3, 384, pad=1)
    n.conv4, n.relu4 = conv_relu(n.relu3, 3, 384, pad=1, group=2)
    n.conv5, n.relu5 = conv_relu(n.relu4, 3, 256, pad=1, group=2)
    n.pool5 = L.Pooling(n.relu5, pool=P.Pooling.MAX, kernel_size=3,
                        stride=2)
    n.fc6, n.relu6 = fc_relu(n.pool5, 4096)
    n.drop6 = L.Dropout(n.relu6, in_place=True)
    n.fc7, n.relu7 = fc_relu(n.drop6, 4096)
    n.drop7 = L.Dropout(n.relu7, in_place=True)
    n.fc8 = L.InnerProduct(n.drop7, num_output=1000, param=frozen)
    n.prob = L.Softmax(n.fc8)
    return n


NETSPECS = {"lenet_style": ns_lenet_style, "multi_top": ns_multi_top,
            "lenet": ns_lenet, "caffenet": caffenet_spec}


@pytest.mark.parametrize("name", sorted(NETSPECS))
def test_netspec_text_is_byte_identical(name):
    mine = NETSPECS[name](caffe).to_proto()
    theirs = NETSPECS[name](jax_caffe).to_proto()
    assert str(mine) == str(theirs)
    assert mine.net_param.to_pmsg() is not None
    assert [lp.name for lp in mine.layer] == [lp.name for lp in theirs.layer]


def test_netspec_nets_run_like_the_jax_shims(weights):
    """The NetSpec lenet-style net and a narrow CaffeNet-shaped net run
    through both shims on one .caffemodel, forward within 1e-5."""
    text = str(ns_lenet_style(caffe).to_proto())
    mine = caffe.Net(text, weights=weights(text), phase=caffe.TEST)
    assert mine._layer_names == ["data", "conv1", "relu1", "pool1", "score"]
    x = _x(20, 2, 1, 12, 12)
    theirs = jax_caffe.Net(text, weights=weights(text), phase=caffe.TEST)
    _same(dict(mine.forward(data=x)), dict(theirs.forward(data=x)))
    full = caffenet_spec(caffe)
    assert full.to_proto().layer[-1].type == "Softmax"


def test_netspec_refusals_match_jax():
    for c in (caffe, jax_caffe):
        L, NetSpec = c.layers, c.NetSpec
        with pytest.raises(ValueError, match="no default param"):
            L.SoftmaxWithLoss(kernel_size=3)
        with pytest.raises(ValueError, match="unknown LayerParameter field"):
            L.Convolution(bogus_param=dict(x=1))
        with pytest.raises(TypeError, match="layer Tops"):
            NetSpec().x = 3
        n = ns_lenet_style(c)
        with pytest.raises(ValueError, match="kernal_size"):
            L.Convolution(n.data, kernal_size=3, num_output=4)
        with pytest.raises(TypeError, match="bottoms must be Tops"):
            L.ReLU(3)
        with pytest.raises(ValueError, match="in_place requires"):
            L.Concat(n.data, n.score, in_place=True)
        with pytest.raises(ValueError, match="unknown NetStateRule"):
            c.net_spec._state_rule(dict(phase="TEST", bogus=1))


# -- the module surface ----------------------------------------------------

def test_module_surface():
    types = caffe.layer_type_list()
    assert "Convolution" in types and "Python" in types
    caffe.set_random_seed(1234)
    a = caffe.Net(NET, phase=caffe.TEST)
    b = caffe.Net(NET, phase=caffe.TEST)
    caffe.set_random_seed(1234)
    a2 = caffe.Net(NET, phase=caffe.TEST)
    assert not np.array_equal(a.params["conv"][0].data,
                              b.params["conv"][0].data)
    np.testing.assert_array_equal(a.params["conv"][0].data,
                                  a2.params["conv"][0].data)
    assert caffe.Classifier.__module__ == "sparknet_tpu_torch.classify"
    assert caffe.io.__name__ == "sparknet_tpu_torch.pycaffe_io"
    assert caffe.draw.__name__ == "sparknet_tpu_torch.tools.draw_net"
    assert caffe.net_spec.__name__ == "sparknet_tpu_torch.pycaffe_netspec"
    assert caffe.PyBlob.__module__ == "sparknet_tpu_torch.ops.python_layer"
    assert caffe.proto.caffe_pb2 is pycaffe_pb2
    with pytest.raises(AttributeError):
        caffe.nonsense  # noqa: B018
    assert caffe.AdamSolver is caffe.get_solver is caffe.SGDSolver


def test_install_binds_the_port_and_never_shadows():
    caffe.install()
    import caffe as bound
    assert bound is caffe
    from caffe.proto import caffe_pb2
    assert caffe_pb2 is pycaffe_pb2
    caffe.install()                      # idempotent
    assert sys.modules["caffe"] is caffe
    # a caffe bound first (here the JAX shim) is never replaced
    sys.modules["caffe"] = jax_caffe
    caffe.install()
    assert sys.modules["caffe"] is jax_caffe
    # and a stale caffe.proto of the other package is replaced
    jax_caffe._proto_module()
    assert caffe.proto.caffe_pb2 is pycaffe_pb2


def test_set_mode_chooses_the_device(monkeypatch):
    caffe.set_mode_gpu()
    caffe.set_device(1)
    assert caffe._mode_device() == "cuda:1"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        caffe.Net(NET, phase=caffe.TEST)
    with pytest.raises(RuntimeError, match="CUDA"):
        caffe.get_solver('base_lr: 0.1\nnet_param { layer { name: "d" '
                         'type: "DummyData" top: "d" dummy_data_param { '
                         'shape { dim: 1 } } } }')
    assert caffe.Net(NET, phase=caffe.TEST, device="cpu").device.type \
        == "cpu"
    caffe.set_mode_cpu()
    assert caffe.Net(NET, phase=caffe.TEST).device.type == "cpu"


# -- pyloss through import caffe -------------------------------------------

PYLOSS = '''import caffe
import numpy as np


class EuclideanLossLayer(caffe.Layer):
    """examples/pycaffe/layers/pyloss.py"""

    def setup(self, bottom, top):
        if len(bottom) != 2:
            raise Exception("Need two inputs to compute distance.")

    def reshape(self, bottom, top):
        if bottom[0].count != bottom[1].count:
            raise Exception("Inputs must have the same dimension.")
        self.diff = np.zeros_like(bottom[0].data, dtype=np.float32)
        top[0].reshape(1)

    def forward(self, bottom, top):
        self.diff[...] = bottom[0].data - bottom[1].data
        top[0].data[...] = np.sum(self.diff**2) / bottom[0].num / 2.

    def backward(self, top, propagate_down, bottom):
        for i in range(2):
            if not propagate_down[i]:
                continue
            sign = 1 if i == 0 else -1
            bottom[i].diff[...] = sign * self.diff / bottom[i].num
'''


def test_pyloss_through_import_caffe(tmp_path, monkeypatch):
    (tmp_path / "pyloss_torch_case.py").write_text(PYLOSS)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "pyloss_torch_case", raising=False)
    net = caffe.Net("""
    name: 'el' force_backward: true
    input: 'a' input_shape { dim: 5 dim: 3 }
    input: 'b' input_shape { dim: 5 dim: 3 }
    layer { type: 'Python' name: 'loss' bottom: 'a' bottom: 'b' top: 'loss'
      python_param { module: 'pyloss_torch_case'
                     layer: 'EuclideanLossLayer' }
      loss_weight: 1 }
    """, phase=caffe.TRAIN)
    user = sys.modules["pyloss_torch_case"]
    assert issubclass(user.EuclideanLossLayer, caffe.Layer)
    assert user.caffe is caffe and "caffe" not in sys.modules
    a, b = _x(21, 5, 3), _x(22, 5, 3)
    loss = net.forward(a=a, b=b)["loss"]
    np.testing.assert_allclose(loss, [np.sum((a - b) ** 2) / 5 / 2],
                               rtol=1e-6)
    diffs = net.backward(loss=np.ones(1, np.float32))
    np.testing.assert_allclose(diffs["a"], (a - b) / 5, rtol=1e-6)
    np.testing.assert_allclose(diffs["b"], -(a - b) / 5, rtol=1e-6)


def test_python_layer_gets_the_port_shim_when_jax_is_bound(tmp_path,
                                                           monkeypatch):
    """With the JAX package's shim bound as ``caffe`` (a JAX test ran
    first in this process), a port Python layer's module still gets the
    port's shim, and the JAX binding stays in place after."""
    (tmp_path / "pyloss_torch_after_jax.py").write_text(PYLOSS)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "pyloss_torch_after_jax",
                        raising=False)
    jax_caffe.install()
    jax_bound = {k: sys.modules[k] for k in ("caffe", "caffe.proto",
                                             "caffe.proto.caffe_pb2")}
    assert jax_bound["caffe"] is jax_caffe
    net = caffe.Net("""
    name: 'el' force_backward: true
    input: 'a' input_shape { dim: 5 dim: 3 }
    input: 'b' input_shape { dim: 5 dim: 3 }
    layer { type: 'Python' name: 'loss' bottom: 'a' bottom: 'b' top: 'loss'
      python_param { module: 'pyloss_torch_after_jax'
                     layer: 'EuclideanLossLayer' }
      loss_weight: 1 }
    """, phase=caffe.TRAIN)
    user = sys.modules["pyloss_torch_after_jax"]
    assert user.caffe is caffe
    assert issubclass(user.EuclideanLossLayer, caffe.Layer)
    assert not issubclass(user.EuclideanLossLayer, jax_caffe.Layer)
    assert {k: sys.modules[k] for k in jax_bound} == jax_bound
    a, b = _x(23, 5, 3), _x(24, 5, 3)
    np.testing.assert_allclose(net.forward(a=a, b=b)["loss"],
                               [np.sum((a - b) ** 2) / 5 / 2], rtol=1e-6)
