"""The ``Python`` layer, the port against the JAX package on the CPU.

- The pycaffe-compatible protocol: the same numpy classes (a Euclidean
  loss in the manner of Caffe's examples/pycaffe/layers/pyloss.py, and a
  two-top layer) run in a net of each package; the loss, the tops and
  the gradients of the inputs and the params agree at rtol 1e-5, atol
  1e-6.  The user's backward sees the state its own forward left.
- The functional protocol: the forward in torch ops (the JAX package's
  classes write theirs in jnp), the reference's three-layer x10 chain
  (caffe/python/caffe/test/test_python_layer.py), ``param_str`` through
  ``setup``, and blobs from ``init_params`` that autograd and the
  ``Solver`` move.
- One instance a net (``per_net_copy``), resolution from ``sys.path``
  before the programmatic registry, a clear error for a missing module,
  and a module that does ``import caffe`` given the port's ``caffe``
  shim.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.ops import register_python_layer as jax_register
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.graph import Net
from sparknet_tpu_torch.ops import register_python_layer
from sparknet_tpu_torch.proto import (NetState, Phase, load_net_prototxt,
                                      load_solver_prototxt_with_net)
from sparknet_tpu_torch.solvers import Solver
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


class PyEuclideanLoss:
    """pyloss.py's EuclideanLossLayer, the top's diff applied."""

    def setup(self, bottom, top):
        if len(bottom) != 2:
            raise Exception("Need two inputs to compute distance.")
        self.forwards = 0

    def reshape(self, bottom, top):
        if bottom[0].count != bottom[1].count:
            raise Exception("Inputs must have the same dimension.")
        self.diff = np.zeros_like(bottom[0].data, dtype=np.float32)
        top[0].reshape(1)

    def forward(self, bottom, top):
        self.forwards += 1
        self.diff[...] = bottom[0].data - bottom[1].data
        top[0].data[...] = np.sum(self.diff ** 2) / bottom[0].num / 2.0

    def backward(self, top, propagate_down, bottom):
        for i in range(2):
            if propagate_down[i]:
                sign = 1 if i == 0 else -1
                bottom[i].diff[...] = (sign * self.diff / bottom[i].num
                                       * top[0].diff[0])


class PySquareAndHalf:
    """Two tops, x² and x/2, with their hand-written backward."""

    def setup(self, bottom, top):
        pass

    def reshape(self, bottom, top):
        for t in top:
            t.reshape(*bottom[0].data.shape)

    def forward(self, bottom, top):
        top[0].data[...] = bottom[0].data ** 2
        top[1].data[...] = 0.5 * bottom[0].data

    def backward(self, top, propagate_down, bottom):
        bottom[0].diff[...] = (2.0 * bottom[0].data * top[0].diff
                               + 0.5 * top[1].diff)


for _name, _cls in (("PyEuclideanLoss", PyEuclideanLoss),
                    ("PySquareAndHalf", PySquareAndHalf)):
    register_python_layer(_name, _cls)
    jax_register(_name, _cls)

CAFFE_STYLE_NET = """
name: "pyloss"
layer { name: "data" type: "Input" top: "data" top: "target"
  input_param { shape { dim: 4 dim: 6 } shape { dim: 4 dim: 3 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" }
    bias_filler { type: "gaussian" std: 0.1 } } }
layer { name: "sq" type: "Python" bottom: "ip" top: "sq" top: "half"
  python_param { module: "no_such_module_for_pysquare" layer: "PySquareAndHalf" } }
layer { name: "sum" type: "Eltwise" bottom: "sq" bottom: "half" top: "sum" }
layer { name: "loss" type: "Python" bottom: "sum" bottom: "target" top: "loss"
  loss_weight: 1
  python_param { module: "no_such_module_for_pyloss" layer: "PyEuclideanLoss" } }
"""


def _inputs(seed=0):
    g = np.random.default_rng(seed)
    return {"data": g.normal(size=(4, 6)).astype(np.float32),
            "target": g.normal(size=(4, 3)).astype(np.float32)}


def test_caffe_style_layers_match_jax():
    """Forward: every blob and the loss; backward: the gradients of the
    params through two user backwards (one of a two-top layer)."""
    jnet = JaxNet(jax_load_net(CAFFE_STYLE_NET), JaxNetState(JaxPhase.TRAIN))
    jp = jnet.init(jax.random.PRNGKey(0))
    feed = _inputs()

    def jloss(p):
        return jnet.apply(p, {k: jnp.asarray(v) for k, v in feed.items()},
                          train=True).loss
    jl, jg = jax.value_and_grad(jloss)(jp)
    jblobs = jnet.apply_all(jp, {k: jnp.asarray(v) for k, v in feed.items()})

    net = Net(load_net_prototxt(CAFFE_STYLE_NET), NetState(Phase.TRAIN))
    params = params_from_jax(jax.device_get(jp), net, device="cpu")
    leaves = [b.requires_grad_() for b in params["ip"]]
    out = net.forward(params, {k: torch.from_numpy(v)
                               for k, v in feed.items()})
    grads = torch.autograd.grad(out.loss, leaves)
    np.testing.assert_allclose(float(out.loss.detach()), float(jl),
                               rtol=RTOL, atol=ATOL)
    blobs = net.apply_all(params, {k: torch.from_numpy(v)
                                   for k, v in feed.items()})
    for k in ("ip", "sq", "half", "sum"):
        np.testing.assert_allclose(blobs[k].detach().numpy(),
                                   np.asarray(jblobs[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for g, w in zip(grads, jax.device_get(jg)["ip"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    # the forward, the backward's own forward first, then apply_all's
    inst = next(iter(net.nodes[-1].impl._cache.values())).inst
    assert inst.forwards == 3


# -- the functional protocol --------------------------------------------------

class TimesTen:
    """The reference's SimpleLayer (x10), its forward in torch ops."""

    def out_shapes(self, bottom_shapes):
        return [tuple(bottom_shapes[0])]

    def forward(self, x):
        return 10.0 * x


class ScaleByParam:
    def setup(self, bottom_shapes, param_str):
        self.k = float(param_str or 1.0)

    def out_shapes(self, bottom_shapes):
        return [tuple(bottom_shapes[0])]

    def forward(self, x):
        return self.k * x


class ChannelScale:
    """A learnable scale a channel, drawn by ``init_params``."""

    def out_shapes(self, bottom_shapes):
        return [tuple(bottom_shapes[0])]

    def init_params(self, gen, bottom_shapes):
        return [torch.full((bottom_shapes[0][1],), 0.5)]

    def forward(self, x, w):
        return x * w.reshape(1, -1)


class JaxChannelScale:
    def out_shapes(self, bottom_shapes):
        return [tuple(bottom_shapes[0])]

    def init_params(self, rng, bottom_shapes):
        return [jnp.full((bottom_shapes[0][1],), 0.5)]

    def forward(self, x, w):
        return x * w.reshape(1, -1)


register_python_layer("TimesTen", TimesTen)
register_python_layer("ScaleByParam", ScaleByParam)
register_python_layer("ChannelScale", ChannelScale)
jax_register("ChannelScale", JaxChannelScale)

CHAIN = """
name: 'pythonnet' force_backward: true
input: 'data' input_shape { dim: 4 dim: 3 dim: 2 }
layer { type: 'Python' name: 'one' bottom: 'data' top: 'one'
  python_param { module: 'x' layer: 'TimesTen' } }
layer { type: 'Python' name: 'two' bottom: 'one' top: 'two'
  python_param { module: 'x' layer: 'TimesTen' } }
layer { type: 'Python' name: 'three' bottom: 'two' top: 'three'
  python_param { module: 'x' layer: 'TimesTen' } }
"""


def test_functional_chain_like_the_reference():
    """test_python_layer.py's forward and backward: three x10 layers give
    1000x, and d(sum)/dx = 1000."""
    net = Net(load_net_prototxt(CHAIN), NetState(Phase.TRAIN))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 3, 2)).astype(np.float32)).requires_grad_()
    y = net.apply_all({}, {"data": x})["three"]
    np.testing.assert_allclose(y.detach().numpy(), 1000.0 * x.detach().numpy(),
                               rtol=RTOL)
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(g.numpy(), 1000.0, rtol=RTOL)


def test_param_str_reaches_setup():
    txt = """
    name: 'p' input: 'data' input_shape { dim: 2 dim: 2 }
    layer { type: 'Python' name: 's' bottom: 'data' top: 's'
      python_param { module: 'x' layer: 'ScaleByParam' param_str: '2.5' } }
    """
    net = Net(load_net_prototxt(txt), NetState(Phase.TRAIN))
    y = net.apply_all({}, {"data": torch.ones(2, 2)})["s"]
    np.testing.assert_allclose(y.numpy(), 2.5)


FUNCTIONAL_NET = """
name: "fn"
layer { name: "data" type: "Input" top: "data" top: "label"
  input_param { shape { dim: 6 dim: 5 } shape { dim: 6 } } }
layer { name: "cs" type: "Python" bottom: "data" top: "cs"
  python_param { module: "x" layer: "ChannelScale" } }
layer { name: "ip" type: "InnerProduct" bottom: "cs" top: "ip"
  inner_product_param { num_output: 3 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" }
"""


def test_functional_blobs_match_jax_and_train():
    """Blobs from ``init_params``: the shapes the net stores, the loss
    and the gradients against the JAX package's jnp class, and a Solver
    that moves them."""
    jnet = JaxNet(jax_load_net(FUNCTIONAL_NET), JaxNetState(JaxPhase.TRAIN))
    jp = jnet.init(jax.random.PRNGKey(0))
    g = np.random.default_rng(2)
    feed = {"data": g.normal(size=(6, 5)).astype(np.float32),
            "label": g.integers(0, 3, size=(6,)).astype(np.float32)}
    jl, jg = jax.value_and_grad(lambda p: jnet.apply(
        p, {k: jnp.asarray(v) for k, v in feed.items()}, train=True).loss)(jp)
    net = Net(load_net_prototxt(FUNCTIONAL_NET), NetState(Phase.TRAIN))
    assert net.param_shapes()["cs"] == [(5,)]
    params = params_from_jax(jax.device_get(jp), net, device="cpu")
    leaves = {k: [b.requires_grad_() for b in v] for k, v in params.items()}
    out = net.forward(leaves, {k: torch.from_numpy(v)
                               for k, v in feed.items()})
    flat = [b for v in leaves.values() for b in v]
    grads = torch.autograd.grad(out.loss, flat)
    np.testing.assert_allclose(float(out.loss.detach()), float(jl),
                               rtol=RTOL)
    jg = jax.device_get(jg)
    it = iter(grads)
    for k, v in leaves.items():
        for i in range(len(v)):
            np.testing.assert_allclose(next(it).numpy(), np.asarray(jg[k][i]),
                                       rtol=RTOL, atol=ATOL)
    solver = Solver(load_solver_prototxt_with_net(
        'base_lr: 0.1\nlr_policy: "fixed"\n',
        load_net_prototxt(FUNCTIONAL_NET)), device="cpu")
    solver.set_train_data(iter([{k: v for k, v in feed.items()}] * 3))
    before = solver.params["cs"][0].clone()
    solver.step(3)
    assert not torch.equal(before, solver.params["cs"][0])


def test_each_net_gets_its_own_instance():
    """Two nets of one prototxt hold two user instances; one net's
    forwards do not count in the other's."""
    a = Net(load_net_prototxt(CAFFE_STYLE_NET), NetState(Phase.TRAIN))
    b = Net(load_net_prototxt(CAFFE_STYLE_NET), NetState(Phase.TEST))
    assert a.nodes[-1].impl is not b.nodes[-1].impl
    pa = a.init(torch.Generator().manual_seed(0), device="cpu")
    a.forward(pa, {k: torch.from_numpy(v) for k, v in _inputs().items()})
    inst = lambda n: next(iter(n.nodes[-1].impl._cache.values())).inst
    assert inst(a).forwards == 1 and inst(b).forwards == 0


def test_resolution_and_its_errors(tmp_path, monkeypatch):
    """A module on sys.path wins over the registry; a missing module names
    itself; a module that imports caffe gets the port's shim (once
    refused naming ROADMAP A11) for its import, its ``caffe.Layer`` the
    port's."""
    (tmp_path / "user_layers_mod.py").write_text(
        "class TimesTen:\n"
        "    def out_shapes(self, s):\n        return [tuple(s[0])]\n"
        "    def forward(self, x):\n        return 3.0 * x\n")
    (tmp_path / "needs_caffe_mod.py").write_text(
        "import caffe\n\nclass L(caffe.Layer):\n    pass\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    for name in ("caffe", "caffe.proto", "caffe.proto.caffe_pb2",
                 "needs_caffe_mod"):
        # recorded first, so the binding the test makes is undone after
        monkeypatch.setitem(sys.modules, name, None)
        monkeypatch.delitem(sys.modules, name)

    def net(module, layer):
        return Net(load_net_prototxt(f"""
        name: 'p' input: 'data' input_shape {{ dim: 2 }}
        layer {{ type: 'Python' name: 's' bottom: 'data' top: 's'
          python_param {{ module: '{module}' layer: '{layer}' }} }}"""))
    y = net("user_layers_mod", "TimesTen").apply_all(
        {}, {"data": torch.ones(2)})["s"]
    np.testing.assert_allclose(y.numpy(), 3.0)
    with pytest.raises(ImportError, match="no_such_module_xyz"):
        net("no_such_module_xyz", "Nope")
    from sparknet_tpu_torch import pycaffe_compat
    caffe_net = net("needs_caffe_mod", "L")
    assert sys.modules["needs_caffe_mod"].caffe is pycaffe_compat
    assert "caffe" not in sys.modules      # bound for the import only
    user = caffe_net.nodes[0].impl._binding(caffe_net.nodes[0].lp,
                                            [(2,)]).inst
    assert isinstance(user, pycaffe_compat.Layer)
