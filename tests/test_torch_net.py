"""The port's Net against the JAX package's, on a narrow CaffeNet.

The net has CaffeNet's layer sequence — grouped conv2/conv4/conv5, two
LRNs after MAX pools, dropout, three InnerProducts — at num_output 16-64
and a 3x67x67 input.  Its LRNs take Caffe's default alpha of 1 rather
than CaffeNet's 1e-4, so that they change unit-scale activations
visibly.  It is written once as prototxt text and parsed by each
package's own ``textformat``; each package derives its deploy net,
the JAX package draws the weights and ``convert.params_from_jax`` carries
them across.  Every blob agrees in f32 at rtol 1e-4, atol 1e-6.  In bf16
the probabilities agree at atol 2e-2: the two frameworks round to bf16 in
different places (the JAX LRN layer computes in bf16, the port's in f32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.models import caffenet as jax_caffenet
from sparknet_tpu.parallel.serving import deploy_from as jax_deploy_from
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu.proto import load_net_prototxt as jax_load
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.graph import Net
from sparknet_tpu_torch.models import caffenet
from sparknet_tpu_torch.parallel.serving import deploy_from
from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt

BATCH = 2


def _conv(name, bottom, n, k, *, stride=1, pad=0, group=1, bias=0.0):
    return f"""
layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 1 decay_mult: 1 }} param {{ lr_mult: 2 decay_mult: 0 }}
  convolution_param {{ num_output: {n} kernel_size: {k} stride: {stride}
    pad: {pad} group: {group}
    weight_filler {{ type: "gaussian" std: 0.01 }}
    bias_filler {{ type: "constant" value: {bias} }} }} }}
layer {{ name: "relu_{name}" type: "ReLU" bottom: "{name}" top: "{name}" }}"""


def _pool(name, bottom):
    return f"""
layer {{ name: "{name}" type: "Pooling" bottom: "{bottom}" top: "{name}"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}"""


def _lrn(name, bottom):
    return f"""
layer {{ name: "{name}" type: "LRN" bottom: "{bottom}" top: "{name}"
  lrn_param {{ local_size: 5 alpha: 1.0 beta: 0.75 }} }}"""


def _fc(name, bottom, n, std, relu_drop=True):
    text = f"""
layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}" top: "{name}"
  inner_product_param {{ num_output: {n}
    weight_filler {{ type: "gaussian" std: {std} }}
    bias_filler {{ type: "constant" value: 0.1 }} }} }}"""
    if relu_drop:
        text += f"""
layer {{ name: "relu_{name}" type: "ReLU" bottom: "{name}" top: "{name}" }}
layer {{ name: "drop_{name}" type: "Dropout" bottom: "{name}" top: "{name}"
  dropout_param {{ dropout_ratio: 0.5 }} }}"""
    return text


NARROW_CAFFENET = (
    f"""name: "CaffeNetNarrow"
layer {{ name: "data" type: "Input" top: "data" top: "label"
  input_param {{ shape {{ dim: {BATCH} dim: 3 dim: 67 dim: 67 }}
                 shape {{ dim: {BATCH} }} }} }}"""
    + _conv("conv1", "data", 32, 11, stride=4)
    + _pool("pool1", "conv1") + _lrn("norm1", "pool1")
    + _conv("conv2", "norm1", 64, 5, pad=2, group=2, bias=1.0)
    + _pool("pool2", "conv2") + _lrn("norm2", "pool2")
    + _conv("conv3", "norm2", 48, 3, pad=1)
    + _conv("conv4", "conv3", 48, 3, pad=1, group=2, bias=1.0)
    + _conv("conv5", "conv4", 32, 3, pad=1, group=2, bias=1.0)
    + _pool("pool5", "conv5")
    + _fc("fc6", "pool5", 64, 0.05) + _fc("fc7", "fc6", 64, 0.05)
    + _fc("fc8", "fc7", 16, 0.05, relu_drop=False)
    + """
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc8" bottom: "label"
  top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "fc8" bottom: "label"
  top: "accuracy" include { phase: TEST } }
""")


def narrow_inputs(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(BATCH, 3, 67, 67)).astype(np.float32)


def _both_nets(compute_bf16: bool):
    jdeploy, jshape = jax_deploy_from(jax_load(NARROW_CAFFENET), BATCH)
    tdeploy, tshape = deploy_from(load_net_prototxt(NARROW_CAFFENET), BATCH)
    assert tshape == tuple(jshape) == (3, 67, 67)
    jnet = JaxNet(jdeploy, JaxNetState(JaxPhase.TEST),
                  compute_dtype=jnp.bfloat16 if compute_bf16 else None)
    tnet = Net(tdeploy, NetState(Phase.TEST),
               compute_dtype=torch.bfloat16 if compute_bf16 else None)
    jparams = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    tparams = params_from_jax(jparams, tnet, device="cpu")
    return jnet, jparams, tnet, tparams


def test_narrow_caffenet_shapes_match():
    jnet, _, tnet, _ = _both_nets(False)
    assert tnet.blob_shapes == {k: tuple(v)
                                for k, v in jnet.blob_shapes.items()}
    assert tnet.output_blobs == jnet.output_blobs == ["prob"]
    assert [n.lp.name for n in tnet.nodes] == jnet.layer_names()


def test_narrow_caffenet_every_blob_f32():
    jnet, jparams, tnet, tparams = _both_nets(False)
    x = narrow_inputs()
    want = jnet.apply_all(jparams, {"data": jnp.asarray(x)}, train=False)
    names = [b for b in want if b != "data"]
    got = tnet.apply(tparams, {"data": torch.from_numpy(x)}, blobs=names)
    assert set(names) >= {"conv1", "norm1", "norm2", "pool5", "fc8", "prob"}
    for name in names:
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-6,
            err_msg=f"blob {name!r}")
    # the LRNs did work: norm1 is not a copy of pool1
    assert not np.allclose(np.asarray(want["norm1"]),
                           np.asarray(want["pool1"]), rtol=1e-3)


def test_narrow_caffenet_probabilities_bf16():
    jnet, jparams, tnet, tparams = _both_nets(True)
    x = narrow_inputs(seed=1)
    want = jnet.apply(jparams, {"data": jnp.asarray(x)},
                      train=False).blobs["prob"]
    got = tnet.apply(tparams, {"data": torch.from_numpy(x)})["prob"]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


def test_full_width_caffenet_shapes_match_jax():
    """CaffeNet at its published widths: the port's blob and param shapes
    equal the JAX package's (shape inference only, nothing computed)."""
    jdeploy, _ = jax_deploy_from(jax_caffenet(1, 1), 64)
    tdeploy, in_shape = deploy_from(caffenet(1, 1), 64)
    assert in_shape == (3, 227, 227)
    jnet = JaxNet(jdeploy, JaxNetState(JaxPhase.TEST))
    tnet = Net(tdeploy, NetState(Phase.TEST))
    assert tnet.blob_shapes == {k: tuple(v)
                                for k, v in jnet.blob_shapes.items()}
    assert tnet.blob_shapes["norm1"] == (64, 96, 27, 27)
    assert tnet.blob_shapes["norm2"] == (64, 256, 13, 13)
    jshapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    assert tnet.param_shapes() == {
        k: [tuple(b.shape) for b in v] for k, v in jshapes.items()}


def test_params_from_jax_refuses_mismatched_weights():
    _, jparams, tnet, _ = _both_nets(False)
    bad = dict(jparams)
    bad["fc8"] = [np.zeros((15, 64), np.float32), jparams["fc8"][1]]
    with pytest.raises(ValueError, match="fc8"):
        params_from_jax(bad, tnet, device="cpu")
    missing = {k: v for k, v in jparams.items() if k != "conv3"}
    with pytest.raises(ValueError, match="conv3"):
        params_from_jax(missing, tnet, device="cpu")


# ---------------------------------------------------------------------------
# Horizontal fusion: the JAX package's tests/test_net.py:246-313 net
# ---------------------------------------------------------------------------

HFUSE_NET = """
input: "data"
input_shape { dim: 2 dim: 6 dim: 8 dim: 8 }
input: "label"
input_shape { dim: 2 }
layer { name: "b1x1" type: "Convolution" bottom: "data" top: "b1x1"
  convolution_param { num_output: 3 kernel_size: 1
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "b3r" type: "Convolution" bottom: "data" top: "b3r"
  convolution_param { num_output: 4 kernel_size: 1
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.2 } } }
layer { name: "b3" type: "Convolution" bottom: "b3r" top: "b3"
  convolution_param { num_output: 5 kernel_size: 3 pad: 1
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.0 } } }
layer { name: "b5r" type: "Convolution" bottom: "data" top: "b5r"
  convolution_param { num_output: 2 kernel_size: 1
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.3 } } }
layer { name: "cat" type: "Concat" bottom: "b1x1" bottom: "b3"
  bottom: "b5r" top: "cat" }
layer { name: "ip" type: "InnerProduct" bottom: "cat" top: "ip"
  inner_product_param { num_output: 4
    weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" }
"""


def _hfuse_nets(monkeypatch):
    monkeypatch.setenv("SPARKNET_NO_HFUSE", "1")
    per_layer = Net(load_net_prototxt(HFUSE_NET), NetState(Phase.TRAIN))
    monkeypatch.delenv("SPARKNET_NO_HFUSE")
    return per_layer, Net(load_net_prototxt(HFUSE_NET),
                          NetState(Phase.TRAIN))


def _loss_and_grads(net, params, inputs):
    p = {k: [b.clone().requires_grad_(True) for b in v]
         for k, v in params.items()}
    out = net.forward(p, inputs)
    out.loss.backward()
    return out, {k: [b.grad for b in v] for k, v in p.items()}


def test_hfuse_groups_and_per_layer_parity(monkeypatch):
    """The three data-fed 1x1 convolutions form one group (the 3x3 stays
    out), as in the JAX package.  Fused against ``SPARKNET_NO_HFUSE=1``:
    the loss and the output bit for bit and the gradients within rtol
    1e-6 (the JAX test's bound): on the CPU each output channel's
    reduction gives the same bits in the wider convolution, and the
    input's gradient sums the members' contributions in another
    order."""
    per_layer, fused = _hfuse_nets(monkeypatch)
    assert not per_layer._hfuse_enabled
    assert [m.lp.name for m in fused._hfuse_first["b1x1"]] == \
        ["b1x1", "b3r", "b5r"]
    jnet = JaxNet(jax_load(HFUSE_NET), JaxNetState(JaxPhase.TRAIN))
    assert set(jnet._hfuse_first) == set(fused._hfuse_first)
    params = fused.init(device="cpu")
    inputs = {"data": torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 6, 8, 8)).astype(np.float32)), "label": torch.zeros(2)}
    ref, ref_g = _loss_and_grads(per_layer, params, inputs)
    got, got_g = _loss_and_grads(fused, params, inputs)
    assert torch.equal(got.loss, ref.loss)
    for k in ref_g:
        for a, b in zip(ref_g[k], got_g[k]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                       atol=1e-7)
    # introspection runs per layer, and every blob equals the fused run's
    # members' own
    blobs = fused.apply_all(params, inputs)
    assert {"b1x1", "b3r", "b5r"} <= set(blobs)


def test_hfuse_against_the_jax_hfused_net(monkeypatch):
    _, fused = _hfuse_nets(monkeypatch)
    jnet = JaxNet(jax_load(HFUSE_NET), JaxNetState(JaxPhase.TRAIN))
    jparams = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
    params = params_from_jax(jparams, fused, device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 6, 8, 8)).astype(
        np.float32)
    label = np.array([1.0, 3.0], np.float32)
    rng = jax.random.PRNGKey(0)
    jl, jg = jax.value_and_grad(lambda p: jnet.apply(
        p, {"data": jnp.asarray(x), "label": jnp.asarray(label)},
        rng=rng).loss)(jparams)
    out, g = _loss_and_grads(fused, params, {
        "data": torch.from_numpy(x), "label": torch.from_numpy(label)})
    np.testing.assert_allclose(float(out.loss.detach()), float(jl),
                               rtol=1e-4, atol=1e-6)
    for k in jg:
        for a, b in zip(g[k], jg[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_hfuse_inplace_versioning_blocks_cross_version_group():
    """Two 1x1 convs reading blob 'x' before and after an in-place ReLU
    read different tensors: they must not fuse (JAX test_net.py:316)."""
    text = """
input: "x"
input_shape { dim: 1 dim: 3 dim: 4 dim: 4 }
layer { name: "a" type: "Convolution" bottom: "x" top: "a"
  convolution_param { num_output: 2 kernel_size: 1
    weight_filler { type: "xavier" } } }
layer { name: "relu" type: "ReLU" bottom: "x" top: "x" }
layer { name: "b" type: "Convolution" bottom: "x" top: "b"
  convolution_param { num_output: 2 kernel_size: 1
    weight_filler { type: "xavier" } } }
"""
    net = Net(load_net_prototxt(text), NetState(Phase.TEST))
    assert net._hfuse_first == {}
