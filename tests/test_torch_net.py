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
