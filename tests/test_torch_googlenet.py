"""GoogLeNet in the port against the JAX package, on the CPU.

- The full-width GoogLeNet TEST net (``models/googlenet.py``, crop 224)
  at batch 1 on pixel-scale inputs (std 58, where GoogLeNet's LRNs
  shrink their outputs by ~20%), from the same weights: the outputs
  (``loss3/classifier``, the loss, top-1 and top-5) at rtol 1e-4, atol
  1e-6 (the bound of test_torch_net.py), and every other blob of the JAX
  forward at rtol 1e-4 and an atol of 1e-6 times the blob's largest
  value.  An f32 sum's rounding error scales with its terms, not its
  result: a few post-ReLU elements near zero in blobs of magnitude 5-280
  are ~1e-5 off in either framework.  The weights are drawn by the port
  (the JAX package's eager init of this net takes tens of seconds here)
  and handed to the JAX net as numpy arrays.
- One training step of a narrow inception net written as prototxt and
  parsed by each package: GoogLeNet's stem (7x7/2 conv, 3/2 MAX pool,
  LRN, 1x1 and 3x3 convs, LRN, pool), two inception modules (four
  branches, 3/1/1 MAX pool, Concat), a TRAIN-only auxiliary head (5/3 AVE
  pool, loss weight 0.3) and the 7/1 AVE pool head, Dropout at ratio 0
  (the identity in both packages; their masks cannot match).  Loss and
  every parameter gradient at rtol 2e-4, atol 2e-5, the trainer tests'
  bound (tests/test_parallel.py:128-129): a backward through two losses
  sums in other orders in the two frameworks.
- Train weights into the TEST and deploy nets: ``params_from_jax``
  refuses the auxiliary heads' twelve blobs unless told to drop them.
- The served ``googlenet`` of the port's ``ModelHouse`` zoo against the
  JAX package's ``LoadedModel`` on the same weights, f32; train weights
  served through ``drop_extra``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.models import googlenet as jax_googlenet
from sparknet_tpu.parallel.serving import LoadedModel as JaxLoadedModel
from sparknet_tpu.parallel.serving import ServeConfig as JaxServeConfig
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu.proto import load_net_prototxt as jax_load
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.graph import Net
from sparknet_tpu_torch.models import googlenet
from sparknet_tpu_torch.parallel.serving import (LoadedModel, ModelHouse,
                                                 ServeConfig, deploy_from,
                                                 zoo_models)
from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt

RTOL, ATOL = 1e-4, 1e-6
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the suite runs in several worker
    processes on the CPU, and torch's thread pools, one per process and
    each as wide as the machine, oversubscribe it (full-width GoogLeNet's
    app run took 183 s under six workers against 4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _numpy(params):
    return {k: [b.detach().cpu().numpy() for b in v]
            for k, v in params.items()}


def _jax(params):
    return {k: [jnp.asarray(b) for b in v] for k, v in params.items()}


@pytest.fixture(scope="module")
def full_weights():
    """GoogLeNet's TRAIN-phase weights (aux heads included), drawn once
    by the port from seed 0, as numpy."""
    net = Net(googlenet(1, 1), NetState(Phase.TRAIN))
    return _numpy(net.init(torch.Generator().manual_seed(0), device="cpu"))


def test_full_width_googlenet_test_forward_every_blob(full_weights):
    jnet = JaxNet(jax_googlenet(1, 1), JaxNetState(JaxPhase.TEST))
    tnet = Net(googlenet(1, 1), NetState(Phase.TEST))
    assert tnet.blob_shapes == {k: tuple(v)
                                for k, v in jnet.blob_shapes.items()}
    assert tnet.blob_shapes["pool1/norm1"] == (1, 64, 56, 56)
    assert tnet.blob_shapes["inception_5b/output"] == (1, 1024, 7, 7)
    assert tnet.blob_shapes["pool5/7x7_s1"] == (1, 1024, 1, 1)
    assert not any(k.startswith("loss1") or k.startswith("loss2")
                   for k in tnet.blob_shapes)
    rng = np.random.default_rng(0)
    inputs = {"data": (58.0 * rng.normal(size=(1, 3, 224, 224))).astype(
        np.float32), "label": np.array([3.0], np.float32)}
    tparams = params_from_jax(full_weights, tnet, device="cpu",
                              drop_extra=True)
    jparams = _jax({k: full_weights[k] for k in tparams})
    fwd = jax.jit(lambda p, x: jnet.apply_all(p, x, train=False))
    want = fwd(jparams, {k: jnp.asarray(v) for k, v in inputs.items()})
    names = [b for b in want if b not in inputs]
    with torch.inference_mode():
        got = tnet.apply(tparams, {k: torch.from_numpy(v)
                                   for k, v in inputs.items()}, blobs=names)
    assert {"inception_3a/output", "inception_4e/output", "pool5/7x7_s1",
            "loss3/classifier", "loss3/loss3"} <= set(names)
    assert tnet.output_blobs == ["loss3/loss3", "loss3/top-1", "loss3/top-5"]
    for name in names:
        ref = np.asarray(want[name])
        scale = 1.0 if name.startswith("loss3/") else float(np.abs(ref).max())
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=RTOL,
                                   atol=ATOL * scale, err_msg=f"blob {name!r}")
    # the LRNs did work at this scale: norm1 is not a copy of pool1
    assert not np.allclose(np.asarray(want["pool1/norm1"]),
                           np.asarray(want["pool1/3x3_s2"]), rtol=1e-2)


# ---------------------------------------------------------------------------
# One training step of a narrow inception net
# ---------------------------------------------------------------------------

BATCH, CLASSES = 2, 10


def _conv(name, bottom, n, k, *, stride=1, pad=0):
    return f"""
layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 1 decay_mult: 1 }} param {{ lr_mult: 2 decay_mult: 0 }}
  convolution_param {{ num_output: {n} kernel_size: {k} stride: {stride}
    pad: {pad} weight_filler {{ type: "xavier" }}
    bias_filler {{ type: "constant" value: 0.2 }} }} }}
layer {{ name: "{name}/relu" type: "ReLU" bottom: "{name}" top: "{name}" }}"""


def _pool(name, bottom, method, k, s, p=0):
    return f"""
layer {{ name: "{name}" type: "Pooling" bottom: "{bottom}" top: "{name}"
  pooling_param {{ pool: {method} kernel_size: {k} stride: {s}
    pad: {p} }} }}"""


def _lrn(name, bottom):
    return f"""
layer {{ name: "{name}" type: "LRN" bottom: "{bottom}" top: "{name}"
  lrn_param {{ local_size: 5 alpha: 1.0 beta: 0.75 }} }}"""


def _fc(name, bottom, n):
    return f"""
layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}" top: "{name}"
  inner_product_param {{ num_output: {n}
    weight_filler {{ type: "xavier" }}
    bias_filler {{ type: "constant" value: 0.2 }} }} }}"""


def _inception(p, bottom, n1, n3r, n3, n5r, n5, npool):
    return (_conv(f"{p}/1x1", bottom, n1, 1)
            + _conv(f"{p}/3x3_reduce", bottom, n3r, 1)
            + _conv(f"{p}/3x3", f"{p}/3x3_reduce", n3, 3, pad=1)
            + _conv(f"{p}/5x5_reduce", bottom, n5r, 1)
            + _conv(f"{p}/5x5", f"{p}/5x5_reduce", n5, 5, pad=2)
            + _pool(f"{p}/pool", bottom, "MAX", 3, 1, 1)
            + _conv(f"{p}/pool_proj", f"{p}/pool", npool, 1) + f"""
layer {{ name: "{p}/output" type: "Concat" bottom: "{p}/1x1"
  bottom: "{p}/3x3" bottom: "{p}/5x5" bottom: "{p}/pool_proj"
  top: "{p}/output" }}""")


def _aux(bottom):
    train = "include { phase: TRAIN }"
    text = _pool("loss1/ave_pool", bottom, "AVE", 5, 3)
    text += _conv("loss1/conv", "loss1/ave_pool", 8, 1)
    text += _fc("loss1/fc", "loss1/conv", 16) + f"""
layer {{ name: "loss1/relu_fc" type: "ReLU" bottom: "loss1/fc"
  top: "loss1/fc" }}
layer {{ name: "loss1/drop_fc" type: "Dropout" bottom: "loss1/fc"
  top: "loss1/fc" dropout_param {{ dropout_ratio: 0.0 }} }}"""
    text += _fc("loss1/classifier", "loss1/fc", CLASSES) + """
layer { name: "loss1/loss" type: "SoftmaxWithLoss"
  bottom: "loss1/classifier" bottom: "label" top: "loss1/loss1"
  loss_weight: 0.3 }"""
    # every layer of the head is TRAIN-only, as in models/googlenet.py
    return text.replace("\nlayer { name:", f"\nlayer {{ {train} name:")


NARROW_INCEPTION = (
    f"""name: "InceptionNarrow"
layer {{ name: "data" type: "Input" top: "data" top: "label"
  input_param {{ shape {{ dim: {BATCH} dim: 3 dim: 67 dim: 67 }}
                 shape {{ dim: {BATCH} }} }} }}"""
    + _conv("conv1", "data", 16, 7, stride=2, pad=3)
    + _pool("pool1", "conv1", "MAX", 3, 2) + _lrn("norm1", "pool1")
    + _conv("conv2_reduce", "norm1", 16, 1)
    + _conv("conv2", "conv2_reduce", 24, 3, pad=1)
    + _lrn("norm2", "conv2") + _pool("pool2", "norm2", "MAX", 3, 2)
    + _inception("inc_a", "pool2", 8, 8, 12, 4, 6, 6)
    + _aux("inc_a/output")
    + _inception("inc_b", "inc_a/output", 8, 8, 12, 4, 6, 6)
    + _pool("pool5", "inc_b/output", "AVE", 7, 1) + """
layer { name: "pool5/drop" type: "Dropout" bottom: "pool5" top: "pool5"
  dropout_param { dropout_ratio: 0.0 } }"""
    + _fc("classifier", "pool5", CLASSES) + """
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "classifier"
  bottom: "label" top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "classifier"
  bottom: "label" top: "accuracy" include { phase: TEST } }""")


def test_narrow_inception_training_step_matches_jax():
    tnet = Net(load_net_prototxt(NARROW_INCEPTION), NetState(Phase.TRAIN))
    jnet = JaxNet(jax_load(NARROW_INCEPTION), JaxNetState(JaxPhase.TRAIN))
    assert tnet.blob_shapes == {k: tuple(v)
                                for k, v in jnet.blob_shapes.items()}
    assert tnet.blob_shapes["inc_a/output"] == (BATCH, 32, 8, 8)
    assert tnet.blob_shapes["loss1/ave_pool"] == (BATCH, 32, 2, 2)
    assert tnet.output_blobs == ["loss1/loss1", "loss"]
    weights = _numpy(tnet.init(torch.Generator().manual_seed(1),
                               device="cpu"))
    rng = np.random.default_rng(2)
    inputs = {"data": rng.normal(size=(BATCH, 3, 67, 67)).astype(np.float32),
              "label": rng.integers(0, CLASSES, BATCH).astype(np.float32)}

    def jax_loss(p):
        return jnet.apply(p, {k: jnp.asarray(v) for k, v in inputs.items()},
                          train=True, rng=jax.random.PRNGKey(0)).loss

    jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(_jax(weights))
    tparams = {k: [torch.from_numpy(b.copy()).requires_grad_() for b in v]
               for k, v in weights.items()}
    out = tnet.forward(tparams, {k: torch.from_numpy(v)
                                 for k, v in inputs.items()},
                       generator=torch.Generator().manual_seed(0))
    out.loss.backward()
    loss = float(out.loss.detach())
    # the loss is 0.3 x the aux loss + the main loss
    np.testing.assert_allclose(
        loss, 0.3 * float(out.blobs["loss1/loss1"].detach())
        + float(out.blobs["loss"].detach()), rtol=1e-6)
    np.testing.assert_allclose(loss, float(jloss), rtol=RTOL, atol=ATOL)
    assert set(jgrads) == set(tparams)
    for k, blobs in tparams.items():
        for i, b in enumerate(blobs):
            np.testing.assert_allclose(
                b.grad.numpy(), np.asarray(jgrads[k][i]), rtol=TRAIN_RTOL,
                atol=TRAIN_ATOL, err_msg=f"{k}[{i}]")
    assert float(tparams["loss1/conv"][0].grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# Train weights into nets without the auxiliary heads
# ---------------------------------------------------------------------------

def test_train_weights_need_drop_extra_for_the_deploy_net(full_weights):
    deploy, _ = deploy_from(googlenet(1, 1), 1)
    net = Net(deploy)
    aux = sorted(k for k in full_weights if k not in net.param_shapes())
    assert aux == sorted(f"loss{i}/{l}" for i in (1, 2)
                         for l in ("conv", "fc", "classifier"))
    assert sum(len(full_weights[k]) for k in aux) == 12
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(full_weights, net, device="cpu")
    params = params_from_jax(full_weights, net, device="cpu",
                             drop_extra=True)
    assert set(params) == set(full_weights) - set(aux)
    missing = {k: v for k, v in full_weights.items() if k != "conv2/3x3"}
    with pytest.raises(ValueError, match="conv2/3x3"):
        params_from_jax(missing, net, device="cpu", drop_extra=True)
    bad = dict(full_weights)
    bad["loss3/classifier"] = [np.zeros((10, 1024), np.float32),
                               full_weights["loss3/classifier"][1]]
    with pytest.raises(ValueError, match="loss3/classifier"):
        params_from_jax(bad, net, device="cpu", drop_extra=True)


def test_served_googlenet_matches_jax_loaded_model(monkeypatch):
    """The zoo's ``googlenet`` loaded by the port's ``ModelHouse`` and by
    the JAX package's ``LoadedModel`` on the same weights (the JAX model
    draws its own in an eager init that takes tens of seconds here, so its
    ``Net.init`` hands back the port's draw; its forward is untouched),
    f32 at rtol 1e-4, atol 1e-6."""
    house = ModelHouse(ServeConfig(batch_shapes=(2,), dtype="f32"),
                       device="cpu")
    tlm = house.load("googlenet")
    served = _jax(_numpy(tlm.params))
    monkeypatch.setattr(JaxNet, "init", lambda self, rng: served)
    jlm = JaxLoadedModel("googlenet", jax_googlenet(1, 1, crop=224),
                         JaxServeConfig(batch_shapes=(2,), dtype="f32"))
    assert tlm.in_shape == tuple(jlm.in_shape) == (3, 224, 224)
    assert tlm.classes == jlm.classes == 1000
    assert tlm.param_bytes == jlm.param_bytes
    batch = (58.0 * np.random.default_rng(3).normal(
        size=(2, 3, 224, 224))).astype(np.float32)
    got, want = tlm.infer(batch), jlm.infer(batch)
    assert got.shape == want.shape == (2, 1000)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_train_weights_serve_through_drop_extra(full_weights):
    """A trained GoogLeNet's weights serve once their auxiliary heads are
    dropped at the call, and answer as the deploy net does on them."""
    cfg = ServeConfig(batch_shapes=(1,), dtype="f32")
    with pytest.raises(ValueError, match="extra"):
        LoadedModel("googlenet", zoo_models()["googlenet"](), cfg,
                    device="cpu", params=full_weights)
    lm = LoadedModel("googlenet", zoo_models()["googlenet"](), cfg,
                     device="cpu", params=full_weights, drop_extra=True)
    x = np.random.default_rng(4).normal(size=(1, 3, 224, 224)).astype(
        np.float32)
    with torch.inference_mode():
        logits = lm.net.apply(lm.params, {"data": torch.from_numpy(x)},
                              blobs=["loss3/classifier"])["loss3/classifier"]
    np.testing.assert_allclose(lm.infer(x), torch.softmax(logits, 1).numpy(),
                               rtol=1e-6, atol=1e-7)
    for k, blobs in lm.params.items():
        for b, w in zip(blobs, full_weights[k]):
            np.testing.assert_array_equal(b.numpy(), w)
