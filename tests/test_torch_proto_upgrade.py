"""The rest of the graph compiler and the prototxt layer, the port against
the JAX package on the CPU.

- V0 nets (a ``layer`` nested in each ``layers`` entry, ``padding``
  layers, a bare ``input_dim``) upgrade to the JAX package's
  ``NetParameter`` field for field: every typed field, and the V2 text
  each package writes from it byte for byte.
- ``serialize`` writes the text of every zoo net, of the mnist_siamese
  and mnist_autoencoder transcriptions and of the upgraded V0 nets byte
  for byte as the JAX ``serialize`` does, uppercase strings quoted;
  ``save_net_prototxt`` and ``replace_data_layers`` likewise.
- ``Slice`` and Accuracy's per-class top, forward and gradients, at rtol
  1e-5, atol 1e-6 (bf16: 2e-2, the bound of tests/test_torch_net.py).
- ``Net.apply_all`` with ``upto``, ``start`` and ``eps`` (its gradient
  with respect to a zero perturbation is the blob's diff), ``layer_names``,
  ``num_layers``, ``layer_num_weights``, ``weights_add`` and
  ``weights_scalar_divide`` at the same bound.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparknet_tpu.models as jax_models
import sparknet_tpu_torch.models as torch_models
from sparknet_tpu.graph import net as jax_net_mod
from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_impl
from sparknet_tpu.proto import caffe_pb as jax_pb
from sparknet_tpu.proto import textformat as jax_tf
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.graph import net as net_mod
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import get_layer_impl as torch_impl
from sparknet_tpu_torch.proto import NetState, Phase
from sparknet_tpu_torch.proto import caffe_pb
from sparknet_tpu_torch.proto import textformat as tf
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6

# tests/test_caffe_pb.py:117-190, with every V0 type the upgrade maps
V0_NETS = {
    "padding": """
name: "v0net"
input: "data"
input_dim: 2 input_dim: 1 input_dim: 12 input_dim: 12
layers { layer { name: "pad1" type: "padding" pad: 2 }
         bottom: "data" top: "pad1" }
layers { layer { name: "conv1" type: "conv" num_output: 4 kernelsize: 5
                 stride: 1 weight_filler { type: "xavier" } }
         bottom: "pad1" top: "conv1" }
layers { layer { name: "relu1" type: "relu" } bottom: "conv1" top: "conv1" }
layers { layer { name: "pool1" type: "pool" pool: MAX kernelsize: 2
                 stride: 2 } bottom: "conv1" top: "pool1" }
layers { layer { name: "drop" type: "dropout" dropout_ratio: 0.4 }
         bottom: "pool1" top: "pool1" }
layers { layer { name: "ip" type: "innerproduct" num_output: 3
                 weight_filler { type: "xavier" } blobs_lr: 1 blobs_lr: 2
                 weight_decay: 1 weight_decay: 0 }
         bottom: "pool1" top: "ip" }
layers { layer { name: "prob" type: "softmax" } bottom: "ip" top: "prob" }
""",
    "data_transform": """
layers { layer { name: "d" type: "data" source: "/nonexistent"
                 batchsize: 4 scale: 0.0039 cropsize: 8 mirror: true
                 meanfile: "mean.binaryproto" rand_skip: 3 }
         top: "data" top: "label" }
""",
    "every_type": """
name: "V0ALL"
layers { layer { name: "img" type: "images" source: "list.txt"
                 batchsize: 2 new_height: 8 new_width: 9 shuffle_images: true
                 cropsize: 6 } top: "data" top: "label" }
layers { layer { name: "win" type: "window_data" source: "w.txt"
                 batchsize: 2 det_fg_threshold: 0.5 det_bg_threshold: 0.3
                 det_fg_fraction: 0.25 det_context_pad: 16
                 det_crop_mode: "square" } top: "wdata" top: "wlabel" }
layers { layer { name: "h5" type: "hdf5_data" source: "h.txt"
                 batchsize: 3 } top: "hdata" }
layers { layer { name: "NORM" type: "lrn" local_size: 3 alpha: 0.001
                 beta: 0.5 k: 2 } bottom: "data" top: "norm" }
layers { layer { name: "cat" type: "concat" concat_dim: 1 }
         bottom: "norm" bottom: "data" top: "cat" }
layers { layer { name: "flat" type: "flatten" } bottom: "cat" top: "flat" }
layers { layer { name: "fc" type: "innerproduct" num_output: 5
                 biasterm: false } bottom: "flat" top: "fc" }
layers { layer { name: "sig" type: "sigmoid" } bottom: "fc" top: "sig" }
layers { layer { name: "th" type: "tanh" } bottom: "sig" top: "th" }
layers { layer { name: "bn" type: "bnll" } bottom: "th" top: "bn" }
layers { layer { name: "info" type: "infogain_loss" source: "H.bp" }
         bottom: "bn" bottom: "label" }
layers { layer { name: "eu" type: "euclidean_loss" }
         bottom: "bn" bottom: "th" }
layers { layer { name: "ml" type: "multinomial_logistic_loss" }
         bottom: "bn" bottom: "label" }
layers { layer { name: "sl" type: "softmax_loss" } bottom: "fc"
         bottom: "label" }
layers { layer { name: "acc" type: "accuracy" } bottom: "fc"
         bottom: "label" top: "acc" }
layers { layer { name: "sp" type: "split" } bottom: "fc" top: "s1"
         top: "s2" }
layers { layer { name: "i2c" type: "im2col" } bottom: "data" top: "cols" }
""",
}


def _typed_fields(net) -> dict:
    """Every typed field of a NetParameter and its layers, with the
    schema-free sub-messages as the text each package writes."""
    def layer(lp):
        d = {f.name: getattr(lp, f.name) for f in dataclasses.fields(lp)
             if f.name not in ("params", "blobs", "param", "include",
                               "exclude", "phase")}
        d["phase"] = None if lp.phase is None else lp.phase.name
        d["param"] = [dataclasses.astuple(p) for p in lp.param]
        d["rules"] = [[(None if r.phase is None else r.phase.name,
                        r.min_level, r.max_level, r.stage, r.not_stage)
                       for r in rules] for rules in (lp.include, lp.exclude)]
        d["params"] = {k: _text(v) for k, v in lp.params.items()}
        return d
    return {"name": net.name, "input": net.input,
            "input_shape": [s.dim for s in net.input_shape],
            "force_backward": net.force_backward,
            "layer": [layer(lp) for lp in net.layer]}


def _text(pmsg) -> str:
    mod = jax_tf if type(pmsg).__module__.startswith("sparknet_tpu.") else tf
    return mod.serialize(pmsg)


@pytest.mark.parametrize("name", sorted(V0_NETS))
def test_v0_nets_upgrade_field_for_field(name):
    ours = caffe_pb.load_net_prototxt(V0_NETS[name])
    theirs = jax_pb.load_net_prototxt(V0_NETS[name])
    assert _typed_fields(ours) == _typed_fields(theirs)
    assert tf.serialize(ours.to_pmsg()) == jax_tf.serialize(theirs.to_pmsg())


def test_the_upgraded_v0_net_builds_and_runs_as_the_jax_one():
    ours = caffe_pb.load_net_prototxt(V0_NETS["padding"])
    by_name = {lp.name: lp for lp in ours.layer}
    assert "pad1" not in by_name and by_name["conv1"].bottom == ["data"]
    assert int(by_name["conv1"].sub("convolution_param").get("pad")) == 2
    assert ours.input_shape[0].dim == [2, 1, 12, 12]
    net = net_mod.Net(ours)
    jnet = jax_net_mod.Net(jax_pb.load_net_prototxt(V0_NETS["padding"]))
    jparams = jnet.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.device_get(jparams), net, device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 1, 12, 12)).astype(
        np.float32)
    got = net.apply(params, {"data": torch.from_numpy(x)})["prob"]
    want = jnet.apply(jparams, {"data": jnp.asarray(x)}, train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.blobs["prob"]),
                               rtol=RTOL, atol=ATOL)


def test_a_padding_layer_feeding_no_conv_or_pool_raises():
    text = """
layers { layer { name: "pad" type: "padding" pad: 1 } bottom: "x" top: "p" }
layers { layer { name: "r" type: "relu" } bottom: "p" top: "r" }
"""
    for load in (caffe_pb.load_net_prototxt, jax_pb.load_net_prototxt):
        with pytest.raises(ValueError, match="non-conv/pool layer 'r'"):
            load(text)


ZOO = [("lenet", (4, 8)), ("cifar10_quick", (4, 8)),
       ("cifar10_full", (4, 8)), ("alexnet", (2, 2)), ("caffenet", (2, 2)),
       ("googlenet", (2, 2)), ("vgg16", (2, 2))]


@pytest.mark.parametrize("name,args", ZOO, ids=[z[0] for z in ZOO])
def test_serialize_writes_the_zoo_byte_for_byte(name, args):
    ours = getattr(torch_models, name)(*args)
    theirs = getattr(jax_models, name)(*args)
    text = tf.serialize(ours.to_pmsg())
    assert text == jax_tf.serialize(theirs.to_pmsg())
    assert caffe_pb.save_net_prototxt(ours) == text
    # and parses back to the same text
    assert tf.serialize(caffe_pb.load_net_prototxt(text).to_pmsg()) == text


def test_serialize_quotes_uppercase_strings_and_round_trips():
    text = 'name: "CONV1" other: "NAN" pool: MAX s: "a\\"b\\nc" x: 1.5e-07'
    m = tf.parse(text)
    out = tf.serialize(m)
    assert out == jax_tf.serialize(jax_tf.parse(text))
    assert 'name: "CONV1"' in out and 'other: "NAN"' in out
    assert "pool: MAX" in out
    back = tf.parse(out)
    assert back.get("other") == "NAN" and back.get("s") == 'a"b\nc'
    assert isinstance(back.get("pool"), tf.EnumToken)
    unwritable = tf.PMessage()
    unwritable.add("o", object())
    with pytest.raises(TypeError):
        tf.serialize(unwritable)


def test_save_net_prototxt_writes_the_file(tmp_path):
    net = torch_models.lenet(4, 8)
    path = str(tmp_path / "lenet.prototxt")
    text = caffe_pb.save_net_prototxt(net, path)
    with open(path) as f:
        assert f.read() == text
    theirs = str(tmp_path / "jax.prototxt")
    jax_pb.save_net_prototxt(jax_models.lenet(4, 8), theirs)
    with open(theirs) as f:
        assert f.read() == text


def test_replace_data_layers_matches_jax():
    from test_torch_siamese import autoencoder_net, siamese_net
    for text in (siamese_net("t", "s"), autoencoder_net("t", "s"),
                 V0_NETS["every_type"]):
        ours = caffe_pb.replace_data_layers(
            caffe_pb.load_net_prototxt(text), 8, 4, 1, 28, 28)
        theirs = jax_pb.replace_data_layers(
            jax_pb.load_net_prototxt(text), 8, 4, 1, 28, 28)
        assert tf.serialize(ours.to_pmsg()) == \
            jax_tf.serialize(theirs.to_pmsg())
    ours = caffe_pb.replace_data_layers(
        caffe_pb.load_net_prototxt(siamese_net("t", "s")),
        8, 4, 2, 28, 28)
    train = net_mod.Net(ours, NetState(Phase.TRAIN))
    assert train.input_blobs == {"pair_data": (8, 2, 28, 28), "sim": (8,)}
    assert net_mod.Net(ours, NetState(Phase.TEST)).input_blobs[
        "pair_data"] == (4, 2, 28, 28)


def _layer_both(type_, bottoms, tops, dtype, wrt=(0,), **sub):
    """Forward and gradients of one layer in both packages."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    names = [f"b{i}" for i in range(len(bottoms))]
    jlp = jax_layer("l", type_, names, tops, **sub)
    tlp = torch_layer("l", type_, names, tops, **sub)

    def jfn(*diff):
        bots = [jnp.asarray(b) for b in bottoms]
        for i, d in zip(wrt, diff):
            bots[i] = d.astype(jdt)
        return tuple(t.astype(jnp.float32) for t in
                     jax_impl(type_).apply(jlp, [], bots, True, None))

    want, vjp = jax.vjp(jfn, *[jnp.asarray(bottoms[i]) for i in wrt])
    rng = np.random.default_rng(3)
    cots = [rng.normal(size=np.shape(w)).astype(np.float32) for w in want]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    xs = [torch.from_numpy(b.copy()) for b in bottoms]
    for i in wrt:
        xs[i] = xs[i].to(tdt).requires_grad_()
    got = [t.float() for t in torch_impl(type_).apply(tlp, [], xs, True)]
    live = [(g, torch.from_numpy(c)) for g, c in zip(got, cots)
            if g.requires_grad]
    grads = torch.autograd.grad([g for g, _ in live], [xs[i] for i in wrt],
                                [c for _, c in live]) if wrt else []
    return ([g.detach().numpy() for g in got], [np.asarray(w) for w in want],
            [g.float().numpy() for g in grads],
            [np.asarray(jnp.asarray(g).astype(jnp.float32)) for g in jgrads])


SLICES = [
    ("siamese_pair", (4, 2, 6, 6), 2, {"slice_dim": 1, "slice_point": 1}),
    ("points", (2, 6, 2, 2), 3, {"slice_point": [1, 3]}),
    ("equal", (2, 6, 3), 3, {}),
    ("last_axis", (3, 4, 8), 2, {"axis": -1, "slice_point": 5}),
    ("batch_axis", (6, 3), 3, {"axis": 0}),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", SLICES, ids=lambda c: c[0])
def test_slice_matches_jax(case, dtype):
    _, shape, ntop, sub = case
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    tops = [f"t{i}" for i in range(ntop)]
    got, want, grads, jgrads = _layer_both("Slice", [x], tops, dtype,
                                           slice_param=sub)
    for g, w in zip(got + grads, want + jgrads):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)  # slicing rounds nothing
    lp = torch_layer("l", "Slice", ["x"], tops, slice_param=sub)
    assert torch_impl("Slice").out_shapes(lp, [shape]) == [
        tuple(w.shape) for w in want]


def test_slice_refuses_an_uneven_split():
    lp = torch_layer("l", "Slice", ["x"], ["a", "b"])
    with pytest.raises(ValueError, match="not divisible"):
        torch_impl("Slice").out_shapes(lp, [(2, 5)])


@pytest.mark.parametrize("sub", [{}, {"ignore_label": 2},
                                 {"top_k": 2, "axis": 1}],
                         ids=["plain", "ignore_label", "top2"])
def test_accuracy_per_class_top_matches_jax(sub):
    rng = np.random.default_rng(4)
    scores = rng.normal(size=(12, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=12).astype(np.float32)  # no class 4
    got, want, _, _ = _layer_both("Accuracy", [scores, labels],
                                  ["acc", "per_class"], "f32", wrt=(),
                                  accuracy_param=sub)
    assert got[1].shape == want[1].shape == (5,)
    assert got[1][4] == 0.0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    lp = torch_layer("l", "Accuracy", ["s", "l"], ["acc", "per_class"])
    assert torch_impl("Accuracy").out_shapes(lp, [(12, 5), (12,)]) == [
        (), (5,)]


INTROSPECT = """
name: "introspect"
input: "data" input_shape { dim: 2 dim: 1 dim: 8 dim: 8 }
input: "label" input_shape { dim: 2 }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 3 kernel_size: 3
    weight_filler { type: "xavier" } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "pool" type: "Pooling" bottom: "conv" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "pool" top: "ip"
  inner_product_param { num_output: 4 weight_filler { type: "xavier" } } }
layer { name: "sig" type: "Sigmoid" bottom: "ip" top: "sig" }
layer { name: "loss" type: "EuclideanLoss" bottom: "sig" bottom: "ip"
  top: "loss" }
"""


def _introspect_pair():
    jnet = jax_net_mod.Net(jax_pb.load_net_prototxt(INTROSPECT))
    net = net_mod.Net(caffe_pb.load_net_prototxt(INTROSPECT))
    jparams = jnet.init(jax.random.PRNGKey(2))
    params = params_from_jax(jax.device_get(jparams), net, device="cpu")
    x = np.random.default_rng(5).normal(size=(2, 1, 8, 8)).astype(np.float32)
    return jnet, net, jparams, params, x


@pytest.mark.parametrize("upto,start", [
    (None, None), ("relu", None), ("pool", None), (None, "ip"),
    ("ip", "pool"), ("loss", "sig")])
def test_apply_all_upto_and_start_match_jax(upto, start):
    jnet, net, jparams, params, x = _introspect_pair()
    full = net.apply_all(params, {"data": torch.from_numpy(x),
                                  "label": torch.zeros(2)})
    feed = {"data": torch.from_numpy(x), "label": torch.zeros(2)}
    if start is not None:
        # every bottom the skipped layers made
        skipped = net.layer_names()[:net.layer_names().index(start)]
        feed = {t: full[t] for n in net.nodes if n.lp.name in skipped
                for t in n.tops}
    got = net.apply_all(params, feed, upto=upto, start=start)
    want = jnet.apply_all(jparams, {k: jnp.asarray(v.numpy())
                                    for k, v in feed.items()},
                          train=False, upto=upto, start=start)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_apply_all_refuses_unknown_layers_and_a_start_after_upto():
    _, net, _, params, x = _introspect_pair()
    with pytest.raises(ValueError, match="unknown layer 'nope'"):
        net.apply_all(params, {}, upto="nope")
    with pytest.raises(ValueError, match="comes after"):
        net.apply_all(params, {}, upto="conv", start="ip")
    with pytest.raises(ValueError, match="needs blobs"):
        net.apply_all(params, {}, start="pool")


@pytest.mark.parametrize("blob", ["conv", "pool", "sig"])
def test_apply_all_eps_gradient_is_the_blobs_diff(blob):
    jnet, net, jparams, params, x = _introspect_pair()
    inputs = {"data": torch.from_numpy(x), "label": torch.zeros(2)}
    shape = net.blob_shapes[blob]
    eps = torch.zeros(shape, requires_grad=True)
    out = net.apply_all(params, inputs, eps={blob: eps})
    (g,) = torch.autograd.grad(out["loss"], [eps])

    def jloss(e):
        return jnet.apply_all(jparams, {k: jnp.asarray(v.numpy())
                                        for k, v in inputs.items()},
                              train=False, eps={blob: e})["loss"]

    want = jax.grad(jloss)(jnp.zeros(shape))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert np.abs(g.numpy()).max() > 0
    # zero perturbations change no value
    plain = net.apply_all(params, inputs)
    torch.testing.assert_close(out["loss"], plain["loss"], rtol=0, atol=0)


def test_introspection_and_weight_math_match_jax():
    jnet, net, jparams, params, _ = _introspect_pair()
    assert net.num_layers == jnet.num_layers == 6
    assert net.layer_names() == jnet.layer_names()
    assert net.layer_num_weights(params) == jnet.layer_num_weights(jparams)
    other = {k: [b * 3.0 + 1.0 for b in v] for k, v in params.items()}
    jother = {k: [jnp.asarray(b.numpy()) for b in v]
              for k, v in other.items()}
    got = net_mod.weights_scalar_divide(
        net_mod.weights_add(params, other), 2.0)
    want = jax_net_mod.weights_scalar_divide(
        jax_net_mod.weights_add(jparams, jother), 2.0)
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=ATOL)
