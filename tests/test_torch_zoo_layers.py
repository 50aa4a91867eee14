"""The layers the rest of the zoo needs, the port against the JAX package on
the CPU: AVE pooling, WITHIN_CHANNEL LRN, Concat, Split and Flatten; and
every zoo net's shapes at its published widths.

Both packages take the same numpy inputs and the same numpy cotangent;
forwards and input gradients (``jax.vjp`` against ``torch.autograd``)
agree in f32 at rtol 1e-5, atol 1e-6: the window sums add in another
order.  The AVE geometries are the zoo's and the two places where Caffe's
divisor is not the kernel area: a ceil-mode window that overshoots the
plane (CIFAR's 3/2 pools on 16x16 and 8x8) and a padded window (3/2 pad 1,
which overshoots too).  In bf16 both packages return the AVE sum over an
f32 divisor as f32 (the next layer's cast takes it back to bf16); they
agree at atol 2e-2, the bf16 bound of test_torch_net.py, since the JAX
window sum rounds to bf16 at every add and the port's once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparknet_tpu.models as jax_models
import sparknet_tpu_torch.models as torch_models
from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_impl
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu_torch.graph import Net
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import get_layer_impl as torch_impl
from sparknet_tpu_torch.proto import NetState, Phase

RTOL, ATOL = 1e-5, 1e-6


def _fwd_bwd(type_, bottoms, ntop=1, seed=0, **sub):
    """(port tops, JAX tops, port grads, JAX grads) of one layer on
    ``bottoms`` with a shared random cotangent for every top."""
    tops = ["y"] if ntop == 1 else [f"y{i}" for i in range(ntop)]
    names = [f"b{i}" for i in range(len(bottoms))]
    jlp = jax_layer("l", type_, names, tops, **sub)
    tlp = torch_layer("l", type_, names, tops, **sub)

    def jax_fn(*xs):
        return tuple(jax_impl(type_).apply(jlp, [], list(xs), True, None))

    want, vjp = jax.vjp(jax_fn, *[jnp.asarray(b) for b in bottoms])
    rng = np.random.default_rng(seed)
    cots = [rng.normal(size=np.shape(w)).astype(np.float32) for w in want]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    xs = [torch.from_numpy(b.copy()).requires_grad_() for b in bottoms]
    got = torch_impl(type_).apply(tlp, [], xs, True)
    torch.autograd.backward(list(got), [torch.from_numpy(c) for c in cots])
    return ([g.detach().numpy() for g in got], [np.asarray(w) for w in want],
            [x.grad.numpy() for x in xs], [np.asarray(g) for g in jgrads])


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# (id, input shape, kernel, stride, pad)
AVE_GEOMETRIES = [
    ("cifar_3s2_16", (2, 4, 16, 16), 3, 2, 0),
    ("cifar_3s2_8", (2, 4, 8, 8), 3, 2, 0),
    ("googlenet_aux_5s3_14", (2, 4, 14, 14), 5, 3, 0),
    ("googlenet_pool5_7s1_7", (2, 4, 7, 7), 7, 1, 0),
    ("padded_3s2p1_13", (2, 3, 13, 13), 3, 2, 1),
]


@pytest.mark.parametrize("shape,k,s,p", [g[1:] for g in AVE_GEOMETRIES],
                         ids=[g[0] for g in AVE_GEOMETRIES])
def test_ave_pool_matches_jax(shape, k, s, p):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got, want, dx, jdx = _fwd_bwd(
        "Pooling", [x], pooling_param={"pool": "AVE", "kernel_size": k,
                                       "stride": s, "pad": p})
    _close(got, want)
    _close(dx, jdx)


def test_ave_pool_divisor_is_clipped_to_the_padded_extent():
    """Ones in: each output is its window's count of real cells over the
    window clipped to [0, dim + pad).  At 3/2 on 16x16 the last window
    overshoots by one and divides by 2; at 3/2 pad 1 on 13x13 the first
    window divides by 3 though it holds 2 real cells a side."""
    impl = torch_impl("Pooling")
    for (h, pad, corner, last) in ((16, 0, 1.0, 1.0), (13, 1, 4.0 / 9.0,
                                                       4.0 / 9.0)):
        lp = torch_layer("l", "Pooling", ["x"], ["y"], pooling_param={
            "pool": "AVE", "kernel_size": 3, "stride": 2, "pad": pad})
        y = impl.apply(lp, [], [torch.ones(1, 1, h, h)], False)[0]
        assert y.shape[-1] == (8 if h == 16 else 7)
        assert float(y[0, 0, 0, 0]) == pytest.approx(corner)
        assert float(y[0, 0, -1, -1]) == pytest.approx(last)
    # torch's own ceil-mode average divides the padded corner by the
    # valid cells (4/4), not Caffe's clipped window
    lib = torch.nn.functional.avg_pool2d(torch.ones(1, 1, 13, 13), 3, 2, 1,
                                         ceil_mode=True,
                                         count_include_pad=False)
    assert float(lib[0, 0, 0, 0]) == 1.0


def test_global_ave_pool_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 5, 6, 9)).astype(np.float32)
    got, want, dx, jdx = _fwd_bwd(
        "Pooling", [x], pooling_param={"pool": "AVE",
                                       "global_pooling": True})
    assert got[0].shape == (2, 5, 1, 1)
    _close(got, want)
    _close(dx, jdx)


def test_ave_pool_bf16_is_f32_out_as_in_jax():
    """A bf16 input: the sum in bf16 over an f32 divisor comes out f32 in
    both packages; the values agree within one bf16 ulp of the sum."""
    x = np.random.default_rng(3).normal(size=(2, 4, 16, 16)).astype(
        np.float32)
    sub = {"pooling_param": {"pool": "AVE", "kernel_size": 3, "stride": 2}}
    want = jax_impl("Pooling").apply(
        jax_layer("l", "Pooling", ["x"], ["y"], **sub), [],
        [jnp.asarray(x, jnp.bfloat16)], False, None)[0]
    got = torch_impl("Pooling").apply(
        torch_layer("l", "Pooling", ["x"], ["y"], **sub), [],
        [torch.from_numpy(x).bfloat16()], False)[0]
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)
    # the port's sum rounds to bf16 once, so it is within one bf16 ulp of
    # the f32 average of the bf16 inputs
    exact = torch_impl("Pooling").apply(
        torch_layer("l", "Pooling", ["x"], ["y"], **sub), [],
        [torch.from_numpy(x).bfloat16().float()], False)[0]
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=2.0 ** -8,
                               atol=1e-6)


def test_stochastic_pooling_still_raises():
    lp = torch_layer("l", "Pooling", ["x"], ["y"], pooling_param={
        "pool": "STOCHASTIC", "kernel_size": 2, "stride": 2})
    with pytest.raises(NotImplementedError, match="STOCHASTIC"):
        torch_impl("Pooling").apply(lp, [], [torch.ones(1, 1, 4, 4)], False)


@pytest.mark.parametrize("size", [3, 4, 5])
def test_within_channel_lrn_matches_jax(size):
    """cifar10_full's norms (size 3, alpha 5e-5) at pixel scale, so the
    normalization moves the output, and an even size, whose window
    overshoots one side and shrinks its divisor there.  k is given and
    must be ignored."""
    x = (60.0 * np.random.default_rng(size).normal(size=(2, 3, 9, 11))
         ).astype(np.float32)
    sub = {"lrn_param": {"local_size": size, "alpha": 5e-5, "beta": 0.75,
                         "k": 7.0, "norm_region": "WITHIN_CHANNEL"}}
    got, want, dx, jdx = _fwd_bwd("LRN", [x], **sub)
    _close(got, want)
    _close(dx, jdx)
    assert not np.allclose(got[0], x, rtol=1e-2)


@pytest.mark.parametrize("sub,axis", [
    ({}, 1), ({"concat_param": {"axis": 2}}, 2),
    ({"concat_param": {"axis": -1}}, 3),
    ({"concat_param": {"concat_dim": 3, "axis": 1}}, 3)],
    ids=["default_axis1", "axis2", "axis_neg1", "legacy_concat_dim"])
def test_concat_matches_jax(sub, axis):
    rng = np.random.default_rng(4)
    shapes = []
    for width in (2, 3, 1):
        s = [2, 3, 4, 5]
        s[axis] = width
        shapes.append(tuple(s))
    bottoms = [rng.normal(size=s).astype(np.float32) for s in shapes]
    got, want, dx, jdx = _fwd_bwd("Concat", bottoms, **sub)
    assert got[0].shape[axis] == 6
    _close(got, want, rtol=0, atol=0)
    _close(dx, jdx, rtol=0, atol=0)


def test_split_sums_the_gradients_of_its_tops():
    x = np.random.default_rng(5).normal(size=(2, 3, 4)).astype(np.float32)
    got, want, dx, jdx = _fwd_bwd("Split", [x], ntop=3)
    assert len(got) == 3
    _close(got, want, rtol=0, atol=0)
    rng = np.random.default_rng(0)
    cot_sum = sum(rng.normal(size=x.shape).astype(np.float32)
                  for _ in range(3))
    np.testing.assert_allclose(dx[0], cot_sum, rtol=RTOL, atol=ATOL)
    _close(dx, jdx)


@pytest.mark.parametrize("sub,shape", [
    ({}, (2, 60)), ({"flatten_param": {"axis": 2}}, (2, 3, 20)),
    ({"flatten_param": {"axis": 1, "end_axis": 2}}, (2, 12, 5)),
    ({"flatten_param": {"axis": -3, "end_axis": -2}}, (2, 12, 5))],
    ids=["default", "axis2", "end_axis2", "negative_axes"])
def test_flatten_matches_jax(sub, shape):
    x = np.random.default_rng(6).normal(size=(2, 3, 4, 5)).astype(np.float32)
    got, want, dx, jdx = _fwd_bwd("Flatten", [x], **sub)
    assert got[0].shape == shape
    _close(got, want, rtol=0, atol=0)
    _close(dx, jdx, rtol=0, atol=0)
    tlp = torch_layer("l", "Flatten", ["x"], ["y"], **sub)
    assert torch_impl("Flatten").out_shapes(tlp, [x.shape]) == [shape]


ZOO = ["lenet", "cifar10_quick", "cifar10_full", "alexnet", "caffenet",
       "googlenet", "vgg16"]


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
@pytest.mark.parametrize("model", ZOO)
def test_zoo_net_shapes_match_jax(model, phase):
    """Every zoo model at its published widths, made by each package's own
    ``models`` function: the port's blob and parameter shapes equal the
    JAX package's in both phases (shape inference only, nothing
    computed)."""
    jnet = JaxNet(getattr(jax_models, model)(2, 2),
                  JaxNetState(getattr(JaxPhase, phase)))
    tnet = Net(getattr(torch_models, model)(2, 2),
               NetState(getattr(Phase, phase)))
    assert tnet.blob_shapes == {k: tuple(v)
                                for k, v in jnet.blob_shapes.items()}
    assert tnet.output_blobs == jnet.output_blobs
    jshapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    assert tnet.param_shapes() == {
        k: [tuple(b.shape) for b in v] for k, v in jshapes.items()}
