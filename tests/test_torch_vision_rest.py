"""The rest of ``ops/vision.py``, the port against the JAX package on the
CPU: Deconvolution (stride, padding, dilation, groups, two bottoms),
Im2col, SPP (pyramid heights 1-3, MAX and AVE) and STOCHASTIC pooling in
train mode (the JAX package's uniform draw handed to the port's
function) and in test mode.

Both packages take the same numpy inputs, blobs and cotangent.  f32 at
rtol 1e-5, atol 1e-6, the forwards and the gradients alike; bf16 at
atol 2e-2 (tests/test_torch_zoo_layers.py) times max(1, max|want|),
since 2e-2 is under one bf16 step of a value above 4 (the worst reading:
STOCHASTIC test mode's, 0.0179 off at a largest value of 1.56, 0.57 of
the bound; Deconvolution's, 0.0625 off at 11.5), the forwards against the JAX layer in
bf16 and the gradients against its f32 gradients of the same
bf16-rounded inputs: the JAX layer's bf16 backward sums a bias gradient
of 240 terms in bf16, 9% from the f32 sum, which the port's CPU
accumulation is not.  The bounds in the code: ``RTOL, ATOL = 1e-5,
1e-6`` and ``BF16_ATOL = 2e-2`` (``_close``; gradients under the same
two as forwards), and STOCHASTIC train mode's input gradient at rtol
1e-6, atol 1e-7 (a pixel two windows sampled sums two cotangents in
either order; its forward is exact).  Im2col's rows are F.unfold's,
which must be channel-major (C, kh, kw) as
``conv_general_dilated_patches``'s are: the f32 forwards agree
exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_impl
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import get_layer_impl as torch_impl
from sparknet_tpu_torch.ops.vision import (SPPLayer, pool_output_size,
                                           stochastic_pool_train)
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
BF16_ATOL = 2e-2
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _both(type_, bottoms, blobs, sub, dtype, train=True, rng=None):
    """Tops, then the gradients of every bottom and blob, of both
    packages as f32 numpy under one seeded cotangent a top."""
    tdt, jdt = DTYPES[dtype]
    names = [f"b{i}" for i in range(len(bottoms))]
    jlp = jax_layer("l", type_, names, ["y"], **sub)
    tlp = torch_layer("l", type_, names, ["y"], **sub)
    nb = len(bottoms)

    def jfn(*args):
        return tuple(jax_impl(type_).apply(jlp, list(args[nb:]),
                                           list(args[:nb]), train, rng))
    jargs = [jnp.asarray(b, jdt) for b in bottoms + blobs]
    want = jfn(*jargs)
    g = np.random.default_rng(5)
    cots = [g.normal(size=np.shape(w)).astype(np.float32) for w in want]
    if dtype == "bf16":
        cots = [np.asarray(jnp.asarray(c, jdt), np.float32) for c in cots]
    _, vjp = jax.vjp(jfn, *[a.astype(jnp.float32) for a in jargs])
    jgrads = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = [torch.from_numpy(b.copy()).to(tdt).requires_grad_()
              for b in bottoms + blobs]
    got = torch_impl(type_).apply(tlp, leaves[nb:], leaves[:nb], train)
    grads = torch.autograd.grad(list(got), leaves,
                                [torch.from_numpy(c).to(t.dtype)
                                 for c, t in zip(cots, got)])
    f32 = lambda t: np.asarray(t, np.float32)
    return ([f32(t.detach().float()) for t in got], [f32(w) for w in want],
            [f32(t.float()) for t in grads], [f32(w) for w in jgrads])


def _close(got, want, dtype, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
        else:
            np.testing.assert_allclose(
                g, w, atol=BF16_ATOL * max(1.0, float(np.abs(w).max())))


_G = np.random.default_rng(11)
# (id, input shapes, convolution_param, groups)
DECONV_CASES = [
    ("k4s2p1_fcn_upsample", [(2, 4, 5, 6)],
     {"num_output": 3, "kernel_size": 4, "stride": 2, "pad": 1}),
    ("k3s1p0", [(2, 3, 4, 4)], {"num_output": 5, "kernel_size": 3}),
    ("k3s3_dilation2_pad1", [(1, 2, 4, 5)],
     {"num_output": 2, "kernel_size": 3, "stride": 3, "pad": 1,
      "dilation": 2}),
    ("groups2_k2s2", [(2, 4, 3, 3)],
     {"num_output": 6, "kernel_size": 2, "stride": 2, "group": 2}),
    ("two_bottoms_no_bias_kh_kw", [(2, 3, 4, 5), (2, 3, 4, 5)],
     {"num_output": 2, "kernel_h": 3, "kernel_w": 2, "stride_h": 2,
      "stride_w": 1, "bias_term": False}),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECONV_CASES, ids=[c[0] for c in DECONV_CASES])
def test_deconvolution_matches_jax(case, dtype):
    """``F.conv_transpose2d`` on Caffe's weight blob against the JAX
    package's forward convolution with the flipped, regrouped weight: the
    tops, the input gradients and the weight and bias gradients (the
    weights shared by both bottoms sum theirs)."""
    _, shapes, conv = case
    group = conv.get("group", 1)
    kh = conv.get("kernel_h", conv.get("kernel_size"))
    kw = conv.get("kernel_w", conv.get("kernel_size"))
    c = shapes[0][1]
    blobs = [_G.normal(size=(c, conv["num_output"] // group, kh, kw))
             .astype(np.float32)]
    if conv.get("bias_term", True):
        blobs.append(_G.normal(size=(conv["num_output"],)).astype(np.float32))
    bottoms = [_G.normal(size=s).astype(np.float32) for s in shapes]
    sub = {"convolution_param": conv}
    got, want, grads, jgrads = _both("Deconvolution", bottoms, blobs, sub,
                                     dtype)
    lp = torch_layer("l", "Deconvolution", [f"b{i}" for i in range(
        len(shapes))], ["y"], **sub)
    assert [tuple(g.shape) for g in got] == \
        torch_impl("Deconvolution").out_shapes(lp, shapes)
    assert torch_impl("Deconvolution").param_shapes(lp, shapes) == \
        [b.shape for b in blobs]
    _close(got, want, dtype)
    _close(grads, jgrads, dtype)


IM2COL_CASES = [
    ("k3s1p1", (2, 3, 5, 6), {"kernel_size": 3, "pad": 1}),
    ("k2s2", (2, 4, 6, 6), {"kernel_size": 2, "stride": 2}),
    ("k3_dilation2_pad2", (1, 2, 7, 7),
     {"kernel_size": 3, "dilation": 2, "pad": 2}),
    ("kh2_kw3_stride_hw", (2, 3, 6, 7),
     {"kernel_h": 2, "kernel_w": 3, "stride_h": 2, "stride_w": 1}),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", IM2COL_CASES, ids=[c[0] for c in IM2COL_CASES])
def test_im2col_matches_jax(case, dtype):
    _, shape, conv = case
    x = _G.normal(size=shape).astype(np.float32)
    got, want, grads, jgrads = _both(
        "Im2col", [x], [], {"convolution_param": {"num_output": 1, **conv}},
        dtype)
    if dtype == "f32":
        np.testing.assert_array_equal(got[0], want[0])
    _close(got, want, dtype)
    _close(grads, jgrads, dtype)


def test_im2col_rows_are_channel_major():
    """Row c·kh·kw + i·kw + j of an Im2col top is channel c's pixel at
    window offset (i, j)."""
    x = np.arange(2 * 3 * 3, dtype=np.float32).reshape(1, 2, 3, 3)
    lp = torch_layer("l", "Im2col", ["x"], ["y"], convolution_param={
        "num_output": 1, "kernel_size": 2})
    y = torch_impl("Im2col").apply(lp, [], [torch.from_numpy(x)],
                                   False)[0].numpy()
    assert y.shape == (1, 8, 2, 2)
    for c in range(2):
        for i in range(2):
            for j in range(2):
                np.testing.assert_array_equal(
                    y[0, c * 4 + i * 2 + j], x[0, c, i:i + 2, j:j + 2])


# (id, shape, pyramid height, pool)
SPP_CASES = [(f"{hw[0]}x{hw[1]}_h{h}_{pool}", (2, 3) + hw, h, pool)
             for hw in ((13, 13), (10, 7)) for h in (1, 2, 3)
             for pool in ("MAX", "AVE")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SPP_CASES, ids=[c[0] for c in SPP_CASES])
def test_spp_matches_jax(case, dtype):
    _, shape, height, pool = case
    x = _G.normal(size=shape).astype(np.float32)
    got, want, grads, jgrads = _both(
        "SPP", [x], [], {"spp_param": {"pyramid_height": height,
                                       "pool": pool}}, dtype)
    assert got[0].shape == (2, 3 * sum(4 ** i for i in range(height)))
    _close(got, want, dtype)
    _close(grads, jgrads, dtype)


def test_spp_max_levels_are_pool_backward_geometries():
    """Each MAX level is a pool the kernel's geometry check accepts on the
    card (padding under the kernel, every window over some input), and
    its output is the level's bins."""
    lp = torch_layer("l", "SPP", ["x"], ["y"],
                     spp_param={"pyramid_height": 3})
    for shape in ((2, 3, 13, 13), (2, 3, 10, 7), (100, 64, 4, 4)):
        for bins, kh, kw, ph, pw in SPPLayer.levels(lp, shape):
            assert 0 <= ph < kh and 0 <= pw < kw
            assert (bins - 1) * kh - ph < shape[2]
            assert (bins - 1) * kw - pw < shape[3]
            assert pool_output_size(shape[2] + 0 * ph, shape[3], kh, kw, kh,
                                    kw, ph, pw) == (bins, bins)


STOCHASTIC_GEOMETRIES = [
    ("k3s2", (2, 3, 9, 9), 3, 2, 0),
    ("k2s2", (2, 2, 8, 8), 2, 2, 0),
    ("k3s2_ceil_overshoot", (1, 3, 8, 8), 3, 2, 0),
    ("k3s2p1", (1, 2, 7, 7), 3, 2, 1),
]


@pytest.mark.parametrize("geom", STOCHASTIC_GEOMETRIES,
                         ids=[g[0] for g in STOCHASTIC_GEOMETRIES])
def test_stochastic_train_matches_jax_with_its_draw(geom):
    """Train mode with the uniform the JAX layer draws from its key handed
    to the port's function: the same element sampled in every window,
    and the gradient routed to it alone."""
    _, shape, k, s, p = geom
    x = np.abs(_G.normal(size=shape)).astype(np.float32)
    x[0, 0, :3, :3] = 0.0                  # an all-zero window
    sub = {"pooling_param": {"pool": "STOCHASTIC", "kernel_size": k,
                             "stride": s, "pad": p}}
    key = jax.random.PRNGKey(3)
    jlp = jax_layer("l", "Pooling", ["x"], ["y"], **sub)
    want, vjp = jax.vjp(lambda v: jax_impl("Pooling").apply(
        jlp, [], [v], True, key)[0], jnp.asarray(x))
    oh, ow = pool_output_size(shape[2], shape[3], k, k, s, s, p, p)
    u = np.asarray(jax.random.uniform(key, (shape[0], shape[1], 1, oh, ow),
                                      jnp.float32)).reshape(
        shape[0], shape[1], oh, ow)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    got = stochastic_pool_train(xt, k, k, s, s, p, p, oh, ow,
                                torch.from_numpy(u.copy()))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    cot = np.random.default_rng(2).normal(size=got.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    (jgx,) = vjp(jnp.asarray(cot))
    # a pixel two windows sampled sums their cotangents in either order
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-6,
                               atol=1e-7)
    # one nonzero gradient a window at most
    assert int((gx.numpy() != 0).sum()) <= oh * ow * shape[0] * shape[1]


def test_stochastic_layer_draws_from_its_generator():
    """Through the layer, the uniform is the generator's next draw, made
    on the CPU; no generator in train mode raises."""
    x = torch.from_numpy(np.abs(_G.normal(size=(2, 3, 9, 9))).astype(
        np.float32))
    lp = torch_layer("l", "Pooling", ["x"], ["y"], pooling_param={
        "pool": "STOCHASTIC", "kernel_size": 3, "stride": 2})
    impl = torch_impl("Pooling")
    assert impl.needs_rng(lp, True) and not impl.needs_rng(lp, False)
    got = impl.apply(lp, [], [x], True, torch.Generator().manual_seed(4))[0]
    u = torch.rand((2, 3, 4, 4), generator=torch.Generator().manual_seed(4))
    want = stochastic_pool_train(x, 3, 3, 2, 2, 0, 0, 4, 4, u)
    assert torch.equal(got, want)
    # every output is one of its window's elements
    from torch.nn.functional import unfold
    wins = unfold(x, 3, stride=2).reshape(2, 3, 9, 4, 4)
    assert bool((wins == got[:, :, None]).any(2).all())
    with pytest.raises(NotImplementedError, match="STOCHASTIC"):
        impl.apply(lp, [], [x], True)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geom", STOCHASTIC_GEOMETRIES,
                         ids=[g[0] for g in STOCHASTIC_GEOMETRIES])
def test_stochastic_test_mode_matches_jax(geom, dtype):
    """Σx²/Σx over each window (a zero window gives 0), forward and
    gradient."""
    _, shape, k, s, p = geom
    x = np.abs(_G.normal(size=shape)).astype(np.float32)
    x[0, 0, :3, :3] = 0.0
    got, want, grads, jgrads = _both(
        "Pooling", [x], [], {"pooling_param": {
            "pool": "STOCHASTIC", "kernel_size": k, "stride": s, "pad": p}},
        dtype, train=False)
    _close(got, want, dtype)
    _close(grads, jgrads, dtype)


def test_stochastic_train_bf16_samples_as_its_f32_values():
    """A bf16 input samples the element its values sample in f32: the
    running sums and the threshold are f32, so the card's and the CPU's
    bf16 runs pick the same elements."""
    x = torch.from_numpy(np.abs(_G.normal(size=(2, 3, 9, 9))).astype(
        np.float32)).bfloat16()
    u = torch.rand((2, 3, 4, 4), generator=torch.Generator().manual_seed(8))
    got = stochastic_pool_train(x, 3, 3, 2, 2, 0, 0, 4, 4, u)
    want = stochastic_pool_train(x.float(), 3, 3, 2, 2, 0, 0, 4, 4, u)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), want)


def test_net_refuses_a_stochastic_run_without_a_generator():
    """As the JAX package's net.py:564 does: a training run whose range
    holds STOCHASTIC pooling needs a generator, refused before any layer
    runs; a test run, or a range that stops before the pool, needs none."""
    from sparknet_tpu_torch.graph import Net
    from sparknet_tpu_torch.proto import load_net_prototxt
    txt = """
layer { name: "d" type: "Input" top: "x"
        input_param { shape { dim: 2 dim: 3 dim: 9 dim: 9 } } }
layer { name: "r" type: "ReLU" bottom: "x" top: "r" }
layer { name: "p" type: "Pooling" bottom: "r" top: "p"
        pooling_param { pool: STOCHASTIC kernel_size: 3 stride: 2 } }
"""
    net = Net(load_net_prototxt(txt))
    x = {"x": torch.from_numpy(_G.normal(size=(2, 3, 9, 9)).astype(
        np.float32))}
    with pytest.raises(ValueError, match="layer 'p' draws from a CPU "
                       "torch.Generator in this mode; none was passed"):
        net.apply({}, x, train=True)
    assert net.apply({}, x, train=False)["p"].shape == (2, 3, 4, 4)
    assert set(net.apply_all({}, x, train=True, upto="r")) == {"x", "r"}
    got = net.apply({}, x, train=True,
                    generator=torch.Generator().manual_seed(0))["p"]
    assert got.shape == (2, 3, 4, 4)

