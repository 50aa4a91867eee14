"""The port's layers against the JAX package's, on the CPU.

The same layer config is built with each package's own DSL, the same numpy
inputs and weights go through both, and the tops agree at rtol 1e-5
(atol 1e-6 for elements near zero, where the two frameworks' different
summation orders leave absolute, not relative, differences).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_impl
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import get_layer_impl as torch_impl

RTOL, ATOL = 1e-5, 1e-6


def _run_both(type_, bottoms, params=(), train=False, **sub):
    """Apply one layer type in both packages -> (port top, JAX top)."""
    bottoms = [np.asarray(b, np.float32) for b in bottoms]
    params = [np.asarray(p, np.float32) for p in params]
    want = jax_impl(type_).apply(
        jax_layer("l", type_, ["x"], ["y"], **sub),
        [jnp.asarray(p) for p in params], [jnp.asarray(b) for b in bottoms],
        train, None)[0]
    got = torch_impl(type_).apply(
        torch_layer("l", type_, ["x"], ["y"], **sub),
        [torch.from_numpy(p) for p in params],
        [torch.from_numpy(b) for b in bottoms], train)[0]
    return got.numpy(), np.asarray(want)


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (in shape, num_output, kernel, stride, pad, group, dilation)
CONV_CASES = [
    ((2, 3, 15, 15), 8, 11, 4, 0, 1, 1),     # CaffeNet conv1 geometry
    ((2, 8, 7, 7), 16, 5, 1, 2, 2, 1),       # conv2: grouped, padded
    ((2, 12, 5, 5), 12, 3, 1, 1, 2, 1),      # conv4/5: grouped 3x3
    ((1, 6, 9, 9), 6, 3, 1, 2, 3, 2),        # dilated, 3 groups
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(
    map(str, c[0])) + f"-k{c[2]}s{c[3]}p{c[4]}g{c[5]}d{c[6]}")
def test_convolution(case):
    shape, num_output, k, s, p, g, d = case
    conv = {"num_output": num_output, "kernel_size": k, "stride": s,
            "pad": p, "group": g, "dilation": d}
    w = _normal(num_output, shape[1] // g, k, k, seed=1) * 0.1
    b = _normal(num_output, seed=2)
    got, want = _run_both("Convolution", [_normal(*shape)], [w, b],
                          convolution_param=conv)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# (h, w, kernel, stride, pad): tests/test_pallas.py's geometries, with
# ceil-mode remainders and the start-inside-padding clip, plus CaffeNet's
POOL_GEOMS = [
    (14, 14, 3, 1, 1), (28, 28, 3, 2, 0), (13, 13, 3, 2, 1), (7, 7, 5, 3, 2),
    (17, 17, 2, 3, 1), (55, 55, 3, 2, 0), (27, 27, 3, 2, 0), (6, 6, 3, 2, 0),
]


@pytest.mark.parametrize("geom", POOL_GEOMS, ids=lambda g: "h{}w{}k{}s{}p{}"
                         .format(*g))
def test_max_pooling(geom):
    h, w, k, s, p = geom
    # all-negative inputs: a padded cell must never win a window
    x = -np.abs(_normal(2, 3, h, w)) - 0.5
    got, want = _run_both("Pooling", [x], pooling_param={
        "pool": "MAX", "kernel_size": k, "stride": s, "pad": p})
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_global_max_pooling():
    got, want = _run_both("Pooling", [_normal(2, 3, 5, 6)], pooling_param={
        "pool": "MAX", "global_pooling": True})
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bias", [True, False])
def test_inner_product(bias):
    x = _normal(3, 4, 5, 5)
    params = [_normal(7, 100, seed=1) * 0.1]
    if bias:
        params.append(_normal(7, seed=2))
    got, want = _run_both("InnerProduct", [x], params, inner_product_param={
        "num_output": 7, "bias_term": bias})
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_inner_product_transposed():
    got, want = _run_both("InnerProduct", [_normal(3, 10)],
                          [_normal(10, 4, seed=1), _normal(4, seed=2)],
                          inner_product_param={"num_output": 4,
                                               "transpose": True})
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("slope", [0.0, 0.1])
def test_relu(slope):
    got, want = _run_both("ReLU", [_normal(2, 3, 4, 4)],
                          relu_param={"negative_slope": slope})
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_dropout_is_identity_at_test_time():
    x = _normal(2, 50)
    got, want = _run_both("Dropout", [x], dropout_param={
        "dropout_ratio": 0.5})
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want, x)


def test_dropout_train_mode_is_refused_until_ported():
    lp = torch_layer("d", "Dropout", ["x"], ["x"],
                     dropout_param={"dropout_ratio": 0.5})
    with pytest.raises(NotImplementedError):
        torch_impl("Dropout").apply(lp, [], [torch.ones(2, 3)], True)


@pytest.mark.parametrize("shape", [(4, 10), (2, 5, 3, 3)])
def test_softmax(shape):
    got, want = _run_both("Softmax", [_normal(*shape) * 3.0])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_shape_inference_matches_jax():
    """out_shapes of each ported layer equal the JAX package's."""
    cases = [
        ("Convolution", (2, 8, 13, 13), {"convolution_param": {
            "num_output": 6, "kernel_size": 3, "pad": 1, "group": 2}}),
        ("Pooling", (2, 8, 13, 13), {"pooling_param": {
            "pool": "MAX", "kernel_size": 3, "stride": 2, "pad": 1}}),
        ("InnerProduct", (2, 8, 3, 3), {"inner_product_param": {
            "num_output": 5}}),
    ]
    for type_, shape, sub in cases:
        jl = jax_layer("l", type_, ["x"], ["y"], **sub)
        tl = torch_layer("l", type_, ["x"], ["y"], **sub)
        assert (torch_impl(type_).out_shapes(tl, [shape])
                == [tuple(s) for s in jax_impl(type_).out_shapes(jl, [shape])])
