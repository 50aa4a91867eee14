"""The port's MAX-pool backward against the JAX package, on the CPU.

The port's MAX Pooling under autograd saves its input and routes each
window's gradient to the window's first row-major maximum; on the CPU
that is the plain version ``cuda_kernels.max_pool_bwd_reference`` (an
explicit gather: unfold, argmax, scatter-add).  It is held against the
JAX package's ``max_pool_vmem_bwd`` with its Pallas kernels in interpret
mode and against the JAX autodiff of ``vision.max_pool``, on the
geometries of tests/test_pallas.py:120-178 plus CaffeNet's 3x3 stride-2
pools and GoogLeNet's 3x3 stride-1 pad-1 pools.  Inputs carry ties
(ReLU'd normals rounded to halves), where only the first-max tie-break
gives the JAX gradient.  Gradients agree at rtol 1e-4 (graph/tuner.py:357),
atol 1e-6: overlapping windows add in another order.  The CUDA kernel is
held against the plain version on the card by
tests/test_torch_cuda_kernels.py and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.ops.pallas_kernels import max_pool_vmem_bwd
from sparknet_tpu.ops.vision import max_pool as jax_max_pool
from sparknet_tpu_torch.models.dsl import layer
from sparknet_tpu_torch.ops import cuda_kernels as ck
from sparknet_tpu_torch.ops import get_layer_impl
from sparknet_tpu_torch.ops.vision import MaxPool, max_pool, pool_output_size
from test_pallas import _np_caffe_maxpool_bwd

RTOL, ATOL = 1e-4, 1e-6

# (h, w, kh, sh, ph)
GEOMS = [
    (14, 14, 3, 1, 1),   # GoogLeNet inception pool (stride 1, pad 1)
    (28, 28, 3, 2, 0),   # ceil-mode stride 2
    (13, 13, 3, 2, 1),   # padded + ceil (odd remainder)
    (7, 7, 5, 3, 2),     # kernel > 2 x stride, fat overlap
    (17, 17, 2, 3, 1),   # stride > kernel: the ceil clip leaves columns
    (27, 27, 3, 2, 0),   # CaffeNet pool2 (pool1 and pool5 are alike)
]


def _ids(g):
    return f"{g[0]}x{g[1]}-k{g[2]}s{g[3]}p{g[4]}"


def _tied(shape, seed):
    """ReLU'd normals rounded to halves: zeros and equal values abound."""
    x = np.maximum(np.random.default_rng(seed).normal(size=shape), 0)
    return (np.round(x * 2) / 2).astype(np.float32)


def _port_grad(x: np.ndarray, dy: np.ndarray, geom, dtype=torch.float32):
    h, w, k, s, p = geom
    oh, ow = pool_output_size(h, w, k, k, s, s, p, p)
    t = torch.from_numpy(x).to(dtype).requires_grad_()
    y = MaxPool.apply(t, k, k, s, s, p, p, oh, ow)
    (dx,) = torch.autograd.grad(y, t, torch.from_numpy(dy).to(dtype))
    return y.detach(), dx


def _jax_grads(x, dy, geom, dtype=jnp.float32):
    h, w, k, s, p = geom
    oh, ow = pool_output_size(h, w, k, k, s, s, p, p)
    out = {}
    for name, fn in (("pallas", max_pool_vmem_bwd), ("autodiff",
                                                     jax_max_pool)):
        _, vjp = jax.vjp(lambda v: fn(v, k, k, s, s, p, p, oh, ow),
                         jnp.asarray(x, dtype))
        out[name] = np.asarray(vjp(jnp.asarray(dy, dtype))[0], np.float32)
    return out


def _dy(geom, seed, n=2, c=3):
    h, w, k, s, p = geom
    oh, ow = pool_output_size(h, w, k, k, s, s, p, p)
    return np.random.default_rng(seed).normal(
        size=(n, c, oh, ow)).astype(np.float32)


@pytest.mark.parametrize("geom", GEOMS, ids=_ids)
def test_pool_gradient_matches_jax_f32(geom):
    h, w = geom[:2]
    x = np.random.default_rng(0).normal(size=(2, 3, h, w)).astype(np.float32)
    dy = _dy(geom, 1)
    y, dx = _port_grad(x, dy, geom)
    k, s, p = geom[2:]
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jax_max_pool(jnp.asarray(x), k, k, s, s, p, p,
                                           *y.shape[2:])))
    for name, want in _jax_grads(x, dy, geom).items():
        np.testing.assert_allclose(dx.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("geom", GEOMS, ids=_ids)
def test_pool_gradient_first_max_ties(geom):
    """Tied windows: the gradient goes to each window's FIRST maximum, as
    Caffe's argmax scan, the Pallas kernel and XLA's select-and-scatter
    route it."""
    h, w, k, s, p = geom
    x, dy = _tied((2, 3, h, w), 2), _dy(geom, 3)
    _, dx = _port_grad(x, dy, geom)
    oh, ow = dy.shape[2:]
    caffe = _np_caffe_maxpool_bwd(x, dy, k, k, s, s, p, p, oh, ow)
    np.testing.assert_allclose(dx.numpy(), caffe, rtol=RTOL, atol=ATOL)
    for name, want in _jax_grads(x, dy, geom).items():
        np.testing.assert_allclose(dx.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("geom", [GEOMS[0], GEOMS[2], GEOMS[5]], ids=_ids)
def test_pool_gradient_bf16_ties(geom):
    """bf16 activations and gradients: the port and the Pallas kernel both
    sum in f32 and round once, on the same bf16 values."""
    h, w, k, s, p = geom
    x, dy = _tied((1, 4, h, w), 4), _dy(geom, 5, n=1, c=4)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    dy16 = torch.from_numpy(dy).to(torch.bfloat16)
    y, dx = _port_grad(x16.float().numpy(), dy16.float().numpy(), geom,
                       torch.bfloat16)
    assert y.dtype == dx.dtype == torch.bfloat16
    want = _jax_grads(x16.float().numpy(), dy16.float().numpy(), geom,
                      jnp.bfloat16)["pallas"]
    np.testing.assert_allclose(dx.float().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    caffe = _np_caffe_maxpool_bwd(x16.float().numpy(), dy16.float().numpy(),
                                  k, k, s, s, p, p, *dy.shape[2:])
    np.testing.assert_allclose(
        dx.float().numpy(),
        torch.from_numpy(caffe).to(torch.bfloat16).float().numpy(),
        rtol=RTOL, atol=ATOL)


def test_last_max_routing_would_fail_the_tie_check():
    """The tie check can fail: routing to each window's LAST maximum, on
    the same tied inputs, moves the gradient."""
    geom = (13, 13, 3, 2, 0)
    h, w, k, s, p = geom
    x, dy = _tied((2, 3, h, w), 6), _dy(geom, 7)
    oh, ow = dy.shape[2:]
    wins = ck._pool_windows(torch.from_numpy(x), k, k, s, s, p, p, oh, ow)
    last = k * k - 1 - wins.flip(-1).argmax(dim=-1)
    moved = ck._route_to_taps(last, torch.from_numpy(dy), h, w, k, k, s, s,
                              p, p, oh, ow)
    caffe = _np_caffe_maxpool_bwd(x, dy, k, k, s, s, p, p, oh, ow)
    assert not np.allclose(moved.numpy(), caffe, rtol=RTOL, atol=ATOL)
    _, dx = _port_grad(x, dy, geom)
    np.testing.assert_allclose(dx.numpy(), caffe, rtol=RTOL, atol=ATOL)


def test_pooling_layer_uses_the_function_only_under_autograd():
    lp = layer("p", "Pooling", ["x"], ["y"],
               pooling_param={"pool": "MAX", "kernel_size": 3, "stride": 2})
    impl = get_layer_impl("Pooling")
    x = torch.from_numpy(_tied((1, 2, 13, 13), 8))
    with torch.no_grad():
        (plain,) = impl.apply(lp, [], [x.clone().requires_grad_()], False)
    assert plain.grad_fn is None
    (tracked,) = impl.apply(lp, [], [x.clone().requires_grad_()], True)
    assert type(tracked.grad_fn).__name__ == "MaxPoolBackward"
    torch.testing.assert_close(tracked.detach(), plain, rtol=0, atol=0)
    torch.testing.assert_close(plain, max_pool(x, 3, 3, 2, 2, 0, 0, 6, 6),
                               rtol=0, atol=0)
