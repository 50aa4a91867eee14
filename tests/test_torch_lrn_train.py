"""The port's LRN training forward and backward against the JAX package.

On the CPU the port's wrappers run their plain versions: the forward
that also returns ``scale`` (the counterpart of ``_lrn_fwd_kernel``) and
the closed-form backward (of ``_lrn_bwd_kernel``).  They are held against
``relu_lrn_across_channels``'s custom VJP with its Pallas kernels in
interpret mode, as tests/test_pallas.py:40-80 runs them, and against
``relu_lrn_reference``'s VJP, for both ``relu`` faces and window sizes 3,
4 and 5 (an even size is where the backward's reflected window differs
from the forward's).  f32 agrees at rtol 1e-4 (the bound of
graph/tuner.py:248 for this candidate), atol 1e-6; bf16 within 2 bf16
ulps: both sides do f32 math on the same bf16 values and round once,
and ``powf`` may differ by an f32 ulp.  The port's autograd function is
also checked by finite differences in f64.  The CUDA kernels are held
against these plain versions on the card by tests/test_torch_cuda_kernels.py
and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.ops.pallas_kernels import (_fwd_call,
                                             relu_lrn_across_channels)
from sparknet_tpu.ops.vision import (_relu_lrn_ref_vjp_bwd,
                                     relu_lrn_reference)
from sparknet_tpu_torch.ops import cuda_kernels as ck
from sparknet_tpu_torch.ops.vision import LRNAcrossChannels, relu_lrn
from test_torch_cuda_kernels import ALPHA, BETA, K, _ids, _input

CASES = [((2, 6, 5, 7), size, relu) for size in (3, 4, 5)
         for relu in (False, True)]
RTOL, ATOL = 1e-4, 1e-6


def _assert_within_bf16_ulps(got, want, ulps: int = 2) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    err = np.abs(got - want)
    assert (err <= ulps * ulp).all(), (
        f"{int((err > ulps * ulp).sum())} elements beyond {ulps} bf16 "
        f"ulps, max |err| {err.max():.3e}")


def _jax_vjp(fn, x, dy):
    y, vjp = jax.vjp(fn, x)
    return np.asarray(y, np.float32), np.asarray(vjp(dy)[0], np.float32)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_train_lrn_matches_jax_f32(case):
    shape, size, relu = case
    x, dy = _input(shape), _input(shape, seed=7)
    y, scale = ck.lrn_across_channels_fwd(torch.from_numpy(x), size, ALPHA,
                                          BETA, K, relu)
    dx = ck.lrn_across_channels_bwd(torch.from_numpy(x), scale,
                                    torch.from_numpy(dy), size, ALPHA, BETA,
                                    relu)
    jy, jscale = _fwd_call(jnp.asarray(x), size, ALPHA, BETA, K, relu)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=RTOL,
                               atol=ATOL)
    for fn in (relu_lrn_across_channels, relu_lrn_reference):
        wy, wdx = _jax_vjp(lambda t: fn(t, size, ALPHA, BETA, K, relu),
                           jnp.asarray(x), jnp.asarray(dy))
        np.testing.assert_allclose(y.numpy(), wy, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dx.numpy(), wdx, rtol=RTOL, atol=ATOL,
                                   err_msg=fn.__name__)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_train_lrn_matches_jax_bf16(case):
    shape, size, relu = case
    x16 = torch.from_numpy(_input(shape, seed=1)).to(torch.bfloat16)
    dy16 = torch.from_numpy(_input(shape, seed=8)).to(torch.bfloat16)
    y, scale = ck.lrn_across_channels_fwd(x16, size, ALPHA, BETA, K, relu)
    dx = ck.lrn_across_channels_bwd(x16, scale, dy16, size, ALPHA, BETA,
                                    relu)
    assert y.dtype == scale.dtype == dx.dtype == torch.bfloat16
    jx = jnp.asarray(x16.float().numpy(), jnp.bfloat16)
    jdy = jnp.asarray(dy16.float().numpy(), jnp.bfloat16)
    jy, jscale = _fwd_call(jx, size, ALPHA, BETA, K, relu)
    assert jscale.dtype == jnp.bfloat16
    _assert_within_bf16_ulps(y.float().numpy(), jy.astype(jnp.float32))
    _assert_within_bf16_ulps(scale.float().numpy(),
                             jscale.astype(jnp.float32))
    _, pallas_dx = _jax_vjp(
        lambda t: relu_lrn_across_channels(t, size, ALPHA, BETA, K, relu),
        jx, jdy)
    _assert_within_bf16_ulps(dx.float().numpy(), pallas_dx)
    # the reference VJP's backward rule on the same bf16 residuals
    (ref_dx,) = _relu_lrn_ref_vjp_bwd(
        size, ALPHA, BETA, K, relu,
        (jx, jnp.asarray(scale.float().numpy(), jnp.bfloat16)), jdy)
    _assert_within_bf16_ulps(dx.float().numpy(), ref_dx.astype(jnp.float32))


def test_even_window_backward_is_reflected():
    """At an even size the reflected window (post, pre) and the forward
    window (pre, post) give different gradients; the plain backward
    matches JAX only with the reflected one."""
    x, dy = _input((1, 8, 3, 3), seed=2), _input((1, 8, 3, 3), seed=3)
    t = torch.from_numpy(x)
    _, scale = ck.lrn_across_channels_fwd(t, 4, ALPHA, BETA, K)
    got = ck.lrn_across_channels_bwd(t, scale, torch.from_numpy(dy), 4,
                                     ALPHA, BETA).numpy()
    _, want = _jax_vjp(lambda v: relu_lrn_reference(v, 4, ALPHA, BETA, K),
                       jnp.asarray(x), jnp.asarray(dy))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    a = t.float()
    y = a * scale.pow(-BETA)
    pre, post = 1, 2
    forward_window = (torch.from_numpy(dy) * scale.pow(-BETA)
                      - (2 * ALPHA * BETA / 4) * a
                      * ck._window_sum(torch.from_numpy(dy) * y / scale,
                                       pre, post))
    assert not np.allclose(forward_window.numpy(), want, rtol=RTOL,
                           atol=ATOL)


@pytest.mark.parametrize("size", [3, 4, 5])
@pytest.mark.parametrize("relu", [False, True])
def test_autograd_function_gradient_matches_jax(size, relu):
    """Through ``torch.autograd``: the LRN function's input gradient
    against the JAX reference's custom VJP, f32."""
    x, dy = _input((2, 16, 5, 5), seed=4), _input((2, 16, 5, 5), seed=5)
    t = torch.from_numpy(x).requires_grad_()
    y = relu_lrn(t, size, ALPHA, BETA, K, relu)
    (dx,) = torch.autograd.grad(y, t, torch.from_numpy(dy))
    _, want = _jax_vjp(
        lambda v: relu_lrn_reference(v, size, ALPHA, BETA, K, relu),
        jnp.asarray(x), jnp.asarray(dy))
    np.testing.assert_allclose(dx.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size", [3, 4, 5])
@pytest.mark.parametrize("relu", [False, True])
def test_autograd_function_passes_gradcheck_f64(size, relu):
    """Finite differences in f64 on a tiny shape.  Inputs keep clear of
    the ReLU's kink at 0."""
    rng = np.random.default_rng(size)
    x = rng.uniform(0.2, 2.0, size=(1, 6, 2, 3)) * rng.choice([-1, 1],
                                                              (1, 6, 2, 3))
    t = torch.from_numpy(x).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: LRNAcrossChannels.apply(v, size, ALPHA, BETA, K, relu),
        (t,), eps=1e-6, atol=1e-7, rtol=1e-5)


def test_caffenet_alpha_at_pixel_scale():
    """CaffeNet's norm2 geometry and alpha 1e-4 on std-50 inputs (at unit
    scale the LRN would barely move its input): forward and gradient
    against the JAX custom VJP, f32."""
    shape, alpha = (2, 256, 3, 3), 1e-4
    x = (25.0 * _input(shape, seed=6)).astype(np.float32)
    dy = _input(shape, seed=9)
    t = torch.from_numpy(x).requires_grad_()
    y = relu_lrn(t, 5, alpha, BETA, K)
    (dx,) = torch.autograd.grad(y, t, torch.from_numpy(dy))
    wy, wdx = _jax_vjp(
        lambda v: relu_lrn_across_channels(v, 5, alpha, BETA, K),
        jnp.asarray(x), jnp.asarray(dy))
    np.testing.assert_allclose(y.detach().numpy(), wy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), wdx, rtol=RTOL, atol=ATOL)
    assert not np.allclose(wy, x, rtol=1e-2)   # the LRN did move it


def test_no_grad_takes_the_inference_path_and_autograd_the_training_one():
    """Without autograd the LRN layer calls the inference wrapper (the
    serving path, unchanged); under autograd the training wrappers."""
    x = torch.from_numpy(_input((1, 8, 3, 3)))
    with torch.no_grad():
        plain = relu_lrn(x.clone().requires_grad_(), 5, ALPHA, BETA, K)
    assert not plain.requires_grad
    torch.testing.assert_close(
        plain, ck.lrn_across_channels_reference(x, 5, ALPHA, BETA, K),
        rtol=0, atol=0)
    trained = relu_lrn(x.clone().requires_grad_(), 5, ALPHA, BETA, K)
    assert trained.grad_fn is not None
    torch.testing.assert_close(trained.detach(), plain, rtol=0, atol=0)
