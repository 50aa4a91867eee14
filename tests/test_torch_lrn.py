"""The port's ACROSS_CHANNELS LRN against the JAX package.

On the CPU the port's wrapper runs its plain version; it is held against
the JAX Pallas kernel ``relu_lrn_across_channels`` (interpret mode, as
tests/test_pallas.py runs it) and against ``relu_lrn_reference``, for both
faces of ``relu``, odd and even window sizes, f32 (rtol 1e-5, atol 1e-6)
and bf16 (within one bf16 ulp: both sides do f32 math and round once).
The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda_kernels.py, on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_layer_impl
from sparknet_tpu.ops.pallas_kernels import relu_lrn_across_channels
from sparknet_tpu.ops.vision import relu_lrn_reference
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import cuda_kernels as ck
from sparknet_tpu_torch.ops import get_layer_impl as torch_layer_impl
from test_torch_cuda_kernels import (
    ALPHA, BETA, K, _assert_within_bf16_ulp, _ids, _input)

# tests/test_pallas.py's shapes, plus CaffeNet norm2 at batch 1
SHAPES = [(2, 6, 5, 7), (1, 8, 3, 3), (2, 16, 5, 5), (1, 256, 13, 13)]
CASES = [(shape, size, relu) for shape in SHAPES for size in (3, 4, 5)
         for relu in (False, True)]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_lrn_matches_jax_f32(case):
    shape, size, relu = case
    x = _input(shape)
    got = ck.lrn_across_channels(torch.from_numpy(x), size, ALPHA, BETA, K,
                                 relu=relu).numpy()
    pallas = np.asarray(relu_lrn_across_channels(
        jnp.asarray(x), size, ALPHA, BETA, K, relu))
    ref = np.asarray(relu_lrn_reference(jnp.asarray(x), size, ALPHA, BETA,
                                        K, relu))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_lrn_matches_jax_bf16(case):
    shape, size, relu = case
    x16 = torch.from_numpy(_input(shape, seed=1)).to(torch.bfloat16)
    got = ck.lrn_across_channels(x16, size, ALPHA, BETA, K, relu=relu)
    assert got.dtype == torch.bfloat16
    xf = x16.float().numpy()        # the exact bf16 values, widened
    pallas = relu_lrn_across_channels(jnp.asarray(xf, jnp.bfloat16), size,
                                      ALPHA, BETA, K, relu)
    assert pallas.dtype == jnp.bfloat16
    # the reference's f32 math on the same values, rounded once to bf16
    ref = relu_lrn_reference(jnp.asarray(xf), size, ALPHA, BETA, K,
                             relu).astype(jnp.bfloat16)
    _assert_within_bf16_ulp(got.float().numpy(),
                            np.asarray(pallas.astype(jnp.float32)))
    _assert_within_bf16_ulp(got.float().numpy(),
                            np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("size", [3, 4, 5])
def test_lrn_layer_matches_jax_pallas_layer(size, monkeypatch):
    """The port's LRNLayer against the JAX LRNLayer routed through its
    Pallas kernel (SPARKNET_PALLAS_LRN=1, as tests/test_pallas.py:56)."""
    lrn = {"local_size": size, "alpha": ALPHA, "beta": BETA, "k": K}
    x = _input((2, 16, 5, 5), seed=size)
    monkeypatch.setenv("SPARKNET_PALLAS_LRN", "1")
    want = jax_layer_impl("LRN").apply(
        jax_layer("n", "LRN", ["x"], ["y"], lrn_param=lrn), [],
        [jnp.asarray(x)], False, None)[0]
    got = torch_layer_impl("LRN").apply(
        torch_layer("n", "LRN", ["x"], ["y"], lrn_param=lrn), [],
        [torch.from_numpy(x)], False)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    before = dict(ck.launch_counts)
    x = torch.from_numpy(_input((1, 8, 3, 3)))
    got = ck.lrn_across_channels(x, 5, ALPHA, BETA, K)
    want = ck.lrn_across_channels_reference(x, 5, ALPHA, BETA, K)
    assert torch.equal(got, want)
    assert ck.launch_counts == before


def test_wrapper_raises_on_a_tensor_neither_cpu_nor_cuda():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ck.lrn_across_channels(torch.empty((1, 4, 2, 2), device="meta"),
                               5, ALPHA, BETA, K)
