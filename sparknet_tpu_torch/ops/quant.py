"""Symmetric quantize and dequantize for the compressed weight exchange.

The port's counterpart of ``sparknet_tpu/ops/quant.py`` :1-79: the
arithmetic the codecs of ``parallel/comms.py`` encode weight deltas with.
It is plain elementwise torch, as the JAX package's is plain ``jnp``
outside any Pallas kernel, and on every device it gives the JAX
package's bits.

- **Symmetric, no zero point**: ``q = clip(round(x / s), -127, 127)``,
  ``x̂ = q·s``, so ``q == 0`` decodes to exactly 0.
- **Scale granularity by ``keep_axes``**: one scale per index of the
  kept axes, the max over every other axis.  ``()`` is per tensor,
  ``(0,)`` per leading index (per worker row of a stacked delta),
  ``(0, 1)`` per (row, channel).
- **Zero-safe**: an all-zero group gets scale 1.0, not 0/127.
- ``amax / 127`` divides by a tensor, never by a Python number: CUDA
  multiplies a tensor by the reciprocal of a Python divisor, which can
  move a scale by one ulp, and through it a ``q``, away from the CPU's
  and the JAX package's true division.  ``torch.round`` rounds half to
  even, as ``jnp.round`` does.  The residual ``delta - q·s`` is two
  rounded operations, so ``decoded + residual == delta`` exactly.  This
  is the JAX package's arithmetic as its ``ops/quant.py`` and
  ``parallel/comms.py`` state it and run it op by op; XLA's CPU compiler
  rewrites it inside the JAX trainer's compiled encode (ROADMAP C), and
  tests/test_torch_codec_rounds.py bounds the difference that makes.
"""

from __future__ import annotations

import torch

INT8_LEVELS = 127  # symmetric int8: wire values in [-127, 127] (no -128)


def _reduce_axes(ndim: int, keep_axes: tuple[int, ...]) -> tuple[int, ...]:
    keep = {a % max(ndim, 1) for a in keep_axes}
    return tuple(i for i in range(ndim) if i not in keep)


def int8_scale(x: torch.Tensor,
               keep_axes: tuple[int, ...] = ()) -> torch.Tensor:
    """amax/127 over the reduced axes, keepdims, so it broadcasts back
    onto ``x``; zero groups get 1.0."""
    x = x.to(torch.float32)
    axes = _reduce_axes(x.dim(), keep_axes)
    amax = (x.abs().amax(dim=axes, keepdim=True) if axes
            else x.abs())
    levels = torch.full_like(amax, INT8_LEVELS)
    return torch.where(amax > 0, amax / levels, torch.ones_like(amax))


def quantize_int8(x: torch.Tensor, keep_axes: tuple[int, ...] = ()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (q int8, scale f32), round half to even onto the 127-level
    grid."""
    x = x.to(torch.float32)
    s = int8_scale(x, keep_axes)
    q = torch.clamp(torch.round(x / s), -INT8_LEVELS, INT8_LEVELS)
    return q.to(torch.int8), s


def dequantize_int8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(q int8, scale) -> f32; exact for q == 0."""
    return q.to(torch.float32) * s.to(torch.float32)


def quantize_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 wire format (round half to even on the dropped
    mantissa; f32 subnormals round onto bf16's subnormals)."""
    return x.to(torch.float32).to(torch.bfloat16)


def dequantize_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16 wire -> f32 (exact)."""
    return x.to(torch.float32)
