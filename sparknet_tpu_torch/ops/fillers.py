"""Weight-initialization fillers, drawn from a ``torch.Generator``.

Caffe semantics for the filler family (reference:
caffe/include/caffe/filler.hpp:31-146), as in ``sparknet_tpu/ops/fillers.py``
(:25-54): constant, uniform, gaussian, xavier, msra, positive_unitball and
bilinear.  Fan-in/fan-out follow XavierFiller/MSRAFiller:
fan_in = count/shape[0], fan_out = count/shape[1].
Blobs are drawn as f32 on the CPU, so a seed gives the same weights
whatever device they are moved to.  A ``torch.Generator`` and ``jax.random``
give different numbers from the same seed: tests carry weights across
(``convert.params_from_jax``) instead of re-drawing them.
"""

from __future__ import annotations

import math

import torch

from ..proto.caffe_pb import FillerParameter
from ..proto.textformat import PMessage

Shape = tuple[int, ...]


def fill(gen: torch.Generator, filler: FillerParameter,
         shape: Shape) -> torch.Tensor:
    t = filler.type
    if t == "constant":
        return torch.full(shape, filler.value, dtype=torch.float32)
    if t == "uniform":
        return torch.empty(shape).uniform_(filler.min, filler.max,
                                           generator=gen)
    if t == "gaussian":
        return torch.empty(shape).normal_(filler.mean, filler.std,
                                          generator=gen)
    if t in ("xavier", "msra"):
        count = math.prod(shape)
        fan_in = count // shape[0] if shape else 1
        fan_out = count // shape[1] if len(shape) > 1 else count
        n = {"AVERAGE": (fan_in + fan_out) / 2.0,
             "FAN_OUT": fan_out}.get(filler.variance_norm, fan_in)
        if t == "xavier":
            scale = math.sqrt(3.0 / n)
            return torch.empty(shape).uniform_(-scale, scale, generator=gen)
        return torch.empty(shape).normal_(0.0, math.sqrt(2.0 / n),
                                          generator=gen)
    if t == "positive_unitball":
        # uniform in [0, 1), each row (first axis) scaled to sum to 1
        x = torch.empty(shape).uniform_(0.0, 1.0, generator=gen)
        flat = x.reshape(shape[0], -1)
        return (flat / flat.sum(1, keepdim=True)).reshape(shape)
    if t == "bilinear":
        # the deconvolution upsampling kernel (filler.hpp BilinearFiller),
        # the same on every leading index
        kh, kw = shape[-2], shape[-1]
        f = math.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        wx = 1 - (torch.arange(kw, dtype=torch.float32) / f - c).abs()
        wy = 1 - (torch.arange(kh, dtype=torch.float32) / f - c).abs()
        return torch.outer(wy, wx).expand(shape).contiguous()
    raise ValueError(f"unknown filler type {t!r}")


def fill_weight_bias(gen: torch.Generator, p: PMessage,
                     shapes: list[Shape]) -> list[torch.Tensor]:
    """A weight blob from ``p.weight_filler`` and, when ``shapes`` has a
    second entry, a bias blob from ``p.bias_filler`` — the Convolution and
    InnerProduct ``LayerSetUp`` pattern."""
    blobs = [fill(gen, FillerParameter.from_pmsg(p.get("weight_filler")),
                  shapes[0])]
    if len(shapes) > 1:
        blobs.append(fill(gen, FillerParameter.from_pmsg(p.get("bias_filler")),
                          shapes[1]))
    return blobs
