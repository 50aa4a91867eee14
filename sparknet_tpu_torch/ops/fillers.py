"""Weight-initialization fillers, drawn from a ``torch.Generator``.

Caffe semantics for the fillers the zoo uses (reference:
caffe/include/caffe/filler.hpp:31-146), as in ``sparknet_tpu/ops/fillers.py``:
constant, gaussian, xavier.  Fan-in/fan-out follow XavierFiller:
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
    if t == "gaussian":
        return torch.empty(shape).normal_(filler.mean, filler.std,
                                          generator=gen)
    if t == "xavier":
        count = math.prod(shape)
        fan_in = count // shape[0] if shape else 1
        fan_out = count // shape[1] if len(shape) > 1 else count
        n = {"AVERAGE": (fan_in + fan_out) / 2.0,
             "FAN_OUT": fan_out}.get(filler.variance_norm, fan_in)
        scale = math.sqrt(3.0 / n)
        return torch.empty(shape).uniform_(-scale, scale, generator=gen)
    raise ValueError(f"filler type {t!r} is not ported")


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
