"""Neuron (elementwise) layers: ReLU and Dropout.

Counterparts of ``sparknet_tpu/ops/neuron.py`` (reference:
caffe/src/caffe/layers/{relu,dropout}_layer.cpp).
"""

from __future__ import annotations

import torch

from .registry import LayerImpl, register_layer


@register_layer("ReLU")
class ReLULayer(LayerImpl):
    """max(x,0) + negative_slope·min(x,0) (relu_layer.cpp)."""

    def apply(self, lp, params, bottoms, train, gen=None):
        slope = float(lp.sub("relu_param").get("negative_slope", 0.0))
        x = bottoms[0]
        if slope == 0.0:
            return [torch.relu(x)]
        return [torch.relu(x) + slope * torch.clamp_max(x, 0.0)]


@register_layer("Dropout")
class DropoutLayer(LayerImpl):
    """Inverted dropout: at train, zero with probability ``dropout_ratio``
    and scale the survivors by 1/(1 - ratio); the identity at test
    (dropout_layer.cpp:20-45).

    The keep mask is drawn on the CPU, from the CPU ``torch.Generator``
    that the net passes down, and copied to the input's device: the same
    generator then gives the same masks on the card and on the CPU, so a
    training round on the card can be checked against the CPU's.  (The
    JAX package's masks come from ``jax.random`` and cannot match.)"""

    def apply(self, lp, params, bottoms, train, gen=None):
        ratio = float(lp.sub("dropout_param").get("dropout_ratio", 0.5))
        x = bottoms[0]
        if not train or ratio == 0.0:
            return [x]
        if gen is None:
            raise NotImplementedError(
                f"layer {lp.name!r}: train-mode Dropout draws its mask "
                f"from a CPU torch.Generator; none was passed")
        keep = 1.0 - ratio
        mask = (torch.rand(x.shape, generator=gen) < keep).to(
            x.device, non_blocking=True)
        return [torch.where(mask, x / keep, torch.zeros_like(x))]
