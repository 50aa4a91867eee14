"""Neuron (elementwise) layers: ReLU and Dropout.

Counterparts of ``sparknet_tpu/ops/neuron.py`` (reference:
caffe/src/caffe/layers/{relu,dropout}_layer.cpp).  Dropout is the identity
at ``train=False``; its train mode comes with the training slice.
"""

from __future__ import annotations

import torch

from .registry import LayerImpl, register_layer


@register_layer("ReLU")
class ReLULayer(LayerImpl):
    """max(x,0) + negative_slope·min(x,0) (relu_layer.cpp)."""

    def apply(self, lp, params, bottoms, train):
        slope = float(lp.sub("relu_param").get("negative_slope", 0.0))
        x = bottoms[0]
        if slope == 0.0:
            return [torch.relu(x)]
        return [torch.relu(x) + slope * torch.clamp_max(x, 0.0)]


@register_layer("Dropout")
class DropoutLayer(LayerImpl):
    """Inverted dropout; the identity at test (dropout_layer.cpp:20-45)."""

    def apply(self, lp, params, bottoms, train):
        ratio = float(lp.sub("dropout_param").get("dropout_ratio", 0.5))
        if train and ratio > 0.0:
            raise NotImplementedError(
                f"layer {lp.name!r}: train-mode Dropout is not ported yet")
        return [bottoms[0]]
