"""Neuron (elementwise) layers: ReLU, PReLU, Sigmoid, TanH, AbsVal, BNLL,
Dropout, Exp, Log, Power and Threshold.

Counterparts of ``sparknet_tpu/ops/neuron.py`` (reference:
caffe/src/caffe/layers/{relu,prelu,sigmoid,tanh,absval,bnll,dropout,exp,
log,power,threshold}_layer.cpp), each one torch expression in the
input's dtype, differentiated by autograd.  None was a Pallas kernel in
the JAX package, and none is a hand kernel here.
"""

from __future__ import annotations

import math

import torch

from ..proto.caffe_pb import FillerParameter
from .fillers import fill
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


@register_layer("PReLU")
class PReLULayer(LayerImpl):
    """A learnable slope a channel (prelu_layer.cpp): blob (C,), or (1,)
    under ``channel_shared``; its filler defaults to constant 0.25."""

    def param_shapes(self, lp, bottom_shapes):
        shared = bool(lp.sub("prelu_param").get("channel_shared", False))
        return [(1 if shared else bottom_shapes[0][1],)]

    def init(self, gen, lp, bottom_shapes):
        p = lp.sub("prelu_param")
        f = (FillerParameter.from_pmsg(p.get("filler")) if p.has("filler")
             else FillerParameter(type="constant", value=0.25))
        return [fill(gen, f, self.param_shapes(lp, bottom_shapes)[0])]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        slope = params[0].reshape((1, -1) + (1,) * (x.dim() - 2))
        return [torch.relu(x) + slope * torch.clamp_max(x, 0.0)]


@register_layer("Sigmoid")
class SigmoidLayer(LayerImpl):
    def apply(self, lp, params, bottoms, train, gen=None):
        return [torch.sigmoid(bottoms[0])]


@register_layer("TanH")
class TanHLayer(LayerImpl):
    def apply(self, lp, params, bottoms, train, gen=None):
        return [torch.tanh(bottoms[0])]


@register_layer("AbsVal")
class AbsValLayer(LayerImpl):
    def apply(self, lp, params, bottoms, train, gen=None):
        return [torch.abs(bottoms[0])]


@register_layer("BNLL")
class BNLLLayer(LayerImpl):
    """log(1 + exp(x)) in bnll_layer.cpp's stable form."""

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        return [torch.relu(x) + torch.log1p(torch.exp(-torch.abs(x)))]


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

    def needs_rng(self, lp, train: bool = True) -> bool:
        return train and float(
            lp.sub("dropout_param").get("dropout_ratio", 0.5)) > 0

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


def _base_scale_shift(lp, key: str) -> tuple[float, float, float]:
    p = lp.sub(key)
    return (float(p.get("base", -1.0)), float(p.get("scale", 1.0)),
            float(p.get("shift", 0.0)))


@register_layer("Exp")
class ExpLayer(LayerImpl):
    """y = base^(shift + scale·x), base e when base is -1 (exp_layer.cpp)."""

    def apply(self, lp, params, bottoms, train, gen=None):
        base, scale, shift = _base_scale_shift(lp, "exp_param")
        inner = shift + scale * bottoms[0]
        if base == -1.0:
            return [torch.exp(inner)]
        return [torch.exp(inner * math.log(base))]


@register_layer("Log")
class LogLayer(LayerImpl):
    """y = log_base(shift + scale·x) (log_layer.cpp)."""

    def apply(self, lp, params, bottoms, train, gen=None):
        base, scale, shift = _base_scale_shift(lp, "log_param")
        y = torch.log(shift + scale * bottoms[0])
        if base != -1.0:
            y = y / math.log(base)
        return [y]


@register_layer("Power")
class PowerLayer(LayerImpl):
    """y = (shift + scale·x)^power (power_layer.cpp); power 1 takes no
    power at all."""

    def apply(self, lp, params, bottoms, train, gen=None):
        p = lp.sub("power_param")
        power = float(p.get("power", 1.0))
        inner = (float(p.get("shift", 0.0))
                 + float(p.get("scale", 1.0)) * bottoms[0])
        if power == 1.0:
            return [inner]
        return [inner ** power]


@register_layer("Threshold")
class ThresholdLayer(LayerImpl):
    """y = 1[x > threshold] (threshold_layer.cpp); its gradient is zero,
    so nothing flows back through it."""

    def apply(self, lp, params, bottoms, train, gen=None):
        t = float(lp.sub("threshold_param").get("threshold", 0.0))
        return [(bottoms[0] > t).to(bottoms[0].dtype)]
