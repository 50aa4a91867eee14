"""Loss layers: SoftmaxWithLoss.

The port's counterpart of ``sparknet_tpu/ops/loss.py`` :25-72 (reference:
caffe/src/caffe/layers/softmax_loss_layer.cpp).  Normalization follows
Caffe exactly, since it sets the effective learning rate.  The loss is
computed in f32 whatever the compute dtype.
"""

from __future__ import annotations

import math

import torch

from .common import _canon_axis
from .registry import LayerImpl, register_layer


class LossLayer(LayerImpl):
    """A layer whose one top is a scalar loss."""

    def out_shapes(self, lp, bottom_shapes):
        return [()]


@register_layer("SoftmaxWithLoss")
class SoftmaxWithLossLayer(LossLayer):
    """Softmax and multinomial logistic loss in one stable pass.
    ``loss_param { ignore_label, normalize }``: with ``normalize`` (the
    default) the summed loss is divided by the count of non-ignored
    predictions (N x spatial), without it by the product of the score
    dims before the softmax axis (Caffe's ``outer_num_``)."""

    def apply(self, lp, params, bottoms, train, gen=None):
        p = lp.sub("loss_param")
        ignore = p.get("ignore_label")
        normalize = bool(p.get("normalize", True))
        scores, labels = bottoms[0].float(), bottoms[1]
        axis = _canon_axis(int(lp.sub("softmax_param").get("axis", 1)),
                           scores.dim())
        logp = torch.log_softmax(scores, dim=axis).movedim(axis, -1)
        n = logp.shape[0]
        logp = logp.reshape(n, -1, logp.shape[-1])      # (N, spatial, C)
        lab = labels.long().reshape(n, -1)              # (N, spatial)
        # an ignored label may lie outside the classes (e.g. 255): clamp
        # the gather, the mask drops the term
        safe = lab.clamp(0, logp.shape[-1] - 1)
        nll = -logp.gather(-1, safe[..., None])[..., 0]
        if ignore is not None:
            mask = (lab != int(ignore)).float()
            nll = nll * mask
            count = mask.sum().clamp_min(1.0)
        else:
            count = float(nll.numel())
        total = nll.sum()
        if normalize:
            return [total / count]
        return [total / math.prod(scores.shape[:axis])]
