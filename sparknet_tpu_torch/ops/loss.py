"""Loss layers: SoftmaxWithLoss, MultinomialLogisticLoss, EuclideanLoss,
SigmoidCrossEntropyLoss, HingeLoss, InfogainLoss and ContrastiveLoss.

The port's counterpart of ``sparknet_tpu/ops/loss.py`` (reference:
caffe/src/caffe/layers/{softmax_loss,multinomial_logistic_loss,
euclidean_loss,sigmoid_cross_entropy_loss,hinge_loss,infogain_loss,
contrastive_loss}_layer.cpp).  Normalization follows the JAX package
exactly, since it sets the effective learning rate.  The net runs every
loss layer in f32 whatever the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import _canon_axis
from .registry import LayerImpl, register_layer

_LOG_THRESHOLD = 1e-20


class LossLayer(LayerImpl):
    """A layer whose one top is a scalar loss."""

    def min_bottoms(self) -> int:
        return 2

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


def _labels(labels: torch.Tensor, n: int) -> torch.Tensor:
    return labels.long().reshape(n)


@register_layer("MultinomialLogisticLoss")
class MultinomialLogisticLossLayer(LossLayer):
    """-log(prob[label]) averaged over the batch, the probability clamped
    at 1e-20 (multinomial_logistic_loss_layer.cpp)."""

    def apply(self, lp, params, bottoms, train, gen=None):
        probs = bottoms[0]
        n = probs.shape[0]
        lab = _labels(bottoms[1], n)
        p = probs.reshape(n, -1)[torch.arange(n, device=probs.device), lab]
        return [-torch.log(p.clamp_min(_LOG_THRESHOLD)).sum() / n]


@register_layer("EuclideanLoss")
class EuclideanLossLayer(LossLayer):
    """sum((a - b)²) / 2N (euclidean_loss_layer.cpp)."""

    def apply(self, lp, params, bottoms, train, gen=None):
        d = bottoms[0] - bottoms[1]
        return [(d * d).sum() / (2.0 * d.shape[0])]


@register_layer("SigmoidCrossEntropyLoss")
class SigmoidCrossEntropyLossLayer(LossLayer):
    """The logistic loss of logits against targets in
    sigmoid_cross_entropy_loss_layer.cpp's stable form, summed and divided
    by N."""

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        t = bottoms[1].to(x.dtype)
        loss = torch.relu(x) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
        return [loss.sum() / x.shape[0]]


@register_layer("HingeLoss")
class HingeLossLayer(LossLayer):
    """One-vs-all hinge loss, L1 or L2 (hinge_loss_layer.cpp), over N."""

    def apply(self, lp, params, bottoms, train, gen=None):
        norm = str(lp.sub("hinge_loss_param").get("norm", "L1"))
        scores = bottoms[0]
        n = scores.shape[0]
        s = scores.reshape(n, -1)
        lab = _labels(bottoms[1], n)
        sign = torch.where(F.one_hot(lab, s.shape[1]) > 0, 1.0, -1.0).to(
            s.dtype)
        margin = torch.relu(1.0 - sign * s)
        if norm == "L2":
            return [(margin * margin).sum() / n]
        return [margin.sum() / n]


@register_layer("InfogainLoss")
class InfogainLossLayer(LossLayer):
    """-Σ_j H[label, j]·log(p_j) / N, the probability clamped at 1e-20,
    with the infogain matrix H a third bottom or the BlobProto file
    ``infogain_loss_param.source`` (infogain_loss_layer.cpp LayerSetUp):
    read once and kept on each device it was asked for."""

    _H_CACHE: dict = {}

    def _matrix(self, lp, bottoms) -> torch.Tensor:
        if len(bottoms) >= 3:
            return bottoms[2]
        source = lp.sub("infogain_loss_param").get("source")
        if source is None:
            raise ValueError(
                "InfogainLoss needs H: a third bottom or "
                "infogain_loss_param.source (infogain_loss_layer.cpp)")
        key = (str(source), bottoms[0].device)
        if key not in self._H_CACHE:
            from ..proto.caffemodel import load_mean_binaryproto
            self._H_CACHE[key] = torch.from_numpy(
                load_mean_binaryproto(str(source)).copy()).to(key[1])
        return self._H_CACHE[key]

    def apply(self, lp, params, bottoms, train, gen=None):
        probs = bottoms[0]
        c = probs.shape[1]
        H = self._matrix(lp, bottoms).reshape(c, c)
        n = probs.shape[0]
        lab = _labels(bottoms[1], n)
        logp = torch.log(probs.reshape(n, -1).clamp_min(_LOG_THRESHOLD))
        return [-(H[lab] * logp).sum() / n]


@register_layer("ContrastiveLoss")
class ContrastiveLossLayer(LossLayer):
    """The siamese contrastive loss (contrastive_loss_layer.cpp) over 2N:
    y·d² + (1 − y)·max(margin − d, 0)², d = sqrt(d² + 1e-12); with
    ``legacy_version``, (1 − y)·max(margin − d², 0)."""

    def min_bottoms(self) -> int:
        return 3

    def apply(self, lp, params, bottoms, train, gen=None):
        p = lp.sub("contrastive_loss_param")
        margin = float(p.get("margin", 1.0))
        legacy = bool(p.get("legacy_version", False))
        a, b = bottoms[0], bottoms[1]
        n = a.shape[0]
        y = bottoms[2].to(a.dtype).reshape(n)
        d2 = ((a - b) ** 2).sum(dim=1)
        if legacy:
            neg = torch.relu(margin - d2)
        else:
            dist = torch.relu(margin - torch.sqrt(d2 + 1e-12))
            neg = dist * dist
        return [(y * d2 + (1.0 - y) * neg).sum() / (2.0 * n)]
