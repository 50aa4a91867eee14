"""InnerProduct, Softmax, Accuracy, Flatten, Concat and Split.

Counterparts of the layers of ``sparknet_tpu/ops/common.py`` (reference:
caffe/src/caffe/layers/{inner_product,softmax,accuracy,flatten,concat,
split}_layer.cpp).  The weight
keeps the JAX layout, (num_output, dim) or (dim, num_output) with
``transpose``.  The product goes to ``F.linear``/``torch.matmul``, as the
JAX package left it to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..proto.caffe_pb import LayerParameter
from .fillers import fill_weight_bias
from .registry import LayerImpl, Shape, register_layer


def _canon_axis(axis: int, ndim: int) -> int:
    return axis + ndim if axis < 0 else axis


def inner_product_geometry(lp: LayerParameter, bottom_shape: Shape):
    """(num_output, axis, dim, transpose, bias_term) of an InnerProduct."""
    p = lp.sub("inner_product_param")
    axis = _canon_axis(int(p.get("axis", 1)), len(bottom_shape))
    return (int(p.get("num_output", 0)), axis,
            math.prod(bottom_shape[axis:]),
            bool(p.get("transpose", False)), bool(p.get("bias_term", True)))


@register_layer("InnerProduct")
class InnerProductLayer(LayerImpl):
    """Fully-connected layer: flattens from ``axis``, then one GEMM."""

    def out_shapes(self, lp, bottom_shapes):
        num_output, axis, _, _, _ = inner_product_geometry(
            lp, bottom_shapes[0])
        return [tuple(bottom_shapes[0][:axis]) + (num_output,)]

    def param_shapes(self, lp, bottom_shapes):
        num_output, _, dim, transpose, bias_term = inner_product_geometry(
            lp, bottom_shapes[0])
        wshape = (dim, num_output) if transpose else (num_output, dim)
        return [wshape, (num_output,)] if bias_term else [wshape]

    def init(self, gen, lp, bottom_shapes):
        return fill_weight_bias(gen, lp.sub("inner_product_param"),
                                self.param_shapes(lp, bottom_shapes))

    def apply(self, lp, params, bottoms, train, gen=None):
        _, axis, dim, transpose, bias_term = inner_product_geometry(
            lp, tuple(bottoms[0].shape))
        x = bottoms[0].reshape(tuple(bottoms[0].shape[:axis]) + (dim,))
        bias = params[1] if bias_term else None
        if transpose:
            y = torch.matmul(x, params[0])
            return [y + bias if bias is not None else y]
        return [F.linear(x, params[0], bias)]


@register_layer("Softmax")
class SoftmaxLayer(LayerImpl):
    """Softmax along ``axis`` (softmax_layer.cpp), in the input's dtype."""

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        axis = _canon_axis(int(lp.sub("softmax_param").get("axis", 1)),
                           x.dim())
        return [torch.softmax(x, dim=axis)]


@register_layer("Accuracy")
class AccuracyLayer(LayerImpl):
    """Top-k classification accuracy with optional ``ignore_label``
    (accuracy_layer.cpp): bottom[0] scores (N, C, spatial...), bottom[1]
    integer-valued labels; one scalar top, in f32.  The label's rank is
    the count of classes with a strictly greater score, so ties count in
    the label's favour, as Caffe's partial sort does.  The per-class
    second top is not ported yet."""

    def out_shapes(self, lp, bottom_shapes):
        if len(lp.top) > 1:
            raise NotImplementedError(
                f"layer {lp.name!r}: the per-class accuracy top is not "
                f"ported yet")
        return [()]

    def apply(self, lp, params, bottoms, train, gen=None):
        p = lp.sub("accuracy_param")
        top_k = int(p.get("top_k", 1))
        ignore = p.get("ignore_label")
        scores, labels = bottoms[0].float(), bottoms[1]
        axis = _canon_axis(int(p.get("axis", 1)), scores.dim())
        n = scores.shape[0]
        sc = scores.movedim(axis, -1).reshape(n, -1, scores.shape[axis])
        lab = labels.long().reshape(n, -1)
        # an ignored label may lie outside the classes: clamp the gather,
        # the mask drops the term
        safe = lab.clamp(0, sc.shape[-1] - 1)
        true_score = sc.gather(-1, safe[..., None])
        rank = (sc > true_score).sum(-1)
        correct = (rank < top_k).float()
        if ignore is None:
            return [correct.mean()]
        mask = (lab != int(ignore)).float()
        return [(correct * mask).sum() / mask.sum().clamp_min(1.0)]


@register_layer("Flatten")
class FlattenLayer(LayerImpl):
    """Flatten axes [axis, end_axis] (reference: flatten_layer.cpp)."""

    def _axes(self, lp, ndim):
        p = lp.sub("flatten_param")
        axis = _canon_axis(int(p.get("axis", 1)), ndim)
        end = _canon_axis(int(p.get("end_axis", -1)), ndim)
        return axis, end

    def out_shapes(self, lp, bottom_shapes):
        s = tuple(bottom_shapes[0])
        axis, end = self._axes(lp, len(s))
        return [s[:axis] + (math.prod(s[axis:end + 1]),) + s[end + 1:]]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        return [x.reshape(self.out_shapes(lp, [tuple(x.shape)])[0])]


@register_layer("Concat")
class ConcatLayer(LayerImpl):
    """Concatenate along ``axis`` (default 1; the legacy ``concat_dim``
    wins where given) — concat_layer.cpp."""

    def _axis(self, lp, ndim):
        p = lp.sub("concat_param")
        if p.has("concat_dim"):
            return int(p.get("concat_dim"))
        return _canon_axis(int(p.get("axis", 1)), ndim)

    def out_shapes(self, lp, bottom_shapes):
        axis = self._axis(lp, len(bottom_shapes[0]))
        s = list(bottom_shapes[0])
        s[axis] = sum(bs[axis] for bs in bottom_shapes)
        return [tuple(s)]

    def apply(self, lp, params, bottoms, train, gen=None):
        return [torch.cat(list(bottoms), dim=self._axis(lp, bottoms[0].dim()))]


@register_layer("Split")
class SplitLayer(LayerImpl):
    """Fan-out: one bottom to N tops (split_layer.cpp).  The tops are the
    bottom itself; autograd sums their gradients, as Caffe's backward
    does."""

    def out_shapes(self, lp, bottom_shapes):
        return [tuple(bottom_shapes[0])] * max(len(lp.top), 1)

    def apply(self, lp, params, bottoms, train, gen=None):
        return [bottoms[0]] * max(len(lp.top), 1)
