"""InnerProduct, Softmax, Accuracy, Flatten, Concat, Slice and Split.

Counterparts of the layers of ``sparknet_tpu/ops/common.py`` (reference:
caffe/src/caffe/layers/{inner_product,softmax,accuracy,flatten,concat,
slice,split}_layer.cpp).  The weight
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
    the label's favour, as Caffe's partial sort does.  A second top is
    the accuracy of each class: its correct predictions over its count,
    0 for a class the batch lacks (accuracy_layer.cpp ``nums_buffer_``)."""

    def out_shapes(self, lp, bottom_shapes):
        if len(lp.top) > 1:
            axis = _canon_axis(int(lp.sub("accuracy_param").get("axis", 1)),
                               len(bottom_shapes[0]))
            return [(), (bottom_shapes[0][axis],)]
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
            mask = torch.ones_like(correct)
            tops = [correct.mean()]
        else:
            mask = (lab != int(ignore)).float()
            tops = [(correct * mask).sum() / mask.sum().clamp_min(1.0)]
        if len(lp.top) > 1:
            classes = torch.arange(sc.shape[-1], device=lab.device)
            onehot = (lab[..., None] == classes) * mask[..., None]
            count = onehot.sum((0, 1))
            hits = (onehot * correct[..., None]).sum((0, 1))
            tops.append(hits / count.clamp_min(1.0))
        return tops


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


@register_layer("Slice")
class SliceLayer(LayerImpl):
    """Split along ``axis`` (the legacy ``slice_dim`` wins where given) at
    each ``slice_point``, or into equal parts, one a top
    (slice_layer.cpp).  The tops are views; autograd writes each one's
    gradient into its part of the bottom's."""

    def _bounds(self, lp, shape) -> tuple[int, list[int]]:
        p = lp.sub("slice_param")
        if p.has("slice_dim"):
            axis = int(p.get("slice_dim"))
        else:
            axis = _canon_axis(int(p.get("axis", 1)), len(shape))
        points = [int(x) for x in p.get_all("slice_point")]
        if not points:
            ntop = max(len(lp.top), 1)
            if shape[axis] % ntop:
                raise ValueError(
                    f"layer {lp.name!r}: axis dim {shape[axis]} not "
                    f"divisible into {ntop} equal slices (give slice_point)")
            step = shape[axis] // ntop
            points = [step * i for i in range(1, ntop)]
        return axis, [0] + points + [shape[axis]]

    def out_shapes(self, lp, bottom_shapes):
        shape = tuple(bottom_shapes[0])
        axis, bounds = self._bounds(lp, shape)
        return [shape[:axis] + (hi - lo,) + shape[axis + 1:]
                for lo, hi in zip(bounds, bounds[1:])]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        axis, bounds = self._bounds(lp, tuple(x.shape))
        return [x.narrow(axis, lo, hi - lo)
                for lo, hi in zip(bounds, bounds[1:])]


@register_layer("Split")
class SplitLayer(LayerImpl):
    """Fan-out: one bottom to N tops (split_layer.cpp).  The tops are the
    bottom itself; autograd sums their gradients, as Caffe's backward
    does."""

    def out_shapes(self, lp, bottom_shapes):
        return [tuple(bottom_shapes[0])] * max(len(lp.top), 1)

    def apply(self, lp, params, bottoms, train, gen=None):
        return [bottoms[0]] * max(len(lp.top), 1)
