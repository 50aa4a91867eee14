"""InnerProduct, BatchNorm, Scale, Bias, MVN, Embed, the shape layers
(Flatten, Reshape, Concat, Slice, Split, Tile), Eltwise, Reduction,
Filter, BatchReindex, ArgMax, Softmax, Accuracy and Silence.

Counterparts of the layers of ``sparknet_tpu/ops/common.py`` (reference:
caffe/src/caffe/layers/*.cpp under caffe/include/caffe/common_layers.hpp).
The weight keeps the JAX layout, (num_output, dim) or (dim, num_output)
with ``transpose``.  Every layer here is torch library work under
autograd, as the JAX package left them all to XLA: the product goes to
``F.linear``/``torch.matmul``.  BatchNorm is the one layer with forward
state: its ``apply`` returns ``(tops, updated_blobs)``, its running
statistics as the training forward rewrote them.  An index blob (Embed,
BatchReindex) is read as JAX reads it: truncated to an integer, a
negative index counted from the end, then clamped into range (so an
index out of range never reaches the card's bounds assert), the
gradient of one that was out of range dropped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..proto.caffe_pb import FillerParameter, LayerParameter
from .fillers import fill, fill_weight_bias
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

    def min_bottoms(self) -> int:
        return 2

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


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x``'s rows at an index blob, as JAX's ``x[idx.astype(int32)]``
    reads them: each index truncated toward zero, a negative one counted
    from the end, then clamped into [0, n); the gradient of an index
    that was out of range is dropped, as JAX's transpose drops it."""
    n = x.shape[0]
    i = idx.to(torch.int64)
    i = torch.where(i < 0, i + n, i)
    rows = x[i.clamp(0, n - 1)]
    if not rows.requires_grad:
        return rows
    valid = ((i >= 0) & (i < n)).reshape(
        tuple(i.shape) + (1,) * (rows.dim() - i.dim()))
    return torch.where(valid, rows, rows.detach())


@register_layer("BatchNorm")
class BatchNormLayer(LayerImpl):
    """Caffe BatchNorm (batch_norm_layer.cpp): three blobs that no
    gradient moves, the running mean (C,), the running variance (C,) and
    the scale factor (1,), each a λ-decayed sum (λ =
    ``moving_average_fraction``).  In training the input is normalised
    by the batch's mean and biased variance, and the blobs come back as
    ``mean_b·λ + mean``, ``var_b·λ + m/(m−1)·var`` (m the count a
    channel) and ``scale_b·λ + 1``.  With ``use_global_stats`` (by
    default ``not train``) the input is normalised by the stored sums
    over the scale factor (a factor of 0 gives 0) and the blobs come back
    unchanged.  The affine part is a separate Scale layer."""

    has_state = True

    def param_shapes(self, lp, bottom_shapes):
        c = bottom_shapes[0][1]
        return [(c,), (c,), (1,)]

    def init(self, gen, lp, bottom_shapes):
        return [torch.zeros(s) for s in self.param_shapes(lp, bottom_shapes)]

    def apply(self, lp, params, bottoms, train, gen=None):
        p = lp.sub("batch_norm_param")
        use_global = bool(p.get("use_global_stats", not train))
        maf = float(p.get("moving_average_fraction", 0.999))
        eps = float(p.get("eps", 1e-5))
        x = bottoms[0]
        mean_b, var_b, scale_b = params
        bshape = (1, -1) + (1,) * (x.dim() - 2)
        if use_global:
            s = scale_b[0]
            zero = s == 0
            factor = torch.where(zero, torch.zeros_like(s),
                                 1.0 / torch.where(zero, torch.ones_like(s),
                                                   s))
            mean, var = mean_b * factor, var_b * factor
            y = (x - mean.reshape(bshape)) / torch.sqrt(var.reshape(bshape)
                                                        + eps)
            return [y], list(params)
        axes = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(axes)
        var = ((x - mean.reshape(bshape)) ** 2).mean(axes)
        y = (x - mean.reshape(bshape)) / torch.sqrt(var.reshape(bshape) + eps)
        m = x.numel() // x.shape[1]
        corr = m / max(m - 1, 1)
        updated = [mean_b * maf + mean.detach(),
                   var_b * maf + corr * var.detach(),
                   scale_b * maf + 1.0]
        return [y], updated


def _scale_shape(lp: LayerParameter, key: str,
                 bottom_shape: Shape) -> tuple[int, Shape]:
    """(axis, blob shape) of Scale and Bias: ``num_axes`` dims from
    ``axis`` (-1: to the end)."""
    p = lp.sub(key)
    axis = _canon_axis(int(p.get("axis", 1)), len(bottom_shape))
    num_axes = int(p.get("num_axes", 1))
    end = len(bottom_shape) if num_axes == -1 else axis + num_axes
    return axis, tuple(bottom_shape[axis:end])


def _broadcastable(v: torch.Tensor, axis: int, x: torch.Tensor
                   ) -> torch.Tensor:
    shape = [1] * x.dim()
    for i, d in enumerate(v.shape):
        shape[axis + i] = d
    return v.reshape(shape)


@register_layer("Scale")
class ScaleLayer(LayerImpl):
    """y = x·γ (+ β), γ broadcast from ``axis`` (scale_layer.cpp).  With a
    second bottom, γ is that bottom and the only blob is β (under
    ``bias_term``, shaped like the second bottom).  γ's filler defaults
    to constant 1."""

    def param_shapes(self, lp, bottom_shapes):
        p = lp.sub("scale_param")
        if len(lp.bottom) > 1:
            shapes = []
            shape = tuple(bottom_shapes[1])
        else:
            _, shape = _scale_shape(lp, "scale_param", bottom_shapes[0])
            shapes = [shape]
        if bool(p.get("bias_term", False)):
            shapes.append(shape)
        return shapes

    def init(self, gen, lp, bottom_shapes):
        p = lp.sub("scale_param")
        shapes = self.param_shapes(lp, bottom_shapes)
        blobs = []
        if len(lp.bottom) == 1:
            f = (FillerParameter.from_pmsg(p.get("filler")) if p.has("filler")
                 else FillerParameter(type="constant", value=1.0))
            blobs.append(fill(gen, f, shapes[0]))
        if bool(p.get("bias_term", False)):
            blobs.append(fill(gen, FillerParameter.from_pmsg(
                p.get("bias_filler")), shapes[-1]))
        return blobs

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        axis, _ = _scale_shape(lp, "scale_param", tuple(x.shape))
        bias_term = bool(lp.sub("scale_param").get("bias_term", False))
        if len(bottoms) > 1:
            gamma = bottoms[1]
            beta = params[0] if bias_term and params else None
        else:
            gamma = params[0]
            beta = params[1] if bias_term and len(params) > 1 else None
        y = x * _broadcastable(gamma, axis, x)
        if beta is not None:
            y = y + _broadcastable(beta, axis, x)
        return [y]


@register_layer("Bias")
class BiasLayer(LayerImpl):
    """y = x + β, β broadcast from ``axis`` (bias_layer.cpp): a blob, or
    the second bottom."""

    def param_shapes(self, lp, bottom_shapes):
        if len(lp.bottom) > 1:
            return []
        return [_scale_shape(lp, "bias_param", bottom_shapes[0])[1]]

    def init(self, gen, lp, bottom_shapes):
        return [fill(gen, FillerParameter.from_pmsg(
            lp.sub("bias_param").get("filler")), s)
            for s in self.param_shapes(lp, bottom_shapes)]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        axis, _ = _scale_shape(lp, "bias_param", tuple(x.shape))
        beta = bottoms[1] if len(bottoms) > 1 else params[0]
        return [x + _broadcastable(beta, axis, x)]


@register_layer("MVN")
class MVNLayer(LayerImpl):
    """Mean-variance normalisation a sample (mvn_layer.cpp), over the
    spatial axes or, ``across_channels``, over C too; eps is added to the
    standard deviation, not to the variance."""

    def apply(self, lp, params, bottoms, train, gen=None):
        p = lp.sub("mvn_param")
        x = bottoms[0]
        axes = tuple(range(1 if bool(p.get("across_channels", False))
                           else 2, x.dim()))
        y = x - x.mean(axes, keepdim=True)
        if bool(p.get("normalize_variance", True)):
            std = torch.sqrt((y * y).mean(axes, keepdim=True))
            y = y / (std + float(p.get("eps", 1e-9)))
        return [y]


@register_layer("Embed")
class EmbedLayer(LayerImpl):
    """A lookup into an (input_dim, num_output) table, plus a bias
    (embed_layer.cpp): InnerProduct on one-hot input."""

    def _geom(self, lp):
        p = lp.sub("embed_param")
        return (int(p.get("num_output", 0)), int(p.get("input_dim", 0)),
                bool(p.get("bias_term", True)))

    def out_shapes(self, lp, bottom_shapes):
        return [tuple(bottom_shapes[0]) + (self._geom(lp)[0],)]

    def param_shapes(self, lp, bottom_shapes):
        num_output, input_dim, bias_term = self._geom(lp)
        return [(input_dim, num_output)] + ([(num_output,)] if bias_term
                                            else [])

    def init(self, gen, lp, bottom_shapes):
        return fill_weight_bias(gen, lp.sub("embed_param"),
                                self.param_shapes(lp, bottom_shapes))

    def apply(self, lp, params, bottoms, train, gen=None):
        y = _take(params[0], bottoms[0])
        if self._geom(lp)[2]:
            y = y + params[1]
        return [y]


@register_layer("Reshape")
class ReshapeLayer(LayerImpl):
    """Reshape the [axis, axis + num_axes) window of dims to
    ``shape``, a 0 entry copying the dim there and one -1 inferred
    (reshape_layer.cpp)."""

    def out_shapes(self, lp, bottom_shapes):
        s = list(bottom_shapes[0])
        p = lp.sub("reshape_param")
        spec = ([int(d) for d in p.get("shape").get_all("dim")]
                if p.get("shape") else [])
        axis = _canon_axis(int(p.get("axis", 0)), len(s))
        num_axes = int(p.get("num_axes", -1))
        end = len(s) if num_axes == -1 else axis + num_axes
        window = s[axis:end]
        out = [window[i] if d == 0 else 1 if d == -1 else d
               for i, d in enumerate(spec)]
        if -1 in spec:
            out[spec.index(-1)] = math.prod(window) // math.prod(out)
        return [tuple(s[:axis]) + tuple(out) + tuple(s[end:])]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        return [x.reshape(self.out_shapes(lp, [tuple(x.shape)])[0])]


@register_layer("Eltwise")
class EltwiseLayer(LayerImpl):
    """PROD, SUM with ``coeff``s, or MAX over equal-shaped bottoms
    (eltwise_layer.cpp)."""

    def apply(self, lp, params, bottoms, train, gen=None):
        p = lp.sub("eltwise_param")
        op = str(p.get("operation", "SUM"))
        if op == "PROD":
            y = bottoms[0]
            for b in bottoms[1:]:
                y = y * b
        elif op == "SUM":
            coeffs = ([float(c) for c in p.get_all("coeff")]
                      or [1.0] * len(bottoms))
            if len(coeffs) != len(bottoms):
                raise ValueError(
                    f"layer {lp.name!r}: eltwise coeff count {len(coeffs)} "
                    f"!= bottom count {len(bottoms)}")
            y = coeffs[0] * bottoms[0]
            for c, b in zip(coeffs[1:], bottoms[1:]):
                y = y + c * b
        elif op == "MAX":
            y = bottoms[0]
            for b in bottoms[1:]:
                y = torch.maximum(y, b)
        else:
            raise ValueError(f"unknown eltwise op {op!r}")
        return [y]


@register_layer("Reduction")
class ReductionLayer(LayerImpl):
    """SUM, ASUM, SUMSQ or MEAN over the axes from ``axis`` on, times
    ``coeff`` (reduction_layer.cpp)."""

    def out_shapes(self, lp, bottom_shapes):
        axis = _canon_axis(int(lp.sub("reduction_param").get("axis", 0)),
                           len(bottom_shapes[0]))
        return [tuple(bottom_shapes[0][:axis])]

    def apply(self, lp, params, bottoms, train, gen=None):
        p = lp.sub("reduction_param")
        op = str(p.get("operation", "SUM"))
        x = bottoms[0]
        axes = tuple(range(_canon_axis(int(p.get("axis", 0)), x.dim()),
                           x.dim()))
        terms = {"SUM": lambda: x, "ASUM": lambda: x.abs(),
                 "SUMSQ": lambda: x * x, "MEAN": lambda: x}
        if op not in terms:
            raise ValueError(f"unknown reduction op {op!r}")
        # an empty dim tuple would reduce every axis in torch
        y = terms[op]()
        if axes:
            y = y.mean(axes) if op == "MEAN" else y.sum(axes)
        return [float(p.get("coeff", 1.0)) * y]


@register_layer("Tile")
class TileLayer(LayerImpl):
    """Repeat the blob ``tiles`` times along ``axis`` (tile_layer.cpp)."""

    def _geom(self, lp, ndim):
        p = lp.sub("tile_param")
        return _canon_axis(int(p.get("axis", 1)), ndim), int(p.get("tiles", 1))

    def out_shapes(self, lp, bottom_shapes):
        axis, tiles = self._geom(lp, len(bottom_shapes[0]))
        s = list(bottom_shapes[0])
        s[axis] *= tiles
        return [tuple(s)]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        axis, tiles = self._geom(lp, x.dim())
        reps = [1] * x.dim()
        reps[axis] = tiles
        return [x.repeat(reps)]


@register_layer("BatchReindex")
class BatchReindexLayer(LayerImpl):
    """Gather items of the batch by the index bottom
    (batch_reindex_layer.cpp); autograd sums the gradient of an item
    picked twice."""

    def min_bottoms(self) -> int:
        return 2

    def out_shapes(self, lp, bottom_shapes):
        return [tuple(bottom_shapes[1][:1]) + tuple(bottom_shapes[0][1:])]

    def apply(self, lp, params, bottoms, train, gen=None):
        return [_take(bottoms[0], bottoms[1])]


@register_layer("Filter")
class FilterLayer(LayerImpl):
    """The items of the batch whose selector (the last bottom) is nonzero
    (filter_layer.cpp).  The tops' batch dim depends on the data:
    ``torch.nonzero`` waits for the card, as the JAX layer runs only
    eagerly.  ``dynamic_batch`` marks the tops, so the graph refuses a
    consumer whose parameter shapes would depend on the batch."""

    dynamic_batch = True

    def min_bottoms(self) -> int:
        return 2

    def out_shapes(self, lp, bottom_shapes):
        # the batch dim is known only at run time: the declared shapes
        # are the bottoms'
        return [tuple(s) for s in bottom_shapes[:-1]]

    def apply(self, lp, params, bottoms, train, gen=None):
        idx = torch.nonzero(bottoms[-1].reshape(-1)).reshape(-1)
        return [b[idx] for b in bottoms[:-1]]


@register_layer("ArgMax")
class ArgMaxLayer(LayerImpl):
    """The ``top_k`` largest entries' indices, and with ``out_max_val``
    their values (argmax_layer.cpp): along ``axis``, else over each
    item's flattened entries as (N, 1 or 2, k).  A tie goes to the lower
    index, as ``jax.lax.top_k`` breaks it: a stable descending sort, since
    ``torch.topk`` on the card promises no order among equals.  The
    indices come out in the input's dtype."""

    def _geom(self, lp):
        p = lp.sub("argmax_param")
        return (bool(p.get("out_max_val", False)), int(p.get("top_k", 1)),
                p.get("axis"))

    def out_shapes(self, lp, bottom_shapes):
        out_max_val, top_k, axis = self._geom(lp)
        s = bottom_shapes[0]
        if axis is not None:
            out = list(s)
            out[_canon_axis(int(axis), len(s))] = top_k
            return [tuple(out)]
        return [(s[0], 2 if out_max_val else 1, top_k)]

    @staticmethod
    def top_k(x: torch.Tensor, k: int):
        vals, idxs = torch.sort(x, dim=-1, descending=True, stable=True)
        return vals[..., :k], idxs[..., :k]

    def apply(self, lp, params, bottoms, train, gen=None):
        out_max_val, top_k, axis = self._geom(lp)
        x = bottoms[0]
        if axis is not None:
            axis = _canon_axis(int(axis), x.dim())
            vals, idxs = self.top_k(x.movedim(axis, -1), top_k)
            pick = vals if out_max_val else idxs.to(x.dtype)
            return [pick.movedim(-1, axis)]
        vals, idxs = self.top_k(x.reshape(x.shape[0], -1), top_k)
        idxs = idxs.to(x.dtype)
        if out_max_val:
            return [torch.stack([idxs, vals], dim=1)]
        return [idxs[:, None, :]]


@register_layer("Silence")
class SilenceLayer(LayerImpl):
    """Takes its bottoms and makes nothing (silence_layer.cpp)."""

    def out_shapes(self, lp, bottom_shapes):
        return []

    def apply(self, lp, params, bottoms, train, gen=None):
        return []
