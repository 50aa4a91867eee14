"""Input layers: host-fed graph inputs with declared shapes.

Counterparts of ``JavaData`` and ``Input`` in ``sparknet_tpu/ops/data.py``
(reference: java_data_layer.cpp, caffe InputLayer).  Their tops are bound
by the caller of ``Net.apply``; they compute nothing.
"""

from __future__ import annotations

from ..proto.caffe_pb import BlobShape
from .registry import LayerImpl, register_layer


class InputLikeLayer(LayerImpl):
    def is_input(self) -> bool:
        return True

    def apply(self, lp, params, bottoms, train, gen=None):
        raise RuntimeError(
            f"input layer {lp.name!r} must be fed by the caller, not applied")


@register_layer("JavaData")
class JavaDataLayer(InputLikeLayer):
    def out_shapes(self, lp, bottom_shapes):
        p = lp.sub("java_data_param")
        if p.get("shape") is None:
            raise ValueError(f"JavaData layer {lp.name!r} missing shape")
        shapes = [tuple(BlobShape.from_pmsg(p.get("shape")).dim)]
        if len(lp.top) > 1:
            label = p.get("label_shape")
            shapes.append(tuple(BlobShape.from_pmsg(label).dim)
                          if label is not None else (shapes[0][0],))
        return shapes


@register_layer("Input")
class InputLayer(InputLikeLayer):
    def out_shapes(self, lp, bottom_shapes):
        shapes = [tuple(BlobShape.from_pmsg(s).dim)
                  for s in lp.sub("input_param").get_all("shape")]
        if not shapes:
            raise ValueError(
                f"Input layer {lp.name!r} missing input_param.shape")
        if len(shapes) == 1 and len(lp.top) > 1:
            shapes = shapes * len(lp.top)
        return shapes
