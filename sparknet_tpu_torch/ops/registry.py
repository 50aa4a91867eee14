"""Layer registry — string type -> implementation.

Mirrors ``sparknet_tpu/ops/registry.py`` (Caffe's ``LayerRegistry``,
reference: caffe/include/caffe/layer_factory.hpp:55-136): an implementation
is a stateless object with shape inference, parameter initialization and a
forward on tensors.  Blobs keep the JAX package's layouts, so weights move
between the packages unchanged.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..proto.caffe_pb import LayerParameter

Shape = tuple[int, ...]


class LayerImpl:
    """Base layer implementation.

    Subclasses override:
      - ``out_shapes(lp, bottom_shapes)``: infer top shapes (Python ints,
        at graph-build time).
      - ``param_shapes(lp, bottom_shapes)``: shapes of the learnable blobs.
      - ``init(gen, lp, bottom_shapes)``: create the learnable blobs as f32
        CPU tensors drawn from ``gen``, mirroring each Caffe layer's
        ``LayerSetUp`` filler logic.
      - ``apply(lp, params, bottoms, train, gen)``: forward compute;
        returns the list of top tensors.  ``gen`` is the CPU
        ``torch.Generator`` a stochastic layer (train-mode Dropout) draws
        from, None elsewhere.
    """

    type: str = ""

    def out_shapes(self, lp: LayerParameter,
                   bottom_shapes: Sequence[Shape]) -> list[Shape]:
        return [tuple(bottom_shapes[0])]

    def param_shapes(self, lp: LayerParameter,
                     bottom_shapes: Sequence[Shape]) -> list[Shape]:
        return []

    def init(self, gen: torch.Generator, lp: LayerParameter,
             bottom_shapes: Sequence[Shape]) -> list[torch.Tensor]:
        return []

    def apply(self, lp: LayerParameter, params: Sequence[torch.Tensor],
              bottoms: Sequence[torch.Tensor], train: bool,
              gen: torch.Generator | None = None) -> list[torch.Tensor]:
        raise NotImplementedError(self.type)

    def is_loss(self) -> bool:
        """Whether top[0] carries an implicit loss_weight of 1
        (Caffe: Layer::SetUp assigns loss weight to *Loss layers)."""
        return self.type.endswith("Loss")

    def is_input(self) -> bool:
        """Whether the tops are host-fed graph inputs."""
        return False


_REGISTRY: dict[str, LayerImpl] = {}


def register_layer(type_name: str) -> Callable[[type], type]:
    def deco(cls: type) -> type:
        impl = cls()
        impl.type = type_name
        if type_name in _REGISTRY:
            raise ValueError(f"layer type {type_name!r} registered twice")
        _REGISTRY[type_name] = impl
        return cls
    return deco


def get_layer_impl(type_name: str) -> LayerImpl:
    try:
        return _REGISTRY[type_name]
    except KeyError:
        raise KeyError(
            f"Unknown layer type: {type_name!r} (the port implements "
            f"{sorted(_REGISTRY)})") from None
