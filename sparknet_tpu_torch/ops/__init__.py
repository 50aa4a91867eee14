from .registry import LayerImpl, get_layer_impl, register_layer
from . import common, data, loss, neuron, vision  # noqa: F401  (register ops)
