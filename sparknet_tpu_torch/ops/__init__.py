from .registry import (LayerImpl, get_layer_impl, register_layer,
                       registered_types)
from . import common, data, loss, neuron, vision  # noqa: F401  (register ops)
from .python_layer import register_python_layer
