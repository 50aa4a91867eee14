from .textformat import ParseError, PMessage, parse
from .caffe_pb import (
    BlobShape,
    FillerParameter,
    LayerParameter,
    NetParameter,
    NetState,
    NetStateRule,
    ParamSpec,
    Phase,
    load_net_prototxt,
)
