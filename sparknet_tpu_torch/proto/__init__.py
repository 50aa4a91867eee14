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
    SolverParameter,
    load_net_prototxt,
    load_solver_prototxt,
    load_solver_prototxt_with_net,
)
