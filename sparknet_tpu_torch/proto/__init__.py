from .textformat import ParseError, PMessage, parse
from .wireformat import WireError, decode as decode_wire, encode as encode_wire
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
    blob_to_array,
    load_net_prototxt,
    load_solver_prototxt,
    load_solver_prototxt_with_net,
    resolve_net_path,
    resolve_solver_nets,
)
from .caffemodel import (
    array_to_blob,
    load_caffemodel,
    load_mean_binaryproto,
    load_net_binaryproto,
    load_solverstate,
    save_caffemodel,
    save_mean_binaryproto,
    save_solverstate,
)
