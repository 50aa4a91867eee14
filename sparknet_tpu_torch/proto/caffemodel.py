"""Weights and solver state in Caffe's binary formats.

The port's own copy of ``sparknet_tpu/proto/caffemodel.py``, the
persistence surface of the reference:

- ``.caffemodel`` model weights: a binary ``NetParameter`` whose layers
  carry ``BlobProto`` weight blobs (reference: caffe/src/caffe/net.cpp:
  805-848 CopyTrainedLayersFrom / ToProto; util/io.cpp
  ReadNetParamsFromBinaryFileOrDie), V1-format files of the BVLC model zoo
  included (``layers``, enum types; upgrade_proto.cpp semantics);
- ``mean.binaryproto`` mean images: a single ``BlobProto`` (reference:
  caffe/tools/compute_image_mean.cpp, data_transformer.cpp:19-31);
- ``.solverstate`` solver snapshots: ``SolverState`` {iter, current_step,
  learned_net, history blobs} (reference: caffe/src/caffe/solver.cpp:
  447-530, sgd_solver.cpp SnapshotSolverState/RestoreSolverState:242-296).

Everything goes through :mod:`wireformat`'s ``PMessage`` codec.  Blobs
are read as f32 numpy arrays (read-only views of the file's bytes) and
written from numpy arrays or tensors on any device.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from .caffe_pb import NetParameter, blob_to_array
from .textformat import PMessage
from .wireformat import decode, encode


def _host(b: Any) -> np.ndarray:
    """A blob as an f32 numpy array on the host."""
    if isinstance(b, torch.Tensor):
        b = b.detach().to("cpu", torch.float32).numpy()
    return np.asarray(b, np.float32)


def array_to_blob(arr: Any) -> PMessage:
    """Array -> BlobProto with a new-style shape and packed float data
    (Blob::ToProto, reference: caffe/src/caffe/blob.cpp)."""
    arr = _host(arr)
    m = PMessage()
    shape = PMessage()
    shape.add("dim", np.asarray(arr.shape, np.int64))
    m.add("shape", shape)
    m.add("data", arr.ravel())
    return m


def _read_bytes(path_or_bytes: str | bytes) -> bytes:
    if isinstance(path_or_bytes, str):
        with open(path_or_bytes, "rb") as f:
            return f.read()
    return path_or_bytes


# ---------------------------------------------------------------------------
# NetParameter (with weights) read/write
# ---------------------------------------------------------------------------

def load_net_binaryproto(path_or_bytes: str | bytes) -> NetParameter:
    """Read a binary NetParameter (e.g. a ``.caffemodel``) into the typed
    view; each layer's weight blobs land on ``LayerParameter.blobs`` as
    numpy arrays.  Takes new-style ``layer`` and V1 ``layers`` entries
    (reference: util/upgrade_proto.cpp UpgradeV1Net)."""
    return NetParameter.from_pmsg(decode(_read_bytes(path_or_bytes),
                                         "NetParameter"))


def load_caffemodel(path_or_bytes: str | bytes
                    ) -> dict[str, list[np.ndarray]]:
    """Read a ``.caffemodel`` as ``{layer name: [weight arrays]}``, the
    payload of Net::CopyTrainedLayersFromBinaryProto (reference:
    net.cpp:805-842); layers without blobs are left out."""
    net = load_net_binaryproto(path_or_bytes)
    return {lp.name: list(lp.blobs) for lp in net.layer if lp.blobs}


def save_caffemodel(path: str, params: Mapping[str, Iterable[Any]],
                    net_param: NetParameter | None = None,
                    name: str = "") -> None:
    """Write ``{layer name: [blobs]}`` as a new-style binary NetParameter
    (Net::ToProto -> WriteProtoToBinaryFile; reference: net.cpp ToProto,
    solver.cpp:447-459 Snapshot).  With ``net_param``, layer *types* are
    carried over, so readers that dispatch on type (Caffe itself
    included) see a well-formed net."""
    types = {}
    if net_param is not None:
        types = {lp.name: lp.type for lp in net_param.layer}
        name = name or net_param.name
    msg = PMessage()
    if name:
        msg.add("name", name)
    for lname, blobs in params.items():
        lmsg = PMessage()
        lmsg.add("name", lname)
        if lname in types:
            lmsg.add("type", types[lname])
        for b in blobs:
            lmsg.add("blobs", array_to_blob(b))
        msg.add("layer", lmsg)
    with open(path, "wb") as f:
        f.write(encode(msg, "NetParameter"))


# ---------------------------------------------------------------------------
# Mean image binaryproto (compute_image_mean / DataTransformer mean_file)
# ---------------------------------------------------------------------------

def load_mean_binaryproto(path: str) -> np.ndarray:
    """Read a mean-image BlobProto -> (C, H, W) float32 (reference:
    data_transformer.cpp:19-31 mean_file path)."""
    with open(path, "rb") as f:
        arr = blob_to_array(decode(f.read(), "BlobProto"))
    return (np.squeeze(arr, axis=0) if arr.ndim == 4 and arr.shape[0] == 1
            else arr)


def save_mean_binaryproto(path: str, mean: Any) -> None:
    """Write a (C, H, W) mean image as a legacy-shaped BlobProto, as
    compute_image_mean does (reference: caffe/tools/compute_image_mean.cpp)."""
    mean = _host(mean)
    if mean.ndim == 3:
        mean = mean[None]
    m = PMessage()
    for k, v in zip(("num", "channels", "height", "width"), mean.shape):
        m.add(k, int(v))
    m.add("data", mean.ravel())
    with open(path, "wb") as f:
        f.write(encode(m, "BlobProto"))


# ---------------------------------------------------------------------------
# SolverState
# ---------------------------------------------------------------------------

def save_solverstate(path: str, iter_: int, history: Iterable[Any],
                     learned_net: str = "", current_step: int = 0) -> None:
    """Write a ``.solverstate`` (SGDSolver::SnapshotSolverStateToBinaryProto,
    reference: sgd_solver.cpp:242-262): iter, current_step, the
    learned_net file name and the history blobs in learnable-param
    order."""
    m = PMessage()
    m.add("iter", int(iter_))
    if learned_net:
        m.add("learned_net", learned_net)
    m.add("current_step", int(current_step))
    for h in history:
        m.add("history", array_to_blob(h))
    with open(path, "wb") as f:
        f.write(encode(m, "SolverState"))


def load_solverstate(path: str) -> dict[str, Any]:
    """Read a ``.solverstate`` -> {iter, current_step, learned_net,
    history: [ndarray]} (SGDSolver::RestoreSolverStateFromBinaryProto,
    reference: sgd_solver.cpp:280-296)."""
    with open(path, "rb") as f:
        m = decode(f.read(), "SolverState")
    return {
        "iter": int(m.get("iter", 0)),
        "current_step": int(m.get("current_step", 0)),
        "learned_net": str(m.get("learned_net", "")),
        "history": [blob_to_array(b) for b in m.get_all("history")],
    }
