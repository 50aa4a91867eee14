"""Typed views over parsed prototxt and binary protobuf for the Caffe net
and solver schema.

The port's own copy of part of ``sparknet_tpu/proto/caffe_pb.py``:
``NetParameter``, ``LayerParameter`` (with the weight ``blobs`` a
``.caffemodel`` carries, ``blob_to_array``), ``NetState``/``NetStateRule``,
``Phase``, ``ParamSpec``, ``FillerParameter``, ``BlobShape`` and
``SolverParameter`` with every field the solver, its test nets and its
snapshots read, plus ``resolve_net_path``/``resolve_solver_nets``.  Nets
are read new-style (V2, ``layer``) or V1 (``layers`` with enum types and
``blobs_lr``/``weight_decay``, the format of every BVLC zoo
``.caffemodel``), upgraded as upgrade_proto.cpp ``UpgradeV1Net`` does,
or V0 (a ``layer`` nested in each ``layers`` entry, explicit ``padding``
layers, a bare ``input_dim``), upgraded to V1 first as
``UpgradeV0Net`` does.  ``to_pmsg``/``save_net_prototxt`` write a net
back as V2 text and ``replace_data_layers`` swaps its data layers for
host-fed inputs.  Per-layer parameter sub-messages stay as ``PMessage``
and are read with defaulting accessors by the op implementations
(reference: caffe.proto:64 NetParameter, :102 SolverParameter, :310
LayerParameter).
"""

from __future__ import annotations

import dataclasses
import enum
import math
import os
from typing import Any, Sequence

import numpy as np

from .textformat import EnumToken, PMessage, parse, serialize


class Phase(enum.IntEnum):
    TRAIN = 0
    TEST = 1


def blob_to_array(m: PMessage) -> np.ndarray:
    """BlobProto -> f32 ndarray (Blob::FromProto shape rules, reference:
    caffe/src/caffe/blob.cpp): ``shape`` if present, else the legacy
    num/channels/height/width.  Data arrive as packed numpy chunks (binary
    decode; one chunk stays a view of the file's bytes) or scalar floats
    (text parse)."""
    def flat_of(key: str):
        chunks = [np.atleast_1d(np.asarray(c)) for c in m.get_all(key)]
        if not chunks:
            return None
        flat = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        return flat.astype(np.float32, copy=False)

    flat = flat_of("data")
    if flat is None:
        flat = flat_of("double_data")
    if flat is None:
        flat = np.zeros((0,), np.float32)
    shape_msg = m.get("shape")
    if isinstance(shape_msg, PMessage):
        shape = tuple(BlobShape.from_pmsg(shape_msg).dim)
    else:
        legacy = [int(m.get(k, 0))
                  for k in ("num", "channels", "height", "width")]
        shape = tuple(legacy) if any(legacy) else (flat.size,)
    if math.prod(shape) != flat.size:
        raise ValueError(
            f"BlobProto count {flat.size} != shape {shape} product")
    return flat.reshape(shape)


def _phase_of(v: Any) -> Phase | None:
    if v is None:
        return None
    if isinstance(v, Phase):
        return v
    if isinstance(v, str):
        return Phase[v]
    return Phase(int(v))


@dataclasses.dataclass
class BlobShape:
    dim: list[int]

    @classmethod
    def from_pmsg(cls, m: PMessage) -> "BlobShape":
        dims: list[int] = []
        for d in m.get_all("dim"):
            # binary decode yields packed numpy vectors; text yields scalars
            dims.extend(int(x) for x in np.atleast_1d(np.asarray(d)))
        return cls(dim=dims)

    def to_pmsg(self) -> PMessage:
        m = PMessage()
        for d in self.dim:
            m.add("dim", int(d))
        return m


@dataclasses.dataclass
class FillerParameter:
    """Weight-init config (reference: caffe/include/caffe/filler.hpp:31-146)."""

    type: str = "constant"
    value: float = 0.0
    min: float = 0.0
    max: float = 1.0
    mean: float = 0.0
    std: float = 1.0
    variance_norm: str = "FAN_IN"  # FAN_IN | FAN_OUT | AVERAGE
    # read but not applied: the gaussian filler stays dense, as in the
    # JAX package (ROADMAP C, known differences)
    sparse: int = -1

    @classmethod
    def from_pmsg(cls, m: PMessage | None) -> "FillerParameter":
        if m is None:
            return cls()
        return cls(
            type=str(m.get("type", "constant")),
            value=float(m.get("value", 0.0)),
            min=float(m.get("min", 0.0)),
            max=float(m.get("max", 1.0)),
            mean=float(m.get("mean", 0.0)),
            std=float(m.get("std", 1.0)),
            variance_norm=str(m.get("variance_norm", "FAN_IN")),
            sparse=int(m.get("sparse", -1)),
        )


@dataclasses.dataclass
class NetState:
    phase: Phase = Phase.TEST
    level: int = 0
    stage: list[str] = dataclasses.field(default_factory=list)

    @classmethod
    def from_pmsg(cls, m: PMessage | None) -> "NetState":
        if m is None:
            return cls()
        return cls(
            phase=_phase_of(m.get("phase")) or Phase.TEST,
            level=int(m.get("level", 0)),
            stage=[str(s) for s in m.get_all("stage")],
        )

    def to_pmsg(self) -> PMessage:
        m = PMessage()
        m.add("phase", EnumToken(self.phase.name))
        if self.level:
            m.add("level", int(self.level))
        for s in self.stage:
            m.add("stage", s)
        return m


@dataclasses.dataclass
class NetStateRule:
    """Phase/level/stage inclusion rule (reference: caffe.proto:263)."""

    phase: Phase | None = None
    min_level: int | None = None
    max_level: int | None = None
    stage: list[str] = dataclasses.field(default_factory=list)
    not_stage: list[str] = dataclasses.field(default_factory=list)

    @classmethod
    def from_pmsg(cls, m: PMessage) -> "NetStateRule":
        return cls(
            phase=_phase_of(m.get("phase")),
            min_level=m.get("min_level"),
            max_level=m.get("max_level"),
            stage=[str(s) for s in m.get_all("stage")],
            not_stage=[str(s) for s in m.get_all("not_stage")],
        )

    def to_pmsg(self) -> PMessage:
        m = PMessage()
        if self.phase is not None:
            m.add("phase", EnumToken(self.phase.name))
        if self.min_level is not None:
            m.add("min_level", int(self.min_level))
        if self.max_level is not None:
            m.add("max_level", int(self.max_level))
        for s in self.stage:
            m.add("stage", s)
        for s in self.not_stage:
            m.add("not_stage", s)
        return m

    def matches(self, state: NetState) -> bool:
        """Mirror of Net::StateMeetsRule (reference: caffe/src/caffe/net.cpp:287-329)."""
        if self.phase is not None and self.phase != state.phase:
            return False
        if self.min_level is not None and state.level < int(self.min_level):
            return False
        if self.max_level is not None and state.level > int(self.max_level):
            return False
        if any(s not in state.stage for s in self.stage):
            return False
        return not any(s in state.stage for s in self.not_stage)


@dataclasses.dataclass
class ParamSpec:
    """Per-learnable-blob training config (lr_mult/decay_mult).  The raw_*
    fields keep proto2 presence (has_lr_mult), which param sharing needs."""

    name: str | None = None
    lr_mult: float = 1.0
    decay_mult: float = 1.0
    raw_lr_mult: float | None = None
    raw_decay_mult: float | None = None

    @classmethod
    def from_pmsg(cls, m: PMessage) -> "ParamSpec":
        raw_lr = m.get("lr_mult")
        raw_decay = m.get("decay_mult")
        return cls(
            name=m.get("name"),
            lr_mult=float(raw_lr) if raw_lr is not None else 1.0,
            decay_mult=float(raw_decay) if raw_decay is not None else 1.0,
            raw_lr_mult=float(raw_lr) if raw_lr is not None else None,
            raw_decay_mult=float(raw_decay) if raw_decay is not None else None,
        )


# V1LayerParameter enum type names -> V2 string type names
# (reference: caffe/src/caffe/util/upgrade_proto.cpp UpgradeV1LayerType)
_V1_TYPE_MAP = {
    "ABSVAL": "AbsVal", "ACCURACY": "Accuracy", "ARGMAX": "ArgMax",
    "BNLL": "BNLL", "CONCAT": "Concat", "CONTRASTIVE_LOSS": "ContrastiveLoss",
    "CONVOLUTION": "Convolution", "DECONVOLUTION": "Deconvolution",
    "DATA": "Data", "DROPOUT": "Dropout", "DUMMY_DATA": "DummyData",
    "EUCLIDEAN_LOSS": "EuclideanLoss", "ELTWISE": "Eltwise", "EXP": "Exp",
    "FLATTEN": "Flatten", "HDF5_DATA": "HDF5Data", "HDF5_OUTPUT": "HDF5Output",
    "HINGE_LOSS": "HingeLoss", "IM2COL": "Im2col", "IMAGE_DATA": "ImageData",
    "INFOGAIN_LOSS": "InfogainLoss", "INNER_PRODUCT": "InnerProduct",
    "LRN": "LRN", "MEMORY_DATA": "MemoryData",
    "MULTINOMIAL_LOGISTIC_LOSS": "MultinomialLogisticLoss", "MVN": "MVN",
    "POOLING": "Pooling", "POWER": "Power", "RELU": "ReLU",
    "SIGMOID": "Sigmoid",
    "SIGMOID_CROSS_ENTROPY_LOSS": "SigmoidCrossEntropyLoss",
    "SILENCE": "Silence", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "SPLIT": "Split", "SLICE": "Slice",
    "TANH": "TanH", "WINDOW_DATA": "WindowData", "THRESHOLD": "Threshold",
}

_PARAM_SUBMSG_KEYS = (
    "transform_param", "loss_param", "accuracy_param", "argmax_param",
    "batch_norm_param", "bias_param", "concat_param", "contrastive_loss_param",
    "convolution_param", "data_param", "dropout_param", "dummy_data_param",
    "eltwise_param", "embed_param", "exp_param", "flatten_param",
    "hdf5_data_param", "hdf5_output_param", "hinge_loss_param",
    "image_data_param", "infogain_loss_param", "inner_product_param",
    "input_param", "log_param", "lrn_param", "memory_data_param", "mvn_param",
    "pooling_param", "power_param", "prelu_param", "python_param",
    "reduction_param", "relu_param", "reshape_param", "scale_param",
    "sigmoid_param", "softmax_param", "spp_param", "slice_param",
    "tanh_param", "threshold_param", "tile_param", "window_data_param",
    "java_data_param",
)

_DATA_PARAM_OF = {"Data": "data_param", "ImageData": "image_data_param",
                  "WindowData": "window_data_param"}


def _upgrade_data_transform(lp: "LayerParameter") -> None:
    """Move old-style scale/mean_file/crop_size/mirror fields out of
    data_param and friends into transform_param (upgrade_proto.cpp
    UpgradeNetDataTransformation)."""
    pkey = _DATA_PARAM_OF.get(lp.type)
    if pkey is None or pkey not in lp.params:
        return
    p = lp.params[pkey]
    moved = {k: p.get(k) for k in ("scale", "mean_file", "crop_size",
                                   "mirror") if p.has(k)}
    if not moved:
        return
    tp = lp.params.setdefault("transform_param", PMessage())
    for k, v in moved.items():
        if not tp.has(k):
            tp.add(k, v)
        p.clear(k)


# V0 lowercase type names -> V1 enum names
# (reference: caffe/src/caffe/util/upgrade_proto.cpp UpgradeV0LayerType)
_V0_TYPE_MAP = {
    "accuracy": "ACCURACY", "bnll": "BNLL", "concat": "CONCAT",
    "conv": "CONVOLUTION", "data": "DATA", "dropout": "DROPOUT",
    "euclidean_loss": "EUCLIDEAN_LOSS", "flatten": "FLATTEN",
    "hdf5_data": "HDF5_DATA", "hdf5_output": "HDF5_OUTPUT",
    "im2col": "IM2COL", "images": "IMAGE_DATA",
    "infogain_loss": "INFOGAIN_LOSS", "innerproduct": "INNER_PRODUCT",
    "lrn": "LRN", "multinomial_logistic_loss": "MULTINOMIAL_LOGISTIC_LOSS",
    "pool": "POOLING", "relu": "RELU", "sigmoid": "SIGMOID",
    "softmax": "SOFTMAX", "softmax_loss": "SOFTMAX_LOSS", "split": "SPLIT",
    "tanh": "TANH", "window_data": "WINDOW_DATA", "padding": "PADDING",
}


def _net_needs_v0_upgrade(m: PMessage) -> bool:
    """V0 nets nest a V0LayerParameter inside each ``layers`` entry
    (upgrade_proto.cpp NetNeedsV0ToV1Upgrade)."""
    return any(isinstance(l, PMessage) and l.has("layer")
               for l in m.get_all("layers"))


def _upgrade_v0_padding(entries: list[PMessage]) -> list[PMessage]:
    """Fold explicit ``padding`` layers into the conv/pool layer that
    consumes them (upgrade_proto.cpp UpgradeV0PaddingLayers)."""
    top_src: dict[str, PMessage] = {}
    out: list[PMessage] = []
    for entry in entries:
        v0 = entry.get("layer")
        if v0 is not None and str(v0.get("type", "")) == "padding":
            for t in entry.get_all("top"):
                top_src[str(t)] = entry
            continue
        for i, b in enumerate(entry.get_all("bottom")):
            pad_entry = top_src.get(str(b))
            if pad_entry is None:
                continue
            pv0 = pad_entry.get("layer")
            if v0 is None or str(v0.get("type", "")) not in ("conv", "pool"):
                who = str(v0.get("name", "?")) if v0 is not None else "?"
                raise ValueError(
                    f"padding layer feeds non-conv/pool layer {who!r} "
                    "(undefined in Caffe; upgrade_proto.cpp CHECK)")
            v0.set("pad", pv0.get("pad", 0))
            bots = entry.get_all("bottom")
            bots[i] = pad_entry.get("bottom")
            entry.clear("bottom")
            for b2 in bots:
                entry.add("bottom", b2)
        for t in entry.get_all("top"):
            top_src.pop(str(t), None)
        out.append(entry)
    return out


def _upgrade_v0_layer(entry: PMessage) -> PMessage:
    """One V0 ``layers`` entry -> a V1-style flat PMessage
    (upgrade_proto.cpp UpgradeV0LayerParameter)."""
    v0 = entry.get("layer")
    out = PMessage()
    for b in entry.get_all("bottom"):
        out.add("bottom", b)
    for t in entry.get_all("top"):
        out.add("top", t)
    if v0 is None:
        return out
    type_ = str(v0.get("type", ""))
    if v0.has("name"):
        out.add("name", v0.get("name"))
    out.add("type", _V0_TYPE_MAP.get(type_, type_))
    for key in ("blobs", "blobs_lr", "weight_decay"):
        for val in v0.get_all(key):
            out.add(key, val)

    subs: dict[str, PMessage] = {}

    def move(v0_key: str, sub_name: str, new_key: str | None = None) -> None:
        if v0.has(v0_key):
            subs.setdefault(sub_name, PMessage()).add(new_key or v0_key,
                                                     v0.get(v0_key))

    # (V0 type, V1 sub-message, [(V0 field, V1 field or None), ...])
    for v0_type, sub_name, fields in _V0_FIELDS:
        if type_ == v0_type:
            for v0_key, new_key in fields:
                move(v0_key, sub_name, new_key)
    # old-style transformation fields -> transform_param
    # (UpgradeNetDataTransformation)
    if type_ in ("data", "images", "window_data"):
        move("scale", "transform_param")
        move("meanfile", "transform_param", "mean_file")
        move("cropsize", "transform_param", "crop_size")
        move("mirror", "transform_param")
    for name, msg_ in subs.items():
        out.add(name, msg_)
    return out


_V0_FIELDS = [
    ("conv", "convolution_param", [
        ("num_output", None), ("biasterm", "bias_term"),
        ("weight_filler", None), ("bias_filler", None), ("pad", None),
        ("kernelsize", "kernel_size"), ("group", None), ("stride", None)]),
    ("innerproduct", "inner_product_param", [
        ("num_output", None), ("biasterm", "bias_term"),
        ("weight_filler", None), ("bias_filler", None)]),
    ("pool", "pooling_param", [
        ("pad", None), ("kernelsize", "kernel_size"), ("stride", None),
        ("pool", None)]),
    ("dropout", "dropout_param", [("dropout_ratio", None)]),
    ("lrn", "lrn_param", [("local_size", None), ("alpha", None),
                          ("beta", None), ("k", None)]),
    ("data", "data_param", [("source", None), ("batchsize", "batch_size"),
                            ("rand_skip", None)]),
    ("hdf5_data", "hdf5_data_param", [("source", None),
                                      ("batchsize", "batch_size")]),
    ("images", "image_data_param", [
        ("source", None), ("batchsize", "batch_size"), ("rand_skip", None),
        ("shuffle_images", "shuffle"), ("new_height", None),
        ("new_width", None)]),
    ("window_data", "window_data_param", [
        ("source", None), ("batchsize", "batch_size"),
        ("det_fg_threshold", "fg_threshold"),
        ("det_bg_threshold", "bg_threshold"),
        ("det_fg_fraction", "fg_fraction"),
        ("det_context_pad", "context_pad"),
        ("det_crop_mode", "crop_mode")]),
    ("infogain_loss", "infogain_loss_param", [("source", None)]),
    ("concat", "concat_param", [("concat_dim", None)]),
]


@dataclasses.dataclass
class LayerParameter:
    """One layer of the net graph (reference: caffe.proto:310)."""

    name: str = ""
    type: str = ""
    bottom: list[str] = dataclasses.field(default_factory=list)
    top: list[str] = dataclasses.field(default_factory=list)
    phase: Phase | None = None
    loss_weight: list[float] = dataclasses.field(default_factory=list)
    param: list[ParamSpec] = dataclasses.field(default_factory=list)
    include: list[NetStateRule] = dataclasses.field(default_factory=list)
    exclude: list[NetStateRule] = dataclasses.field(default_factory=list)
    propagate_down: list[bool] = dataclasses.field(default_factory=list)
    # type-specific sub-configs, kept schema-free:
    params: dict[str, PMessage] = dataclasses.field(default_factory=dict)
    # trained weight blobs, present when read from a .caffemodel
    # (reference: caffe.proto LayerParameter.blobs=7, V1LayerParameter.blobs=6)
    blobs: list[np.ndarray] = dataclasses.field(default_factory=list)

    @classmethod
    def from_pmsg(cls, m: PMessage, v1: bool = False) -> "LayerParameter":
        """``v1``: ``m`` is a V1LayerParameter (a ``layers`` entry): its
        enum type becomes the V2 name and its ``blobs_lr``/``weight_decay``
        lists become ``ParamSpec``s (upgrade_proto.cpp UpgradeV1LayerParameter)."""
        type_ = m.get("type", "")
        if v1 and isinstance(type_, str) and type_ in _V1_TYPE_MAP:
            type_ = _V1_TYPE_MAP[type_]
        lp = cls(
            name=str(m.get("name", "")),
            type=str(type_),
            bottom=[str(b) for b in m.get_all("bottom")],
            top=[str(t) for t in m.get_all("top")],
            phase=_phase_of(m.get("phase")),
            loss_weight=[float(w) for w in m.get_all("loss_weight")],
            include=[NetStateRule.from_pmsg(r) for r in m.get_all("include")],
            exclude=[NetStateRule.from_pmsg(r) for r in m.get_all("exclude")],
            propagate_down=[bool(p) for p in m.get_all("propagate_down")],
        )
        pmsgs = [p for p in m.get_all("param") if isinstance(p, PMessage)]
        shared_names = [p for p in m.get_all("param") if isinstance(p, str)]
        if pmsgs:
            lp.param = [ParamSpec.from_pmsg(p) for p in pmsgs]
        elif v1 and (m.has("blobs_lr") or m.has("weight_decay")
                     or shared_names):
            lrs = [float(x) for x in m.get_all("blobs_lr")]
            wds = [float(x) for x in m.get_all("weight_decay")]
            for i in range(max(len(lrs), len(wds), len(shared_names))):
                # V1 blobs_lr/weight_decay are explicit settings: presence
                # is kept, as param sharing's merge reads it
                lr = lrs[i] if i < len(lrs) else None
                wd = wds[i] if i < len(wds) else None
                lp.param.append(ParamSpec(
                    name=shared_names[i] if i < len(shared_names) else None,
                    lr_mult=1.0 if lr is None else lr,
                    decay_mult=1.0 if wd is None else wd,
                    raw_lr_mult=lr, raw_decay_mult=wd))
        for key in _PARAM_SUBMSG_KEYS:
            sub = m.get(key)
            if isinstance(sub, PMessage):
                lp.params[key] = sub
        lp.blobs = [blob_to_array(b) for b in m.get_all("blobs")
                    if isinstance(b, PMessage)]
        return lp

    def sub(self, key: str) -> PMessage:
        """Type-specific sub-config, empty message if absent."""
        return self.params.get(key) or PMessage()

    def to_pmsg(self, include_blobs: bool = False) -> PMessage:
        """The layer as a new-style (V2) message, the write half of the
        prototxt round trip: unset multipliers stay unset."""
        m = PMessage()
        if self.name:
            m.add("name", self.name)
        if self.type:
            m.add("type", self.type)
        for b in self.bottom:
            m.add("bottom", b)
        for t in self.top:
            m.add("top", t)
        if self.phase is not None:
            m.add("phase", EnumToken(self.phase.name))
        for w in self.loss_weight:
            m.add("loss_weight", float(w))
        for ps in self.param:
            pm = PMessage()
            if ps.name:
                pm.add("name", ps.name)
            if ps.raw_lr_mult is not None:
                pm.add("lr_mult", ps.raw_lr_mult)
            if ps.raw_decay_mult is not None:
                pm.add("decay_mult", ps.raw_decay_mult)
            m.add("param", pm)
        for r in self.include:
            m.add("include", r.to_pmsg())
        for r in self.exclude:
            m.add("exclude", r.to_pmsg())
        for p in self.propagate_down:
            m.add("propagate_down", bool(p))
        for key, sub in self.params.items():
            m.add(key, sub)
        if include_blobs and self.blobs:
            from .caffemodel import array_to_blob
            for b in self.blobs:
                m.add("blobs", array_to_blob(np.asarray(b)))
        return m

    def included_in(self, state: NetState) -> bool:
        """Mirror of Net::FilterNet layer inclusion (reference: net.cpp:256-286):
        no rules -> included; include rules -> any match; exclude -> none
        match; plus the direct ``phase`` field the zoo's data layers use."""
        if self.phase is not None and self.phase != state.phase:
            return False
        if self.include:
            return any(r.matches(state) for r in self.include)
        return not any(r.matches(state) for r in self.exclude)


@dataclasses.dataclass
class NetParameter:
    """The model graph config (reference: caffe.proto:64)."""

    name: str = ""
    layer: list[LayerParameter] = dataclasses.field(default_factory=list)
    input: list[str] = dataclasses.field(default_factory=list)
    input_shape: list[BlobShape] = dataclasses.field(default_factory=list)
    state: NetState = dataclasses.field(default_factory=NetState)
    force_backward: bool = False

    @classmethod
    def from_pmsg(cls, m: PMessage) -> "NetParameter":
        """New-style ``layer`` entries, then V1 ``layers`` entries upgraded
        (upgrade_proto.cpp UpgradeV1Net), V0 entries first upgraded to V1
        (padding layers folded in, the nested layer flattened); old-style
        data transformation fields move into ``transform_param``, and a
        bare ``input_dim`` (4 ints an input) becomes ``input_shape``."""
        layers_v1 = m.get_all("layers")
        if _net_needs_v0_upgrade(m):
            layers_v1 = [_upgrade_v0_layer(e)
                         for e in _upgrade_v0_padding(list(layers_v1))]
        layer = [LayerParameter.from_pmsg(l) for l in m.get_all("layer")]
        layer += [LayerParameter.from_pmsg(l, v1=True) for l in layers_v1]
        for lp in layer:
            _upgrade_data_transform(lp)
        input_shape = [BlobShape.from_pmsg(s)
                       for s in m.get_all("input_shape")]
        input_dims = [int(d) for d in m.get_all("input_dim")]
        if input_dims and not input_shape:
            input_shape = [BlobShape(dim=input_dims[i:i + 4])
                           for i in range(0, len(input_dims), 4)]
        return cls(
            name=str(m.get("name", "")),
            layer=layer,
            input=[str(i) for i in m.get_all("input")],
            input_shape=input_shape,
            state=NetState.from_pmsg(m.get("state")),
            force_backward=bool(m.get("force_backward", False)),
        )

    def to_pmsg(self, include_blobs: bool = False) -> PMessage:
        """The net as a new-style (V2) message, always upgraded, as the
        reference's upgrade_net_proto_* tools write it."""
        m = PMessage()
        if self.name:
            m.add("name", self.name)
        for name in self.input:
            m.add("input", name)
        for s in self.input_shape:
            m.add("input_shape", s.to_pmsg())
        if self.force_backward:
            m.add("force_backward", True)
        if self.state != NetState():
            m.add("state", self.state.to_pmsg())
        for lp in self.layer:
            m.add("layer", lp.to_pmsg(include_blobs=include_blobs))
        return m

    def filtered(self, state: NetState) -> "NetParameter":
        """Phase-filtered copy — Net::FilterNet (reference: net.cpp:256)."""
        return dataclasses.replace(
            self, layer=[l for l in self.layer if l.included_in(state)],
            state=state)


@dataclasses.dataclass
class SolverParameter:
    """Training config (reference: caffe.proto:102), with the proto
    defaults (reference: caffe/src/caffe/solvers/sgd_solver.cpp,
    solver.cpp).  The net comes from ``net_param`` or ``train_net_param``
    (``net``/``train_net`` file references are resolved into them by
    :func:`resolve_solver_nets`); the test nets from ``test_net_param``
    (one per entry, ``test_net`` files resolved likewise), else the shared
    net in the TEST phase.  ``snapshot`` (an interval in iterations, 0 for
    none) and ``snapshot_prefix`` drive snapshots on schedule;
    ``snapshot_format`` is BINARYPROTO or HDF5."""

    net: str | None = None
    net_param: NetParameter | None = None
    train_net: str | None = None
    test_net: list[str] = dataclasses.field(default_factory=list)
    train_net_param: NetParameter | None = None
    test_net_param: list[NetParameter] = dataclasses.field(
        default_factory=list)
    train_state: NetState = dataclasses.field(
        default_factory=lambda: NetState(Phase.TRAIN))
    test_state: list[NetState] = dataclasses.field(default_factory=list)

    test_iter: list[int] = dataclasses.field(default_factory=list)
    test_interval: int = 0
    test_initialization: bool = True
    base_lr: float = 0.01
    display: int = 0
    average_loss: int = 1
    max_iter: int = 0
    iter_size: int = 1
    lr_policy: str = "fixed"
    gamma: float = 0.0
    power: float = 0.0
    momentum: float = 0.0
    weight_decay: float = 0.0
    regularization_type: str = "L2"
    stepsize: int = 0
    stepvalue: list[int] = dataclasses.field(default_factory=list)
    clip_gradients: float = -1.0
    snapshot: int = 0
    snapshot_prefix: str = ""
    random_seed: int = -1
    solver_type: str = "SGD"  # SGD|NESTEROV|ADAGRAD|RMSPROP|ADADELTA|ADAM
    delta: float = 1e-8
    momentum2: float = 0.999
    rms_decay: float = 0.99
    debug_info: bool = False
    snapshot_format: str = "BINARYPROTO"  # or HDF5 (caffe.proto:240-244)

    @classmethod
    def from_pmsg(cls, m: PMessage) -> "SolverParameter":
        def net_of(key: str) -> NetParameter | None:
            sub = m.get(key)
            return (NetParameter.from_pmsg(sub) if isinstance(sub, PMessage)
                    else None)

        sp = cls(
            net=m.get("net"),
            net_param=net_of("net_param"),
            train_net=m.get("train_net"),
            test_net=[str(t) for t in m.get_all("test_net")],
            train_net_param=net_of("train_net_param"),
            test_net_param=[NetParameter.from_pmsg(t)
                            for t in m.get_all("test_net_param")],
            test_iter=[int(t) for t in m.get_all("test_iter")],
            test_interval=int(m.get("test_interval", 0)),
            test_initialization=bool(m.get("test_initialization", True)),
            base_lr=float(m.get("base_lr", 0.01)),
            display=int(m.get("display", 0)),
            average_loss=int(m.get("average_loss", 1)),
            max_iter=int(m.get("max_iter", 0)),
            iter_size=int(m.get("iter_size", 1)),
            lr_policy=str(m.get("lr_policy", "fixed")),
            gamma=float(m.get("gamma", 0.0)),
            power=float(m.get("power", 0.0)),
            momentum=float(m.get("momentum", 0.0)),
            weight_decay=float(m.get("weight_decay", 0.0)),
            regularization_type=str(m.get("regularization_type", "L2")),
            stepsize=int(m.get("stepsize", 0)),
            stepvalue=[int(v) for v in m.get_all("stepvalue")],
            clip_gradients=float(m.get("clip_gradients", -1.0)),
            snapshot=int(m.get("snapshot", 0)),
            snapshot_prefix=str(m.get("snapshot_prefix", "")),
            random_seed=int(m.get("random_seed", -1)),
            solver_type=str(m.get("type", m.get("solver_type", "SGD"))
                            ).upper(),
            delta=float(m.get("delta", 1e-8)),
            momentum2=float(m.get("momentum2", 0.999)),
            rms_decay=float(m.get("rms_decay", 0.99)),
            debug_info=bool(m.get("debug_info", False)),
            snapshot_format=str(m.get("snapshot_format",
                                      "BINARYPROTO")).upper(),
        )
        if m.has("train_state"):
            sp.train_state = NetState.from_pmsg(m.get("train_state"))
            sp.train_state.phase = Phase.TRAIN
        for ts in m.get_all("test_state"):
            st = NetState.from_pmsg(ts)
            st.phase = Phase.TEST
            sp.test_state.append(st)
        return sp


def _read(path_or_text: str) -> str:
    """Literal prototxt text, or the contents of the file it names."""
    if "\n" in path_or_text or "{" in path_or_text:
        return path_or_text
    with open(path_or_text) as f:
        return f.read()


def load_net_prototxt(path_or_text: str) -> NetParameter:
    """Parse a net prototxt from a file path or literal text
    (ProtoLoader.loadNetPrototxt, reference: ProtoLoader.scala:20)."""
    return NetParameter.from_pmsg(parse(_read(path_or_text)))


def load_solver_prototxt(path_or_text: str) -> SolverParameter:
    """ProtoLoader.loadSolverPrototxt (reference: ProtoLoader.scala:9)."""
    return SolverParameter.from_pmsg(parse(_read(path_or_text)))


def load_solver_prototxt_with_net(solver_path_or_text: str,
                                  net: NetParameter,
                                  snapshot_prefix: str | None = None
                                  ) -> SolverParameter:
    """A solver config with ``net`` embedded as its net, snapshotting
    cleared unless a prefix is given (ProtoLoader.loadSolverPrototxtWithNet,
    reference: ProtoLoader.scala:31-43)."""
    sp = load_solver_prototxt(solver_path_or_text)
    sp.net = None
    sp.train_net = None
    sp.test_net = []
    sp.net_param = net
    sp.train_net_param = None
    if snapshot_prefix is None:
        sp.snapshot = 0
        sp.snapshot_prefix = ""
    else:
        sp.snapshot_prefix = snapshot_prefix
    return sp


def save_net_prototxt(net: NetParameter, path_or_none: str | None = None
                      ) -> str:
    """``net`` as prototxt text, also written to ``path_or_none`` when
    given (the write half of the ProtoLoader round trip)."""
    text = serialize(net.to_pmsg())
    if path_or_none:
        with open(path_or_none, "w") as f:
            f.write(text)
    return text


def _resolve_ref_path(net_ref: str, solver_path: str,
                      extra_bases: Sequence[str] = ()) -> str:
    """Resolve one net file reference: the working directory first (Caffe
    resolves relative to the process's; zoo solvers use paths like
    examples/cifar10/...), then the solver's own directory, the
    reference's basename there, and any ``extra_bases``."""
    bases = ["", os.path.dirname(os.path.abspath(solver_path)) or "."]
    bases.extend(extra_bases)
    for base in bases:
        for cand in (os.path.join(base, net_ref) if base else net_ref,
                     os.path.join(base, os.path.basename(net_ref))
                     if base else net_ref):
            if os.path.exists(cand):
                return cand
    raise FileNotFoundError(f"cannot resolve net path {net_ref!r} "
                            f"(searched {bases})")


def resolve_net_path(sp: SolverParameter, solver_path: str,
                     extra_bases: Sequence[str] = ()) -> str:
    """Resolve a solver's ``net:``/``train_net:`` file reference."""
    net_ref = sp.net or sp.train_net
    if net_ref is None:
        raise FileNotFoundError("solver has no net:/train_net: reference")
    return _resolve_ref_path(net_ref, solver_path, extra_bases)


def resolve_solver_nets(sp: SolverParameter, solver_path: str) -> None:
    """Load every net file reference of a solver into its ``*_net_param``
    fields (Solver::InitTrainNet/InitTestNets path resolution): ``net:``/
    ``train_net:`` into ``net_param`` and each ``test_net:`` entry into
    ``test_net_param``.  Embedded definitions win over file references."""
    if not (sp.net_param or sp.train_net_param):
        sp.net_param = load_net_prototxt(resolve_net_path(sp, solver_path))
    if sp.test_net and not sp.test_net_param:
        sp.test_net_param = [
            load_net_prototxt(_resolve_ref_path(p, solver_path))
            for p in sp.test_net]


_DATA_LAYER_TYPES = {"Data", "ImageData", "WindowData", "MemoryData",
                     "HDF5Data", "DummyData", "JavaData", "Input"}


def replace_data_layers(net: NetParameter, train_batch_size: int,
                        test_batch_size: int, channels: int, height: int,
                        width: int) -> NetParameter:
    """``net`` with its data layers swapped for host-fed ``JavaData``
    input layers, one a phase (ProtoLoader.replaceDataLayers, reference:
    ProtoLoader.scala:50-57).  The new layers' tops are every top of the
    removed data layers, in order (``data`` and ``label`` when there
    were none); the label, when there is one, is (batch,)."""
    kept = [l for l in net.layer if l.type not in _DATA_LAYER_TYPES]
    tops: list[str] = []
    for l in net.layer:
        if l.type in _DATA_LAYER_TYPES:
            for t in l.top:
                if t not in tops:
                    tops.append(t)
    if not tops:
        tops = ["data", "label"]

    def make(phase: Phase, batch: int) -> LayerParameter:
        lp = LayerParameter(name=f"{tops[0]}_{phase.name.lower()}",
                            type="JavaData", top=list(tops), phase=phase)
        shape = PMessage()
        for d in (batch, channels, height, width):
            shape.add("dim", d)
        jd = PMessage()
        jd.add("shape", shape)
        if len(tops) > 1:
            lshape = PMessage()
            lshape.add("dim", batch)
            jd.add("label_shape", lshape)
        lp.params["java_data_param"] = jd
        return lp

    return dataclasses.replace(net, layer=[make(Phase.TRAIN, train_batch_size),
                                           make(Phase.TEST, test_batch_size)]
                               + kept)
