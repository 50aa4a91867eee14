"""Typed views over parsed prototxt for the Caffe net and solver schema.

The port's own copy of part of ``sparknet_tpu/proto/caffe_pb.py``:
``NetParameter``, ``LayerParameter``, ``NetState``/``NetStateRule``,
``Phase``, ``ParamSpec``, ``FillerParameter`` and ``BlobShape``, read from
new-style (V2) nets, and ``SolverParameter`` with the fields the learning
rate policies, the update rules and ``iter_size`` read.  V0/V1 upgrades
and ``.caffemodel`` blobs are not carried over.  Per-layer parameter
sub-messages stay as ``PMessage`` and are read with defaulting accessors
by the op implementations (reference: caffe.proto:64 NetParameter, :102
SolverParameter, :310 LayerParameter).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from .textformat import PMessage, parse


class Phase(enum.IntEnum):
    TRAIN = 0
    TEST = 1


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
        return cls(dim=[int(d) for d in m.get_all("dim")])


@dataclasses.dataclass
class FillerParameter:
    """Weight-init config (reference: caffe/include/caffe/filler.hpp:31-146)."""

    type: str = "constant"
    value: float = 0.0
    mean: float = 0.0
    std: float = 1.0
    variance_norm: str = "FAN_IN"  # FAN_IN | FAN_OUT | AVERAGE

    @classmethod
    def from_pmsg(cls, m: PMessage | None) -> "FillerParameter":
        if m is None:
            return cls()
        return cls(
            type=str(m.get("type", "constant")),
            value=float(m.get("value", 0.0)),
            mean=float(m.get("mean", 0.0)),
            std=float(m.get("std", 1.0)),
            variance_norm=str(m.get("variance_norm", "FAN_IN")),
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


_PARAM_SUBMSG_KEYS = (
    "accuracy_param", "convolution_param", "dropout_param",
    "inner_product_param", "input_param", "java_data_param", "loss_param",
    "lrn_param", "pooling_param", "relu_param", "softmax_param",
)


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
    # type-specific sub-configs, kept schema-free:
    params: dict[str, PMessage] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_pmsg(cls, m: PMessage) -> "LayerParameter":
        lp = cls(
            name=str(m.get("name", "")),
            type=str(m.get("type", "")),
            bottom=[str(b) for b in m.get_all("bottom")],
            top=[str(t) for t in m.get_all("top")],
            phase=_phase_of(m.get("phase")),
            loss_weight=[float(w) for w in m.get_all("loss_weight")],
            param=[ParamSpec.from_pmsg(p) for p in m.get_all("param")
                   if isinstance(p, PMessage)],
            include=[NetStateRule.from_pmsg(r) for r in m.get_all("include")],
            exclude=[NetStateRule.from_pmsg(r) for r in m.get_all("exclude")],
        )
        for key in _PARAM_SUBMSG_KEYS:
            sub = m.get(key)
            if isinstance(sub, PMessage):
                lp.params[key] = sub
        return lp

    def sub(self, key: str) -> PMessage:
        """Type-specific sub-config, empty message if absent."""
        return self.params.get(key) or PMessage()

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

    @classmethod
    def from_pmsg(cls, m: PMessage) -> "NetParameter":
        if m.has("layers") or m.has("input_dim"):
            raise ValueError("V0/V1 nets (`layers`, `input_dim`) are not "
                             "ported: upgrade the prototxt to `layer` and "
                             "`input_shape`")
        return cls(
            name=str(m.get("name", "")),
            layer=[LayerParameter.from_pmsg(l) for l in m.get_all("layer")],
            input=[str(i) for i in m.get_all("input")],
            input_shape=[BlobShape.from_pmsg(s)
                         for s in m.get_all("input_shape")],
            state=NetState.from_pmsg(m.get("state")),
        )

    def filtered(self, state: NetState) -> "NetParameter":
        """Phase-filtered copy — Net::FilterNet (reference: net.cpp:256)."""
        return dataclasses.replace(
            self, layer=[l for l in self.layer if l.included_in(state)],
            state=state)


@dataclasses.dataclass
class SolverParameter:
    """Training config (reference: caffe.proto:102), the fields that
    SGDSolver and the port's trainer read, with the proto defaults
    (reference: caffe/src/caffe/solvers/sgd_solver.cpp, solver.cpp).
    ``snapshot`` (an interval in iterations, 0 for none) and
    ``snapshot_prefix`` drive the trainer's snapshots on schedule; the
    test-net fields are not ported."""

    net_param: NetParameter | None = None
    train_net_param: NetParameter | None = None
    base_lr: float = 0.01
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
    solver_type: str = "SGD"  # SGD|NESTEROV|ADAGRAD|RMSPROP|ADADELTA|ADAM
    snapshot: int = 0
    snapshot_prefix: str = ""

    @classmethod
    def from_pmsg(cls, m: PMessage) -> "SolverParameter":
        def net_of(key: str) -> NetParameter | None:
            sub = m.get(key)
            return (NetParameter.from_pmsg(sub) if isinstance(sub, PMessage)
                    else None)

        return cls(
            net_param=net_of("net_param"),
            train_net_param=net_of("train_net_param"),
            base_lr=float(m.get("base_lr", 0.01)),
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
            solver_type=str(m.get("type", m.get("solver_type", "SGD"))
                            ).upper(),
            snapshot=int(m.get("snapshot", 0)),
            snapshot_prefix=str(m.get("snapshot_prefix", "")),
        )


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
    sp.net_param = net
    sp.train_net_param = None
    if snapshot_prefix is None:
        sp.snapshot = 0
        sp.snapshot_prefix = ""
    else:
        sp.snapshot_prefix = snapshot_prefix
    return sp
