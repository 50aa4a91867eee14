"""``caffe.proto.caffe_pb2`` shim — protobuf-message-style access over
this framework's own wire codecs (reference: the generated caffe_pb2
module; schema caffe/src/caffe/proto/caffe.proto).

pycaffe data scripts build LMDBs and read mean files through message
objects::

    blob = caffe.proto.caffe_pb2.BlobProto()
    blob.ParseFromString(open("mean.binaryproto", "rb").read())
    mean = caffe.io.blobproto_to_array(blob)

    datum = caffe.io.array_to_datum(img, label)
    txn.put(key, datum.SerializeToString())

This module provides that surface without protoc: each class wraps a
``textformat.PMessage`` and serializes through ``wireformat.decode`` /
``encode`` (the same codecs behind .caffemodel/.binaryproto IO, already
round-trip-pinned across the zoo).  Protobuf semantics honored:

- repeated fields present the list API (append/extend/indexing), with
  packed numeric fields (``blob.data``) stored as numpy chunks — one
  chunk per append/extend, concatenated on read, so element-wise fill
  loops stay linear;
- nested singular messages auto-vivify on first access
  (``blob.shape.dim``) but attach to the parent only on first MUTATION —
  reads never set field presence (HasField stays false);
- enum fields read and compare as their INTEGER values
  (``rule.phase == caffe_pb2.TEST``) and accept int or identifier on
  write;
- ``str()`` renders prototxt text.

Cardinality comes from ``_REPEATED`` below — the fields the reference's
python surface actually touches; all other fields behave as singular
(proto2 optional).

The port's own copy of ``sparknet_tpu/pycaffe_pb2.py``, over the port's
``proto/wireformat.py`` and ``proto/textformat.py``: no
``google.protobuf``, and the same bytes as the JAX module's messages.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from .proto.textformat import PMessage, serialize
from .proto.wireformat import ENUMS, MESSAGES, decode, encode

_ENUM_REV = {name: {v: k for k, v in table.items()}
             for name, table in ENUMS.items()}

TRAIN = 0
TEST = 1

# (message type, field) pairs that are `repeated` in caffe.proto —
# the python-visible subset (caffe.proto:6-41, 64-100, 102-243, 306-425)
_REPEATED: set[tuple[str, str]] = {
    ("BlobShape", "dim"),
    ("BlobProto", "data"), ("BlobProto", "diff"),
    ("BlobProto", "double_data"), ("BlobProto", "double_diff"),
    ("BlobProtoVector", "blobs"),
    ("Datum", "float_data"),
    ("NetParameter", "input"), ("NetParameter", "input_shape"),
    ("NetParameter", "input_dim"), ("NetParameter", "layer"),
    ("NetParameter", "layers"),
    ("SolverParameter", "test_net"), ("SolverParameter", "test_iter"),
    ("SolverParameter", "test_net_param"),
    ("SolverParameter", "test_state"), ("SolverParameter", "stepvalue"),
    ("LayerParameter", "bottom"), ("LayerParameter", "top"),
    ("LayerParameter", "loss_weight"), ("LayerParameter", "param"),
    ("LayerParameter", "blobs"), ("LayerParameter", "include"),
    ("LayerParameter", "exclude"), ("LayerParameter", "propagate_down"),
    ("NetState", "stage"), ("NetStateRule", "stage"),
    ("NetStateRule", "not_stage"),
}

_PACKED_KINDS = {"pfloat32", "pfloat64", "pint64"}
_PACKED_DTYPES = {"pfloat32": np.float32, "pfloat64": np.float64,
                  "pint64": np.int64}

_SCALAR_DEFAULTS = {
    "int32": 0, "int64": 0, "uint32": 0, "uint64": 0,
    "float": 0.0, "double": 0.0, "bool": False,
    "string": "", "bytes": b"",
}


def _field_table(msg_type: str) -> dict[str, str]:
    """{field name: kind} for a schema message."""
    return {name: kind for name, kind in MESSAGES[msg_type].values()}


def _enum_default(ename: str) -> int:
    table = ENUMS[ename]
    return 0 if 0 in table else min(table)


class _RepeatedScalar:
    """List API over a repeated scalar field.  Packed numeric fields
    (BlobProto.data etc.) are stored as numpy CHUNKS in the underlying
    PMessage — append/extend add one chunk (O(1)); readers (this view,
    the wire encoder, blob_to_array) concatenate."""

    def __init__(self, pmsg: PMessage, name: str, kind: str,
                 on_mutate: Callable[[], None] | None = None):
        self._p, self._name, self._kind = pmsg, name, kind
        self._on_mutate = on_mutate

    def _mutate(self) -> None:
        if self._on_mutate is not None:
            self._on_mutate()

    def _packed(self) -> bool:
        return self._kind in _PACKED_KINDS

    def _flat(self):
        vals = self._p.get_all(self._name)
        if not self._packed():
            return vals
        if not vals:
            return np.zeros((0,), _PACKED_DTYPES[self._kind])
        if len(vals) == 1:  # the common case: no copy per read
            return np.atleast_1d(np.asarray(vals[0]))
        # consolidate storage so element-wise read loops stay linear
        # (semantically neutral: readers concatenate chunks anyway)
        flat = np.concatenate([np.atleast_1d(np.asarray(v)) for v in vals])
        self._p.clear(self._name)
        self._p.set(self._name, flat)
        return flat

    def append(self, v) -> None:
        self._mutate()
        if self._packed():
            self._p.add(self._name,
                        np.atleast_1d(np.asarray(v, _PACKED_DTYPES[self._kind])))
        else:
            self._p.add(self._name, v)

    def extend(self, vs) -> None:
        self._mutate()
        if self._packed():
            arr = np.asarray(list(vs), _PACKED_DTYPES[self._kind])
            if arr.size:
                self._p.add(self._name, arr)
        else:
            for v in vs:
                self._p.add(self._name, v)

    def __len__(self) -> int:
        if self._packed():
            return int(sum(np.size(v) for v in self._p.get_all(self._name)))
        return len(self._p.get_all(self._name))

    def __iter__(self):
        return iter(self._flat())

    def __getitem__(self, i):
        return self._flat()[i]

    def __eq__(self, other) -> bool:
        return list(self._flat()) == list(other)

    def __repr__(self) -> str:
        return repr(list(self._flat()))


class _RepeatedMessage:
    """List API over a repeated message field, protobuf-style:
    ``add()`` appends and returns a new element."""

    def __init__(self, pmsg: PMessage, name: str, msg_type: str,
                 on_mutate: Callable[[], None] | None = None):
        self._p, self._name, self._type = pmsg, name, msg_type
        self._on_mutate = on_mutate

    def _mutate(self) -> None:
        if self._on_mutate is not None:
            self._on_mutate()

    def add(self) -> "Message":
        self._mutate()
        sub = PMessage()
        self._p.add(self._name, sub)
        return _class_for(self._type)(sub)

    def extend(self, msgs) -> None:
        self._mutate()
        for m in msgs:
            # protobuf extend COPIES: later edits to the source must not
            # reach into this container (wire round trip = deep copy)
            self._p.add(self._name,
                        decode(encode(m._p, self._type), self._type))

    def __len__(self) -> int:
        return len(self._p.get_all(self._name))

    def __iter__(self):
        cls = _class_for(self._type)
        return (cls(v) for v in self._p.get_all(self._name))

    def __getitem__(self, i) -> "Message":
        return _class_for(self._type)(self._p.get_all(self._name)[i])


class Message:
    """Base wrapper: one PMessage + the schema table of its type.

    ``_on_mutate`` implements protobuf presence semantics for vivified
    nested messages: reading ``blob.shape`` returns a DETACHED wrapper;
    the first mutation anywhere beneath it attaches it to the parent
    (and so on up the chain), so reads never set HasField."""

    TYPE = ""  # set per subclass

    def __init__(self, pmsg: PMessage | None = None,
                 _on_mutate: Callable[[], None] | None = None):
        object.__setattr__(self, "_p", pmsg if pmsg is not None
                           else PMessage())
        object.__setattr__(self, "_on_mutate", _on_mutate)
        object.__setattr__(self, "_viv", {})  # vivified children by field

    def _mutate(self) -> None:
        cb = self._on_mutate
        if cb is not None:
            object.__setattr__(self, "_on_mutate", None)
            cb()

    # -- protobuf wire API ------------------------------------------------
    def ParseFromString(self, data: bytes) -> None:
        self._mutate()
        decoded = decode(bytes(data), self.TYPE)
        self._p._fields.clear()  # in place: parents keep holding this pmsg
        self._p._fields.update(decoded._fields)

    def SerializeToString(self) -> bytes:
        return encode(self._p, self.TYPE)

    def CopyFrom(self, other: "Message") -> None:
        self.ParseFromString(other.SerializeToString())

    def __str__(self) -> str:  # prototxt text, like protobuf text_format
        return serialize(self._p)

    # -- field access -----------------------------------------------------
    def _kind(self, name: str) -> str:
        table = _field_table(self.TYPE)
        if name not in table:
            raise AttributeError(
                f"{self.TYPE} has no field {name!r} "
                f"(fields: {sorted(table)})")
        return table[name]

    def __getattr__(self, name: str):
        kind = self._kind(name)
        repeated = (self.TYPE, name) in _REPEATED
        if kind.startswith("msg:"):
            sub_type = kind[4:]
            if repeated:
                return _RepeatedMessage(self._p, name, sub_type,
                                        on_mutate=self._mutate)
            sub = self._p.get(name)
            if sub is None:
                # auto-vivify DETACHED (blob.shape.dim.extend(...)):
                # attach to self only when the child first mutates.  The
                # wrapper is cached so repeated reads of the same unset
                # field share ONE child, as protobuf does.
                cached = self._viv.get(name)
                if cached is not None:
                    return cached
                sub_p = PMessage()

                def attach(parent=self, nm=name, sp=sub_p):
                    parent._mutate()
                    parent._p.set(nm, sp)
                child = _class_for(sub_type)(sub_p, _on_mutate=attach)
                self._viv[name] = child
                return child
            return _class_for(sub_type)(sub, _on_mutate=self._mutate)
        if repeated or kind in _PACKED_KINDS:
            return _RepeatedScalar(self._p, name, kind,
                                   on_mutate=self._mutate)
        if kind.startswith("enum:"):
            ename = kind[5:]
            v = self._p.get(name)
            if v is None:
                return _enum_default(ename)
            if isinstance(v, str):  # identifier (text parse / wire decode)
                return _ENUM_REV[ename].get(str(v), _enum_default(ename))
            return int(v)
        return self._p.get(name, _SCALAR_DEFAULTS.get(kind, 0))

    def __setattr__(self, name: str, value: Any) -> None:
        kind = self._kind(name)
        if kind.startswith("msg:") or (self.TYPE, name) in _REPEATED \
                or kind in _PACKED_KINDS:
            raise AttributeError(
                f"{self.TYPE}.{name} is not a singular scalar; use "
                f".extend()/.append()/.add() or CopyFrom")
        self._mutate()
        if kind.startswith("enum:"):
            # store an EnumToken identifier (bare in prototxt text, the
            # convention the text/wire codecs share); accept int or a
            # VALID identifier
            from .proto.textformat import EnumToken
            table = ENUMS[kind[5:]]
            if isinstance(value, str):
                if value not in _ENUM_REV[kind[5:]]:
                    raise ValueError(
                        f"{self.TYPE}.{name}: unknown enum identifier "
                        f"{value!r} (one of {sorted(table.values())})")
            else:
                if int(value) not in table:
                    raise ValueError(
                        f"{self.TYPE}.{name}: no enum value {value!r}")
                value = table[int(value)]
            value = EnumToken(value)
        self._p.set(name, value)

    def HasField(self, name: str) -> bool:
        self._kind(name)
        return self._p.has(name)


_CLASS_CACHE: dict[str, type] = {}


def _class_for(msg_type: str) -> type:
    cls = _CLASS_CACHE.get(msg_type)
    if cls is None:
        cls = type(msg_type, (Message,), {"TYPE": msg_type})
        _CLASS_CACHE[msg_type] = cls
    return cls


def __getattr__(name: str):
    """Every schema message is constructible: caffe_pb2.BlobProto(),
    caffe_pb2.Datum(), caffe_pb2.NetParameter(), ..."""
    if name in MESSAGES:
        return _class_for(name)
    raise AttributeError(name)
