"""``caffe.net_spec``: programmatic net construction in the pycaffe idiom
(reference: caffe/python/caffe/net_spec.py)::

    from sparknet_tpu_torch.pycaffe_compat import layers as L, params as P
    from sparknet_tpu_torch.pycaffe_compat import NetSpec
    n = NetSpec()
    n.conv1 = L.Convolution(n.data, kernel_size=5, num_output=20,
                            weight_filler=dict(type='xavier'))
    n.pool1 = L.Pooling(n.conv1, kernel_size=2, stride=2,
                        pool=P.Pooling.MAX)
    n.loss = L.SoftmaxWithLoss(n.score, n.label)
    net_param = n.to_proto()          # a typed NetParameter
    text = str(n.to_proto())          # prototxt text

The port's own copy of ``sparknet_tpu/pycaffe_netspec.py``: it emits the
port's typed ``NetParameter`` and prints through the port's
``proto/textformat.serialize``, byte for byte the JAX module's text.
Kwarg routing matches the reference's param_name_dict(): a layer type's
kwargs land in its ``<type>_param`` sub-message (derived from the
LayerParameter schema, e.g. Convolution -> convolution_param), except
LayerParameter-level fields (loss_weight, param, include, ...) and
explicit ``*_param=dict(...)`` sub-messages.  ``ntop`` controls the
number of returned tops, ``in_place=True`` reuses the bottom name
(net_spec.py Function semantics).
"""

from __future__ import annotations

from typing import Any

from .proto.caffe_pb import NetParameter
from .proto.textformat import serialize
from .proto.wireformat import MESSAGES

# LayerParameter-level fields assignable directly from kwargs
_TOP_LEVEL = {"loss_weight", "param", "phase", "include", "exclude"}

# message-type -> field map derived from the schema, the reference's
# param_name_dict(): ConvolutionParameter -> Convolution -> convolution_param
_PARAM_FIELDS = {name for _num, (name, kind) in
                 MESSAGES["LayerParameter"].items()
                 if name.endswith("_param")}
_TYPE_TO_PARAM = {}
_PARAM_MSG_TYPE = {}
for _num, (_name, _kind) in MESSAGES["LayerParameter"].items():
    if _name.endswith("_param") and _kind.startswith("msg:"):
        _t = _kind[4:]
        _PARAM_MSG_TYPE[_name] = _t
        if _t.endswith("Parameter"):
            _TYPE_TO_PARAM[_t[:-len("Parameter")]] = _name


def _check_param_fields(field: str, sub: dict) -> None:
    """Reject misspelled sub-message fields at build time, like
    net_spec's protobuf assignment would (reference net_spec.py
    assign_proto raising on nonexistent fields)."""
    schema = MESSAGES.get(_PARAM_MSG_TYPE.get(field, ""), None)
    if schema is None:
        return  # param message without a wire schema: accept as-is
    known = {name for _n, (name, _k) in schema.items()}
    bad = sorted(set(sub) - known)
    if bad:
        raise ValueError(
            f"{field} has no field(s) {bad} (known: {sorted(known)})")


def _state_rule(rule: dict):
    """include/exclude kwarg dict -> NetStateRule (phase accepts 'TRAIN'/
    'TEST' strings, Phase enums, or 0/1 ints)."""
    from .proto.caffe_pb import NetStateRule, Phase
    rule = dict(rule)
    phase = rule.pop("phase", None)
    if isinstance(phase, str):
        phase = Phase[phase]
    elif isinstance(phase, int):
        phase = Phase(phase)
    stage = rule.pop("stage", [])
    not_stage = rule.pop("not_stage", [])
    min_level = rule.pop("min_level", None)
    max_level = rule.pop("max_level", None)
    if rule:
        raise ValueError(f"unknown NetStateRule field(s) {sorted(rule)}")
    return NetStateRule(
        phase=phase,
        min_level=min_level,
        max_level=max_level,
        stage=[stage] if isinstance(stage, str) else list(stage),
        not_stage=([not_stage] if isinstance(not_stage, str)
                   else list(not_stage)),
    )


class Top:
    """A named layer output; bottoms of later layers (net_spec.py Top)."""

    def __init__(self, fn: "Function", n: int):
        self.fn = fn
        self.n = n


class Function:
    """One layer call: type + input Tops + params (net_spec.py Function)."""

    def __init__(self, type_name: str, inputs: tuple, params: dict):
        self.type_name = type_name
        self.inputs = inputs
        for t in inputs:
            if not isinstance(t, Top):
                raise TypeError(
                    f"{type_name} bottoms must be Tops (got "
                    f"{type(t).__name__}) — pass n.<blob>, not raw values")
        self.params = dict(params)
        self.ntop = self.params.pop("ntop", 1)
        self.in_place = self.params.pop("in_place", False)
        if self.in_place and (self.ntop != 1 or len(inputs) != 1):
            raise ValueError("in_place requires exactly one bottom and top")
        unknown = [k for k in self.params
                   if k not in _TOP_LEVEL and not k.endswith("_param")
                   and self.type_name not in _TYPE_TO_PARAM]
        if unknown:
            raise ValueError(
                f"layer type {self.type_name!r} has no default param "
                f"message; pass explicit <name>_param=dict(...) for "
                f"{unknown}")
        for k in self.params:
            if k.endswith("_param") and k not in _PARAM_FIELDS:
                raise ValueError(f"unknown LayerParameter field {k!r}")
        # misspelled fields fail NOW, like net_spec's protobuf assignment
        default_field = _TYPE_TO_PARAM.get(self.type_name)
        bare = {k: v for k, v in self.params.items()
                if k not in _TOP_LEVEL and not k.endswith("_param")}
        if bare and default_field:
            _check_param_fields(default_field, bare)
        for k, v in self.params.items():
            if k.endswith("_param") and isinstance(v, dict):
                _check_param_fields(k, v)
        self.tops = tuple(Top(self, i) for i in range(self.ntop))

    def _layer_param(self, names: dict["Top", str],
                     blob_names: dict["Top", str]) -> Any:
        from .models.dsl import layer as dsl_layer

        bottoms = [blob_names[t] for t in self.inputs]
        if self.in_place:
            tops = list(bottoms)
        else:
            tops = [blob_names[t] for t in self.tops]
        top_level: dict[str, Any] = {}
        type_params: dict[str, Any] = {}
        default_field = _TYPE_TO_PARAM.get(self.type_name)
        for k, v in self.params.items():
            if k in _TOP_LEVEL:
                top_level[k] = v
            elif k.endswith("_param"):
                type_params[k] = dict(v)
            else:
                type_params.setdefault(default_field, {})[k] = v
        for field, sub in type_params.items():
            _check_param_fields(field, sub)
        # layer NAME is the assigned attr even in-place (Caffe idiom:
        # name "relu1", bottom/top both "conv1"); blob names differ
        name = names[self.tops[0]]
        lp = dsl_layer(name, self.type_name, bottoms, tops,
                       phase=top_level.get("phase"),
                       param=top_level.get("param"), **type_params)
        if "loss_weight" in top_level:
            lw = top_level["loss_weight"]
            lp.loss_weight = (list(lw) if isinstance(lw, (list, tuple))
                              else [float(lw)])
        for key in ("include", "exclude"):
            if key in top_level:
                rules = top_level[key]
                if isinstance(rules, dict):
                    rules = [rules]
                setattr(lp, key, [_state_rule(r) for r in rules])
        return lp


class _Layers:
    """``L``: attribute access builds layer Functions (net_spec.py layers)."""

    def __getattr__(self, type_name: str):
        def build(*inputs, **params):
            fn = Function(type_name, inputs, params)
            if fn.ntop == 0:
                return fn
            if fn.ntop == 1:
                return fn.tops[0]
            return fn.tops
        return build


class _ParamEnum:
    def __init__(self, prefix: str):
        self._prefix = prefix

    def __getattr__(self, name: str):
        # enums serialize by bare NAME in proto text format (EnumToken);
        # a plain str would be quoted like a string field
        from .proto.textformat import EnumToken
        return EnumToken(name)


class _Params:
    """``P``: enum access, e.g. P.Pooling.MAX -> bare enum token "MAX"
    (net_spec.py params, which resolves protobuf enum values; our config
    tree keeps enum names, tagged so prototxt serialization leaves them
    unquoted)."""

    def __getattr__(self, msg_name: str) -> _ParamEnum:
        return _ParamEnum(msg_name)


layers = _Layers()
params = _Params()


class _ProtoWrapper:
    """to_proto() result: a typed NetParameter whose str() is prototxt
    (the pycaffe idiom ``f.write(str(n.to_proto()))``)."""

    def __init__(self, net_param: NetParameter):
        self.net_param = net_param

    def __str__(self) -> str:
        return serialize(self.net_param.to_pmsg())

    def __getattr__(self, name):
        return getattr(self.net_param, name)


class NetSpec:
    """Named collection of Tops; to_proto() assembles the NetParameter
    (net_spec.py NetSpec)."""

    def __init__(self):
        super().__setattr__("tops", {})

    def __setattr__(self, name: str, value) -> None:
        if not isinstance(value, Top):
            raise TypeError(
                f"NetSpec attributes must be layer Tops (n.{name} = "
                f"L.<Type>(...)); got {type(value).__name__}")
        self.tops[name] = value

    def __getattr__(self, name: str) -> Top:
        try:
            return self.tops[name]
        except KeyError:
            raise AttributeError(name) from None

    def __delattr__(self, name: str) -> None:
        del self.tops[name]

    def to_proto(self) -> _ProtoWrapper:
        # name every reachable Top: assigned names win; autonames for
        # unassigned tops of multi-top functions (net_spec.py to_proto)
        names: dict[Top, str] = {}
        for name, top in self.tops.items():
            names.setdefault(top, name)

        fns: list[Function] = []
        seen: set[int] = set()

        def visit(fn: Function) -> None:
            if id(fn) in seen:
                return
            seen.add(id(fn))
            for t in fn.inputs:
                visit(t.fn)
            fns.append(fn)

        for top in self.tops.values():
            visit(top.fn)
        autonum = 0
        for fn in fns:
            for t in fn.tops:
                if t not in names:
                    if t is fn.tops[0]:
                        names[t] = f"{fn.type_name.lower()}{autonum}"
                        autonum += 1
                    else:
                        names[t] = f"{names[fn.tops[0]]}_top{t.n}"

        # blob name: an in-place chain keeps the original bottom's blob
        # (the assigned attr still names the LAYER, net_spec semantics)
        blob_names: dict[Top, str] = {}

        def blob_name(t: Top) -> str:
            if t not in blob_names:
                blob_names[t] = (blob_name(t.fn.inputs[0])
                                 if t.fn.in_place else names[t])
            return blob_names[t]

        for fn in fns:
            for t in list(fn.inputs) + list(fn.tops):
                blob_name(t)
        layer_params = [fn._layer_param(names, blob_names) for fn in fns]
        return _ProtoWrapper(NetParameter(name="", layer=layer_params))
