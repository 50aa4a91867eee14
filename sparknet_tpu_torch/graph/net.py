"""Graph compiler: NetParameter -> an executable network on tensors.

The port's counterpart of ``sparknet_tpu/graph/net.py`` (Caffe's ``Net``,
reference: caffe/src/caffe/net.cpp:40 ``Init`` — phase filtering, wiring,
per-layer shape inference — and ``ForwardFromTo``).  PyTorch runs eagerly:
``apply`` walks the layers in order on whatever device the inputs and
params are on.

Params are a plain ``{layer name: [blobs...]}`` dict of tensors, the
JAX package's ``WeightCollection``, with the JAX blob layouts.  With a
``compute_dtype`` (bf16), params and activations are cast per layer over
f32 master weights while loss and accuracy layers stay f32 (``_cast``,
net.py:529 of the JAX package).  :meth:`Net.forward` also sums the loss
tops, weighted by their ``loss_weight`` (``NetOutputs``, net.py:46-62),
and runs the TRAIN phase's stochastic layers from a CPU
``torch.Generator``; gradients come from ``torch.autograd``.  While a
profiler records, each layer's forward runs inside an ``L[<layer>]``
range (``utils/profiling.py::layer_scope``), which
``utils/trace_tables.py`` reads to charge device time to layers.

Params are shared across layers by ``ParamSpec.name`` as Caffe's
``AppendParam`` shares them (net.cpp): the first layer to declare a name
owns the blob, and only owners store it, in the JAX package's compacted
layout (a layer that shares every blob has no entry; one that shares
some keeps its own blobs in order).  Every layer that shares a blob is
handed the owner's very tensor, so autograd sums all their gradients
into it before the solver regularizes and steps.

Fusion (the JAX package's ``net.py:214-317``, ``:580-779``), latched at
construction with the lowering table (``graph/tuner.py``), and run on
full runs only (``forward``, ``apply`` of output blobs): a ranged run,
an ``eps`` run or one that returns intermediate blobs (``apply_all``,
``apply(blobs=...)``) runs each layer by itself and is counted in
``fusion_unfused_runs_total``.

- **Horizontal** (``SPARKNET_NO_HFUSE``, on by default): sibling 1x1
  convolutions over the same version of one blob (an inception block's
  ``1x1``, ``3x3_reduce``, ``5x5_reduce``) run as one wider convolution
  whose output is split by channels.  The members' weights and biases
  are concatenated at every run, so autograd hands each member its own
  gradient and the solver's in-place updates are seen.
- **Vertical** (``SPARKNET_FUSE``, ``graph/fusion.py``): each planned
  Conv -> [ReLU] -> [Pool] -> [LRN] chain runs as one block under one
  ``L[a+b+...]`` scope, its LRN tail through
  ``ops.vision.lrn_chain_epilogue`` (a zero-slope ReLU folded into the
  hand LRN kernels where the chain allows it).

Forward state: a layer with ``has_state`` (BatchNorm) hands back its
blobs as the forward rewrote them (its running statistics), and
:meth:`Net.forward` returns the params with them written in, through the
sharing map, as ``NetOutputs.params`` (the JAX package's
``_scatter_node_params``, net.py:448-470).  Such a layer runs in f32
under a bf16 ``compute_dtype``, and BatchNorm's three blobs get lr_mult
and decay_mult 0 whatever the prototxt says (net.py:176-178).  A top of
a ``dynamic_batch`` layer (Filter) has a batch dim the data decides: a
consumer whose parameter shapes would depend on it is refused at build
time (``_check_batch_insensitive``, net.py:319-340).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

from .. import ops  # noqa: F401  (registers the layer implementations)
from ..ops import vision
from ..ops.registry import LayerImpl, Shape, get_layer_impl
from ..proto.caffe_pb import LayerParameter, NetParameter, NetState, Phase
from ..utils import knobs, telemetry
from ..utils.device import resolve_device
from ..utils.profiling import layer_scope
from . import fusion, tuner

Params = dict[str, list[torch.Tensor]]


@dataclasses.dataclass
class NetOutputs:
    """Result of one forward pass."""

    blobs: dict[str, torch.Tensor]   # the net's output blobs
    loss: torch.Tensor               # sum of loss_weight x top, f32
    params: dict[str, list[torch.Tensor]]   # with the forward's state


def _split_channels(y: torch.Tensor,
                    sizes: Sequence[int]) -> tuple[torch.Tensor, ...]:
    """A horizontally fused convolution's output, cut back into its
    members' outputs along the channels."""
    return torch.split(y, list(sizes), dim=1)


def _check_batch_insensitive(lp: LayerParameter, impl: LayerImpl,
                             bottoms: Sequence[str],
                             bshapes: Sequence[Shape],
                             tainted: set[str]) -> None:
    """A consumer of a Filter's tops sees a placeholder batch dim (the
    real one is the data's, filter_layer.cpp Reshape).  Refuse a layer
    whose parameter shapes change with that dim; the usual layers size
    their blobs from the other dims and stay valid (the JAX package's
    ``Net._check_batch_insensitive``)."""
    def probe(shapes):
        return [tuple(s) for s in impl.param_shapes(lp, shapes)]
    bumped = [(s[0] + 1,) + tuple(s[1:]) if b in tainted and s else s
              for b, s in zip(bottoms, bshapes)]
    try:
        sensitive = probe(bshapes) != probe(bumped)
    except Exception:
        sensitive = bool(probe(bshapes))   # the bump broke it: be strict
    if sensitive:
        raise ValueError(
            f"layer {lp.name!r} ({lp.type}) builds parameters from blobs "
            f"with a data-dependent batch dim (downstream of a Filter "
            f"layer): its declared shapes are unreliable")


class _LayerNode:
    """One layer, with its blobs' place in the storage: ``shared_refs``
    maps a blob index to (owner layer, position in the owner's stored
    list), ``own_map`` a blob index this layer owns to its position in
    its own stored list (both empty when it shares nothing), and
    ``lr_mults``/``decay_mults`` its per-blob multipliers after the merge
    with the layers that share them."""

    __slots__ = ("lp", "impl", "bottoms", "tops", "lr_mults", "decay_mults",
                 "shared_refs", "own_map", "n_blobs", "tune")

    def __init__(self, lp: LayerParameter, impl: LayerImpl,
                 bottoms: list[str], tops: list[str]):
        self.lp = lp
        self.impl = impl
        self.bottoms = bottoms
        self.tops = tops
        self.lr_mults = [ps.lr_mult for ps in lp.param]
        self.decay_mults = [ps.decay_mult for ps in lp.param]
        self.shared_refs: dict[int, tuple[str, int]] = {}
        self.own_map: dict[int, int] = {}
        self.n_blobs = 0
        # a tuner seam's {(shape, dtype): lowering} from the Net's table
        # (empty: the built-in lowering); None for a layer with no seam
        self.tune: dict[tuple, str] | None = None

    def seam(self, bottoms: Sequence[torch.Tensor]) -> dict:
        """The keyword a seam layer's ``apply`` takes: the lowering the
        Net's table names for this input, None for the built-in one.
        Nothing for a layer with no seam."""
        if self.tune is None:
            return {}
        x = bottoms[0]
        return {"lowering": self.tune.get((tuple(x.shape), x.dtype))
                if self.tune else None}

    def owner_keys(self) -> set[str]:
        """The storage keys that hold any of this layer's blobs."""
        keys = {o for o, _ in self.shared_refs.values()}
        if self.own_map or not self.shared_refs:
            keys.add(self.lp.name)
        return keys

    def loss_weights(self) -> list[float]:
        """Per-top loss weights, Layer::SetLossWeights: the explicit
        ``loss_weight``s, else 1 on a loss layer's first top."""
        weights = list(self.lp.loss_weight)
        if not weights and self.impl.is_loss():
            weights = [1.0] + [0.0] * (len(self.tops) - 1)
        return weights


class Net:
    """A phase-filtered, shape-inferred, executable network.
    ``input_overrides`` ({input blob: shape}) replaces the declared
    shapes of inputs, as pycaffe's ``Net.reshape`` does."""

    def __init__(self, net_param: NetParameter,
                 state: NetState | None = None, *,
                 compute_dtype: torch.dtype | None = None,
                 input_overrides: Mapping[str, Sequence[int]] | None = None):
        state = state or net_param.state or NetState()
        self.state = state
        self.param = net_param.filtered(state)
        self.name = net_param.name
        self.compute_dtype = compute_dtype
        self.nodes: list[_LayerNode] = []
        self.blob_shapes: dict[str, Shape] = {}
        self.input_blobs: dict[str, Shape] = {}
        # {input blob: shape} replacing the declared shape of a net-level
        # input or an input layer's top, downstream shapes re-inferred
        # from it: pycaffe's Net.reshape (net.cpp Reshape)
        overrides = {k: tuple(int(d) for d in v)
                     for k, v in (input_overrides or {}).items()}

        # net-level input declarations (legacy `input:` + `input_shape:`)
        for i, name in enumerate(self.param.input):
            shape = overrides.get(name, tuple(self.param.input_shape[i].dim))
            self.blob_shapes[name] = shape
            self.input_blobs[name] = shape

        shared_owner: dict[str, tuple[str, int]] = {}  # name -> (layer, i)
        self._node_by_name: dict[str, _LayerNode] = {}
        # blobs whose batch dim the data decides (downstream of Filter):
        # their declared shapes are placeholders
        tainted: set[str] = set()
        for lp in self.param.layer:
            # a fresh impl for a layer with host state per net (Python)
            impl = get_layer_impl(lp.type).per_net_copy()
            # input layers are fed, not run: their bottoms go unread
            if not impl.is_input() and len(lp.bottom) < impl.min_bottoms():
                raise ValueError(
                    f"layer {lp.name!r} ({lp.type}) needs at least "
                    f"{impl.min_bottoms()} bottoms, has {len(lp.bottom)}")
            for b in lp.bottom:
                if b not in self.blob_shapes:
                    raise ValueError(
                        f"layer {lp.name!r} bottom {b!r} unknown "
                        f"(known: {sorted(self.blob_shapes)})")
            bshapes = [self.blob_shapes[b] for b in lp.bottom]
            if any(b in tainted for b in lp.bottom):
                _check_batch_insensitive(lp, impl, lp.bottom, bshapes,
                                         tainted)
            oshapes = impl.out_shapes(lp, bshapes)
            tops = list(lp.top) or ([lp.name] if oshapes else [])
            while len(tops) < len(oshapes):
                tops.append(f"{lp.name}_top{len(tops)}")
            if impl.is_input() and overrides:
                oshapes = [overrides.get(t, s) for t, s in zip(tops, oshapes)]
            for t, s in zip(tops, oshapes):
                self.blob_shapes[t] = tuple(int(d) for d in s)
                if impl.is_input():
                    self.input_blobs[t] = self.blob_shapes[t]
            if impl.dynamic_batch or any(b in tainted for b in lp.bottom):
                tainted.update(tops)
            node = _LayerNode(lp, impl, list(lp.bottom), tops)
            if lp.type == "BatchNorm":
                # running statistics: no update moves them
                node.lr_mults = [0.0, 0.0, 0.0]
                node.decay_mults = [0.0, 0.0, 0.0]
            # each named spec shares one blob with the first layer that
            # declared the name (net.cpp AppendParam)
            raw_refs: dict[int, tuple[str, int]] = {}
            for i, ps in enumerate(lp.param):
                if not ps.name:
                    continue
                if ps.name in shared_owner:
                    raw_refs[i] = shared_owner[ps.name]
                else:
                    shared_owner[ps.name] = (lp.name, i)
            if raw_refs:
                self._resolve_sharing(node, raw_refs)
            self.nodes.append(node)
            self._node_by_name[lp.name] = node

        # net outputs via Caffe's available-blob walk (net.cpp AppendTop/
        # AppendBottom): a trailing in-place layer's blob stays an output;
        # survivors in first-production order
        available: dict[str, None] = {}
        order: dict[str, None] = {}
        for n in self.nodes:
            for b in n.bottoms:
                available.pop(b, None)
            for t in n.tops:
                available[t] = None
                order[t] = None
        self.output_blobs = [t for t in order
                             if t in available and t not in self.input_blobs]
        unknown = set(overrides) - set(self.input_blobs)
        if unknown:
            raise ValueError(
                f"input_overrides for non-input blobs: {sorted(unknown)}")
        self._detect_hfuse_groups()
        self._detect_vfuse_chains()
        self._latch_tune_plan()
        self._fuse_skip_noted: set[str] = set()

    def _detect_hfuse_groups(self) -> None:
        """Horizontal fusion of sibling 1x1 convolutions (default on,
        ``SPARKNET_NO_HFUSE=1`` turns it off; the JAX package's
        ``_detect_hfuse_groups``): conv(x, W1) || conv(x, W2) ==
        split(conv(x, cat(W1, W2))), each output channel's reduction
        untouched.  Members read the same version of their bottom (an
        in-place layer reassigns a name), share bias_term, and have one
        bottom and one top.  The toggle is read once, here."""
        self._hfuse_enabled = knobs.raw("SPARKNET_NO_HFUSE") != "1"
        ver: dict[str, int] = {}
        groups: dict[tuple, list[_LayerNode]] = {}
        for node in self.nodes:
            if (node.lp.type == "Convolution" and len(node.bottoms) == 1
                    and len(node.tops) == 1):
                kh, kw, sh, sw, ph, pw, dh, dw, _, group, bias = \
                    vision.conv_geometry(node.lp)
                if (kh, kw, sh, sw, ph, pw, dh, dw, group) == (
                        1, 1, 1, 1, 0, 0, 1, 1, 1):
                    b = node.bottoms[0]
                    groups.setdefault((b, ver.get(b, 0), bias),
                                      []).append(node)
            for t in node.tops:
                ver[t] = ver.get(t, 0) + 1
        # first member name -> all member nodes; later members -> stash
        self._hfuse_first: dict[str, list[_LayerNode]] = {}
        self._hfuse_member: set[str] = set()
        for members in groups.values():
            if len(members) >= 2:
                self._hfuse_first[members[0].lp.name] = members
                self._hfuse_member.update(m.lp.name for m in members[1:])

    def _detect_vfuse_chains(self) -> None:
        """Vertical chains, planned by ``graph/fusion.py`` from
        ``SPARKNET_FUSE`` (latched here).  Runs after the horizontal
        detection: horizontal groups keep their members, vertical
        chains take what is left."""
        self._fuse_plan = fusion.resolve_plan(self)
        self._vfuse_head: dict[str, fusion.FusedChain] = {}
        self._vfuse_member: set[str] = set()
        if self._fuse_plan is None:
            return
        for ch in self._fuse_plan.chains:
            if not all(m in self._node_by_name for m in ch.members):
                continue   # plan from another net's namespace
            self._vfuse_head[ch.members[0]] = ch
            self._vfuse_member.update(ch.members[1:])

    def fuse_plan_id(self) -> str:
        """Short id of the vertical-fusion plan (``off`` when none), the
        perf-ledger fingerprint field that keeps fused and unfused
        captures out of each other's baseline bands."""
        return (self._fuse_plan.plan_id() if self._fuse_plan is not None
                else "off")

    def _latch_tune_plan(self) -> None:
        """Resolve ``SPARKNET_TUNE`` once, here: a typo'd path or a
        drifted or wrong-backend table fails at construction, and each
        seam node and chain epilogue keeps what the table names for it,
        so a run does no key work and none at all where the table names
        only the built-in lowerings."""
        table = self._tune_table = tuner.active_table()
        self._tune_plan_id = (table.table_id() if table is not None
                              else "off")

        def overrides(op: str, extra: str) -> dict:
            return table.overrides(op, extra) if table is not None else {}
        for node in self.nodes:
            seam = tuner.seam_of(node.lp, self.blob_shapes.get(
                node.bottoms[0]) if node.bottoms else None)
            node.tune = overrides(*seam) if seam is not None else None
        self._epilogue_tune: dict[str, dict] = {}
        for head, ch in self._vfuse_head.items():
            if ch.epilogue in ("lrn", "relu+lrn"):
                size = vision.lrn_geometry(
                    self._node_by_name[ch.members[-1]].lp)[0]
                self._epilogue_tune[head] = overrides(
                    "lrn_epilogue", tuner.epilogue_extra(
                        size, ch.epilogue == "relu+lrn"))

    def tune_plan_id(self) -> str:
        """Short id of the lowering table latched at construction
        (``off`` when none), the perf-ledger ``tune_plan`` field."""
        return self._tune_plan_id

    def _note_unfused_run(self, reason: str) -> None:
        """A fusable net running unfused (ranged, ``eps`` or
        introspected run): the always-on counter, and one instant event
        per (net, reason), so a capture of such a run is not mistaken
        for the fused program's."""
        telemetry.get_registry().counter(
            "fusion_unfused_runs_total",
            "runs of a fusable net that skipped fusion").inc(
                reason=reason)
        if reason not in self._fuse_skip_noted:
            self._fuse_skip_noted.add(reason)
            telemetry.instant(
                "fusion.unfused_run", cat="graph", reason=reason,
                net=self.name or "?",
                hfuse_groups=len(self._hfuse_first),
                vfuse_chains=len(self._vfuse_head))

    def _blob_shapes_of(self, node: _LayerNode) -> list[Shape]:
        return [tuple(s) for s in node.impl.param_shapes(
            node.lp, [self.blob_shapes[b] for b in node.bottoms])]

    @staticmethod
    def _merge_shared_mult(node: _LayerNode, owner: _LayerNode, i: int,
                           oidx: int, attr: str, label: str) -> None:
        """net.cpp AppendParam's lr_mult/decay_mult rule for a shared
        blob: the sharer's explicit value goes to the owner when the owner
        left it unset; two explicit values that differ are an error."""
        raw = f"raw_{label}"
        specs, ospecs = node.lp.param, owner.lp.param
        mine = getattr(specs[i], raw) if i < len(specs) else None
        if mine is None:
            return
        owners = getattr(ospecs[oidx], raw) if oidx < len(ospecs) else None
        if owners is None:
            mults = getattr(owner, attr)
            while len(mults) <= oidx:
                mults.append(1.0)
            mults[oidx] = mine
        elif owners != mine:
            raise ValueError(
                f"shared param {label} mismatch: layer {node.lp.name!r} "
                f"blob {i} sets {mine}, owner {owner.lp.name!r} blob {oidx} "
                f"sets {owners} (reference: net.cpp AppendParam CHECK)")

    def _resolve_sharing(self, node: _LayerNode,
                         raw_refs: dict[int, tuple[str, int]]) -> None:
        """Map each shared blob index to (owner, owner's stored position),
        checking shapes against the owner's (net.cpp AppendParam CHECKs),
        and merge the multipliers into the owner's."""
        mine = self._blob_shapes_of(node)
        node.n_blobs = len(mine)
        for i, (oname, oidx) in raw_refs.items():
            if i >= len(mine):
                continue  # a named spec beyond the layer's blob count
            owner = self._node_by_name.get(oname)
            if owner is None:
                raise ValueError(
                    f"layer {node.lp.name!r} shares param {i} with unknown "
                    f"layer {oname!r}")
            oshapes = self._blob_shapes_of(owner)
            if oidx >= len(oshapes):
                raise ValueError(
                    f"layer {node.lp.name!r} param {i} shares blob {oidx} of "
                    f"{oname!r}, which has only {len(oshapes)} blobs")
            if oshapes[oidx] != mine[i]:
                raise ValueError(
                    f"shared param shape mismatch: {node.lp.name!r} blob {i} "
                    f"{mine[i]} vs owner {oname!r} blob {oidx} "
                    f"{oshapes[oidx]} (reference: net.cpp AppendParam)")
            self._merge_shared_mult(node, owner, i, oidx, "lr_mults",
                                    "lr_mult")
            self._merge_shared_mult(node, owner, i, oidx, "decay_mults",
                                    "decay_mult")
            opos = owner.own_map.get(oidx, oidx) if owner.shared_refs else oidx
            node.shared_refs[i] = (oname, opos)
        node.own_map = {i: pos for pos, i in enumerate(
            j for j in range(len(mine)) if j not in node.shared_refs)}

    def param_shapes(self) -> dict[str, list[Shape]]:
        """Shape of every stored learnable blob, by layer name: owners'
        blobs only (the storage :meth:`init` makes)."""
        out = {}
        for node in self.nodes:
            shapes = [s for i, s in enumerate(self._blob_shapes_of(node))
                      if i not in node.shared_refs]
            if shapes:
                out[node.lp.name] = shapes
        return out

    def init(self, generator: torch.Generator | None = None, *,
             device: str | torch.device = "cuda") -> Params:
        """Create all learnable blobs with Caffe-filler init (the SetUp pass
        of reference net.cpp:73-133): f32, drawn on the CPU from
        ``generator`` (seed 0 when None), then moved to ``device``.  A
        layer that shares a blob draws it too, as Caffe's SetUp does, and
        the draw is dropped: only owners store blobs."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params: Params = {}
        for node in self.nodes:
            blobs = node.impl.init(
                generator, node.lp, [self.blob_shapes[b] for b in node.bottoms])
            own = [b.to(dev) for i, b in enumerate(blobs)
                   if i not in node.shared_refs]
            if own:
                params[node.lp.name] = own
        return params

    def node_params(self, params: Mapping[str, Sequence[torch.Tensor]],
                    node: _LayerNode) -> list[torch.Tensor]:
        """The blob list ``node`` computes with, shared blobs taken from
        their owners: the owners' own tensors, not copies."""
        if not node.shared_refs:
            return list(params.get(node.lp.name, []))
        return [params[node.lp.name][node.own_map[i]]
                if i not in node.shared_refs
                else params[node.shared_refs[i][0]][node.shared_refs[i][1]]
                for i in range(node.n_blobs)]

    def _scatter_node_params(self, params: Params, node: _LayerNode,
                             updated: Sequence[torch.Tensor]) -> None:
        """Write a node's updated blobs into ``params`` where they are
        stored, a shared blob at its owner's place; lists are replaced,
        never changed in place."""
        if not node.shared_refs:
            params[node.lp.name] = list(updated)
            return
        own = list(params.get(node.lp.name, []))
        for i, b in enumerate(updated):
            ref = node.shared_refs.get(i)
            if ref is None:
                own[node.own_map[i]] = b
            else:
                oblobs = list(params[ref[0]])
                oblobs[ref[1]] = b
                params[ref[0]] = oblobs
        if own:
            params[node.lp.name] = own

    def full_params(self, params: Mapping[str, Sequence[torch.Tensor]]
                    ) -> Params:
        """Every layer's full blob list, a sharer's shared blobs included,
        as ``Net::ToProto`` writes them into a ``.caffemodel``."""
        out = {}
        for node in self.nodes:
            blobs = self.node_params(params, node)
            if blobs:
                out[node.lp.name] = blobs
        return out

    def lr_mult_tree(self, params: Params) -> dict[str, list[float]]:
        """Per-blob lr multipliers, keyed like ``params``
        (ParamSpec.lr_mult merged over the sharers, 1 where a layer
        declares fewer specs)."""
        return self._mult_tree(params, "lr_mults")

    def decay_mult_tree(self, params: Params) -> dict[str, list[float]]:
        """Per-blob weight-decay multipliers, keyed like ``params``."""
        return self._mult_tree(params, "decay_mults")

    def _mult_tree(self, params: Params, attr: str) -> dict[str, list[float]]:
        out = {}
        for key, blobs in params.items():
            node = self._node_by_name.get(key)
            mults = getattr(node, attr) if node is not None else []
            # stored position -> blob index (storage compacts away the
            # shared blobs)
            orig = ({pos: i for i, pos in node.own_map.items()}
                    if node is not None and node.shared_refs else {})
            idxs = [orig.get(p, p) for p in range(len(blobs))]
            out[key] = [mults[i] if i < len(mults) else 1.0 for i in idxs]
        return out

    def layer_flops(self) -> list[tuple[_LayerNode, int]]:
        """(node, forward FLOPs) of every Convolution and InnerProduct
        layer: 2 FLOPs a multiply-add, at the declared shapes."""
        from ..ops.common import inner_product_geometry
        from ..ops.vision import conv_geometry
        out = []
        for node in self.nodes:
            if node.lp.type == "Convolution":
                kh, kw, *_, group, _ = conv_geometry(node.lp)
                cin = self.blob_shapes[node.bottoms[0]][1]
                out.append((node, sum(
                    2 * math.prod(self.blob_shapes[t]) * (cin // group)
                    * kh * kw for t in node.tops)))
            elif node.lp.type == "InnerProduct":
                shape = self.blob_shapes[node.bottoms[0]]
                num_output, axis, dim, _, _ = inner_product_geometry(
                    node.lp, shape)
                out.append((node, 2 * math.prod(shape[:axis]) * dim
                            * num_output))
        return out

    def forward_flops(self) -> int:
        """Multiply-add FLOPs (2 per MAC) of one forward at the declared
        shapes, counted from the Convolution and InnerProduct geometries."""
        return sum(f for _, f in self.layer_flops())

    @staticmethod
    def _cast(tensors: Sequence[torch.Tensor],
              dtype: torch.dtype) -> list[torch.Tensor]:
        """Cast floating tensors for mixed-precision compute; ints (labels,
        indices) pass through."""
        return [t.to(dtype) if t.is_floating_point() else t for t in tensors]

    def apply(self, params: Mapping[str, Sequence[torch.Tensor]],
              inputs: Mapping[str, torch.Tensor], *, train: bool = False,
              blobs: Sequence[str] | None = None,
              generator: torch.Generator | None = None,
              device: str | torch.device | None = None
              ) -> dict[str, torch.Tensor]:
        """One forward pass.  ``inputs`` binds every input blob.  Returns
        the named ``blobs`` (the net's output blobs by default) at their
        final values: an in-place top holds what its last writer wrote.
        ``generator`` is the CPU generator that train-mode Dropout and
        DummyData draw from.  ``device`` is where source layers
        (DummyData) put their tops; by default the device of the inputs,
        else of the params, else the CPU."""
        names = self.output_blobs if blobs is None else list(blobs)
        values, _, _ = self._run(
            params, inputs, train, generator, device,
            introspect=not set(names) <= set(self.output_blobs))
        return {b: values[b] for b in names}

    def apply_all(self, params: Mapping[str, Sequence[torch.Tensor]],
                  inputs: Mapping[str, torch.Tensor], *,
                  train: bool = False,
                  generator: torch.Generator
                  | Mapping[str, torch.Generator] | None = None,
                  device: str | torch.device | None = None,
                  upto: str | None = None, start: str | None = None,
                  eps: Mapping[str, torch.Tensor] | None = None
                  ) -> dict[str, torch.Tensor]:
        """One forward returning every blob, inputs included, at its final
        value (the JAX package's ``Net.apply_all``, net.py:505; the
        Solver's ``debug_info`` reads it).  ``upto`` stops after the named
        layer (pycaffe's ``forward(end=)``); ``start`` begins at it
        (``forward(start=)``), every bottom a skipped layer would have
        made then supplied in ``inputs``.  ``generator`` may map layer
        names to generators of their own, so that a ranged rerun draws
        what the full run drew (pycaffe's ranged ``backward``).  ``eps``
        maps blob names to zero perturbations added where the run last
        assigns each blob: the gradient of an output with respect to one
        is the blob's diff (pycaffe ``backward(diffs=)``)."""
        for name, which in ((upto, "upto"), (start, "start")):
            if name is not None and name not in self._node_by_name:
                raise ValueError(f"unknown layer {name!r} for {which}= "
                                 f"(layers: {self.layer_names()})")
        values, _, _ = self._run(params, inputs, train, generator, device,
                                 upto=upto, start=start, eps=eps,
                                 introspect=True)
        return values

    def forward(self, params: Mapping[str, Sequence[torch.Tensor]],
                inputs: Mapping[str, torch.Tensor], *,
                train: bool | None = None,
                generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> NetOutputs:
        """One forward pass with the loss: the net's output blobs, the
        sum of every loss top times its weight, in f32, and the params
        with every stateful layer's updated blobs written in (the same
        tensors as ``params`` elsewhere).  ``train`` defaults to whether
        the net's phase is TRAIN; ``generator`` and ``device`` as in
        :meth:`apply`."""
        if train is None:
            train = self.state.phase == Phase.TRAIN
        values, loss, new_params = self._run(params, inputs, train,
                                             generator, device)
        return NetOutputs({b: values[b] for b in self.output_blobs}, loss,
                          new_params)

    @staticmethod
    def _device_of(params, inputs) -> torch.device:
        """The device of the first input, else of the first param blob,
        else the CPU."""
        for t in inputs.values():
            return t.device
        for blobs in params.values():
            for b in blobs:
                return b.device
        return torch.device("cpu")

    def _run(self, params, inputs, train, generator, device=None, *,
             upto=None, start=None, eps=None, introspect=False):
        names = self.layer_names()
        start_i = names.index(start) if start is not None else 0
        stop_i = names.index(upto) if upto is not None else len(names) - 1
        if stop_i < start_i:
            raise ValueError(f"start={start!r} comes after upto={upto!r}")
        active = self.nodes[start_i:stop_i + 1]
        if generator is None:
            for n in active:
                if n.impl.needs_rng(n.lp, train):
                    raise ValueError(
                        f"net {self.name!r}: layer {n.lp.name!r} draws "
                        f"from a CPU torch.Generator in this mode; none "
                        f"was passed")
        if start is None:
            for name in self.input_blobs:
                if name not in inputs:
                    raise ValueError(f"missing input blob {name!r}")
        # eps goes in where the executed range last assigns each blob
        last_producer = {t: n.lp.name for n in active for t in n.tops
                         if eps and t in eps}
        # fusion on full runs only: a ranged, eps or introspected run
        # must surface every layer's real blobs
        full_run = (start is None and upto is None and not eps
                    and not introspect)
        hfuse_on = bool(self._hfuse_first) and self._hfuse_enabled
        vfuse_on = bool(self._vfuse_head)
        if not full_run and (hfuse_on or vfuse_on):
            self._note_unfused_run(
                "ranged" if (start is not None or upto is not None)
                else "eps" if eps else "introspect")
        hfuse_on = hfuse_on and full_run
        vfuse_on = vfuse_on and full_run
        dev = (torch.device(device) if device is not None
               else self._device_of(params, inputs))
        values: dict[str, torch.Tensor] = dict(inputs)
        new_params: Params = dict(params)
        loss = None
        cd = self.compute_dtype
        hstash: dict[str, torch.Tensor] = {}
        for node in active:
            if node.impl.is_input():
                continue
            if vfuse_on and node.lp.name in self._vfuse_member:
                # runs inside its chain head's block; its blob has
                # that member as its one consumer (graph/fusion.py)
                continue
            missing = [b for b in node.bottoms if b not in values]
            if missing:
                raise ValueError(
                    f"layer {node.lp.name!r} needs blobs {missing}; "
                    f"with start={start!r} every bottom made before "
                    f"the start layer must be fed in inputs")
            if vfuse_on and node.lp.name in self._vfuse_head:
                ch = self._vfuse_head[node.lp.name]
                members = [self._node_by_name[m] for m in ch.members]
                values[members[-1].tops[0]] = self._apply_fused_chain(
                    ch, members, new_params, values, cd, train)
                continue
            stateful = node.impl.has_state
            if hfuse_on and node.lp.name in self._hfuse_member:
                # its slice of the group's convolution, stashed when
                # the group's first member ran
                tops = [hstash.pop(node.lp.name)]
            elif hfuse_on and node.lp.name in self._hfuse_first:
                members = self._hfuse_first[node.lp.name]
                parts = self._apply_hfused(members, new_params, values,
                                           cd, train)
                for m, part in zip(members[1:], parts[1:]):
                    hstash[m.lp.name] = part
                tops = [parts[0]]
            else:
                p = self.node_params(new_params, node)
                bots = [values[b] for b in node.bottoms]
                if cd is not None:
                    # numerics-critical layers stay f32: losses,
                    # accuracy, BatchNorm's batch statistics
                    dtype = (torch.float32 if node.impl.is_loss()
                             or node.lp.type == "Accuracy" or stateful
                             else cd)
                    bots = self._cast(bots, dtype)
                    p = self._cast(p, dtype)
                gen = (generator.get(node.lp.name)
                       if isinstance(generator, Mapping) else generator)
                with layer_scope(node.lp.name):
                    tops = node.impl.apply(node.lp, p, bots, train, gen,
                                           **node.seam(bots))
                if stateful:
                    tops, updated = tops
                    self._scatter_node_params(new_params, node, updated)
                if not node.bottoms:
                    # a source layer (DummyData) draws its tops on the
                    # CPU
                    tops = [t.to(dev) for t in tops]
            if last_producer:
                tops = [v + eps[t]
                        if last_producer.get(t) == node.lp.name
                        else v for t, v in zip(node.tops, tops)]
            for t, v in zip(node.tops, tops):
                values[t] = v
            for w, v in zip(node.loss_weights(), tops):
                if w:
                    term = w * v.float().sum()
                    loss = term if loss is None else loss + term
        if loss is None:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
        return values, loss, new_params

    def _apply_hfused(self, members: list[_LayerNode], params, values, cd,
                      train) -> tuple[torch.Tensor, ...]:
        """One horizontal group as one convolution: the members' weights
        (and biases) concatenated along the output channels, the output
        split back, all under one ``L[a+b+...]`` scope.  Members are
        stateless convolutions that draw no random numbers."""
        head = members[0]
        mp = [self.node_params(params, m) for m in members]
        fused = [torch.cat([p[0] for p in mp], dim=0)]
        if len(mp[0]) > 1:   # bias_term, the same within a group
            fused.append(torch.cat([p[1] for p in mp], dim=0))
        bots = [values[head.bottoms[0]]]
        if cd is not None:
            bots = self._cast(bots, cd)
            fused = self._cast(fused, cd)
        with layer_scope("+".join(m.lp.name for m in members)):
            (y,) = head.impl.apply(head.lp, fused, bots, train, None,
                                   **head.seam(bots))
            return _split_channels(y, [p[0].shape[0] for p in mp])

    def _apply_fused_chain(self, ch: fusion.FusedChain,
                           members: list[_LayerNode], params, values, cd,
                           train) -> torch.Tensor:
        """One planned vertical chain as one block under one
        ``L[a+b+...]`` scope (the JAX package's ``_apply_fused_chain``).
        The head convolution and every in-block member run their own
        layer code; an LRN tail with an epilogue runs as
        ``ops.vision.lrn_chain_epilogue``, a ReLU just before it folded
        in under ``relu+lrn``."""
        head = members[0]
        x = values[head.bottoms[0]]
        p = self.node_params(params, head)
        if cd is not None:
            x = self._cast([x], cd)[0]
            p = self._cast(p, cd)
        epi = self._epilogue_tune.get(head.lp.name)

        def epilogue(y, lrn, relu):
            size, alpha, beta, k, _ = vision.lrn_geometry(lrn.lp)
            return vision.lrn_chain_epilogue(
                y, size, alpha, beta, k, relu=relu, lowering=epi.get(
                    (tuple(y.shape), y.dtype)) if epi else None)
        with layer_scope(ch.scope()):
            (y,) = head.impl.apply(head.lp, p, [x], train, None,
                                   **head.seam([x]))
            i = 1
            while i < len(members):
                m = members[i]
                nxt = members[i + 1] if i + 1 < len(members) else None
                if (ch.epilogue == "relu+lrn" and m.lp.type == "ReLU"
                        and nxt is not None and nxt.lp.type == "LRN"):
                    y = epilogue(y, nxt, True)
                    i += 2
                    continue
                if (ch.epilogue in ("lrn", "relu+lrn")
                        and m.lp.type == "LRN" and nxt is None):
                    y = epilogue(y, m, False)
                    i += 1
                    continue
                mp = self.node_params(params, m)
                if cd is not None:
                    mp = self._cast(mp, cd)
                (y,) = m.impl.apply(m.lp, mp, [y], train, None,
                                    **m.seam([y]))
                i += 1
        return y

    # -- introspection (reference: ccaffe.cpp:86-139, Net.scala:64-66) -----
    @property
    def num_layers(self) -> int:
        return len(self.nodes)

    def layer_names(self) -> list[str]:
        return [n.lp.name for n in self.nodes]

    def layer_num_weights(self, params: Params) -> dict[str, int]:
        return {k: len(v) for k, v in params.items()}


# -- WeightCollection math (reference: Net.scala:17-46) ----------------------

def weights_add(a: Params, b: Params) -> Params:
    """Blob-wise sum, WeightCollection.add (Net.scala:27-46)."""
    return {k: [x + y for x, y in zip(a[k], b[k])] for k in a}


def weights_scalar_divide(w: Params, v: float) -> Params:
    """Every blob divided by ``v``, WeightCollection.scalarDivide
    (Net.scala:17-23; in place there, a new collection here)."""
    return {k: [x / v for x in blobs] for k, blobs in w.items()}
