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
``utils/trace_tables.py`` reads to charge device time to layers.  Not
ported yet: cross-layer param sharing, horizontal and vertical fusion and
the lowering tuner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

from .. import ops  # noqa: F401  (registers the layer implementations)
from ..ops.registry import LayerImpl, Shape, get_layer_impl
from ..proto.caffe_pb import LayerParameter, NetParameter, NetState, Phase
from ..utils.device import resolve_device
from ..utils.profiling import layer_scope

Params = dict[str, list[torch.Tensor]]


@dataclasses.dataclass
class NetOutputs:
    """Result of one forward pass."""

    blobs: dict[str, torch.Tensor]   # the net's output blobs
    loss: torch.Tensor               # sum of loss_weight x top, f32


class _LayerNode:
    __slots__ = ("lp", "impl", "bottoms", "tops")

    def __init__(self, lp: LayerParameter, impl: LayerImpl,
                 bottoms: list[str], tops: list[str]):
        self.lp = lp
        self.impl = impl
        self.bottoms = bottoms
        self.tops = tops

    def loss_weights(self) -> list[float]:
        """Per-top loss weights, Layer::SetLossWeights: the explicit
        ``loss_weight``s, else 1 on a loss layer's first top."""
        weights = list(self.lp.loss_weight)
        if not weights and self.impl.is_loss():
            weights = [1.0] + [0.0] * (len(self.tops) - 1)
        return weights


class Net:
    """A phase-filtered, shape-inferred, executable network."""

    def __init__(self, net_param: NetParameter,
                 state: NetState | None = None, *,
                 compute_dtype: torch.dtype | None = None):
        state = state or net_param.state or NetState()
        self.state = state
        self.param = net_param.filtered(state)
        self.name = net_param.name
        self.compute_dtype = compute_dtype
        self.nodes: list[_LayerNode] = []
        self.blob_shapes: dict[str, Shape] = {}
        self.input_blobs: dict[str, Shape] = {}

        # net-level input declarations (legacy `input:` + `input_shape:`)
        for i, name in enumerate(self.param.input):
            shape = tuple(self.param.input_shape[i].dim)
            self.blob_shapes[name] = shape
            self.input_blobs[name] = shape

        for lp in self.param.layer:
            if any(ps.name for ps in lp.param):
                raise NotImplementedError(
                    f"layer {lp.name!r}: shared params (ParamSpec.name) are "
                    f"not ported yet (ROADMAP A3)")
            impl = get_layer_impl(lp.type)
            for b in lp.bottom:
                if b not in self.blob_shapes:
                    raise ValueError(
                        f"layer {lp.name!r} bottom {b!r} unknown "
                        f"(known: {sorted(self.blob_shapes)})")
            oshapes = impl.out_shapes(
                lp, [self.blob_shapes[b] for b in lp.bottom])
            tops = list(lp.top) or ([lp.name] if oshapes else [])
            while len(tops) < len(oshapes):
                tops.append(f"{lp.name}_top{len(tops)}")
            for t, s in zip(tops, oshapes):
                self.blob_shapes[t] = tuple(int(d) for d in s)
                if impl.is_input():
                    self.input_blobs[t] = self.blob_shapes[t]
            self.nodes.append(_LayerNode(lp, impl, list(lp.bottom), tops))

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

    def param_shapes(self) -> dict[str, list[Shape]]:
        """Shape of every learnable blob, by layer name."""
        out = {}
        for node in self.nodes:
            shapes = node.impl.param_shapes(
                node.lp, [self.blob_shapes[b] for b in node.bottoms])
            if shapes:
                out[node.lp.name] = [tuple(s) for s in shapes]
        return out

    def init(self, generator: torch.Generator | None = None, *,
             device: str | torch.device = "cuda") -> Params:
        """Create all learnable blobs with Caffe-filler init (the SetUp pass
        of reference net.cpp:73-133): f32, drawn on the CPU from
        ``generator`` (seed 0 when None), then moved to ``device``."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params: Params = {}
        for node in self.nodes:
            blobs = node.impl.init(
                generator, node.lp, [self.blob_shapes[b] for b in node.bottoms])
            if blobs:
                params[node.lp.name] = [b.to(dev) for b in blobs]
        return params

    def lr_mult_tree(self, params: Params) -> dict[str, list[float]]:
        """Per-blob lr multipliers, keyed like ``params``
        (ParamSpec.lr_mult, 1 where a layer declares fewer specs)."""
        return self._mult_tree(params, "lr_mult")

    def decay_mult_tree(self, params: Params) -> dict[str, list[float]]:
        """Per-blob weight-decay multipliers, keyed like ``params``."""
        return self._mult_tree(params, "decay_mult")

    def _mult_tree(self, params: Params, attr: str) -> dict[str, list[float]]:
        specs = {node.lp.name: node.lp.param for node in self.nodes}
        return {key: [getattr(specs[key][i], attr)
                      if i < len(specs.get(key, ())) else 1.0
                      for i in range(len(blobs))]
                for key, blobs in params.items()}

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
        values, _ = self._run(params, inputs, train, generator, device)
        return {b: values[b] for b in (self.output_blobs if blobs is None
                                       else blobs)}

    def apply_all(self, params: Mapping[str, Sequence[torch.Tensor]],
                  inputs: Mapping[str, torch.Tensor], *,
                  train: bool = False,
                  generator: torch.Generator | None = None,
                  device: str | torch.device | None = None
                  ) -> dict[str, torch.Tensor]:
        """One forward returning every blob, inputs included, at its final
        value (the JAX package's ``Net.apply_all``, net.py:505, without
        its ``upto``/``start``/``eps`` options; the Solver's
        ``debug_info`` reads it)."""
        values, _ = self._run(params, inputs, train, generator, device)
        return values

    def forward(self, params: Mapping[str, Sequence[torch.Tensor]],
                inputs: Mapping[str, torch.Tensor], *,
                train: bool | None = None,
                generator: torch.Generator | None = None,
                device: str | torch.device | None = None) -> NetOutputs:
        """One forward pass with the loss: the net's output blobs and the
        sum of every loss top times its weight, in f32.  ``train``
        defaults to whether the net's phase is TRAIN; ``generator`` and
        ``device`` as in :meth:`apply`."""
        if train is None:
            train = self.state.phase == Phase.TRAIN
        values, loss = self._run(params, inputs, train, generator, device)
        return NetOutputs({b: values[b] for b in self.output_blobs}, loss)

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

    def _run(self, params, inputs, train, generator, device=None):
        for name in self.input_blobs:
            if name not in inputs:
                raise ValueError(f"missing input blob {name!r}")
        dev = (torch.device(device) if device is not None
               else self._device_of(params, inputs))
        values: dict[str, torch.Tensor] = dict(inputs)
        loss = None
        cd = self.compute_dtype
        for node in self.nodes:
            if node.impl.is_input():
                continue
            p = list(params.get(node.lp.name, []))
            bots = [values[b] for b in node.bottoms]
            if cd is not None:
                # numerics-critical loss and accuracy layers stay f32
                dtype = (torch.float32 if node.impl.is_loss()
                         or node.lp.type == "Accuracy" else cd)
                bots = self._cast(bots, dtype)
                p = self._cast(p, dtype)
            with layer_scope(node.lp.name):
                tops = node.impl.apply(node.lp, p, bots, train, generator)
            if not node.bottoms:
                # a source layer (DummyData) draws its tops on the CPU
                tops = [t.to(dev) for t in tops]
            for t, v in zip(node.tops, tops):
                values[t] = v
            for w, v in zip(node.loss_weights(), tops):
                if w:
                    term = w * v.float().sum()
                    loss = term if loss is None else loss + term
        if loss is None:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
        return values, loss
