"""``caffe`` module shim: pycaffe's user-facing surface over the port
(reference: caffe/python/caffe/__init__.py + pycaffe.py).

The port's own copy of ``sparknet_tpu/pycaffe_compat.py``.  Covers what
pycaffe scripts touch:

- ``caffe.Layer`` and the phase constants: user Python layers import
  unmodified (e.g. examples/pycaffe/layers/pyloss.py).
- ``caffe.Net``: the net-surgery and inspection interface
  (reference: caffe/python/caffe/pycaffe.py): ``net.blobs`` and
  ``net.params`` as mutable ``.data``/``.diff`` numpy buffers on the host,
  ``forward(blobs, start, end)``, ``backward(diffs, start, end)`` (one
  ``torch.autograd.grad`` over ``graph/net.py::Net.apply_all``, with zero
  perturbations ``eps`` for intermediate-blob diffs; no per-layer
  Backward code), ``forward_all``/``forward_backward_all``,
  ``set_input_arrays``, ``save``/``copy_from``.
- ``caffe.get_solver`` and the per-type aliases: the port's ``Solver``
  behind one set of host mirrors shared by ``solver.net`` and every test
  net.
- ``caffe.io``, ``caffe.proto``, ``caffe.NetSpec``/``layers``/``params``,
  ``caffe.Classifier``/``Detector``/``draw``: lazily re-exported from
  their homes in the port.

Devices.  ``set_mode_gpu()`` (the default) and ``set_device(i)`` put the
nets made afterwards on ``cuda:i``; ``set_mode_cpu()`` puts them on the
CPU.  A net on the card raises without CUDA, as every entry point of the
port does; ``Net(..., device=)`` overrides the mode for one net.  (The JAX
shim's selectors are no-ops, ROADMAP C.)  Each forward uploads the host
param mirrors to the net's device and copies every blob back, so net
surgery on the mirrors takes effect at the next call, and runs in full
f32 (TF32 off).

Shapes are static: ``net.blobs['data'].reshape(...)`` and
``net.reshape()`` (the deploy batch-size idiom, _caffe.cpp:180-189,227)
rebuild shape inference for the new input shapes, one graph net per
shape, cached.  ``forward(start=..., end=...)`` reads the skipped
prefix's outputs from the current blob mirrors.  Each forward that runs
a stochastic layer draws one seed from the net's CPU ``torch.Generator``
(seeded at construction), and each such layer draws from a generator of
its own seeded from it and the layer's index, so ``backward``, ranged or
not, replays the masks the last forward drew.

Usage::

    from sparknet_tpu_torch import pycaffe_compat
    pycaffe_compat.install()     # binds sys.modules["caffe"] to this shim

after which ``import caffe`` resolves to this shim unless a ``caffe``
module is already bound or importable (that one always wins).
"""

from __future__ import annotations

import collections
import contextlib
import sys

import numpy as np
import torch

from .utils.device import full_f32, resolve_device

TRAIN = 0
TEST = 1

_random_seed: int | None = None
# the device of the nets made next: set_mode_cpu/set_mode_gpu/set_device
_mode = {"cpu": False, "device_id": 0}


def set_mode_cpu() -> None:
    """Nets made afterwards run on the CPU (reference: _caffe.cpp
    set_mode_cpu)."""
    _mode["cpu"] = True


def set_mode_gpu() -> None:
    """Nets made afterwards run on the card :func:`set_device` chose
    (cuda:0 by default); the default mode."""
    _mode["cpu"] = False


def set_device(device_id: int) -> None:
    """Choose the card of GPU mode (reference: _caffe.cpp set_device)."""
    _mode["device_id"] = int(device_id)


def _mode_device() -> str:
    return "cpu" if _mode["cpu"] else f"cuda:{_mode['device_id']}"


def set_random_seed(seed: int) -> None:
    """Seed subsequent Net constructions: filler init and the Dropout
    stream (reference: _caffe.cpp set_random_seed).  Like Caffe's global
    RNG, the stream advances at each construction: consecutive nets are
    reproducible but distinct; re-seed to replay."""
    global _random_seed
    _random_seed = int(seed)


def _next_seed() -> int:
    global _random_seed
    if _random_seed is None:
        return 0
    s = _random_seed
    _random_seed += 1  # the global stream advances per construction
    return s


def layer_type_list() -> list:
    """Registered layer type names (reference: _caffe.cpp
    layer_type_list)."""
    from .ops.registry import registered_types
    return registered_types()


class Layer:
    """Base class for user Python layers (python_layer.hpp analog).

    Subclasses override ``setup/reshape/forward/backward`` on blob lists
    whose elements expose ``.data``/``.diff`` numpy buffers
    (``ops/python_layer.PyBlob``).  ``self.param_str`` carries
    ``python_param.param_str``."""

    param_str: str = ""

    def __init__(self):
        self.blobs: list = []

    def setup(self, bottom, top):
        pass

    def reshape(self, bottom, top):
        pass

    def forward(self, bottom, top):
        raise NotImplementedError

    def backward(self, top, propagate_down, bottom):
        pass


def _pyblob_cls():
    """The one PyBlob (ops/python_layer.PyBlob), shared by ``net.blobs``
    and Python-layer bottoms and tops."""
    from .ops.python_layer import PyBlob
    return PyBlob


def __getattr__(name: str):
    """Lazy exports of the rest of the pycaffe surface."""
    if name == "PyBlob":
        return _pyblob_cls()
    if name in ("Classifier", "Detector"):
        from . import classify
        return getattr(classify, name)
    if name == "draw":
        from .tools import draw_net
        return draw_net
    if name == "io":
        from . import pycaffe_io
        return pycaffe_io
    if name == "proto":
        return _proto_module()
    if name in ("layers", "params", "NetSpec", "net_spec", "to_proto"):
        from . import pycaffe_netspec
        if name == "net_spec":
            return pycaffe_netspec
        return getattr(pycaffe_netspec, name)
    raise AttributeError(name)


class _LayerView:
    """Entry of ``net.layers`` (type + blobs)."""

    def __init__(self, type_: str, blobs: list):
        self.type = type_
        self.blobs = blobs


def _host(t: torch.Tensor) -> np.ndarray:
    """An own, writable host copy of a tensor."""
    return np.array(t.detach().cpu().numpy())


class Net:
    """pycaffe-style Net (reference: caffe/python/caffe/pycaffe.py).

    ``model`` is a prototxt path or text; ``weights`` an optional
    ``.caffemodel``/npz/HDF5 path; ``phase`` caffe.TRAIN or caffe.TEST;
    ``device`` overrides the mode the ``set_mode_*`` calls chose."""

    def __init__(self, model: str, weights: str | None = None,
                 phase: int = TEST, *, initial_params=None,
                 device: str | torch.device | None = None):
        from .graph.net import Net as GraphNet
        from .proto import NetState, Phase, load_net_prototxt

        self.device = resolve_device(device or _mode_device())
        self._train = phase == TRAIN
        net_param = load_net_prototxt(model)
        self._state = NetState(Phase.TRAIN if self._train else Phase.TEST)
        self._net = GraphNet(net_param, self._state)
        seed0 = _next_seed()
        if initial_params is not None:
            # pre-built collection (the solver's views share one init)
            params = {k: [np.asarray(torch.as_tensor(b).detach().cpu(),
                                     np.float32) for b in v]
                      for k, v in initial_params.items()}
        else:
            # full filler init even when weights are given: layers absent
            # from the file keep their filler values, as
            # Net::CopyTrainedLayersFrom over a freshly SetUp net
            params = {k: [b.numpy() for b in v] for k, v in self._net.init(
                torch.Generator().manual_seed(seed0), device="cpu").items()}
        PyBlob = _pyblob_cls()
        # host-side mutable mirrors (net surgery edits these in place)
        self.params: dict[str, list] = collections.OrderedDict(
            (k, [PyBlob(np.array(b)) for b in v]) for k, v in params.items())
        if weights:
            self.copy_from(weights)
        self.blobs: dict[str, object] = collections.OrderedDict(
            (name, PyBlob(np.zeros(shape, np.float32)))
            for name, shape in self._net.blob_shapes.items())
        self._shape_sig = tuple(sorted(
            (k, tuple(v)) for k, v in self._net.input_blobs.items()))
        self._net_cache: dict = {self._shape_sig: self._net}
        # the Dropout stream, and the seed of the most recent forward that
        # drew (backward replays it)
        self._gen = torch.Generator().manual_seed(seed0)
        self._last_seed = 0
        # DB-backed data layers self-feed on forward(), advancing their
        # cursor each call like the reference's prefetching data layers
        from .data.db import _FEEDABLE_TYPES
        self._net_param = net_param
        self._auto_feed = None
        self._feedable = any(n.lp.type in _FEEDABLE_TYPES
                             for n in self._net.nodes)
        self._memory_data = None  # set_input_arrays state
        self._memory_node = None
        self._memory_pos = 0

    # -- introspection ----------------------------------------------------
    @property
    def _layer_names(self) -> list[str]:
        return self._net.layer_names()

    def _node_pyblobs(self, node) -> list:
        """A node's blob list through shared-param refs, so shared blobs
        alias the owner's PyBlob objects."""
        if not node.shared_refs:
            return self.params.get(node.lp.name, [])
        out = []
        for i in range(node.n_blobs or 0):
            ref = node.shared_refs.get(i)
            if ref is None:
                out.append(self.params[node.lp.name][node.own_map[i]])
            else:
                out.append(self.params[ref[0]][ref[1]])
        return out

    @property
    def layers(self) -> list[_LayerView]:
        return [_LayerView(n.lp.type, self._node_pyblobs(n))
                for n in self._net.nodes]

    @property
    def inputs(self) -> list[str]:
        return list(self._net.input_blobs)

    @property
    def outputs(self) -> list[str]:
        return list(self._net.output_blobs)

    @property
    def blob_loss_weights(self):
        """{blob name: loss weight} over every blob (pycaffe.py:32;
        Net::AppendTop: explicit loss_weight, else 1 on a loss layer's
        first top, else 0)."""
        out = collections.OrderedDict(
            (b, 0.0) for b in self._net.blob_shapes)
        for n in self._net.nodes:
            for t, w in zip(n.tops, n.loss_weights()):
                out[t] = float(w)
        return out

    # -- execution --------------------------------------------------------
    def reshape(self) -> None:
        """Re-infer every blob shape after input-blob reshapes (pycaffe
        ``Net.reshape``, _caffe.cpp:227).  The deploy idiom::

            net.blobs['data'].reshape(1, 3, H, W)
            net.reshape()          # optional: forward() calls it
            net.blobs['data'].data[...] = img
            net.forward()

        Each input-shape signature gets its own graph net, cached.  A
        reshape that would change PARAM shapes is refused, as in Caffe,
        where layer weight shapes are fixed at setup."""
        from .graph.net import Net as GraphNet
        overrides = {name: tuple(self.blobs[name].data.shape)
                     for name in self._net.input_blobs}
        if all(overrides[n] == tuple(s)
               for n, s in self._net.input_blobs.items()):
            return
        sig = tuple(sorted(overrides.items()))
        new_net = self._net_cache.get(sig)
        if new_net is None:
            new_net = GraphNet(self._net_param, self._state,
                               input_overrides=overrides)
            for k, shapes in new_net.param_shapes().items():
                mine = self.params.get(k)
                if mine is not None and \
                        [b.data.shape for b in mine] != list(shapes):
                    raise ValueError(
                        f"reshape would change param shapes of layer {k!r} "
                        f"({[b.data.shape for b in mine]} -> {shapes}); "
                        f"parameter shapes are fixed at net construction")
            self._net_cache[sig] = new_net
        self._net = new_net
        self._shape_sig = sig
        PyBlob = _pyblob_cls()
        for name, shape in self._net.blob_shapes.items():
            if name in self._net.input_blobs:
                continue  # mirrors hold user data at the new shape already
            if (name not in self.blobs
                    or tuple(self.blobs[name].data.shape) != tuple(shape)):
                self.blobs[name] = PyBlob(np.zeros(shape, np.float32))

    def _upload(self, arr, requires_grad: bool = False) -> torch.Tensor:
        """A copy of a host array on the net's device, f32."""
        return torch.tensor(np.asarray(arr, np.float32), device=self.device,
                            requires_grad=requires_grad)

    def _device_params(self, requires_grad: bool = False):
        """The host mirrors uploaded to the device, every call, so that
        surgery on them takes effect."""
        return {k: [self._upload(b.data, requires_grad) for b in v]
                for k, v in self.params.items()}

    def _gather_inputs(self, kwargs) -> dict[str, np.ndarray]:
        inputs = {}
        for name, shape in self._net.input_blobs.items():
            arr = np.asarray(kwargs[name] if name in kwargs
                             else self.blobs[name].data, np.float32)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(
                    f"input {name!r} has shape {arr.shape}, net expects "
                    f"{shape} (static shapes: build the net with the "
                    f"shapes you need, or reshape the input blob first "
                    f"— net.blobs[{name!r}].reshape(...))")
            # bind an own copy of a caller's array, never the array: the
            # mirror stays apart from user data even if the forward raises
            self.blobs[name].data = (np.array(arr) if name in kwargs
                                     else arr)
            inputs[name] = self.blobs[name].data
        unknown = set(kwargs) - set(self._net.input_blobs)
        if unknown:
            raise ValueError(f"not input blobs: {sorted(unknown)}")
        return inputs

    def _range_needs_rng(self, start: str | None, end: str | None) -> bool:
        """Does [start, end] (forward order, None = net edge) hold a
        stochastic layer in this phase?"""
        names = self._layer_names
        si = names.index(start) if start is not None else 0
        ei = names.index(end) + 1 if end is not None else len(names)
        return any(n.impl.needs_rng(n.lp, self._train)
                   for n in self._net.nodes[si:ei])

    def _layer_generators(self, seed: int) -> dict[str, torch.Generator]:
        """One generator per stochastic layer, from ``seed`` and the
        layer's index: the same draws whatever range runs it."""
        return {n.lp.name: torch.Generator().manual_seed(
                    (seed * 1_000_003 + i) % 2**63)
                for i, n in enumerate(self._net.nodes)
                if n.impl.needs_rng(n.lp, self._train)}

    def _range_sets(self, start: str, end: str | None,
                    ) -> tuple[list[str], set[str]]:
        """(needed, produced) blob sets for the layers in [start, end],
        shared by ranged forward and backward.  Input-type layers run
        nothing, so their tops are needed (fed), not produced."""
        names = self._layer_names
        si = names.index(start)
        ei = names.index(end) + 1 if end is not None else len(names)
        produced: set[str] = set()
        needed: list[str] = []
        for n in self._net.nodes[si:ei]:
            if n.impl.is_input():
                for t in n.tops:
                    if t not in produced and t not in needed:
                        needed.append(t)
                continue
            for b in n.bottoms:
                if b not in produced and b not in needed:
                    needed.append(b)
            produced.update(n.tops)
        return needed, produced

    def _gather_range_inputs(self, start: str, end: str | None,
                             kwargs) -> dict[str, np.ndarray]:
        """Seed blobs for forward(start=...): every bottom consumed in
        [start, end] that the range does not produce comes from kwargs
        (copied) or the current blob mirrors."""
        needed, _ = self._range_sets(start, end)
        inputs = {}
        for b in needed:
            arr = np.asarray(kwargs[b] if b in kwargs
                             else self.blobs[b].data, np.float32)
            shape = self._net.blob_shapes[b]
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(
                    f"seed blob {b!r} has shape {arr.shape}, net expects "
                    f"{shape}")
            self.blobs[b].data = np.array(arr) if b in kwargs else arr
            inputs[b] = self.blobs[b].data
        unknown = set(kwargs) - set(needed)
        if unknown:
            raise ValueError(
                f"not consumed by layers in [{start!r}, {end!r}]: "
                f"{sorted(unknown)}")
        return inputs

    def forward(self, blobs=None, start: str | None = None,
                end: str | None = None, **kwargs):
        """Run forward; returns {output blob: data} (plus the blobs named
        in ``blobs``), filling every ``net.blobs[...].data`` on the way
        (pycaffe _Net_forward, pycaffe.py:105).  With ``start=``, layers
        before it are skipped and their outputs read from the current
        blob mirrors (or kwargs)."""
        for nm, which in ((end, "end"), (start, "start")):
            if nm is not None and nm not in self._layer_names:
                raise ValueError(
                    f"unknown layer {nm!r} for {which}= "
                    f"(layers: {self._layer_names})")
        if (start is not None and end is not None
                and self._layer_names.index(start)
                > self._layer_names.index(end)):
            raise ValueError(f"start={start!r} comes after end={end!r}")
        for b in blobs or ():
            if b not in self._net.blob_shapes:
                raise ValueError(f"unknown blob {b!r} in blobs")
        if end is not None and blobs:
            # refuse before running: blobs produced after the truncation
            # point would come back stale
            computed = set(self._net.input_blobs)
            for n in self._net.nodes:
                computed.update(n.tops)
                if n.lp.name == end:
                    break
            stale = [b for b in blobs if b not in computed]
            if stale:
                raise ValueError(
                    f"blobs {stale} are produced after end={end!r}; "
                    f"their contents would be stale — drop end= or "
                    f"request blobs computed up to it")
        self.reshape()  # honor pending input-blob reshapes
        if self._feedable and start is None:
            # data layers win over mirror contents (their Forward
            # overwrites the top blobs each call in the reference)
            if self._auto_feed is None:
                from .data.db import feed_for_net
                from .proto import Phase
                self._auto_feed = feed_for_net(
                    self._net_param,
                    Phase.TRAIN if self._train else Phase.TEST)
            kwargs = {**next(self._auto_feed), **kwargs}
        if self._memory_data is not None and start is None:
            # MemoryData: each Forward takes the next bound batch, cycling
            kwargs = {**self._next_memory_batch(), **kwargs}
        inputs = (self._gather_inputs(kwargs) if start is None
                  else self._gather_range_inputs(start, end, kwargs))
        # draw only when the range run has a stochastic layer: a ranged
        # forward past the net's dropouts must not advance the stream a
        # later ranged backward will replay
        gen = None
        if self._range_needs_rng(start, end):
            self._last_seed = int(torch.randint(
                2**62, (1,), generator=self._gen))
            gen = self._layer_generators(self._last_seed)
        with torch.no_grad(), full_f32():
            out = self._net.apply_all(
                self._device_params(),
                {k: self._upload(v) for k, v in inputs.items()},
                train=self._train, generator=gen, device=self.device,
                upto=end, start=start)
            for name, val in out.items():
                self.blobs[name].data = _host(val)
        if end is not None:
            node = next(n for n in self._net.nodes if n.lp.name == end)
            wanted = list(node.tops)
        else:
            wanted = list(self._net.output_blobs)
        for extra in blobs or []:
            if extra not in wanted:
                wanted.append(extra)
        return {k: self.blobs[k].data for k in wanted}

    def backward(self, diffs=None, start: str | None = None,
                 end: str | None = None, **kwargs):
        """Back-propagate: cotangents come from ``kwargs`` (arrays per top
        blob) or, when omitted, from the ``.diff`` mirrors of the net's
        output blobs (or of ``start``'s tops).  Fills ``.diff`` on params
        and input blobs and returns {input blob: diff, plus each blob
        named in ``diffs``} (pycaffe _Net_backward, pycaffe.py:141), as one
        ``torch.autograd.grad`` over the forward.  ``start``/``end`` bound
        the range in BACKWARD order: start is the later layer whose top
        diffs seed the pass, end the earlier layer it stops after.
        Intermediate-blob diffs named in ``diffs`` are the gradients of
        zero perturbations added where the forward last assigns each
        blob.  Stochastic layers replay the last forward's draws."""
        names = self._layer_names
        for nm, which in ((start, "start"), (end, "end")):
            if nm is not None and nm not in names:
                raise ValueError(
                    f"unknown layer {nm!r} for {which}= (layers: {names})")
        ranged = start is not None or end is not None
        if ranged:
            si = names.index(start) if start is not None else len(names) - 1
            ei = names.index(end) if end is not None else 0
            if ei > si:
                raise ValueError(
                    f"end={end!r} comes after start={start!r} (backward "
                    f"runs from start back to end)")
            fstart, fstop = names[ei], names[si]  # forward-order range
            range_inputs = self._gather_range_inputs(fstart, fstop, {})
            # strictly in-range tops: an out-of-range seed or diffs entry
            # must raise, not silently return zeros
            _, produced = self._range_sets(fstart, fstop)
        else:
            fstart = fstop = None
            range_inputs = {name: self.blobs[name].data
                            for name in self._net.input_blobs}
            produced = set(self._net.blob_shapes)

        for b in diffs or ():
            if b not in self._net.blob_shapes:
                raise ValueError(f"unknown blob {b!r} in diffs")
            if b not in produced and b not in range_inputs:
                raise ValueError(
                    f"blob {b!r} is outside the backward range "
                    f"[{end!r}, {start!r}]")
        # range-input blobs already get diffs as inputs
        extra = tuple(b for b in diffs or () if b not in range_inputs)

        seeds = dict(kwargs)
        if not seeds:
            if start is not None:
                node = next(n for n in self._net.nodes
                            if n.lp.name == start)
                seeds = {t: self.blobs[t].diff for t in node.tops}
            else:
                seeds = {k: self.blobs[k].diff
                         for k in self._net.output_blobs}
        for k in seeds:
            if k not in self._net.blob_shapes:
                raise ValueError(f"unknown top blob {k!r}")
            if k not in produced:
                raise ValueError(
                    f"seed blob {k!r} is not produced in the backward "
                    f"range [{end!r}, {start!r}]")
        seeds = {k: np.asarray(v, np.float32).reshape(
                     self._net.blob_shapes[k])
                 for k, v in seeds.items()}

        gen = (self._layer_generators(self._last_seed)
               if self._range_needs_rng(fstart, fstop) else None)
        with torch.enable_grad(), full_f32():
            p = self._device_params(requires_grad=True)
            x = {k: self._upload(v, True) for k, v in range_inputs.items()}
            eps = {b: torch.zeros(self._net.blob_shapes[b],
                                  device=self.device, requires_grad=True)
                   for b in extra}
            out = self._net.apply_all(
                p, x, train=self._train, generator=gen, device=self.device,
                eps=eps or None, start=fstart, upto=fstop)
            outs, cts = [], []
            for k, ct in seeds.items():
                if out[k].requires_grad:
                    outs.append(out[k])
                    cts.append(self._upload(ct).to(out[k].dtype))
            leaves = ([b for v in p.values() for b in v] + list(x.values())
                      + list(eps.values()))
            grads = (torch.autograd.grad(outs, leaves, cts,
                                         allow_unused=True)
                     if outs else [None] * len(leaves))
        grads = [np.zeros(tuple(t.shape), np.float32) if g is None
                 else _host(g) for g, t in zip(grads, leaves)]
        it = iter(grads)
        p_bar = {k: [next(it) for _ in v] for k, v in p.items()}
        x_bar = {k: next(it) for k in x}
        e_bar = {k: next(it) for k in eps}
        if ranged:
            # Caffe's ranged Backward leaves out-of-range param diffs
            # untouched; only layers inside [end, start] get written
            in_range = set()
            for n in self._net.nodes[ei:si + 1]:
                in_range.update(n.owner_keys())
        for lname, blobs_bar in p_bar.items():
            if ranged and lname not in in_range:
                continue
            for pb, bar in zip(self.params[lname], blobs_bar):
                pb.diff = bar
        for name, bar in x_bar.items():
            self.blobs[name].diff = bar
        result = {name: self.blobs[name].diff for name in x_bar}
        for b in extra:
            self.blobs[b].diff = e_bar[b]
            result[b] = self.blobs[b].diff
        return result

    # -- batched drivers (pycaffe.py:159-278) -----------------------------
    def _batch(self, blobs):
        """Split {name: array} into net-batch-size chunks, zero-padding
        the last (pycaffe _Net_batch)."""
        if not blobs:
            return
        num = len(next(iter(blobs.values())))
        batch_size = next(iter(self.blobs.values())).num
        remainder = num % batch_size
        for b in range(num // batch_size):
            i = b * batch_size
            yield {name: blobs[name][i:i + batch_size] for name in blobs}
        if remainder > 0:
            padded = {}
            for name in blobs:
                arr = np.asarray(blobs[name])
                padding = np.zeros((batch_size - remainder,) + arr.shape[1:],
                                   arr.dtype)
                padded[name] = np.concatenate([arr[-remainder:], padding])
            yield padded

    @staticmethod
    def _collect(acc: dict, outs: dict, scalars: set) -> None:
        """Accumulate one batch's outputs: per-sample blobs extend the
        list row-wise; scalar blobs (losses) keep one entry per chunk."""
        for out, ob in outs.items():
            arr = np.array(ob)
            if arr.ndim == 0:
                scalars.add(out)
                acc[out].append(arr)
            else:
                acc[out].extend(arr)

    def forward_all(self, blobs=None, **kwargs):
        """Forward in net-batch-size chunks over arbitrarily long inputs;
        returns {blob: stacked outputs} with the tail padding discarded
        (pycaffe _Net_forward_all).  Scalar outputs come back one value
        per chunk."""
        all_outs = {out: [] for out in set(self.outputs) | set(blobs or [])}
        scalars: set = set()
        for batch in self._batch({k: np.asarray(v)
                                  for k, v in kwargs.items()}):
            self._collect(all_outs, self.forward(blobs=blobs, **batch),
                          scalars)
        if not kwargs:  # self-feeding nets: a single batch
            self._collect(all_outs, self.forward(blobs=blobs), scalars)
        for out in all_outs:
            all_outs[out] = np.asarray(all_outs[out])
        if kwargs:
            n_in = len(next(iter(kwargs.values())))
            for out in all_outs:
                if out not in scalars and len(all_outs[out]) > n_in:
                    all_outs[out] = all_outs[out][:n_in]
        return all_outs

    def forward_backward_all(self, blobs=None, diffs=None, **kwargs):
        """Batched forward and backward (pycaffe
        _Net_forward_backward_all): forward kwargs feed input blobs,
        backward kwargs seed output-blob diffs; returns (all_outs,
        all_diffs) with the tail padding discarded."""
        import itertools

        all_outs = {out: [] for out in set(self.outputs) | set(blobs or [])}
        all_diffs = {d: [] for d in set(self.inputs) | set(diffs or [])}
        forward_batches = self._batch(
            {k: np.asarray(kwargs[k]) for k in self.inputs if k in kwargs})
        backward_batches = self._batch(
            {k: np.asarray(kwargs[k]) for k in self.outputs if k in kwargs})
        scalars: set = set()
        for fb, bb in itertools.zip_longest(forward_batches,
                                            backward_batches, fillvalue={}):
            self._collect(all_outs, self.forward(blobs=blobs, **fb),
                          scalars)
            self._collect(all_diffs, self.backward(diffs=diffs, **bb),
                          scalars)
        for out in all_outs:
            all_outs[out] = np.asarray(all_outs[out])
        for d in all_diffs:
            all_diffs[d] = np.asarray(all_diffs[d])
        if kwargs:
            n_in = len(next(iter(kwargs.values())))
            for acc in (all_outs, all_diffs):
                for k in acc:
                    if k not in scalars and len(acc[k]) > n_in:
                        acc[k] = acc[k][:n_in]
        return all_outs, all_diffs

    def set_input_arrays(self, data, labels) -> None:
        """Bind in-memory arrays to the net's MemoryData layer (pycaffe
        _Net_set_input_arrays / MemoryDataLayer::Reset: the size must
        divide into whole batches; each forward() takes the next batch,
        cycling)."""
        node = next((n for n in self._net.nodes
                     if n.lp.type == "MemoryData"), None)
        if node is None:
            raise RuntimeError(
                "set_input_arrays requires a MemoryData layer")
        data = np.asarray(data, np.float32)
        labels = np.asarray(labels, np.float32).reshape(len(data))
        bs = self._net.blob_shapes[node.tops[0]][0]
        if len(data) % bs:
            raise ValueError(
                f"sample count {len(data)} not divisible by batch size "
                f"{bs} (MemoryDataLayer::Reset)")
        self._memory_node = node
        self._memory_data = (data, labels)
        self._memory_pos = 0

    def _next_memory_batch(self) -> dict:
        d, l = self._memory_data
        bs = self._net.blob_shapes[self._memory_node.tops[0]][0]
        i = self._memory_pos
        self._memory_pos = (i + bs) % len(d)
        tops = self._memory_node.tops
        return {tops[0]: d[i:i + bs], tops[1]: l[i:i + bs]}

    # -- persistence (net surgery round trip) -----------------------------
    def save(self, path: str) -> None:
        """Write the current (possibly edited) params as a .caffemodel
        (reference: pycaffe Net.save)."""
        from .proto.caffemodel import save_caffemodel
        save_caffemodel(path, {k: [b.data for b in v]
                               for k, v in self.params.items()})

    def copy_from(self, path: str) -> None:
        """Load weights by layer name into the net
        (Net::CopyTrainedLayersFrom), into the existing PyBlob buffers so
        that held references and shared-param aliases stay live."""
        from .solvers.solver import load_weights_into
        current = {k: [torch.tensor(np.asarray(b.data, np.float32))
                       for b in v] for k, v in self.params.items()}
        params = load_weights_into(self._net, current, path)
        PyBlob = _pyblob_cls()
        for k, v in params.items():
            mine = self.params.get(k)
            if mine is not None and len(mine) == len(v):
                for pb, b in zip(mine, v):
                    arr = np.asarray(b.detach().cpu(), pb.data.dtype)
                    if pb.data.shape == arr.shape:
                        pb.data[...] = arr
                    else:  # shape changed: fresh buffers on this PyBlob
                        pb.data = np.array(arr)
                        pb.diff = np.zeros_like(pb.data)
            else:
                self.params[k] = [PyBlob(_host(b)) for b in v]


class _PySolver:
    """pycaffe's solver interface (reference: _caffe.cpp Solver bindings,
    python/caffe/test/test_solver.py): ``solver.net`` (the TRAIN view),
    ``solver.test_nets``, ``step(n)``, ``solve()``, ``iter``,
    ``snapshot``/``restore``.  One set of host mirrors backs
    ``solver.net.params`` and every test net's matching layers (Caffe's
    ShareTrainedLayersWith); surgery on them is copied into the Solver's
    device tensors before each step or solve and the trained values
    copied back after.  ``solver.net.blobs`` fill on an explicit
    ``net.forward()``."""

    def __init__(self, solver: str, *,
                 device: str | torch.device | None = None):
        import os

        from .data.db import _FEEDABLE_TYPES, feed_for_net
        from .proto import NetState, Phase, load_solver_prototxt
        from .proto.caffe_pb import resolve_solver_nets
        from .proto.textformat import serialize
        from .solvers import Solver as _Solver

        dev = resolve_device(device or _mode_device())
        sp = load_solver_prototxt(solver)
        # net:/train_net:/test_net: file references, resolved like
        # Solver::InitTrainNet/InitTestNets
        resolve_solver_nets(sp, solver if os.path.exists(solver) else ".")
        self._solver = _Solver(sp, device=dev)  # seed honors random_seed
        net_param = sp.net_param or sp.train_net_param
        text = serialize(net_param.to_pmsg())
        # one mirror set (from the Solver's initialized params), shared by
        # the train view and every test net's matching layers
        self.net = Net(text, phase=TRAIN, device=dev,
                       initial_params=self._solver.params)
        self.test_nets = []
        # dedicated test net definitions win (Solver::InitTestNets);
        # otherwise the TEST-phase view of the shared net
        test_params = list(sp.test_net_param) or (
            [net_param] if sp.test_iter else [])
        for tp in test_params:
            # each test net runs its own filler init (layers the train net
            # lacks), then matching layers share the train mirrors
            tn = Net(serialize(tp.to_pmsg()), phase=TEST, device=dev)
            for k in tn.params:
                if k in self.net.params:
                    tn.params[k] = self.net.params[k]
            self.test_nets.append(tn)
        # DB-backed nets feed themselves (the caffe_cli train path);
        # Input-declared nets train through net.forward/backward instead
        train_layers = net_param.filtered(NetState(Phase.TRAIN)).layer
        if any(lp.type in _FEEDABLE_TYPES for lp in train_layers):
            self._solver.set_train_data(feed_for_net(net_param,
                                                     Phase.TRAIN))

    @property
    def iter(self) -> int:
        return self._solver.iter

    @staticmethod
    def _copy_in(tensors, mirrors) -> None:
        with torch.no_grad():
            for t, pb in zip(tensors, mirrors):
                t.copy_(torch.from_numpy(np.asarray(pb.data, np.float32)))

    def _push(self) -> None:
        for k, v in self._solver.params.items():
            self._copy_in(v, self.net.params[k])
        # surgery on test-only layers reaches the Solver's test pass too,
        # for every test net
        for tn, extra in zip(self.test_nets, self._solver._test_extras):
            for k, v in extra.items():
                if k in tn.params:
                    self._copy_in(v, tn.params[k])

    def _pull(self) -> None:
        for k, v in self._solver.params.items():
            for pb, t in zip(self.net.params[k], v):
                pb.data[...] = _host(t)

    def step(self, n: int) -> float:
        self._push()
        loss = self._solver.step(n)
        self._pull()
        return loss

    def solve(self) -> None:
        self._push()
        self._solver.solve()
        self._pull()

    def snapshot(self) -> None:
        self._push()
        self._solver.snapshot_caffe()

    def restore(self, state_path: str) -> None:
        self._solver.restore_caffe(state_path)
        self._pull()


def get_solver(path: str) -> _PySolver:
    """caffe.get_solver: the solver type comes from the prototxt's
    ``type:`` field (the six rules of solvers/update_rules)."""
    return _PySolver(path)


# pycaffe's per-type constructors; the prototxt's type field wins
SGDSolver = NesterovSolver = AdaGradSolver = RMSPropSolver = \
    AdaDeltaSolver = AdamSolver = get_solver


def _proto_module():
    """The one ``caffe.proto`` module object (the port's ``caffe_pb2``
    inside), registered in sys.modules so that ``from caffe.proto import
    caffe_pb2`` resolves."""
    import types

    from . import pycaffe_pb2
    mod = sys.modules.get("caffe.proto")
    if mod is None or getattr(mod, "caffe_pb2", None) is not pycaffe_pb2:
        mod = types.ModuleType("caffe.proto")
        mod.caffe_pb2 = pycaffe_pb2
        sys.modules["caffe.proto"] = mod
        sys.modules["caffe.proto.caffe_pb2"] = pycaffe_pb2
    return mod


def install() -> None:
    """Make ``import caffe`` resolve to this shim if no other ``caffe``
    is bound or importable.  Idempotent; never shadows a real caffe."""
    if "caffe" in sys.modules:
        if sys.modules["caffe"] is sys.modules[__name__]:
            _proto_module()  # ensure submodule imports resolve
        return
    try:
        import importlib.util
        if importlib.util.find_spec("caffe") is not None:
            return
    except (ImportError, ValueError):
        pass
    sys.modules["caffe"] = sys.modules[__name__]
    _proto_module()


_BOUND_NAMES = ("caffe", "caffe.proto", "caffe.proto.caffe_pb2")


@contextlib.contextmanager
def bound_as_caffe():
    """``import caffe`` resolves to this shim inside the scope, unless a
    real caffe (a module of that name) is bound or importable; whatever
    was bound under the names before (another package's shim, or
    nothing) is bound again after.  A user Python layer's module is
    imported inside it, so that its ``caffe.Layer`` is this shim's."""
    import importlib.util
    bound = sys.modules.get("caffe")
    if bound is sys.modules[__name__] or (
            bound is not None and bound.__name__ == "caffe"):
        yield
        return
    if bound is None:
        try:
            if importlib.util.find_spec("caffe") is not None:
                yield
                return
        except (ImportError, ValueError):
            pass
    saved = {k: sys.modules.get(k) for k in _BOUND_NAMES}
    sys.modules["caffe"] = sys.modules[__name__]
    _proto_module()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
