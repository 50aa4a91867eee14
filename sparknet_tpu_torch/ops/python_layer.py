"""User-defined ``Python`` layers (reference: caffe's PythonLayer,
caffe/include/caffe/layers/python_layer.hpp; the JAX package's
``sparknet_tpu/ops/python_layer.py``).  ``python_param {module, layer,
param_str}`` names a user class, imported from ``sys.path`` (pycaffe's
$PYTHONPATH contract) or registered with :func:`register_python_layer`.

Two protocols:

**Functional.**  The class writes its forward in torch ops; autograd
gives the backward, and the forward runs on whatever device its inputs
are on::

    class ScaleBy10:
        def setup(self, bottom_shapes, param_str): ...          # optional
        def out_shapes(self, bottom_shapes) -> list[tuple]: ...
        def forward(self, *bottoms) -> tensor | sequence: ...   # torch ops
        def init_params(self, gen, bottom_shapes) -> list: ...  # optional

``init_params`` draws its blobs from the CPU ``torch.Generator`` it is
given; ``forward`` then gets them after the bottoms.

**pycaffe-compatible.**  A class with ``setup/reshape/forward/backward``
that writes ``top[i].data`` and ``bottom[i].diff`` numpy buffers (as the
reference's examples/pycaffe/layers/pyloss.py) runs unmodified: its
blobs are numpy :class:`PyBlob` shims on the host, bridged into autograd
by a ``torch.autograd.Function``.  Its backward re-runs the user's
``forward`` (so that state the instance keeps, pyloss's ``self.diff``,
belongs to this cotangent) and then calls the user's ``backward``, as
the JAX package's custom VJP does.  Such a layer runs on the host
whatever the device, as in Caffe; its tops come back f32 on the
bottoms' device.  A user module that does ``import caffe`` needs the
``caffe`` module shim (``pycaffe_compat``), which is not ported yet
(ROADMAP A11): it raises, naming that item.

Each net gets its own instance of each user layer (``per_net_copy``),
as Caffe makes layer objects per net.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Sequence

import numpy as np
import torch

from .registry import LayerImpl, Shape, register_layer

_PROGRAMMATIC: dict[str, type] = {}


def register_python_layer(name: str, cls: type) -> None:
    """Register ``cls`` under ``python_param.layer == name``, for a class
    that no module on ``sys.path`` holds."""
    _PROGRAMMATIC[name] = cls


def _resolve(module: str, layer: str) -> type:
    # the module wins where it imports (the pycaffe contract); the
    # programmatic registry is the fallback, so a registered name never
    # shadows a real import
    try:
        mod = importlib.import_module(module)
    except ImportError as e:
        if layer in _PROGRAMMATIC:
            return _PROGRAMMATIC[layer]
        if getattr(e, "name", None) == "caffe":
            raise ImportError(
                f"Python layer module {module!r} imports caffe: the caffe "
                f"module shim (pycaffe_compat) is not ported yet (ROADMAP "
                f"A11)") from e
        raise ImportError(
            f"Python layer module {module!r} not importable (pycaffe "
            f"resolves it from $PYTHONPATH; register_python_layer() is the "
            f"programmatic alternative): {e}") from e
    try:
        return getattr(mod, layer)
    except AttributeError:
        if layer in _PROGRAMMATIC:
            return _PROGRAMMATIC[layer]
        raise AttributeError(
            f"module {module!r} has no class {layer!r}") from None


class PyBlob:
    """A numpy stand-in for a Caffe Blob as pycaffe layers see it:
    ``.data`` and ``.diff`` buffers and pycaffe's shape accessors."""

    def __init__(self, arr: np.ndarray):
        self.data = np.asarray(arr, np.float32)
        self.diff = np.zeros_like(self.data)

    def reshape(self, *dims: int) -> None:
        self.data = np.zeros(dims, np.float32)
        self.diff = np.zeros(dims, np.float32)

    @property
    def shape(self):
        return self.data.shape

    @property
    def num(self) -> int:
        return self.data.shape[0] if self.data.ndim else 1

    @property
    def channels(self) -> int:
        return self.data.shape[1] if self.data.ndim > 1 else 1

    @property
    def height(self) -> int:
        return self.data.shape[2] if self.data.ndim > 2 else 1

    @property
    def width(self) -> int:
        return self.data.shape[3] if self.data.ndim > 3 else 1

    @property
    def count(self) -> int:
        return int(self.data.size)


def _needs_args(cls: type) -> bool:
    """Whether ``cls.__init__`` requires arguments, which pycaffe never
    passes: such a class is made without calling it."""
    try:
        sig = inspect.signature(cls.__init__)
    except (TypeError, ValueError):
        return False
    return any(p.default is inspect.Parameter.empty
               and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
               for name, p in sig.parameters.items() if name != "self")


class _Binding:
    """One resolved user-layer instance and, for a pycaffe-style one, its
    host blob shims."""

    def __init__(self, lp, bottom_shapes: Sequence[Shape]):
        p = lp.sub("python_param")
        self.param_str = str(p.get("param_str", ""))
        cls = _resolve(str(p.get("module", "")), str(p.get("layer", "")))
        self.caffe_style = hasattr(cls, "reshape")
        self.inst = cls.__new__(cls) if _needs_args(cls) else cls()
        # pycaffe sets param_str as an attribute before setup
        try:
            self.inst.param_str = self.param_str
        except AttributeError:
            pass
        self.bottom_shapes = [tuple(s) for s in bottom_shapes]
        if self.caffe_style:
            self.bottoms = [PyBlob(np.zeros(s, np.float32))
                            for s in self.bottom_shapes]
            self.tops = [PyBlob(np.zeros((0,), np.float32))
                         for _ in (lp.top or [""])]
            self.inst.setup(self.bottoms, self.tops)
            self.inst.reshape(self.bottoms, self.tops)
            self.out_shapes = [tuple(t.data.shape) for t in self.tops]
        else:
            setup = getattr(self.inst, "setup", None)
            if setup is not None:
                setup(self.bottom_shapes, self.param_str)
            self.out_shapes = [tuple(s) for s in
                               self.inst.out_shapes(self.bottom_shapes)]

    def host_forward(self, *bottoms: np.ndarray) -> list[np.ndarray]:
        for blob, arr in zip(self.bottoms, bottoms):
            blob.data = np.asarray(arr, np.float32)
        self.inst.forward(self.bottoms, self.tops)
        return [np.array(t.data, np.float32) for t in self.tops]

    def host_backward(self, bottoms: Sequence[np.ndarray],
                      gtops: Sequence[np.ndarray]) -> list[np.ndarray]:
        # forward again, so that the instance's state is the one this
        # cotangent belongs to, then the top diffs down
        self.host_forward(*bottoms)
        for t, g in zip(self.tops, gtops):
            t.diff = np.asarray(g, np.float32)
        for b in self.bottoms:
            b.diff = np.zeros_like(b.data)
        self.inst.backward(self.tops, [True] * len(self.bottoms),
                           self.bottoms)
        return [np.array(b.diff, np.float32) for b in self.bottoms]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class _HostLayer(torch.autograd.Function):
    """A pycaffe-style layer under autograd: forward and backward are the
    user's, on the host."""

    @staticmethod
    def forward(ctx, binding: _Binding, *bottoms: torch.Tensor):
        dev = bottoms[0].device if bottoms else torch.device("cpu")
        ctx.binding, ctx.dev = binding, dev
        ctx.save_for_backward(*bottoms)
        return tuple(torch.from_numpy(o).to(dev)
                     for o in binding.host_forward(*map(_host, bottoms)))

    @staticmethod
    def backward(ctx, *gtops):
        bottoms = ctx.saved_tensors
        gtops = [np.zeros(s, np.float32) if g is None else _host(g)
                 for g, s in zip(gtops, ctx.binding.out_shapes)]
        grads = ctx.binding.host_backward([_host(b) for b in bottoms], gtops)
        return (None,) + tuple(torch.from_numpy(g).to(ctx.dev, b.dtype)
                               for g, b in zip(grads, bottoms))


@register_layer("Python")
class PythonLayer(LayerImpl):
    """Resolves ``python_param`` to a user class (the module docstring
    has the two protocols; reference: layer_factory.cpp's Python
    registration, python_layer.hpp)."""

    def min_bottoms(self) -> int:
        return 0

    def per_net_copy(self) -> "PythonLayer":
        # one user-layer instance per net, as Caffe makes layer objects
        # per net (net.cpp Init): a stateful layer shares nothing
        copy = PythonLayer()
        copy.type = self.type
        return copy

    def _binding(self, lp, bottom_shapes) -> _Binding:
        key = (lp.name, tuple(tuple(s) for s in bottom_shapes))
        cache = self.__dict__.setdefault("_cache", {})
        if key not in cache:
            cache[key] = _Binding(lp, bottom_shapes)
        return cache[key]

    def out_shapes(self, lp, bottom_shapes):
        return list(self._binding(lp, bottom_shapes).out_shapes)

    def init(self, gen, lp, bottom_shapes):
        b = self._binding(lp, bottom_shapes)
        init = getattr(b.inst, "init_params", None)
        if init is None or b.caffe_style:
            return []
        return [torch.as_tensor(t, dtype=torch.float32)
                for t in init(gen, b.bottom_shapes)]

    def param_shapes(self, lp, bottom_shapes):
        return [tuple(t.shape) for t in self.init(torch.Generator(), lp,
                                                  bottom_shapes)]

    def apply(self, lp, params, bottoms, train, gen=None):
        b = self._binding(lp, [tuple(x.shape) for x in bottoms])
        if b.caffe_style:
            return list(_HostLayer.apply(b, *bottoms))
        out = b.inst.forward(*bottoms, *params)
        return list(out) if isinstance(out, (list, tuple)) else [out]
