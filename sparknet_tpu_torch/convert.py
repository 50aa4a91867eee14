"""Weights carried across from the JAX package.

The JAX package keeps params as ``{layer name: [blobs...]}`` of arrays in
Caffe's layouts (conv OIHW, InnerProduct (out, in)), and so does the port:
carrying them across is a per-blob copy, checked against the shapes the
port's net expects.  Under shared params (``ParamSpec.name``) both keep
the owners' blobs only, compacted (a layer that shares every blob has no
entry), so the JAX ``Net.init`` layout is the port's
``Net.param_shapes()``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .graph.net import Net, Params
from .utils.device import resolve_device


def params_from_jax(params: Mapping[str, Sequence[np.ndarray]], net: Net,
                    *, device: str | torch.device = "cuda",
                    drop_extra: bool = False) -> Params:
    """``{layer: [np.ndarray, ...]}`` (e.g. ``jax.device_get`` of a JAX
    ``Net.init`` result) -> the port's params for ``net``, f32 on
    ``device``.  Raises on a missing or mis-shaped blob, and on a layer
    ``net`` lacks unless ``drop_extra``: then such layers are dropped by
    name, as ``Net::CopyTrainedLayersFrom`` ignores them — the way train
    weights (GoogLeNet's TRAIN-only auxiliary heads) go into a TEST or
    deploy net."""
    dev = resolve_device(device)
    want = net.param_shapes()
    missing = set(want) - set(params)
    extra = set(params) - set(want)
    if missing or (extra and not drop_extra):
        raise ValueError(f"layers differ: missing {sorted(missing)}, "
                         f"extra {sorted(extra)}")
    out: Params = {}
    for name, shapes in want.items():
        blobs = [np.asarray(b, np.float32) for b in params[name]]
        got = [b.shape for b in blobs]
        if got != shapes:
            raise ValueError(f"layer {name!r}: blob shapes {got} != the "
                             f"net's {shapes}")
        out[name] = [torch.from_numpy(b.copy()).to(dev) for b in blobs]
    return out
