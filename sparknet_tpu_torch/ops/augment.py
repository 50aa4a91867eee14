"""Caffe's DataTransformer on a batch already on the device.

The port's counterpart of ``sparknet_tpu/ops/augment.py``: the host ships
raw uint8 records untouched (``records_feed(raw=True)``, or a feed
without a transform) and the transform of
caffe/src/caffe/data_transformer.cpp runs as torch ops on the batch's
own device: cast to f32, subtract the full-size mean, crop each sample
at its offsets, mirror the samples drawn for it, scale.  The op order is
the host ``DataTransformer``'s, and every op (cast, subtraction, slice,
flip, multiplication) is IEEE-exact with no two of them fused, so the
device path and the numpy one (``data/transforms.augment_batch_host``)
give the same bits at the same offsets.  ``Solver.set_augment`` puts it
in front of the step.

Randomness: ``draw_offsets`` draws on a CPU ``torch.Generator`` (the same
draws whatever the batch's device), where the JAX package splits a
traced ``jax.random`` key; the two streams cannot match, so parity with
the JAX ``apply`` is held at injected offsets.  No kernel of the port's
own: the JAX package does this in XLA with no Pallas kernel, and here a
crop is one gather and a mirror one flip.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AugmentSpec(NamedTuple):
    """The ``transform_param`` fields augmentation runs on the device.
    ``mean`` is None or an f32 array that broadcasts against one image:
    (C, 1, 1) values per channel or a full (C, H, W) mean image,
    subtracted before the crop as Caffe indexes the mean at each crop
    window (``apply`` also takes it as a tensor already on the batch's
    device, which saves the copy each call).  ``train`` selects a random
    crop and mirror, else a center crop and no mirror."""

    crop: int = 0
    mirror: bool = False
    mean: np.ndarray | None = None
    scale: float = 1.0
    train: bool = True

    @classmethod
    def from_transform_param(cls, transform_param, phase) -> "AugmentSpec":
        """From a layer's ``transform_param`` (a ``PMessage`` or a plain
        dict), the fields ``db.DataTransformer`` reads; ``mean_file``
        through ``proto/caffemodel.py``."""
        from ..proto.caffe_pb import Phase
        p = transform_param
        mean = None
        mean_file = p.get("mean_file")
        if mean_file is not None:
            from ..proto.caffemodel import load_mean_binaryproto
            mean = np.asarray(load_mean_binaryproto(str(mean_file)),
                              np.float32)
        else:
            if hasattr(p, "get_all"):      # PMessage
                mv = p.get_all("mean_value")
            else:                          # plain dict
                mv = p.get("mean_value") or []
                if not isinstance(mv, (list, tuple)):
                    mv = [mv]
            values = [float(v) for v in mv]
            if values:
                mean = np.asarray(values, np.float32).reshape(-1, 1, 1)
        return cls(crop=int(p.get("crop_size", 0)),
                   mirror=bool(p.get("mirror", False)),
                   mean=mean, scale=float(p.get("scale", 1.0)),
                   train=(phase == Phase.TRAIN))


def draw_offsets(generator: torch.Generator, n: int, h: int, w: int,
                 spec: AugmentSpec
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ys, xs, flips), int32 CPU tensors of ``n``: the one place
    augmentation draws, shared by the device and host paths.  ys, then
    xs, then flips; the test phase gives center offsets and no flips and
    draws nothing."""
    zeros = torch.zeros(n, dtype=torch.int32)
    if spec.crop and spec.train:
        ys = torch.randint(0, h - spec.crop + 1, (n,), generator=generator,
                           dtype=torch.int32)
        xs = torch.randint(0, w - spec.crop + 1, (n,), generator=generator,
                           dtype=torch.int32)
    elif spec.crop:
        ys = torch.full((n,), (h - spec.crop) // 2, dtype=torch.int32)
        xs = torch.full((n,), (w - spec.crop) // 2, dtype=torch.int32)
    else:
        ys = xs = zeros
    if spec.mirror and spec.train:
        flips = torch.randint(0, 2, (n,), generator=generator,
                              dtype=torch.int32)
    else:
        flips = zeros
    return ys, xs, flips


def apply(imgs: torch.Tensor, ys, xs, flips,
          spec: AugmentSpec) -> torch.Tensor:
    """DataTransformer over an (N, C, H, W) uint8 (or f32) batch on its
    own device: cast, full-size mean subtract, per-sample crop at
    (ys, xs), per-sample mirror where ``flips`` is 1, scale.  Returns
    f32."""
    dev = imgs.device
    x = imgs.to(torch.float32)
    if spec.mean is not None:
        mean = spec.mean
        if not isinstance(mean, torch.Tensor):
            mean = torch.from_numpy(np.array(mean, np.float32))
        x = x - mean.to(dev, torch.float32)
    n, c, h, w = x.shape
    if spec.crop:
        r = torch.arange(spec.crop, device=dev)
        rows = torch.as_tensor(ys).to(dev, torch.int64)[:, None] + r
        cols = torch.as_tensor(xs).to(dev, torch.int64)[:, None] + r
        idx = (rows[:, :, None] * w + cols[:, None, :]).reshape(n, 1, -1)
        x = x.reshape(n, c, h * w).gather(2, idx.expand(n, c, -1))
        x = x.reshape(n, c, spec.crop, spec.crop)
    if spec.mirror and spec.train:
        flip = torch.as_tensor(flips).to(dev, torch.bool)[:, None, None,
                                                          None]
        x = torch.where(flip, x.flip(-1), x)
    if spec.scale != 1.0:
        # the f32 value of scale, exactly: an f32 multiplication
        x = x * float(np.float32(spec.scale))
    return x


def augment_batch(imgs: torch.Tensor, generator: torch.Generator,
                  spec: AugmentSpec) -> torch.Tensor:
    """Draw and apply in one call, the step's entry point.  The draws
    reach the batch's device in one copy."""
    n, _c, h, w = imgs.shape
    offs = torch.stack(draw_offsets(generator, n, h, w, spec))
    if imgs.device.type != "cpu":
        offs = offs.to(imgs.device)
    return apply(imgs, offs[0], offs[1], offs[2], spec)


def out_shape(in_shape: tuple, spec: AugmentSpec) -> tuple:
    """The augmented batch's shape for an (N, C, H, W) input."""
    n, c, h, w = in_shape
    return (n, c, spec.crop, spec.crop) if spec.crop else (n, c, h, w)
