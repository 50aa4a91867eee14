"""Vision layers: Convolution, MAX Pooling, LRN.

Counterparts of the layers of ``sparknet_tpu/ops/vision.py``, with Caffe's
shape and padding semantics (reference:
caffe/src/caffe/layers/base_conv_layer.cpp shape setup,
pooling_layer.cpp:90-110 ceil-mode output sizing, lrn_layer.cpp scale
formula).  Layout is NCHW and weights are OIHW, the JAX package's
``DIMNUMS``.  Convolution goes to cuDNN through ``F.conv2d``, as the JAX
package left it to XLA.  ACROSS_CHANNELS LRN goes through the port's
hand-written kernels (``ops/cuda_kernels.py``) on every CUDA tensor: the
inference kernel without autograd, and under autograd a
``torch.autograd.Function`` whose forward and backward are the training
kernels (the JAX package's ``relu_lrn_across_channels`` custom VJP).  MAX
pooling's forward is the library max pool over explicit -inf padding (the
JAX primal ``reduce_window``); under autograd its backward is the port's
first-maximum kernel (the JAX package's ``max_pool_vmem_bwd``).
WITHIN_CHANNEL LRN and AVE/STOCHASTIC pooling are not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..proto.caffe_pb import LayerParameter
from .cuda_kernels import (lrn_across_channels, lrn_across_channels_bwd,
                           lrn_across_channels_fwd, max_pool_bwd)
from .fillers import fill_weight_bias
from .registry import LayerImpl, Shape, register_layer


def _pair(p, key: str, default: int, hkey: str | None = None,
          wkey: str | None = None):
    """Caffe's kernel/stride/pad convention: repeated `key` or `key_h`/`key_w`."""
    hkey = hkey or f"{key}_h"
    wkey = wkey or f"{key}_w"
    vals = [int(v) for v in p.get_all(key)]
    if p.has(hkey) or p.has(wkey):
        return int(p.get(hkey, default)), int(p.get(wkey, default))
    if len(vals) >= 2:
        return vals[0], vals[1]
    if len(vals) == 1:
        return vals[0], vals[0]
    return default, default


def conv_geometry(lp: LayerParameter):
    p = lp.sub("convolution_param")
    kh, kw = _pair(p, "kernel_size", 0, "kernel_h", "kernel_w")
    sh, sw = _pair(p, "stride", 1)
    ph, pw = _pair(p, "pad", 0)
    dh, dw = _pair(p, "dilation", 1)
    num_output = int(p.get("num_output", 0))
    group = int(p.get("group", 1))
    bias_term = bool(p.get("bias_term", True))
    if kh <= 0 or kw <= 0:
        raise ValueError(
            f"layer {lp.name!r}: kernel_size (or kernel_h/kernel_w) required")
    if num_output <= 0:
        raise ValueError(f"layer {lp.name!r}: num_output required")
    return kh, kw, sh, sw, ph, pw, dh, dw, num_output, group, bias_term


@register_layer("Convolution")
class ConvolutionLayer(LayerImpl):
    """2-D convolution (reference: caffe/src/caffe/layers/conv_layer.cpp;
    weight blob (out, in/group, kh, kw), out_dim = (in + 2p - ke)/s + 1 with
    ke = d*(k-1)+1, floor division)."""

    def out_shapes(self, lp: LayerParameter,
                   bottom_shapes: Sequence[Shape]) -> list[Shape]:
        n, c, h, w = bottom_shapes[0]
        kh, kw, sh, sw, ph, pw, dh, dw, num_output, _, _ = conv_geometry(lp)
        oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
        ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
        return [(n, num_output, oh, ow) for _ in lp.bottom]

    def param_shapes(self, lp, bottom_shapes):
        c = bottom_shapes[0][1]
        kh, kw, _, _, _, _, _, _, num_output, group, bias_term = \
            conv_geometry(lp)
        wshape = (num_output, c // group, kh, kw)
        return [wshape, (num_output,)] if bias_term else [wshape]

    def init(self, gen, lp, bottom_shapes):
        return fill_weight_bias(gen, lp.sub("convolution_param"),
                                self.param_shapes(lp, bottom_shapes))

    def apply(self, lp, params, bottoms, train, gen=None):
        kh, kw, sh, sw, ph, pw, dh, dw, _, group, bias_term = \
            conv_geometry(lp)
        bias = params[1] if bias_term else None
        return [F.conv2d(x, params[0], bias, stride=(sh, sw),
                         padding=(ph, pw), dilation=(dh, dw), groups=group)
                for x in bottoms]


def pool_output_size(h: int, w: int, kh: int, kw: int, sh: int, sw: int,
                     ph: int, pw: int) -> tuple[int, int]:
    """Caffe's ceil-mode pooled size with the start-inside-padding clip
    (reference: pooling_layer.cpp:90-102; sparknet_tpu/ops/vision.py:274)."""
    oh = int(math.ceil((h + 2 * ph - kh) / sh)) + 1
    ow = int(math.ceil((w + 2 * pw - kw) / sw)) + 1
    if ph or pw:
        if (oh - 1) * sh >= h + ph:
            oh -= 1
        if (ow - 1) * sw >= w + pw:
            ow -= 1
    return oh, ow


def _pool_geometry(lp: LayerParameter, bottom_shape: Shape):
    p = lp.sub("pooling_param")
    _, _, h, w = bottom_shape
    if bool(p.get("global_pooling", False)):
        kh, kw, sh, sw, ph, pw = h, w, 1, 1, 0, 0
    else:
        kh, kw = _pair(p, "kernel_size", 0, "kernel_h", "kernel_w")
        sh, sw = _pair(p, "stride", 1)
        ph, pw = _pair(p, "pad", 0)
        if kh <= 0 or kw <= 0:
            raise ValueError(
                f"layer {lp.name!r}: kernel_size (or kernel_h/kernel_w) "
                f"required unless global_pooling")
    return kh, kw, sh, sw, ph, pw, str(p.get("pool", "MAX"))


def max_pool(x: torch.Tensor, kh, kw, sh, sw, ph, pw, oh, ow) -> torch.Tensor:
    """Caffe MAX pooling: pad with -inf to exactly the extent the ceil-mode
    windows cover, ``(o-1)·s + k`` (cropping where the start-inside-padding
    clip leaves rows uncovered), then an unpadded floor-mode max pool.  The
    padding is explicit rather than ``ceil_mode``, whose clip rule is not
    Caffe's."""
    h, w = x.shape[2], x.shape[3]
    pads = (pw, max((ow - 1) * sw + kw - w - pw, 0),
            ph, max((oh - 1) * sh + kh - h - ph, 0))
    if any(pads):
        x = F.pad(x, pads, value=-math.inf)
    x = x[:, :, :(oh - 1) * sh + kh, :(ow - 1) * sw + kw]
    return F.max_pool2d(x, (kh, kw), (sh, sw))


class MaxPool(torch.autograd.Function):
    """Caffe MAX pooling whose backward is the port's first-maximum kernel
    (``cuda_kernels.max_pool_bwd``), the counterpart of the JAX package's
    ``max_pool_vmem_bwd`` (ops/pallas_kernels.py:379-405): the forward is
    :func:`max_pool`, and only ``x`` is saved; the backward re-derives
    each window's first maximum from it."""

    @staticmethod
    def forward(ctx, x, kh, kw, sh, sw, ph, pw, oh, ow):
        ctx.save_for_backward(x)
        ctx.geometry = (kh, kw, sh, sw, ph, pw, oh, ow)
        return max_pool(x, kh, kw, sh, sw, ph, pw, oh, ow)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        dx = max_pool_bwd(x.contiguous(), dy.contiguous(), *ctx.geometry)
        return (dx,) + (None,) * 8


@register_layer("Pooling")
class PoolingLayer(LayerImpl):
    """MAX pooling (reference: pooling_layer.cpp Forward_cpu MAX branch)."""

    def out_shapes(self, lp, bottom_shapes):
        n, c, h, w = bottom_shapes[0]
        kh, kw, sh, sw, ph, pw, _ = _pool_geometry(lp, bottom_shapes[0])
        return [(n, c) + pool_output_size(h, w, kh, kw, sh, sw, ph, pw)]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        kh, kw, sh, sw, ph, pw, method = _pool_geometry(lp, tuple(x.shape))
        if method != "MAX":
            raise NotImplementedError(
                f"layer {lp.name!r}: {method} pooling is not ported yet")
        oh, ow = pool_output_size(x.shape[2], x.shape[3], kh, kw, sh, sw,
                                  ph, pw)
        if torch.is_grad_enabled() and x.requires_grad:
            return [MaxPool.apply(x, kh, kw, sh, sw, ph, pw, oh, ow)]
        return [max_pool(x, kh, kw, sh, sw, ph, pw, oh, ow)]


def lrn_geometry(lp: LayerParameter):
    """(size, alpha, beta, k, region) from lrn_param."""
    p = lp.sub("lrn_param")
    return (int(p.get("local_size", 5)), float(p.get("alpha", 1.0)),
            float(p.get("beta", 0.75)), float(p.get("k", 1.0)),
            str(p.get("norm_region", "ACROSS_CHANNELS")))


class LRNAcrossChannels(torch.autograd.Function):
    """[ReLU +] ACROSS_CHANNELS LRN under autograd, the counterpart of the
    JAX package's ``relu_lrn_across_channels`` custom VJP
    (ops/pallas_kernels.py:152-171): the forward is the training kernel,
    which also writes ``scale``; it saves ``(x, scale)``, Caffe's own
    residual, and the backward is the backward kernel."""

    @staticmethod
    def forward(ctx, x, size, alpha, beta, k, relu):
        x = x.contiguous()
        y, scale = lrn_across_channels_fwd(x, size, alpha, beta, k, relu)
        ctx.save_for_backward(x, scale)
        ctx.args = (size, alpha, beta, relu)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx = lrn_across_channels_bwd(x, scale, dy.contiguous(), *ctx.args)
        return (dx,) + (None,) * 5


def relu_lrn(x: torch.Tensor, size: int, alpha: float, beta: float,
             k: float, relu: bool = False) -> torch.Tensor:
    """[ReLU +] ACROSS_CHANNELS LRN: under autograd the training kernels
    (:class:`LRNAcrossChannels`), else the inference kernel."""
    if torch.is_grad_enabled() and x.requires_grad:
        return LRNAcrossChannels.apply(x, size, alpha, beta, k, relu)
    return lrn_across_channels(x, size, alpha, beta, k, relu)


@register_layer("LRN")
class LRNLayer(LayerImpl):
    """Local response normalization (reference: lrn_layer.cpp):
    scale = k + (alpha/n)·Σ x² over a size-n channel window,
    out = x · scale^-beta — the hand-written kernels on a CUDA tensor, their
    plain versions on a CPU tensor."""

    def apply(self, lp, params, bottoms, train, gen=None):
        size, alpha, beta, k, region = lrn_geometry(lp)
        if region != "ACROSS_CHANNELS":
            raise NotImplementedError(
                f"layer {lp.name!r}: {region} LRN is not ported yet")
        return [relu_lrn(bottoms[0], size, alpha, beta, k, relu=False)]
