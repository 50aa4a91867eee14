"""Vision layers: Convolution, Deconvolution, Pooling, LRN, Im2col and
SPP.

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
first-maximum kernel (the JAX package's ``max_pool_vmem_bwd``).  AVE
pooling and WITHIN_CHANNEL LRN are library work, as the JAX package left
them to XLA: a zero-padded window sum over Caffe's clipped divisor, under
autograd.  STOCHASTIC pooling samples each window's element in
proportion to its value at train (the uniform drawn on the CPU generator
and uploaded, as Dropout's mask is) and takes Σx²/Σx at test.
Deconvolution is ``F.conv_transpose2d`` (cuDNN): Caffe's weight blob
(C_in, C_out/group, kh, kw) is already its layout.  Im2col is
``F.unfold``, whose rows are channel-major (C, kh, kw) as the JAX
package's ``conv_general_dilated_patches``; SPP pools each level with
the MAX pool above (its backward the kernel) or the AVE pool.

Convolution, MAX pooling and ACROSS_CHANNELS LRN take a lowering from
the tuner (``graph/tuner.py``): the one their Net resolved at
construction (``lowering=``), or for a layer called on its own what
``SPARKNET_TUNE``'s table names.  A lowering the layer does not know,
one the geometry cannot take, or on a CUDA tensor one that takes a hand
kernel off the path, is refused with an error.  A fused conv chain's
[ReLU +] LRN tail runs through :func:`lrn_chain_epilogue`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..proto.caffe_pb import LayerParameter
from .cuda_kernels import (lrn_across_channels, lrn_across_channels_bwd,
                           lrn_across_channels_fwd,
                           lrn_across_channels_reference, max_pool_bwd)
from .fillers import fill_weight_bias
from .registry import LayerImpl, Shape, register_layer


# a seam's ``lowering`` when no Net passed one: read SPARKNET_TUNE now
CONSULT = object()


def _lowering(op: str, x: torch.Tensor, lowering, extra) -> str | None:
    """The lowering a seam runs: ``lowering`` as its Net resolved it, or
    under :data:`CONSULT` what the active table names at ``extra()``;
    None is the built-in one.  On a CUDA tensor an ``off_kernel``
    candidate is refused."""
    from ..graph import tuner
    if lowering is CONSULT:
        lowering = tuner.resolve_lowering(op, x.shape, x.dtype,
                                          extra=extra())
    if lowering is not None and x.is_cuda:
        tuner.refuse_off_kernel(op, lowering, "layer seam")
    return lowering


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


def s2d_geometry_ok(c_in: int, kh, kw, sh, sw, ph, pw, dh, dw,
                    group) -> bool:
    """Where the space-to-depth rewrite applies (the JAX package's
    ``_s2d_geometry_ok``, vision.py:63)."""
    return (group == 1 and dh == 1 and dw == 1 and c_in * sh * sw <= 64
            and (sh > 1 or sw > 1) and kh >= sh and kw >= sw)


def space_to_depth_conv(x: torch.Tensor, weight: torch.Tensor, kh, kw, sh,
                        sw, ph, pw) -> torch.Tensor:
    """A stride-s convolution as a stride-1 convolution on input whose
    s x s stride phases are folded into channels (the JAX package's
    ``_space_to_depth_conv``): the kernel zero-padded up to a stride
    multiple, the input padded or clipped to exactly the extent the
    windows read.  Equal up to summation order."""
    n, c, h, w = x.shape
    o = weight.shape[0]
    kph, kpw = -kh % sh, -kw % sw
    keh, kew = kh + kph, kw + kpw
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    hi_h = (oh - 1) * sh + keh - h - ph
    hi_w = (ow - 1) * sw + kew - w - pw
    # F.pad takes negative widths as crops
    x = F.pad(x, (pw, hi_w, ph, hi_h))
    hp, wp = x.shape[2], x.shape[3]
    x = x.reshape(n, c, hp // sh, sh, wp // sw, sw).permute(
        0, 1, 3, 5, 2, 4).reshape(n, c * sh * sw, hp // sh, wp // sw)
    weight = F.pad(weight, (0, kpw, 0, kph))
    weight = weight.reshape(o, c, keh // sh, sh, kew // sw, sw).permute(
        0, 1, 3, 5, 2, 4).reshape(o, c * sh * sw, keh // sh, kew // sw)
    return F.conv2d(x, weight)


def im2col_conv(x: torch.Tensor, weight: torch.Tensor, kh, kw, sh, sw, ph,
                pw, dh, dw, group) -> torch.Tensor:
    """Convolution as explicit patches and a grouped matrix product
    (Caffe's im2col + GEMM, the JAX package's ``_im2col_conv``).  The
    patch rows are channel-major, so a group's input channels are one
    contiguous block."""
    n, c, h, w = x.shape
    o = weight.shape[0]
    oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    patches = F.unfold(x, (kh, kw), dilation=(dh, dw), padding=(ph, pw),
                       stride=(sh, sw))
    pg = patches.reshape(n, group, (c // group) * kh * kw, oh * ow)
    wg = weight.reshape(group, o // group, (c // group) * kh * kw)
    return torch.matmul(wg, pg).reshape(n, o, oh, ow)


def conv_lowering(x: torch.Tensor, weight: torch.Tensor, bias, kh, kw, sh,
                  sw, ph, pw, dh, dw, group,
                  choice: str | None) -> torch.Tensor:
    """One convolution through the tuner's lowering (None: the default,
    ``F.conv2d``).  A table naming s2d at a geometry the rewrite cannot
    express, or an unknown lowering, is a drifted table: refused."""
    if choice in (None, "native"):
        return F.conv2d(x, weight, bias, stride=(sh, sw), padding=(ph, pw),
                        dilation=(dh, dw), groups=group)
    if choice == "s2d":
        if not s2d_geometry_ok(x.shape[1], kh, kw, sh, sw, ph, pw, dh, dw,
                               group):
            raise ValueError(
                "tuning table selects s2d for a geometry the rewrite "
                "cannot express — drifted table, re-run tools/tune.py run")
        y = space_to_depth_conv(x, weight, kh, kw, sh, sw, ph, pw)
    elif choice == "im2col":
        y = im2col_conv(x, weight, kh, kw, sh, sw, ph, pw, dh, dw, group)
    else:
        raise ValueError(f"tuning table selects unknown conv lowering "
                         f"{choice!r} — drifted table")
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


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

    def apply(self, lp, params, bottoms, train, gen=None,
              lowering=CONSULT):
        from ..graph import tuner
        kh, kw, sh, sw, ph, pw, dh, dw, num_output, group, bias_term = \
            conv_geometry(lp)
        bias = params[1] if bias_term else None

        def extra():
            return tuner.conv_extra(kh, kw, sh, sw, ph, pw, dh, dw,
                                    num_output, group)
        return [conv_lowering(x, params[0], bias, kh, kw, sh, sw, ph, pw,
                              dh, dw, group,
                              _lowering("conv", x, lowering, extra))
                for x in bottoms]


@register_layer("Deconvolution")
class DeconvolutionLayer(LayerImpl):
    """Transposed convolution (deconv_layer.cpp): weight blob (C_in,
    C_out/group, kh, kw), out = s·(in − 1) + ke − 2p with ke = d·(k − 1)
    + 1; ``F.conv_transpose2d`` (cuDNN), whose weight layout that is.
    The JAX package computes it as a forward convolution, hence its flip
    and regrouping of the weight; the product is a library call in
    both."""

    def out_shapes(self, lp, bottom_shapes):
        n, _, h, w = bottom_shapes[0]
        kh, kw, sh, sw, ph, pw, dh, dw, num_output, _, _ = conv_geometry(lp)
        oh = sh * (h - 1) + dh * (kh - 1) + 1 - 2 * ph
        ow = sw * (w - 1) + dw * (kw - 1) + 1 - 2 * pw
        return [(n, num_output, oh, ow) for _ in lp.bottom]

    def param_shapes(self, lp, bottom_shapes):
        c = bottom_shapes[0][1]
        kh, kw, _, _, _, _, _, _, num_output, group, bias_term = \
            conv_geometry(lp)
        wshape = (c, num_output // group, kh, kw)
        return [wshape, (num_output,)] if bias_term else [wshape]

    def init(self, gen, lp, bottom_shapes):
        return fill_weight_bias(gen, lp.sub("convolution_param"),
                                self.param_shapes(lp, bottom_shapes))

    def apply(self, lp, params, bottoms, train, gen=None):
        kh, kw, sh, sw, ph, pw, dh, dw, _, group, bias_term = \
            conv_geometry(lp)
        bias = params[1] if bias_term else None
        return [F.conv_transpose2d(x, params[0], bias, stride=(sh, sw),
                                   padding=(ph, pw), groups=group,
                                   dilation=(dh, dw))
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
    pads = _pool_pads(x.shape[2], x.shape[3], kh, kw, sh, sw, ph, pw, oh, ow)
    if any(pads):
        x = F.pad(x, pads, value=-math.inf)
    x = x[:, :, :(oh - 1) * sh + kh, :(ow - 1) * sw + kw]
    return F.max_pool2d(x, (kh, kw), (sh, sw))


def _pool_pads(h: int, w: int, kh, kw, sh, sw, ph, pw, oh, ow):
    """``F.pad`` widths that extend an (h, w) plane to exactly what the
    ceil-mode windows cover, ``(o-1)·s + k`` (a negative high side, where
    the start-inside-padding clip leaves rows uncovered, is cropped by the
    caller)."""
    return (pw, max((ow - 1) * sw + kw - w - pw, 0),
            ph, max((oh - 1) * sh + kh - h - ph, 0))


def ave_pool(x: torch.Tensor, kh, kw, sh, sw, ph, pw, oh, ow) -> torch.Tensor:
    """Caffe AVE pooling (pooling_layer.cpp Forward_cpu AVE branch;
    sparknet_tpu/ops/vision.py:347-367): zero-pad, sum each window, divide
    by the window clipped to the padded extent [0, dim + pad): neither the
    kernel area nor the valid area.  The sum is the library's
    ``avg_pool2d`` with a divisor of 1 over the explicit padding; the
    divisor map is f32, so a bf16 sum comes out f32, as ``s / denom``
    promotes it in the JAX package (the next layer's cast takes it back)."""
    h, w = x.shape[2], x.shape[3]
    pads = _pool_pads(h, w, kh, kw, sh, sw, ph, pw, oh, ow)
    if any(pads):
        x = F.pad(x, pads)
    x = x[:, :, :(oh - 1) * sh + kh, :(ow - 1) * sw + kw]
    s = F.avg_pool2d(x, (kh, kw), (sh, sw), divisor_override=1)

    def counts(dim: int, k: int, stride: int, pad: int, out: int):
        # made on the tensor's device: a copy up from the host would wait
        # for the stream at every call
        starts = torch.arange(out, device=s.device,
                              dtype=torch.float32) * stride - pad
        return (starts + k).clamp(max=dim + pad) - starts

    return s / torch.outer(counts(h, kh, sh, ph, oh),
                           counts(w, kw, sw, pw, ow))


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


def max_pool_layer(x: torch.Tensor, kh, kw, sh, sw, ph, pw, oh,
                   ow) -> torch.Tensor:
    """MAX pooling as a layer runs it: under autograd :class:`MaxPool`,
    whose backward is the kernel, else :func:`max_pool`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPool.apply(x, kh, kw, sh, sw, ph, pw, oh, ow)
    return max_pool(x, kh, kw, sh, sw, ph, pw, oh, ow)


def patches_pool_ok(h, w, kh, kw, sh, sw, ph, pw) -> bool:
    """Where the patches MAX pool is exact (the JAX package's
    ``_patches_pool_ok``): no padding (unfold pads with 0, not -inf) and
    no ceil-mode remainder."""
    return (ph == 0 and pw == 0 and kh <= h and kw <= w
            and (h - kh) % sh == 0 and (w - kw) % sw == 0)


def max_pool_patches(x: torch.Tensor, kh, kw, sh, sw, oh,
                     ow) -> torch.Tensor:
    """MAX pooling as patches, argmax and a gather (the JAX package's
    ``max_pool_patches``) on :func:`patches_pool_ok`'s geometries: max is
    association-free, so the forward equals :func:`max_pool` bit for
    bit, and the gather routes the gradient to each window's first
    maximum."""
    n, c = x.shape[:2]
    p = F.unfold(x, (kh, kw), stride=(sh, sw)).reshape(n, c, kh * kw, oh,
                                                       ow)
    idx = p.detach().argmax(dim=2, keepdim=True)
    return torch.gather(p, 2, idx)[:, :, 0]


def stochastic_pool_train(x: torch.Tensor, kh, kw, sh, sw, ph, pw, oh, ow,
                          u: torch.Tensor) -> torch.Tensor:
    """Train-mode STOCHASTIC pooling (pooling_layer.cu StoPoolForwardTrain;
    sparknet_tpu/ops/vision.py:370-390): in each window, the first element
    whose running sum exceeds ``u``·Σwindow, ``u`` (N, C, oh, ow) uniform
    in [0, 1); the gradient goes to that element alone.  The windows are
    ``F.unfold``'s over the zero padding that ``max_pool`` pads with -inf
    (``F.unfold`` pads both sides alike, so the high side is padded here).
    An all-zero window gives 0, its gradient to its first element.  The
    running sums and the threshold are f32 whatever the input's dtype: a
    bf16 cumsum rounds differently on the card and on the CPU, and would
    sample another element there."""
    n, c = x.shape[:2]
    pads = _pool_pads(x.shape[2], x.shape[3], kh, kw, sh, sw, ph, pw, oh, ow)
    if any(pads):
        x = F.pad(x, pads)
    x = x[:, :, :(oh - 1) * sh + kh, :(ow - 1) * sw + kw]
    p = F.unfold(x, (kh, kw), stride=(sh, sw)).reshape(n, c, kh * kw, oh, ow)
    cs = torch.cumsum(p.detach().float(), dim=2)
    thres = u.float().reshape(n, c, 1, oh, ow) * cs[:, :, -1:]
    idx = (cs > thres).to(torch.uint8).argmax(dim=2, keepdim=True)
    return torch.gather(p, 2, idx)[:, :, 0]


def stochastic_pool_test(x: torch.Tensor, kh, kw, sh, sw, ph, pw, oh,
                         ow) -> torch.Tensor:
    """Test-mode STOCHASTIC pooling (StoPoolForwardTest): Σx²/Σx over each
    window, a zero denominator taken as 1."""
    num = ave_pool(x * x, kh, kw, sh, sw, ph, pw, oh, ow)
    den = ave_pool(x, kh, kw, sh, sw, ph, pw, oh, ow)
    return num / torch.where(den == 0, torch.ones_like(den), den)


@register_layer("Pooling")
class PoolingLayer(LayerImpl):
    """MAX, AVE and STOCHASTIC pooling (reference: pooling_layer.cpp
    Forward_cpu, pooling_layer.cu StoPoolForwardTrain/Test)."""

    def needs_rng(self, lp, train: bool = True) -> bool:
        return train and str(
            lp.sub("pooling_param").get("pool", "MAX")) == "STOCHASTIC"

    def out_shapes(self, lp, bottom_shapes):
        n, c, h, w = bottom_shapes[0]
        kh, kw, sh, sw, ph, pw, _ = _pool_geometry(lp, bottom_shapes[0])
        return [(n, c) + pool_output_size(h, w, kh, kw, sh, sw, ph, pw)]

    def apply(self, lp, params, bottoms, train, gen=None,
              lowering=CONSULT):
        x = bottoms[0]
        kh, kw, sh, sw, ph, pw, method = _pool_geometry(lp, tuple(x.shape))
        oh, ow = pool_output_size(x.shape[2], x.shape[3], kh, kw, sh, sw,
                                  ph, pw)
        if method == "AVE":
            return [ave_pool(x, kh, kw, sh, sw, ph, pw, oh, ow)]
        if method == "MAX":
            from ..graph import tuner
            choice = _lowering("pool", x, lowering, lambda: tuner.pool_extra(
                kh, kw, sh, sw, ph, pw))
            if choice == "patches_max":
                if not patches_pool_ok(x.shape[2], x.shape[3], kh, kw, sh,
                                       sw, ph, pw):
                    raise ValueError(
                        "tuning table selects patches_max for a padded/"
                        "remainder pool geometry it cannot express "
                        "exactly — drifted table, re-run tools/tune.py")
                return [max_pool_patches(x, kh, kw, sh, sw, oh, ow)]
            if choice not in (None, "cuda_bwd"):
                raise ValueError(f"tuning table selects unknown pool "
                                 f"lowering {choice!r} — drifted table")
            return [max_pool_layer(x, kh, kw, sh, sw, ph, pw, oh, ow)]
        if method != "STOCHASTIC":
            raise ValueError(f"unknown pool method {method!r}")
        if not train:
            return [stochastic_pool_test(x, kh, kw, sh, sw, ph, pw, oh, ow)]
        if gen is None:
            raise NotImplementedError(
                f"layer {lp.name!r}: train-mode STOCHASTIC pooling draws "
                f"from a CPU torch.Generator; none was passed")
        u = torch.rand((x.shape[0], x.shape[1], oh, ow), generator=gen).to(
            x.device, non_blocking=True)
        return [stochastic_pool_train(x, kh, kw, sh, sw, ph, pw, oh, ow, u)]


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
    return lrn_across_channels(x.contiguous(), size, alpha, beta, k, relu)


def lrn_cumsum(x: torch.Tensor, size: int, alpha: float, beta: float,
               k: float) -> torch.Tensor:
    """ACROSS_CHANNELS LRN with the window sum as a difference of channel
    prefix sums in f32 (the JAX package's ``lrn_window_sum`` with
    ``use_cumsum``): O(C) reads an element, equal to the shifted-add sum
    up to association.  A tuner candidate; autograd backward."""
    c = x.shape[1]
    pre = (size - 1) // 2
    post = size - 1 - pre
    xf = x.float()
    cs = F.pad(torch.cumsum(xf * xf, dim=1), (0, 0, 0, 0, 1, 0))
    hi = torch.clamp(torch.arange(c, device=x.device) + post + 1, max=c)
    lo = torch.clamp(torch.arange(c, device=x.device) - pre, min=0)
    ssum = cs.index_select(1, hi) - cs.index_select(1, lo)
    return (xf * (k + (alpha / size) * ssum).pow(-beta)).to(x.dtype)


def lrn_chain_epilogue(x: torch.Tensor, size: int, alpha: float, beta: float,
                       k: float, *, relu: bool,
                       lowering=CONSULT) -> torch.Tensor:
    """A fused conv chain's tail: [ReLU +] ACROSS_CHANNELS LRN in one
    pass over the producer's output (the JAX package's
    ``lrn_chain_epilogue``, vision.py:562-586).  By default
    :func:`relu_lrn` with the ReLU folded in: on a CUDA tensor B1/B3
    under autograd and B2 without, on a CPU tensor their plain versions.
    The tuning table (op ``lrn_epilogue``) may pick ``per_layer`` (the
    ReLU, then the kernels with ``relu=0``) or, off the card,
    ``plain``."""
    from ..graph import tuner
    choice = _lowering("lrn_epilogue", x, lowering,
                       lambda: tuner.epilogue_extra(size, relu))
    if choice == "per_layer":
        return relu_lrn(torch.relu(x) if relu else x, size, alpha, beta, k)
    if choice == "plain":
        return lrn_across_channels_reference(x, size, alpha, beta, k, relu)
    if choice not in (None, "cuda"):
        raise ValueError(f"tuning table selects unknown lrn_epilogue "
                         f"lowering {choice!r} — drifted table")
    return relu_lrn(x, size, alpha, beta, k, relu=relu)


@register_layer("LRN")
class LRNLayer(LayerImpl):
    """Local response normalization (reference: lrn_layer.cpp).
    ACROSS_CHANNELS: scale = k + (alpha/n)·Σ x² over a size-n channel
    window, out = x · scale^-beta — the hand-written kernels on a CUDA
    tensor, their plain versions on a CPU tensor.  WITHIN_CHANNEL
    (WithinChannelForward): x · (1 + alpha·avgpool(x²))^-beta over a
    size x size window at stride 1, pad (size-1)/2, output forced to the
    input's size; k is unused and alpha is not divided by size."""

    def apply(self, lp, params, bottoms, train, gen=None,
              lowering=CONSULT):
        size, alpha, beta, k, region = lrn_geometry(lp)
        x = bottoms[0]
        if region == "WITHIN_CHANNEL":
            pre = (size - 1) // 2
            h, w = x.shape[2], x.shape[3]
            savg = ave_pool(x * x, size, size, 1, 1, pre, pre, h, w)
            return [x * (1.0 + alpha * savg) ** (-beta)]
        if region != "ACROSS_CHANNELS":
            raise ValueError(f"layer {lp.name!r}: unknown norm_region "
                             f"{region!r}")
        from ..graph import tuner
        choice = _lowering("lrn", x, lowering,
                           lambda: tuner.lrn_extra(size))
        if choice == "plain":
            return [lrn_across_channels_reference(x, size, alpha, beta, k)]
        if choice == "cumsum":
            return [lrn_cumsum(x, size, alpha, beta, k)]
        if choice not in (None, "cuda"):
            raise ValueError(f"tuning table selects unknown lrn lowering "
                             f"{choice!r} — drifted table")
        return [relu_lrn(x, size, alpha, beta, k, relu=False)]


@register_layer("Im2col")
class Im2colLayer(LayerImpl):
    """The convolution's patches as a blob (im2col_layer.cpp): (N,
    C·kh·kw, oh, ow), each row channel-major (C, kh, kw)."""

    def out_shapes(self, lp, bottom_shapes):
        n, c, h, w = bottom_shapes[0]
        kh, kw, sh, sw, ph, pw, dh, dw, _, _, _ = conv_geometry(lp)
        oh = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
        ow = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
        return [(n, c * kh * kw, oh, ow)]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        kh, kw, sh, sw, ph, pw, dh, dw, _, _, _ = conv_geometry(lp)
        shape = self.out_shapes(lp, [tuple(x.shape)])[0]
        return [F.unfold(x, (kh, kw), dilation=(dh, dw), padding=(ph, pw),
                         stride=(sh, sw)).reshape(shape)]


@register_layer("SPP")
class SPPLayer(LayerImpl):
    """Spatial pyramid pooling (spp_layer.cpp): ``pyramid_height``
    levels, level l pooling the plane into 2^l x 2^l bins (kernel and
    stride ceil(dim / bins), padding (kernel·bins − dim + 1) // 2), each
    flattened, all concatenated a sample.  MAX levels go through
    :func:`max_pool_layer` (the kernel's backward on the card), AVE
    levels through :func:`ave_pool`."""

    @staticmethod
    def levels(lp, shape) -> list[tuple[int, int, int, int, int]]:
        """(bins, kh, kw, ph, pw) of each level."""
        _, _, h, w = shape
        out = []
        for level in range(int(lp.sub("spp_param").get("pyramid_height", 1))):
            bins = 2 ** level
            kh, kw = -(-h // bins), -(-w // bins)
            out.append((bins, kh, kw, (kh * bins - h + 1) // 2,
                        (kw * bins - w + 1) // 2))
        return out

    def out_shapes(self, lp, bottom_shapes):
        n, c = bottom_shapes[0][:2]
        return [(n, sum(c * b * b for b, *_ in self.levels(
            lp, bottom_shapes[0])))]

    def apply(self, lp, params, bottoms, train, gen=None):
        x = bottoms[0]
        pool = (max_pool_layer if str(lp.sub("spp_param").get("pool", "MAX"))
                == "MAX" else ave_pool)
        return [torch.cat([pool(x, kh, kw, kh, kw, ph, pw, bins,
                                bins).reshape(x.shape[0], -1)
                           for bins, kh, kw, ph, pw in self.levels(
                               lp, tuple(x.shape))], dim=1)]
