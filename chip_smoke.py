"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Builds every hand-written CUDA kernel of ``sparknet_tpu_torch`` from the
checkout's sources, holds each against its plain PyTorch version on the
card at the shapes every main path gives it (with planted faults the same
checks must reject), then drives the port's main paths at full width:
it serves CaffeNet and GoogLeNet through the micro-batching engine
(``ModelHouse`` -> ``InferenceEngine`` -> ``run_closed_loop``) in bf16 and
in f32, and a few VGG-16 requests; it checks the device crop
(``crop_mirror_mean``) against the host crop bit for bit at CaffeNet's and
GoogLeNet's shapes and the pinned, prefetched ``DeviceFeed`` (order,
bytes, pinning, its own stream), with planted faults; it trains CaffeNet
(2 workers, batch 64) and GoogLeNet (batch 32), τ=5, through
``apps.imagenet_app.main`` with the crop on the feed's host thread and
with ``--device-preprocess``, and through the synchronous loop the
device feed replaced (the same-call baseline), CaffeNet also one
``--strategy sync`` round whose ``--snapshot`` must restore bit for bit
on the card and on the CPU, VGG-16 (batch 32, one short round), and cifar10_full and
cifar10_quick through ``apps.cifar_app.main`` (batch 100, τ=10), f32 with
TF32 off.  Each training run prints per round the loop's seconds (the
wait for the feed included), the round's own, the feed's host seconds,
the wait, and img/s per card over the loop and over the round.  It checks
what comes out, how often each kernel launched on each path, and one
training round of CaffeNet (``local_sgd`` and ``sync``), GoogLeNet and
each CIFAR net on the card against the same round on the CPU, and
GoogLeNet's round at τ=2 with the hand kernels against their plain
versions on the card.  Phase 5c writes a 1,024-record LMDB of raw
256x256 Datums (and a test LMDB and a LevelDB, read back equal) and its
mean through ``tools/compute_image_mean``, checks the training feed on the
card against ``db_feed`` bit for bit and planted feed faults, trains
full-width CaffeNet through ``tools/caffe_cli.main(["train", ...])`` from
it (batch 256, crop 227, mirror, ``mean_file``; test batch 50) with exact
launch counts, scores the snapshot with ``caffe_cli test`` against the last
test pass, checks ``extract_features``' fc7 records against the net's
fc7, and times the net with ``caffe_cli time``.  Prints the card, timings, a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": ...}``.  Every failed check
exits non-zero.  Without a CUDA device it exits 2 and prints no result.
``--profile PATH`` also writes per-kernel device-time tables of batch-64
forwards and of one steady round of each training run to PATH, prints
the host-side split of one batch-64 dispatch, and prints for each of
those rounds the device's busy share of its wall time and its
host-to-device copies, pinned or pageable, by what they carry.

Imports nothing of JAX and nothing of ``sparknet_tpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Iterator
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

# The one card this script has peak rates for: the H100 SXM5 80 GB at its
# 700 W limit, from NVIDIA's H100 data sheet (HBM3 3.35 TB/s, f32 non-tensor
# 67 TFLOP/s).  Another card fails the run until its row is added.
CARD = "NVIDIA H100 80GB HBM3"
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12

SEED = 0
L2_FLUSH_BYTES = 128 * 2**20     # > the card's 50 MB L2


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of one call, each call timed alone with CUDA
    events after a write of ``flush`` has evicted the L2 cache.  A ~1 ms
    device-side spin ahead of the start event keeps the card busy while
    the host enqueues the call, so host launch time is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


class cudnn_deterministic:
    """cuDNN's deterministic algorithms for a scope: two runs of the same
    steps from the same bits give the same bits.  The default algorithms
    vary from run to run, and some round a sum with heavy cancellation
    far from f64: a card-vs-CPU cifar10_full round at init put the conv
    biases 2.0e-3 from the f64 round in 2 of 12 repeats on an H100 with
    them, 1e-7 in the others, and 4.3e-7 in all 12 with this scope."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.saved


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each f32 value (8-bit mantissa)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

# (label, shape, local_size, relu); alpha, beta, k are CaffeNet's (and
# GoogLeNet's).  The CaffeNet and GoogLeNet rows cover every batch shape
# the engine launches the kernel at.
LRN_CASES = [
    *((f"caffenet_{norm}_b{b}", (b, c, hw, hw), 5, False)
      for norm, c, hw in (("norm1", 96, 27), ("norm2", 256, 13))
      for b in (1, 4, 16, 64)),
    *((f"googlenet_{norm}_b{b}", (b, c, 56, 56), 5, False)
      for norm, c in (("norm1", 64), ("norm2", 192)) for b in (1, 4, 16, 64)),
    ("googlenet_conv2_norm2_b16", (16, 192, 56, 56), 5, True),
    ("odd_size3", (3, 7, 5, 9), 3, False),
    ("odd_size4_relu", (3, 7, 5, 9), 4, True),
    ("odd_size5", (3, 7, 5, 9), 5, False),
    ("odd_size7_generic", (3, 7, 5, 9), 7, False),
]
LRN_ALPHA, LRN_BETA, LRN_K = 1e-4, 0.75, 1.0
# Spread of the LRN checks' inputs.  At unit scale CaffeNet's alpha moves
# an output by under half a bf16 ulp, so an identity kernel would pass;
# at 50 (pixel-scale activations) the window sum is ~12,500 and the
# output shrinks by ~15%, tens of bf16 ulps.
LRN_INPUT_STD = 50.0


def outside_tol(got: torch.Tensor, want: torch.Tensor,
                rtol: float = 1e-5) -> tuple:
    """(mask of elements of ``got`` outside the tolerance of ``want``'s
    dtype, its text): f32 ``rtol`` (1e-5 by default) + atol 1e-6, bf16
    one ulp."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        return err > 1e-6 + rtol * w.abs(), f"rtol {rtol:g}, atol 1e-6"
    return err > bf16_ulp(torch.maximum(g.abs(), w.abs())), "1 bf16 ulp"


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: bytes over the HBM rate or f32
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / F32_FLOP_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_lrn(ck, dev) -> list[dict]:
    """Every LRN case in f32 and bf16: the kernel against its plain
    version, plus two planted faults that the same check must catch — an
    identity kernel (output = input) and the kernel launched with -beta."""
    gen = np.random.default_rng(SEED)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    rows = []
    for label, shape, size, relu in LRN_CASES:
        xf = torch.from_numpy((LRN_INPUT_STD * gen.normal(size=shape))
                              .astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = xf.to(dtype)
            args = (size, LRN_ALPHA, LRN_BETA, LRN_K, relu)
            got = ck.lrn_across_channels(x, *args)
            want = ck.lrn_across_channels_reference(x, *args)
            wrong_beta = ck.lrn_across_channels(
                x, size, LRN_ALPHA, -LRN_BETA, LRN_K, relu)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != x.shape:
                fail(f"lrn {label}: got {got.dtype} {tuple(got.shape)}")
            bad, tol = outside_tol(got, want)
            err = (got.float() - want.float()).abs()
            if bool(bad.any()):
                fail(f"lrn {label} {dtype}: {int(bad.sum())} elements "
                     f"outside {tol}, max |err| {float(err.max()):.3e}")
            controls = {k: float(outside_tol(v, want)[0].float().mean())
                        for k, v in (("identity", x),
                                     ("neg_beta", wrong_beta))}
            for k, frac in controls.items():
                if frac == 0.0:
                    fail(f"lrn {label} {dtype}: the planted {k} fault "
                         f"passes the {tol} check, so the check proves nothing")
            ms = time_ms(lambda: ck.lrn_across_channels(x, *args), 50, flush)
            plain_ms = time_ms(
                lambda: ck.lrn_across_channels_reference(x, *args), 20, flush)
            library_ms = None
            if size % 2 == 1 and not relu:
                library_ms = time_ms(lambda: F.local_response_norm(
                    x, size, LRN_ALPHA, LRN_BETA, LRN_K), 20, flush)
            numel = x.numel()
            row = {"case": label, "shape": list(shape), "size": size,
                   "relu": relu, "dtype": str(dtype).split(".")[-1],
                   "plan": ck.lrn_plan(shape[0], shape[1],
                                       shape[2] * shape[3])._asdict(),
                   "max_abs_err": float(err.max()), "tolerance": tol,
                   "planted_outside_tol": controls,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   # read x, write y once
                   **bound(2 * numel * x.element_size(),
                           numel * (2 * size + 4 + int(relu)))}
            rows.append(row)
            print("lrn_check " + json.dumps(row), flush=True)
    return rows


# The training kernels.  The CaffeNet and GoogLeNet rows are the shapes
# their training paths launch them at (batch 64 and 32, f32 there); the
# others carry GoogLeNet's relu face, odd and even window sizes, and the
# backward's chunk and block edges: one channel, fewer channels than the
# window, 13 channels (the last warp with one), 37 (a partial last
# block), and a batch above 65535.
TRAIN_BATCH = 64
GN_BATCH = 32          # GoogLeNet's and VGG-16's per-worker batch
LRN_TRAIN_CASES = [
    *((f"caffenet_{norm}_b{TRAIN_BATCH}", (TRAIN_BATCH, c, hw, hw), 5, False)
      for norm, c, hw in (("norm1", 96, 27), ("norm2", 256, 13))),
    *((f"googlenet_{norm}_b{GN_BATCH}", (GN_BATCH, c, 56, 56), 5, False)
      for norm, c in (("norm1", 64), ("norm2", 192))),
    ("googlenet_conv2_norm2_b16", (16, 192, 56, 56), 5, True),
    ("odd_size3", (3, 7, 5, 9), 3, False),
    ("odd_size4", (3, 7, 5, 9), 4, False),
    ("odd_size4_relu", (3, 7, 5, 9), 4, True),
    ("odd_size5", (3, 7, 5, 9), 5, False),
    ("odd_size7_generic", (3, 7, 5, 9), 7, False),
    ("one_channel_relu", (3, 1, 5, 9), 5, True),
    ("c3_under_size5", (3, 3, 5, 9), 5, False),
    ("c13_size3_relu", (3, 13, 5, 9), 3, True),
    ("c37_size4_partial_block", (3, 37, 5, 9), 4, False),
    ("batch_70000", (70_000, 3, 2, 2), 3, False),
]


def lrn_bwd_forward_window(ck, x, scale, dy, size, alpha, beta, relu):
    """A planted fault: the plain backward summing over the forward
    window (pre, post) in place of the reflected one (post, pre); it
    differs from the right gradient only at an even size."""
    xf, s, g = x.float(), scale.float(), dy.float()
    a = torch.relu(xf) if relu else xf
    y = a * s.pow(-beta)
    pre, post = ck._lrn_window(size)
    da = (g * s.pow(-beta) - (2.0 * alpha * beta / size) * a
          * ck._window_sum(g * y / s, pre, post))
    if relu:
        da = torch.where(xf > 0, da, torch.zeros_like(da))
    return da.to(x.dtype)


def check_lrn_train(ck, dev) -> list[dict]:
    """The LRN training forward (y and scale) and backward kernels
    against their plain versions at every case, f32 and bf16, inputs and
    gradients at std 50.  f32 y and scale at rtol 1e-5, dx at rtol 1e-4
    (graph/tuner.py:248: its powf calls and a difference of two terms);
    bf16 one ulp.  The training forward's y must equal the inference
    kernel's bit for bit.  Planted fault: at an even size the backward
    with the forward window must fail the dx check."""
    gen = np.random.default_rng(SEED + 10)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    rows = []
    for label, shape, size, relu in LRN_TRAIN_CASES:
        xf, dyf = (torch.from_numpy((LRN_INPUT_STD * gen.normal(size=shape))
                                    .astype(np.float32)).to(dev)
                   for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = xf.to(dtype), dyf.to(dtype)
            args = (size, LRN_ALPHA, LRN_BETA, LRN_K, relu)
            bargs = (size, LRN_ALPHA, LRN_BETA, relu)
            y, scale = ck.lrn_across_channels_fwd(x, *args)
            dx = ck.lrn_across_channels_bwd(x, scale, dy, *bargs)
            wy, wscale = ck.lrn_across_channels_fwd_reference(x, *args)
            wdx = ck.lrn_across_channels_bwd_reference(x, scale, dy, *bargs)
            y_infer = ck.lrn_across_channels(x, *args)
            torch.cuda.synchronize()
            for t in (y, scale, dx):
                if t.dtype != dtype or t.shape != x.shape:
                    fail(f"lrn train {label}: got {t.dtype} "
                         f"{tuple(t.shape)}")
            if not torch.equal(y, y_infer):
                fail(f"lrn train {label} {dtype}: the training forward's y "
                     f"differs from the inference kernel's")
            errs = {}
            for what, got, want, rtol in (("y", y, wy, 1e-5),
                                          ("scale", scale, wscale, 1e-5),
                                          ("dx", dx, wdx, 1e-4)):
                bad, tol = outside_tol(got, want, rtol)
                errs[what] = float((got.float() - want.float()).abs().max())
                if bool(bad.any()):
                    fail(f"lrn train {label} {dtype} {what}: "
                         f"{int(bad.sum())} elements outside {tol}, max "
                         f"|err| {errs[what]:.3e}")
            planted = None
            if size % 2 == 0:
                wrong = lrn_bwd_forward_window(ck, x, scale, dy, *bargs)
                planted = float(outside_tol(wrong, wdx, 1e-4)[0]
                                .float().mean())
                if planted == 0.0:
                    fail(f"lrn train {label} {dtype}: the planted "
                         f"forward-window backward passes the dx check")
            timings = {
                "fwd_ms": time_ms(lambda: ck.lrn_across_channels_fwd(
                    x, *args), 50, flush),
                "fwd_plain_ms": time_ms(
                    lambda: ck.lrn_across_channels_fwd_reference(x, *args),
                    20, flush),
                "bwd_ms": time_ms(lambda: ck.lrn_across_channels_bwd(
                    x, scale, dy, *bargs), 50, flush),
                "bwd_plain_ms": time_ms(
                    lambda: ck.lrn_across_channels_bwd_reference(
                        x, scale, dy, *bargs), 20, flush),
                "fwd_library_ms": None, "bwd_library_ms": None}
            if size % 2 == 1 and not relu:
                lrn = lambda v: F.local_response_norm(
                    v, size, LRN_ALPHA, LRN_BETA, LRN_K)
                xr = x.detach().requires_grad_()
                yl = lrn(xr)
                timings["fwd_library_ms"] = time_ms(lambda: lrn(x), 20, flush)
                timings["bwd_library_ms"] = time_ms(
                    lambda: torch.autograd.grad(yl, xr, dy,
                                                retain_graph=True), 20, flush)
                del xr, yl
            numel, elt = x.numel(), x.element_size()
            base = {"case": label, "shape": list(shape), "size": size,
                    "relu": relu, "dtype": str(dtype).split(".")[-1]}
            nch = (shape[0], shape[1], shape[2] * shape[3])
            fwd = {**base, "kernel": "lrn_across_channels_fwd",
                   "plan": ck.lrn_plan(*nch)._asdict(),
                   "max_abs_err": max(errs["y"], errs["scale"]),
                   "ms": timings["fwd_ms"],
                   "plain_ms": timings["fwd_plain_ms"],
                   "library_ms": timings["fwd_library_ms"],
                   # read x; write y and scale
                   **bound(3 * numel * elt, numel * (2 * size + 4 + relu))}
            bwd = {**base, "kernel": "lrn_across_channels_bwd",
                   "plan": ck.lrn_bwd_plan(*nch)._asdict(),
                   "max_abs_err": errs["dx"], "planted_outside_tol": planted,
                   "ms": timings["bwd_ms"],
                   "plain_ms": timings["bwd_plain_ms"],
                   "library_ms": timings["bwd_library_ms"],
                   # read x, scale, dy; write dx.  The function's own work
                   # per element: a window sum of `size` adds, one powf,
                   # one division, five multiplies and a subtraction, and
                   # with relu the max and the mask
                   **bound(4 * numel * elt,
                           numel * (size + 8 + 2 * relu))}
            for row in (fwd, bwd):
                rows.append(row)
                print("lrn_train_check " + json.dumps(row), flush=True)
    return rows


def sweep_lrn_bwd_warps(ck, dev) -> None:
    """The LRN backward at CaffeNet's norms (f32, batch 64) with 1, 2, 4
    and 8 warps a block, each checked against the plain version (rtol
    1e-4) and timed twice, in turns.  One warp is each thread loading and
    computing its own halo; more warps pass their edge channels' terms
    to each other, and only the block's outer halo is loaded twice.  The
    plan's warps are those of ``lrn_bwd_plan``."""
    gen = np.random.default_rng(SEED + 12)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    out = {}
    for label, shape, size, relu in LRN_TRAIN_CASES[:2]:
        x, dy = (torch.from_numpy((LRN_INPUT_STD * gen.normal(size=shape))
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))
        _, scale = ck.lrn_across_channels_fwd(x, size, LRN_ALPHA, LRN_BETA,
                                              LRN_K, relu)
        want = ck.lrn_across_channels_bwd_reference(
            x, scale, dy, size, LRN_ALPHA, LRN_BETA, relu)
        n, c, hw = shape[0], shape[1], shape[2] * shape[3]
        dx = torch.empty_like(x)

        def run(warps):
            ck._launch("lrn_across_channels_bwd", "lrn_bwd",
                       "sparknet_lrn_across_channels_bwd", dev,
                       x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                       dx.data_ptr(), n, c, hw, size,
                       2.0 * LRN_ALPHA * LRN_BETA / size, LRN_BETA,
                       int(relu), 0, warps)
        times = {}
        for warps in (1, 2, 4, 8, 8, 4, 2, 1):
            if warps not in times:
                dx.fill_(float("nan"))
                run(warps)
                torch.cuda.synchronize()
                bad, tol = outside_tol(dx, want, 1e-4)
                if bool(bad.any()):
                    fail(f"lrn bwd {label} with {warps} warps: "
                         f"{int(bad.sum())} elements outside {tol}")
            times.setdefault(warps, []).append(
                time_ms(lambda: run(warps), 50, flush))
        out[label] = {"plan_warps": ck.lrn_bwd_plan(n, c, hw).threads
                      // ck.LRN_BWD_LANES, "ms_by_warps": times}
    print("lrn_bwd_warps " + json.dumps(out), flush=True)


# (label, input shape, kernel, stride, pad): the pools of every training
# path at its batch: CaffeNet's three, GoogLeNet's thirteen (four 3/2, the
# first on 112x112 planes the kernel cuts into bands, and nine 3/1/1),
# cifar10's pool1 and VGG-16's five 2/2; then GoogLeNet's stride-1
# pad-1 pool at batch 16, the padded and remainder geometries of
# tests/test_pallas.py:120-156, two geometries whose planes the kernel
# cuts into bands of rows (VGG's pool1 at batch 2, and a 3x3 stride-2
# pad-1 pool on 224x224 planes, banded in bf16 too), and a plane count
# that is no multiple of the planes packed per block
GN_POOLS = [
    *((f"googlenet_{name}_b{GN_BATCH}", (GN_BATCH, c, hw, hw), 3, 2, 0)
      for name, c, hw in (("pool1", 64, 112), ("pool2", 192, 56),
                          ("pool3", 480, 28), ("pool4", 832, 14))),
    *((f"googlenet_inception_{name}_pool_b{GN_BATCH}", (GN_BATCH, c, hw, hw),
       3, 1, 1)
      for name, c, hw in (("3a", 192, 28), ("3b", 256, 28), ("4a", 480, 14),
                          ("4b", 512, 14), ("4c", 512, 14), ("4d", 512, 14),
                          ("4e", 528, 14), ("5a", 832, 7), ("5b", 832, 7))),
]
CIFAR_BATCH = 100      # CifarApp.scala:111
VGG_POOLS = [(f"vgg16_pool{i}_b{GN_BATCH}", (GN_BATCH, c, hw, hw), 2, 2, 0)
             for i, c, hw in ((1, 64, 224), (2, 128, 112), (3, 256, 56),
                              (4, 512, 28), (5, 512, 14))]
BANDED = {"vgg_pool1_b2_banded", "k3s2p1_224_banded",
          f"googlenet_pool1_b{GN_BATCH}"}
POOL_CASES = [
    (f"caffenet_pool1_b{TRAIN_BATCH}", (TRAIN_BATCH, 96, 55, 55), 3, 2, 0),
    (f"caffenet_pool2_b{TRAIN_BATCH}", (TRAIN_BATCH, 256, 27, 27), 3, 2, 0),
    (f"caffenet_pool5_b{TRAIN_BATCH}", (TRAIN_BATCH, 256, 13, 13), 3, 2, 0),
    *GN_POOLS,
    (f"cifar_pool1_b{CIFAR_BATCH}", (CIFAR_BATCH, 32, 32, 32), 3, 2, 0),
    *VGG_POOLS,
    ("googlenet_k3s1p1_b16", (16, 192, 28, 28), 3, 1, 1),
    ("padded_13_k3s2p1", (2, 4, 13, 13), 3, 2, 1),
    ("overlap_7_k5s3p2", (2, 4, 7, 7), 5, 3, 2),
    ("clipped_17_k2s3p1", (2, 4, 17, 17), 2, 3, 1),
    ("vgg_pool1_b2_banded", (2, 64, 224, 224), 2, 2, 0),
    ("k3s2p1_224_banded", (2, 8, 224, 224), 3, 2, 1),
    ("pool5_planes_not_multiple", (64, 251, 13, 13), 3, 2, 0),
]


def pool_bwd_last_max(ck, x, dy, kh, kw, sh, sw, ph, pw, oh, ow):
    """A planted fault: the plain backward routing each window's gradient
    to its LAST maximum; on tied windows it moves the gradient."""
    wins = ck._pool_windows(x, kh, kw, sh, sw, ph, pw, oh, ow)
    idx = kh * kw - 1 - wins.flip(-1).argmax(dim=-1)
    return ck._route_to_taps(idx, dy, x.shape[2], x.shape[3], kh, kw, sh, sw,
                             ph, pw, oh, ow)


def check_pool_bwd(ck, dev) -> list[dict]:
    """The MAX-pool backward kernel against its plain version at every
    case, f32 and bf16, on tied inputs: ReLU'd normals rounded to
    integers (exact in bf16), so zeros and equal maxima abound and only
    the first-max tie-break agrees.  Gradients at rtol 1e-4, atol 1e-6
    (graph/tuner.py:357; overlapping windows add in another order), bf16
    one ulp.  Planted fault: the last-max plain backward must fail."""
    from sparknet_tpu_torch.ops.vision import max_pool, pool_output_size
    gen = np.random.default_rng(SEED + 11)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    rows = []
    for label, shape, k, st, p in POOL_CASES:
        oh, ow = pool_output_size(shape[2], shape[3], k, k, st, st, p, p)
        geom = (k, k, st, st, p, p, oh, ow)
        xf = torch.from_numpy(np.round(np.maximum(
            4.0 * gen.normal(size=shape), 0.0)).astype(np.float32)).to(dev)
        dyf = torch.from_numpy(gen.normal(size=shape[:2] + (oh, ow))
                               .astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = xf.to(dtype), dyf.to(dtype)
            plan = ck.max_pool_bwd_plan(shape[0] * shape[1], *shape[2:],
                                        *geom, x.element_size())
            if label in BANDED and plan.bands == 1:
                fail(f"pool bwd {label} {dtype}: plan {plan} is not banded")
            if (label.endswith("_not_multiple") and
                    (plan.planes_per_block == 1 or shape[0] * shape[1]
                     % plan.planes_per_block == 0)):
                fail(f"pool bwd {label}: plan {plan} leaves no partial group")
            got = ck.max_pool_bwd(x, dy, *geom)
            want = ck.max_pool_bwd_reference(x, dy, *geom)
            wrong = pool_bwd_last_max(ck, x, dy, *geom)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != x.shape:
                fail(f"pool bwd {label}: got {got.dtype} {tuple(got.shape)}")
            bad, tol = outside_tol(got, want, 1e-4)
            err = float((got.float() - want.float()).abs().max())
            if bool(bad.any()):
                fail(f"pool bwd {label} {dtype}: {int(bad.sum())} elements "
                     f"outside {tol}, max |err| {err:.3e}")
            planted = float(outside_tol(wrong, want, 1e-4)[0].float().mean())
            if planted == 0.0:
                fail(f"pool bwd {label} {dtype}: the planted last-max "
                     f"backward passes the check")
            xr = x.detach().requires_grad_()
            yl = max_pool(xr, *geom)
            row = {"case": label, "kernel": "max_pool_bwd",
                   "shape": list(shape), "kernel_stride_pad": [k, st, p],
                   "plan": plan._asdict(),
                   "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                   "tolerance": tol, "planted_outside_tol": planted,
                   "ms": time_ms(lambda: ck.max_pool_bwd(x, dy, *geom), 50,
                                 flush),
                   "plain_ms": time_ms(lambda: ck.max_pool_bwd_reference(
                       x, dy, *geom), 20, flush),
                   "library_ms": time_ms(lambda: torch.autograd.grad(
                       yl, xr, dy, retain_graph=True), 20, flush),
                   # read x and dy, write dx; a compare per window tap
                   **bound((2 * x.numel() + dy.numel()) * x.element_size(),
                           dy.numel() * (k * k + 1))}
            del xr, yl
            rows.append(row)
            print("pool_bwd_check " + json.dumps(row), flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 4: serving — full-width CaffeNet, GoogLeNet and VGG-16 through the
# engine
# ---------------------------------------------------------------------------

# Spread of the served images: mean-subtracted 0-255 pixels.  At this
# scale the LRNs move f32 logits by ~1e-3 of their largest value (an
# identity LRN in place of the kernel fails check_against_cpu); at unit
# scale they move CaffeNet's fc8 by ~1e-6 and no check downstream could
# see them.
IMAGE_STD = 58.0

# batch shape -> (clients, window): concurrency that fills that shape
LOAD_LEGS = {1: (1, 1), 4: (4, 1), 16: (4, 4), 64: (8, 16)}


def serve(dtype: str, dev, *, model: str = "caffenet", lrn_per_batch: int = 2,
          duration_s: float, n_inputs: int, legs=LOAD_LEGS, tag: str = "",
          min_completed: int = 256,
          weights: str | None = None) -> tuple[dict, object]:
    """Load ``model`` (with the weight file ``weights``, else seeded),
    answer requests from several client threads at each load leg, audit
    every answer bit for bit against its solo padded run, and check the
    LRN launch count (``lrn_per_batch`` per dispatched batch).  Returns
    (report, loaded model)."""
    from sparknet_tpu_torch.ops import cuda_kernels as ck
    from sparknet_tpu_torch.parallel.serving import (
        InferenceEngine, ModelHouse, ServeConfig, run_closed_loop,
        solo_references)

    cfg = ServeConfig(dtype=dtype, max_delay_ms=2.0, max_queue=512,
                      seed=SEED)
    house = ModelHouse(cfg, device=dev)
    t0 = time.perf_counter()
    lm = house.load(model, weights=weights)
    load_s = time.perf_counter() - t0
    gen = np.random.default_rng(SEED + 1)
    inputs = [(IMAGE_STD * gen.normal(size=lm.in_shape)).astype(np.float32)
              for _ in range(n_inputs)]
    refs = solo_references(lm, inputs)
    sum_tol = 1e-2 if dtype == "bf16" else 1e-4
    for s, by_idx in refs.items():
        for i, row in by_idx.items():
            if row.shape != (lm.classes,) or not np.isfinite(row).all():
                fail(f"{model} {dtype}: solo run of input {i} at shape {s} "
                     f"is not {lm.classes} finite probabilities")
            if abs(float(row.sum()) - 1.0) > sum_tol:
                fail(f"{model} {dtype}: solo probabilities sum to "
                     f"{row.sum()}")
    ck.reset_launch_counts()
    runs = {}
    with InferenceEngine(house, cfg) as eng:
        for shape, (clients, window) in legs.items():
            runs[str(shape)] = run_closed_loop(
                eng, model, inputs, clients=clients, window=window,
                duration_s=duration_s, refs=refs)
        stats = eng.stats()
    launches = ck.launch_counts["lrn_across_channels"]
    completed = sum(r["completed"] for r in runs.values())
    if completed < min_completed:
        fail(f"{model} {dtype}: only {completed} requests answered "
             f"(< {min_completed})")
    for name, r in runs.items():
        if r["errors"] or r["exact_mismatches"]:
            fail(f"{model} {dtype} leg {name}: {r['errors']} errors, "
                 f"{r['exact_mismatches']} answers differ from their solo "
                 f"padded run")
    if stats["failed"] or stats["completed"] != completed:
        fail(f"{model} {dtype}: engine failed {stats['failed']}, completed "
             f"{stats['completed']} vs clients' {completed}")
    if launches != lrn_per_batch * stats["dispatches"]:
        fail(f"{model} {dtype}: {launches} LRN launches for "
             f"{stats['dispatches']} dispatched batches (want "
             f"{lrn_per_batch} per batch)")
    others = {k: v for k, v in ck.launch_counts.items()
              if k != "lrn_across_channels" and v}
    if others:
        fail(f"{model} {dtype}: serving launched training kernels {others}")
    report = {"model": model, "dtype": dtype, "load_s": load_s,
              "completed": completed, "dispatches": stats["dispatches"],
              "lrn_launches": launches, "exact_mismatches": 0,
              "occupancy": stats["occupancy"], "batch_ms": stats["batch_ms"],
              "legs": runs, "flops_per_image": lm.flops_per_image}
    print(f"serve{tag} " + json.dumps(report), flush=True)
    return report, lm


def device_forward_ms(lm, batch: int, reps: int) -> float:
    """Device time of one forward at ``batch`` (CUDA events around
    ``reps`` back-to-back launches, warm)."""
    x = torch.zeros((batch,) + lm.in_shape, device=lm.device)
    with torch.inference_mode(), lm.precision():
        run = lambda: lm.net.apply(lm._fwd_params, {"data": x})
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_against_cpu(lm, blob: str) -> tuple[float, float, tuple]:
    """The card's f32 logits (``blob``) against the port's CPU forward
    (plain LRN) on the same weights, and that CPU forward against one
    whose LRNs are the identity (a planted fault): two max|diff| /
    max|ref|, and the (cuDNN, matmul) TF32 flags the card's forward ran
    with."""
    from sparknet_tpu_torch.ops import vision
    gen = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(
        (IMAGE_STD * gen.normal(size=(4,) + lm.in_shape)).astype(np.float32))
    cpu_params = {k: [b.cpu() for b in v] for k, v in lm.params.items()}
    logits = lambda params, data: lm.net.apply(
        params, {"data": data}, blobs=[blob])[blob]
    with torch.inference_mode():
        with lm.precision():
            got = logits(lm.params, x.to(lm.device)).cpu()
            tf32 = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        want = logits(cpu_params, x)
        with mock.patch.object(vision, "lrn_across_channels",
                               lambda t, *args, **kw: t):
            planted = logits(cpu_params, x)
    rel = lambda a: float((a - want).abs().max() / want.abs().max())
    return rel(got), rel(planted), tf32


def serve_both(dev, smi: str, model: str, blob: str) -> dict:
    """``model`` served in bf16 and in f32 on the same weights: the f32
    logits on the card within 1e-4 of the CPU forward (TF32 off), with
    identity LRNs moving them by more; device forward and closed-loop
    throughput at batch 64; p50/p99 per batch shape.  Returns the two
    reports and their loaded models."""
    tag = "" if model == "caffenet" else f"_{model}"
    bf16, lm16 = serve("bf16", dev, model=model, duration_s=2.0,
                       n_inputs=16, tag=tag)
    f32, lm32 = serve("f32", dev, model=model, duration_s=1.0, n_inputs=8,
                      tag=f"{tag}_f32")
    for k, blobs in lm16.params.items():
        if not all(torch.equal(a, b) for a, b in zip(blobs, lm32.params[k])):
            fail(f"{model}: bf16 and f32 houses drew different weights "
                 f"for {k!r}")
    rel, planted, tf32 = check_against_cpu(lm32, blob)
    print(f"{model} f32 {blob} card vs CPU: max|diff|/max|ref| = {rel:.3e} "
          f"(limit 1e-4, TF32 allowed: cudnn {tf32[0]}, matmul {tf32[1]}); "
          f"CPU with identity LRNs vs CPU: {planted:.3e}", flush=True)
    if any(tf32):
        fail(f"{model}: the f32 forward ran with TF32 allowed")
    if not rel <= 1e-4:
        fail(f"{model}: f32 {blob} differs from the CPU forward by "
             f"{rel:.3e}")
    if not planted > 1e-4:
        fail(f"{model}: identity LRNs move f32 {blob} by only "
             f"{planted:.3e}: the 1e-4 check cannot see the LRN kernel")
    fwd = {d: {"b64_ms": device_forward_ms(lm, 64, 20)}
           for d, lm in (("bf16", lm16), ("f32", lm32))}
    for d, r in (("bf16", bf16), ("f32", f32)):
        leg = r["legs"]["64"]
        fwd[d]["img_s_b64_closed_loop"] = leg["achieved_qps"]
        fwd[d]["img_s_b64_device"] = 64e3 / fwd[d]["b64_ms"]
    print(f"throughput [{smi}] {model} " + json.dumps(fwd), flush=True)
    for d, r in (("bf16", bf16), ("f32", f32)):
        for shape, lat in r["batch_ms"].items():
            print(f"latency [{smi}] {model} {d} batch {shape}: p50 "
                  f"{lat['p50_ms']} ms, p99 {lat['p99_ms']} ms over "
                  f"{lat['batches']} batches", flush=True)
    return {"bf16": bf16, "f32": f32, "lm16": lm16, "lm32": lm32,
            "card_vs_cpu": rel, "planted": planted, "forward": fwd}


def dispatch_breakdown(lm, inputs, reps: int = 10) -> dict:
    """Host-clock split of one batch at the largest shape, done as the
    engine's dispatcher and harvester do it, alone (no other threads):
    pad (numpy batch), launch (``infer_async``: pinned staging, upload,
    forward enqueue) and wait (``harvest``).  Medians in ms."""
    s = lm.batch_shapes[-1]
    split = {"pad_ms": [], "launch_ms": [], "wait_ms": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        batch = np.zeros((s,) + lm.in_shape, np.float32)
        for i in range(s):
            batch[i] = inputs[i % len(inputs)]
        t1 = time.perf_counter()
        handle = lm.infer_async(batch)
        t2 = time.perf_counter()
        lm.harvest(handle)
        t3 = time.perf_counter()
        for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(dt * 1e3)
    return {k: float(np.median(v)) for k, v in split.items()}


def profile_forward(lm, path: str, mode: str = "w") -> None:
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros((64,) + lm.in_shape, device=lm.device)
    with torch.inference_mode():
        lm.net.apply(lm._fwd_params, {"data": x})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                lm.net.apply(lm._fwd_params, {"data": x})
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, mode) as f:
        f.write(f"\n\n{lm.name} {lm.dtype}: five batch-64 forwards\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40))


# ---------------------------------------------------------------------------
# Phase 4b: the training feed on the card — the device crop against the
# host crop, and the pinned, prefetched DeviceFeed
# ---------------------------------------------------------------------------

# (label, batch, crop): CaffeNet's global batch at 227, GoogLeNet's at 224
CROP_CASES = [("caffenet", 2 * TRAIN_BATCH, 227), ("googlenet", 2 * GN_BATCH,
                                                   224)]


def host_draws(seed: int, n: int, size: int, crop: int):
    """The host crop's draws, in its order (ys, xs, flips)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, size - crop + 1, size=n),
            rng.integers(0, size - crop + 1, size=n),
            rng.integers(0, 2, size=n))


def check_crop(dev) -> dict:
    """``crop_mirror_mean`` on the card at CaffeNet's and GoogLeNet's
    shapes (256x256 images, a full-size mean) against the port's numpy
    host crop with the same offsets: equal bit for bit.  Two planted
    faults must differ: every x offset one further, and the flips
    dropped.  Times: the card's crop (device ms, CUDA events) and the
    host crop it replaces (host clock)."""
    from sparknet_tpu_torch.data import random_crop_mirror
    from sparknet_tpu_torch.parallel.trainer import crop_mirror_mean
    gen = np.random.default_rng(SEED + 20)
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    out = {}
    for label, n, crop in CROP_CASES:
        x = gen.uniform(0, 255, (n, 3, TRAIN_RESIZE, TRAIN_RESIZE)).astype(
            np.float32)
        mean = x.mean(axis=0)
        t0 = time.perf_counter()
        want = random_crop_mirror(x, crop, np.random.default_rng(SEED + 21),
                                  mean=mean)
        host_s = time.perf_counter() - t0
        ys, xs, flips = (torch.from_numpy(a).to(dev) for a in host_draws(
            SEED + 21, n, TRAIN_RESIZE, crop))
        xd, md = torch.from_numpy(x).to(dev), torch.from_numpy(mean).to(dev)
        run = lambda xs_=xs, fl=flips: crop_mirror_mean(xd, ys, xs_, fl,
                                                        crop, md)
        got = run().cpu().numpy()
        shifted = run(xs_=(xs + 1) % (TRAIN_RESIZE - crop + 1)).cpu().numpy()
        unflipped = run(fl=torch.zeros_like(flips)).cpu().numpy()
        if got.tobytes() != want.tobytes():
            fail(f"crop {label}: the card's crop differs from the host's "
                 f"(max |err| {float(np.abs(got - want).max()):.3e})")
        for fault, v in (("x_offset_plus_1", shifted),
                         ("flip_dropped", unflipped)):
            if v.tobytes() == want.tobytes():
                fail(f"crop {label}: the planted {fault} fault passes")
        ms = time_ms(run, 20, flush)
        # read each sample's window and the mean once, write the output
        nbytes = 4 * (2 * got.size + mean.size)
        out[label] = {"batch": n, "crop": crop, "equal": True, "ms": ms,
                      "host_crop_s": host_s,
                      "planted_differ": ["x_offset_plus_1", "flip_dropped"],
                      **bound(nbytes, got.size)}
    print("crop_check " + json.dumps(out), flush=True)
    return out


def check_feed(dev) -> dict:
    """``DeviceFeed`` on the card: 2 x its ring size + 2 distinct rounds
    (2 x 8 images of 3x256x256 each, labels), a consumer slower than the
    feed (a 20 ms device spin and a 10 ms host sleep a round): every
    round arrives in order and byte-equal to its source; the staging
    buffers are pinned; and a round is delivered while a 1 s spin still
    holds the consumer's (default) stream, so its copy ran on the feed's
    stream.  Prints the pinned bytes and the feed's stats."""
    import threading
    from sparknet_tpu_torch.data.pipeline import FeedStats, ring_size
    from sparknet_tpu_torch.data.prefetch import device_feed
    gen = np.random.default_rng(SEED + 22)
    depth, putters = 1, 2
    n = 2 * ring_size(depth, putters + 1) + 2
    src = [{"data": gen.normal(size=(2, 8, 3, 256, 256)).astype(np.float32),
            "label": np.full((2, 8), i, np.float32)} for i in range(n)]
    # the source releases round i when go[i] is set: the last round waits
    # until the default stream is busy
    go = [threading.Event() for _ in range(n)]
    for e in go[:-1]:
        e.set()

    def rounds():
        for i, r in enumerate(src):
            go[i].wait()
            yield r

    stats = FeedStats()
    t0 = time.perf_counter()
    with device_feed(rounds(), dev, depth=depth, putters=putters,
                     stats=stats) as feed:
        if feed.stream == torch.cuda.default_stream(dev):
            fail("feed: its stream is the default stream")
        for i in range(n - 1):
            batch = next(feed)
            torch.cuda._sleep(40_000_000)        # ~20 ms of device work
            time.sleep(0.01)
            for k, v in src[i].items():
                if batch[k].device != dev or \
                        batch[k].cpu().numpy().tobytes() != v.tobytes():
                    fail(f"feed: round {i} {k} differs from its source")
        pinned = [b.is_pinned() for r in feed.rings.values()
                  for b in r.buffers]
        if not pinned or not all(pinned):
            fail(f"feed: staging buffers pinned: {pinned}")
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)         # ~1 s on the default stream
        go[-1].set()
        last = next(feed)
        busy = not torch.cuda.default_stream(dev).query()
        torch.cuda.synchronize()
        if not busy:
            fail("feed: the last round waited for the default stream, so "
                 "its copy did not run on the feed's stream")
        if last["data"].cpu().numpy().tobytes() != src[-1]["data"].tobytes():
            fail("feed: the last round differs from its source")
        report = {"rounds": n, "ring_size": feed._ring_size,
                  "pinned_bytes": feed.pinned_bytes,
                  "delivered_while_default_stream_busy": busy,
                  "wall_s": time.perf_counter() - t0,
                  "stats": stats.snapshot(), "per_round": stats.per_batch()}
    print("feed_check " + json.dumps(report), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5: training — full-width CaffeNet, GoogLeNet and VGG-16 through
# imagenet_app, cifar10_full and cifar10_quick through cifar_app,
# τ-step local SGD
# ---------------------------------------------------------------------------

TRAIN_WORKERS, TRAIN_TAU = 2, 5
# Round 0 warms up and rounds 1-7 are steady.  The feed builds rounds
# ahead while round 0 runs, so the first steady rounds can take stock
# the feed built then; by the later ones a feed-bound loop waits for
# every round it takes.
TRAIN_ROUNDS = 8
PROFILE_ROUND = 7         # the steady round that --profile traces
TRAIN_RESIZE, TRAIN_CROP = 256, 227     # bvlc_reference_caffenet's
GN_CROP = 224                           # bvlc_googlenet's and VGG-16's
CIFAR_TAU, CIFAR_ROUNDS = 10, 2         # CifarApp.scala:111


def eval_batches(workers: int, batch: int) -> int:
    """Worker test batches of imagenet_app's one eval at the end: its
    test set is max(2 x workers x batch, 64) images over the workers,
    scored in whole per-worker batches."""
    return workers * (max(2 * workers * batch, 64) // workers // batch)


def synchronous_loop(trainer, feed, test_factory, test_steps, *, rounds,
                     test_interval=10, logger=None, snapshot_path=None,
                     prefetch_depth=None, profiler=None):
    """The port's training loop before the device feed, kept here as the
    same-call baseline: each round built on the host (``feed.next_round``)
    and then run (``train_round``, which copies each micro-batch from
    pageable memory), one after the other; one eval at the end."""
    from sparknet_tpu_torch.apps.common import TrainingRun, normalize_scores
    run = TrainingRun({}, trainer, feed)
    for r in range(rounds):
        if profiler is not None and r == profiler.index:
            profiler.start()
        t0 = time.perf_counter()
        batches = feed.next_round()
        run.feed_wait_seconds.append(time.perf_counter() - t0)
        trainer.train_round(batches)
        run.loop_seconds.append(time.perf_counter() - t0)
        if profiler is not None and r == profiler.index:
            profiler.stop(trainer)
    run.scores = normalize_scores(trainer.test(test_factory(), test_steps),
                                  test_steps)
    return run


def device_busy_and_uploads(trace_path: str, wall_s: float,
                            sizes: dict) -> dict:
    """From a chrome trace of one round: the device's busy share of the
    round's wall time (the union of kernel, memcpy and memset intervals
    on every stream) and the host-to-device copies by source memory
    (pinned or pageable) and by what they carry, told apart by size
    (``sizes``: kind -> set of byte counts; the rest is "other")."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, uploads = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        name = e.get("name", "")
        if e["cat"] == "gpu_memcpy" and "HtoD" in name:
            src = ("pinned" if "Pinned" in name else
                   "pageable" if "Pageable" in name else name)
            nbytes = int(e.get("args", {}).get("bytes", -1))
            kind = next((k for k, v in sizes.items() if nbytes in v),
                        "other")
            slot = uploads.setdefault(src, {}).setdefault(
                kind, {"count": 0, "bytes": 0, "ms": 0.0})
            slot["count"] += 1
            slot["bytes"] += nbytes
            slot["ms"] += float(e["dur"]) / 1e3
    spans.sort()
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {"wall_s": wall_s, "device_busy_s": busy / 1e6,
            "device_busy_share": busy / 1e6 / wall_s, "uploads": uploads}


class RoundProfile:
    """``torch.profiler`` over round ``index`` of a training run, from the
    loop's request for the round's feed (``DeviceFeed.__next__``, or the
    baseline's ``next_round``) to the end of its ``train_round``: the
    device's busy share of that wall time and its host-to-device copies
    (``device_busy_and_uploads``); the per-kernel table goes to
    ``path``."""

    def __init__(self, index: int, label: str, path: str,
                 whole_rounds: bool):
        self.index, self.label, self.path = index, label, path
        self.whole_rounds = whole_rounds
        self.prof, self.result, self._fed = None, None, 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, tr) -> None:
        import tempfile
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        sizes = upload_sizes(tr, self.whole_rounds)
        with tempfile.TemporaryDirectory() as d:
            trace = os.path.join(d, "trace.json")
            self.prof.export_chrome_trace(trace)
            self.result = device_busy_and_uploads(trace, wall, sizes)
        with open(self.path, "a") as f:
            f.write(f"\n\n{self.label}: round {self.index} of the loop, "
                    f"feed wait included\n")
            f.write(self.prof.key_averages().table(
                sort_by="cuda_time_total", row_limit=40))
        self.prof = None

    def hooks(self):
        """Patches that open the window at the round's feed request and
        close it after its ``train_round``."""
        from contextlib import ExitStack
        from sparknet_tpu_torch.data.prefetch import DeviceFeed
        from sparknet_tpu_torch.parallel.trainer import DistributedTrainer
        feed_next, train_round = DeviceFeed.__next__, \
            DistributedTrainer.train_round
        prof = self

        def next_(feed):
            if prof._fed == prof.index:
                prof.start()
            prof._fed += 1
            return feed_next(feed)

        def round_(tr, batches):
            loss = train_round(tr, batches)
            if prof.prof is not None and tr.round - 1 == prof.index:
                prof.stop(tr)
            return loss

        stack = ExitStack()
        stack.enter_context(mock.patch.object(DeviceFeed, "__next__", next_))
        stack.enter_context(mock.patch.object(DistributedTrainer,
                                              "train_round", round_))
        return stack


def upload_sizes(tr, whole_rounds: bool) -> dict:
    """Byte counts of a training run's host-to-device copies by kind: the
    minibatches (whole rounds through the feed, or one micro-batch at a
    time in the baseline), their labels, the Dropout masks (one bool a
    unit of each Dropout top, a worker's batch) and the crop offsets."""
    net, n = tr.train_net, tr.n_workers
    batch = net.blob_shapes["data"][0] // n
    per_round = tr.batches_per_round
    data = math.prod(net.blob_shapes["data"][1:]) * 4
    if tr.config.device_preprocess is not None:
        data = 3 * TRAIN_RESIZE ** 2 * 4
    lead = per_round * n * batch if whole_rounds else batch * tr.sp.iter_size
    masks = {batch * math.prod(net.blob_shapes[lp.top[0]][1:])
             for lp in net.param.layer if lp.type == "Dropout"}
    return {"minibatch": {lead * data}, "label": {lead * 4},
            "dropout_mask": masks,
            "crop_offsets": {3 * batch * tr.sp.iter_size * 8}}


def train_app(ck, dev, smi: str, label: str, main_fn, argv: list[str], *,
              workers: int, tau: int, rounds: int, batch: int,
              want: dict, score_keys: set, loop=None,
              profile_path: str | None = None) -> dict:
    """One app's ``main`` on the card, with the launch counts set to 0
    just before it and read just after: checks the losses and scores,
    that the counts are exactly ``want``, that the master params moved
    and (under ``local_sgd``) are the mean of the workers' last-round
    params.  Prints per round: the loop's seconds (the wait for the feed
    plus the round), the round's own seconds, the feed's host seconds
    for that round, the wait, and img/s per card over the loop and over
    the round; then their medians over the steady rounds (round 0 warms
    up; a profiled round is left out).  ``loop="synchronous"`` runs the
    app with ``synchronous_loop`` in place of its ``run_training``.
    ``profile_path`` traces round ``PROFILE_ROUND``."""
    from sparknet_tpu_torch.apps import imagenet_app
    prof = (RoundProfile(PROFILE_ROUND, label, profile_path,
                         whole_rounds=loop != "synchronous")
            if profile_path else None)
    from contextlib import ExitStack
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with ExitStack() as stack:
        if loop == "synchronous":
            stack.enter_context(mock.patch.object(
                imagenet_app, "run_training",
                lambda *a, **kw: synchronous_loop(*a, profiler=prof, **kw)))
        elif prof is not None:
            stack.enter_context(prof.hooks())
        run = main_fn(argv)
    wall_s = time.perf_counter() - t0
    launches = dict(ck.launch_counts)
    tr = run.trainer
    losses = [tr.round_losses[r] for r in range(rounds)]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: round losses {losses}")
    if set(run.scores) != score_keys or not all(
            math.isfinite(v) for v in run.scores.values()):
        fail(f"{label}: eval scores {run.scores}")
    if launches != want:
        fail(f"{label}: launches {launches}, want {want}")
    if len(run.loop_seconds) != rounds:
        fail(f"{label}: {len(run.loop_seconds)} loop rounds, want {rounds}")
    init = tr.train_net.init(torch.Generator().manual_seed(0), device=dev)
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            if torch.equal(b, init[k][i]):
                fail(f"{label}: master param {k}[{i}] never moved")
            if tr.config.strategy != "local_sgd":
                continue
            mean = torch.stack([p[k][i] for p in tr.worker_params]).mean(0)
            if not torch.equal(b, mean):
                fail(f"{label}: master param {k}[{i}] is not the mean of "
                     f"the workers' params")
    images = workers * tau * batch
    report_rounds = []
    for r in range(rounds):
        sec, loop_s = tr.round_seconds[r], run.loop_seconds[r]
        report_rounds.append({
            "round": r, "loss": tr.round_losses[r], "loop_s": loop_s,
            "round_s": sec, "feed_host_s": run.feed.seconds[r],
            "feed_wait_s": run.feed_wait_seconds[r],
            "worker_step_ms": sec * 1e3 / (workers * tau),
            "img_s_loop": images / loop_s, "img_s_round": images / sec})
    steady = [r for r in report_rounds[1:]
              if prof is None or r["round"] != PROFILE_ROUND]
    medians = ({k: float(np.median([r[k] for r in steady]))
                for k in ("loop_s", "round_s", "feed_host_s", "feed_wait_s",
                          "img_s_loop", "img_s_round", "worker_step_ms")}
               if steady else None)
    if prof is not None and medians is not None:
        # the profiler slows the host; the unprofiled rounds' loop is the
        # wall time the card's busy seconds are a share of
        prof.result["busy_share_of_steady_loop"] = (
            prof.result["device_busy_s"] / medians["loop_s"])
    report = {"argv": argv, "loop": loop or "run_training",
              "strategy": tr.config.strategy,
              "preprocess": ("device" if tr.config.device_preprocess
                             else "host"),
              "wall_s": wall_s, "rounds": report_rounds,
              "steady_medians": medians, "steady_rounds": len(steady),
              "feed_stats": (tr.feed_stats.snapshot()
                             if loop != "synchronous" else None),
              "scores": run.scores, "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
              "profile": prof.result if prof is not None else None}
    print(f"{label} " + json.dumps(report), flush=True)
    for r in report_rounds:
        print(f"{label} [{smi}] round {r['round']}"
              f"{' (first, includes warm-up)' if r['round'] == 0 else ''}: "
              f"loop {r['loop_s']:.3f} s, round {r['round_s']:.3f} s, feed "
              f"host {r['feed_host_s']:.3f} s, feed wait "
              f"{r['feed_wait_s']:.3f} s; {r['img_s_loop']:.1f} img/s per "
              f"card over the loop, {r['img_s_round']:.1f} over the round; "
              f"loss {r['loss']:.4f}", flush=True)
    if prof is not None:
        print(f"{label} profile [{smi}] round {PROFILE_ROUND}: "
              + json.dumps(prof.result), flush=True)
    del init
    return {"report": report, "trainer": tr}


def imagenet_argv(model: str, dev, *, batch: int, tau: int, rounds: int,
                  workers: int = TRAIN_WORKERS, extra=()) -> list[str]:
    return ["--synthetic", "--model", model, "--workers", str(workers),
            "--batch", str(batch), "--tau", str(tau), "--rounds", str(rounds),
            "--test-interval", str(rounds), "--resize", str(TRAIN_RESIZE),
            "--device", str(dev), *extra]


def train_imagenet(ck, dev, smi: str, label: str, model: str, *,
                   mode: str, rounds: int = TRAIN_ROUNDS, extra=(),
                   profile_path: str | None = None,
                   initial_check: bool = False) -> dict:
    """``imagenet_app.main`` on the card, 2 workers, τ=5, synthetic
    256x256 images: CaffeNet at 227 (batch 64), GoogLeNet at 224 (batch
    32).  ``mode``: "host" (the app's loop, the crop on the feed's host
    thread), "device" (``--device-preprocess``) or "synchronous" (the
    loop before the device feed, ``synchronous_loop``).  Per worker step
    CaffeNet runs 2 LRN forwards, 2 LRN backwards and 3 pool backwards,
    GoogLeNet 2, 2 and 13 (4 strided, 9 stride-1); 2 inference LRNs per
    worker test batch; the crop launches no hand kernel.  The first round's loss sits near
    ln 1000 (within 1, the train loss carries Dropout; GoogLeNet's sums
    three heads and is not checked).  ``initial_check`` also checks the
    test-mode loss at init (``check_initial_test_loss``)."""
    from sparknet_tpu_torch.apps import imagenet_app
    batch = TRAIN_BATCH if model == "caffenet" else GN_BATCH
    pools = 3 if model == "caffenet" else 13
    steps = TRAIN_WORKERS * TRAIN_TAU * rounds
    extra = list(extra) + (["--device-preprocess"] if mode == "device"
                           else [])
    score_keys = ({"loss", "accuracy"} if model == "caffenet" else
                  {"loss3/loss3", "loss3/top-1", "loss3/top-5"})
    out = train_app(
        ck, dev, smi, label, imagenet_app.main,
        imagenet_argv(model, dev, batch=batch, tau=TRAIN_TAU, rounds=rounds,
                      extra=extra),
        workers=TRAIN_WORKERS, tau=TRAIN_TAU, rounds=rounds, batch=batch,
        score_keys=score_keys,
        loop="synchronous" if mode == "synchronous" else None,
        profile_path=profile_path,
        want={"lrn_across_channels_fwd": 2 * steps,
              "lrn_across_channels_bwd": 2 * steps,
              "max_pool_bwd": pools * steps,
              "lrn_across_channels": 2 * eval_batches(TRAIN_WORKERS,
                                                      batch)})
    tr = out["trainer"]
    crop = TRAIN_CROP if model == "caffenet" else GN_CROP
    if tr.train_net.blob_shapes["data"][-1] != crop:
        fail(f"{label}: the app did not crop to {crop}")
    if (tr.config.device_preprocess is not None) != (mode == "device"):
        fail(f"{label}: device_preprocess does not match mode {mode}")
    first = out["report"]["rounds"][0]["loss"]
    if model == "caffenet" and abs(first - math.log(1000)) > 1.0:
        fail(f"{label}: first round's loss {first:.4f} is not near "
             f"ln 1000 = {math.log(1000):.4f}")
    if initial_check:
        check_initial_test_loss(label, tr, dev, crop,
                                0.5 if model == "caffenet" else 1.0)
    return out


def train_sync_and_snapshot(ck, dev, smi: str) -> dict:
    """One CaffeNet round with ``--strategy sync`` (2 x 64, τ=5, host
    preprocess) and ``--snapshot``: the file restores into a fresh
    trainer on the card and one on the CPU, each with params equal to
    the run's bit for bit."""
    import tempfile
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "caffenet_sync.npz")
        out = train_imagenet(ck, dev, smi, "train_sync", "caffenet",
                             mode="host", rounds=1,
                             extra=["--strategy", "sync",
                                    "--snapshot", path])
        tr = out["trainer"]
        if tr.config.strategy != "sync" or tr.worker_params:
            fail("train_sync: the run was not sync")
        t0 = time.perf_counter()
        checked = {}
        for where in (dev, "cpu"):
            back = DistributedTrainer(tr.sp, TRAIN_WORKERS,
                                      TrainerConfig(strategy="sync"),
                                      seed=SEED + 1, device=where)
            back.restore(path)
            for k, blobs in tr.params.items():
                for i, b in enumerate(blobs):
                    if not torch.equal(b.cpu(), back.params[k][i].cpu()):
                        fail(f"snapshot: {k}[{i}] restored on {where} "
                             f"differs")
            if (back.iter, back.round) != (tr.iter, tr.round):
                fail(f"snapshot: iter/round {back.iter}/{back.round}")
            checked[str(where)] = True
            del back
        report = {"bytes": os.path.getsize(path),
                  "restored_equal": checked,
                  "restore_s": time.perf_counter() - t0}
    print("snapshot " + json.dumps(report), flush=True)
    out["snapshot"] = report
    return out


def check_initial_test_loss(label: str, tr, dev, crop: int,
                            tol: float) -> float:
    """The test-mode loss of the initial params on a batch made as the
    app makes its test batches (synthetic images, center crop, less
    their mean), with random labels: within ``tol`` of ln 1000."""
    from sparknet_tpu_torch.apps.imagenet_app import synthetic_imagenet
    from sparknet_tpu_torch.data import center_crop
    from sparknet_tpu_torch.utils.device import full_f32
    init = tr.train_net.init(torch.Generator().manual_seed(0), device=dev)
    n = tr.test_net.blob_shapes["data"][0] // tr.n_workers
    x, y = synthetic_imagenet(n, TRAIN_RESIZE, 1000, SEED + 6)
    batch = {"data": torch.from_numpy(center_crop(
        x, crop, mean=x.mean(axis=0))).to(dev),
        "label": torch.from_numpy(y.astype(np.float32)).to(dev)}
    with torch.inference_mode(), full_f32():
        loss = float(tr.test_net.forward(init, batch, train=False).loss)
    print(f"{label}: test-mode loss at init {loss:.4f} "
          f"(ln 1000 = {math.log(1000):.4f})", flush=True)
    if abs(loss - math.log(1000)) > tol:
        fail(f"{label}: the test-mode loss at init, {loss:.4f}, is not "
             f"within {tol} of ln 1000")
    return loss


def identity_lrn():
    """A planted fault for a CPU round: every LRN the identity."""
    from sparknet_tpu_torch.ops import vision
    return mock.patch.object(vision, "relu_lrn", lambda x, *args, **kw: x)


def kernel_area_ave_pool():
    """A planted fault for a CPU round: AVE pooling divided by the kernel
    area (torch's own convention) in place of Caffe's clipped window."""
    from sparknet_tpu_torch.ops import vision

    def ave(x, kh, kw, sh, sw, ph, pw, oh, ow):
        pads = vision._pool_pads(x.shape[2], x.shape[3], kh, kw, sh, sw,
                                 ph, pw, oh, ow)
        x = F.pad(x, pads)[:, :, :(oh - 1) * sh + kh, :(ow - 1) * sw + kw]
        return F.avg_pool2d(x, (kh, kw), (sh, sw))
    return mock.patch.object(vision, "ave_pool", ave)


def one_round(sp, batches: dict, device, *, f64: bool = False,
              strategy: str = "local_sgd") -> tuple[float, dict]:
    """One round of a fresh 2-worker trainer (seed ``SEED``, τ from the
    batches) on ``device``: its loss and its master params in f64 on the
    host.  ``f64`` runs the port's same code in f64 (the plain kernels
    compute in f64 for f64 tensors)."""
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    tr = DistributedTrainer(sp, 2, TrainerConfig(
        strategy=strategy, tau=len(batches["label"])), seed=SEED,
        device=device)
    feed = batches
    if f64:
        tr.params = {k: [b.double() for b in v]
                     for k, v in tr.params.items()}
        tr.state = tr.init_state()
        feed = {k: v.astype(np.float64) for k, v in batches.items()}
    loss = tr.train_round(feed)
    return loss, {k: [b.cpu().double() for b in v]
                  for k, v in tr.params.items()}


def rel_errors(params: dict, ref: dict) -> dict:
    """max|Δ|/max|ref| per blob."""
    return {f"{k}[{i}]": float((a - b).abs().max() / b.abs().max())
            for k in ref for i, (a, b) in enumerate(zip(params[k], ref[k]))}


def plain_kernels():
    """The training path with every hand kernel swapped for its plain
    PyTorch version, on any device (not a fault: the yardstick the
    kernels are held to)."""
    from contextlib import ExitStack
    from sparknet_tpu_torch.ops import cuda_kernels as ck
    from sparknet_tpu_torch.ops import vision
    stack = ExitStack()
    for name in ("lrn_across_channels_fwd", "lrn_across_channels_bwd",
                 "max_pool_bwd"):
        stack.enter_context(mock.patch.object(
            vision, name, getattr(ck, f"{name}_reference")))
    return stack


def train_against_cpu(dev, label: str, sp, batches: dict, planted,
                      strategy: str = "local_sgd") -> dict:
    """One round (2 workers, τ from the batches) from the same weights,
    batches and CPU-drawn Dropout masks on the card, on the CPU in f32,
    and on the CPU in f64.  The round's loss on the card must agree with
    the CPU's within 1e-4 relative.  Per blob, max|Δ|/max|ref| of the
    averaged params against the f64 round must be within 1e-3, or within
    10x the CPU f32 round's own error: a zero-initialised convolution
    bias holds only its first update, a sum over ~10^5 positions with
    heavy cancellation, where f32 on either device misses the f64 answer
    by more than 1e-3.  The card's round runs on cuDNN's deterministic
    algorithms (``cudnn_deterministic``), so the comparison is the same on
    every call.  The same checks must see a CPU round run under
    ``planted`` (a context that plants a fault)."""
    with cudnn_deterministic():
        card_loss, card = one_round(sp, batches, dev, strategy=strategy)
    cpu_loss, cpu = one_round(sp, batches, "cpu", strategy=strategy)
    _, exact = one_round(sp, batches, "cpu", f64=True, strategy=strategy)
    with planted:
        planted_loss, planted_params = one_round(sp, batches, "cpu",
                                                 strategy=strategy)
    cpu_err = rel_errors(cpu, exact)
    allowed = {b: max(1e-3, 10.0 * e) for b, e in cpu_err.items()}
    card_err = rel_errors(card, exact)
    planted_err = rel_errors(planted_params, exact)
    card_vs_cpu = rel_errors(card, cpu)
    out = {"strategy": strategy,
           "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss),
           "planted_loss_rel": abs(planted_loss - cpu_loss) / abs(cpu_loss),
           "card_loss": card_loss, "cpu_loss": cpu_loss,
           "card_vs_cpu_max": max(card_vs_cpu.values()),
           "card_vs_cpu_over_1e-3": {b: e for b, e in card_vs_cpu.items()
                                     if e > 1e-3},
           "card_vs_f64": card_err, "cpu_f32_vs_f64": cpu_err,
           "planted_vs_f64_max": max(planted_err.values()),
           "planted_blobs_beyond_bound": sum(
               e > allowed[b] for b, e in planted_err.items())}
    print(f"{label} card vs CPU " + json.dumps(out), flush=True)
    over = {b: e for b, e in card_err.items() if e > allowed[b]}
    if over or not out["loss_rel"] <= 1e-4:
        fail(f"{label}: the card's round differs from the CPU's: loss "
             f"{out['loss_rel']:.3e}, blobs beyond their bound {over}")
    if (out["planted_loss_rel"] <= 1e-4
            and all(e <= allowed[b] for b, e in planted_err.items())):
        fail(f"{label}: the planted fault passes the card-vs-CPU checks: "
             f"{out}")
    return out


def image_batches(seed: int, global_batch: int, crop: int, classes: int,
                  tau: int = 2):
    """One round's batches of images at std 58 with random labels."""
    gen = np.random.default_rng(seed)
    return {"data": (IMAGE_STD * gen.normal(
        size=(tau, global_batch, 3, crop, crop))).astype(np.float32),
            "label": gen.integers(0, classes, (tau, global_batch)).astype(
                np.float32)}


def caffenet_against_cpu(dev, strategy: str = "local_sgd") -> dict:
    """Full-width CaffeNet, 2 workers x batch 8; identity LRNs
    planted."""
    from sparknet_tpu_torch.apps.imagenet_app import SOLVER
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(SOLVER, caffenet(16, 16,
                                                        crop=TRAIN_CROP))
    return train_against_cpu(
        dev, "train" if strategy == "local_sgd" else f"train_{strategy}", sp,
        image_batches(SEED + 4, 16, TRAIN_CROP, 1000), identity_lrn(),
        strategy=strategy)


def googlenet_against_cpu(dev) -> dict:
    """Full-width GoogLeNet with its auxiliary heads and Dropout, 2
    workers x batch 2, one step each (τ=1); identity LRNs planted.  At
    τ=2 the second step starts from weights the first moved far (the
    three heads' loss is ~35 at init on std-58 images), and f32 on
    either device drifts from the f64 round by up to 3e-3 in the weights
    (measured on an H100), so a blob's bound, set by the CPU's own error
    in that blob, no longer measures the card."""
    from sparknet_tpu_torch.apps.imagenet_app import SOLVER
    from sparknet_tpu_torch.models import googlenet
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(SOLVER, googlenet(4, 4, crop=GN_CROP))
    return train_against_cpu(dev, "train_googlenet", sp,
                             image_batches(SEED + 7, 4, GN_CROP, 1000, tau=1),
                             identity_lrn())


def googlenet_tau2_kernels_vs_plain(dev) -> dict:
    """GoogLeNet's round at τ=2 (2 workers x batch 2, the batches of
    ``googlenet_against_cpu`` with a second step), on the card with the
    hand kernels and on the card with their plain versions, each against
    the f64 CPU round, beside the CPU's own f32 error.  Which blobs are
    beyond 10x the CPU's error in each card round tells rounding (the
    plain round shows them too) from a kernel fault (only the kernels'
    round does).  The kernels' round must also stay within 1e-3 per blob
    of the plain round on the same card: the two differ only in the
    pool backward's order of summation."""
    from sparknet_tpu_torch.apps.imagenet_app import SOLVER
    from sparknet_tpu_torch.models import googlenet
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(SOLVER, googlenet(4, 4, crop=GN_CROP))
    batches = image_batches(SEED + 7, 4, GN_CROP, 1000, tau=2)
    k_loss, kern = one_round(sp, batches, dev)
    with plain_kernels():
        p_loss, plain = one_round(sp, batches, dev)
    c_loss, cpu = one_round(sp, batches, "cpu")
    _, exact = one_round(sp, batches, "cpu", f64=True)
    cpu_err = rel_errors(cpu, exact)
    allowed = {b: max(1e-3, 10.0 * e) for b, e in cpu_err.items()}
    kern_err, plain_err = rel_errors(kern, exact), rel_errors(plain, exact)
    kern_vs_plain = rel_errors(kern, plain)
    out = {"losses": {"kernels": k_loss, "plain": p_loss, "cpu": c_loss},
           "kernels_beyond": {b: [e, cpu_err[b]] for b, e in kern_err.items()
                              if e > allowed[b]},
           "plain_beyond": {b: [e, cpu_err[b]] for b, e in plain_err.items()
                            if e > allowed[b]},
           "kernels_vs_f64_max": max(kern_err.values()),
           "plain_vs_f64_max": max(plain_err.values()),
           "cpu_vs_f64_max": max(cpu_err.values()),
           "kernels_vs_plain_max": max(kern_vs_plain.values()),
           "kernels_vs_plain_top": dict(sorted(
               kern_vs_plain.items(), key=lambda kv: -kv[1])[:5])}
    print("googlenet_tau2 " + json.dumps(out), flush=True)
    if out["kernels_vs_plain_max"] > 1e-3:
        fail(f"googlenet_tau2: the kernels' round is "
             f"{out['kernels_vs_plain_max']:.3e} from the plain round on "
             f"the card")
    return out


def train_cifar(ck, dev, smi: str, model: str) -> dict:
    """``cifar_app.main --synthetic --model <model>`` on the card at
    CifarApp's batch 100 and τ=10, 2 workers, 2 rounds: one pool backward
    per worker step (the AVE pools and WITHIN_CHANNEL LRNs are library
    work), then one round on the card against the CPU's at the same
    batch, with the AVE divisor of the kernel area planted."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.models import cifar10_full, cifar10_quick
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    steps = TRAIN_WORKERS * CIFAR_TAU * CIFAR_ROUNDS
    argv = ["--synthetic", "--model", model, "--workers", str(TRAIN_WORKERS),
            "--batch", str(CIFAR_BATCH), "--tau", str(CIFAR_TAU),
            "--rounds", str(CIFAR_ROUNDS), "--device", str(dev)]
    out = train_app(
        ck, dev, smi, f"train_cifar10_{model}", cifar_app.main, argv,
        workers=TRAIN_WORKERS, tau=CIFAR_TAU, rounds=CIFAR_ROUNDS,
        batch=CIFAR_BATCH, score_keys={"loss", "accuracy"},
        want={"lrn_across_channels_fwd": 0, "lrn_across_channels_bwd": 0,
              "max_pool_bwd": steps, "lrn_across_channels": 0})
    net = (cifar10_full if model == "full" else cifar10_quick)(
        2 * CIFAR_BATCH, 2 * CIFAR_BATCH)
    sp = load_solver_prototxt_with_net(cifar_app.SOLVER, net)
    x, y = cifar_app.synthetic_cifar(2 * 2 * CIFAR_BATCH, seed=SEED + 8)
    x = x - x.mean(axis=0)
    batches = {"data": x.reshape(2, 2 * CIFAR_BATCH, 3, 32, 32),
               "label": y.astype(np.float32).reshape(2, 2 * CIFAR_BATCH)}
    out["against_cpu"] = train_against_cpu(
        dev, f"train_cifar10_{model}", sp, batches, kernel_area_ave_pool())
    return out


def train_vgg16(ck, dev, smi: str) -> dict:
    """``imagenet_app.main --model vgg16``, one short round: 2 workers x
    batch 32, τ=2; five pool backwards per worker step, no LRN."""
    from sparknet_tpu_torch.apps import imagenet_app
    steps = TRAIN_WORKERS * 2
    return train_app(
        ck, dev, smi, "train_vgg16", imagenet_app.main,
        imagenet_argv("vgg16", dev, batch=GN_BATCH, tau=2, rounds=1),
        workers=TRAIN_WORKERS, tau=2, rounds=1, batch=GN_BATCH,
        score_keys={"loss", "accuracy", "accuracy_top5"},
        want={"lrn_across_channels_fwd": 0, "lrn_across_channels_bwd": 0,
              "max_pool_bwd": 5 * steps, "lrn_across_channels": 0})


# ---------------------------------------------------------------------------
# Phase 5b: the Solver, weights and solver state on disk
# ---------------------------------------------------------------------------

# bvlc_reference_caffenet's published solver (base_lr, the step policy,
# gamma, momentum, weight_decay, display) with its schedule cut to the
# smoke's depth: stepsize 100000 -> 10 (so the policy acts), max_iter
# 450000 -> 20, test_interval 1000 -> 10, test_iter 1000 -> 2, snapshot
# 10000 -> 20.  average_loss 20 keeps every iteration's loss in the
# Solver's window, so the first one can be checked.
CAFFENET_SOLVER = """
base_lr: 0.01
lr_policy: "step"
gamma: 0.1
stepsize: 10
momentum: 0.9
weight_decay: 0.0005
display: 20
max_iter: 20
test_interval: 10
test_iter: 2
snapshot: 20
average_loss: 20
"""
SOLVER_ITERS, SOLVER_TESTS, SOLVER_TEST_ITER = 20, 3, 2
SOLVER_TRAIN_BATCH, SOLVER_TEST_BATCH = 256, 50   # the published batches
SOLVER_FEED = 4          # train batches made on the card once, then cycled
RESUME_ITERS = 5
# Caffe's six rules on cifar10_quick, the cifar app's settings (base_lr
# 0.001, momentum 0.9, weight_decay 0.004) with each rule's own fields
CIFAR_RULES = {
    "SGD": 'type: "SGD"\nbase_lr: 0.001\nmomentum: 0.9\n',
    "Nesterov": 'type: "Nesterov"\nbase_lr: 0.001\nmomentum: 0.9\n',
    "AdaGrad": 'type: "AdaGrad"\nbase_lr: 0.01\ndelta: 1e-8\n',
    "RMSProp": ('type: "RMSProp"\nbase_lr: 0.001\nrms_decay: 0.98\n'
                'delta: 1e-8\n'),
    "Adam": ('type: "Adam"\nbase_lr: 0.001\nmomentum: 0.9\n'
             'momentum2: 0.999\ndelta: 1e-8\n'),
    "AdaDelta": ('type: "AdaDelta"\nbase_lr: 1.0\nmomentum: 0.95\n'
                 'delta: 1e-6\n'),
}
RULE_ITERS, RULE_RESUME_ITERS = 10, 3


def card_batches(dev, n: int, batch: int, crop: int, seed: int) -> list:
    """``n`` batches of std-58 images with random labels, drawn on the
    card from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [{"data": IMAGE_STD * torch.randn((batch, 3, crop, crop),
                                             generator=gen, device=dev),
             "label": torch.randint(0, 1000, (batch,), generator=gen,
                                    device=dev).float()}
            for _ in range(n)]


def differing(a: dict, b: dict) -> list[str]:
    """Blobs of two {layer: [tensor or array]} trees that are not equal
    bit for bit (a missing layer counts)."""
    host = lambda t: (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t))
    out = [k for k in set(a) ^ set(b)]
    for k in set(a) & set(b):
        out += [f"{k}[{i}]" for i, (x, y) in enumerate(zip(a[k], b[k]))
                if host(x).tobytes() != host(y).tobytes()]
        if len(a[k]) != len(b[k]):
            out.append(f"{k} count")
    return out


def state_differs(a, b) -> list[str]:
    if set(a) != set(b):
        return [f"slots {sorted(a)} != {sorted(b)}"]
    return [f"{s}:{x}" for s in a for x in differing(a[s], b[s])]


def max_rel(a: dict, b: dict) -> float:
    """max over blobs of max|a - b| / max|b|."""
    return max(float((x.double() - y.double()).abs().max()
                     / y.double().abs().max().clamp_min(1e-30))
               for k in b for x, y in zip(a[k], b[k]))


def clone_tree(t: dict) -> dict:
    return {k: [b.detach().clone() for b in v] for k, v in t.items()}


def timed_writes(times: dict):
    """Time ``save_caffemodel``/``save_solverstate`` wherever the Solver
    calls them (its snapshot on schedule)."""
    from contextlib import ExitStack
    from sparknet_tpu_torch.proto import caffemodel
    stack = ExitStack()
    for name in ("save_caffemodel", "save_solverstate"):
        real = getattr(caffemodel, name)

        def wrapper(*args, real=real, name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real(*args, **kw)
            times[name] = time.perf_counter() - t0
        stack.enter_context(mock.patch.object(caffemodel, name, wrapper))
    return stack


def solver_caffenet(ck, dev, smi: str, d: str) -> dict:
    """Full-width CaffeNet (batch 256 train, 50 test) through the Solver on
    the published solver at the smoke's depth: ``solve()`` with its test
    passes and its snapshot on schedule, exact launches; the snapshot's
    ``.caffemodel`` read on the CPU equal to the card's params, the pair
    restored into a fresh card Solver bit for bit, and both solvers' next
    5 iterations (Dropout generator state copied) within rtol 2e-4, atol
    2e-5; a transposed fc6 weight refused; the Solver's ms per iteration
    against the trainer's worker step at the same batch, same call."""
    import itertools
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    from sparknet_tpu_torch.proto import (load_caffemodel, load_solverstate,
                                          load_solver_prototxt_with_net,
                                          save_caffemodel)
    from sparknet_tpu_torch.solvers import Solver
    prefix = os.path.join(d, "caffenet")
    sp = load_solver_prototxt_with_net(
        CAFFENET_SOLVER, caffenet(SOLVER_TRAIN_BATCH, SOLVER_TEST_BATCH,
                                  crop=TRAIN_CROP), snapshot_prefix=prefix)
    if (sp.snapshot, sp.max_iter, sp.test_interval) != (20, 20, 10):
        fail(f"solver: schedule {sp.snapshot} {sp.max_iter} "
             f"{sp.test_interval}")
    t0 = time.perf_counter()
    a = Solver(sp, seed=SEED, device=dev)
    build_s = time.perf_counter() - t0
    train = card_batches(dev, SOLVER_FEED, SOLVER_TRAIN_BATCH, TRAIN_CROP,
                         SEED + 30)
    test = card_batches(dev, SOLVER_TEST_ITER, SOLVER_TEST_BATCH, TRAIN_CROP,
                        SEED + 31)
    a.set_train_data(itertools.cycle(train))
    a.set_test_data(lambda: iter(test))
    # the test-mode loss at init, what solve()'s pass at iteration 0 logs,
    # against the CPU's forward of the same params on the same batches.
    # It sits above ln 1000 by about s^2 / 2: at init every sample's fc8
    # is nearly the same vector, spread by the fc7 biases (1) through fc8
    # (std 0.01 over 4096 inputs), s^2 ~ 0.4; the apps' check allows 0.5
    init_loss = a.test(SOLVER_TEST_ITER)["loss"] / SOLVER_TEST_ITER
    cpu_params = {k: [b.cpu() for b in v] for k, v in a.params.items()}
    with torch.no_grad():
        cpu_loss = sum(float(a.test_net.forward(
            cpu_params, {k: v.cpu() for k, v in b.items()},
            train=False).loss) for b in test) / SOLVER_TEST_ITER
    del cpu_params
    if abs(init_loss - cpu_loss) > 1e-4 * abs(cpu_loss) or \
            abs(init_loss - math.log(1000)) > 0.5:
        fail(f"solver_caffenet: test loss at init {init_loss:.6f}, the "
             f"CPU's {cpu_loss:.6f} (ln 1000 = {math.log(1000):.4f})")
    writes: dict = {}
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_writes(writes):
        final = a.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    training = dict(ck.launch_counts)
    want = {"lrn_across_channels_fwd": 2 * SOLVER_ITERS,
            "lrn_across_channels_bwd": 2 * SOLVER_ITERS,
            "max_pool_bwd": 3 * SOLVER_ITERS,
            "lrn_across_channels": 2 * SOLVER_TESTS * SOLVER_TEST_ITER}
    if training != want:
        fail(f"solver_caffenet: launches {training}, want {want}")
    losses = [float(v) for v in a._smoothed]
    if a.iter != SOLVER_ITERS or len(losses) != SOLVER_ITERS or not all(
            math.isfinite(v) for v in losses + [final]):
        fail(f"solver_caffenet: iter {a.iter}, losses {losses}")
    # in train mode Dropout (fc6 and fc7, biases 1 at init) gives the
    # logits a per-sample variance of about 1, so the first training loss
    # sits about 0.5 above ln 1000 (the apps' check allows 1)
    if abs(losses[0] - math.log(1000)) > 1.0:
        fail(f"solver_caffenet: first loss {losses[0]:.4f} is not within "
             f"1 of ln 1000")
    model = f"{prefix}_iter_{SOLVER_ITERS}.caffemodel"
    state = f"{prefix}_iter_{SOLVER_ITERS}.solverstate"
    if not (os.path.exists(model) and os.path.exists(state)) or \
            set(writes) != {"save_caffemodel", "save_solverstate"}:
        fail(f"solver_caffenet: snapshot on schedule wrote {os.listdir(d)}")
    saved_params, saved_state = clone_tree(a.params), {
        s: clone_tree(t) for s, t in a.state.items()}
    sizes = {"caffemodel": os.path.getsize(model),
             "solverstate": os.path.getsize(state)}
    t0 = time.perf_counter()
    on_cpu = load_caffemodel(model)
    reads = {"load_caffemodel": time.perf_counter() - t0}
    bad = differing(on_cpu, a.params)
    if bad:
        fail(f"solver_caffenet: the .caffemodel read on the CPU differs "
             f"from the card's params in {bad[:5]}")
    t0 = time.perf_counter()
    st = load_solverstate(state)
    reads["load_solverstate"] = time.perf_counter() - t0
    if st["iter"] != SOLVER_ITERS or st["learned_net"] != model:
        fail(f"solver_caffenet: solverstate iter {st['iter']}, learned_net "
             f"{st['learned_net']}")
    del st
    # the test pass alone: the inference kernel, 2 a forward
    ck.reset_launch_counts()
    scores = a.test(SOLVER_TEST_ITER)
    test_launches = dict(ck.launch_counts)
    want_test = {k: 0 for k in want}
    want_test["lrn_across_channels"] = 2 * SOLVER_TEST_ITER
    if test_launches != want_test or set(scores) != {"loss", "accuracy"} \
            or not all(math.isfinite(v) for v in scores.values()):
        fail(f"solver_caffenet test: launches {test_launches}, scores "
             f"{scores}")
    # restore into a fresh card Solver: bit for bit
    b = Solver(sp, seed=SEED + 1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.restore_caffe(state)
    torch.cuda.synchronize()
    reads["restore_caffe"] = time.perf_counter() - t0
    bad = differing(b.params, saved_params) + state_differs(b.state,
                                                            saved_state)
    if bad or b.iter != SOLVER_ITERS:
        fail(f"solver_caffenet: restore_caffe differs in {bad[:5]}, iter "
             f"{b.iter}")
    # both run on from iteration 20 on the same batches, the Dropout
    # generator's state copied across
    b.generator.set_state(a.generator.get_state())
    nxt = [train[i % SOLVER_FEED]
           for i in range(SOLVER_ITERS, SOLVER_ITERS + RESUME_ITERS)]
    runs = []
    with cudnn_deterministic():
        for s in (a, b):
            s.set_train_data(iter(nxt))
            s.step(RESUME_ITERS)
            runs.append([float(v) for v in list(s._smoothed)[-RESUME_ITERS:]])
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(*runs))
    param_fail = [f"{k}[{i}]" for k in a.params
                  for i, (x, y) in enumerate(zip(b.params[k], a.params[k]))
                  if not torch.allclose(x, y, rtol=2e-4, atol=2e-5)]
    resumed = {"loss_rel": loss_rel, "params_max_rel": max_rel(b.params,
                                                               a.params),
               "bit_equal": not differing(b.params, a.params)}
    if param_fail or not np.allclose(runs[1], runs[0], rtol=2e-4,
                                     atol=2e-5):
        fail(f"solver_caffenet: the resumed run differs: losses {runs}, "
             f"blobs {param_fail[:5]}")
    # planted: fc6's weight transposed must be refused
    fc6 = os.path.join(d, "fc6_transposed.caffemodel")
    save_caffemodel(fc6, {"fc6": [on_cpu["fc6"][0].T.copy(),
                                  on_cpu["fc6"][1]]})
    try:
        b.load_weights(fc6)
        fail("solver_caffenet: a transposed fc6 weight was loaded")
    except ValueError as e:
        refused = str(e)
    os.remove(fc6)
    del b, on_cpu
    # ms per iteration, warm, against the trainer's worker step at the
    # same batch in the same call
    a.set_train_data(itertools.cycle(train))
    a.step(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.step(10)
    torch.cuda.synchronize()
    solver_ms = (time.perf_counter() - t0) * 1e3 / 10
    del a, saved_params, saved_state
    torch.cuda.empty_cache()
    tr = DistributedTrainer(sp, 1, TrainerConfig(tau=5), seed=SEED,
                            device=dev)
    rnd = {k: torch.stack([train[i % SOLVER_FEED][k] for i in range(5)])
           for k in ("data", "label")}
    for _ in range(3):
        tr.train_round(rnd)
    trainer_ms = min(tr.round_seconds[r] for r in (1, 2)) * 1e3 / 5
    del tr, rnd
    mb = lambda n: n / 1e6
    report = {
        "iters": SOLVER_ITERS, "test_loss_at_init": init_loss,
        "test_loss_at_init_cpu": cpu_loss,
        "first_loss": losses[0],
        "last_loss": losses[-1], "solve_s": solve_s, "build_s": build_s,
        "launches_training": training, "launches_test": test_launches,
        "test_scores": scores, "resumed": resumed,
        "planted_transposed_fc6": refused[:120],
        "sizes_mb": {k: mb(v) for k, v in sizes.items()},
        "write_s": writes, "read_s": reads,
        "write_mb_s": {"caffemodel": mb(sizes["caffemodel"])
                       / writes["save_caffemodel"],
                       "solverstate": mb(sizes["solverstate"])
                       / writes["save_solverstate"]},
        "read_mb_s": {"caffemodel": mb(sizes["caffemodel"])
                      / reads["load_caffemodel"],
                      "solverstate": mb(sizes["solverstate"])
                      / reads["load_solverstate"]},
        "solver_ms_per_iter_b256": solver_ms,
        "trainer_worker_step_ms_b256": trainer_ms}
    print(f"solver_caffenet [{smi}] " + json.dumps(report), flush=True)
    return {"report": report, "model": model, "state": state}


def serve_weights(dev, smi: str, model: str) -> dict:
    """``ModelHouse.load("caffenet", weights=model)`` through the engine in
    bf16 and f32: the served params are the file's bit for bit, the f32
    fc8 within the serving check's bound (1e-4) of the CPU forward on
    the same params (identity LRNs planted), and its fc8 differs from a
    seeded load's."""
    from sparknet_tpu_torch.parallel.serving import ModelHouse, ServeConfig
    from sparknet_tpu_torch.proto import load_caffemodel
    want = load_caffemodel(model)
    out = {}
    for dtype in ("bf16", "f32"):
        rep, lm = serve(dtype, dev, weights=model, duration_s=0.5,
                        n_inputs=8, legs={1: (1, 1), 4: (4, 1), 16: (4, 4)},
                        tag=f"_weights_{dtype}", min_completed=32)
        bad = differing(lm.params, {k: want[k] for k in lm.params})
        if bad or lm.info()["weights"] != model:
            fail(f"serving weights {dtype}: params differ from the file in "
                 f"{bad[:5]}")
        if dtype == "f32":
            rel, planted, tf32 = check_against_cpu(lm, "fc8")
            seeded = ModelHouse(ServeConfig(dtype="f32", seed=SEED),
                                device=dev).load("caffenet")
            gen = np.random.default_rng(SEED + 32)
            x = torch.from_numpy((IMAGE_STD * gen.normal(
                size=(4,) + lm.in_shape)).astype(np.float32)).to(dev)
            with torch.inference_mode(), lm.precision():
                fc8 = [m.net.apply(m.params, {"data": x}, blobs=["fc8"])
                       ["fc8"] for m in (lm, seeded)]
            moved = float((fc8[0] - fc8[1]).abs().max()
                          / fc8[1].abs().max())
            rep.update(card_vs_cpu=rel, planted=planted,
                       fc8_vs_seeded=moved)
            print(f"caffenet from {os.path.basename(model)} f32 fc8 card vs "
                  f"CPU: {rel:.3e} (limit 1e-4; identity LRNs {planted:.3e}); "
                  f"vs a seeded load {moved:.3e}", flush=True)
            if any(tf32) or not rel <= 1e-4 or not planted > 1e-4:
                fail(f"serving weights: f32 fc8 card vs CPU {rel:.3e}, "
                     f"planted {planted:.3e}, TF32 {tf32}")
            if not moved > 1e-2:
                fail(f"serving weights: fc8 is within {moved:.3e} of a "
                     f"seeded load's: the file was not used")
            del seeded
        out[dtype] = rep
        del lm
    print(f"serving_weights [{smi}] " + json.dumps(
        {d: {"load_s": r["load_s"], "dispatches": r["dispatches"],
             "lrn_launches": r["lrn_launches"], "batch_ms": r["batch_ms"]}
         for d, r in out.items()}), flush=True)
    return out


def adadelta_reads_new_sq_update(sp):
    """A planted fault: AdaDelta in place computing its update from the
    sq_update it has just written, not the old one."""
    from sparknet_tpu_torch.solvers import update_rules as ur

    def init(params):
        return {"sq_grad": ur._zeros(params), "sq_update": ur._zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, rate, step, lr_mults=None):
        mu = sp.momentum
        for k, i, p, r in ur._blobs(params, rate, lr_mults):
            g = grads[k][i]
            sq_g, sq_u = state["sq_grad"][k][i], state["sq_update"][k][i]
            sq_g.mul_(mu).addcmul_(g, g, value=1.0 - mu)
            first = (sq_u + sp.delta).div_(sq_g + sp.delta).sqrt_().mul_(g)
            sq_u.mul_(mu).addcmul_(first, first, value=1.0 - mu)
            upd = (sq_u + sp.delta).div_(sq_g + sp.delta).sqrt_().mul_(g)
            p.sub_(upd, alpha=r)
        return params, state
    return ur.SolverUpdate("ADADELTA", init, apply)


def cpu_solver(sp, dtype, rule=None):
    """A fresh CPU Solver in ``dtype`` (f64: the same code in f64), with
    ``rule`` (a planted update rule) in place of the solver's."""
    from sparknet_tpu_torch.solvers import Solver
    from sparknet_tpu_torch.solvers.step import make_step_fns
    s = Solver(sp, seed=SEED + 1, device="cpu")
    if rule is not None:
        s.rule = rule(sp)
        _, s._local_update, _ = make_step_fns(sp, s.train_net, s.rule,
                                              s._lr_mults, s._decay_mults)
    s.params = {k: [b.to(dtype) for b in v] for k, v in s.params.items()}
    s.state = s.rule.init(s.params)
    return s


def feed_of(batches: list, dtype) -> Iterator:
    return iter({k: torch.from_numpy(v).to(dtype) for k, v in b.items()}
                for b in batches)


def free_run(sp, weights: str, batches: list, dtype) -> list[float]:
    """Per-iteration losses of a CPU Solver from the ``weights`` file."""
    s = cpu_solver(sp, dtype)
    s.load_weights(weights)
    s.params = {k: [b.to(dtype) for b in v] for k, v in s.params.items()}
    s.set_train_data(feed_of(batches, dtype))
    return [s.step(1) for _ in batches]


def host_f64(tree: dict) -> dict:
    return {k: [b.detach().cpu().double() for b in v] for k, v in tree.items()}


def replay(sp, traj: list, batches: list, dtype, rule=None):
    """Each iteration ``t`` of the card's run again on the CPU from the
    card's params and state before it (``traj[t]``): the losses and each
    iteration's update of the params, in f64."""
    s = cpu_solver(sp, dtype, rule)
    losses, updates = [], []
    for t, b in enumerate(batches):
        params, state = traj[t]
        # copies: the update writes them in place
        s.params = {k: [x.to(dtype, copy=True) for x in v]
                    for k, v in params.items()}
        s.state = {slot: {k: [x.to(dtype, copy=True) for x in v]
                          for k, v in tr.items()}
                   for slot, tr in state.items()}
        s.iter = t
        s.set_train_data(feed_of([b], dtype))
        losses.append(s.step(1))
        updates.append({k: [n.double() - p for n, p in zip(s.params[k], v)]
                        for k, v in params.items()})
    return losses, updates


def update_err(got: list, ref: list) -> float:
    """max over iterations of ||got - ref|| / ||ref||, over every blob."""
    def one(g, r):
        num = sum(float((x - y).pow(2).sum()) for k in r
                  for x, y in zip(g[k], r[k]))
        den = sum(float(y.pow(2).sum()) for k in r for y in r[k])
        return math.sqrt(num / den)
    return max(one(g, r) for g, r in zip(got, ref))


def solver_rules_cifar(ck, dev, smi: str, d: str) -> dict:
    """Each of Caffe's six rules through the Solver on cifar10_quick at
    the app's batch 100 and data (pool1, a 3/2 MAX pool: one pool
    backward an iteration), 10 iterations on the card from a
    ``.caffemodel``, checked two ways against the CPU:

    - free-running: the same 10 iterations on the CPU from the same file,
      in f32 and in f64.  The card's per-iteration losses must be within
      max(1e-3, 10x the CPU f32 run's own error) of the f64 run's:
      ``train_against_cpu``'s rule for a blob after a round (within 1e-3,
      or 10x the CPU's own error).  AdaGrad, RMSProp, Adam and AdaDelta step by about
      base_lr x sign(g) at first (RMSProp by 7x that), so gradient
      elements that are rounding noise around zero take full steps and
      every f32 run wanders from the f64 one by a draw of its own.
    - lockstep: each card iteration again on the CPU, in f32 and in f64,
      from the card's params and state before it: one iteration's
      rounding, not ten compounded.  The card's loss must be within 1e-4
      of the f64 one (``train_against_cpu``'s loss bound), and its update
      of the params within max(1e-3, 10x the CPU f32 update's error) of
      the f64 update (L2 over every blob).

    The card's iterations run on cuDNN's deterministic algorithms: the
    default ones vary from run to run (AdaGrad's free-running error on an
    H100 was 4.1e-4 in one run and 9.3e-4 in another), and the rules
    amplify that.  Adam and AdaDelta: snapshot_caffe at 10, restore_caffe into a fresh
    card Solver (bit for bit), 3 more iterations equal to the
    uninterrupted run.  Planted: AdaDelta reading its new sq_update (the
    lockstep update check), Adam resumed at iter 0, swapped history
    slots, a history one blob short."""
    from sparknet_tpu_torch.apps.cifar_app import synthetic_cifar
    from sparknet_tpu_torch.models import cifar10_quick
    from sparknet_tpu_torch.proto import (load_solver_prototxt_with_net,
                                          load_solverstate, save_solverstate)
    from sparknet_tpu_torch.solvers import Solver
    n = RULE_ITERS + RULE_RESUME_ITERS
    x, y = synthetic_cifar(n * CIFAR_BATCH, seed=SEED + 40)
    x = x - x.mean(axis=0)
    batches = [{"data": x[i * CIFAR_BATCH:(i + 1) * CIFAR_BATCH],
                "label": y[i * CIFAR_BATCH:(i + 1) * CIFAR_BATCH].astype(
                    np.float32)} for i in range(n)]
    head, tail = batches[:RULE_ITERS], batches[RULE_ITERS:]
    rel = lambda a, b: max(abs(p - q) / abs(q) for p, q in zip(a, b))
    f32, f64 = torch.float32, torch.float64
    out, launches = {}, {}
    for rule, txt in CIFAR_RULES.items():
        sp = load_solver_prototxt_with_net(
            txt + 'weight_decay: 0.004\nlr_policy: "fixed"\n',
            cifar10_quick(CIFAR_BATCH, CIFAR_BATCH))
        card = Solver(sp, seed=SEED, device=dev)
        init, _ = card.snapshot_caffe(os.path.join(d, f"quick_{rule}_init"))
        card.set_train_data(iter(head))
        traj = [(host_f64(card.params),
                 {s: host_f64(t) for s, t in card.state.items()})]
        card_losses = []
        ck.reset_launch_counts()
        with cudnn_deterministic():    # the same card run on every call
            for _ in head:
                card_losses.append(card.step(1))
                traj.append((host_f64(card.params),
                             {s: host_f64(t)
                              for s, t in card.state.items()}))
        launches[rule] = dict(ck.launch_counts)
        want = {"lrn_across_channels_fwd": 0, "lrn_across_channels_bwd": 0,
                "max_pool_bwd": RULE_ITERS, "lrn_across_channels": 0}
        if launches[rule] != want:
            fail(f"solver_cifar10_quick_{rule}: launches {launches[rule]}")
        cpu, exact = (free_run(sp, init, head, dt) for dt in (f32, f64))
        cpu_err = rel(cpu, exact)
        allowed = max(1e-3, 10.0 * cpu_err)
        card_updates = [{k: [b - a for a, b in zip(traj[t][0][k],
                                                   traj[t + 1][0][k])]
                         for k in traj[t][0]} for t in range(RULE_ITERS)]
        (l32, u32), (l64, u64) = (replay(sp, traj, head, dt)
                                  for dt in (f32, f64))
        upd_allowed = max(1e-3, 10.0 * update_err(u32, u64))
        r = {"card_losses": card_losses, "cpu_losses": cpu,
             "card_vs_f64": rel(card_losses, exact), "cpu_vs_f64": cpu_err,
             "card_vs_cpu": rel(card_losses, cpu), "allowed": allowed,
             "lockstep_loss_vs_f64": rel(card_losses, l64),
             "lockstep_cpu_loss_vs_f64": rel(l32, l64),
             "lockstep_update_vs_f64": update_err(card_updates, u64),
             "lockstep_cpu_update_vs_f64": update_err(u32, u64),
             "lockstep_update_allowed": upd_allowed}
        if not all(math.isfinite(v) for v in card_losses) or not (
                r["card_vs_f64"] <= allowed
                and r["lockstep_loss_vs_f64"] <= 1e-4
                and r["lockstep_update_vs_f64"] <= upd_allowed):
            fail(f"solver_cifar10_quick_{rule}: the card differs from the "
                 f"CPU: {r}")
        if rule == "AdaDelta":
            _, planted = replay(sp, traj, head, f32,
                                rule=adadelta_reads_new_sq_update)
            r["planted_new_sq_update_vs_f64"] = update_err(planted, u64)
            if not r["planted_new_sq_update_vs_f64"] > upd_allowed:
                fail("AdaDelta reading its new sq_update passes the check")
        if rule in ("Adam", "AdaDelta"):
            model, state = card.snapshot_caffe(os.path.join(d, f"q_{rule}"))
            saved = {s: clone_tree(t) for s, t in card.state.items()}
            saved_params = clone_tree(card.params)
            fork = card.generator.get_state()
            with cudnn_deterministic():
                card.set_train_data(iter(tail))
                straight = [card.step(1) for _ in tail]
                back = Solver(sp, seed=SEED + 2, device=dev)
                back.restore_caffe(state)
                bad = (differing(back.params, saved_params)
                       + state_differs(back.state, saved))
                if bad or back.iter != RULE_ITERS:
                    fail(f"solver_cifar10_quick_{rule}: restore_caffe "
                         f"differs in {bad[:5]}, iter {back.iter}")
                back.generator.set_state(fork)
                back.set_train_data(iter(tail))
                resumed = [back.step(1) for _ in tail]
                r["resumed_vs_straight"] = rel(resumed, straight)
                r["resumed_params_max_rel"] = max_rel(back.params,
                                                      card.params)
                if not r["resumed_vs_straight"] <= 1e-4 or any(
                        not torch.allclose(p, q, rtol=2e-4, atol=2e-5)
                        for k in card.params
                        for p, q in zip(back.params[k], card.params[k])):
                    fail(f"solver_cifar10_quick_{rule}: the resumed run "
                         f"differs: {r}")
                if rule == "Adam":
                    # planted: the bias correction restarted at t = 1
                    again = Solver(sp, seed=SEED + 3, device=dev)
                    again.restore_caffe(state)
                    again.iter = 0
                    again.set_train_data(iter(tail))
                    restarted = [again.step(1) for _ in tail]
                    r["planted_iter_0_vs_straight"] = rel(restarted,
                                                          straight)
                    if not r["planted_iter_0_vs_straight"] > 1e-4:
                        fail("Adam resumed at iter 0 passes the check")
                    del again
            # planted: the two history slots swapped
            st = load_solverstate(state)
            half = len(st["history"]) // 2
            swapped = os.path.join(d, f"q_{rule}_swapped.solverstate")
            save_solverstate(swapped, st["iter"], st["history"][half:]
                             + st["history"][:half], learned_net=model)
            back.restore_caffe(swapped)
            r["planted_swapped_slots_differ"] = len(
                state_differs(back.state, saved))
            if not r["planted_swapped_slots_differ"]:
                fail(f"{rule}: swapped history slots restore as the saved "
                     f"state")
            if rule == "AdaDelta":
                short = os.path.join(d, "q_short.solverstate")
                save_solverstate(short, st["iter"], st["history"][:-1],
                                 learned_net=model)
                try:
                    back.restore_caffe(short)
                    fail("a history one blob short was restored")
                except ValueError as e:
                    r["planted_short_history"] = str(e)[:100]
            del back
        out[rule] = r
        del card
    print(f"solver_rules [{smi}] " + json.dumps(
        {k: {m: v for m, v in r.items() if not m.endswith("_losses")}
         for k, r in out.items()}), flush=True)
    return {"rules": out, "launches": launches}


def solver_and_weights(ck, dev, smi: str) -> dict:
    """Phase 5b: the Solver on CaffeNet, its weights served, the six rules
    on cifar10_quick; the files in a temporary directory."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="solver_smoke_") as d:
        caffenet_out = solver_caffenet(ck, dev, smi, d)
        torch.cuda.empty_cache()
        served = serve_weights(dev, smi, caffenet_out["model"])
        torch.cuda.empty_cache()
        rules = solver_rules_cifar(ck, dev, smi, d)
    torch.cuda.empty_cache()
    print(f"solver_and_weights: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"caffenet": caffenet_out["report"], "served": served,
            "rules": rules}


# ---------------------------------------------------------------------------
# Phase 5c: Caffe's data path — LMDB/LevelDB, the DataTransformer, the
# device feed and caffe_cli train/test/time with compute_image_mean and
# extract_features
# ---------------------------------------------------------------------------

# The fixture: 1,024 raw 3x256x256 Datums (uint8 pixels uniform in
# [60, 180]: std 35 after the mean, between the apps' 30 and phase 5b's
# 58) for training, 100 for the test net, from seed 0.  At batch 256 the
# feed cycles the training LMDB five times in 20 iterations.
DB_TRAIN, DB_TEST, DB_LEVELDB = 1024, 100, 64
DB_SIZE = 256
# phase 5b's solver schedule with display 1: every iteration's loss is
# logged, with its glog timestamp, so the first one can be checked and
# the ms per iteration read from the CLI's own log
DATA_PATH_SOLVER = CAFFENET_SOLVER.replace("display: 20", "display: 1")
DATA_PATH_WANT = {"lrn_across_channels_fwd": 2 * SOLVER_ITERS,
                  "lrn_across_channels_bwd": 2 * SOLVER_ITERS,
                  "max_pool_bwd": 3 * SOLVER_ITERS,
                  "lrn_across_channels": 2 * SOLVER_TESTS * SOLVER_TEST_ITER}


def pmsg_text(m) -> str:
    """A PMessage as prototxt text (strings quoted, nested messages in
    braces)."""
    from sparknet_tpu_torch.proto.textformat import PMessage
    parts = []
    for key, v in m.items():
        if isinstance(v, PMessage):
            parts.append(f"{key} {{ {pmsg_text(v)} }}")
        elif isinstance(v, bool):
            parts.append(f"{key}: {'true' if v else 'false'}")
        elif isinstance(v, str):
            parts.append(f"{key}: {json.dumps(v)}")
        else:
            parts.append(f"{key}: {v!r}")
    return " ".join(parts)


def layer_text(lp) -> str:
    """A LayerParameter built by the port's model DSL as prototxt text."""
    parts = [f'name: "{lp.name}"', f'type: "{lp.type}"']
    parts += [f'bottom: "{b}"' for b in lp.bottom]
    parts += [f'top: "{t}"' for t in lp.top]
    if lp.phase is not None:
        parts.append(f"phase: {lp.phase.name}")
    parts += [f"param {{ lr_mult: {p.lr_mult!r} decay_mult: "
              f"{p.decay_mult!r} }}" for p in lp.param]
    parts += [f"loss_weight: {w!r}" for w in lp.loss_weight]
    parts += [f"{k} {{ {pmsg_text(v)} }}" for k, v in lp.params.items()]
    return "layer { " + " ".join(parts) + " }"


def caffenet_train_val(train_db: str, test_db: str, mean_file: str) -> str:
    """bvlc_reference_caffenet's train_val.prototxt: the port's CaffeNet
    backbone (``models/alexnet.py``) under two ``Data`` layers (TRAIN:
    batch 256, crop 227, mirror; TEST: batch 50, centre crop; both less
    ``mean_file``), as text."""
    from sparknet_tpu_torch.models import caffenet
    ref = caffenet(SOLVER_TRAIN_BATCH, SOLVER_TEST_BATCH, crop=TRAIN_CROP)
    data = [
        f'layer {{ name: "data" type: "Data" top: "data" top: "label" '
        f'include {{ phase: {phase} }} transform_param {{ mirror: '
        f'{"true" if phase == "TRAIN" else "false"} crop_size: {TRAIN_CROP} '
        f'mean_file: "{mean_file}" }} data_param {{ source: "{src}" '
        f'batch_size: {batch} backend: LMDB }} }}'
        for phase, src, batch in (("TRAIN", train_db, SOLVER_TRAIN_BATCH),
                                  ("TEST", test_db, SOLVER_TEST_BATCH))]
    return "\n".join(['name: "CaffeNet"'] + data + [
        layer_text(lp) for lp in ref.layer if lp.type != "JavaData"]) + "\n"


def check_train_val(text: str) -> None:
    """The text parses back to CaffeNet: blob, input and param shapes and
    lr/decay multipliers equal the DSL net's, in both phases."""
    from sparknet_tpu_torch.graph.net import Net
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt
    ref = caffenet(SOLVER_TRAIN_BATCH, SOLVER_TEST_BATCH, crop=TRAIN_CROP)
    for phase in (Phase.TRAIN, Phase.TEST):
        a = Net(load_net_prototxt(text), NetState(phase))
        b = Net(ref, NetState(phase))
        fake = {k: [torch.empty(0)] * len(v)
                for k, v in b.param_shapes().items()}
        if (a.blob_shapes != b.blob_shapes
                or a.input_blobs != b.input_blobs
                or a.param_shapes() != b.param_shapes()
                or a.lr_mult_tree(fake) != b.lr_mult_tree(fake)
                or a.decay_mult_tree(fake) != b.decay_mult_tree(fake)
                or [n.lp for n in a.nodes if not n.impl.is_input()]
                != [n.lp for n in b.nodes if not n.impl.is_input()]):
            fail(f"data_path: the train_val text is not CaffeNet in "
                 f"{phase.name}")


def glog_seconds(line: str) -> float:
    """Seconds of the day of a glog line (``I1017 13:44:28.011901 ...``)."""
    hms = line.split()[1]
    h, m, s = hms.split(":")
    return int(h) * 3600 + int(m) * 60 + float(s)


def run_cli(main_fn, argv: list[str]) -> tuple[str, float]:
    """``main_fn(argv)`` with its standard output captured; exits 0 or
    the phase fails.  Returns the output and the wall seconds."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        print(buf.getvalue()[-4000:])
        fail(f"data_path: {argv[:2]} exited {rc}")
    return buf.getvalue(), wall


def write_fixture(d: str) -> dict:
    """The train and test LMDBs and the LevelDB, each read back equal;
    write and read MB/s of the training LMDB."""
    from sparknet_tpu_torch.data.db import array_to_datum
    from sparknet_tpu_torch.data.leveldb_io import LeveldbReader, \
        write_leveldb
    from sparknet_tpu_torch.data.lmdb_io import LmdbReader, write_lmdb
    rng = np.random.default_rng(SEED)
    train = rng.integers(60, 181, size=(DB_TRAIN, 3, DB_SIZE, DB_SIZE),
                         dtype=np.uint8)
    test = rng.integers(60, 181, size=(DB_TEST, 3, DB_SIZE, DB_SIZE),
                        dtype=np.uint8)
    labels = rng.integers(0, 1000, size=DB_TRAIN + DB_TEST)
    out = {"train_db": os.path.join(d, "train_lmdb"),
           "test_db": os.path.join(d, "test_lmdb"),
           "leveldb": os.path.join(d, "train_leveldb"), "train": train}
    items = [(b"%08d" % i, array_to_datum(train[i], int(labels[i])))
             for i in range(DB_TRAIN)]
    nbytes = sum(len(k) + len(v) for k, v in items)
    t0 = time.perf_counter()
    write_lmdb(out["train_db"], items)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with LmdbReader(out["train_db"]) as r:
        got = list(r.items())
    read_s = time.perf_counter() - t0
    if got != items:
        fail("data_path: the training LMDB read back differs from what "
             "was written")
    write_lmdb(out["test_db"], [
        (b"%08d" % i, array_to_datum(test[i], int(labels[DB_TRAIN + i])))
        for i in range(DB_TEST)])
    write_leveldb(out["leveldb"], items[:DB_LEVELDB])
    if list(LeveldbReader(out["leveldb"]).items()) != items[:DB_LEVELDB]:
        fail("data_path: the LevelDB read back differs from what was "
             "written")
    out["lmdb_mb"] = nbytes / 1e6
    out["lmdb_write_mb_s"] = nbytes / 1e6 / write_s
    out["lmdb_read_mb_s"] = nbytes / 1e6 / read_s
    return out


def check_feed_on_card(dev, lp, seed: int) -> None:
    """The training feed's first batches through ``device_feed`` equal the
    CPU's ``db_feed`` batches bit for bit."""
    from sparknet_tpu_torch.data.db import db_feed
    from sparknet_tpu_torch.data.prefetch import device_feed
    from sparknet_tpu_torch.proto import Phase
    host = db_feed(lp, Phase.TRAIN, seed=seed)
    want = [{k: v.copy() for k, v in next(host).items()} for _ in range(3)]
    host.close()
    with device_feed(db_feed(lp, Phase.TRAIN, seed=seed), dev) as feed:
        got = [next(feed) for _ in range(3)]
        for i, (g, w) in enumerate(zip(got, want)):
            for k in w:
                if g[k].device.type != dev.type or \
                        g[k].cpu().numpy().tobytes() != w[k].tobytes():
                    fail(f"data_path: batch {i} {k} on the card differs "
                         f"from the host feed's")


def planted_data_faults(d: str, datum: bytes) -> dict:
    """Each planted fault must raise: a truncated Datum and one whose byte
    count disagrees with its geometry (``DataCorruptionError`` naming the
    key), an LMDB with both meta pages torn, a mean file of the wrong
    shape."""
    from sparknet_tpu_torch.data.db import db_feed
    from sparknet_tpu_torch.data.integrity import DataCorruptionError
    from sparknet_tpu_torch.data.lmdb_io import LmdbError, write_lmdb
    from sparknet_tpu_torch.proto import (Phase, load_net_prototxt,
                                          save_mean_binaryproto)
    from sparknet_tpu_torch.proto.textformat import PMessage
    from sparknet_tpu_torch.proto.wireformat import encode
    wrong = PMessage()
    for k, v in (("channels", 3), ("height", DB_SIZE),
                 ("width", DB_SIZE - 1), ("data", bytes(3 * DB_SIZE ** 2)),
                 ("label", 1)):
        wrong.add(k, v)
    mean = os.path.join(d, "bad_mean.binaryproto")
    save_mean_binaryproto(mean, np.zeros((3, TRAIN_CROP, TRAIN_CROP),
                                         np.float32))
    cases = {"truncated": ([datum] * 5 + [datum[:-7]] * 3, None),
             "geometry": ([datum] * 5 + [encode(wrong, "Datum")] * 3, None),
             "meta_pages": ([datum] * 8, "torn"),
             "mean_shape": ([datum] * 8, mean)}
    out = {}
    for name, (values, extra) in cases.items():
        path = os.path.join(d, f"planted_{name}")
        write_lmdb(path, [(b"%08d" % i, v) for i, v in enumerate(values)])
        if extra == "torn":
            with open(os.path.join(path, "data.mdb"), "r+b") as f:
                for page in (0, 4096):
                    f.seek(page + 16)
                    f.write(b"\0\0\0\0")
        tf = f'mean_file: "{extra}"' if name == "mean_shape" else ""
        lp = load_net_prototxt(
            f'layer {{ name: "d" type: "Data" top: "data" top: "label" '
            f'transform_param {{ crop_size: {TRAIN_CROP} {tf} }} '
            f'data_param {{ source: "{path}" batch_size: 8 backend: LMDB '
            f'}} }}').layer[0]
        feed = db_feed(lp, Phase.TRAIN, workers=2)
        try:
            next(feed)
            fail(f"data_path: planted {name} fault went through the feed")
        except DataCorruptionError as e:
            if name not in ("truncated", "geometry") or \
                    "key=b'00000005'" not in str(e):
                fail(f"data_path: planted {name}: {e}")
            out[name] = str(e)[-150:]
        except (LmdbError, ValueError) as e:
            if name not in ("meta_pages", "mean_shape"):
                fail(f"data_path: planted {name}: {type(e).__name__} {e}")
            out[name] = f"{type(e).__name__}: {e}"[:120]
        finally:
            feed.close()
    return out


def caffe_data_path(ck, dev, smi: str, solver_ms_b256: float) -> dict:
    """Phase 5c: full-width CaffeNet trained by ``caffe_cli train`` from
    an LMDB (batch 256, crop 227, mirror, ``mean_file``; test batch 50),
    exact launches; ``caffe_cli test`` on the snapshot against the last
    test pass; ``extract_features`` fc7 against the net's; ``caffe_cli
    time`` at batch 256; ``compute_image_mean`` against numpy; the feed
    on the card against the CPU's; planted faults."""
    import tempfile
    from sparknet_tpu_torch.data.db import datum_to_array
    from sparknet_tpu_torch.data.lmdb_io import LmdbReader
    from sparknet_tpu_torch.graph.net import Net
    from sparknet_tpu_torch.proto import (NetState, Phase,
                                          load_mean_binaryproto,
                                          load_net_prototxt)
    from sparknet_tpu_torch.solvers.solver import load_weights_into
    from sparknet_tpu_torch.tools import (caffe_cli, compute_image_mean,
                                          extract_features)
    from sparknet_tpu_torch.utils.device import full_f32
    t_phase = time.perf_counter()
    report: dict = {}
    with tempfile.TemporaryDirectory(prefix="data_path_smoke_") as d:
        t0 = time.perf_counter()
        fx = write_fixture(d)
        report["fixture_s"] = time.perf_counter() - t0
        report.update({k: fx[k] for k in ("lmdb_mb", "lmdb_write_mb_s",
                                          "lmdb_read_mb_s")})
        # compute_image_mean against numpy's f64 mean, rounded to f32
        mean_file = os.path.join(d, "mean.binaryproto")
        _, report["compute_image_mean_s"] = run_cli(
            compute_image_mean.main, [fx["train_db"], mean_file])
        acc = np.zeros((3, DB_SIZE, DB_SIZE), np.float64)
        for i in range(0, DB_TRAIN, 128):
            acc += fx["train"][i:i + 128].sum(0, dtype=np.float64)
        want_mean = (acc / DB_TRAIN).astype(np.float32)
        if load_mean_binaryproto(mean_file).tobytes() != want_mean.tobytes():
            fail("data_path: compute_image_mean differs from numpy's mean")
        del fx["train"], acc
        # the train_val and the solver
        text = caffenet_train_val(fx["train_db"], fx["test_db"], mean_file)
        check_train_val(text)
        model = os.path.join(d, "train_val.prototxt")
        with open(model, "w") as f:
            f.write(text)
        prefix = os.path.join(d, "caffenet")
        solver = os.path.join(d, "solver.prototxt")
        with open(solver, "w") as f:
            f.write(f'net: "{model}"\nsnapshot_prefix: "{prefix}"\n'
                    + DATA_PATH_SOLVER)
        train_lp = load_net_prototxt(text).layer[0]
        check_feed_on_card(dev, train_lp, seed=SEED)
        with LmdbReader(fx["train_db"]) as r:
            datum = r.first()[1]
        report["planted"] = planted_data_faults(d, datum)
        torch.cuda.empty_cache()
        # caffe_cli train
        torch.cuda.reset_peak_memory_stats(dev)
        ck.reset_launch_counts()
        log, train_s = run_cli(caffe_cli.main, ["train", "--solver", solver])
        launches = dict(ck.launch_counts)
        if launches != DATA_PATH_WANT:
            fail(f"data_path: caffe_cli train launches {launches}, want "
                 f"{DATA_PATH_WANT}")
        peak = torch.cuda.max_memory_allocated(dev)
        lines = log.splitlines()
        loss_at, loss_line = {}, {}
        for ln in lines:
            if "] Iteration " in ln and ", loss = " in ln:
                it = int(ln.split("Iteration ")[1].split(",")[0])
                if it not in loss_at:
                    loss_at[it] = float(ln.rsplit("= ", 1)[1])
                    loss_line[it] = glog_seconds(ln)
        tests = [(ln.split("output: ")[1].split(" = ")[0],
                  float(ln.rsplit("= ", 1)[1]))
                 for ln in lines if "Test net output:" in ln]
        feed_line = [ln for ln in lines if "] Train feed: " in ln]
        if sorted(loss_at) != list(range(1, SOLVER_ITERS + 1)) or \
                len(tests) != 2 * SOLVER_TESTS or len(feed_line) != 1 or \
                "Optimization Done." not in log:
            print(log[-4000:])
            fail("data_path: caffe_cli train's log lacks its iterations, "
                 "test outputs or feed line")
        feed = json.loads(feed_line[0].split("] Train feed: ")[1])
        test_loss0 = dict(tests[:2])["loss"]
        last_scores = dict(tests[-2:])
        if abs(test_loss0 - math.log(1000)) > 0.5 or \
                abs(loss_at[1] - math.log(1000)) > 1.0 or not all(
                    math.isfinite(v) for v in loss_at.values()):
            fail(f"data_path: test loss at init {test_loss0}, first loss "
                 f"{loss_at[1]} (ln 1000 = {math.log(1000):.4f})")
        # the CLI's own log: the interval between consecutive iterations'
        # loss lines (each fetched from the card, so the card has finished
        # that iteration), steady iterations 2-10 and 12-20 (11 follows
        # the test pass at 10)
        steady = [(loss_line[i] - loss_line[i - 1]) * 1e3
                  for i in range(3, SOLVER_ITERS + 1) if i != 11]
        iter_ms = float(np.median(steady))
        snapshot = f"{prefix}_iter_{SOLVER_ITERS}.caffemodel"
        if not os.path.exists(snapshot):
            fail(f"data_path: no snapshot {snapshot}")
        # caffe_cli test on the snapshot: the last test pass's scores
        with cudnn_deterministic():
            tlog, test_s = run_cli(caffe_cli.main, [
                "test", "--model", model, "--weights", snapshot,
                "--iterations", str(SOLVER_TEST_ITER)])
        scores = {ln.split(" = ")[0]: float(ln.split(" = ")[1])
                  for ln in tlog.splitlines()
                  if not ln.startswith("Batch") and " = " in ln}
        test_rel = max(abs(scores[k] - v) / max(abs(v), 1e-12)
                       for k, v in last_scores.items())
        if set(scores) != set(last_scores) or test_rel > 1e-5:
            fail(f"data_path: caffe_cli test {scores} != the last test "
                 f"pass {last_scores}")
        # extract_features fc7 against the net's fc7 on the same batches
        feat_db = os.path.join(d, "fc7_lmdb")
        ck.reset_launch_counts()
        with cudnn_deterministic():
            _, extract_s = run_cli(extract_features.main, [
                snapshot, model, "fc7", feat_db, str(SOLVER_TEST_ITER)])
            extract_launches = dict(ck.launch_counts)
            from sparknet_tpu_torch.data.db import db_feed
            net = Net(load_net_prototxt(text), NetState(Phase.TEST))
            params = load_weights_into(net, net.init(
                torch.Generator().manual_seed(0), device=dev), snapshot)
            test_lp = [lp for lp in load_net_prototxt(text).layer
                       if lp.type == "Data"][1]
            tfeed = db_feed(test_lp, Phase.TEST)
            want = []
            with torch.no_grad(), full_f32():
                for _ in range(SOLVER_TEST_ITER):
                    b = {k: torch.from_numpy(v).to(dev)
                         for k, v in next(tfeed).items()}
                    want.append(net.apply(params, b, blobs=["fc7"])["fc7"]
                                .cpu().numpy())
            tfeed.close()
            del net, params
        want = np.concatenate(want)
        with LmdbReader(feat_db) as r:
            got = np.stack([datum_to_array(v)[0].reshape(-1)
                            for _, v in r.items()])
        fc7_err = float(np.abs(got - want).max()) if got.shape == \
            want.shape else math.inf
        if fc7_err > 1e-5 * float(np.abs(want).max()):
            fail(f"data_path: extract_features fc7 differs from the net's "
                 f"by {fc7_err} (shape {got.shape} vs {want.shape})")
        # caffe_cli time at batch 256
        torch.cuda.empty_cache()
        tm, _ = run_cli(caffe_cli.main, ["time", "--model", model,
                                         "--iterations", "10"])
        time_ms = {k: float(ln.split(":")[1].split()[0])
                   for ln in tm.splitlines()
                   for k, tag in (("forward_ms", "Average Forward pass"),
                                  ("forward_backward_ms",
                                   "Average Forward-Backward"))
                   if ln.startswith(tag)}
        if len(time_ms) != 2:
            fail(f"data_path: caffe_cli time printed {tm[-500:]}")
    torch.cuda.empty_cache()
    report.update({
        "train_s": train_s, "iters": SOLVER_ITERS,
        "first_loss": loss_at[1], "last_loss": loss_at[SOLVER_ITERS],
        "test_loss_at_init": test_loss0, "last_test_scores": last_scores,
        "launches": launches, "cli_test_scores": scores,
        "cli_test_max_rel": test_rel, "cli_test_s": test_s,
        "extract_fc7_max_abs_err": fc7_err, "extract_s": extract_s,
        "extract_launches": extract_launches,
        "iter_ms_median": iter_ms, "iter_ms_steady": steady,
        "img_s": SOLVER_TRAIN_BATCH / iter_ms * 1e3,
        "solver_on_card_batches_ms_b256 (phase 5b)": solver_ms_b256,
        "feed": feed, "time_b256": time_ms, "peak_mem_gb": peak / 1e9,
        "phase_s": time.perf_counter() - t_phase})
    print(f"data_path [{smi}] " + json.dumps(report), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 6: the kernels line
# ---------------------------------------------------------------------------

def kernel_entry(name: str, source: str, replaces: str, launches: dict,
                 rows: list[dict], main: list[dict]) -> dict:
    """One kernel's entry: launches per main path, the worst error over
    every check, and times, bounds and library times summed over the
    main-path rows (one launch of each per step or forward)."""
    libs = [r["library_ms"] for r in main]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main)
        else "operations",
        "library_ms": None if None in libs else sum(libs),
        "checked": True,
        "main_path_rows": [f"{r['case']} {r['dtype']}" for r in main],
        "per_shape": [{k: r[k] for k in ("case", "dtype", "ms", "plain_ms",
                                         "bound_ms", "library_ms")}
                      for r in rows],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="write per-kernel device-time tables of batch-64 "
                         "bf16 forwards and of one steady round of each "
                         "CaffeNet and GoogLeNet training run to PATH; "
                         "print the host-side split of one batch-64 "
                         "dispatch and each profiled round's device busy "
                         "share and host-to-device copies")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    from sparknet_tpu_torch.ops import cuda_kernels as ck

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    if name != CARD:
        fail(f"no peak rates known for card {name!r} (only {CARD!r})")
    dev = torch.device("cuda", 0)

    # phase 2: build every kernel from the checkout's sources, one nvcc
    # per source, all at once
    t0 = time.perf_counter()
    built = ck.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(built) or 'already built'})", flush=True)
    for lib, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{lib}]: {line.strip()}")

    # phase 3: kernels against their plain versions
    lrn_rows = check_lrn(ck, dev)
    lrn_train_rows = check_lrn_train(ck, dev)
    sweep_lrn_bwd_warps(ck, dev)
    pool_rows = check_pool_bwd(ck, dev)
    print("plans " + json.dumps(
        [{"kernel": r.get("kernel", "lrn_across_channels"), "case": r["case"],
          "dtype": r["dtype"], **r["plan"]}
         for r in lrn_rows + lrn_train_rows + pool_rows if "plan" in r]),
        flush=True)

    # phase 4: serving, bf16 then f32 on the same weights: CaffeNet,
    # GoogLeNet, then a few VGG-16 requests
    served = {}
    for model, blob in (("caffenet", "fc8"),
                        ("googlenet", "loss3/classifier")):
        served[model] = serve_both(dev, smi, model, blob)
    if args.profile:
        gen = np.random.default_rng(SEED + 3)
        for i, model in enumerate(served):
            lm16 = served[model]["lm16"]
            profile_forward(lm16, args.profile, "w" if i == 0 else "a")
            inputs = [(IMAGE_STD * gen.normal(size=lm16.in_shape))
                      .astype(np.float32) for _ in range(8)]
            for d in ("bf16", "f32"):
                print(f"dispatch_breakdown [{smi}] {model} {d} batch 64 "
                      + json.dumps(dispatch_breakdown(
                          served[model][f"lm{d[-2:]}"], inputs)),
                      flush=True)
    for r in served.values():
        del r["lm16"], r["lm32"]
    _, lm = serve("bf16", dev, model="vgg16", lrn_per_batch=0,
                    duration_s=0.5, n_inputs=4, legs={1: (1, 1), 4: (4, 1)},
                    tag="_vgg16", min_completed=8)
    del lm
    torch.cuda.empty_cache()

    # phase 4b: the crop and the feed on the card
    check_crop(dev)
    check_feed(dev)
    torch.cuda.empty_cache()

    # phase 5: training through the apps.  CaffeNet and GoogLeNet each
    # with the crop on the feed's host thread and on the card, and
    # through the synchronous loop the device feed replaced (the
    # same-call baseline); CaffeNet also one sync round with a snapshot;
    # each model with a round on the card against the CPU.
    prof = args.profile
    if prof:
        open(prof, "a").close()
    trained = {
        "caffenet": train_imagenet(ck, dev, smi, "train", "caffenet",
                                   mode="host", profile_path=prof,
                                   initial_check=True),
        "caffenet_device_pre": train_imagenet(
            ck, dev, smi, "train_device_pre", "caffenet", mode="device",
            profile_path=prof),
        "caffenet_synchronous_loop": train_imagenet(
            ck, dev, smi, "train_synchronous_loop", "caffenet",
            mode="synchronous", profile_path=prof),
        "googlenet": train_imagenet(ck, dev, smi, "train_googlenet",
                                    "googlenet", mode="host",
                                    profile_path=prof, initial_check=True),
        "googlenet_device_pre": train_imagenet(
            ck, dev, smi, "train_googlenet_device_pre", "googlenet",
            mode="device", profile_path=prof),
        "googlenet_synchronous_loop": train_imagenet(
            ck, dev, smi, "train_googlenet_synchronous_loop", "googlenet",
            mode="synchronous", profile_path=prof),
        "caffenet_sync": train_sync_and_snapshot(ck, dev, smi),
    }
    for t in trained.values():
        del t["trainer"]
    torch.cuda.empty_cache()
    caffenet_against_cpu(dev)
    caffenet_against_cpu(dev, "sync")
    googlenet_against_cpu(dev)
    googlenet_tau2_kernels_vs_plain(dev)
    for model in ("full", "quick"):
        trained[f"cifar10_{model}"] = train_cifar(ck, dev, smi, model)
        del trained[f"cifar10_{model}"]["trainer"]
    trained["vgg16"] = train_vgg16(ck, dev, smi)
    del trained["vgg16"]["trainer"]
    torch.cuda.empty_cache()
    print("feed_summary [" + smi + "] " + json.dumps(
        {m: t["report"]["steady_medians"] for m, t in trained.items()
         if m.startswith(("caffenet", "googlenet"))}), flush=True)

    # phase 5b: the Solver at full width, its snapshot on disk and served,
    # and Caffe's six rules
    solved = solver_and_weights(ck, dev, smi)

    # phase 5c: Caffe's data path, CaffeNet trained from an LMDB through
    # caffe_cli train, tested and timed, its features extracted
    data_path = caffe_data_path(ck, dev, smi,
                                solved["caffenet"]["solver_ms_per_iter_b256"])

    # phase 6: the kernels line.  Launches per path, each path's counts set
    # to 0 just before it.  Main-path rows: GoogLeNet's, this slice's main
    # path: norm1 + norm2 at serving batch 64 in bf16 (its default) for
    # the inference LRN; norm1 + norm2 and its 13 pools at training batch
    # 32 in f32 for the training kernels.  CaffeNet's rows stay in
    # per_shape.
    tl = {m: t["report"]["launches"] for m, t in trained.items()}
    # the Solver's paths, by their own names: its training run (with its
    # test passes), its test pass alone, the served weight file, each
    # rule's run on cifar10_quick, and caffe_cli's training run from an
    # LMDB and its feature extraction
    sc = solved["caffenet"]
    solver_paths = {
        "solver_caffenet_training": sc["launches_training"],
        "solver_caffenet_test": sc["launches_test"],
        **{f"caffenet_serving_weights_{d}": {
            "lrn_across_channels": r["lrn_launches"]}
           for d, r in solved["served"].items()},
        **{f"solver_cifar10_quick_{r.lower()}": n
           for r, n in solved["rules"]["launches"].items()},
        "caffe_cli_train_lmdb": data_path["launches"],
        "caffe_cli_extract_features": data_path["extract_launches"]}
    def solver_launches(kernel):   # the paths that run ``kernel``
        return {m: c[kernel] for m, c in solver_paths.items()
                if c.get(kernel)}
    def rows_of(rows, kernel=None, dtype="float32", batch=GN_BATCH):
        return [r for r in rows if r["case"].startswith("googlenet_")
                and r["case"].endswith(f"_b{batch}")
                and r["dtype"] == dtype
                and (kernel is None or r["kernel"] == kernel)]
    fwd_rows = [r for r in lrn_train_rows
                if r["kernel"] == "lrn_across_channels_fwd"]
    bwd_rows = [r for r in lrn_train_rows
                if r["kernel"] == "lrn_across_channels_bwd"]
    lrn_paths = [m for m in tl if m.startswith(("caffenet", "googlenet"))]
    kernels = [
        kernel_entry(
            "lrn_across_channels", "sparknet_tpu_torch/ops/csrc/lrn.cu",
            "sparknet_tpu/ops/pallas_kernels.py:72",
            {**{f"{m}_serving_{d}": served[m][d]["lrn_launches"]
                for m in served for d in ("bf16", "f32")},
             **{f"{m}_training_eval": tl[m]["lrn_across_channels"]
                for m in lrn_paths},
             **solver_launches("lrn_across_channels")},
            lrn_rows, rows_of(lrn_rows, dtype="bfloat16", batch=64)),
        kernel_entry(
            "lrn_across_channels_fwd", "sparknet_tpu_torch/ops/csrc/lrn.cu",
            "sparknet_tpu/ops/pallas_kernels.py:56",
            {**{f"{m}_training": tl[m]["lrn_across_channels_fwd"]
                for m in lrn_paths},
             **solver_launches("lrn_across_channels_fwd")},
            fwd_rows, rows_of(fwd_rows)),
        kernel_entry(
            "lrn_across_channels_bwd",
            "sparknet_tpu_torch/ops/csrc/lrn_bwd.cu",
            "sparknet_tpu/ops/pallas_kernels.py:83",
            {**{f"{m}_training": tl[m]["lrn_across_channels_bwd"]
                for m in lrn_paths},
             **solver_launches("lrn_across_channels_bwd")},
            bwd_rows, rows_of(bwd_rows)),
        kernel_entry(
            "max_pool_bwd", "sparknet_tpu_torch/ops/csrc/maxpool_bwd.cu",
            "sparknet_tpu/ops/pallas_kernels.py:203",
            {**{f"{m}_training": tl[m]["max_pool_bwd"] for m in tl},
             **solver_launches("max_pool_bwd")},
            pool_rows, rows_of(pool_rows)),
    ]
    for k in kernels:
        if len(k["main_path_rows"]) != {"max_pool_bwd": 13}.get(k["name"],
                                                                2):
            fail(f"kernels line: main-path rows of {k['name']}: "
                 f"{k['main_path_rows']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
