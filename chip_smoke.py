"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Builds every hand-written CUDA kernel of ``sparknet_tpu_torch`` from the
checkout's sources, holds each against its plain PyTorch version on the
card (with planted faults the same checks must reject), then drives the
port's two main paths at full width: it serves CaffeNet through the
micro-batching engine (``ModelHouse`` -> ``InferenceEngine`` ->
``run_closed_loop``) in bf16 and in f32, and it trains CaffeNet with
τ-step local SGD through ``apps.imagenet_app.main`` (2 workers, batch 64,
τ=5, 2 rounds, f32 with TF32 off), checking what comes out, how often
each kernel launched, and one training round on the card against the
same round on the CPU.  Prints the card, timings, a ``{"kernels": [...]}``
line and, last, ``{"ok": true, "device": ...}``.  Every failed check
exits non-zero.  Without a CUDA device it exits 2 and prints no result.
``--profile PATH`` also writes per-kernel device-time tables of batch-64
forwards and of one training round to PATH and prints the host-side
split of one batch-64 dispatch.

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


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each f32 value (8-bit mantissa)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------

# (label, shape, local_size, relu); alpha, beta, k are CaffeNet's.  The
# CaffeNet rows cover every batch shape the engine launches the kernel at.
LRN_CASES = [
    *((f"caffenet_{norm}_b{b}", (b, c, hw, hw), 5, False)
      for norm, c, hw in (("norm1", 96, 27), ("norm2", 256, 13))
      for b in (1, 4, 16, 64)),
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


# The training kernels.  The CaffeNet rows are the shapes the training
# path launches them at (batch 64, f32 there); the others carry
# GoogLeNet's relu face and odd and even window sizes.
TRAIN_BATCH = 64
LRN_TRAIN_CASES = [
    *((f"caffenet_{norm}_b{TRAIN_BATCH}", (TRAIN_BATCH, c, hw, hw), 5, False)
      for norm, c, hw in (("norm1", 96, 27), ("norm2", 256, 13))),
    ("googlenet_conv2_norm2_b16", (16, 192, 56, 56), 5, True),
    ("odd_size3", (3, 7, 5, 9), 3, False),
    ("odd_size4", (3, 7, 5, 9), 4, False),
    ("odd_size4_relu", (3, 7, 5, 9), 4, True),
    ("odd_size5", (3, 7, 5, 9), 5, False),
    ("odd_size7_generic", (3, 7, 5, 9), 7, False),
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
            plan = ck.lrn_plan(shape[0], shape[1], shape[2] * shape[3])
            fwd = {**base, "kernel": "lrn_across_channels_fwd",
                   "plan": plan._asdict(),
                   "max_abs_err": max(errs["y"], errs["scale"]),
                   "ms": timings["fwd_ms"],
                   "plain_ms": timings["fwd_plain_ms"],
                   "library_ms": timings["fwd_library_ms"],
                   # read x; write y and scale
                   **bound(3 * numel * elt, numel * (2 * size + 4 + relu))}
            bwd = {**base, "kernel": "lrn_across_channels_bwd",
                   "max_abs_err": errs["dx"], "planted_outside_tol": planted,
                   "ms": timings["bwd_ms"],
                   "plain_ms": timings["bwd_plain_ms"],
                   "library_ms": timings["bwd_library_ms"],
                   # read x, scale, dy; write dx
                   **bound(4 * numel * elt, numel * (6 * size + 6 + relu))}
            for row in (fwd, bwd):
                rows.append(row)
                print("lrn_train_check " + json.dumps(row), flush=True)
    return rows


# (label, input shape, kernel, stride, pad): CaffeNet's three pools at the
# training batch, GoogLeNet's stride-1 pad-1 pools, the padded and
# remainder geometries of tests/test_pallas.py:120-156, two geometries
# whose planes the kernel cuts into bands of rows (VGG's pool1 at batch 2,
# and a 3x3 stride-2 pad-1 pool on 224x224 planes, banded in bf16 too),
# and a plane count that is no multiple of the planes packed per block
POOL_CASES = [
    (f"caffenet_pool1_b{TRAIN_BATCH}", (TRAIN_BATCH, 96, 55, 55), 3, 2, 0),
    (f"caffenet_pool2_b{TRAIN_BATCH}", (TRAIN_BATCH, 256, 27, 27), 3, 2, 0),
    (f"caffenet_pool5_b{TRAIN_BATCH}", (TRAIN_BATCH, 256, 13, 13), 3, 2, 0),
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
            if label.endswith("_banded") and plan.bands == 1:
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
# Phase 4: the slice — full-width CaffeNet served through the engine
# ---------------------------------------------------------------------------

# Spread of the served images: mean-subtracted 0-255 pixels.  At this
# scale the two LRNs move f32 fc8 by ~1e-3 of its largest value (an
# identity LRN in place of the kernel fails check_against_cpu); at unit
# scale they move it by ~1e-6 and no check downstream could see them.
IMAGE_STD = 58.0

# batch shape -> (clients, window): concurrency that fills that shape
LOAD_LEGS = {1: (1, 1), 4: (4, 1), 16: (4, 4), 64: (8, 16)}


def serve(dtype: str, dev, *, duration_s: float, n_inputs: int,
          legs=LOAD_LEGS, tag: str = "") -> tuple[dict, object]:
    """Load caffenet, answer requests from several client threads at each
    load leg, audit every answer bit for bit against its solo padded run,
    and check the LRN launch count.  Returns (report, loaded model)."""
    from sparknet_tpu_torch.ops import cuda_kernels as ck
    from sparknet_tpu_torch.parallel.serving import (
        InferenceEngine, ModelHouse, ServeConfig, run_closed_loop,
        solo_references)

    cfg = ServeConfig(dtype=dtype, max_delay_ms=2.0, max_queue=512,
                      seed=SEED)
    house = ModelHouse(cfg, device=dev)
    t0 = time.perf_counter()
    lm = house.load("caffenet")
    load_s = time.perf_counter() - t0
    gen = np.random.default_rng(SEED + 1)
    inputs = [(IMAGE_STD * gen.normal(size=lm.in_shape)).astype(np.float32)
              for _ in range(n_inputs)]
    refs = solo_references(lm, inputs)
    sum_tol = 1e-2 if dtype == "bf16" else 1e-4
    for s, by_idx in refs.items():
        for i, row in by_idx.items():
            if row.shape != (lm.classes,) or not np.isfinite(row).all():
                fail(f"{dtype}: solo run of input {i} at shape {s} is not "
                     f"{lm.classes} finite probabilities")
            if abs(float(row.sum()) - 1.0) > sum_tol:
                fail(f"{dtype}: solo probabilities sum to {row.sum()}")
    ck.reset_launch_counts()
    runs = {}
    with InferenceEngine(house, cfg) as eng:
        for shape, (clients, window) in legs.items():
            runs[str(shape)] = run_closed_loop(
                eng, "caffenet", inputs, clients=clients, window=window,
                duration_s=duration_s, refs=refs)
        stats = eng.stats()
    launches = ck.launch_counts["lrn_across_channels"]
    completed = sum(r["completed"] for r in runs.values())
    if completed < 256:
        fail(f"{dtype}: only {completed} requests answered (< 256)")
    for name, r in runs.items():
        if r["errors"] or r["exact_mismatches"]:
            fail(f"{dtype} leg {name}: {r['errors']} errors, "
                 f"{r['exact_mismatches']} answers differ from their solo "
                 f"padded run")
    if stats["failed"] or stats["completed"] != completed:
        fail(f"{dtype}: engine failed {stats['failed']}, completed "
             f"{stats['completed']} vs clients' {completed}")
    if launches != 2 * stats["dispatches"]:
        fail(f"{dtype}: {launches} LRN launches for {stats['dispatches']} "
             f"dispatched batches (want 2 per batch)")
    others = {k: v for k, v in ck.launch_counts.items()
              if k != "lrn_across_channels" and v}
    if others:
        fail(f"{dtype}: serving launched training kernels {others}")
    report = {"dtype": dtype, "load_s": load_s, "completed": completed,
              "dispatches": stats["dispatches"], "lrn_launches": launches,
              "exact_mismatches": 0, "occupancy": stats["occupancy"],
              "batch_ms": stats["batch_ms"], "legs": runs,
              "flops_per_image": lm.flops_per_image}
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


def check_against_cpu(lm) -> tuple[float, float, tuple]:
    """The card's f32 fc8 blob against the port's CPU forward (plain LRN)
    on the same weights, and that CPU forward against one whose LRNs are
    the identity (a planted fault): two max|diff| / max|ref|, and the
    (cuDNN, matmul) TF32 flags the card's forward ran with."""
    from sparknet_tpu_torch.ops import vision
    gen = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(
        (IMAGE_STD * gen.normal(size=(4,) + lm.in_shape)).astype(np.float32))
    cpu_params = {k: [b.cpu() for b in v] for k, v in lm.params.items()}
    fc8 = lambda params, data: lm.net.apply(
        params, {"data": data}, blobs=["fc8"])["fc8"]
    with torch.inference_mode():
        with lm.precision():
            got = fc8(lm.params, x.to(lm.device)).cpu()
            tf32 = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        want = fc8(cpu_params, x)
        lrn = vision.lrn_across_channels
        vision.lrn_across_channels = lambda t, *args, **kw: t
        try:
            planted = fc8(cpu_params, x)
        finally:
            vision.lrn_across_channels = lrn
    rel = lambda a: float((a - want).abs().max() / want.abs().max())
    return rel(got), rel(planted), tf32


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


def profile_forward(lm, path: str) -> None:
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
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40))


# ---------------------------------------------------------------------------
# Phase 5: the training slice — full-width CaffeNet, τ-step local SGD
# ---------------------------------------------------------------------------

TRAIN_WORKERS, TRAIN_TAU, TRAIN_ROUNDS = 2, 5, 2
TRAIN_RESIZE, TRAIN_CROP = 256, 227     # bvlc_reference_caffenet's


def train_slice(ck, dev, smi: str) -> dict:
    """``imagenet_app.main`` on the card: synthetic 256x256 images,
    CaffeNet at 227, 2 workers x batch 64, τ=5, 2 rounds, one eval at the
    end.  Checks the losses and scores, the launch counts (per worker step
    2 LRN forwards, 2 LRN backwards, 3 pool backwards; 2 inference LRNs
    per worker test batch), that the master params moved and are the
    mean of the workers' last-round params."""
    from sparknet_tpu_torch.apps import imagenet_app
    argv = ["--synthetic", "--model", "caffenet",
            "--workers", str(TRAIN_WORKERS), "--batch", str(TRAIN_BATCH),
            "--tau", str(TRAIN_TAU), "--rounds", str(TRAIN_ROUNDS),
            "--test-interval", "2", "--resize", str(TRAIN_RESIZE),
            "--crop", str(TRAIN_CROP), "--device", str(dev)]
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    run = imagenet_app.main(argv)
    wall_s = time.perf_counter() - t0
    launches = dict(ck.launch_counts)
    tr = run.trainer
    losses = [tr.round_losses[r] for r in range(TRAIN_ROUNDS)]
    if not all(math.isfinite(v) for v in losses):
        fail(f"train: round losses {losses}")
    # the train-mode loss carries Dropout: at CaffeNet's init (fc6/fc7
    # biases 1) its doubled survivors widen fc8's logits, so the first
    # round's loss sits above ln 1000; the test-mode loss at init is
    # checked more tightly below
    if abs(losses[0] - math.log(1000)) > 1.0:
        fail(f"train: first round's loss {losses[0]:.4f} is not near "
             f"ln 1000 = {math.log(1000):.4f}")
    if set(run.scores) != {"loss", "accuracy"} or not all(
            math.isfinite(v) for v in run.scores.values()):
        fail(f"train: eval scores {run.scores}")
    steps = TRAIN_WORKERS * TRAIN_TAU * TRAIN_ROUNDS
    # the app's test set: max(2 x workers x batch, 64) images over the
    # workers, scored in whole per-worker batches, once at the end
    test_batches = TRAIN_WORKERS * (max(2 * TRAIN_WORKERS * TRAIN_BATCH, 64)
                                    // TRAIN_WORKERS // TRAIN_BATCH)
    want = {"lrn_across_channels_fwd": 2 * steps,
            "lrn_across_channels_bwd": 2 * steps,
            "max_pool_bwd": 3 * steps,
            "lrn_across_channels": 2 * test_batches}
    if launches != want:
        fail(f"train: launches {launches}, want {want}")
    init = tr.train_net.init(torch.Generator().manual_seed(0), device=dev)
    init_loss = initial_test_loss(tr, init, dev)
    if abs(init_loss - math.log(1000)) > 0.5:
        fail(f"train: the test-mode loss at init, {init_loss:.4f}, is not "
             f"near ln 1000 = {math.log(1000):.4f}")
    for k, blobs in tr.params.items():
        for i, b in enumerate(blobs):
            if torch.equal(b, init[k][i]):
                fail(f"train: master param {k}[{i}] never moved")
            mean = torch.stack([p[k][i] for p in tr.worker_params]).mean(0)
            if not torch.equal(b, mean):
                fail(f"train: master param {k}[{i}] is not the mean of the "
                     f"workers' params")
    rounds = []
    for r in range(TRAIN_ROUNDS):
        sec = tr.round_seconds[r]
        rounds.append({"round": r, "loss": tr.round_losses[r],
                       "seconds": sec,
                       "worker_step_ms": sec * 1e3 / (TRAIN_WORKERS
                                                      * TRAIN_TAU),
                       "img_s": TRAIN_WORKERS * TRAIN_TAU * TRAIN_BATCH
                       / sec})
    report = {"argv": argv, "wall_s": wall_s, "init_test_loss": init_loss,
              "rounds": rounds,
              "scores": run.scores, "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print("train " + json.dumps(report), flush=True)
    for r in rounds:
        print(f"train [{smi}] round {r['round']}"
              f"{' (first, includes warm-up)' if r['round'] == 0 else ''}: "
              f"{r['worker_step_ms']:.2f} ms per worker step of "
              f"{TRAIN_BATCH} images, {r['img_s']:.1f} img/s per card, "
              f"loss {r['loss']:.4f}", flush=True)
    return {"report": report, "trainer": tr}


def initial_test_loss(tr, init, dev) -> float:
    """The test-mode loss of the initial params on a batch made as the
    app makes its test batches (synthetic images, center crop, less
    their mean), with random labels."""
    from sparknet_tpu_torch.apps.imagenet_app import synthetic_imagenet
    from sparknet_tpu_torch.data import center_crop
    from sparknet_tpu_torch.utils.device import full_f32
    x, y = synthetic_imagenet(TRAIN_BATCH, TRAIN_RESIZE, 1000, SEED + 6)
    batch = {"data": torch.from_numpy(center_crop(
        x, TRAIN_CROP, mean=x.mean(axis=0))).to(dev),
        "label": torch.from_numpy(y.astype(np.float32)).to(dev)}
    with torch.inference_mode(), full_f32():
        return float(tr.test_net.forward(init, batch, train=False).loss)


def profile_train_round(tr, path: str) -> None:
    """Per-kernel device time of one more training round (same shapes,
    random images at std 58), appended to ``path``."""
    from torch.profiler import ProfilerActivity, profile
    gen = np.random.default_rng(SEED + 5)
    n = TRAIN_WORKERS * TRAIN_BATCH
    batches = {"data": (IMAGE_STD * gen.standard_normal(
        (TRAIN_TAU, n, 3, TRAIN_CROP, TRAIN_CROP), np.float32)),
        "label": gen.integers(0, 1000, (TRAIN_TAU, n)).astype(np.float32)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_round(batches)
        torch.cuda.synchronize()
    with open(path, "a") as f:
        f.write("\n\none training round (2 workers x 5 steps, batch 64)\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40))


def train_against_cpu(dev) -> dict:
    """One round of full-width CaffeNet (2 workers x batch 8, τ=2) from
    the same weights, batches and CPU-drawn Dropout masks on the card, on
    the CPU in f32, and on the CPU in f64 (the port's same code: the
    plain kernels compute in f64 for f64 tensors).  The round's loss on
    the card must agree with the CPU's within 1e-4 relative.  Per blob,
    max|Δ|/max|ref| of the averaged params against the f64 round must be
    within 1e-3, or within 10x the CPU f32 round's own error: a
    zero-initialised convolution bias holds only its first update, a sum
    over ~10^5 positions with heavy cancellation, where f32 on either
    device misses the f64 answer by more than 1e-3.  The same checks must
    see a CPU round whose LRNs are the identity (a planted fault)."""
    from sparknet_tpu_torch.apps.imagenet_app import SOLVER
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.ops import vision
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(SOLVER, caffenet(16, 16,
                                                        crop=TRAIN_CROP))
    gen = np.random.default_rng(SEED + 4)
    batches = {"data": (IMAGE_STD * gen.normal(
        size=(2, 16, 3, TRAIN_CROP, TRAIN_CROP))).astype(np.float32),
               "label": gen.integers(0, 1000, (2, 16)).astype(np.float32)}

    def one_round(device, f64=False):
        tr = DistributedTrainer(sp, 2, TrainerConfig(tau=2), seed=SEED,
                                device=device)
        feed = batches
        if f64:
            tr.params = {k: [b.double() for b in v]
                         for k, v in tr.params.items()}
            tr.state = [tr.rule.init(tr.params) for _ in range(2)]
            feed = {k: v.astype(np.float64) for k, v in batches.items()}
        loss = tr.train_round(feed)
        return loss, {k: [b.cpu().double() for b in v]
                      for k, v in tr.params.items()}

    card_loss, card = one_round(dev)
    cpu_loss, cpu = one_round("cpu")
    _, exact = one_round("cpu", f64=True)
    relu_lrn = vision.relu_lrn
    vision.relu_lrn = lambda x, *args, **kw: x
    try:
        planted_loss, planted = one_round("cpu")
    finally:
        vision.relu_lrn = relu_lrn

    def rel(params, ref):
        return {f"{k}[{i}]": float((a - b).abs().max() / b.abs().max())
                for k in ref for i, (a, b) in enumerate(zip(params[k],
                                                            ref[k]))}

    cpu_err = rel(cpu, exact)
    allowed = {b: max(1e-3, 10.0 * e) for b, e in cpu_err.items()}
    card_err, planted_err = rel(card, exact), rel(planted, exact)
    card_vs_cpu = rel(card, cpu)
    out = {"loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss),
           "planted_loss_rel": abs(planted_loss - cpu_loss) / abs(cpu_loss),
           "card_loss": card_loss, "cpu_loss": cpu_loss,
           "card_vs_cpu_max": max(card_vs_cpu.values()),
           "card_vs_cpu_over_1e-3": {b: e for b, e in card_vs_cpu.items()
                                     if e > 1e-3},
           "card_vs_f64": card_err, "cpu_f32_vs_f64": cpu_err,
           "planted_vs_f64_max": max(planted_err.values())}
    print("train card vs CPU " + json.dumps(out), flush=True)
    over = {b: e for b, e in card_err.items() if e > allowed[b]}
    if over or not out["loss_rel"] <= 1e-4:
        fail(f"train: the card's round differs from the CPU's: loss "
             f"{out['loss_rel']:.3e}, blobs beyond their bound {over}")
    if (out["planted_loss_rel"] <= 1e-4
            and all(e <= allowed[b] for b, e in planted_err.items())):
        fail(f"train: identity LRNs pass the card-vs-CPU checks: {out}")
    return out


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
                         "bf16 forwards and of one training round to PATH "
                         "and print the host-side split of one batch-64 "
                         "dispatch")
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
    pool_rows = check_pool_bwd(ck, dev)
    print("plans " + json.dumps(
        [{"kernel": r.get("kernel", "lrn_across_channels"), "case": r["case"],
          "dtype": r["dtype"], **r["plan"]}
         for r in lrn_rows + lrn_train_rows + pool_rows if "plan" in r]),
        flush=True)

    # phase 4: serving, bf16 then f32 on the same weights
    bf16, lm16 = serve("bf16", dev, duration_s=2.0, n_inputs=16)
    f32, lm32 = serve("f32", dev, duration_s=1.0, n_inputs=8,
                      legs={1: (1, 1), 64: (8, 16)}, tag="_f32")
    for k, blobs in lm16.params.items():
        if not all(torch.equal(a, b) for a, b in zip(blobs, lm32.params[k])):
            fail(f"bf16 and f32 houses drew different weights for {k!r}")
    rel, planted, tf32 = check_against_cpu(lm32)
    print(f"f32 fc8 card vs CPU: max|diff|/max|ref| = {rel:.3e} "
          f"(limit 1e-4, TF32 allowed: cudnn {tf32[0]}, matmul {tf32[1]}); "
          f"CPU with identity LRNs vs CPU: {planted:.3e}", flush=True)
    if any(tf32):
        fail("the f32 forward ran with TF32 allowed")
    if not rel <= 1e-4:
        fail(f"f32 fc8 differs from the CPU forward by {rel:.3e}")
    if not planted > 1e-4:
        fail(f"identity LRNs move f32 fc8 by only {planted:.3e}: the 1e-4 "
             f"check cannot see the LRN kernel")
    fwd = {d: {"b64_ms": device_forward_ms(lm, 64, 20)}
           for d, lm in (("bf16", lm16), ("f32", lm32))}
    for d, r in (("bf16", bf16), ("f32", f32)):
        leg = r["legs"]["64"]
        fwd[d]["img_s_b64_closed_loop"] = leg["achieved_qps"]
        fwd[d]["img_s_b64_device"] = 64e3 / fwd[d]["b64_ms"]
    print(f"throughput [{smi}] " + json.dumps(fwd), flush=True)
    for d, r in (("bf16", bf16), ("f32", f32)):
        for shape, lat in r["batch_ms"].items():
            print(f"latency [{smi}] {d} batch {shape}: p50 "
                  f"{lat['p50_ms']} ms, p99 {lat['p99_ms']} ms over "
                  f"{lat['batches']} batches", flush=True)
    if args.profile:
        profile_forward(lm16, args.profile)
        gen = np.random.default_rng(SEED + 3)
        inputs = [(IMAGE_STD * gen.normal(size=lm16.in_shape))
                  .astype(np.float32) for _ in range(8)]
        for d, lm in (("bf16", lm16), ("f32", lm32)):
            print(f"dispatch_breakdown [{smi}] {d} batch 64 "
                  + json.dumps(dispatch_breakdown(lm, inputs)), flush=True)
    del lm16, lm32

    # phase 5: training, then one round on the card against the CPU
    train = train_slice(ck, dev, smi)
    if args.profile:
        profile_train_round(train["trainer"], args.profile)
    del train["trainer"]
    train_against_cpu(dev)

    # phase 6: the kernels line.  Main-path rows: serving's norm1 + norm2
    # at batch 64 in bf16 (its default) for the inference LRN; training's
    # norm1 + norm2 and pool1 + pool2 + pool5 at batch 64 in f32
    tl = train["report"]["launches"]
    def rows_of(rows, kernel=None, dtype="float32", prefix="caffenet_"):
        return [r for r in rows if r["case"].startswith(prefix)
                and r["case"].endswith(f"_b{TRAIN_BATCH}")
                and r["dtype"] == dtype
                and (kernel is None or r["kernel"] == kernel)]
    fwd_rows = [r for r in lrn_train_rows
                if r["kernel"] == "lrn_across_channels_fwd"]
    bwd_rows = [r for r in lrn_train_rows
                if r["kernel"] == "lrn_across_channels_bwd"]
    kernels = [
        kernel_entry(
            "lrn_across_channels", "sparknet_tpu_torch/ops/csrc/lrn.cu",
            "sparknet_tpu/ops/pallas_kernels.py:72",
            {"serving_bf16": bf16["lrn_launches"],
             "serving_f32": f32["lrn_launches"],
             "training_eval": tl["lrn_across_channels"]},
            lrn_rows, rows_of(lrn_rows, dtype="bfloat16")),
        kernel_entry(
            "lrn_across_channels_fwd", "sparknet_tpu_torch/ops/csrc/lrn.cu",
            "sparknet_tpu/ops/pallas_kernels.py:56",
            {"training": tl["lrn_across_channels_fwd"]}, fwd_rows,
            rows_of(fwd_rows)),
        kernel_entry(
            "lrn_across_channels_bwd",
            "sparknet_tpu_torch/ops/csrc/lrn_bwd.cu",
            "sparknet_tpu/ops/pallas_kernels.py:83",
            {"training": tl["lrn_across_channels_bwd"]}, bwd_rows,
            rows_of(bwd_rows)),
        kernel_entry(
            "max_pool_bwd", "sparknet_tpu_torch/ops/csrc/maxpool_bwd.cu",
            "sparknet_tpu/ops/pallas_kernels.py:203",
            {"training": tl["max_pool_bwd"]}, pool_rows,
            rows_of(pool_rows)),
    ]
    for k in kernels:
        if len(k["main_path_rows"]) != {"max_pool_bwd": 3}.get(k["name"], 2):
            fail(f"kernels line: main-path rows of {k['name']}: "
                 f"{k['main_path_rows']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
