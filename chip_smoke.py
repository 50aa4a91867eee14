"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile PATH]

Builds every hand-written CUDA kernel of ``sparknet_tpu_torch`` from the
checkout's sources, holds each against its plain PyTorch version on the
card, then serves full-width CaffeNet through the port's micro-batching
engine (``ModelHouse`` -> ``InferenceEngine`` -> ``run_closed_loop``) in
bf16 and in f32 and checks what comes out.  Prints the card, timings, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Every failed check exits non-zero.  Without a CUDA device it exits 2 and
prints no result.  ``--profile PATH`` also writes a per-kernel
device-time table of batch-64 forwards to PATH and prints the host-side
split of one batch-64 dispatch.

Imports nothing of JAX and nothing of ``sparknet_tpu``.
"""

from __future__ import annotations

import argparse
import json
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
]
LRN_ALPHA, LRN_BETA, LRN_K = 1e-4, 0.75, 1.0
# Spread of the LRN checks' inputs.  At unit scale CaffeNet's alpha moves
# an output by under half a bf16 ulp, so an identity kernel would pass;
# at 50 (pixel-scale activations) the window sum is ~12,500 and the
# output shrinks by ~15%, tens of bf16 ulps.
LRN_INPUT_STD = 50.0


def outside_tol(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(mask of elements of ``got`` outside the tolerance of ``want``'s
    dtype, its text): f32 rtol 1e-5 + atol 1e-6, bf16 one ulp."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.float32:
        return err > 1e-6 + 1e-5 * w.abs(), "rtol 1e-5, atol 1e-6"
    return err > bf16_ulp(torch.maximum(g.abs(), w.abs())), "1 bf16 ulp"


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
            nbytes = 2 * numel * x.element_size()   # read x, write y once
            ops = numel * (2 * size + 4 + int(relu))
            t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / F32_FLOP_S * 1e3
            row = {"case": label, "shape": list(shape), "size": size,
                   "relu": relu, "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": float(err.max()), "tolerance": tol,
                   "planted_outside_tol": controls,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bytes": nbytes, "ops": ops,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            rows.append(row)
            print("lrn_check " + json.dumps(row), flush=True)
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
    with torch.inference_mode():
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


def check_against_cpu(lm) -> tuple[float, float]:
    """The card's f32 fc8 blob against the port's CPU forward (plain LRN)
    on the same weights, and that CPU forward against one whose LRNs are
    the identity (a planted fault): two max|diff| / max|ref|."""
    from sparknet_tpu_torch.ops import vision
    gen = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(
        (IMAGE_STD * gen.normal(size=(4,) + lm.in_shape)).astype(np.float32))
    cpu_params = {k: [b.cpu() for b in v] for k, v in lm.params.items()}
    fc8 = lambda params, data: lm.net.apply(
        params, {"data": data}, blobs=["fc8"])["fc8"]
    with torch.inference_mode():
        got = fc8(lm.params, x.to(lm.device)).cpu()
        want = fc8(cpu_params, x)
        lrn = vision.lrn_across_channels
        vision.lrn_across_channels = lambda t, *args, **kw: t
        try:
            planted = fc8(cpu_params, x)
        finally:
            vision.lrn_across_channels = lrn
    rel = lambda a: float((a - want).abs().max() / want.abs().max())
    return rel(got), rel(planted)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="write a per-kernel device-time table of batch-64 "
                         "bf16 forwards to PATH and print the host-side "
                         "split of one batch-64 dispatch")
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

    # phase 2: build every kernel from the checkout's sources
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

    # phase 4: the slice, bf16 then f32 on the same weights
    bf16, lm16 = serve("bf16", dev, duration_s=2.0, n_inputs=16)
    f32, lm32 = serve("f32", dev, duration_s=1.0, n_inputs=8,
                      legs={1: (1, 1), 64: (8, 16)}, tag="_f32")
    for k, blobs in lm16.params.items():
        if not all(torch.equal(a, b) for a, b in zip(blobs, lm32.params[k])):
            fail(f"bf16 and f32 houses drew different weights for {k!r}")
    rel, planted = check_against_cpu(lm32)
    print(f"f32 fc8 card vs CPU: max|diff|/max|ref| = {rel:.3e} "
          f"(limit 1e-4, TF32 off: cudnn {torch.backends.cudnn.allow_tf32},"
          f" matmul {torch.backends.cuda.matmul.allow_tf32}); CPU with "
          f"identity LRNs vs CPU: {planted:.3e}", flush=True)
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

    # phase 5: the kernels line — main-path numbers are CaffeNet's norm1 +
    # norm2 at batch 64 in bf16 (the serving default), summed per forward
    main = [r for r in lrn_rows if r["case"].startswith("caffenet_")
            and r["case"].endswith("_b64") and r["dtype"] == "bfloat16"]
    entry = {
        "name": "lrn_across_channels", "route": "cuda",
        "source": "sparknet_tpu_torch/ops/csrc/lrn.cu",
        "replaces": "sparknet_tpu/ops/pallas_kernels.py:72",
        "launches": bf16["lrn_launches"] + f32["lrn_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in lrn_rows),
        "ms": sum(r["ms"] for r in main),
        "plain_ms": sum(r["plain_ms"] for r in main),
        "bound_ms": sum(r["bound_ms"] for r in main),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in main)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in main),
        "checked": True,
        "per_shape": [{k: r[k] for k in ("case", "dtype", "ms", "plain_ms",
                                         "bound_ms", "library_ms")}
                      for r in lrn_rows],
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
