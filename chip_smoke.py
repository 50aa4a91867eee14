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
fc7, and times the net with ``caffe_cli time``.  Phase 5d decodes real
JPEGs on the card: the two image kernels (``ycc_to_rgb``,
``resize_bilinear``) against their plain versions bit for bit at the
shapes the image paths give them, with planted faults; nvJPEG's pixels
against libjpeg's on the committed fixtures; full-width CaffeNet trained
from tars of JPEGs through ``imagenet_app.main(["--tar-dir", ...])``
with undecodable entries planted; ``convert_imageset --encoded``,
``compute_image_mean`` and ``caffe_cli train`` over encoded Datums and
over an ``ImageData`` list; one ``WindowData`` batch against its plain
path.  Phase 5e runs the rest of SparkNet's round on full-width
CaffeNet: ``caffe_cli train --devices 4 --strategy hierarchical --hosts
2 --tau 5`` over phase 5c's LMDB (per-host solver state, exact
launches); a ``DistributedTrainer`` from ``comm_config_from_env`` (2
workers x 64, τ=5, the crop on the card) with each codec (none, bf16,
int8, int8_channel, and int8 with ``comm_overlap``): exchange bytes, the
error-feedback invariant and the card's encode against the CPU's on the
card's own deltas, overlap bit-identical with less comm stall, above 0;
recovery in child processes
(``--round-child``): a run killed by ``crash_in_ckpt`` mid-checkpoint
and resumed, bit for bit the fault-free run, a ``nan_inject`` under the
guard rolled back to the same bits, with planted faults (a codec that
drops its residual, a scribbled newest checkpoint, a resume with its
generators reset); elastic 4 -> 2 workers; harvest lag 0 against 2;
checkpoint MB, stalls and resume seconds.  Phase 5f runs the bench, its
CLI, ``profile_step`` and the telemetry plane.  Phase 5g holds the neuron
and loss layers, ``Slice`` and Accuracy's per-class top on the card
against the CPU in f32 and bf16 (planted: ContrastiveLoss's legacy form),
then trains Caffe's mnist_siamese (shared params, the pool backward at
2x2 stride 2, exactly 4 launches an iteration) and mnist_autoencoder
(two test nets by ``test_state``) at their published widths through
``caffe_cli train`` on synthetic digits, checks that every sharer holds
its owner's storage and that the ``.caffemodel`` carries every sharer's
blobs (planted: a sharer with its own clone), scores the siamese
snapshot with ``caffe_cli test``, and runs 5 iterations of each net on
the card against the CPU.  Phase 5h holds the layer library's last 17
types and STOCHASTIC pooling on the card against the CPU in f32 and
bf16 (planted: BatchNorm's biased variance, ArgMax's last-index tie
break), then trains Caffe's cifar10_full_sigmoid_bn at its published
widths from an LMDB of synthetic 32x32 images through ``caffe_cli
train`` on one device and with ``--devices 2`` under ``sync`` (each
step's BatchNorm statistics the mean of what the two workers' forwards
wrote) and ``local_sgd --tau 5``, the pool backward once a worker step,
scores the snapshot with ``caffe_cli test`` and runs 5 iterations on
the card against the CPU (planted: the statistics never written back).
Phase 5i runs SparkNet's data tier over phase 5c's LMDBs: ``python -m
sparknet_tpu_torch.tools.convert`` writes them as record shards (6 of
32 MB), every record equal to its Datum's pixels (planted: a flipped
byte named by shard and record, and under a quarantine budget of one
replaced by the next record); ``records_feed`` through a
``VerifyingStore`` and a ``ShardCache`` of 2 RAM shards with a spill
directory gives the LMDB feed's first 8 batches of 256 bit for bit;
full-width CaffeNet trains from the shards through ``caffe_cli train``
with exact launches and snapshots to ``.caffemodel.h5`` and
``.solverstate.h5``, its first 5 losses equal to a same-seed run from
the LMDB, ``caffe_cli test`` on the HDF5 weights scoring what the
binary ones of the same iteration score, a resume from the
``.solverstate.h5`` equal to the uninterrupted run (planted: a history
of flipped shape refused); a fake RDD of 512 records through
``SparkPartitionBridge``'s spill and ``RoundFeed`` into a ``local_sgd``
round equal bit for bit to the same round from
``PartitionedDataset.from_items`` and from ``from_records(...)
.rebalance(2).cached()`` (planted: a rotted spill file); Caffe's
hdf5_classification net through ``caffe_cli train`` from the committed
HDF5 fixtures (read by the port's own reader), against the CPU.  Phase
5f's bench line carries the records tier (``feed_records``, at
CaffeNet's 256², batch 256).  Phase 5j runs Caffe's tools and pycaffe's
classifiers: ``tools/train_cifar.py`` on cifar10_quick at its published
widths and batch from seeded CIFAR-10 binaries (``--data-dir``) and
``--synthetic --workers 2 --strategy local_sgd --tau 10``, the pool
backward exactly once a worker iteration and never in a test pass, its
log through ``parse_log`` (the CSV's losses those printed), 5 iterations
on the card against the CPU; ``upgrade_net_proto`` and ``draw_net`` on a
V0 and a V1 prototxt; every committed PNG fixture through ``load_image``
and an encoded Datum equal to its PIL pixels bit for bit without PIL,
the Adobe CMYK fixture through nvJPEG within 2 of PIL's (mean under
0.05), the corrupt ones refused (planted: a flipped IDAT byte, Paeth
undone as Sub, 16-bit gray scaled, CMYK without the inversion);
full-width CaffeNet through ``caffe_cli train`` over an ImageData list
of JPEGs and PNGs; ``classify_cli`` (10-crop and ``--center_only``, JPEG,
PNG and CMYK inputs) and ``detect_cli`` on CaffeNet's deploy net with
``.caffemodel`` weights, the LRN inference kernel twice a forward, the
probabilities against the CPU forward of the same crops.  Phase 5k
runs the training data plane and SparkNet's learning proxy: the native
host pipeline (``sparknet_tpu_torch/native``, built with g++; the phase
fails if it does not build) against its numpy paths bit for bit on 5c's
Datums, CIFAR records and the JPEG fixtures' libjpeg pixels (planted: a
crop one pixel off), ``db_feed``'s img/s at batch 256 over 5c's LMDB
with the native parse and crop and with the per-record path; full-width
CaffeNet from 5c's LMDB as record shards through the Solver at batch 256
with the host transform, with ``set_augment`` on the host and on the
card (those two bit for bit; planted: a mirror along the rows), ms an
iteration beside 5c's ``caffe_cli train`` with the native transform;
the learning proxy on full-width cifar10_full at ``--scale 3500`` (1x,
8-way, hier 2x4, 20 iterations each) and a τ sweep (τ 2 and 10, codecs
none and int8, 20 iterations), img/s per card, exact launches, and the
first 10 iterations of 1x on the card against the CPU.  Phase 5l runs
pycaffe's ``caffe`` module and the serving plane: ``python -m
sparknet_tpu_torch.tools.serve --models caffenet=W`` (f32, through
``--serve-child``, which also writes the child's launch counts) answers
batch-1 requests and a closed loop over HTTP (``run_closed_loop``'s
``submit`` seam), every row against the in-process solo reference at its
padded shape; a registry version loads over ``/v1/models/load`` and
serves when pinned; ``/slo`` reads ok and the beacon file is read back
while serving and after SIGTERM; ``classify_cli --server`` 10-crop over
the JPEG fixtures against the local CLI; a planted server
(``--slo-p99-ms 0.001`` and a ``bad_canary`` version) must answer the
canary with typed 400s and ``/slo`` with 503 and a flight dump;
``caffe.set_mode_gpu()`` then ``caffe.Net`` on CaffeNet's deploy net
against the CPU (and the ms of a forward with its mirror copies), the
train net's ``forward()``/``backward()`` at batch 64, and ``get_solver``
on a NetSpec-built CaffeNet from an LMDB, each of its 5 steps, against
f64 runs on the CPU that take the card's ReLU and MAX pool decisions,
with B3 planted.  Phase 5m runs the fusion pass and the lowering tuner:
``tools/fusebench.py`` on the card in f32 and bf16 (planted: an epilogue
that drops the ReLU fold, swapped horizontal slices), GoogLeNet's round
(2 workers x 32, τ=2) under the committed fusion plan against the
unfused round (params within 1e-5, the ReLU-folded launches exact), its
deploy net served at 64 with horizontal fusion on and off (rows within
1e-5, device ms and launches of each), and ``tools/tune.py staleness
--budget-s 20`` on the committed tuning table.  Phase 5n (the last,
with 5c's directory kept until it) runs the rest of the observability
and bench plane:
``tools/perf_probe.py``'s ``poolbwd`` (GoogLeNet's 13 pools, f32 at 32),
``lrn`` (the four LRN shapes at 32, f32) and ``hlo`` (the layout census
of CaffeNet's step at 256), every variant against its plain version and
each kernel launched exactly once a kernel call the tool made;
``tools/serveload.py`` on CaffeNet's deploy net in f32 (1 s points, the
sweep at 0.5x and 1x, overload at 2x: every answer bit for bit its solo
reference, the SLO breach declared with a flight dump; planted: an
answer one ulp off); a profiler-server capture of served CaffeNet
batches that must name B2 and ``L[norm1]``; ``tools/feedbench.py
--records-leg`` over 5c's LMDB; ``tools/roundbench.py`` at its defaults
(planted: an asynchronous checkpoint without its generator states);
``tools/obs.py smoke`` (planted: a span without its run id fails ``merge
--check``); ``tools/knobs.py --check``.  Phase 5o (after 5n) runs the
fleet on the card: ``tools/serve.py --fleet 2`` on CaffeNet f32 in a
child (64 requests through the router, each bit for bit its solo
reference; ``/healthz`` two live replicas), ``serveload``'s fleet legs on
CaffeNet (a replica SIGKILLed under load, typed failover, healed, a
drain-based scale-down, 0 wrong answers), a CaffeNet rollout at canary
fraction 0.25, promoted, then a planted bad canary (weights x 1.01)
rolled back with every pinned request unchanged, and last, alone, a
lenet training tenant (2 workers) preempted at round 2 by a job of
higher priority, requeued and resumed bit for bit an unpreempted run
(planted: a router that answers a pinned request from the canary, a
resume fed the wrong round's batch, an orphan left running); every replica, front and driver is a
``--fleet-child`` of this script that writes its own launch counts, B2
twice a forward and the pool backward twice a worker step exact in each
that exits cleanly, and no fleet process is left.  Phase 5p (after 5o)
runs the round over the wire: ``tools/commbench.py`` in this process
(lenet, 4 workers, τ=2, 8 rounds a training: codec none bit for bit,
error feedback exact with the planted residual dropper caught, the loss
band, int8 with overlap bit for bit and with less comm stall, above 0,
a 50 ms spin queued ahead of each measured round keeping the card behind
the host, int8's bytes 4x fewer), then ``tools/soak.py --net --net-slice`` with
every lenet driver (4 workers) a ``--fleet-child`` started over the
fake-ssh wire with ``--device cuda``: the partition leg SUSPECT with no
kill and no straggler, the fenced leg resumed past a torn ship with the
zombie refused and no temporaries left, both bit for bit the baseline;
the pool backward twice a worker step exact in commbench and in every
driver; planted: ``_verified_copy`` without its crc checks lands a
flipped chunk, which the manifest's sha256 must refuse.  Phase 5q
runs the pod half's tensors: ``tools/shardbench.py`` in process (six
verdicts on lenet), CaffeNet at full width on 4 positions through the
bench's ``shard_round_legs`` (``shard`` off and auto bit for bit, 243,860,896
against 67,995,040 boundary bytes a position, one sharded checkpoint
resumed bit for bit), three 2-process x 2-worker gangs of the lenet
driver started together (each rank a ``--fleet-child driver``):
hierarchical under ``SPARKNET_SHARD=auto``/``SPARKNET_SHARD_CKPT=1``
against the one-process 2x2 run, local_sgd with ``--audit-every 1`` and
a flip on position 3 against the fault-free run, and (planted) a flip
on position 1 with the audit off, which must differ; roundbench's audit
leg; a tile with one byte changed, which resume skips.  The kernels
line counts the launches with the ReLU folded in apart
(``relu_launches``).  A
``timeline`` line gives each phase's seconds.
Prints the card, timings, a
``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": ...}``.  Every failed check
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
import collections
import contextlib
import csv
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
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
# the image kernels' counts on a path that decodes no JPEG
IMAGE_KERNELS_IDLE = {"ycc_to_rgb": 0, "resize_bilinear": 0}
# the LRN kernels' launches with the ReLU folded in (a relu+lrn chain of
# the fusion plan), counted under keys of their own
RELU_FOLD_KEYS = ("lrn_across_channels_relu", "lrn_across_channels_fwd_relu",
                  "lrn_across_channels_bwd_relu")


def launched(ck) -> dict:
    """The kernels' launch counts, the ReLU-folded ones only where a path
    launched them: a path without a relu+lrn chain reads as before."""
    return {k: v for k, v in ck.launch_counts.items()
            if v or k not in RELU_FOLD_KEYS}


def folded(want: dict) -> dict:
    """``want`` without its ReLU-folded keys at 0 (as :func:`launched`)."""
    return {k: v for k, v in want.items() if v or k not in RELU_FOLD_KEYS}


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
    # the fused relu+lrn chain served at 64 (phase 5m)
    ("googlenet_conv2_norm2_relu_b64", (64, 192, 56, 56), 5, True),
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
    # the fused relu+lrn chain GoogLeNet's training path runs
    (f"googlenet_conv2_norm2_relu_b{GN_BATCH}", (GN_BATCH, 192, 56, 56), 5,
     True),
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
    # mnist_siamese's pools (phase 5g), each twice a step: 2x2 stride-2
    # windows that do not overlap
    ("siamese_pool1_b64", (64, 20, 24, 24), 2, 2, 0),
    ("siamese_pool2_b64", (64, 50, 8, 8), 2, 2, 0),
    (f"cifar_pool1_b{CIFAR_BATCH}", (CIFAR_BATCH, 32, 32, 32), 3, 2, 0),
    *VGG_POOLS,
    ("googlenet_k3s1p1_b16", (16, 192, 28, 28), 3, 1, 1),
    ("padded_13_k3s2p1", (2, 4, 13, 13), 3, 2, 1),
    ("overlap_7_k5s3p2", (2, 4, 7, 7), 5, 3, 2),
    ("clipped_17_k2s3p1", (2, 4, 17, 17), 2, 3, 1),
    ("vgg_pool1_b2_banded", (2, 64, 224, 224), 2, 2, 0),
    ("k3s2p1_224_banded", (2, 8, 224, 224), 3, 2, 1),
    ("pool5_planes_not_multiple", (64, 251, 13, 13), 3, 2, 0),
    # SPP's MAX levels on 13x13 planes (phase 5h): kernel = stride =
    # ceil(13 / bins), Caffe's padding, for 1, 2 and 4 bins
    ("spp_13_level0_k13s13", (64, 32, 13, 13), 13, 13, 0),
    ("spp_13_level1_k7s7p1", (64, 32, 13, 13), 7, 7, 1),
    ("spp_13_level2_k4s4p2", (64, 32, 13, 13), 4, 4, 2),
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


# seconds of each closed-loop leg of phase 4
SERVE_LEG_S = 0.5


def serve_both(dev, smi: str, model: str, blob: str) -> dict:
    """``model`` served in bf16 and in f32 on the same weights: the f32
    logits on the card within 1e-4 of the CPU forward (TF32 off), with
    identity LRNs moving them by more; device forward and closed-loop
    throughput at batch 64; p50/p99 per batch shape.  Returns the two
    reports and their loaded models."""
    tag = "" if model == "caffenet" else f"_{model}"
    bf16, lm16 = serve("bf16", dev, model=model, duration_s=SERVE_LEG_S,
                       n_inputs=16, tag=tag)
    f32, lm32 = serve("f32", dev, model=model, duration_s=SERVE_LEG_S,
                      n_inputs=8, tag=f"{tag}_f32")
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
# Round 0 warms up and rounds 1-3 are steady.  The feed builds rounds
# ahead while round 0 runs, so the first steady rounds can take stock
# the feed built then; by the later ones a feed-bound loop waits for
# every round it takes.  (8 rounds until phase 5o took the time, 5 until
# phase 5p did.)
TRAIN_ROUNDS = 4
PROFILE_ROUND = 3         # the steady round that --profile traces
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
    that the counts are exactly ``want`` (a dict, or a function that
    makes one after the run; the image kernels 0 unless it names them),
    that the master params moved
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
    launches = launched(ck)
    tr = run.trainer
    losses = [tr.round_losses[r] for r in range(rounds)]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: round losses {losses}")
    if set(run.scores) != score_keys or not all(
            math.isfinite(v) for v in run.scores.values()):
        fail(f"{label}: eval scores {run.scores}")
    want = {**IMAGE_KERNELS_IDLE, **(want() if callable(want) else want)}
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


class drawn_once:
    """A scope in which ``imagenet_app.synthetic_imagenet`` draws each
    set of images once and hands every later call with the same
    arguments a fresh copy of them: phase 5's runs of one model and 5f's
    telemetry runs draw the same images, and the draw (~7 s for
    CaffeNet's 896 + 256 at 256x256 on one host core) is the script's
    set-up, not the app's work."""

    def __enter__(self):
        from sparknet_tpu_torch.apps import imagenet_app
        self.module, self.draw = imagenet_app, imagenet_app.synthetic_imagenet
        drawn: dict = {}

        def synthetic_imagenet(*args):
            if args not in drawn:
                drawn[args] = self.draw(*args)
            x, y = drawn[args]
            return x.copy(), y.copy()
        imagenet_app.synthetic_imagenet = synthetic_imagenet
        return self

    def __exit__(self, *exc):
        self.module.synthetic_imagenet = self.draw


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
    # the ReLU-folded LRNs of the committed auto plan (train and test nets
    # fuse the same chains)
    folds = relu_folds(model)
    evals = eval_batches(TRAIN_WORKERS, batch)
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
        want=folded({"lrn_across_channels_fwd": (2 - folds) * steps,
                     "lrn_across_channels_bwd": (2 - folds) * steps,
                     "lrn_across_channels_fwd_relu": folds * steps,
                     "lrn_across_channels_bwd_relu": folds * steps,
                     "max_pool_bwd": pools * steps,
                     "lrn_across_channels": (2 - folds) * evals,
                     "lrn_across_channels_relu": folds * evals}))
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
                            tol: float, batch=None) -> float:
    """The test-mode loss of the initial params on a batch made as the
    app makes its test batches (synthetic images, center crop, less
    their mean), with random labels, or on ``batch`` (cropped images,
    labels): within ``tol`` of ln 1000."""
    from sparknet_tpu_torch.apps.imagenet_app import synthetic_imagenet
    from sparknet_tpu_torch.data import center_crop
    from sparknet_tpu_torch.utils.device import full_f32
    init = tr.train_net.init(torch.Generator().manual_seed(0), device=dev)
    if batch is None:
        n = tr.test_net.blob_shapes["data"][0] // tr.n_workers
        x, y = synthetic_imagenet(n, TRAIN_RESIZE, 1000, SEED + 6)
        batch = (center_crop(x, crop, mean=x.mean(axis=0)), y)
    batch = {"data": torch.from_numpy(batch[0]).to(dev),
             "label": torch.from_numpy(batch[1].astype(np.float32)).to(dev)}
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
    """Full-width CaffeNet, 2 workers x batch 8, one step each (τ=1);
    identity LRNs planted."""
    from sparknet_tpu_torch.apps.imagenet_app import SOLVER
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(SOLVER, caffenet(16, 16,
                                                        crop=TRAIN_CROP))
    return train_against_cpu(
        dev, "train" if strategy == "local_sgd" else f"train_{strategy}", sp,
        image_batches(SEED + 4, 16, TRAIN_CROP, 1000, tau=1), identity_lrn(),
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
RULE_ITERS, RULE_RESUME_ITERS = 5, 3


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
    training = launched(ck)
    want = {"lrn_across_channels_fwd": 2 * SOLVER_ITERS,
            "lrn_across_channels_bwd": 2 * SOLVER_ITERS,
            "max_pool_bwd": 3 * SOLVER_ITERS,
            "lrn_across_channels": 2 * SOLVER_TESTS * SOLVER_TEST_ITER,
            **IMAGE_KERNELS_IDLE}
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
    test_launches = launched(ck)
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
    backward an iteration), 5 iterations on the card from a
    ``.caffemodel``, checked two ways against the CPU:

    - free-running: the same 5 iterations on the CPU from the same file,
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
    amplify that.  Adam and AdaDelta: snapshot_caffe at 5, restore_caffe into a fresh
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
        launches[rule] = launched(ck)
        want = {"lrn_across_channels_fwd": 0, "lrn_across_channels_bwd": 0,
                "max_pool_bwd": RULE_ITERS, "lrn_across_channels": 0,
                **IMAGE_KERNELS_IDLE}
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
                  "lrn_across_channels": 2 * SOLVER_TESTS * SOLVER_TEST_ITER,
                  **IMAGE_KERNELS_IDLE}


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


def caffe_data_path(ck, dev, smi: str, solver_ms_b256: float,
                    d: str) -> dict:
    """Phase 5c: full-width CaffeNet trained by ``caffe_cli train`` from
    an LMDB (batch 256, crop 227, mirror, ``mean_file``; test batch 50),
    exact launches; ``caffe_cli test`` on the snapshot against the last
    test pass; ``extract_features`` fc7 against the net's; ``caffe_cli
    time`` at batch 256; ``compute_image_mean`` against numpy; the feed
    on the card against the CPU's; planted faults.  The LMDBs, the mean
    and ``train_val.prototxt`` stay in ``d`` for phase 5e."""
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
    launches = launched(ck)
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
        extract_launches = launched(ck)
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
# Phase 5d: real images — nvJPEG and the two image kernels against their
# plain versions and libjpeg's pixels, full-width CaffeNet from tars of
# JPEGs through imagenet_app --tar-dir, encoded Datums and ImageData
# through caffe_cli, one WindowData batch
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "sparknet_tpu_torch", "data", "jpeg_fixtures")
# nvJPEG against libjpeg: where only the IDCTs' rounding differs (4:4:4,
# gray) a pixel moves by at most 2 (a rounding of 1 in a component,
# through the colour conversion), and on average by far less everywhere:
# the chroma is upsampled and converted by ycc_to_rgb, as libjpeg does
NVJPEG_MAX_DIFF = {"s444": 2, "gray": 2}
NVJPEG_MEAN_DIFF = 1.0
# phase 5d's cell: 1,280 train and 256 test JPEGs (the eight ImageNet-
# sized fixtures copied under distinct names) in 4 + 1 tars, one
# undecodable entry planted in a train tar and one in the test tar
IMG_TRAIN, IMG_TEST, IMG_TRAIN_TARS, IMG_ROUNDS = 1280, 256, 4, 4
PLANTED = b"\xff\xd8\xff\xe0 planted: no JPEG past its start marker"
# (label, source: a fixture or a random (h, w) image, output (h, w) or
# None for the source's own, gray); the first is the main path's shape,
# ImageNet's commonest, 375x500 to the apps' 256x256
RESIZE_CASES = [
    ("imagenet_375x500_to_256", "imagenet_0.jpg", (256, 256), False),
    ("imagenet_500x375_to_256", "imagenet_1.jpg", (256, 256), False),
    ("upscale_64x48_to_256", (64, 48), (256, 256), False),
    ("natural_37x53", "s420.jpg", None, False),
    ("one_row_1x40", (1, 40), (9, 7), False),
    ("one_column_40x1", (40, 1), (9, 7), False),
    ("to_1x1", (33, 47), (1, 1), False),
    ("gray_500x375_to_256", "imagenet_1.jpg", (256, 256), True),
]
YCC_FIXTURES = ["imagenet_0.jpg", "imagenet_1.jpg", "imagenet_6.jpg",
                "s420.jpg", "s422.jpg", "s444.jpg", "progressive.jpg",
                "restart.jpg"]
# bvlc_reference_caffenet's solver (phase 5b's) cut to 5 iterations, a
# test pass of 2 batches at 0 and at 5, every loss logged
IMAGE_SOLVER_ITERS, IMAGE_SOLVER_TESTS = 5, 2
IMAGE_SOLVER = (CAFFENET_SOLVER.replace("display: 20", "display: 1")
                .replace("max_iter: 20", f"max_iter: {IMAGE_SOLVER_ITERS}")
                .replace("test_interval: 10",
                         f"test_interval: {IMAGE_SOLVER_ITERS}")
                .replace("snapshot: 20\n", ""))


def fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def planted_resize(src: torch.Tensor, oh: int, ow: int,
                   fault: str) -> torch.Tensor:
    """The plain resize with a fault planted: ``f64`` forms the scale and
    sample points in float64, ``swap`` exchanges x and y."""
    from sparknet_tpu_torch.ops import cuda_kernels as ck
    if fault == "swap":
        return ck.resize_bilinear_reference(
            src.transpose(0, 1).contiguous(), ow, oh).transpose(1, 2)
    h, w = src.shape[:2]
    dev = src.device
    ys = torch.arange(oh, dtype=torch.float64, device=dev) * (
        (h - 1) / (oh - 1))
    xs = torch.arange(ow, dtype=torch.float64, device=dev) * (
        (w - 1) / (ow - 1))
    y0, x0 = ys.long(), xs.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    wy, wx = (ys - y0).float()[:, None], (xs - x0).float()[None, :]
    p = src.permute(2, 0, 1).float()
    return ((1 - wy) * ((1 - wx) * p[:, y0][:, :, x0]
                        + wx * p[:, y0][:, :, x1])
            + wy * ((1 - wx) * p[:, y1][:, :, x0] + wx * p[:, y1][:, :, x1]))


def planted_ycc(y, cb, cr, fault: str) -> torch.Tensor:
    """The plain conversion with a fault planted: ``box`` upsamples the
    chroma by replication, ``swap`` exchanges Cb and Cr."""
    from sparknet_tpu_torch.ops import cuda_kernels as ck
    if fault == "swap":
        return ck.ycc_to_rgb_reference(y, cr, cb)
    h, w = y.shape
    up = [c.repeat_interleave(2 if c.shape[0] < h else 1, 0)
          .repeat_interleave(2 if c.shape[1] < w else 1, 1)[:h, :w]
          .contiguous() for c in (cb, cr)]
    return ck.ycc_to_rgb_reference(y, *up)


def check_image_kernels(ck, dev, smi: str) -> dict:
    """The resize kernel and the colour conversion against their plain
    versions on the card, bit for bit, and on the CPU (the JAX package's
    path), with planted faults; nvJPEG's pixels against libjpeg's on
    the small fixtures; drops; the decode's time on one thread."""
    from sparknet_tpu_torch.data import jpeg
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    gen = np.random.default_rng(SEED + 20)
    resize_rows, ycc_rows = [], []
    for label, spec, out, gray in RESIZE_CASES:
        if isinstance(spec, str):
            src = jpeg.decode_rgb(fixture(spec), dev)
        else:
            src = torch.from_numpy(gen.integers(0, 256, spec + (3,),
                                                dtype=np.uint8)).to(dev)
        h, w = src.shape[:2]
        oh, ow = out or (h, w)
        got = ck.resize_bilinear(src, oh, ow, gray)
        torch.cuda.synchronize()
        want = ck.resize_bilinear_reference(src, oh, ow, gray)
        if not torch.equal(got, want) or not torch.equal(
                got.cpu(), ck.resize_bilinear_reference(src.cpu(), oh, ow,
                                                        gray)):
            fail(f"resize_bilinear {label}: differs from its plain version "
                 f"(max |err| {float((got - want).abs().max())})")
        if out is None and not torch.equal(got, src.permute(2, 0, 1)
                                           .float()):
            fail(f"resize_bilinear {label}: the natural size is no copy")
        planted = {}
        if label in ("imagenet_375x500_to_256", "upscale_64x48_to_256"):
            for fault in ("f64", "swap"):
                bad = planted_resize(src, oh, ow, fault)
                planted[fault] = int((bad != got).sum())
                if planted[fault] == 0:
                    fail(f"resize_bilinear {label}: the planted {fault} "
                         f"fault went unseen")
        c = 1 if gray else 3
        row = {"case": label, "kernel": "resize_bilinear", "dtype": "uint8",
               "shape": [h, w, oh, ow], "max_abs_err": 0.0,
               "planted_elements_differing": planted,
               **bound(h * w * 3 + 4 * c * oh * ow,
                       oh * ow * (2 + 9 * 3 + (3 if gray else 0)))}
        row["ms"] = time_ms(lambda: ck.resize_bilinear(src, oh, ow, gray),
                            50, flush)
        row["plain_ms"] = time_ms(
            lambda: ck.resize_bilinear_reference(src, oh, ow, gray), 10,
            flush)
        row["library_ms"] = None
        if not gray and oh > 1 and ow > 1:
            planar = src.permute(2, 0, 1)[None].float().contiguous()
            row["library_ms"] = time_ms(lambda: F.interpolate(
                planar, size=(oh, ow), mode="bilinear", align_corners=True),
                50, flush)
        resize_rows.append(row)
    for name in YCC_FIXTURES:
        y, cb, cr = jpeg.decode_planes(fixture(name), dev)
        got = ck.ycc_to_rgb(y, cb, cr)
        torch.cuda.synchronize()
        want = ck.ycc_to_rgb_reference(y, cb, cr)
        if not torch.equal(got, want) or not torch.equal(
                got.cpu(), ck.ycc_to_rgb_reference(y.cpu(), cb.cpu(),
                                                   cr.cpu())):
            fail(f"ycc_to_rgb {name}: differs from its plain version")
        h, w = y.shape
        planted = {}
        if cb.shape != y.shape:
            for fault in ("box", "swap"):
                planted[fault] = int((planted_ycc(y, cb, cr, fault)
                                      != got).sum())
                if planted[fault] == 0:
                    fail(f"ycc_to_rgb {name}: the planted {fault} fault "
                         f"went unseen")
        # integer operations counted at the f32 rate: ~20 a pixel
        row = {"case": name.split(".")[0], "kernel": "ycc_to_rgb",
               "dtype": "uint8", "shape": [h, w, *cb.shape],
               "max_abs_err": 0.0, "planted_elements_differing": planted,
               **bound(h * w * 4 + 2 * cb.numel(), 20 * h * w)}
        row["ms"] = time_ms(lambda: ck.ycc_to_rgb(y, cb, cr), 50, flush)
        row["plain_ms"] = time_ms(
            lambda: ck.ycc_to_rgb_reference(y, cb, cr), 10, flush)
        row["library_ms"] = None      # no one PyTorch call does this
        ycc_rows.append(row)
    # nvJPEG (+ ycc_to_rgb) against libjpeg's pixels
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    vs_libjpeg = {}
    for name, e in manifest["small"].items():
        rgb = jpeg.decode_rgb(fixture(e["file"]), dev)
        if e["pixels"] is None:
            if rgb is not None:
                fail(f"nvjpeg: {name} decoded; libjpeg refuses it")
            vs_libjpeg[name] = "dropped"
            continue
        if rgb is None:
            fail(f"nvjpeg: {name} dropped; libjpeg decodes it")
        px = np.load(os.path.join(FIXTURES, e["pixels"])).astype(np.int32)
        diff = np.abs(rgb.cpu().numpy().astype(np.int32) - px)
        vs_libjpeg[name] = {"max": int(diff.max()),
                            "mean": float(diff.mean())}
        if name == "truncated":
            continue     # nvJPEG fills a cut scan otherwise (ROADMAP §C)
        if diff.mean() > NVJPEG_MEAN_DIFF or diff.max() > \
                NVJPEG_MAX_DIFF.get(name, 255):
            fail(f"nvjpeg: {name} differs from libjpeg by {vs_libjpeg[name]}"
                 f" (bounds: mean {NVJPEG_MEAN_DIFF}, max "
                 f"{NVJPEG_MAX_DIFF.get(name, 'none')})")
    channel_means = {}
    for name, e in manifest["imagenet"].items():
        rgb = jpeg.decode_rgb(fixture(e["file"]), dev).cpu().numpy()
        channel_means[name] = float(np.abs(
            rgb.reshape(-1, 3).mean(0) - e["channel_mean"]).max())
    # the yardstick: nvJPEG's own upsampling and colour conversion
    # (NVJPEG_OUTPUT_RGBI), which ycc_to_rgb replaces for these samplings
    rgbi = ck._function("jpeg", "sparknet_jpeg_decode_rgbi")
    nvjpeg_own = {}
    for name, e in {**manifest["small"], **manifest["imagenet"]}.items():
        if "height" not in e or name in ("cmyk", "truncated"):
            continue
        data = fixture(e["file"])
        h, w = e["height"], e["width"]
        rgb = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
        if rgbi(data, len(data), rgb.data_ptr(), 3 * w,
                torch.cuda.current_stream(dev).cuda_stream):
            fail(f"nvjpeg: its own RGB decode of {name} failed")
        got = rgb.cpu().numpy().astype(np.int32)
        if e.get("pixels"):
            diff = np.abs(got - np.load(os.path.join(FIXTURES,
                                                     e["pixels"])))
            nvjpeg_own[name] = {"max": int(diff.max()),
                                "mean": float(diff.mean())}
        else:
            nvjpeg_own[name] = {"channel_mean_minus_libjpeg": [
                float(v) for v in got.reshape(-1, 3).mean(0)
                - e["channel_mean"]]}
    # one thread decoding the main path's image, copied back as the lazy
    # partitions take it
    data = fixture("imagenet_0.jpg")
    times = {}
    for what, fn in (("decode_resize_copy_ms", lambda: jpeg.decode_jpeg_resize(
            data, TRAIN_RESIZE, TRAIN_RESIZE, dev).cpu()),
                     ("decode_only_ms", lambda: jpeg.decode_rgb(data, dev))):
        fn()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        times[what] = (time.perf_counter() - t0) / 50 * 1e3
    report = {"nvjpeg_vs_libjpeg": vs_libjpeg,
              "imagenet_channel_mean_max_diff": channel_means,
              "nvjpeg_own_rgb_vs_libjpeg": nvjpeg_own, **times}
    print(f"images [{smi}] " + json.dumps(report), flush=True)
    print("image_kernels " + json.dumps(resize_rows + ycc_rows), flush=True)
    del flush
    return {"resize_rows": resize_rows, "ycc_rows": ycc_rows, **report}


def write_image_tars(d: str) -> dict:
    """Phase 5d's cell on disk: the train tars, the test tar, their label
    files (1000 classes from seed ``SEED``) and the planted entries."""
    import io
    import tarfile
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        files = [e["file"] for e in json.load(f)["imagenet"].values()]
    jpegs = [fixture(n) for n in files]
    rng = np.random.default_rng(SEED + 21)
    out = {}
    for split, n, tars in (("train", IMG_TRAIN, IMG_TRAIN_TARS),
                           ("test", IMG_TEST, 1)):
        root = os.path.join(d, split)
        os.makedirs(root)
        planted = int(rng.integers(n))
        lines = []
        per = n // tars
        for t in range(tars):
            with tarfile.open(os.path.join(root, f"{split}{t:02d}.tar"),
                              "w") as tf:
                for k in range(t * per, (t + 1) * per):
                    data = PLANTED if k == planted else jpegs[k % len(jpegs)]
                    info = tarfile.TarInfo(f"{split}/img{k:05d}.JPEG")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                    lines.append(f"img{k:05d}.JPEG {int(rng.integers(1000))}")
        labels = os.path.join(d, f"{split}.txt")
        with open(labels, "w") as f:
            f.write("\n".join(lines) + "\n")
        out[split] = (root, labels)
    return out


def train_from_tars(ck, dev, smi: str, synthetic_loop: dict) -> dict:
    """Full-width CaffeNet through ``imagenet_app.main(["--tar-dir", ...])``
    (2 workers, batch 64, τ=5, 4 rounds, resize 256, crop 227, the crop on
    the card): exact launches of every kernel a round runs, the image
    kernels once for each image decoded (counted at the decoder); every
    drop a read of a planted entry; the test-mode loss at init on a batch
    of the test tar within 0.5 of ln 1000."""
    import tempfile
    import threading
    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.data import center_crop, imagenet
    decode_image = imagenet.decode_image
    counts = {"decoded": 0, "planted": 0, "other_drops": 0, "seconds": 0.0}
    lock = threading.Lock()

    def counted(data, size, device):
        t0 = time.perf_counter()
        img = decode_image(data, size, device)
        dt = time.perf_counter() - t0
        with lock:
            counts["seconds"] += dt
            if img is not None:
                counts["decoded"] += 1
            elif data == PLANTED:
                counts["planted"] += 1
            else:
                counts["other_drops"] += 1
        return img

    loaded = []
    load = imagenet_app.load_imagenet

    def capture(*a, **kw):
        loaded.append(load(*a, **kw))
        return loaded[-1]

    per_round = []     # (decode seconds, images read) of each round built

    class TimedRoundFeed(imagenet_app.RoundFeed):
        def next_round(self):
            with lock:
                s0, n0 = counts["seconds"], counts["decoded"] + counts[
                    "planted"]
            out = super().next_round()
            with lock:
                per_round.append((counts["seconds"] - s0, counts["decoded"]
                                  + counts["planted"] - n0))
            return out

    steps = TRAIN_WORKERS * TRAIN_TAU * IMG_ROUNDS
    test_batches = TRAIN_WORKERS * (IMG_TEST // TRAIN_WORKERS // TRAIN_BATCH)
    with tempfile.TemporaryDirectory(prefix="tars_smoke_") as d:
        t0 = time.perf_counter()
        cell = write_image_tars(d)
        write_s = time.perf_counter() - t0
        argv = ["--tar-dir", cell["train"][0], "--label-file",
                cell["train"][1], "--test-tar-dir", cell["test"][0],
                "--test-label-file", cell["test"][1], "--model", "caffenet",
                "--workers", str(TRAIN_WORKERS), "--batch", str(TRAIN_BATCH),
                "--tau", str(TRAIN_TAU), "--rounds", str(IMG_ROUNDS),
                "--test-interval", str(IMG_ROUNDS), "--device", str(dev),
                "--device-preprocess"]
        with mock.patch.object(imagenet, "decode_image", counted), \
                mock.patch.object(imagenet_app, "load_imagenet", capture), \
                mock.patch.object(imagenet_app, "RoundFeed", TimedRoundFeed):
            out = train_app(
                ck, dev, smi, "train_tar_dir", imagenet_app.main, argv,
                workers=TRAIN_WORKERS, tau=TRAIN_TAU, rounds=IMG_ROUNDS,
                batch=TRAIN_BATCH, score_keys={"loss", "accuracy"},
                want=lambda: {"lrn_across_channels_fwd": 2 * steps,
                              "lrn_across_channels_bwd": 2 * steps,
                              "max_pool_bwd": 3 * steps,
                              "lrn_across_channels": 2 * test_batches,
                              "ycc_to_rgb": counts["decoded"],
                              "resize_bilinear": counts["decoded"]})
        train_ds, test_ds = loaded
        dropped = sum(p.dropped for ds in loaded for p in ds.partitions)
        if counts["other_drops"] or dropped != counts["planted"] or \
                counts["planted"] < 2:
            fail(f"train_tar_dir: {dropped} drops counted, {counts} at the "
                 f"decoder (want every drop a read of the 2 planted "
                 f"entries, each read at least once)")
        if train_ds.count() != IMG_TRAIN or test_ds.count() != IMG_TEST:
            fail(f"train_tar_dir: {train_ds.count()} / {test_ds.count()} "
                 f"images indexed")
        tr = out["trainer"]
        first = out["report"]["rounds"][0]["loss"]
        if abs(first - math.log(1000)) > 1.0:
            fail(f"train_tar_dir: first round's loss {first:.4f}")
        n = tr.test_net.blob_shapes["data"][0] // tr.n_workers
        recs = test_ds.partitions[0][:n]
        x = np.stack([r[0] for r in recs])
        y = np.asarray([r[1] for r in recs], np.float32)
        init_loss = check_initial_test_loss(
            "train_tar_dir", tr, dev, TRAIN_CROP, 0.5,
            batch=(center_crop(x, TRAIN_CROP, mean=x.mean(axis=0)), y))
    med = out["report"]["steady_medians"]
    decode_rounds = [dt / max(n, 1) * 1e3 for dt, n in per_round]
    for r in out["report"]["rounds"]:
        print(f"train_tar_dir [{smi}] round {r['round']}: decode "
              f"{decode_rounds[r['round']]:.3f} ms an image on the feed "
              f"thread ({per_round[r['round']][1]} images)", flush=True)
    report = {
        "write_tars_s": write_s, "decode_counts": counts,
        "decode_ms_per_image_by_round": decode_rounds,
        "decode_ms_per_image": counts["seconds"] / max(
            counts["decoded"] + counts["planted"], 1) * 1e3,
        "dropped": dropped, "test_loss_at_init": init_loss,
        "steady_medians": med,
        "synthetic_device_crop_steady_medians (phase 5)": synthetic_loop,
        "peak_mem_gb": out["report"]["peak_mem_gb"]}
    print(f"train_tar_dir [{smi}] " + json.dumps(report), flush=True)
    syn = synthetic_loop
    print(f"train_tar_dir [{smi}]: loop {med['loop_s']:.3f} s a round "
          f"({med['img_s_loop']:.1f} img/s per card) from tars against "
          f"{syn['loop_s']:.3f} s ({syn['img_s_loop']:.1f} img/s) on "
          f"synthetic images, same call; decode "
          f"{report['decode_ms_per_image']:.3f} ms an image", flush=True)
    del out["trainer"]
    return {"report": report, "launches": out["report"]["launches"]}


def image_train_val(layer: str, train_src: str, test_src: str,
                    mean_file: str | None, root: str = "") -> str:
    """bvlc_reference_caffenet's train_val over encoded Datums
    (``layer="Data"``, ``mean_file``) or over lists of JPEGs under
    ``root`` (``layer="ImageData"``, new size 256, bvlc's mean values)."""
    text = caffenet_train_val(train_src, test_src, mean_file or "")
    if layer == "Data":
        return text
    for src, batch in ((train_src, SOLVER_TRAIN_BATCH),
                       (test_src, SOLVER_TEST_BATCH)):
        text = text.replace(
            f'data_param {{ source: "{src}" batch_size: {batch} '
            f'backend: LMDB }}',
            f'image_data_param {{ source: "{src}" root_folder: "{root}" '
            f'batch_size: {batch} new_height: {TRAIN_RESIZE} '
            f'new_width: {TRAIN_RESIZE} }}')
    return (text.replace('type: "Data"', 'type: "ImageData"')
            .replace('mean_file: ""', "mean_value: 104 mean_value: 117 "
                     "mean_value: 123"))


def cli_image_paths(ck, dev, smi: str) -> dict:
    """``convert_imageset --encoded`` of 256 JPEGs (ImageNet's commonest
    size, 375x500, under distinct names) to an LMDB, its mean through
    ``compute_image_mean``, then ``caffe_cli train`` for 5 iterations of
    bvlc_reference_caffenet's train_val over the encoded Datums and over
    an ImageData list of the same files (new size 256): exact launches,
    the image kernels once for each image decoded, finite losses."""
    import tempfile
    from sparknet_tpu_torch.data import jpeg
    from sparknet_tpu_torch.data.lmdb_io import LmdbReader
    from sparknet_tpu_torch.proto import load_mean_binaryproto
    from sparknet_tpu_torch.tools import (caffe_cli, compute_image_mean,
                                          convert_imageset)
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        e = json.load(f)["imagenet"]["imagenet_0"]
    data = fixture(e["file"])
    import threading
    rgb_cuda = jpeg._rgb_cuda
    decoded = {"n": 0}
    lock = threading.Lock()

    def counted(raw, dev_):   # runs on the feed's decode threads too
        out = rgb_cuda(raw, dev_)
        with lock:
            decoded["n"] += out is not None
        return out

    report: dict = {"launches": {}}
    with tempfile.TemporaryDirectory(prefix="cli_images_") as d, \
            mock.patch.object(jpeg, "_rgb_cuda", counted):
        os.makedirs(os.path.join(d, "img"))
        lines = []
        for i in range(256):
            with open(os.path.join(d, "img", f"{i:04d}.jpg"), "wb") as f:
                f.write(data)
            lines.append(f"{i:04d}.jpg {i % 1000}")
        listfile = os.path.join(d, "list.txt")
        with open(listfile, "w") as f:
            f.write("\n".join(lines) + "\n")
        db_path = os.path.join(d, "encoded_lmdb")
        _, report["convert_s"] = run_cli(convert_imageset.main, [
            os.path.join(d, "img") + "/", listfile, db_path, "--encoded"])
        with LmdbReader(db_path) as r:
            if len(r) != 256:
                fail(f"convert_imageset: {len(r)} records, want 256")
        mean_file = os.path.join(d, "mean.binaryproto")
        ck.reset_launch_counts()
        decoded["n"] = 0
        _, report["compute_image_mean_s"] = run_cli(
            compute_image_mean.main, [db_path, mean_file])
        report["launches"]["compute_image_mean"] = launched(ck)
        mean = load_mean_binaryproto(mean_file)
        err = float(np.abs(mean.reshape(3, -1).mean(1)
                           - e["channel_mean"]).max())
        if mean.shape != (3, e["height"], e["width"]) or err > 0.01 or \
                decoded["n"] != 256:
            fail(f"compute_image_mean of encoded Datums: shape "
                 f"{mean.shape}, channel means {err} from libjpeg's, "
                 f"{decoded['n']} decodes")
        report["mean_channel_max_diff_vs_libjpeg"] = err
        for layer, train_src, test_src, mf in (
                ("Data", db_path, db_path, mean_file),
                ("ImageData", listfile, listfile, None)):
            model = os.path.join(d, f"{layer}.prototxt")
            with open(model, "w") as f:
                f.write(image_train_val(layer, train_src, test_src, mf,
                                        os.path.join(d, "img") + "/"))
            solver = os.path.join(d, f"{layer}_solver.prototxt")
            with open(solver, "w") as f:
                f.write(f'net: "{model}"\n' + IMAGE_SOLVER)
            torch.cuda.empty_cache()
            ck.reset_launch_counts()
            decoded["n"] = 0
            log, wall = run_cli(caffe_cli.main, ["train", "--solver",
                                                 solver])
            launches = launched(ck)
            want = {"lrn_across_channels_fwd": 2 * IMAGE_SOLVER_ITERS,
                    "lrn_across_channels_bwd": 2 * IMAGE_SOLVER_ITERS,
                    "max_pool_bwd": 3 * IMAGE_SOLVER_ITERS,
                    "lrn_across_channels":
                        2 * IMAGE_SOLVER_TESTS * SOLVER_TEST_ITER,
                    "ycc_to_rgb": decoded["n"],
                    "resize_bilinear": decoded["n"]}
            losses = [float(ln.rsplit("= ", 1)[1]) for ln in log.splitlines()
                      if "] Iteration " in ln and ", loss = " in ln]
            feed = [json.loads(ln.split("] Train feed: ")[1])
                    for ln in log.splitlines() if "] Train feed: " in ln]
            if launches != want or decoded["n"] < SOLVER_TRAIN_BATCH * \
                    IMAGE_SOLVER_ITERS or len(losses) < IMAGE_SOLVER_ITERS \
                    or not all(math.isfinite(v) for v in losses):
                print(log[-3000:])
                fail(f"caffe_cli train ({layer} over JPEGs): launches "
                     f"{launches}, want {want}; losses {losses}")
            key = "caffe_cli_train_" + ("encoded" if layer == "Data"
                                        else "image_data")
            report["launches"][key] = launches
            report[key] = {"wall_s": wall, "losses": losses,
                           "decoded": decoded["n"],
                           "feed": feed[0] if feed else None}
    print(f"cli_images [{smi}] " + json.dumps(report), flush=True)
    return report


def window_batch(ck, dev, smi: str) -> dict:
    """One WindowData batch (R-CNN's window file over three ImageNet-sized
    fixtures: crop 227, context_pad 16, mirror, bvlc's mean values, batch
    128) built on the card, against the same batch with the image
    kernels swapped for their plain versions on the card: equal bytes."""
    import tempfile
    from sparknet_tpu_torch.data import db
    from sparknet_tpu_torch.proto import Phase, load_net_prototxt
    rng = np.random.default_rng(SEED + 22)
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        ims = json.load(f)["imagenet"]
    with tempfile.TemporaryDirectory(prefix="windows_") as d:
        blocks = []
        for i, name in enumerate(("imagenet_0", "imagenet_1", "imagenet_4")):
            e = ims[name]
            path = os.path.join(d, e["file"])
            with open(path, "wb") as f:
                f.write(fixture(e["file"]))
            h, w = e["height"], e["width"]
            wins = []
            for _ in range(20):
                x1 = int(rng.integers(0, w - 20))
                y1 = int(rng.integers(0, h - 20))
                x2 = int(min(x1 + rng.integers(16, w), w - 1))
                y2 = int(min(y1 + rng.integers(16, h), h - 1))
                wins.append(f"{int(rng.integers(1, 21))} "
                            f"{rng.uniform(0, 1):.3f} {x1} {y1} {x2} {y2}")
            blocks.append(f"# {i}\n{path}\n3 {h} {w}\n{len(wins)}\n"
                          + "\n".join(wins))
        source = os.path.join(d, "windows.txt")
        with open(source, "w") as f:
            f.write("\n".join(blocks) + "\n")
        lp = load_net_prototxt(
            'layer { name: "data" type: "WindowData" top: "data" '
            'top: "label" transform_param { crop_size: 227 mirror: true '
            'mean_value: 104 mean_value: 117 mean_value: 123 } '
            f'window_data_param {{ source: "{source}" batch_size: 128 '
            'fg_threshold: 0.5 bg_threshold: 0.5 fg_fraction: 0.25 '
            'context_pad: 16 } }').layer[0]
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        got = next(db.window_data_feed(lp, Phase.TRAIN, seed=SEED,
                                       device=dev))
        wall = time.perf_counter() - t0
        launches = launched(ck)
        with mock.patch.object(ck, "resize_bilinear",
                               ck.resize_bilinear_reference), \
                mock.patch.object(ck, "ycc_to_rgb",
                                  ck.ycc_to_rgb_reference):
            ck.reset_launch_counts()
            want = next(db.window_data_feed(lp, Phase.TRAIN, seed=SEED,
                                            device=dev))
            plain_launches = launched(ck)
    if got.keys() != want.keys() or any(
            got[k].tobytes() != want[k].tobytes() for k in want) or \
            got["data"].shape != (128, 3, 227, 227) or \
            not launches["resize_bilinear"] or any(plain_launches.values()):
        fail(f"window_data: the batch on the card differs from the plain "
             f"path's (launches {launches}, plain {plain_launches})")
    report = {"wall_s": wall, "launches": launches,
              "windows_fg_share": float((got["label"] > 0).mean())}
    print(f"window_data [{smi}] " + json.dumps(report), flush=True)
    return report


def real_images(ck, dev, smi: str, synthetic_loop: dict) -> dict:
    """Phase 5d."""
    t0 = time.perf_counter()
    out = {"kernels": check_image_kernels(ck, dev, smi)}
    torch.cuda.empty_cache()
    out["tar_dir"] = train_from_tars(ck, dev, smi, synthetic_loop)
    torch.cuda.empty_cache()
    out["cli"] = cli_image_paths(ck, dev, smi)
    out["window"] = window_batch(ck, dev, smi)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"images phase [{smi}]: {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 6: the kernels line
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 5e: the round — the hierarchical strategy through caffe_cli, the
# compressed exchange with error feedback, round checkpoints with resume
# after a crash, the numerical guard, elastic re-forming and the harvest
# lag, on full-width CaffeNet
# ---------------------------------------------------------------------------

# caffe_cli train --devices 4 --strategy hierarchical --hosts 2 --tau 5
# over phase 5c's LMDB: phase 5b's solver with display 1, 5 iterations
# (1 round; a depth that keeps the whole script inside its time limit),
# one test pass at 5
HIER_DEVICES, HIER_HOSTS, HIER_TAU, HIER_ITERS = 4, 2, 5, 5
HIER_SOLVER = (DATA_PATH_SOLVER.replace("max_iter: 20",
                                        f"max_iter: {HIER_ITERS}")
               .replace("test_interval: 10", f"test_interval: {HIER_ITERS}")
               .replace("snapshot: 20\n", ""))
# the first round's mean loss from random weights: near ln 1000, as
# phase 5's first round
HIER_LOSS0_TOL = 1.0
HIER_WANT = {"lrn_across_channels_fwd": 2 * HIER_DEVICES * HIER_ITERS,
             "lrn_across_channels_bwd": 2 * HIER_DEVICES * HIER_ITERS,
             "max_pool_bwd": 3 * HIER_DEVICES * HIER_ITERS,
             # one test pass: ceil(test_iter 2 / 4 workers) step of 4
             # worker batches, 2 LRNs each
             "lrn_across_channels": 2 * HIER_DEVICES,
             **IMAGE_KERNELS_IDLE}
# the codec rounds: 2 workers x batch 64, τ=5, 2 rounds of full-size
# 256x256 images cropped, mirrored and mean-subtracted on the card (a
# round count that keeps the whole script inside its time limit; the
# steady figures are round 1's)
ROUND_WORKERS, ROUND_BATCH, ROUND_TAU, ROUNDS = 2, 64, 5, 2
ROUND_WANT = {"lrn_across_channels_fwd": 2 * ROUND_WORKERS * ROUND_TAU
              * ROUNDS,
              "lrn_across_channels_bwd": 2 * ROUND_WORKERS * ROUND_TAU
              * ROUNDS,
              "max_pool_bwd": 3 * ROUND_WORKERS * ROUND_TAU * ROUNDS,
              "lrn_across_channels": 0, **IMAGE_KERNELS_IDLE}
CODECS = ("none", "bf16", "int8", "int8_channel")
# wire bytes of one exchange of CaffeNet's 60,965,224 params over 2
# tiers, by the JAX package's exchange_bytes
EXCHANGE_BYTES = {"none": 487_721_792, "bf16": 243_860_896,
                  "int8": 121_930_576, "int8_channel": 122_015_056}
# tests/test_comms.py:247-258's bound on a lossy codec's last loss
CODEC_LOSS_BOUND = 0.1
CRASH_ROUND, NAN_ROUND = 2, 1


def round_data(dev, r: int) -> dict:
    """Round ``r`` of the codec and recovery runs, drawn on the card
    from a seeded generator (the same bits in every process on one
    card): [τ, 128, 3, 256, 256] f32 pixels around 120 and labels."""
    g = torch.Generator(device=dev).manual_seed(SEED * 1000 + 17 + r)
    n = ROUND_WORKERS * ROUND_BATCH
    x = torch.randn((ROUND_TAU, n, 3, TRAIN_RESIZE, TRAIN_RESIZE),
                    generator=g, device=dev).mul_(30.0).add_(120.0)
    labels = torch.randint(0, 1000, (ROUND_TAU, n),
                           generator=torch.Generator().manual_seed(r))
    return {"data": x.clamp_(0.0, 255.0),
            "label": labels.to(dev, torch.float32)}


def round_trainer(dev, workers=ROUND_WORKERS, **cfg):
    """The second entry point of this phase: a ``DistributedTrainer``
    built from ``comm_config_from_env`` (``SPARKNET_COMM_CODEC`` picks
    the codec) over full-width CaffeNet, local_sgd (or ``cfg``'s
    strategy on a ``workers`` layout), τ=5, with the crop, mirror and
    mean on the card (``device_crop_mirror_mean``)."""
    from sparknet_tpu_torch.apps.imagenet_app import SOLVER
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.parallel import (DistributedTrainer,
                                             TrainerConfig,
                                             comm_config_from_env,
                                             device_crop_mirror_mean)
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    n = ROUND_WORKERS * ROUND_BATCH
    sp = load_solver_prototxt_with_net(SOLVER,
                                       caffenet(n, n, crop=TRAIN_CROP))
    mean = np.full((3, TRAIN_RESIZE, TRAIN_RESIZE), 120.0, np.float32)
    config = comm_config_from_env(TrainerConfig(**{
        "strategy": "local_sgd", "tau": ROUND_TAU,
        "device_preprocess": device_crop_mirror_mean(TRAIN_CROP, mean=mean),
        **cfg}))
    return DistributedTrainer(sp, workers, config, seed=SEED, device=dev)


def host_params(tr) -> dict:
    return {k: [b.detach().cpu().numpy() for b in v]
            for k, v in tr.params.items()}


def round_child(mode: str, d: str, out: str, dev=None) -> int:
    """One recovery run in a process of its own (``--round-child``): the
    int8 trainer (the codec from ``SPARKNET_COMM_CODEC``) trains
    ``ROUNDS`` rounds and writes its final params and counters to
    ``out``.  Modes: "clean" (no checkpoints), "run" (round checkpoints
    in ``d`` every round on the asynchronous writer, resuming from
    ``d``), "guard" (``guard_numerics``, checkpoints every 2 rounds),
    and "reset_generators" ("run" with the resumed workers' Dropout and
    crop generators re-seeded: a planted fault the parent must catch).
    ``SPARKNET_FAULT``, set by the parent, may kill or poison it."""
    from sparknet_tpu_torch.utils.checkpoint import save_checkpoint
    dev = dev or torch.device("cuda", 0)
    cfg = {} if mode == "clean" else dict(
        checkpoint_dir=d, checkpoint_keep=2,
        checkpoint_every=2 if mode == "guard" else 1,
        guard_numerics=mode == "guard")
    with cudnn_deterministic():
        t0 = time.perf_counter()
        tr = round_trainer(dev, **cfg)
        init_s = time.perf_counter() - t0
        resumed = tr.round
        if mode == "reset_generators":
            for i, g in enumerate(tr.generators + tr.crop_generators):
                g.manual_seed(7 + i)
        t0 = time.perf_counter()
        while tr.round < ROUNDS:
            tr.train_round(round_data(dev, tr.round))
        loop_s = time.perf_counter() - t0
        submit_stall = tr.stall_s["checkpoint"]
        t0 = time.perf_counter()
        tr.drain()
        drain_s = time.perf_counter() - t0
    save_checkpoint(out, {
        "params": host_params(tr), "resumed_round": resumed,
        "guard_trips": tr.guard_trips, "init_s": init_s, "loop_s": loop_s,
        "drain_s": drain_s, "ckpt_submit_stall_s": submit_stall,
        "losses": [tr.round_losses.get(r, float("nan"))
                   for r in range(ROUNDS)]})
    return 0


def run_child(mode: str, d: str, out: str, fault: str = "",
              attempt: int = 0) -> tuple[int, float, str]:
    """``chip_smoke.py --round-child`` in a new process: exit code, wall
    seconds, the tail of its standard error."""
    env = dict(os.environ, SPARKNET_COMM_CODEC="int8", SPARKNET_FAULT=fault,
               SPARKNET_FAULT_ATTEMPT=str(attempt))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--round-child", mode, "--round-dir", d,
                        "--round-out", out], env=env, capture_output=True,
                       text=True, timeout=600)
    return p.returncode, time.perf_counter() - t0, p.stderr[-3000:]


def ef_holds(codec, delta: dict) -> bool:
    """The error-feedback invariant on the card's tensors:
    ``decoded + residual == delta`` exactly, leaf by leaf."""
    from sparknet_tpu_torch.parallel import comms
    _, decoded, residual = comms.roundtrip_tree(codec, delta)
    return all(torch.equal(decoded[k][i] + residual[k][i], delta[k][i])
               for k in delta for i in range(len(delta[k])))


def card_encode_equals_cpu(codec, delta: dict) -> bool:
    """The card's encode of ``delta`` (payload and residual) equals the
    CPU's bit for bit: the scale's division must not become a
    multiplication by a reciprocal on the card."""
    from sparknet_tpu_torch.parallel import comms
    cpu = {k: [b.cpu() for b in v] for k, v in delta.items()}
    pa, _, ra = comms.roundtrip_tree(codec, delta)
    pb, _, rb = comms.roundtrip_tree(codec, cpu)
    flat = lambda p: ([p] if isinstance(p, torch.Tensor)
                      else [t for x in p for t in flat(x)])
    for k in delta:
        for i in range(len(delta[k])):
            for x, y in zip(flat(pa[k][i]), flat(pb[k][i])):
                if not torch.equal(x.cpu(), y):
                    return False
            if not torch.equal(ra[k][i].cpu(), rb[k][i]):
                return False
    return True


def hierarchical_cli(ck, dev, smi: str, fx: dict) -> dict:
    """``caffe_cli train --devices 4 --strategy hierarchical --hosts 2
    --tau 5`` on CaffeNet's train_val over phase 5c's LMDB (batch 256 a
    worker): its iterations and losses, the 2x2 layout, per-host solver
    state, exact launches."""
    import sparknet_tpu_torch.parallel as par
    from sparknet_tpu_torch.tools import caffe_cli
    d = fx["dir"]
    prefix = os.path.join(d, "hier")
    solver = os.path.join(d, "hier_solver.prototxt")
    with open(solver, "w") as f:
        f.write(f'net: "{fx["model"]}"\nsnapshot_prefix: "{prefix}"\n'
                + HIER_SOLVER)
    made = []

    class Recorded(par.DistributedTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    torch.cuda.empty_cache()
    ck.reset_launch_counts()
    with mock.patch.object(par, "DistributedTrainer", Recorded):
        log, wall = run_cli(caffe_cli.main, [
            "train", "--solver", solver, "--devices", str(HIER_DEVICES),
            "--strategy", "hierarchical", "--hosts", str(HIER_HOSTS),
            "--tau", str(HIER_TAU)])
    launches = launched(ck)
    if launches != HIER_WANT:
        fail(f"round: hierarchical caffe_cli launches {launches}, want "
             f"{HIER_WANT}")
    losses = {int(ln.split("Iteration ")[1].split(",")[0]):
              float(ln.rsplit("= ", 1)[1])
              for ln in log.splitlines() if ", loss = " in ln}
    tests = [ln for ln in log.splitlines() if "Test net output:" in ln]
    if (sorted(losses) != sorted({HIER_TAU, HIER_ITERS}) or len(tests) != 2
            or "Multi-device training: 2x2 pod" not in log
            or "Optimization Done." not in log
            or not all(math.isfinite(v) for v in losses.values())
            or abs(losses[HIER_TAU] - math.log(1000)) > HIER_LOSS0_TOL):
        print(log[-3000:])
        fail(f"round: hierarchical caffe_cli log: losses {losses}, "
             f"{len(tests)} test outputs")
    (tr,) = made
    shapes = {k: [tuple(b.shape) for b in v] for k, v in tr.params.items()}
    if ((tr.n_hosts, tr.n_chips, tr.n_workers) != (2, 2, 4)
            or len(tr.state) != HIER_HOSTS
            or any({k: [tuple(b.shape) for b in v]
                    for k, v in s["history"].items()} != shapes
                   for s in tr.state)
            or torch.equal(tr.state[0]["history"]["conv1"][0],
                           tr.state[1]["history"]["conv1"][0])):
        fail("round: hierarchical per-host solver state is not one "
             "distinct state of the params' shapes per host")
    out = {"losses": losses, "wall_s": wall, "launches": launches,
           "hosts": tr.n_hosts, "chips": tr.n_chips,
           "state_rows": len(tr.state),
           "per_host_state_shape_conv1": list(
               tr.state[0]["history"]["conv1"][0].shape),
           "round_s": [tr.round_seconds[r] for r in sorted(tr.round_seconds)],
           "test_outputs": tests}
    del made[:], tr
    torch.cuda.empty_cache()
    return out


def codec_rounds(ck, dev, rounds: list) -> dict:
    """Each codec, ``ROUNDS`` rounds of 2 workers from the same weights on
    the same rounds, through ``comm_config_from_env``; int8 once more with
    ``comm_overlap``.  Exact launches, exchange bytes against the JAX
    package's, the EF invariant and the card's encode against the CPU's
    on a delta the run made, int8's last loss within
    ``CODEC_LOSS_BOUND`` of none's, overlap bit-identical; a codec that
    drops its residual must fail the EF check."""
    from sparknet_tpu_torch.parallel import comms
    out, finals = {}, {}
    for codec, overlap in [(c, False) for c in CODECS] + [("int8", True)]:
        label = codec + ("_overlap" if overlap else "")
        with mock.patch.dict(os.environ, {
                "SPARKNET_COMM_CODEC": codec,
                "SPARKNET_COMM_OVERLAP": "1" if overlap else "0"}):
            tr = round_trainer(dev)
        if tr.config.comm_codec != codec or \
                tr.config.comm_overlap != overlap:
            fail(f"round: comm_config_from_env gave {tr.config}")
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        # the collector held off the rounds, as commbench holds it: a
        # collection of this process's heap (~0.1 s) landing in one
        # stage's host window is not the exchange's stall
        gc.collect()
        gc.disable()
        try:
            losses = [tr.train_round(b) for b in rounds]
        finally:
            gc.enable()
        launches = launched(ck)
        if launches != ROUND_WANT:
            fail(f"round {label}: launches {launches}, want {ROUND_WANT}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"round {label}: losses {losses}")
        nbytes = comms.exchange_bytes(comms.get_codec(codec), tr.params,
                                      ROUND_WORKERS)
        if nbytes != EXCHANGE_BYTES[codec]:
            fail(f"round {label}: exchange bytes {nbytes}, want "
                 f"{EXCHANGE_BYTES[codec]}")
        out[label] = {"losses": losses, "exchange_bytes": nbytes,
                      "round_s": [tr.round_seconds[r] for r in range(ROUNDS)],
                      "round_s_steady_median": float(np.median(
                          [tr.round_seconds[r] for r in range(1, ROUNDS)])),
                      "stall_s": {k: tr.stall_s[k] for k in
                                  ("comm_encode", "comm_allreduce",
                                   "comm_decode")},
                      "launches": launches}
        finals[label] = host_params(tr)
        if codec != "none" and not overlap:
            # a delta of the run's own: each worker's params against the
            # averaged ones, plus the residual
            delta = {k: [torch.stack([p[k][i] for p in tr.worker_params])
                         - b.unsqueeze(0) + tr.comm_residual[k][i]
                         for i, b in enumerate(v)]
                     for k, v in tr.params.items()}
            c = comms.get_codec(codec)
            out[label]["ef_invariant_exact"] = ef_holds(c, delta)
            out[label]["card_encode_equals_cpu"] = \
                card_encode_equals_cpu(c, delta)
            if not (out[label]["ef_invariant_exact"]
                    and out[label]["card_encode_equals_cpu"]):
                fail(f"round {label}: EF invariant or card-vs-CPU encode "
                     f"broken: {out[label]}")
            if codec == "int8":
                dropres = comms.Codec("int8_dropres_planted", c.encode,
                                      c.decode, keep_residual=False)
                if ef_holds(dropres, delta):
                    fail("round: planted codec without its residual "
                         "passed the EF check")
            del delta
        del tr
        torch.cuda.empty_cache()
    if differing(finals["int8"], finals["int8_overlap"]):
        fail("round: int8 with comm_overlap differs from without")
    # both charge each stage's host time (F4); only the run without
    # overlap also waits for the device after each stage
    ov, sy = out["int8_overlap"]["stall_s"], out["int8"]["stall_s"]
    if not (ov["comm_encode"] > 0 and ov["comm_decode"] > 0
            and sy["comm_encode"] > 0
            and sum(ov.values()) < sum(sy.values())):
        fail(f"round: stall_s with/without overlap "
             f"{out['int8_overlap']['stall_s']} / {out['int8']['stall_s']}")
    gap = abs(out["int8"]["losses"][-1] - out["none"]["losses"][-1])
    if gap > CODEC_LOSS_BOUND:
        fail(f"round: int8's last loss is {gap} from none's")
    out["int8_vs_none_last_loss_gap"] = gap
    return out


def hierarchical_rounds(ck, dev, rounds: list) -> dict:
    """4 workers at batch 64 as 2 hosts x 2 chips (codec none), on each
    round's images twice over (256 a step), against the 2-worker
    local_sgd rounds of ``codec_rounds``: round seconds and exact
    launches."""
    from sparknet_tpu_torch.parallel import make_pod_mesh
    with mock.patch.dict(os.environ, {"SPARKNET_COMM_CODEC": "none"}):
        tr = round_trainer(dev, make_pod_mesh(2, 2),
                           strategy="hierarchical")
    wide = [{k: torch.cat([v, v], 1) for k, v in b.items()}
            for b in rounds]
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    losses = [tr.train_round(b) for b in wide]
    launches = launched(ck)
    want = {k: 2 * v for k, v in ROUND_WANT.items()}
    if launches != want or len(tr.state) != 2 or \
            not all(math.isfinite(v) for v in losses):
        fail(f"round hierarchical 2x2 b64: launches {launches} (want "
             f"{want}), losses {losses}, {len(tr.state)} states")
    out = {"losses": losses, "launches": launches,
           "round_s": [tr.round_seconds[r] for r in range(ROUNDS)],
           "round_s_steady_median": float(np.median(
               [tr.round_seconds[r] for r in range(1, ROUNDS)]))}
    del tr, wide
    torch.cuda.empty_cache()
    return out


def child_result(name: str, mode: str, cdir: str, d: str, *,
                 fault: str = "", attempt: int = 0, want_rc: int = 0):
    """Run one recovery child; its report and (exit 0) its output."""
    from sparknet_tpu_torch.utils.checkpoint import load_checkpoint
    out = os.path.join(d, f"{name}.npz")
    rc, wall, err = run_child(mode, cdir, out, fault, attempt)
    if rc != want_rc:
        print(err)
        fail(f"round recovery {name}: exit {rc}, want {want_rc}")
    rep = {"rc": rc, "wall_s": wall}
    if rc != 0:
        return rep, None
    got = load_checkpoint(out)
    rep.update({k: np.asarray(got[k]).tolist() for k in (
        "resumed_round", "guard_trips", "init_s", "loop_s", "drain_s",
        "ckpt_submit_stall_s", "losses")})
    return rep, got


def recovery(ck, dev, rounds: list, d: str) -> dict:
    """Children on the same card: a fault-free run; a run killed by
    ``crash_in_ckpt`` while writing round 2's checkpoint (exit 43, npz
    without manifest) and its resume, bit for bit the fault-free params;
    the same resume with its generators reset, which must differ; a run
    poisoned by ``nan_inject`` under the guard, one trip and the
    fault-free params.  Then a scribbled newest checkpoint, which resume
    must skip and report; a synchronous checkpoint's stall; elastic
    4 -> 2; harvest lag 0 against 2."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor
    from sparknet_tpu_torch.utils import faults
    rep: dict = {}
    crash = f"crash_in_ckpt@round:{CRASH_ROUND}"
    cdir = os.path.join(d, "crash")
    # the children that share no files run at once, each in its own
    # process on the card (deterministic cuDNN: the same bits)
    with ThreadPoolExecutor(3) as pool:
        runs = [pool.submit(child_result, "clean", "clean", "", d),
                pool.submit(child_result, "crash", "run", cdir, d,
                            fault=crash, want_rc=43),
                pool.submit(child_result, "guard", "guard",
                            os.path.join(d, "guard"), d,
                            fault=f"nan_inject@round:{NAN_ROUND}")]
        (rep["clean"], clean), (rep["crash"], _), (rep["guard"], guarded) \
            = [r.result() for r in runs]
    names = set(os.listdir(cdir))
    last = f"{CRASH_ROUND - 1:08d}"
    if (f"ckpt_round_{CRASH_ROUND:08d}.npz" not in names
            or f"manifest_{CRASH_ROUND:08d}.json" in names
            or f"manifest_{last}.json" not in names):
        fail(f"round recovery: the crash left {sorted(names)}")
    # the planted resume starts from the same files (linked, not copied)
    pdir = os.path.join(d, "planted")
    os.makedirs(pdir)
    for n in (f"manifest_{last}.json", f"ckpt_round_{last}.npz"):
        os.link(os.path.join(cdir, n), os.path.join(pdir, n))
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(child_result, "resume", "run", cdir, d,
                            fault=crash, attempt=1),
                pool.submit(child_result, "reset_generators",
                            "reset_generators", pdir, d)]
        (rep["resume"], resumed), (rep["reset_generators"], planted) = [
            r.result() for r in runs]
    if rep["resume"]["resumed_round"] != CRASH_ROUND - 1 or \
            differing(resumed["params"], clean["params"]):
        fail(f"round recovery: the resumed run ({rep['resume']}) differs "
             f"from the fault-free run")
    if planted["resumed_round"] != CRASH_ROUND - 1 or \
            not differing(planted["params"], clean["params"]):
        fail("round recovery: a resume with reset generators passed the "
             "bit-for-bit check")
    if rep["guard"]["guard_trips"] != 1 or \
            differing(guarded["params"], clean["params"]):
        fail(f"round recovery: nan_inject under the guard: {rep['guard']}")
    del clean, resumed, planted, guarded
    newest = os.path.join(cdir, f"ckpt_round_{ROUNDS:08d}.npz")
    rep["checkpoint_mb"] = os.path.getsize(newest) / 1e6
    written = ROUNDS - (CRASH_ROUND - 1)
    rep["async_stall_s_per_checkpoint"] = \
        rep["resume"]["ckpt_submit_stall_s"] / written
    rep["resume_s"] = rep["resume"]["init_s"] - rep["clean"]["init_s"]
    # a scribbled newest checkpoint: resume skips it, says so, and lands
    # on the one before
    faults.scribble(newest)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), mock.patch.dict(
            os.environ, {"SPARKNET_COMM_CODEC": "int8"}):
        tr = round_trainer(dev, checkpoint_dir=cdir, checkpoint_keep=2)
    if (tr.round != ROUNDS - 1
            or f"resume: skipping manifest_{ROUNDS:08d}.json"
            not in err.getvalue()):
        print(err.getvalue()[-2000:])
        fail(f"round recovery: the scribbled checkpoint was not skipped "
             f"(resumed round {tr.round})")
    # one synchronous checkpoint of the same state, for its stall
    with mock.patch.dict(os.environ, {"SPARKNET_ASYNC_CKPT": "0"}):
        s0 = tr.stall_s["checkpoint"]
        tr.save_round_checkpoint(os.path.join(d, "sync_ckpt"))
        rep["sync_stall_s_per_checkpoint"] = tr.stall_s["checkpoint"] - s0
    del tr
    torch.cuda.empty_cache()
    rep["elastic"] = elastic_4_to_2(dev, rounds, os.path.join(d, "elastic"))
    rep["harvest_lag"] = harvest_lag_0_vs_2(dev, rounds)
    return rep


def elastic_4_to_2(dev, rounds: list, d: str) -> dict:
    """A 4-worker checkpoint (batch 32 a worker, codec none) resumed by a
    2-worker elastic trainer: the params restore as they are, the
    per-worker state re-tiers to rows 0 and 1, and it trains on."""
    with mock.patch.dict(os.environ, {"SPARKNET_COMM_CODEC": "none",
                                      "SPARKNET_ASYNC_CKPT": "0"}):
        a = round_trainer(dev, workers=4, checkpoint_dir=d)
        a.train_round(rounds[0])
        want = host_params(a)
        rows = [s["history"]["fc6"][0].cpu() for s in a.state]
        del a
        torch.cuda.empty_cache()
        b = round_trainer(dev, elastic=True)
        t0 = time.perf_counter()
        b.resume_latest(d)
        resume_s = time.perf_counter() - t0
    if (b.round != 1 or differing(host_params(b), want)
            or len(b.state) != 2
            or any(not torch.equal(b.state[i]["history"]["fc6"][0].cpu(),
                                   rows[i]) for i in range(2))):
        fail("round: elastic 4 -> 2 did not restore params and re-tier "
             "the state")
    loss = b.train_round(rounds[1])
    if not math.isfinite(loss):
        fail(f"round: elastic 2-worker round loss {loss}")
    del b
    torch.cuda.empty_cache()
    return {"resume_s": resume_s, "loss_after": loss}


def harvest_lag_0_vs_2(dev, rounds: list) -> dict:
    """``ROUNDS`` rounds at harvest_lag 0 and at 2 from the same weights:
    losses and params bit-identical; the loops' seconds."""
    out, finals, losses = {}, {}, {}
    for lag in (0, 2):
        with mock.patch.dict(os.environ, {"SPARKNET_COMM_CODEC": "none"}):
            tr = round_trainer(dev, harvest_lag=lag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in rounds:
            tr.train_round(b)
        losses[lag] = tr.drain()
        out[f"lag{lag}_loop_s"] = time.perf_counter() - t0
        finals[lag] = host_params(tr)
        del tr
        torch.cuda.empty_cache()
    if losses[0] != losses[2] or differing(finals[0], finals[2]):
        fail(f"round: harvest_lag 2 differs from 0: {losses}")
    out["losses"] = [losses[0][r] for r in range(ROUNDS)]
    return out


def the_round(ck, dev, smi: str, fx: dict) -> dict:
    """Phase 5e: the hierarchical strategy through caffe_cli over phase
    5c's LMDB, the codec rounds, and recovery; one ``round [...]`` JSON
    line.  Every card-side run is under deterministic cuDNN, so replays
    across processes are bit for bit."""
    import tempfile
    t_phase = time.perf_counter()
    report: dict = {}
    with cudnn_deterministic():
        report["hierarchical"] = hierarchical_cli(ck, dev, smi, fx)
        rounds = [round_data(dev, r) for r in range(ROUNDS)]
        report["codecs"] = codec_rounds(ck, dev, rounds)
        report["hierarchical_b64"] = hierarchical_rounds(ck, dev, rounds)
        report["hierarchical_b64"]["vs_local_sgd_2x64"] = (
            report["hierarchical_b64"]["round_s_steady_median"]
            / report["codecs"]["none"]["round_s_steady_median"])
        with tempfile.TemporaryDirectory(prefix="round_smoke_") as d:
            report["recovery"] = recovery(ck, dev, rounds, d)
        del rounds
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"round [{smi}] " + json.dumps(report), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5f: the bench — sparknet_tpu_torch.bench at its defaults (CaffeNet,
# batch 256, 20 iterations, both dtypes, every tier) in process, its CLI
# in a child, tools/profile_step on CaffeNet b256 f32, and the telemetry
# plane on the card, with planted faults
# ---------------------------------------------------------------------------

# the hand kernels' names in a profile of the train step (B2 runs in
# no train step: its launches there are 0 by the counts)
PROFILE_KERNELS = {"lrn_across_channels_fwd": r"lrn_fwd(_generic)?_kernel",
                   "lrn_across_channels_bwd": r"lrn_bwd(_generic)?_kernel",
                   "max_pool_bwd": r"maxpool_bwd_kernel"}
PROFILE_LAYERS = ("norm1", "norm2", "pool1", "pool2", "pool5")
# the keys of the bench line beyond BENCH_r05.json's ``parsed``: those the
# JAX bench has printed since (bench.py:735-760) and the port's peak_flops
BENCH_LINE_EXTRA = {"fuse_plan", "tune_plan", "round_overhead", "serving",
                    "provenance", "feed_records", "shard_round",
                    "peak_flops"}
# the JAX bench's records tier's keys (bench.py:464-477)
FEED_RECORDS_KEYS = {"feed_source", "records", "edge", "batch", "epochs",
                     "images_per_sec", "serial_img_s", "speedup_x",
                     "convert_s", "read_s", "serial_decode_s", "cache"}
# the CLI contract's short configuration
BENCH_CLI_ENV = {"BENCH_ITERS": "2", "BENCH_REPS": "1", "BENCH_WINDOWS": "1",
                 "BENCH_FEED_ITERS": "2", "BENCH_ROUND_N": "1",
                 "BENCH_ROUND_TAU": "2", "BENCH_SERVE_SECONDS": "0.5",
                 "BENCH_RECORDS_N": "64", "BENCH_RECORDS_EDGE": "64",
                 "BENCH_RECORDS_BATCH": "32", "BENCH_RECORDS_EPOCHS": "1"}
BENCH_TIME_TOL, SOLVER_TIME_TOL, PROFILE_TIME_TOL = 0.10, 0.15, 0.15
TELEMETRY_ROUNDS = 2
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def want_steps(steps: int, forwards: int = 0) -> dict:
    """Every kernel's launches for ``steps`` CaffeNet train steps and
    ``forwards`` test-net forwards."""
    return {"lrn_across_channels_fwd": 2 * steps,
            "lrn_across_channels_bwd": 2 * steps,
            "max_pool_bwd": 3 * steps,
            "lrn_across_channels": 2 * forwards, **IMAGE_KERNELS_IDLE}


def block_time_ok(host_s: float, event_s: float) -> bool:
    """A host window that ends at ``torch.cuda.synchronize()`` holds the
    device time between its first launch and its end, and not 10% more."""
    return event_s * (1 - 1e-4) <= host_s <= (1 + BENCH_TIME_TOL) * event_s


def event_timed_blocks(bench_mod, solver, reps: int, iters: int,
                       sync) -> tuple[float, float]:
    """(host s, CUDA-event s) of one bench window of ``reps`` blocks, the
    events recorded inside the window around the blocks' launches and
    ``sync`` (the bench's ``torch.cuda.synchronize``) ending it."""
    from sparknet_tpu_torch.utils.profiling import train_block
    block = train_block(solver, iters)
    block()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    calls = [0]

    def run():
        if calls[0] == 0:
            start.record()
        block()
        calls[0] += 1
        if calls[0] == reps:
            end.record()

    host = bench_mod.timed_windows(run, reps, 1, sync)[0]
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / 1e3


def bench_solver(dev, cfg, dtype: str):
    import itertools
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    from sparknet_tpu_torch.solvers import Solver
    from sparknet_tpu_torch.utils.profiling import (BENCH_SOLVER_PROTOTXT,
                                                    build_bench_model)
    net, in_shape, classes = build_bench_model(cfg.model, cfg.batch)
    solver = Solver(load_solver_prototxt_with_net(BENCH_SOLVER_PROTOTXT,
                                                  net), seed=0, device=dev,
                    compute_dtype=torch.bfloat16 if dtype == "bf16"
                    else None)
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    batch = {"data": torch.randn((cfg.batch,) + in_shape, generator=g,
                                 device=dev),
             "label": torch.randint(0, classes, (cfg.batch,), device=dev,
                                    generator=g).float()}
    solver.set_train_data(itertools.repeat(batch))
    return solver


def bench_in_process(ck, dev, smi: str, solver_ms_b256: float) -> dict:
    """The bench at its defaults but 1 timed window, 1 epoch of the
    records tier, 1 round a round leg and 1 s serving points (the
    script's time limit), each phase's launches
    counted from 0 and each of its timed windows also timed by CUDA
    events recorded inside it, around its blocks' launches; every check
    of the line."""
    from sparknet_tpu_torch import bench as bench_mod
    cfg = bench_mod.BenchConfig(windows=1, records_epochs=1, round_n=1,
                                serve_seconds=1.0)
    launches: dict[str, dict] = {}
    windows: dict[str, list] = {}
    current: list = [None]

    def on_phase(name):
        if current[0] is not None:
            launches[current[0]] = launched(ck)
        ck.reset_launch_counts()
        current[0] = name

    timed = bench_mod.timed_windows

    def event_windows(run, reps, n, sync):
        """The bench's timer, ``run`` wrapped to record a CUDA event
        before the first and after the last block of each window."""
        marks: list = []
        calls = [0]

        def marked():
            if calls[0] % reps == 0:
                marks.append([torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)])
                marks[-1][0].record()
            out = run()
            calls[0] += 1
            if calls[0] % reps == 0:
                marks[-1][1].record()
            return out

        host = timed(marked, reps, n, sync)
        torch.cuda.synchronize()
        windows.setdefault(current[0], []).extend(
            zip(host, [a.elapsed_time(b) / 1e3 for a, b in marks]))
        return host

    t0 = time.perf_counter()
    with mock.patch.object(bench_mod, "timed_windows", event_windows):
        line = bench_mod.run(cfg, "cuda", on_phase)
    wall = time.perf_counter() - t0
    print(f"bench [{smi}] ({wall:.1f} s) " + json.dumps(line), flush=True)
    it, reps, win = cfg.iters, cfg.reps, cfg.windows
    steps_per_dtype = (1 + win * reps) * it
    forwards_per_dtype = 1 + win * it * reps
    want = {}
    for d in cfg.dtypes:
        want[f"bench_caffenet_train_{d}"] = want_steps(steps_per_dtype)
        want[f"bench_caffenet_eval_{d}"] = want_steps(0, forwards_per_dtype)
    want["bench_feed_compute"] = want_steps(2 + cfg.feed_iters)
    want["bench_feed_loop"] = want_steps(2 + cfg.feed_iters)
    # the records tier decodes each Datum on the card, one ycc_to_rgb and
    # one resize a decode: the feed's first record (its geometry), its
    # warm-up and timed batches, and the conversion
    rec = line["feed_records"]
    decodes = 1 + (2 + max(1, cfg.records_epochs * cfg.records_n
                           // cfg.records_batch)) * cfg.records_batch \
        + cfg.records_n
    want["bench_feed_records"] = {**want_steps(0), "ycc_to_rgb": decodes,
                                  "resize_bilinear": decodes}
    if not rec["images_per_sec"] > rec["serial_img_s"] > 0 or \
            rec["cache"]["misses"] < 1:
        fail(f"bench feed_records tier: {rec}")
    ro = line["round_overhead"]
    for leg in ("bare", "sync", "async"):
        if ro[leg]["guard_trips"] or ro[leg]["rounds"] != 1 + cfg.round_n:
            fail(f"bench round tier {leg}: {ro[leg]}")
        want[f"bench_round_{leg}"] = want_steps(
            (1 + cfg.round_n) * cfg.round_tau)
    want["bench_serving"] = want_steps(0, line["serving"]["device_forwards"])
    if launches != want:
        fail(f"bench launches {launches} != {want}")
    # the line: MFU, the FLOP count, correctness of the tiers
    conv1 = 2 * cfg.batch * 96 * 55 * 55 * 3 * 11 * 11
    from sparknet_tpu_torch.graph.net import Net
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.proto import NetState, Phase
    fwd = Net(caffenet(cfg.batch, cfg.batch),
              NetState(Phase.TRAIN)).forward_flops()
    for d, r in line["by_dtype"].items():
        if not (r["mfu"] is not None and 0 < r["mfu"] <= 1):
            fail(f"bench {d}: mfu {r['mfu']} outside (0, 1]")
        if r["flops_per_step"] != 3 * fwd - conv1:
            fail(f"bench {d}: flops_per_step {r['flops_per_step']} != "
                 f"3 x {fwd} - {conv1}")
    sv = line["serving"]
    if not sv["verdicts"]["bit_identical"] or \
            [p["fraction_of_saturation"] for p in sv["sweep"] or []] != \
            [0.5, 1.0] or sv["overload"] is None or any(
                p["exact_mismatches"] != 0
                for p in sv["sweep"] + [sv["overload"]]):
        fail(f"bench serving: verdicts {sv['verdicts']}, sweep "
             f"{sv['sweep']}, overload {sv['overload']}")
    if line["feed_in_loop"]["staged_dtype"] != "uint8":
        fail(f"bench feed tier: {line['feed_in_loop']}")
    # timing: every window the bench timed against the CUDA events
    # inside it, and each dtype's block against the events' median
    timing = {}
    for d in cfg.dtypes:
        for phase in (f"bench_caffenet_train_{d}",
                      f"bench_caffenet_eval_{d}"):
            for host, event in windows[phase]:
                if not block_time_ok(host, event):
                    fail(f"{phase}: host window {host:.4f} s against "
                         f"{event:.4f} s under CUDA events")
        train = windows[f"bench_caffenet_train_{d}"]
        event_block = float(np.median([e for _, e in train])) / reps
        bench_s = line["by_dtype"][d]["block_20x256_s"] * it / 20
        timing[d] = {"bench_block_s": bench_s, "event_block_s": event_block,
                     "windows_host_event_s": train}
        if len(train) != win or \
                abs(bench_s - event_block) > BENCH_TIME_TOL * event_block:
            fail(f"bench {d}: block {bench_s:.4f} s, {event_block:.4f} s "
                 f"under CUDA events ({train})")
    # planted: a window of the same block with no synchronize at its end
    solver = bench_solver(dev, cfg, "f32")
    host_ns, event_ns = event_timed_blocks(bench_mod, solver, 1, it,
                                           lambda: None)
    del solver
    torch.cuda.empty_cache()
    timing["planted_no_sync_f32"] = {"host_s": host_ns, "event_s": event_ns}
    if block_time_ok(host_ns, event_ns):
        fail(f"bench: a window without synchronize passed ({host_ns:.4f} "
             f"s host, {event_ns:.4f} s device)")
    f32_ms = line["by_dtype"]["f32"]["block_20x256_s"] / 20 * 1e3
    if abs(f32_ms - solver_ms_b256) > SOLVER_TIME_TOL * solver_ms_b256:
        fail(f"bench f32 {f32_ms:.2f} ms an iteration against phase 5b's "
             f"Solver {solver_ms_b256:.2f} ms")
    print(f"bench_timing [{smi}] " + json.dumps(
        {**timing, "f32_ms_per_iter": f32_ms,
         "solver_5b_ms_per_iter": solver_ms_b256}), flush=True)
    return {"line": line, "launches": launches, "timing": timing}


def bench_cli(smi: str) -> dict:
    """``python -m sparknet_tpu_torch.bench`` as a child at a short
    configuration: one JSON line on stdout, the JAX line's keys."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env.update(BENCH_CLI_ENV)
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "sparknet_tpu_torch.bench"],
                       cwd=here, env=env, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    lines = p.stdout.splitlines()
    if p.returncode != 0 or len(lines) != 1:
        fail(f"bench CLI: rc {p.returncode}, {len(lines)} stdout lines: "
             f"{p.stdout[-2000:]} {p.stderr[-3000:]}")
    line = json.loads(lines[0])
    with open(os.path.join(here, "BENCH_r05.json")) as f:
        parsed = set(json.load(f)["parsed"])
    keys = set(line)
    if not parsed <= keys or not keys - parsed <= BENCH_LINE_EXTRA \
            or not {"feed_records", "shard_round"} <= keys:
        fail(f"bench CLI keys: missing {sorted(parsed - keys)}, extra "
             f"{sorted(keys - parsed - BENCH_LINE_EXTRA)}")
    if "skipped" not in line["shard_round"] or \
            set(line["feed_records"]) != FEED_RECORDS_KEYS:
        fail(f"bench CLI: shard_round {line['shard_round']}, feed_records "
             f"{line['feed_records']}")
    if not line["device"].endswith(torch.cuda.get_device_name(0)):
        fail(f"bench CLI device {line['device']}")
    print(f"bench_cli [{smi}] {wall:.1f} s, keys {sorted(keys)}",
          flush=True)
    return {"wall_s": wall, "keys": sorted(keys)}


class DroppedEvents:
    """A profile that lost the device activity whose name matches
    ``pattern`` (the planted lost kernel): its device events, and its
    entries in the host ops' ``kernels``."""

    def __init__(self, prof, pattern: str):
        import copy
        self._events = []
        for e in prof.events():
            if str(e.device_type).endswith("CPU"):
                e = copy.copy(e)
                e.kernels = [k for k in e.kernels
                             if not re.search(pattern, k.name)]
            elif re.search(pattern, e.name):
                continue
            self._events.append(e)

    def events(self):
        return self._events


def profile_faults(tables: dict, launched: dict, event_step_ms: float,
                   iters: int) -> list[str]:
    """What is wrong with a profile of ``iters`` train steps: a hand
    kernel whose events do not count its launches, a layer of the five
    without forward or backward time, an unattributed share of 5% or
    more, a device total more than 15% from the CUDA-event step time."""
    from sparknet_tpu_torch.utils.trace_tables import UNATTRIBUTED
    bad = []
    for k, pat in PROFILE_KERNELS.items():
        n = sum(r["count"] for r in tables["by_op"]
                if re.search(pat, r["op"]))
        if n != launched[k]:
            bad.append(f"{k}: {n} kernel events, {launched[k]} launches")
    # a fused chain's row (a+b+...) stands for each of its layers
    rows = {m: r for r in tables["by_layer"] for m in r["op"].split("+")}
    for name in PROFILE_LAYERS:
        r = rows.get(name)
        if r is None or r["total_ms"] <= r["backward_ms"] or \
                r["backward_ms"] <= 0:
            bad.append(f"layer {name}: {r}")
    un = rows.get(UNATTRIBUTED, {"total_ms": 0.0})["total_ms"]
    if un >= 0.05 * tables["total_ms"]:
        bad.append(f"unattributed {un} ms of {tables['total_ms']}")
    step_ms = tables["total_ms"] / iters
    if abs(step_ms - event_step_ms) > PROFILE_TIME_TOL * event_step_ms:
        bad.append(f"device {step_ms:.3f} ms a step, {event_step_ms:.3f} "
                   f"ms under CUDA events")
    return bad


def profile_caffenet(ck, dev, smi: str, event_step_ms: float) -> dict:
    """``tools/profile_step`` on CaffeNet b256 f32: warm-up block, one
    profiled block of 10 steps, the op tables checked (and a planted
    lost kernel rejected)."""
    import tempfile
    from sparknet_tpu_torch.tools import profile_step
    from sparknet_tpu_torch.utils import trace_tables
    iters = 10
    ck.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="profile_step_") as d:
        summary, tables, prof = profile_step.profile(
            "caffenet", 256, iters, "f32", d, device=str(dev), top=None)
        launches = launched(ck)
        if launches != want_steps(2 * iters):
            fail(f"profile_step launches {launches}")
        profiled = want_steps(iters)
        bad = profile_faults(tables, profiled, event_step_ms, iters)
        if bad:
            print(trace_tables.format_tables(
                {**tables, "by_op": tables["by_op"][:25]}), flush=True)
            fail("profile_step: " + "; ".join(bad))
        planted = trace_tables.op_tables(
            DroppedEvents(prof, PROFILE_KERNELS["lrn_across_channels_bwd"]),
            top=None)
        if not profile_faults(planted, profiled, event_step_ms, iters):
            fail("profile_step: a profile without the LRN backward's "
                 "kernels passed")
    rows = {m: r for r in tables["by_layer"] for m in r["op"].split("+")}
    print(f"profile_step [{smi}] " + json.dumps({
        "summary": summary, "total_ms": tables["total_ms"],
        "by_layer": tables["by_layer"][:12],
        "hand_kernels": [r for r in tables["by_op"] if any(
            re.search(p, r["op"]) for p in PROFILE_KERNELS.values())]}),
        flush=True)
    return {"launches": launches, "summary": summary,
            "layers": {k: rows[k] for k in PROFILE_LAYERS}}


def sync_count(prof) -> int:
    """Host waits and device-to-host copies in a profile."""
    return sum(1 for e in prof.events()
               if e.name in SYNC_EVENTS or e.name.startswith("Memcpy DtoH"))


def round_syncs(dev, rounds: list, plane_on: bool, d: str,
                publish_extra=None) -> int:
    """Syncs in one profiled steady round of the 5e trainer with the
    plane on (tracing) or off; ``publish_extra`` plants work in the
    trainer's per-round publishing."""
    from sparknet_tpu_torch.parallel import DistributedTrainer
    from sparknet_tpu_torch.utils import telemetry
    env = {"SPARKNET_TELEMETRY": "1" if plane_on else "0",
           "SPARKNET_TRACE_DIR": d}
    with mock.patch.dict(os.environ, env):
        if not plane_on:
            os.environ.pop("SPARKNET_TRACE_DIR")
        telemetry.reset()
        tr = round_trainer(dev)
        tr.train_round(rounds[0])
        torch.cuda.synchronize()
        publish = DistributedTrainer._publish_round

        def planted(self):
            publish(self)
            publish_extra(self)

        with (mock.patch.object(DistributedTrainer, "_publish_round",
                                planted) if publish_extra
              else contextlib.nullcontext()):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                tr.train_round(rounds[1])
                torch.cuda.synchronize()
        telemetry.reset()
    return sync_count(prof)


def telemetry_on_card(ck, dev, smi: str) -> dict:
    """Two 2-round CaffeNet runs through ``imagenet_app`` (2 x 64, τ=5,
    the crop on the card, deterministic cuDNN), the plane on with a trace
    directory and off: spans and ``trainer_rounds_total`` count the
    rounds, the final params are equal bit for bit; the plane adds no
    host wait or device-to-host copy to a round (a planted ``.item()``
    in the per-round publishing is caught)."""
    import glob
    import tempfile
    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.utils import telemetry
    argv = imagenet_argv("caffenet", dev, batch=TRAIN_BATCH, tau=TRAIN_TAU,
                         rounds=TELEMETRY_ROUNDS,
                         extra=["--device-preprocess"])
    steps = TRAIN_WORKERS * TRAIN_TAU * TELEMETRY_ROUNDS
    want = want_steps(steps, eval_batches(TRAIN_WORKERS, TRAIN_BATCH))
    out, params, launches = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="telemetry_") as d:
        for on in (True, False):
            env = {"SPARKNET_TELEMETRY": "1" if on else "0",
                   "SPARKNET_TRACE_DIR": os.path.join(d, "trace")}
            with mock.patch.dict(os.environ, env):
                if not on:
                    os.environ.pop("SPARKNET_TRACE_DIR")
                telemetry.reset()
                ck.reset_launch_counts()
                with cudnn_deterministic():
                    run = imagenet_app.main(argv)
                label = f"telemetry_caffenet_{'on' if on else 'off'}"
                launches[label] = launched(ck)
                if launches[label] != want:
                    fail(f"{label}: launches {launches[label]} != {want}")
                params[on] = host_params(run.trainer)
                if on:
                    reg = telemetry.get_registry()
                    out["rounds_total"] = reg.counter(
                        "trainer_rounds_total").value()
                    telemetry.get_tracer().flush()
                    names = []
                    for path in glob.glob(os.path.join(d, "trace",
                                                       "trace_*.jsonl")):
                        with open(path) as f:
                            names += [json.loads(x)["name"] for x in f]
                    out["round_spans"] = names.count("trainer.round")
                    out["feed_spans"] = sum(n.startswith("feed.")
                                            for n in names)
                telemetry.reset()
            del run
        if out["rounds_total"] != TELEMETRY_ROUNDS or \
                out["round_spans"] != TELEMETRY_ROUNDS:
            fail(f"telemetry: {out} for {TELEMETRY_ROUNDS} rounds")
        diff = differing(params[True], params[False])
        if diff:
            fail(f"telemetry: params differ with the plane on and off: "
                 f"{diff[:5]}")
        rounds = [round_data(dev, r) for r in range(2)]
        with cudnn_deterministic():
            syncs = {"on": round_syncs(dev, rounds, True, d),
                     "off": round_syncs(dev, rounds, False, d),
                     "planted_item": round_syncs(
                         dev, rounds, True, d, publish_extra=lambda tr: float(
                             next(iter(tr.params.values()))[0].sum()))}
        del rounds
    if syncs["on"] != syncs["off"] or syncs["planted_item"] <= syncs["on"]:
        fail(f"telemetry: syncs in a round {syncs}")
    torch.cuda.empty_cache()
    out.update(syncs_per_round=syncs, launches=launches)
    print(f"telemetry [{smi}] " + json.dumps(out), flush=True)
    return out


def the_bench(ck, dev, smi: str, solver_ms_b256: float) -> dict:
    """Phase 5f."""
    t0 = time.perf_counter()
    rep = bench_in_process(ck, dev, smi, solver_ms_b256)
    torch.cuda.empty_cache()
    rep["cli"] = bench_cli(smi)
    event_step_ms = rep["timing"]["f32"]["event_block_s"] / 20 * 1e3
    rep["profile"] = profile_caffenet(ck, dev, smi, event_step_ms)
    torch.cuda.empty_cache()
    rep["telemetry"] = telemetry_on_card(ck, dev, smi)
    rep["launches"].update(
        {"profile_step_caffenet_f32": rep["profile"]["launches"],
         **rep["telemetry"]["launches"]})
    print(f"phase 5f: {time.perf_counter() - t0:.1f} s", flush=True)
    return rep


# ---------------------------------------------------------------------------
# Phase 5g: the rest of the graph compiler — shared params, the neuron and
# loss layers and Slice, on Caffe's mnist_siamese and mnist_autoencoder at
# their published widths through caffe_cli train
# ---------------------------------------------------------------------------

def _siamese_branch(s: str, bottom: str) -> str:
    def param(name, lr):
        return f'param {{ name: "{name}" lr_mult: {lr} }}'
    fillers = ('weight_filler { type: "xavier" } '
               'bias_filler { type: "constant" }')
    return f"""
layer {{ name: "conv1{s}" type: "Convolution" bottom: "{bottom}"
  top: "conv1{s}" {param("conv1_w", 1)} {param("conv1_b", 2)}
  convolution_param {{ num_output: 20 kernel_size: 5 stride: 1 {fillers} }} }}
layer {{ name: "pool1{s}" type: "Pooling" bottom: "conv1{s}" top: "pool1{s}"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "conv2{s}" type: "Convolution" bottom: "pool1{s}"
  top: "conv2{s}" {param("conv2_w", 1)} {param("conv2_b", 2)}
  convolution_param {{ num_output: 50 kernel_size: 5 stride: 1 {fillers} }} }}
layer {{ name: "pool2{s}" type: "Pooling" bottom: "conv2{s}" top: "pool2{s}"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "ip1{s}" type: "InnerProduct" bottom: "pool2{s}"
  top: "ip1{s}" {param("ip1_w", 1)} {param("ip1_b", 2)}
  inner_product_param {{ num_output: 500 {fillers} }} }}
layer {{ name: "relu1{s}" type: "ReLU" bottom: "ip1{s}" top: "ip1{s}" }}
layer {{ name: "ip2{s}" type: "InnerProduct" bottom: "ip1{s}" top: "ip2{s}"
  {param("ip2_w", 1)} {param("ip2_b", 2)}
  inner_product_param {{ num_output: 10 {fillers} }} }}
layer {{ name: "feat{s}" type: "InnerProduct" bottom: "ip2{s}"
  top: "feat{s}" {param("feat_w", 1)} {param("feat_b", 2)}
  inner_product_param {{ num_output: 2 {fillers} }} }}
"""


SIAMESE_BATCH, SIAMESE_TEST_BATCH = 64, 100
# Caffe's examples/siamese/mnist_siamese_train_test.prototxt (BVLC caffe,
# master) at its published widths: 2-channel pair Datums from a LevelDB,
# sliced into two branches sharing every blob by name, ContrastiveLoss
SIAMESE_NET = f"""
name: "mnist_siamese_train_test"
layer {{ name: "pair_data" type: "Data" top: "pair_data" top: "sim"
  include {{ phase: TRAIN }} transform_param {{ scale: 0.00390625 }}
  data_param {{ source: "TRAIN_DB" batch_size: {SIAMESE_BATCH} }} }}
layer {{ name: "pair_data" type: "Data" top: "pair_data" top: "sim"
  include {{ phase: TEST }} transform_param {{ scale: 0.00390625 }}
  data_param {{ source: "TEST_DB" batch_size: {SIAMESE_TEST_BATCH} }} }}
layer {{ name: "slice_pair" type: "Slice" bottom: "pair_data"
  top: "data" top: "data_p" slice_param {{ slice_dim: 1 slice_point: 1 }} }}
""" + _siamese_branch("", "data") + _siamese_branch("_p", "data_p") + """
layer { name: "loss" type: "ContrastiveLoss" bottom: "feat"
  bottom: "feat_p" bottom: "sim" top: "loss"
  contrastive_loss_param { margin: 1 } }
"""
SIAMESE_OWNERS = ("conv1", "conv2", "ip1", "ip2", "feat")
GRAPH_ITERS = 200          # the published solvers run 50,000 and 65,000
GRAPH_TEST_INTERVAL = 100  # published: 500
# examples/siamese/mnist_siamese_solver.prototxt, cut in iterations
SIAMESE_TEST_ITER = 100
SIAMESE_SOLVER = f"""
test_iter: {SIAMESE_TEST_ITER}
test_interval: {GRAPH_TEST_INTERVAL}
base_lr: 0.01
momentum: 0.9
weight_decay: 0.0000
lr_policy: "inv"
gamma: 0.0001
power: 0.75
display: 1
max_iter: {GRAPH_ITERS}
snapshot: {GRAPH_ITERS}
"""


def _ae_ip(name: str, bottom: str, width: int) -> str:
    return f"""
layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 1 decay_mult: 1 }} param {{ lr_mult: 1 decay_mult: 0 }}
  inner_product_param {{ num_output: {width}
    weight_filler {{ type: "gaussian" std: 1 sparse: 15 }}
    bias_filler {{ type: "constant" value: 0 }} }} }}""" + (
        "" if name in ("encode4", "decode1") else
        f'\nlayer {{ name: "{name}neuron" type: "Sigmoid" bottom: "{name}" '
        f'top: "{name}neuron" }}')


AE_BATCH = 100
_AE_DATA = "".join(f"""
layer {{ name: "data" type: "Data" top: "data" include {{ {rule} }}
  transform_param {{ scale: 0.0039215684 }}
  data_param {{ source: "{src}" batch_size: {AE_BATCH} backend: LMDB }} }}"""
    for rule, src in (("phase: TRAIN", "TRAIN_DB"),
                      ('phase: TEST stage: "test-on-train"', "TRAIN_DB"),
                      ('phase: TEST stage: "test-on-test"', "TEST_DB")))
# Caffe's examples/mnist/mnist_autoencoder.prototxt (BVLC caffe, master)
# at its published widths, 784-1000-500-250-30 and back, Sigmoid between
# layers, SigmoidCrossEntropyLoss and EuclideanLoss at loss_weight 0;
# the gaussian filler's sparse: 15 is read and not applied (ROADMAP C)
AUTOENCODER_NET = 'name: "MNISTAutoencoder"' + _AE_DATA + """
layer { name: "flatdata" type: "Flatten" bottom: "data" top: "flatdata" }
""" + "".join(_ae_ip(n, b, w) for n, b, w in (
    ("encode1", "data", 1000), ("encode2", "encode1neuron", 500),
    ("encode3", "encode2neuron", 250), ("encode4", "encode3neuron", 30),
    ("decode4", "encode4", 250), ("decode3", "decode4neuron", 500),
    ("decode2", "decode3neuron", 1000),
    ("decode1", "decode2neuron", 784))) + """
layer { name: "loss" type: "SigmoidCrossEntropyLoss" bottom: "decode1"
  bottom: "flatdata" top: "cross_entropy_loss" loss_weight: 1 }
layer { name: "decode1neuron" type: "Sigmoid" bottom: "decode1"
  top: "decode1neuron" }
layer { name: "loss" type: "EuclideanLoss" bottom: "decode1neuron"
  bottom: "flatdata" top: "l2_error" loss_weight: 0 }
"""
# examples/mnist/mnist_autoencoder_solver.prototxt, cut in iterations and
# test_iter (published 500 and 100)
AE_TEST_ITERS = (50, 10)
AUTOENCODER_SOLVER = f"""
test_state: {{ stage: "test-on-train" }}
test_iter: {AE_TEST_ITERS[0]}
test_state: {{ stage: "test-on-test" }}
test_iter: {AE_TEST_ITERS[1]}
test_interval: {GRAPH_TEST_INTERVAL}
base_lr: 0.01
lr_policy: "step"
gamma: 0.1
stepsize: 10000
display: 1
max_iter: {GRAPH_ITERS}
weight_decay: 0.0005
snapshot: {GRAPH_ITERS}
momentum: 0.9
"""
PAIRS_TRAIN, PAIRS_TEST = 6400, 1000
DIGITS_TRAIN, DIGITS_TEST = 5000, 1000
CARD_VS_CPU_ITERS = 5


def synthetic_digits(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` 28x28 uint8 digits and their classes: one smooth template a
    class drawn from ``seed`` (7x7 blocks of 4x4 pixels), plus noise.
    Real MNIST is not in the repository."""
    rng = np.random.default_rng(seed)
    templates = np.kron(rng.uniform(0.0, 1.0, size=(10, 7, 7)),
                        np.ones((4, 4)))
    labels = rng.integers(0, 10, size=n)
    x = 200.0 * templates[labels] + rng.normal(0.0, 25.0, size=(n, 28, 28))
    return np.clip(x, 0, 255).astype(np.uint8), labels


def write_pair_leveldb(path: str, n: int, seed: int) -> None:
    """A LevelDB of ``n`` 2x28x28 pair Datums, about half of them one
    class, label 1 for a same-class pair (the layout of
    examples/siamese/convert_mnist_siamese_data.cpp)."""
    from sparknet_tpu_torch.data.db import array_to_datum
    from sparknet_tpu_torch.data.leveldb_io import write_leveldb
    imgs, labels = synthetic_digits(2 * n, seed)
    rng = np.random.default_rng(seed + 1)
    items = []
    for i in range(n):
        pool = np.flatnonzero((labels == labels[i]) == (rng.random() < 0.5))
        pool = pool[pool != i]
        if not len(pool):
            pool = np.flatnonzero(labels != labels[i])
        j = int(rng.choice(pool))
        items.append((b"%08d" % i, array_to_datum(
            np.stack([imgs[i], imgs[j]]), int(labels[i] == labels[j]))))
    write_leveldb(path, items)


def write_digit_lmdb(path: str, n: int, seed: int) -> None:
    from sparknet_tpu_torch.data.db import array_to_datum
    from sparknet_tpu_torch.data.lmdb_io import write_lmdb
    imgs, labels = synthetic_digits(n, seed)
    write_lmdb(path, [(b"%08d" % i, array_to_datum(imgs[i][None],
                                                   int(labels[i])))
                      for i in range(n)])


# (label, type, bottoms, indices of the bottoms to differentiate, params,
# sub-messages): every layer type of the slice at a small shape
def _layer_cases() -> list:
    g = np.random.default_rng(SEED + 40)
    x = g.normal(size=(4, 3, 5, 6)).astype(np.float32)
    pos = np.abs(x) + 0.5
    z = g.normal(size=(6, 5))
    probs = (np.exp(z) / np.exp(z).sum(1, keepdims=True)).astype(np.float32)
    probs[1, 3] = 0.0                      # a clamped log at the label
    labels = np.array([0, 3, 1, 4, 2, 3], np.float32)
    feats = g.normal(size=(2, 6, 2)).astype(np.float32)
    # pairs inside the margin, where the legacy form differs, and d = 0
    # on a dissimilar pair
    feats[1] = feats[0] + 0.3 * g.normal(size=(6, 2)).astype(np.float32)
    feats[1, 1] = feats[0, 1]
    sim = np.array([1, 0, 1, 0, 0, 1], np.float32)
    return [
        ("AbsVal", "AbsVal", [x], [0], [], {}),
        ("BNLL", "BNLL", [3 * x], [0], [], {}),
        ("Exp", "Exp", [x], [0], [], {"exp_param": {"base": 2.0,
                                                     "scale": 0.5}}),
        ("Log", "Log", [pos], [0], [], {"log_param": {"shift": 1.0}}),
        ("Power", "Power", [x], [0], [], {"power_param": {
            "power": 2.0, "scale": 3.0, "shift": 1.0}}),
        ("PReLU", "PReLU", [x], [0],
         [g.uniform(0, 0.5, size=3).astype(np.float32)], {}),
        ("Sigmoid", "Sigmoid", [3 * x], [0], [], {}),
        ("TanH", "TanH", [2 * x], [0], [], {}),
        ("Threshold", "Threshold", [x], [], [], {
            "threshold_param": {"threshold": 0.3}}),
        ("Slice", "Slice", [x], [0], [], {"slice_param": {
            "slice_point": [1, 2]}}),
        ("MultinomialLogisticLoss", "MultinomialLogisticLoss",
         [probs, labels], [0], [], {}),
        ("EuclideanLoss", "EuclideanLoss", [x, 2 * x + 1], [0, 1], [], {}),
        ("SigmoidCrossEntropyLoss", "SigmoidCrossEntropyLoss",
         [4 * z.astype(np.float32), g.uniform(size=(6, 5)).astype(
             np.float32)], [0, 1], [], {}),
        ("HingeLoss", "HingeLoss", [z.astype(np.float32), labels], [0], [],
         {"hinge_loss_param": {"norm": "L2"}}),
        ("InfogainLoss", "InfogainLoss",
         [probs, labels, g.uniform(0, 2, size=(5, 5)).astype(np.float32)],
         [0, 2], [], {}),
        ("ContrastiveLoss", "ContrastiveLoss", [feats[0], feats[1], sim],
         [0, 1], [], {"contrastive_loss_param": {"margin": 1.0}}),
        ("Accuracy_per_class", "Accuracy", [z.astype(np.float32), labels],
         [], [], {}),
    ]


def run_layer(dev, dtype, type_, bottoms, wrt, params, sub) -> list:
    """One layer's tops and the gradients of the ``wrt`` bottoms and the
    params under a fixed cotangent, on ``dev`` in ``dtype``, as f64 on
    the host."""
    from sparknet_tpu_torch.models.dsl import layer
    from sparknet_tpu_torch.ops import get_layer_impl
    ntop = 3 if type_ == "Slice" else 2 if type_ == "Accuracy" else 1
    lp = layer("l", type_, [f"b{i}" for i in range(len(bottoms))],
               [f"t{i}" for i in range(ntop)], **sub)
    label_at = {"MultinomialLogisticLoss": 1, "HingeLoss": 1,
                "InfogainLoss": 1, "ContrastiveLoss": 2,
                "Accuracy": 1}.get(type_)
    xs = [torch.from_numpy(b).to(dev, torch.float32 if i == label_at
                                 else dtype)
          for i, b in enumerate(bottoms)]
    for i in wrt:
        xs[i].requires_grad_()
    ps = [torch.from_numpy(p).to(dev, dtype).requires_grad_() for p in params]
    tops = get_layer_impl(type_).apply(lp, ps, xs, True)
    leaves = [xs[i] for i in wrt] + ps
    live = [t for t in tops if t.requires_grad]
    grads = []
    if live and leaves:
        gen = torch.Generator().manual_seed(SEED + 41)
        cots = [torch.randn(t.shape, generator=gen).to(dev, t.dtype)
                for t in live]
        grads = list(torch.autograd.grad(live, leaves, cots))
    return [t.detach().double().cpu() for t in list(tops) + grads]


def check_layers_on_card(dev) -> dict:
    """Every layer type of the slice, forward and the gradients of its
    float bottoms and params, on the card against the CPU in f32 and
    bf16: each tensor within tol·max|CPU| + tol (f32 1e-5, bf16 2e-2, the
    bounds the CPU tests hold the port to against the JAX package).
    Planted fault: ContrastiveLoss on the card with ``legacy_version``
    flipped must fall outside."""
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    worst = {}
    cases = _layer_cases()
    for dtype, tol in tols.items():
        for label, type_, bottoms, wrt, params, sub in cases:
            want = run_layer("cpu", dtype, type_, bottoms, wrt, params, sub)
            got = run_layer(dev, dtype, type_, bottoms, wrt, params, sub)
            errs = [float((a - b).abs().max() / (tol * b.abs().max() + tol))
                    for a, b in zip(got, want)]
            if len(got) != len(want) or max(errs) > 1.0:
                fail(f"layer {label} {dtype}: the card differs from the "
                     f"CPU by {max(errs):.3g} of its tolerance")
            worst[f"{label} {str(dtype).split('.')[-1]}"] = max(errs)
    label, type_, bottoms, wrt, params, sub = cases[-2]
    want = run_layer("cpu", torch.float32, type_, bottoms, wrt, params, sub)
    planted = run_layer(dev, torch.float32, type_, bottoms, wrt, params,
                        {"contrastive_loss_param": {
                            "margin": 1.0, "legacy_version": True}})
    planted_err = max(float((a - b).abs().max() / (1e-5 * b.abs().max()
                                                    + 1e-5))
                      for a, b in zip(planted, want))
    if planted_err <= 1.0:
        fail("layers: the planted legacy ContrastiveLoss passes the check")
    out = {"worst_over_tolerance": max(worst.values()), "cases": worst,
           "planted_contrastive_legacy_over_tolerance": planted_err}
    print("graph_layers " + json.dumps(out), flush=True)
    return out


def sharer_clones():
    """A planted fault: every layer that shares a blob computes with a
    clone of its owner's, so no gradient of the sharer reaches the
    owner."""
    from sparknet_tpu_torch.graph.net import Net
    own = Net.node_params

    def cloned(self, params, node):
        blobs = own(self, params, node)
        return [b.detach().clone().requires_grad_(b.requires_grad)
                if i in node.shared_refs else b for i, b in enumerate(blobs)]
    return mock.patch.object(Net, "node_params", cloned)


def unaliased_sharers(net, params) -> list[str]:
    """The shared blobs whose tensor is not the owner's storage."""
    bad = []
    for node in net.nodes:
        blobs = net.node_params(params, node)
        for i, (owner, pos) in node.shared_refs.items():
            if (blobs[i].untyped_storage().data_ptr()
                    != params[owner][pos].untyped_storage().data_ptr()):
                bad.append(f"{node.lp.name}[{i}]")
    return bad


def cli_losses(log: str) -> tuple[dict, dict, list]:
    """The first logged loss and its glog second of each iteration, and
    the test outputs, from a caffe_cli train log."""
    loss_at, stamp = {}, {}
    for ln in log.splitlines():
        if "] Iteration " in ln and ", loss = " in ln:
            it = int(ln.split("Iteration ")[1].split(",")[0])
            if it not in loss_at:
                loss_at[it] = float(ln.rsplit("= ", 1)[1])
                stamp[it] = glog_seconds(ln)
    tests = [(ln.split("output: ")[1].split(" = ")[0],
              float(ln.rsplit("= ", 1)[1]))
             for ln in log.splitlines() if "output:" in ln and "Test net" in ln]
    return loss_at, stamp, tests


def train_graph_net(ck, dev, label: str, d: str, net_text: str,
                    solver_text: str, want_launches: dict, *,
                    iters: int = GRAPH_ITERS,
                    test_interval: int = GRAPH_TEST_INTERVAL) -> dict:
    """``caffe_cli.main(["train", ...])`` on the net, the Solver it builds
    recorded; exact launches; the loss over the last ten of ``iters``
    iterations under half that over the first ten; ms an
    iteration from the CLI's own log (iterations after a test pass left
    out)."""
    from sparknet_tpu_torch import solvers
    from sparknet_tpu_torch.tools import caffe_cli
    model = os.path.join(d, f"{label}.prototxt")
    with open(model, "w") as f:
        f.write(net_text)
    solver = os.path.join(d, f"{label}_solver.prototxt")
    prefix = os.path.join(d, label)
    with open(solver, "w") as f:
        f.write(f'net: "{model}"\nsnapshot_prefix: "{prefix}"\n'
                + solver_text)
    built = []

    class Recorded(solvers.Solver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    ck.reset_launch_counts()
    with mock.patch.object(solvers, "Solver", Recorded):
        log, train_s = run_cli(caffe_cli.main, ["train", "--solver", solver,
                                                "--device", str(dev)])
    launches = launched(ck)
    if launches != want_launches:
        fail(f"{label}: caffe_cli train launches {launches}, want "
             f"{want_launches}")
    loss_at, stamp, tests = cli_losses(log)
    if sorted(loss_at) != list(range(1, iters + 1)) or \
            "Optimization Done." not in log or not tests or not all(
                math.isfinite(v) for v in loss_at.values()):
        print(log[-4000:])
        fail(f"{label}: caffe_cli train's log lacks its iterations or "
             f"test outputs, or a loss is not finite")
    first = float(np.mean([loss_at[i] for i in range(1, 11)]))
    last = float(np.mean([loss_at[i] for i in range(iters - 9, iters + 1)]))
    if not last < 0.5 * first:
        fail(f"{label}: the training loss did not fall: {first} over the "
             f"first ten iterations, {last} over the last ten")
    after_test = {i + 1 for i in range(0, iters, test_interval)}
    steady = [(stamp[i] - stamp[i - 1]) * 1e3
              for i in range(3, iters + 1) if i not in after_test]
    snapshot = f"{prefix}_iter_{iters}.caffemodel"
    if len(built) != 1 or not os.path.exists(snapshot):
        fail(f"{label}: {len(built)} Solvers built, snapshot "
             f"{os.path.exists(snapshot)}")
    return {"solver": built[0], "model": model, "snapshot": snapshot,
            "tests": tests, "launches": launches, "train_s": train_s,
            "first_loss_10": first, "last_loss_10": last,
            "iter_ms_median": float(np.median(steady))}


def feed_batches(net_text: str, n: int) -> list[dict]:
    """The first ``n`` training batches of the net's Data layer, as the
    CPU's feed makes them."""
    from sparknet_tpu_torch.data.db import db_feed
    from sparknet_tpu_torch.proto import Phase, load_net_prototxt
    lp = load_net_prototxt(net_text).layer[0]
    feed = db_feed(lp, Phase.TRAIN)
    out = [{k: v.copy() for k, v in next(feed).items()} for _ in range(n)]
    feed.close()
    return out


def solver_run(sp, weights: str, batches: list, device, dtype) -> tuple:
    """Per-iteration losses and the final params (f64, host) of a Solver
    on ``device`` in ``dtype`` from the ``weights`` file."""
    from sparknet_tpu_torch.solvers import Solver
    s = Solver(sp, seed=SEED, device=device)
    s.load_weights(weights)
    s.params = {k: [b.to(dtype) for b in v] for k, v in s.params.items()}
    s.state = s.rule.init(s.params)
    s.set_train_data(iter({k: torch.from_numpy(v).to(device, dtype)
                           for k, v in b.items()} for b in batches))
    losses = [s.step(1) for _ in batches]
    return losses, host_f64(s.params)


def graph_against_cpu(dev, label: str, net_text: str, solver_text: str,
                      weights: str, planted) -> dict:
    """``CARD_VS_CPU_ITERS`` Solver iterations from one ``.caffemodel`` on
    the same batches on the card (deterministic cuDNN, TF32 off), on the
    CPU in f32 and in f64.  The bound, set before the first run on the
    card: every loss within 1e-4 relative of the CPU f32 run's, and per
    blob max|Δ|/max|ref| against the f64 run within 1e-3 or 10x the CPU
    f32 run's own error (``train_against_cpu``'s rule).  A CPU run under
    ``planted`` must break it."""
    from sparknet_tpu_torch.proto import (load_net_prototxt,
                                          load_solver_prototxt_with_net)
    sp = load_solver_prototxt_with_net(solver_text.replace(
        "display: 1", "display: 0"), load_net_prototxt(net_text))
    batches = feed_batches(net_text, CARD_VS_CPU_ITERS)
    with cudnn_deterministic():
        card_l, card = solver_run(sp, weights, batches, dev, torch.float32)
    cpu_l, cpu = solver_run(sp, weights, batches, "cpu", torch.float32)
    _, exact = solver_run(sp, weights, batches, "cpu", torch.float64)
    with planted:
        bad_l, bad = solver_run(sp, weights, batches, "cpu", torch.float32)
    cpu_err = rel_errors(cpu, exact)
    allowed = {b: max(1e-3, 10.0 * e) for b, e in cpu_err.items()}
    card_err = rel_errors(card, exact)
    bad_err = rel_errors(bad, exact)
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    out = {"losses_card": card_l, "losses_cpu": cpu_l,
           "loss_rel": rel(card_l, cpu_l), "planted_loss_rel": rel(bad_l,
                                                                   cpu_l),
           "card_vs_f64_max": max(card_err.values()),
           "cpu_f32_vs_f64_max": max(cpu_err.values()),
           "card_blobs_beyond_bound": [b for b, e in card_err.items()
                                       if e > allowed[b]],
           "planted_blobs_beyond_bound": sum(e > allowed[b]
                                             for b, e in bad_err.items())}
    print(f"{label} card vs CPU " + json.dumps(out), flush=True)
    if out["card_blobs_beyond_bound"] or out["loss_rel"] > 1e-4:
        fail(f"{label}: the card's iterations differ from the CPU's: {out}")
    if out["planted_loss_rel"] <= 1e-4 and not out[
            "planted_blobs_beyond_bound"]:
        fail(f"{label}: the planted fault passes the card-vs-CPU checks")
    return out


def loss_weight_ignored():
    """A planted fault for the autoencoder: every loss top weighted 1,
    its EuclideanLoss's explicit ``loss_weight: 0`` dropped."""
    from sparknet_tpu_torch.graph import net as net_mod
    return mock.patch.object(net_mod._LayerNode, "loss_weights",
                             lambda self: [1.0] if self.impl.is_loss()
                             else [0.0] * len(self.tops))


def graph_compiler_rest(ck, dev, smi: str) -> dict:
    """Phase 5g: the layers of the slice on the card against the CPU;
    mnist_siamese (shared params, Slice, ContrastiveLoss, the pool
    backward at 2x2 s2) and mnist_autoencoder (Sigmoid, the two losses,
    two test nets by ``test_state``) through ``caffe_cli train`` at
    their published widths on synthetic digits, with exact launches and
    planted faults; each net's iterations on the card against the CPU."""
    import tempfile

    from sparknet_tpu_torch.proto import load_caffemodel
    from sparknet_tpu_torch.tools import caffe_cli
    t_phase = time.perf_counter()
    report = {"layers": check_layers_on_card(dev)}
    idle = {k: 0 for k in ck.launch_counts if k not in RELU_FOLD_KEYS}
    with tempfile.TemporaryDirectory(prefix="graph_smoke_") as d:
        t0 = time.perf_counter()
        pairs = (os.path.join(d, "pairs_train_leveldb"),
                 os.path.join(d, "pairs_test_leveldb"))
        digits = (os.path.join(d, "digits_train_lmdb"),
                  os.path.join(d, "digits_test_lmdb"))
        write_pair_leveldb(pairs[0], PAIRS_TRAIN, SEED + 50)
        write_pair_leveldb(pairs[1], PAIRS_TEST, SEED + 51)
        write_digit_lmdb(digits[0], DIGITS_TRAIN, SEED + 52)
        write_digit_lmdb(digits[1], DIGITS_TEST, SEED + 53)
        report["fixture_s"] = time.perf_counter() - t0

        # mnist_siamese through caffe_cli train: 4 pool backwards an
        # iteration (pool1, pool2, pool1_p, pool2_p), none at test
        siamese_text = SIAMESE_NET.replace("TRAIN_DB", pairs[0]).replace(
            "TEST_DB", pairs[1])
        sm = train_graph_net(ck, dev, "mnist_siamese", d, siamese_text,
                             SIAMESE_SOLVER,
                             {**idle, "max_pool_bwd": 4 * GRAPH_ITERS})
        s = sm.pop("solver")
        net, params = s.train_net, s.params
        if sorted(params) != sorted(SIAMESE_OWNERS) or \
                unaliased_sharers(net, params) or \
                sum(len(n.shared_refs) for n in net.nodes) != 10:
            fail(f"mnist_siamese: the sharers do not hold their owners' "
                 f"storage: {unaliased_sharers(net, params)}")
        with sharer_clones():
            if not unaliased_sharers(net, params):
                fail("mnist_siamese: the planted sharer clones pass the "
                     "storage check")
        saved = load_caffemodel(sm["snapshot"])
        for o in SIAMESE_OWNERS:
            mine = [b.detach().cpu().numpy() for b in params[o]]
            if len(saved[o + "_p"]) != 2 or not all(
                    a.tobytes() == b.tobytes() == c.tobytes()
                    for a, b, c in zip(saved[o], saved[o + "_p"], mine)):
                fail(f"mnist_siamese: the .caffemodel's {o}_p blobs are "
                     f"not {o}'s")
        del s, net, params
        with cudnn_deterministic():
            tlog, _ = run_cli(caffe_cli.main, [
                "test", "--model", sm["model"], "--weights",
                sm["snapshot"], "--iterations", str(SIAMESE_TEST_ITER),
                "--device",
                str(dev)])
        scored = float(re.search(r"^loss = ([-\d.e+]+)$", tlog,
                                 re.M).group(1))
        last_test = sm["tests"][-1][1]
        sm["cli_test_loss"], sm["last_test_loss"] = scored, last_test
        sm["test_losses"] = [v for _, v in sm["tests"]]
        if abs(scored - last_test) > 1e-5 * abs(last_test) or not \
                sm["test_losses"][-1] < sm["test_losses"][0]:
            fail(f"mnist_siamese: caffe_cli test gives {scored}, the last "
                 f"test pass {last_test}; test losses {sm['test_losses']}")
        ck.reset_launch_counts()
        sm["card_vs_cpu"] = graph_against_cpu(
            dev, "mnist_siamese", siamese_text, SIAMESE_SOLVER,
            sm["snapshot"], sharer_clones())
        sm["card_vs_cpu_launches"] = launched(ck)
        if sm["card_vs_cpu_launches"] != {
                **idle, "max_pool_bwd": 4 * CARD_VS_CPU_ITERS}:
            fail(f"mnist_siamese card vs CPU: launches "
                 f"{sm['card_vs_cpu_launches']}")
        torch.cuda.empty_cache()

        # mnist_autoencoder through caffe_cli train with its two test
        # stages: no hand kernel on its path
        ae_text = AUTOENCODER_NET.replace("TRAIN_DB", digits[0]).replace(
            "TEST_DB", digits[1])
        ae = train_graph_net(ck, dev, "mnist_autoencoder", d, ae_text,
                             AUTOENCODER_SOLVER, idle)
        del ae["solver"]
        names = {k for k, _ in ae["tests"]}
        n_tests = len(range(0, GRAPH_ITERS + 1, GRAPH_TEST_INTERVAL))
        if names != {"cross_entropy_loss", "l2_error"} or \
                len(ae["tests"]) != 2 * 2 * n_tests:
            fail(f"mnist_autoencoder: test outputs {ae['tests']}")
        ae["card_vs_cpu"] = graph_against_cpu(
            dev, "mnist_autoencoder", ae_text, AUTOENCODER_SOLVER,
            ae["snapshot"], loss_weight_ignored())
        torch.cuda.empty_cache()
    report.update(siamese=sm, autoencoder=ae,
                  phase_s=time.perf_counter() - t_phase)
    print(f"graph_compiler [{smi}] " + json.dumps(report, default=str),
          flush=True)
    print(f"phase 5g: {report['phase_s']:.1f} s; ms an iteration: "
          f"mnist_siamese {sm['iter_ms_median']:.3f}, mnist_autoencoder "
          f"{ae['iter_ms_median']:.3f} [{smi}]", flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5h: the layer library's last types, BatchNorm's forward state, and
# Caffe's cifar10_full_sigmoid_bn through caffe_cli
# ---------------------------------------------------------------------------

class SmokePyEuclideanLoss:
    """A pycaffe-style layer (Caffe's examples/pycaffe/layers/pyloss.py),
    the top's diff applied: numpy on the host, whatever the device."""

    def setup(self, bottom, top):
        pass

    def reshape(self, bottom, top):
        self.diff = np.zeros_like(bottom[0].data, dtype=np.float32)
        top[0].reshape(1)

    def forward(self, bottom, top):
        self.diff[...] = bottom[0].data - bottom[1].data
        top[0].data[...] = np.sum(self.diff ** 2) / bottom[0].num / 2.0

    def backward(self, top, propagate_down, bottom):
        for i, sign in ((0, 1.0), (1, -1.0)):
            bottom[i].diff[...] = (sign * self.diff / bottom[i].num
                                   * top[0].diff[0])


class SmokeCube:
    """A functional Python layer: its forward in torch ops, on the card."""

    def out_shapes(self, bottom_shapes):
        return [tuple(bottom_shapes[0])]

    def forward(self, x):
        return x * x * x


def _slice_layer_cases() -> list:
    """(label, type, bottoms, indices of the bottoms to differentiate,
    blobs, sub-messages, tops, train) of every type of the slice and
    STOCHASTIC pooling at a small shape."""
    g = np.random.default_rng(SEED + 60)
    x, x2, x3 = (g.normal(size=(4, 3, 5, 6)).astype(np.float32)
                 for _ in range(3))
    pos = np.abs(g.normal(size=(4, 3, 9, 9))).astype(np.float32)
    pos13 = np.abs(g.normal(size=(4, 3, 13, 13))).astype(np.float32)
    ties = np.round(2.0 * g.normal(size=(4, 3, 5, 6))).astype(np.float32)
    c3 = g.uniform(0.5, 1.5, size=3).astype(np.float32)
    zero = [np.zeros(3, np.float32)] * 2 + [np.zeros(1, np.float32)]
    stats = [g.normal(size=3).astype(np.float32),
             g.uniform(1, 4, size=3).astype(np.float32),
             np.array([2.5], np.float32)]
    idx = np.array([[0, 6, 7], [-1, -9, 2.7], [-0.5, 100, 3]], np.float32)
    py = lambda layer: {"python_param": {"module": "smoke_absent_module",
                                         "layer": layer}}
    pool = lambda method: {"pooling_param": {"pool": method,
                                             "kernel_size": 3, "stride": 2}}
    return [
        ("ArgMax_ties", "ArgMax", [ties], [], [],
         {"argmax_param": {"top_k": 3}}, 1, True),
        ("ArgMax_values_axis", "ArgMax", [x], [0], [],
         {"argmax_param": {"top_k": 2, "axis": 1, "out_max_val": True}}, 1,
         True),
        ("BatchNorm_train", "BatchNorm", [2.0 + 3.0 * x], [0], zero, {}, 1,
         True),
        ("BatchNorm_global_stats", "BatchNorm", [x], [0], stats,
         {"batch_norm_param": {"use_global_stats": True}}, 1, True),
        ("BatchReindex", "BatchReindex",
         [x, np.array([2, 0, 0, 3, -1, 7], np.float32)], [0], [], {}, 1,
         True),
        ("Bias", "Bias", [x], [0], [c3], {}, 1, True),
        ("Deconvolution", "Deconvolution", [x], [0],
         [g.normal(size=(3, 2, 4, 4)).astype(np.float32),
          g.normal(size=2).astype(np.float32)],
         {"convolution_param": {"num_output": 2, "kernel_size": 4,
                                "stride": 2, "pad": 1}}, 1, True),
        ("Eltwise_sum", "Eltwise", [x, x2, x3], [0, 1, 2], [],
         {"eltwise_param": {"operation": "SUM",
                            "coeff": [1.0, -0.5, 2.0]}}, 1, True),
        ("Eltwise_prod", "Eltwise", [x, x2], [0, 1], [],
         {"eltwise_param": {"operation": "PROD"}}, 1, True),
        ("Eltwise_max", "Eltwise", [x, x2], [0, 1], [],
         {"eltwise_param": {"operation": "MAX"}}, 1, True),
        ("Embed", "Embed", [idx], [], [g.normal(size=(7, 4)).astype(
            np.float32), g.normal(size=4).astype(np.float32)],
         {"embed_param": {"num_output": 4, "input_dim": 7}}, 1, True),
        ("Filter", "Filter", [x, x2, np.array([1, 0, 1, 1], np.float32)],
         [0, 1], [], {}, 2, True),
        ("Im2col", "Im2col", [x], [0], [],
         {"convolution_param": {"num_output": 1, "kernel_size": 3,
                                "pad": 1}}, 1, True),
        ("MVN", "MVN", [3.0 + 2.0 * x], [0], [],
         {"mvn_param": {"across_channels": True}}, 1, True),
        ("Python_pycaffe", "Python", [x, x2], [0, 1], [],
         py("SmokePyEuclideanLoss"), 1, True),
        ("Python_functional", "Python", [x], [0], [], py("SmokeCube"), 1,
         True),
        ("Reduction", "Reduction", [x], [0], [],
         {"reduction_param": {"operation": "SUMSQ", "axis": 1,
                              "coeff": 0.5}}, 1, True),
        ("Reshape", "Reshape", [x], [0], [],
         {"reshape_param": {"shape": {"dim": [0, -1, 10]}}}, 1, True),
        ("SPP_MAX", "SPP", [pos13], [0], [],
         {"spp_param": {"pyramid_height": 3}}, 1, True),
        ("SPP_AVE", "SPP", [pos13], [0], [],
         {"spp_param": {"pyramid_height": 3, "pool": "AVE"}}, 1, True),
        ("Scale", "Scale", [x], [0], [c3, c3 - 1.0],
         {"scale_param": {"bias_term": True}}, 1, True),
        ("Silence", "Silence", [x], [], [], {}, 0, True),
        ("Tile", "Tile", [x], [0], [], {"tile_param": {"tiles": 3}}, 1,
         True),
        ("STOCHASTIC_train", "Pooling", [pos], [0], [], pool("STOCHASTIC"),
         1, True),
        ("STOCHASTIC_test", "Pooling", [pos], [0], [], pool("STOCHASTIC"),
         1, False),
    ]


INDEX_BOTTOMS = {("Embed", 0), ("BatchReindex", 1), ("Filter", 2)}


def run_slice_layer(dev, dtype, case) -> list:
    """One layer's tops, its updated blobs (BatchNorm) and the gradients
    of the differentiated bottoms and the blobs under a fixed cotangent,
    on ``dev`` in ``dtype`` (index bottoms and BatchNorm's blobs f32), as
    f64 on the host.  STOCHASTIC draws its uniform from a CPU generator
    seeded the same on either device, then uploads it."""
    from sparknet_tpu_torch.models.dsl import layer
    from sparknet_tpu_torch.ops import get_layer_impl
    from sparknet_tpu_torch.utils.device import full_f32
    label, type_, bottoms, wrt, params, sub, ntop, train = case
    lp = layer("l", type_, [f"b{i}" for i in range(len(bottoms))],
               [f"t{i}" for i in range(ntop)], **sub)
    impl = get_layer_impl(type_).per_net_copy()
    xs = [torch.from_numpy(b).to(dev, torch.float32
                                 if (type_, i) in INDEX_BOTTOMS else dtype)
          for i, b in enumerate(bottoms)]
    for i in wrt:
        xs[i].requires_grad_()
    pdt = torch.float32 if impl.has_state else dtype
    ps = [torch.from_numpy(p).to(dev, pdt).requires_grad_() for p in params]
    gen = torch.Generator().manual_seed(SEED + 61)
    with full_f32():
        out = impl.apply(lp, ps, xs, train, gen)
        tops, updated = out if impl.has_state else (out, [])
        leaves = [xs[i] for i in wrt] + ps
        live = [t for t in tops if t.requires_grad]
        grads = []
        if live and leaves:
            cg = torch.Generator().manual_seed(SEED + 62)
            cots = [torch.randn(t.shape, generator=cg).to(dev, t.dtype)
                    for t in live]
            grads = [torch.zeros_like(l) if g is None else g
                     for g, l in zip(torch.autograd.grad(
                         live, leaves, cots, allow_unused=True), leaves)]
    return [t.detach().double().cpu()
            for t in list(tops) + list(updated) + grads]


def bn_biased_variance():
    """A planted fault: BatchNorm storing the biased batch variance,
    without Caffe's m/(m−1) correction."""
    from sparknet_tpu_torch.ops.common import BatchNormLayer
    own = BatchNormLayer.apply

    def biased(self, lp, params, bottoms, train, gen=None):
        tops, updated = own(self, lp, params, bottoms, train, gen)
        if train and not lp.sub("batch_norm_param").get("use_global_stats"):
            x = bottoms[0]
            m = x.numel() // x.shape[1]
            maf = float(lp.sub("batch_norm_param").get(
                "moving_average_fraction", 0.999))
            updated[1] = (params[1] * maf
                          + (updated[1] - params[1] * maf) * (m - 1) / m)
        return tops, updated
    return mock.patch.object(BatchNormLayer, "apply", biased)


def argmax_last_on_ties():
    """A planted fault: ArgMax breaking a tie toward the higher index."""
    from sparknet_tpu_torch.ops.common import ArgMaxLayer

    def last_first(x, k):
        vals, idxs = torch.sort(x.flip(-1), dim=-1, descending=True,
                                stable=True)
        return vals[..., :k], x.shape[-1] - 1 - idxs[..., :k]
    return mock.patch.object(ArgMaxLayer, "top_k", staticmethod(last_first))


def slice_layers_on_card(dev) -> dict:
    """Every type of the slice and STOCHASTIC pooling, forward, updated
    blobs and gradients, on the card against the CPU in f32 and bf16 on
    deterministic cuDNN with TF32 off: each tensor within tol·max|CPU| +
    tol (f32 1e-5, bf16 2e-2, the CPU tests' bounds against the JAX
    package).  Planted: BatchNorm's biased variance and ArgMax's last-index
    tie-break on the card must fall outside."""
    from sparknet_tpu_torch.ops import register_python_layer
    register_python_layer("SmokePyEuclideanLoss", SmokePyEuclideanLoss)
    register_python_layer("SmokeCube", SmokeCube)
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    cases = _slice_layer_cases()

    def over(got, want, tol):
        if len(got) != len(want) or any(a.shape != b.shape
                                        for a, b in zip(got, want)):
            return math.inf
        return max([float((a - b).abs().max() / (tol * b.abs().max() + tol))
                    for a, b in zip(got, want) if b.numel()] or [0.0])

    worst = {}
    for dtype, tol in tols.items():
        for case in cases:
            want = run_slice_layer("cpu", dtype, case)
            with cudnn_deterministic():
                got = run_slice_layer(dev, dtype, case)
            err = over(got, want, tol)
            if err > 1.0:
                fail(f"layer {case[0]} {dtype}: the card differs from the "
                     f"CPU by {err:.3g} of its tolerance")
            worst[f"{case[0]} {str(dtype).split('.')[-1]}"] = err
    planted = {}
    for name, plant, label in (("bn_biased_variance", bn_biased_variance,
                                "BatchNorm_train"),
                               ("argmax_last_on_ties", argmax_last_on_ties,
                                "ArgMax_ties")):
        case = next(c for c in cases if c[0] == label)
        want = run_slice_layer("cpu", torch.float32, case)
        with plant(), cudnn_deterministic():
            got = run_slice_layer(dev, torch.float32, case)
        planted[name] = over(got, want, 1e-5)
        if planted[name] <= 1.0:
            fail(f"layers: the planted {name} passes the check")
    out = {"worst_over_tolerance": max(worst.values()), "cases": worst,
           "planted_over_tolerance": planted}
    print("slice_layers " + json.dumps(out), flush=True)
    return out


BN_BATCH = 100
BN_ITERS = 200           # the published solver runs 60,000
BN_TEST_INTERVAL = 100   # published: 1,000
BN_TEST_ITER = 10
BN_MULTI_ITERS = 50      # each --devices 2 run
BN_TRAIN, BN_TEST = 5000, 1000   # CIFAR-10: 50,000 and 10,000 images


def _bn_conv(name: str, bottom: str, width: int, std: str) -> str:
    return f"""
layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 1 }}
  convolution_param {{ num_output: {width} pad: 2 kernel_size: 5 stride: 1
    bias_term: false weight_filler {{ type: "gaussian" std: {std} }} }} }}"""


def _bn_layer(name: str, bottom: str) -> str:
    return f"""
layer {{ name: "{name}" type: "BatchNorm" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 0 }} param {{ lr_mult: 0 }} param {{ lr_mult: 0 }} }}"""


def _bn_one(name: str, type_: str, bottom: str, body: str = "") -> str:
    return (f'\nlayer {{ name: "{name}" type: "{type_}" bottom: "{bottom}" '
            f'top: "{name}" {body} }}')


def _bn_pool(name: str, bottom: str, method: str) -> str:
    return _bn_one(name, "Pooling", bottom, f"pooling_param {{ pool: "
                   f"{method} kernel_size: 3 stride: 2 }}")


# Caffe's examples/cifar10/cifar10_full_sigmoid_train_test_bn.prototxt
# (BVLC caffe, master) at its published widths: LMDB Data layers with
# the mean file, three convolutions without bias, each followed by a
# BatchNorm whose three blobs take no learning rate, Sigmoid, MAX then
# AVE pools, ip1
BN_NET = ('name: "CIFAR10_full"' + "".join(f"""
layer {{ name: "cifar" type: "Data" top: "data" top: "label"
  include {{ phase: {phase} }}
  transform_param {{ mean_file: "MEAN_FILE" }}
  data_param {{ source: "{db}" batch_size: {BN_BATCH} backend: LMDB }} }}"""
    for phase, db in (("TRAIN", "TRAIN_DB"), ("TEST", "TEST_DB")))
    + _bn_conv("conv1", "data", 32, "0.0001") + _bn_pool("pool1", "conv1",
                                                         "MAX")
    + _bn_layer("bn1", "pool1") + _bn_one("Sigmoid1", "Sigmoid", "bn1")
    + _bn_conv("conv2", "Sigmoid1", 32, "0.01") + _bn_layer("bn2", "conv2")
    + _bn_one("Sigmoid2", "Sigmoid", "bn2") + _bn_pool("pool2", "Sigmoid2",
                                                        "AVE")
    + _bn_conv("conv3", "pool2", 64, "0.01") + _bn_layer("bn3", "conv3")
    + _bn_one("Sigmoid3", "Sigmoid", "bn3") + _bn_pool("pool3", "Sigmoid3",
                                                        "AVE")
    + """
layer { name: "ip1" type: "InnerProduct" bottom: "pool3" top: "ip1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 1 decay_mult: 0 }
  inner_product_param { num_output: 10
    weight_filler { type: "gaussian" std: 0.01 }
    bias_filler { type: "constant" } } }
layer { name: "accuracy" type: "Accuracy" bottom: "ip1" bottom: "label"
  top: "accuracy" include { phase: TEST } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip1" bottom: "label"
  top: "loss" }
""")
BN_BLOBS = ("bn1", "bn2", "bn3")


def bn_solver(iters: int, test_interval: int) -> str:
    """examples/cifar10/cifar10_full_sigmoid_solver_bn.prototxt (its
    weight_decay line commented out there), cut in iterations, test
    interval and snapshot, with a display every iteration."""
    return f"""
test_iter: {BN_TEST_ITER}
test_interval: {test_interval}
base_lr: 0.001
momentum: 0.9
lr_policy: "step"
gamma: 1
stepsize: 5000
display: 1
max_iter: {iters}
snapshot: {iters}
"""


def write_cifar_lmdb(path: str, n: int, seed: int) -> None:
    """``n`` 3x32x32 uint8 Datums: one smooth colour template a class
    drawn from SEED + 70 (8x8 blocks of 4x4 pixels), plus noise drawn
    from ``seed``.  Real CIFAR-10 is not in the repository."""
    from sparknet_tpu_torch.data.db import array_to_datum
    from sparknet_tpu_torch.data.lmdb_io import write_lmdb
    templates = np.kron(np.random.default_rng(SEED + 70).uniform(
        0.0, 1.0, size=(10, 3, 8, 8)), np.ones((4, 4)))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    x = np.clip(40.0 + 160.0 * templates[labels]
                + rng.normal(0.0, 30.0, size=(n, 3, 32, 32)), 0, 255)
    x = x.astype(np.uint8)
    write_lmdb(path, [(b"%08d" % i, array_to_datum(x[i], int(labels[i])))
                      for i in range(n)])


def bn_state_dropped():
    """A planted fault: the forward's updated statistics never written
    back, so the running blobs stay at their init."""
    from sparknet_tpu_torch.graph.net import Net
    return mock.patch.object(Net, "_scatter_node_params",
                             lambda self, params, node, updated: None)


def train_bn_devices(ck, dev, label: str, d: str, model: str,
                     strategy: str, tau: int, want: dict) -> dict:
    """``caffe_cli train --devices 2 --strategy S --tau T`` on the net,
    the trainer it builds recorded: exact launches, ms an iteration from
    the log's round lines, the loss finite and falling.  Under ``sync``
    the first step's statistics must be the mean of what the two
    workers' forwards wrote, each forward from the same pre-step blobs;
    under ``local_sgd`` the last round's statistics the mean of the
    workers'."""
    from sparknet_tpu_torch import parallel
    from sparknet_tpu_torch.tools import caffe_cli
    solver = os.path.join(d, f"{label}_solver.prototxt")
    prefix = os.path.join(d, label)
    with open(solver, "w") as f:
        f.write(f'net: "{model}"\nsnapshot_prefix: "{prefix}"\n'
                + bn_solver(BN_MULTI_ITERS, BN_MULTI_ITERS))
    built = []

    class Recorded(parallel.DistributedTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)
            self.first_step = None

        def _psum_steps(self, starts, state, batches, workers, **kw):
            if self.first_step is not None:
                return super()._psum_steps(starts, state, batches, workers,
                                           **kw)
            wrote, accum = [], self._accum

            def spy(p, micro, gen):
                loss, after, grads = accum(p, micro, gen)
                wrote.append({k: [b.detach().clone() for b in after[k]]
                              for k in self._state_keys})
                return loss, after, grads
            self._accum = spy
            try:
                out = super()._psum_steps(starts, state, batches, workers,
                                          **kw)
            finally:
                self._accum = accum
            # the step's params: the first worker's (every worker's share
            # them on one copy)
            stepped = out[0][workers[0]]
            self.first_step = (wrote, {k: [b.detach().clone() for b in
                                           stepped[k]]
                                       for k in self._state_keys})
            return out

    ck.reset_launch_counts()
    with mock.patch.object(parallel, "DistributedTrainer", Recorded):
        log, train_s = run_cli(caffe_cli.main, [
            "train", "--solver", solver, "--devices", "2", "--strategy",
            strategy, "--tau", str(tau), "--device", str(dev)])
    launches = launched(ck)
    if launches != want:
        fail(f"{label}: caffe_cli train launches {launches}, want {want}")
    loss_at, stamp, tests = cli_losses(log)
    want_its = list(range(tau, BN_MULTI_ITERS + 1, tau))
    if sorted(loss_at) != want_its or not tests or \
            "Optimization Done." not in log or not all(
                math.isfinite(v) for v in loss_at.values()):
        print(log[-4000:])
        fail(f"{label}: caffe_cli train's log lacks its rounds or test "
             f"outputs, or a loss is not finite")
    if len(built) != 1 or sorted(built[0]._state_keys) != list(BN_BLOBS):
        fail(f"{label}: {len(built)} trainers, state keys "
             f"{built and built[0]._state_keys}")
    tr = built[0]
    check = {}
    if strategy == "sync":
        wrote, after = tr.first_step
        for k in BN_BLOBS:
            for i in range(3):
                mean = torch.stack([w[k][i] for w in wrote]).mean(0)
                if not torch.allclose(after[k][i], mean, rtol=1e-6,
                                      atol=1e-7):
                    fail(f"{label}: {k}[{i}] after the first step is not "
                         f"the mean of the workers' forwards")
            if not (len(wrote) == 2 and torch.equal(wrote[0][k][2],
                                                    wrote[1][k][2])
                    and not torch.equal(wrote[0][k][0], wrote[1][k][0])):
                fail(f"{label}: the workers' forwards did not start from "
                     f"the same statistics or saw the same batch")
        check["first_step_scale_factor"] = float(after["bn1"][2])
    else:
        for k in BN_BLOBS:
            for i in range(3):
                mean = torch.stack([w[k][i] for w in tr.worker_params]
                                   ).mean(0)
                if not torch.allclose(tr.params[k][i], mean, rtol=1e-6,
                                      atol=1e-7):
                    fail(f"{label}: {k}[{i}] is not the workers' mean")
    check["scale_factor"] = float(tr.params["bn1"][2])
    want_factor = sum(0.999 ** i for i in range(BN_MULTI_ITERS))
    if abs(check["scale_factor"] - want_factor) > 1e-4 * want_factor:
        fail(f"{label}: bn1's scale factor {check['scale_factor']}, want "
             f"{want_factor}")
    its = sorted(loss_at)
    steady = [(stamp[b] - stamp[a]) * 1e3 / (b - a)
              for a, b in zip(its[1:], its[2:])]
    del built[:], tr
    return {"launches": launches, "train_s": train_s, "tests": tests,
            "losses": [loss_at[i] for i in its], **check,
            "iter_ms_median": float(np.median(steady)),
            "snapshot_exists": os.path.exists(
                f"{prefix}_iter_{BN_MULTI_ITERS}.npz")}


def batchnorm_slice(ck, dev, smi: str) -> dict:
    """Phase 5h: every type of the slice and STOCHASTIC pooling on the
    card against the CPU; Caffe's cifar10_full_sigmoid_bn at its
    published widths from an LMDB of synthetic 32x32 images through
    ``caffe_cli train`` (one device; ``--devices 2`` under ``sync`` and
    under ``local_sgd --tau 5``), with exact launches (the pool backward
    once a worker step, no LRN kernel), the snapshot scored by
    ``caffe_cli test``, and 5 iterations on the card against the CPU."""
    import tempfile

    from sparknet_tpu_torch.proto import load_caffemodel
    from sparknet_tpu_torch.tools import caffe_cli, compute_image_mean
    t_phase = time.perf_counter()
    report = {"layers": slice_layers_on_card(dev)}
    idle = {k: 0 for k in ck.launch_counts if k not in RELU_FOLD_KEYS}
    with tempfile.TemporaryDirectory(prefix="bn_smoke_") as d:
        t0 = time.perf_counter()
        dbs = (os.path.join(d, "cifar_train_lmdb"),
               os.path.join(d, "cifar_test_lmdb"))
        write_cifar_lmdb(dbs[0], BN_TRAIN, SEED + 71)
        write_cifar_lmdb(dbs[1], BN_TEST, SEED + 72)
        mean_file = os.path.join(d, "mean.binaryproto")
        run_cli(compute_image_mean.main, [dbs[0], mean_file])
        report["fixture_s"] = time.perf_counter() - t0
        text = BN_NET.replace("TRAIN_DB", dbs[0]).replace(
            "TEST_DB", dbs[1]).replace("MEAN_FILE", mean_file)

        # one device: the pool backward once an iteration, none at test
        one = train_graph_net(ck, dev, "cifar10_full_sigmoid_bn", d, text,
                              bn_solver(BN_ITERS, BN_TEST_INTERVAL),
                              {**idle, "max_pool_bwd": BN_ITERS},
                              iters=BN_ITERS,
                              test_interval=BN_TEST_INTERVAL)
        s = one.pop("solver")
        saved = load_caffemodel(one["snapshot"])
        for k in BN_BLOBS:
            mine = [b.detach().cpu().numpy() for b in s.params[k]]
            if len(saved[k]) != 3 or not all(
                    a.tobytes() == b.tobytes()
                    for a, b in zip(saved[k], mine)) or \
                    abs(float(mine[2][0]) - sum(0.999 ** i for i in range(
                        BN_ITERS))) > 1e-3:
                fail(f"cifar10_full_sigmoid_bn: the .caffemodel's {k} "
                     f"blobs are not the Solver's running statistics")
        del s
        with cudnn_deterministic():
            tlog, _ = run_cli(caffe_cli.main, [
                "test", "--model", one["model"], "--weights",
                one["snapshot"], "--iterations", str(BN_TEST_ITER),
                "--device", str(dev)])
        scored = float(re.search(r"^loss = ([-\d.e+]+)$", tlog,
                                 re.M).group(1))
        test_losses = [v for k, v in one["tests"] if k == "loss"]
        accuracy = [v for k, v in one["tests"] if k == "accuracy"]
        one.update(cli_test_loss=scored, test_losses=test_losses,
                   test_accuracy=accuracy)
        if abs(scored - test_losses[-1]) > 1e-5 * abs(test_losses[-1]) or \
                not test_losses[-1] < test_losses[0]:
            fail(f"cifar10_full_sigmoid_bn: caffe_cli test gives {scored}, "
                 f"the last test pass {test_losses[-1]}; test losses "
                 f"{test_losses}")
        torch.cuda.empty_cache()

        # --devices 2: sync, each step's statistics re-averaged, and
        # SparkNet's local_sgd at τ=5; two pool backwards an iteration
        two = {**idle, "max_pool_bwd": 2 * BN_MULTI_ITERS}
        report["sync2"] = train_bn_devices(ck, dev, "bn_sync2", d,
                                           one["model"], "sync", 1, two)
        report["local_sgd2"] = train_bn_devices(
            ck, dev, "bn_local_sgd2", d, one["model"], "local_sgd", 5, two)
        torch.cuda.empty_cache()

        ck.reset_launch_counts()
        one["card_vs_cpu"] = graph_against_cpu(
            dev, "cifar10_full_sigmoid_bn", text,
            bn_solver(BN_ITERS, BN_TEST_INTERVAL), one["snapshot"],
            bn_state_dropped())
        one["card_vs_cpu_launches"] = launched(ck)
        if one["card_vs_cpu_launches"] != {
                **idle, "max_pool_bwd": CARD_VS_CPU_ITERS}:
            fail(f"cifar10_full_sigmoid_bn card vs CPU: launches "
                 f"{one['card_vs_cpu_launches']}")
        torch.cuda.empty_cache()
    report.update(single=one, phase_s=time.perf_counter() - t_phase)
    print(f"batchnorm_slice [{smi}] " + json.dumps(report, default=str),
          flush=True)
    print(f"phase 5h: {report['phase_s']:.1f} s; ms an iteration of "
          f"cifar10_full_sigmoid_bn (batch {BN_BATCH}): one device "
          f"{one['iter_ms_median']:.3f}, --devices 2 sync "
          f"{report['sync2']['iter_ms_median']:.3f}, local_sgd τ=5 "
          f"{report['local_sgd2']['iter_ms_median']:.3f} [{smi}]",
          flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5i: SparkNet's data tier — record shards through the convert tool,
# the verifying store and the tiered cache, CaffeNet trained from them
# through caffe_cli with HDF5 snapshots, the Spark bridge's partitions in
# a round, Caffe's hdf5_classification through HDF5Data
# ---------------------------------------------------------------------------

RECORD_SHARD_MB = 32        # 1,024 raw 256x256 Datums roll 6 shards
RECORD_BATCHES = 8          # two epochs of the 1,024 records at batch 256
RECORD_RAM_SHARDS = 2
RECORD_RESUME_AT, RECORD_RESUME_ITERS = 10, 5
RECORD_SOLVER = (DATA_PATH_SOLVER.replace("snapshot: 20",
                                          f"snapshot: {RECORD_RESUME_AT}")
                 + "snapshot_format: HDF5\n")
# phase 5c's solver cut to the first iterations, the LMDB's same-seed run
LMDB_ITERS = 5
BRIDGE_RECORDS, BRIDGE_TAU = 512, 2
BRIDGE_WANT = want_steps(ROUND_WORKERS * BRIDGE_TAU)
NO_KERNELS = want_steps(0)
# the binary .caffemodel of full-width CaffeNet as phase 5b first wrote
# and read it on an H100 80GB HBM3 at 700 W, printed beside the HDF5 pair
BINARY_EARLIER = {"mb": 243.86, "write_s": 0.869, "read_s": 0.085}
HDF5_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "sparknet_tpu_torch", "data", "hdf5_fixtures")
# Caffe's examples/hdf5_classification/nonlinear_train_val.prototxt, the
# sources pointed at the committed fixtures
HDF5_NET = """name: "LogisticRegressionNet"
layer { name: "data" type: "HDF5Data" top: "data" top: "label"
  include { phase: TRAIN }
  hdf5_data_param { source: "%(train)s" batch_size: 10 } }
layer { name: "data" type: "HDF5Data" top: "data" top: "label"
  include { phase: TEST }
  hdf5_data_param { source: "%(test)s" batch_size: 10 } }
layer { name: "fc1" type: "InnerProduct" bottom: "data" top: "fc1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 40
    weight_filler { type: "gaussian" std: 0.01 }
    bias_filler { type: "constant" value: 0 } } }
layer { name: "relu1" type: "ReLU" bottom: "fc1" top: "fc1" }
layer { name: "fc2" type: "InnerProduct" bottom: "fc1" top: "fc2"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  inner_product_param { num_output: 2
    weight_filler { type: "gaussian" std: 0.01 }
    bias_filler { type: "constant" value: 0 } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fc2" bottom: "label"
  top: "loss" }
layer { name: "accuracy" type: "Accuracy" bottom: "fc2" bottom: "label"
  top: "accuracy" include { phase: TEST } }
""" % {"train": os.path.join(HDF5_FIXTURES, "train.txt"),
       "test": os.path.join(HDF5_FIXTURES, "test.txt")}
# Caffe's nonlinear_solver.prototxt (10,000 iterations, a test every 1,000
# of 250 batches) cut to the 1,000 and 250 fixture rows: 200 iterations,
# a test every 100 over the 25 test batches
HDF5_ITERS = 200
HDF5_SOLVER = f"""
base_lr: 0.01
lr_policy: "step"
gamma: 0.1
stepsize: 5000
momentum: 0.9
weight_decay: 0.0005
display: 1
max_iter: {HDF5_ITERS}
test_iter: 25
test_interval: 100
snapshot: {HDF5_ITERS}
"""
HDF5_CARD_VS_CPU_REL = 1e-5


def records_of(path: str) -> list:
    """Every record of a shard directory, in order."""
    from sparknet_tpu_torch.data.records import ShardSet
    ss = ShardSet.open(path)
    out = [s.read(i) for s in ss.shards for i in range(s.count)]
    ss.close()
    return out


def convert_and_plant(d: str, fx: dict) -> dict:
    """(a) 5c's training LMDB through ``python -m
    sparknet_tpu_torch.tools.convert`` (``SPARKNET_RECORD_SHARD_MB=32``),
    its test LMDB through the tool's ``main``; every record equal to
    ``datum_to_array`` of its Datum; a flipped byte in a shard must raise
    ``DataCorruptionError`` naming the shard and the record, and under
    ``SPARKNET_QUARANTINE_RECORDS=1`` be admitted with the next record
    pulled in its place."""
    import shutil
    from sparknet_tpu_torch.data.db import datum_to_array, db_feed
    from sparknet_tpu_torch.data.integrity import DataCorruptionError
    from sparknet_tpu_torch.data.lmdb_io import LmdbReader
    from sparknet_tpu_torch.data.records import RecordShard, records_feed
    from sparknet_tpu_torch.proto import Phase, load_net_prototxt
    from sparknet_tpu_torch.tools import convert
    out = {"train": os.path.join(d, "train_shards"),
           "test": os.path.join(d, "test_shards")}
    env = dict(os.environ, SPARKNET_RECORD_SHARD_MB=str(RECORD_SHARD_MB))
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "sparknet_tpu_torch.tools."
                        "convert", "--source", fx["train_db"], "--out",
                        out["train"]], cwd=here, env=env,
                       capture_output=True, text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    if p.returncode != 0 or len(p.stdout.splitlines()) != 1:
        fail(f"data_tier: convert exited {p.returncode}: {p.stdout[-500:]} "
             f"{p.stderr[-2000:]}")
    line = json.loads(p.stdout)
    with open(os.devnull, "w") as devnull, \
            contextlib.redirect_stdout(devnull):
        convert.main(["--source", fx["test_db"], "--out", out["test"],
                      "--shard-mb", str(RECORD_SHARD_MB)])
    for split, db in (("train", fx["train_db"]), ("test", fx["test_db"])):
        recs = records_of(out[split])
        with LmdbReader(db) as r:
            items = list(r.items())
        if len(recs) != len(items) or any(
                img.tobytes() != datum_to_array(v)[0].astype(
                    np.uint8).tobytes() or label != datum_to_array(v)[1]
                for (img, label), (_, v) in zip(recs, items)):
            fail(f"data_tier: the {split} shards differ from the LMDB's "
                 f"records")
    if line["records"] != DB_TRAIN or line["quarantine"]["total_bad"]:
        fail(f"data_tier: convert line {line}")
    # planted: record 2 of the first shard rots
    planted = os.path.join(d, "planted_shards")
    os.makedirs(planted)
    first = line["shards"][0]
    shutil.copy(first, planted)
    path = os.path.join(planted, os.path.basename(first))
    shard = RecordShard.open(path)
    with open(path, "r+b") as f:
        f.seek(shard.offset(2) + 1000)
        byte = f.read(1)[0]
        f.seek(shard.offset(2) + 1000)
        f.write(bytes([byte ^ 0x10]))
    try:
        RecordShard.open(path).read(2)
        fail("data_tier: a flipped byte in a shard was read")
    except DataCorruptionError as e:
        if e.key != 2 or os.path.basename(first) not in str(e):
            fail(f"data_tier: the planted rot is misattributed: {e}")
        rot = str(e)[-160:]
    lp = load_net_prototxt(
        f'layer {{ name: "d" type: "Data" top: "data" top: "label" '
        f'data_param {{ source: "{planted}" batch_size: 4 backend: '
        f'RECORDS }} }}').layer[0]
    feed = db_feed(lp, Phase.TRAIN)
    try:
        next(feed)
        fail("data_tier: the planted rot went through a zero budget")
    except DataCorruptionError:
        pass
    finally:
        feed.close()
    os.environ["SPARKNET_QUARANTINE_RECORDS"] = "1"
    try:
        feed = records_feed(lp, Phase.TRAIN, raw=True)
        got = next(feed)
        feed.close()
    finally:
        del os.environ["SPARKNET_QUARANTINE_RECORDS"]
    want = [0, 1, 3, 4]                 # record 4 pulled in 2's place
    clean = RecordShard.open(first)
    if got["data"].tobytes() != np.stack(
            [clean.read(i)[0] for i in want]).tobytes():
        fail("data_tier: the quarantined record's replacement is not the "
             "next record")
    return {"dirs": out, "line": line, "convert_s": convert_s,
            "planted_rot": rot, "shards": len(line["shards"])}


def feeds_equal(d: str, text: str, shards: dict) -> dict:
    """(b) ``records_feed`` through a ``VerifyingStore`` and a
    ``ShardCache`` of 2 RAM shards with a spill directory against
    ``db_feed`` on the LMDB, the same seed, crop 227, mirror and mean:
    the first 8 batches of 256 (two epochs: cold, then the RAM and the
    spilled tiers) bit for bit, and each feed's host img/s."""
    from sparknet_tpu_torch.data.db import db_feed
    from sparknet_tpu_torch.data.pipeline import FeedStats, ShardCache
    from sparknet_tpu_torch.data.records import records_feed
    from sparknet_tpu_torch.proto import Phase, load_net_prototxt
    lp = load_net_prototxt(text).layer[0]
    rlp = load_net_prototxt(text.replace(
        lp.sub("data_param").get("source"), shards["train"])).layer[0]
    stats = FeedStats()
    cache = ShardCache(RECORD_RAM_SHARDS,
                       spill_dir=os.path.join(d, "spill"),
                       max_spill=len(os.listdir(shards["train"])))
    rates = {}
    batches = {}
    for name, make in (
            ("lmdb", lambda: db_feed(lp, Phase.TRAIN, seed=SEED)),
            ("records", lambda: records_feed(rlp, Phase.TRAIN, seed=SEED,
                                             verify=True, cache=cache,
                                             stats=stats))):
        feed = make()
        t0 = time.perf_counter()
        batches[name] = [next(feed)["data"].tobytes()
                         for _ in range(RECORD_BATCHES)]
        rates[name] = RECORD_BATCHES * SOLVER_TRAIN_BATCH / (
            time.perf_counter() - t0)
        feed.close()
    if batches["lmdb"] != batches["records"]:
        fail("data_tier: the records feed's batches differ from the LMDB "
             "feed's")
    tiers = cache.tier_counts()
    if not (tiers["disk_hits"] and tiers["misses"] and tiers["ram_hits"]):
        fail(f"data_tier: the cache's tiers were not all exercised: {tiers}")
    return {"lmdb_img_s": rates["lmdb"], "records_img_s": rates["records"],
            "cache": tiers, "stats": stats.snapshot()}


def records_train_val(text: str, shards: dict) -> str:
    """5c's train_val with its Data layers on the shards."""
    from sparknet_tpu_torch.proto import load_net_prototxt
    layers = [lp for lp in load_net_prototxt(text).layer
              if lp.type == "Data"]
    for lp, split in zip(layers, ("train", "test")):
        text = text.replace(str(lp.sub("data_param").get("source")),
                            shards[split])
    return text.replace("backend: LMDB", "backend: RECORDS")


def recorded_cli(argv: list[str], *, gens: dict | None = None,
                 resume_gen=None, skip_batches: int = 0) -> tuple:
    """``caffe_cli.main(argv)`` with the Solver it builds recorded (its
    Dropout generator's state kept at each snapshot in ``gens``, or set
    from ``resume_gen`` on restore: a ``.solverstate`` carries none, as
    Caffe's does not) and the training feed advanced by
    ``skip_batches`` (a resumed run starts its feed where the
    uninterrupted run's stood)."""
    from sparknet_tpu_torch import solvers
    from sparknet_tpu_torch.data import db
    from sparknet_tpu_torch.proto import Phase
    from sparknet_tpu_torch.tools import caffe_cli
    built = []

    class Recorded(solvers.Solver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

        def snapshot_caffe(self, prefix=None):
            if gens is not None:
                gens[self.iter] = self.generator.get_state()
            return super().snapshot_caffe(prefix)

        def restore_caffe(self, path):
            super().restore_caffe(path)
            if resume_gen is not None:
                self.generator.set_state(resume_gen)

    real = db.feed_for_net

    def skipping(net_param, phase, **kw):
        it = real(net_param, phase, **kw)
        if phase == Phase.TRAIN:
            for _ in range(skip_batches):
                next(it)
        return it

    with mock.patch.object(solvers, "Solver", Recorded), \
            mock.patch.object(db, "feed_for_net", skipping):
        log, wall = run_cli(caffe_cli.main, argv)
    return log, wall, built[0]


def loss_bits(solver, n: int) -> list[str]:
    """The first ``n`` per-iteration losses the Solver kept, as hex."""
    return [float(v).hex() for v in list(solver._smoothed)[:n]]


def train_from_records(ck, dev, d: str, text: str, shards: dict,
                       lmdb_text: str, data_path: dict) -> dict:
    """(c) and (d): full-width CaffeNet through ``caffe_cli train`` from
    the shards (5c's solver, snapshots to HDF5 at 10 and 20) with exact
    launches, its first 5 losses against a same-seed 5-iteration run
    from 5c's LMDB bit for bit; ``caffe_cli test`` on the
    ``.caffemodel.h5`` against the binary ``.caffemodel`` of the same
    iteration; a resume from the ``.solverstate.h5`` at 10 whose next 5
    iterations equal the uninterrupted run's; each format's MB, and the
    seconds of the whole ``Solver.snapshot_caffe`` (the params' copy to
    the host and the encode, ended by a synchronize) and of each file's
    read; a history of flipped shape refused."""
    from sparknet_tpu_torch.data import hdf5
    from sparknet_tpu_torch.proto import caffemodel
    from sparknet_tpu_torch.tools import caffe_cli
    model = os.path.join(d, "records_train_val.prototxt")
    with open(model, "w") as f:
        f.write(records_train_val(text, shards))
    prefix = os.path.join(d, "records")
    solver = os.path.join(d, "records_solver.prototxt")
    with open(solver, "w") as f:
        f.write(f'net: "{model}"\nsnapshot_prefix: "{prefix}"\n'
                + RECORD_SOLVER)
    gens: dict = {}
    torch.cuda.empty_cache()
    ck.reset_launch_counts()
    with cudnn_deterministic():
        log, train_s, s = recorded_cli(["train", "--solver", solver],
                                       gens=gens)
    launches = launched(ck)
    if launches != DATA_PATH_WANT:
        fail(f"data_tier: caffe_cli train from records launches "
             f"{launches}, want {DATA_PATH_WANT}")
    loss_at, stamp, tests = cli_losses(log)
    if sorted(loss_at) != list(range(1, SOLVER_ITERS + 1)) or \
            "Optimization Done." not in log or not all(
                math.isfinite(v) for v in loss_at.values()):
        print(log[-4000:])
        fail("data_tier: caffe_cli train from records: iterations missing "
             "or a loss not finite")
    steady = [(stamp[i] - stamp[i - 1]) * 1e3
              for i in range(3, SOLVER_ITERS + 1) if i != 11]
    # the same seed from the LMDB: the first 5 losses bit for bit
    lmdb_solver = os.path.join(d, "lmdb5_solver.prototxt")
    with open(lmdb_solver, "w") as f:
        f.write(f'net: "{lmdb_text}"\n' + DATA_PATH_SOLVER.replace(
            f"max_iter: {SOLVER_ITERS}", f"max_iter: {LMDB_ITERS}")
            .replace(f"snapshot: {SOLVER_ITERS}\n", ""))
    ck.reset_launch_counts()
    with cudnn_deterministic():
        _, _, s_lmdb = recorded_cli(["train", "--solver", lmdb_solver])
    lmdb_launches = launched(ck)
    ours, theirs = loss_bits(s, LMDB_ITERS), loss_bits(s_lmdb, LMDB_ITERS)
    if ours != theirs:
        fail(f"data_tier: the records run's first losses {ours} differ "
             f"from the LMDB run's {theirs}")
    # (d) the HDF5 snapshot at 20 against the binary file of the same
    # iteration, scored by caffe_cli test
    h5_model = f"{prefix}_iter_{SOLVER_ITERS}.caffemodel.h5"
    h5_state = f"{prefix}_iter_{SOLVER_ITERS}.solverstate.h5"
    # each format's whole snapshot over the same span, twice, alternated
    write_s: dict = {"HDF5": [], "BINARYPROTO": []}
    for rep in range(2):
        for fmt in ("HDF5", "BINARYPROTO"):
            s.sp.snapshot_format = fmt
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = s.snapshot_caffe(f"{prefix}_{fmt.lower()}")
            torch.cuda.synchronize()
            write_s[fmt].append(time.perf_counter() - t0)
            if fmt == "HDF5":
                for p in paths:
                    os.unlink(p)
    bin_model, bin_state = paths
    scores = {}
    ck.reset_launch_counts()
    with cudnn_deterministic():
        for name, w in (("hdf5", h5_model), ("binary", bin_model)):
            tlog, _ = run_cli(caffe_cli.main, [
                "test", "--model", model, "--weights", w, "--iterations",
                str(SOLVER_TEST_ITER)])
            scores[name] = [ln for ln in tlog.splitlines()
                            if " = " in ln and not ln.startswith("Batch")]
    test_launches = launched(ck)
    if not scores["hdf5"] or scores["hdf5"] != scores["binary"]:
        fail(f"data_tier: caffe_cli test on the HDF5 weights scores "
             f"{scores['hdf5']}, on the binary ones {scores['binary']}")
    t0 = time.perf_counter()
    h5_read = hdf5.load_model_hdf5(h5_model)
    h5_read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hdf5.load_state_hdf5(h5_state)
    h5_state_read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    caffemodel.load_caffemodel(bin_model)
    bin_read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    caffemodel.load_solverstate(bin_state)
    bin_state_read_s = time.perf_counter() - t0
    if differing(h5_read, s.train_net.full_params(s.params)):
        fail("data_tier: the .caffemodel.h5 read back differs from the "
             "card's params")
    # resume from the .solverstate.h5 at 10: iterations 11-15 as the
    # uninterrupted run's
    resume_solver = os.path.join(d, "resume_solver.prototxt")
    with open(resume_solver, "w") as f:
        f.write(f'net: "{model}"\n' + RECORD_SOLVER.replace(
            f"max_iter: {SOLVER_ITERS}",
            f"max_iter: {RECORD_RESUME_AT + RECORD_RESUME_ITERS}")
            .replace(f"snapshot: {RECORD_RESUME_AT}\n", ""))
    state10 = f"{prefix}_iter_{RECORD_RESUME_AT}.solverstate.h5"
    ck.reset_launch_counts()
    with cudnn_deterministic():
        rlog, _, s_res = recorded_cli(
            ["train", "--solver", resume_solver, "--snapshot", state10],
            resume_gen=gens[RECORD_RESUME_AT], skip_batches=RECORD_RESUME_AT)
    resume_launches = launched(ck)
    uninterrupted = [float(v).hex() for v in list(s._smoothed)[
        RECORD_RESUME_AT:RECORD_RESUME_AT + RECORD_RESUME_ITERS]]
    resumed = loss_bits(s_res, RECORD_RESUME_ITERS)
    if f"(iter {RECORD_RESUME_AT})" not in rlog or resumed != uninterrupted:
        fail(f"data_tier: the resumed run's losses {resumed} differ from "
             f"the uninterrupted run's {uninterrupted}")
    # planted: a history blob of flipped shape
    st = hdf5.load_state_hdf5(h5_state)
    st["history"][0] = st["history"][0].reshape(
        st["history"][0].shape[::-1])
    bad = os.path.join(d, "flipped.solverstate.h5")
    hdf5.save_state_hdf5(bad, st["iter"], st["history"],
                         learned_net=h5_model)
    try:
        s.restore_caffe(bad)
        fail("data_tier: a .solverstate.h5 with a flipped history shape "
             "was restored")
    except ValueError as e:
        flipped = str(e)[:160]
    mb = lambda p: os.path.getsize(p) / 1e6  # noqa: E731
    del s, s_lmdb, s_res, h5_read
    torch.cuda.empty_cache()
    return {
        "launches": launches, "lmdb5_launches": lmdb_launches,
        "test_launches": test_launches, "resume_launches": resume_launches,
        "train_s": train_s, "first_losses": [loss_at[i] for i in
                                             range(1, LMDB_ITERS + 1)],
        "last_loss": loss_at[SOLVER_ITERS], "tests": tests,
        "iter_ms_median": float(np.median(steady)),
        "iter_ms_lmdb_5c": data_path["iter_ms_median"],
        "scores": scores["hdf5"], "planted_flipped_history": flipped,
        "hdf5_pair": {
            "model_mb": mb(h5_model), "state_mb": mb(h5_state),
            "snapshot_s": write_s["HDF5"],
            "model_read_s": h5_read_s, "state_read_s": h5_state_read_s},
        "binary_pair_same_run": {
            "model_mb": mb(bin_model), "state_mb": mb(bin_state),
            "snapshot_s": write_s["BINARYPROTO"],
            "model_read_s": bin_read_s, "state_read_s": bin_state_read_s},
        "binary_model_5b_earlier": BINARY_EARLIER}


def bridge_rounds(ck, dev, d: str, fx: dict) -> dict:
    """(e) a fake RDD of 512 CaffeNet-sized uint8 records in two
    partitions through ``SparkPartitionBridge(rdd, 2).to_local_dataset(
    spill_dir=...)`` and ``RoundFeed`` into one ``local_sgd`` round of
    CaffeNet (2 workers x 64, τ=2, the crop on the card); the same round
    from ``PartitionedDataset.from_items`` over the same partitions and
    from ``from_records(shards).rebalance(2).cached()``: the rounds and
    the params after them bit for bit; a spill file with a flipped byte
    raises its crc error."""
    from sparknet_tpu_torch.apps.common import RoundFeed
    from sparknet_tpu_torch.data import PartitionedDataset
    from sparknet_tpu_torch.data.integrity import DataCorruptionError
    from sparknet_tpu_torch.data.records import convert_to_shards
    from sparknet_tpu_torch.data.spark_bridge import SparkPartitionBridge
    recs = records_of(fx["shards"])[:BRIDGE_RECORDS]
    half = BRIDGE_RECORDS // 2
    parts = [recs[:half], recs[half:]]

    class FakeRDD:
        """The minimal RDD protocol over a list of partitions."""

        def __init__(self, partitions):
            self.parts = [list(p) for p in partitions]

        def getNumPartitions(self):
            return len(self.parts)

        def coalesce(self, n):
            flat = [x for p in self.parts for x in p]
            return FakeRDD([flat[i::n] for i in range(n)])

        def repartition(self, n):
            return self.coalesce(n)

        def mapPartitionsWithIndex(self, f):
            return FakeRDD([list(f(i, iter(p)))
                            for i, p in enumerate(self.parts)])

        def collect(self):
            return [x for p in self.parts for x in p]

    spill = os.path.join(d, "bridge_spill")
    t0 = time.perf_counter()
    bridged = SparkPartitionBridge(FakeRDD(parts), ROUND_WORKERS) \
        .to_local_dataset(spill_dir=spill)
    bridge_s = time.perf_counter() - t0
    interleaved = [r for pair in zip(*parts) for r in pair]
    shard_dir = os.path.join(d, "bridge_shards")
    convert_to_shards(iter(recs), shard_dir,
                      shard_bytes=RECORD_SHARD_MB << 20)
    datasets = {
        "bridge": bridged,
        "from_items": PartitionedDataset.from_items(interleaved,
                                                    ROUND_WORKERS),
        "from_records": PartitionedDataset.from_records(
            shard_dir).rebalance(ROUND_WORKERS).cached()}
    rounds, params, launches = {}, {}, {}
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    for name, ds in datasets.items():
        rounds[name] = RoundFeed(ds, ROUND_BATCH, BRIDGE_TAU, preprocess=f32,
                                 seed=SEED).next_round()
        with mock.patch.dict(os.environ, {"SPARKNET_COMM_CODEC": "none"}):
            tr = round_trainer(dev, tau=BRIDGE_TAU)
        ck.reset_launch_counts()
        with cudnn_deterministic():
            loss = tr.train_round(rounds[name])
        launches[name] = launched(ck)
        if launches[name] != BRIDGE_WANT or not math.isfinite(loss):
            fail(f"data_tier: bridge round {name}: loss {loss}, launches "
                 f"{launches[name]}, want {BRIDGE_WANT}")
        params[name] = host_params(tr)
        del tr
        torch.cuda.empty_cache()
    for name in ("from_items", "from_records"):
        if any(rounds[name][k].tobytes() != rounds["bridge"][k].tobytes()
               for k in ("data", "label")):
            fail(f"data_tier: the {name} round differs from the bridge's")
        bad = differing(params[name], params["bridge"])
        if bad:
            fail(f"data_tier: the {name} round's params differ from the "
                 f"bridge round's: {bad[:5]}")
    # planted: a spill file rots
    path = os.path.join(spill, "part-00001.pkl")
    with open(path, "r+b") as f:
        f.seek(4096)
        byte = f.read(1)[0]
        f.seek(4096)
        f.write(bytes([byte ^ 0x01]))
    try:
        SparkPartitionBridge(FakeRDD(parts), ROUND_WORKERS) \
            .to_local_dataset(spill_dir=spill)
        fail("data_tier: a rotted spill file was read")
    except DataCorruptionError as e:
        if "crc32" not in str(e) or e.key != 1:
            fail(f"data_tier: the rotted spill is misattributed: {e}")
        rot = str(e)[:160]
    return {"launches": launches, "bridge_s": bridge_s,
            "planted_spill_rot": rot}


def hdf5_classification(ck, dev, d: str) -> dict:
    """(f) Caffe's nonlinear hdf5_classification net through ``caffe_cli
    train`` from the committed gzip-chunked, shuffled ``.h5`` fixtures,
    read by the port's own reader (no h5py on this machine): no hand
    kernel launched, the loss falling (the mean of the last ten
    iterations under that of the first ten, the last test's accuracy
    above the first's: from the published std-0.01 init the loss leaves
    ln 2 slowly, and 200 of the published 10,000 iterations do not halve
    it), and 5 iterations on the card against the CPU within 1e-5
    relative."""
    from sparknet_tpu_torch.data.hdf5 import hdf5_feed
    from sparknet_tpu_torch.proto import (load_net_prototxt,
                                          load_solver_prototxt_with_net)
    from sparknet_tpu_torch.tools import caffe_cli
    model = os.path.join(d, "hdf5_classification.prototxt")
    with open(model, "w") as f:
        f.write(HDF5_NET)
    prefix = os.path.join(d, "hdf5_classification")
    solver = os.path.join(d, "hdf5_classification_solver.prototxt")
    with open(solver, "w") as f:
        f.write(f'net: "{model}"\nsnapshot_prefix: "{prefix}"\n'
                + HDF5_SOLVER)
    ck.reset_launch_counts()
    log, train_s = run_cli(caffe_cli.main, ["train", "--solver", solver,
                                            "--device", str(dev)])
    launches = launched(ck)
    loss_at, stamp, tests = cli_losses(log)
    acc = [v for k, v in tests if k == "accuracy"]
    snapshot = f"{prefix}_iter_{HDF5_ITERS}.caffemodel"
    if launches != NO_KERNELS or sorted(loss_at) != list(
            range(1, HDF5_ITERS + 1)) or len(acc) != 3 or \
            not os.path.exists(snapshot):
        print(log[-3000:])
        fail(f"data_tier: hdf5_classification launches {launches}, "
             f"{len(loss_at)} iterations, tests {tests}")
    first = float(np.mean([loss_at[i] for i in range(1, 11)]))
    last = float(np.mean([loss_at[i] for i in range(HDF5_ITERS - 9,
                                                    HDF5_ITERS + 1)]))
    if not (last < first and acc[-1] > acc[0]):
        fail(f"data_tier: hdf5_classification did not learn: loss "
             f"{first} -> {last}, test accuracy {acc}")
    sp = load_solver_prototxt_with_net(HDF5_SOLVER.replace(
        "display: 1", "display: 0"), load_net_prototxt(HDF5_NET))
    feed = hdf5_feed(os.path.join(HDF5_FIXTURES, "train.txt"),
                     ["data", "label"], 10)
    batches = [next(feed) for _ in range(CARD_VS_CPU_ITERS)]
    card, _ = solver_run(sp, snapshot, batches, dev, torch.float32)
    cpu, _ = solver_run(sp, snapshot, batches, "cpu", torch.float32)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    if rel > HDF5_CARD_VS_CPU_REL:
        fail(f"data_tier: hdf5_classification card {card} against CPU "
             f"{cpu}: {rel} relative")
    after_test = {1, 101}
    steady = [(stamp[i] - stamp[i - 1]) * 1e3
              for i in range(3, HDF5_ITERS + 1) if i not in after_test]
    return {"launches": launches, "first_loss_10": first,
            "last_loss_10": last, "test_accuracy": acc,
            "card_vs_cpu_rel": rel, "train_s": train_s,
            "iter_ms_median": float(np.median(steady))}


def data_tier(ck, dev, smi: str, d5c: str, data_path: dict) -> dict:
    """Phase 5i: SparkNet's data tier on full-width CaffeNet, over phase
    5c's LMDBs, mean and train_val in ``d5c``."""
    t_phase = time.perf_counter()
    fx = {"train_db": os.path.join(d5c, "train_lmdb"),
          "test_db": os.path.join(d5c, "test_lmdb")}
    text_path = os.path.join(d5c, "train_val.prototxt")
    with open(text_path) as f:
        text = f.read()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="data_tier_smoke_") as d:
        conv = convert_and_plant(d, fx)
        shards = conv["dirs"]
        feeds = feeds_equal(d, text, shards)
        trained = train_from_records(ck, dev, d, text, shards, text_path,
                                     data_path)
        bridge = bridge_rounds(ck, dev, d, {"shards": shards["train"]})
        h5c = hdf5_classification(ck, dev, d)
    report = {"convert": {k: v for k, v in conv.items() if k != "dirs"},
              "feeds": feeds, "train": trained, "bridge": bridge,
              "hdf5_classification": h5c,
              "phase_s": time.perf_counter() - t_phase}
    print(f"data_tier [{smi}] " + json.dumps(report, default=str),
          flush=True)
    print(f"data_tier wall [{smi}] {report['phase_s']:.1f} s", flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5j: Caffe's tools and pycaffe's classifiers: train_cifar on
# cifar10_quick and its log through parse_log, upgrade_net_proto and
# draw_net, PNG and CMYK images without PIL, Classifier and Detector on
# full-width CaffeNet through classify_cli and detect_cli
# ---------------------------------------------------------------------------

PNG_FIXTURES = os.path.join(os.path.dirname(FIXTURES), "png_fixtures")
# caffe/examples/cifar10/cifar10_quick_solver.prototxt, max_iter cut from
# 4,000 to 200 and its test every 500 of 100 batches to every 100 of 10
# (1,000 test records at the published batch of 100)
CIFAR_QUICK_SOLVER = """net: "{net}"
test_iter: {test_iter}
test_interval: {test_interval}
base_lr: 0.001
momentum: 0.9
weight_decay: 0.004
lr_policy: "fixed"
display: 10
max_iter: {max_iter}
"""
CIFAR_ITERS, CIFAR_TEST_INTERVAL, CIFAR_TEST_ITER = 100, 50, 10
CIFAR_RECORDS = 1000        # each of the 5 train binaries, and the test one
CIFAR_LOCAL_TAU = 10
# a V0 net (a padding layer folded into its convolution by the upgrade)
# and a V1 net (enum layer types, blobs_lr/weight_decay, phase rules)
V0_NET = """name: "v0"
input: "data"
input_dim: 10 input_dim: 3 input_dim: 227 input_dim: 227
layers { layer { name: "pad1" type: "padding" pad: 2 }
         bottom: "data" top: "p1" }
layers { layer { name: "conv1" type: "conv" num_output: 96 kernelsize: 11
                 stride: 4 weight_filler { type: "gaussian" std: 0.01 } }
         bottom: "p1" top: "conv1" }
layers { layer { name: "relu1" type: "relu" } bottom: "conv1"
         top: "conv1" }
layers { layer { name: "norm1" type: "lrn" local_size: 5 alpha: 0.0001
                 beta: 0.75 } bottom: "conv1" top: "norm1" }
"""
V1_NET = """name: "v1"
layers { name: "data" type: DATA top: "data" top: "label"
  data_param { source: "train_lmdb" batch_size: 256 }
  transform_param { crop_size: 227 mirror: true } include { phase: TRAIN } }
layers { name: "data" type: DATA top: "data" top: "label"
  data_param { source: "val_lmdb" batch_size: 50 } include { phase: TEST } }
layers { name: "conv1" type: CONVOLUTION bottom: "data" top: "conv1"
  blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
  convolution_param { num_output: 96 kernel_size: 11 stride: 4 } }
layers { name: "pool1" type: POOLING bottom: "conv1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 } }
layers { name: "fc8" type: INNER_PRODUCT bottom: "pool1" top: "fc8"
  inner_product_param { num_output: 1000 } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "fc8" bottom: "label" }
layers { name: "accuracy" type: ACCURACY bottom: "fc8" bottom: "label"
  top: "accuracy" include { phase: TEST } }
"""
# the ImageData list: the eight JPEG fixtures and, one entry in
# PNG_EVERY, the 375x500 PNG fixture (resized by pil_resample)
PNG_EVERY = 32
PNG_CMYK_BOUND = (2, 0.05)      # nvJPEG against PIL: max, mean
CLASSIFY_TOL = 1e-4             # the card's probabilities against the CPU's
ARGMAX_MARGIN = 1e-3
CLASSIFY_PNGS = ["photo_375x500.png", "pil_rgb.png", "pil_l.png",
                 "pil_rgba.png", "t0_d16.png", "t3_d4_adam7.png",
                 "t6_d16_adam7.png"]
CLASSIFY_WANT = {"lrn_across_channels": 2}     # a CaffeNet forward


def tool_main(main_fn):
    """A tool's ``main`` as ``run_cli`` takes it: exit code 0 when it
    returns without raising (``train_cifar.main`` returns its
    trajectory)."""
    def run(argv):
        main_fn(argv)
        return 0
    return run


def write_cifar_binaries(d: str) -> str:
    """5 x CIFAR_RECORDS train and CIFAR_RECORDS test records in CIFAR-10's
    binary format, seeded class-banded 32x32 images."""
    from sparknet_tpu_torch.apps.cifar_app import synthetic_cifar
    from sparknet_tpu_torch.data import write_cifar10_binary
    out = os.path.join(d, "cifar10")
    os.makedirs(out)
    for i, name in enumerate([f"data_batch_{k}.bin" for k in range(1, 6)]
                             + ["test_batch.bin"]):
        x, y = synthetic_cifar(CIFAR_RECORDS, seed=SEED + 60 + i)
        write_cifar10_binary(os.path.join(out, name),
                             np.round(x).astype(np.uint8), y)
    return out


def timed_solvers():
    """A patch of the port's ``Solver`` that keeps every instance and its
    seconds inside ``step`` (which ends on the loss's host read), and the
    list of instances."""
    from sparknet_tpu_torch import solvers
    made = []

    class Timed(solvers.Solver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.step_s = 0.0
            made.append(self)

        def step(self, n):
            t0 = time.perf_counter()
            out = super().step(n)
            self.step_s += time.perf_counter() - t0
            return out
    return mock.patch.object(solvers, "Solver", Timed), made


def train_cifar_tool(ck, dev, smi: str, d: str) -> dict:
    """``tools/train_cifar.py`` on cifar10_quick at its published widths
    and batch: the Solver path from CIFAR-10 binaries (``--data-dir``),
    then ``--synthetic --workers 2 --strategy local_sgd --tau 10``, each
    with the pool backward exactly once a worker iteration and never in a
    test pass; the Solver run's log through ``parse_log``, its losses
    those it printed; 5 iterations on the card against the CPU."""
    from sparknet_tpu_torch.models import cifar10_quick
    from sparknet_tpu_torch.proto import save_net_prototxt
    from sparknet_tpu_torch.tools import parse_log, train_cifar
    data_dir = write_cifar_binaries(d)
    net = os.path.join(d, "cifar10_quick_train_test.prototxt")
    save_net_prototxt(cifar10_quick(CIFAR_BATCH, CIFAR_BATCH), net)
    solver = os.path.join(d, "cifar10_quick_solver.prototxt")
    with open(solver, "w") as f:
        f.write(CIFAR_QUICK_SOLVER.format(
            net=net, test_iter=CIFAR_TEST_ITER,
            test_interval=CIFAR_TEST_INTERVAL, max_iter=CIFAR_ITERS))
    run = tool_main(train_cifar.main)
    idle = {k: 0 for k in ck.launch_counts if k not in RELU_FOLD_KEYS}
    report: dict = {"launches": {}}
    patch, made = timed_solvers()
    out = os.path.join(d, "solver.json")
    with patch:
        ck.reset_launch_counts()
        log, wall = run_cli(run, ["--solver", solver, "--data-dir", data_dir,
                                  "--device", str(dev), "--out", out])
        launches = launched(ck)
    want = {**idle, "max_pool_bwd": CIFAR_ITERS}
    with open(out) as f:
        traj = json.load(f)
    pts = traj["points"]
    if launches != want or [p["iter"] for p in pts] != list(range(
            CIFAR_TEST_INTERVAL, CIFAR_ITERS + 1, CIFAR_TEST_INTERVAL)) \
            or traj["data"] != "cifar10" or traj["batch"] != CIFAR_BATCH \
            or not all(math.isfinite(p["loss"]) and 0 <= p["accuracy"] <= 1
                       for p in pts):
        print(log[-3000:])
        fail(f"train_cifar (Solver path): launches {launches}, want {want};"
             f" trajectory {traj}")
    report["launches"]["train_cifar_cifar10_quick"] = launches
    report["solver"] = {
        "ms_per_iter": made[-1].step_s / CIFAR_ITERS * 1e3, "wall_s": wall,
        "points": pts}
    # its log through parse_log: the CSV's losses are those printed
    log_path = os.path.join(d, "train_cifar.log")
    with open(log_path, "w") as f:
        f.write(log)
    train_csv, _ = parse_log.write_csvs(log_path, d)
    printed = [(int(m.group(1)), m.group(2)) for m in re.finditer(
        r"Iteration (\d+), loss = (\S+)", log)]
    with open(train_csv) as f:
        rows = list(csv.reader(f))
    parsed = [(int(r[0]), float(r[3])) for r in rows[1:]]
    if not printed or parsed != [(i, float(v)) for i, v in printed]:
        fail(f"parse_log: CSV losses {parsed[:5]} differ from the printed "
             f"{printed[:5]}")
    report["parse_log_rows"] = len(parsed)
    # the synthetic stand-in on two workers, tau 10
    out2 = os.path.join(d, "local_sgd.json")
    ck.reset_launch_counts()
    _, wall2 = run_cli(run, ["--solver", solver, "--synthetic", "--workers",
                             "2", "--strategy", "local_sgd", "--tau",
                             str(CIFAR_LOCAL_TAU), "--device", str(dev),
                             "--out", out2])
    launches = launched(ck)
    want = {**idle, "max_pool_bwd": 2 * CIFAR_ITERS}
    with open(out2) as f:
        traj2 = json.load(f)
    if launches != want or traj2["strategy"] != "local_sgd" or not all(
            math.isfinite(p["loss"]) for p in traj2["points"]):
        fail(f"train_cifar --workers 2: launches {launches}, want {want}; "
             f"trajectory {traj2}")
    report["launches"]["train_cifar_local_sgd2"] = launches
    report["local_sgd2"] = {"wall_s": wall2, "points": traj2["points"]}
    # 5 iterations on the card against the CPU, deterministic cuDNN
    runs = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        patch, made = timed_solvers()
        ck.reset_launch_counts()
        with patch, cudnn_deterministic():
            log5, _ = run_cli(run, [
                "--solver", solver, "--data-dir", data_dir, "--max-iter",
                str(CARD_VS_CPU_ITERS), "--test-interval",
                str(CARD_VS_CPU_ITERS), "--device", str(where),
                "--out", os.path.join(d, f"five_{key}.json")])
        runs[key] = (made[-1], log5, launched(ck))
    card, cpu = runs["card"][0], runs["cpu"][0]
    err = max_rel({k: [b.cpu() for b in v] for k, v in card.params.items()},
                  cpu.params)
    loss = [float(re.search(r"loss=(\S+)", runs[k][1]).group(1))
            for k in ("card", "cpu")]
    loss_rel = abs(loss[0] - loss[1]) / abs(loss[1])
    report["launches"]["train_cifar_card_vs_cpu"] = runs["card"][2]
    report["card_vs_cpu"] = {"params_max_rel": err, "loss_rel": loss_rel,
                             "losses": loss}
    if err > 1e-3 or loss_rel > 1e-4 or \
            runs["card"][2]["max_pool_bwd"] != CARD_VS_CPU_ITERS:
        fail(f"train_cifar: {CARD_VS_CPU_ITERS} iterations on the card "
             f"against the CPU: {report['card_vs_cpu']}, launches "
             f"{runs['card'][2]}")
    return report


def upgrade_and_draw(d: str) -> dict:
    """``upgrade_net_proto`` (text and ``--binary``) and ``draw_net`` on a
    V0 and a V1 prototxt: each output byte for byte what the same tool
    writes again in this process, the V0 padding folded into its
    convolution, the V1 enums upgraded to type names."""
    from sparknet_tpu_torch.proto import load_net_prototxt
    from sparknet_tpu_torch.tools import draw_net, upgrade_net_proto
    report = {}
    for name, text in (("v0", V0_NET), ("v1", V1_NET)):
        src = os.path.join(d, f"{name}.prototxt")
        with open(src, "w") as f:
            f.write(text)
        outs = {}
        for tool, args, suffix in (
                (upgrade_net_proto.main, [], ".prototxt"),
                (upgrade_net_proto.main, ["--binary"], ".caffemodel"),
                (draw_net.main, ["--rankdir", "TB"], ".dot")):
            got = []
            for i in range(2):
                out = os.path.join(d, f"{name}_{len(outs)}_{i}{suffix}")
                run_cli(tool, [src, out] + args)
                with open(out, "rb") as f:
                    got.append(f.read())
            if got[0] != got[1]:
                fail(f"{name}: {suffix} differs between two runs")
            outs[suffix] = got[0]
        upgraded = load_net_prototxt(outs[".prototxt"].decode())
        types = [lp.type for lp in upgraded.layer]
        if b"layers {" in outs[".prototxt"] or "Convolution" not in types \
                or (name == "v0" and "padding" in " ".join(types)) or \
                not outs[".dot"].startswith(f'digraph "{name}"'.encode()):
            fail(f"upgrade_net_proto/draw_net on {name}: types {types}")
        report[name] = {"types": types, "bytes": {k: len(v) for k, v in
                                                  outs.items()}}
    return report


def _manifest_png() -> dict:
    with open(os.path.join(PNG_FIXTURES, "manifest.json")) as f:
        return json.load(f)


def _pixels_sha(arr: np.ndarray) -> str:
    """sha256 of (C, H, W) float32 0-255 pixels as PIL's uint8 (H, W, C),
    or (H, W) for one channel."""
    import hashlib
    u8 = arr.astype(np.uint8)
    u8 = u8[0] if u8.shape[0] == 1 else u8.transpose(1, 2, 0)
    return hashlib.sha256(np.ascontiguousarray(u8).tobytes()).hexdigest()


def png_and_cmyk_on_card(dev, d: str) -> dict:
    """Every committed PNG fixture through ``load_image`` and an encoded
    Datum on the card's host path equals its PIL pixels bit for bit; the
    CMYK fixture through nvJPEG within PNG_CMYK_BOUND of PIL's; the
    corrupt ones refused; and the planted faults fail these checks."""
    from sparknet_tpu_torch.data import db, jpeg, png
    from sparknet_tpu_torch.data.integrity import DataCorruptionError
    manifest = _manifest_png()
    checked = 0

    def png_ok(name: str) -> bool:
        e = manifest["images"][name]
        path = os.path.join(PNG_FIXTURES, name)
        return all(_pixels_sha(db.load_image(path, 0, 0, color, dev))
                   == e[f"{'rgb' if color else 'l'}_sha256"]
                   for color in (True, False))

    for name in manifest["images"]:
        if not name.endswith(".png"):
            continue
        if not png_ok(name):
            fail(f"png: {name} differs from PIL's pixels on the card")
        with open(os.path.join(PNG_FIXTURES, name), "rb") as f:
            raw = f.read()
        img, _ = db.datum_to_array(db.array_to_datum(None, 0, encoded=raw),
                                   device=dev)
        if _pixels_sha(img) != manifest["images"][name]["rgb_sha256"]:
            fail(f"png: {name} as an encoded Datum differs from PIL's")
        checked += 1
    for name in manifest["corrupt"]:
        with open(os.path.join(PNG_FIXTURES, name), "rb") as f:
            raw = f.read()
        try:
            db.datum_to_array(db.array_to_datum(None, 0, encoded=raw),
                              device=dev)
        except DataCorruptionError:
            continue
        fail(f"png: the corrupt {name} decoded")
    e = manifest["images"]["cmyk_adobe.jpg"]
    want = np.load(os.path.join(PNG_FIXTURES, e["rgb_pixels"])).astype(int)
    cmyk_path = os.path.join(PNG_FIXTURES, "cmyk_adobe.jpg")

    def cmyk_diff():
        got = db.load_image(cmyk_path, 0, 0, True, dev).transpose(1, 2, 0)
        diff = np.abs(got.astype(int) - want)
        return int(diff.max()), float(diff.mean())

    cmyk = cmyk_diff()
    with open(cmyk_path, "rb") as f:
        datum, _ = db.datum_to_array(db.array_to_datum(
            None, 0, encoded=f.read()), device=dev)
    datum_diff = np.abs(datum.transpose(1, 2, 0).astype(int) - want)
    if cmyk[0] > PNG_CMYK_BOUND[0] or cmyk[1] >= PNG_CMYK_BOUND[1] or \
            datum_diff.max() > PNG_CMYK_BOUND[0]:
        fail(f"cmyk: nvJPEG's pixels {cmyk} from PIL's (bound "
             f"{PNG_CMYK_BOUND}); as a Datum max {datum_diff.max()}")
    # planted faults
    planted = {}
    photo = os.path.join(PNG_FIXTURES, "photo_375x500.png")
    with open(photo, "rb") as f:
        raw = f.read()
    at = raw.index(b"IDAT") + 4 + 5000
    try:
        png.decode_png(raw[:at] + bytes([raw[at] ^ 0x5A]) + raw[at + 1:])
        fail("planted: a PNG with a flipped IDAT byte decoded")
    except png.PNGError as err:
        planted["flipped_idat_byte"] = str(err)
    unfilter = png.unfilter

    def paeth_as_sub(raw_rows, height, row_bytes, bpp):
        rows = raw_rows.reshape(height, row_bytes + 1).copy()
        rows[rows[:, 0] == 4, 0] = 1
        return unfilter(rows.reshape(-1), height, row_bytes, bpp)

    with mock.patch.object(png, "unfilter", paeth_as_sub):
        if png_ok("photo_375x500.png"):
            fail("planted: Paeth undone as Sub passes the pixel check")
    planted["paeth_as_sub"] = "refused"
    convert = png.PNGImage.convert

    def scaled_16bit(self, mode):
        if self.mode == "I;16":
            g = (self.pixels() >> 8).astype(np.uint8)
            return g if mode == "L" else np.repeat(g[..., None], 3, 2)
        return convert(self, mode)

    with mock.patch.object(png.PNGImage, "convert", scaled_16bit):
        if png_ok("t0_d16.png") or png_ok("pil_i16.png"):
            fail("planted: 16-bit gray scaled, not clipped, passes")
    planted["sixteen_bit_scaled"] = "refused"
    cmyk_to_rgb = jpeg.cmyk_to_rgb
    with mock.patch.object(jpeg, "cmyk_to_rgb",
                           lambda c, inverted: cmyk_to_rgb(c, False)):
        no_inversion = cmyk_diff()
    if no_inversion[0] <= PNG_CMYK_BOUND[0] and \
            no_inversion[1] < PNG_CMYK_BOUND[1]:
        fail(f"planted: CMYK without the Adobe inversion passes: "
             f"{no_inversion}")
    planted["cmyk_without_inversion"] = no_inversion
    return {"png_fixtures": checked, "cmyk_vs_pil": cmyk,
            "cmyk_datum_max": int(datum_diff.max()), "planted": planted}


def image_data_with_pngs(ck, dev, d: str) -> dict:
    """``caffe_cli train`` for IMAGE_SOLVER_ITERS iterations of full-width
    CaffeNet over an ImageData list of JPEG fixtures with one entry in
    PNG_EVERY the 375x500 PNG fixture (new size 256: the PNGs decoded by
    ``png.py`` and resized by ``pil_resample``): exact launches, PNGs
    decoded, finite losses."""
    from sparknet_tpu_torch.data import jpeg, pil_resample, png
    from sparknet_tpu_torch.tools import caffe_cli
    import threading
    img = os.path.join(d, "img")
    os.makedirs(img)
    jpegs = [f"imagenet_{i}.jpg" for i in range(8)]
    for name in jpegs:
        with open(os.path.join(img, name), "wb") as f:
            f.write(fixture(name))
    with open(os.path.join(PNG_FIXTURES, "photo_375x500.png"), "rb") as f:
        photo = f.read()
    with open(os.path.join(img, "photo.png"), "wb") as f:
        f.write(photo)
    lines = [("photo.png" if i % PNG_EVERY == PNG_EVERY - 1
              else jpegs[i % 8]) + f" {i % 1000}"
             for i in range(SOLVER_TRAIN_BATCH)]
    listfile = os.path.join(d, "mixed.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(lines) + "\n")
    model = os.path.join(d, "image_data.prototxt")
    with open(model, "w") as f:
        f.write(image_train_val("ImageData", listfile, listfile, None,
                                img + "/"))
    solver = os.path.join(d, "image_data_solver.prototxt")
    with open(solver, "w") as f:
        f.write(f'net: "{model}"\n' + IMAGE_SOLVER)
    counts = {"png": 0, "resize": 0, "jpeg": 0}
    lock = threading.Lock()
    decode_png, resize, rgb_cuda = (png.decode_png, pil_resample.resize,
                                    jpeg._rgb_cuda)

    def counted(fn, key, ok=lambda out: True):
        def run(*a, **k):
            out = fn(*a, **k)
            with lock:
                counts[key] += ok(out)
            return out
        return run

    torch.cuda.empty_cache()
    ck.reset_launch_counts()
    with mock.patch.object(png, "decode_png", counted(decode_png, "png")), \
            mock.patch.object(pil_resample, "resize",
                              counted(resize, "resize")), \
            mock.patch.object(jpeg, "_rgb_cuda", counted(
                rgb_cuda, "jpeg", lambda out: out is not None)):
        log, wall = run_cli(caffe_cli.main, ["train", "--solver", solver])
    launches = launched(ck)
    want = {"lrn_across_channels_fwd": 2 * IMAGE_SOLVER_ITERS,
            "lrn_across_channels_bwd": 2 * IMAGE_SOLVER_ITERS,
            "max_pool_bwd": 3 * IMAGE_SOLVER_ITERS,
            "lrn_across_channels": 2 * IMAGE_SOLVER_TESTS * SOLVER_TEST_ITER,
            "ycc_to_rgb": counts["jpeg"], "resize_bilinear": counts["jpeg"]}
    losses = [float(ln.rsplit("= ", 1)[1]) for ln in log.splitlines()
              if "] Iteration " in ln and ", loss = " in ln]
    images = IMAGE_SOLVER_ITERS * SOLVER_TRAIN_BATCH
    if launches != want or counts["png"] < images // PNG_EVERY or \
            counts["resize"] != counts["png"] or \
            len(losses) < IMAGE_SOLVER_ITERS or \
            not all(math.isfinite(v) for v in losses):
        print(log[-3000:])
        fail(f"caffe_cli train over JPEGs and PNGs: launches {launches}, "
             f"want {want}; decodes {counts}; losses {losses}")
    return {"launches": launches, "wall_s": wall, "decodes": counts,
            "losses": losses}


def caffenet_deploy(d: str) -> tuple[str, str]:
    """Full-width CaffeNet's deploy net (input 10 x 3 x 227 x 227, Softmax
    ``prob``) and a ``.caffemodel`` of seeded weights with fc8 scaled so
    that the logits' std over the JPEG fixtures' center crops is 3 (at
    its filler the softmax is flat to 1e-5 and no argmax is decided)."""
    from sparknet_tpu_torch.classify import preprocess_image
    from sparknet_tpu_torch.graph.net import Net
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.parallel.serving import deploy_from
    from sparknet_tpu_torch.proto import (NetState, Phase, save_caffemodel,
                                          save_net_prototxt)
    from sparknet_tpu_torch.pycaffe_io import load_image
    deploy, _ = deploy_from(caffenet(), 10)
    net_path = os.path.join(d, "caffenet_deploy.prototxt")
    save_net_prototxt(deploy, net_path)
    net = Net(deploy, NetState(Phase.TEST))
    params = net.init(torch.Generator().manual_seed(SEED + 70), device="cpu")
    crop = net.input_blobs["data"][-1]
    crops = np.stack([preprocess_image(
        load_image(os.path.join(FIXTURES, f"imagenet_{i}.jpg"),
                   device="cpu"), (crop, crop),
        channel_swap=(2, 1, 0), raw_scale=255.0) for i in range(8)])
    with torch.inference_mode():
        logits = net.apply(params, {"data": torch.from_numpy(crops)},
                           blobs=["fc8"])["fc8"]
    params["fc8"] = [b * (3.0 / float(logits.std())) for b in params["fc8"]]
    weights = os.path.join(d, "caffenet.caffemodel")
    save_caffemodel(weights, params)
    return net_path, weights


def classify_on_card(ck, dev, smi: str, d: str) -> dict:
    """``classify_cli`` on CaffeNet's deploy net with ``.caffemodel``
    weights, 10-crop and ``--center_only``, over the eight JPEG fixtures
    (``--ext jpg``), over PNG fixtures (``--ext png``) and the CMYK JPEG,
    and ``detect_cli`` on a windows CSV over the JPEG fixtures: every
    forward launches the LRN inference kernel twice, and its
    probabilities are within CLASSIFY_TOL of the CPU forward of the same
    crops (TF32 off), the argmax equal wherever the top-2 margin exceeds
    ARGMAX_MARGIN."""
    from sparknet_tpu_torch import classify
    from sparknet_tpu_torch.graph.net import Net
    from sparknet_tpu_torch.proto import NetState, Phase, load_net_prototxt
    from sparknet_tpu_torch.solvers.solver import load_weights_into
    from sparknet_tpu_torch.tools import classify_cli, detect_cli
    os.makedirs(d)
    model, weights = caffenet_deploy(d)
    cpu_net = Net(load_net_prototxt(model), NetState(Phase.TEST))
    cpu_params = load_weights_into(
        cpu_net, cpu_net.init(device="cpu"), weights)
    forwards: list = []
    fwd = classify.Classifier._fwd

    def recorded(self, crops):
        before = launched(ck)
        out = fwd(self, crops)
        forwards.append((np.array(crops, np.float32), out, {
            k: v - before.get(k, 0) for k, v in launched(ck).items()
            if v - before.get(k, 0)}))
        return out

    predict = classify.Classifier.predict
    predict_s = []

    def timed_predict(self, inputs, oversample_crops=True):
        t0 = time.perf_counter()
        out = predict(self, inputs, oversample_crops)
        predict_s.append((len(inputs), time.perf_counter() - t0))
        return out

    jpg_dir = os.path.join(d, "jpg")
    png_dir = os.path.join(d, "png")
    os.makedirs(jpg_dir)
    os.makedirs(png_dir)
    for i in range(8):
        with open(os.path.join(jpg_dir, f"imagenet_{i}.jpg"), "wb") as f:
            f.write(fixture(f"imagenet_{i}.jpg"))
    for name in CLASSIFY_PNGS:
        with open(os.path.join(PNG_FIXTURES, name), "rb") as f, \
                open(os.path.join(png_dir, name), "wb") as g:
            g.write(f.read())
    base = ["--model_def", model, "--pretrained_model", weights,
            "--mean_file", os.path.join(d, "mean.npy"), "--device", str(dev)]
    np.save(os.path.join(d, "mean.npy"), np.array([104.0, 117.0, 123.0]))
    runs = {"classify_cli_10crop_jpeg": [jpg_dir, "--ext", "jpg"],
            "classify_cli_center_jpeg": [jpg_dir, "--ext", "jpg",
                                         "--center_only"],
            "classify_cli_center_png": [png_dir, "--ext", "png",
                                        "--center_only"],
            "classify_cli_cmyk": [os.path.join(PNG_FIXTURES,
                                               "cmyk_adobe.jpg")]}
    report: dict = {"launches": {}, "runs": {}}
    with mock.patch.object(classify.Classifier, "_fwd", recorded), \
            mock.patch.object(classify.Classifier, "predict", timed_predict):
        for name, args in runs.items():
            forwards.clear()
            ck.reset_launch_counts()
            out = os.path.join(d, f"{name}.npy")
            _, wall = run_cli(classify_cli.main, [args[0], out] + base
                              + args[1:])
            report["launches"][name] = launched(ck)
            probs = np.load(out)
            report["runs"][name] = {"wall_s": wall, "inputs": len(probs),
                                    **check_forwards(forwards, cpu_net,
                                                     cpu_params, name)}
        n, secs = predict_s[0]
        report["classify_10crop_img_per_s"] = n / secs
        # detect_cli: two windows a JPEG fixture, context padding 16
        wins = os.path.join(d, "windows.csv")
        rows = ["filename,ymin,xmin,ymax,xmax"]
        for i in range(8):
            h, w = (_manifest_jpeg()[f"imagenet_{i}"][k]
                    for k in ("height", "width"))
            path = os.path.join(jpg_dir, f"imagenet_{i}.jpg")
            rows += [f"{path},0,0,{h - 1},{w - 1}",
                     f"{path},{h // 4},{w // 4},{3 * h // 4},{3 * w // 4}"]
        with open(wins, "w") as f:
            f.write("\n".join(rows) + "\n")
        forwards.clear()
        ck.reset_launch_counts()
        out = os.path.join(d, "detections.csv")
        _, wall = run_cli(detect_cli.main, [wins, out] + base)
        report["launches"]["detect_cli"] = launched(ck)
        with open(out) as f:
            dets = list(csv.reader(f))
        if len(dets) != 17 or len(dets[0]) != 5 + 1000:
            fail(f"detect_cli: {len(dets)} rows of {len(dets[0])}")
        report["runs"]["detect_cli"] = {
            "wall_s": wall, "windows": 16,
            **check_forwards(forwards, cpu_net, cpu_params, "detect_cli")}
    print(f"classify [{smi}] " + json.dumps(report), flush=True)
    return report


def _manifest_jpeg() -> dict:
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)["imagenet"]


def check_forwards(forwards: list, cpu_net, cpu_params, name: str) -> dict:
    """Each recorded forward: 2 LRN inference launches; the card's output
    against the CPU forward of the same crops."""
    if not forwards:
        fail(f"{name}: no forward ran")
    worst, decided, margins = 0.0, 0, []
    for crops, card, launched in forwards:
        if launched != CLASSIFY_WANT:
            fail(f"{name}: a forward launched {launched}, want "
                 f"{CLASSIFY_WANT}")
        with torch.inference_mode():
            cpu = cpu_net.apply(cpu_params, {"data": torch.from_numpy(
                crops)})[cpu_net.output_blobs[-1]].numpy()
        card, cpu = card.reshape(len(card), -1), cpu.reshape(len(cpu), -1)
        worst = max(worst, float(np.abs(card - cpu).max()))
        top2 = np.sort(cpu, 1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > ARGMAX_MARGIN
        margins.append(float(np.median(top2[:, 1] - top2[:, 0])))
        decided += int(sure.sum())
        if (card.argmax(1) != cpu.argmax(1))[sure].any():
            fail(f"{name}: the card's argmax differs from the CPU's where "
                 f"the margin exceeds {ARGMAX_MARGIN}")
    if worst > CLASSIFY_TOL:
        fail(f"{name}: probabilities {worst:.3e} from the CPU's (bound "
             f"{CLASSIFY_TOL})")
    return {"forwards": len(forwards), "max_abs_vs_cpu": worst,
            "argmax_decided": decided, "median_top2_margin":
            float(np.median(margins))}


def host_image_times() -> dict:
    """Host ms of a 375x500 PNG's decode and of its PIL-style resize to
    256x256 (median of 5 each)."""
    from sparknet_tpu_torch.data import pil_resample, png
    with open(os.path.join(PNG_FIXTURES, "photo_375x500.png"), "rb") as f:
        raw = f.read()
    rgb = png.decode_png(raw).convert("RGB")
    out = {}
    for key, fn in (("png_decode_ms", lambda: png.decode_png(raw)
                     .convert("RGB")),
                    ("resample_ms", lambda: pil_resample.resize(
                        rgb, (TRAIN_RESIZE, TRAIN_RESIZE)))):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[key] = float(np.median(times))
    return out


def tools_and_classifiers(ck, dev, smi: str) -> dict:
    """Phase 5j."""
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tools_smoke_") as d:
        cifar = train_cifar_tool(ck, dev, smi, os.path.join(d, "cifar"))
        tools = upgrade_and_draw(d)
        images = png_and_cmyk_on_card(dev, d)
        mixed = image_data_with_pngs(ck, dev, os.path.join(d, "mixed"))
        classified = classify_on_card(ck, dev, smi, os.path.join(d, "cls"))
    times = host_image_times()
    report = {"train_cifar": cifar, "tools": tools, "images": images,
              "image_data_png": mixed, "classify": classified,
              "host_images": times,
              "phase_s": time.perf_counter() - t_phase}
    print(f"tools_and_classifiers [{smi}] " + json.dumps(report, default=str),
          flush=True)
    print(f"tools_and_classifiers times [{smi}] " + json.dumps({
        "train_cifar_ms_per_iter": cifar["solver"]["ms_per_iter"],
        "png_decode_ms": times["png_decode_ms"],
        "resample_ms": times["resample_ms"],
        "classify_10crop_img_per_s":
            classified["classify_10crop_img_per_s"],
        "phase_s": report["phase_s"]}), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5k: the training data plane on the card and SparkNet's learning
# proxy: the native host pipeline against its numpy paths and its feed
# speed, full-width CaffeNet from record shards through the Solver with
# the host transform and with set_augment on the host and on the card,
# the learning proxy and the τ sweep on full-width cifar10_full
# ---------------------------------------------------------------------------

AUG_ITERS, AUG_WARM = 8, 2      # Solver iterations a feed, the first warm
                                # (12 until phase 5p took the time)
FEED_BATCHES = 4                # one epoch of 5c's 1,024 records at 256
NATIVE_JPEGS = ("s420", "s422", "s444", "gray", "progressive", "restart",
                "truncated")
# the published cifar10_full schedule (70,000 iterations) divided by 3,500
# (1,400 until phase 5p took the time): 20 iterations, whole rounds of
# every τ, the lr drops at 17 and 18; the tool's defaults otherwise
# (10,000 + 2,000 images, batch 100, 8 workers, τ=10, hier 2x4)
PROXY_SCALE, PROXY_WORKERS = 3500, 8
PROXY_ITERS = 70000 // PROXY_SCALE
# the τ sweep: 2 τ x 2 codecs at 20 iterations (divided by 3,500) on the
# sweep tool's 2,000 + 400 images
SWEEP_SCALE, SWEEP_TAUS, SWEEP_CODECS = 3500, (2, 10), ("none", "int8")
SWEEP_ITERS = 70000 // SWEEP_SCALE
# the first 10 iterations of 1x on 2,000 + 100 images, card against CPU:
# their mean loss within 1e-4 relative (the CPU tests' bound against the
# JAX tool), and, since that loss sits on cifar10_full's ln(10) plateau
# (conv1 drawn with std 1e-4) where a wrong update moves it by less, what
# the 10 iterations changed: the worst leaf of ||Δcard − Δcpu|| / ||Δcpu||
# within 1e-2 (the CPU tests' bound against the JAX tool's update, where
# a mean one grey level off reads 0.12); the same run with the mean one
# grey level off on the card must read beyond it
PROXY_CHECK_ITERS, PROXY_CHECK_TRAIN, PROXY_CPU_REL = 10, 2000, 1e-4
PROXY_UPDATE_REL = 1e-2
# caffe_cli train on 5c's LMDB with the per-image Python crop, measured on
# an H100 80GB HBM3 at 700 W, printed beside this run's
CAFFE_CLI_EARLIER_MS = 331.606


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def numpy_paths():
    """The native pipeline's numpy paths, as on a host with no compiler."""
    from sparknet_tpu_torch import native
    return mock.patch.object(native, "get_lib", lambda: None)


def native_crop_holds(crop_fn, x, mean) -> bool:
    """``crop_fn`` (the native crop, or a planted one) equals the numpy
    path bit for bit at CaffeNet's crop, with a crop-sized mean."""
    from sparknet_tpu_torch import native
    rng = np.random.default_rng(SEED + 11)
    n, _, h, w = x.shape
    ys = rng.integers(0, h - TRAIN_CROP + 1, n).astype(np.int32)
    xs = rng.integers(0, w - TRAIN_CROP + 1, n).astype(np.int32)
    flips = rng.integers(0, 2, n).astype(np.int32)
    with numpy_paths():
        want = native.crop_batch(x, TRAIN_CROP, ys, xs, flips, mean)
    return same_bits(crop_fn(x, TRAIN_CROP, ys, xs, flips, mean), want)


def check_native(d5c: str) -> dict:
    """(a) ``native.available()`` where the script runs, and every entry
    against its numpy path bit for bit: the Datum parse and the crop on
    5c's first 256 Datums, the mean's sums, CIFAR records; the libjpeg decode
    against the fixtures' libjpeg pixels resized by the plain version,
    where the library has libjpeg.  Planted: a crop one pixel off."""
    from sparknet_tpu_torch import native
    from sparknet_tpu_torch.data.db import datum_to_array
    from sparknet_tpu_torch.data.lmdb_io import LmdbReader
    from sparknet_tpu_torch.ops.cuda_kernels import resize_bilinear_reference
    from sparknet_tpu_torch.proto import load_mean_binaryproto
    t0 = time.perf_counter()
    if not native.available():
        fail(f"native: the library did not build: "
             f"{native.build_error()}")
    build_s = time.perf_counter() - t0
    with LmdbReader(os.path.join(d5c, "train_lmdb")) as r:
        vals = [v for _, v in itertools.islice(r.items(), SOLVER_TRAIN_BATCH)]
    t0 = time.perf_counter()
    parsed = native.parse_datum_batch(vals, 3, DB_SIZE, DB_SIZE)
    parse_s = time.perf_counter() - t0
    per_record = [datum_to_array(v, device="cpu") for v in vals]
    if parsed is None or not same_bits(
            parsed[0], np.stack([np.asarray(x, np.float32)
                                 for x, _ in per_record])) or \
            parsed[1].tolist() != [lbl for _, lbl in per_record]:
        fail("native: parse_datum_batch differs from the per-record parse")
    x = parsed[0] - load_mean_binaryproto(os.path.join(d5c,
                                                       "mean.binaryproto"))
    mean = np.random.default_rng(SEED + 12).normal(
        size=(3, TRAIN_CROP, TRAIN_CROP)).astype(np.float32) * 20
    if not native_crop_holds(native.crop_batch, x, mean):
        fail("native: crop_batch differs from its numpy path")

    def one_pixel_off(b, crop, ys, xs, flips, m):
        return native.crop_batch(b, crop, ys, np.minimum(
            xs + 1, b.shape[-1] - crop), flips, m)

    if native_crop_holds(one_pixel_off, x, mean):
        fail("native: a crop one pixel off passed the check")
    acc, want = np.zeros(x.shape[1:]), np.zeros(x.shape[1:])
    native.accumulate_mean(x, acc)
    with numpy_paths():
        native.accumulate_mean(x, want)
    recs = np.random.default_rng(SEED + 13).integers(
        0, 256, (1000, 3073)).astype(np.uint8)
    got = native.decode_cifar(recs)
    with numpy_paths():
        ref = native.decode_cifar(recs)
    if not same_bits(acc, want) or not (same_bits(got[0], ref[0])
                                        and same_bits(got[1], ref[1])):
        fail("native: accumulate_mean or decode_cifar differs from numpy")
    jpeg = native.jpeg_available()
    for name in NATIVE_JPEGS if jpeg else ():
        pixels = torch.from_numpy(np.load(os.path.join(FIXTURES,
                                                       f"{name}.npy")))
        data = open(os.path.join(FIXTURES, f"{name}.jpg"), "rb").read()
        if not same_bits(native.decode_jpeg_resize(data, DB_SIZE, DB_SIZE),
                         resize_bilinear_reference(pixels, DB_SIZE,
                                                   DB_SIZE).numpy()):
            fail(f"native: decode_jpeg_resize of {name}.jpg differs from "
                 f"libjpeg's pixels resized by the plain version")
    return {"available": True, "libjpeg": jpeg, "build_or_load_s": build_s,
            "parse_256_ms": parse_s * 1e3,
            "planted_crop_one_pixel_off": "refused"}


def host_feed(lp, dev, native_on: bool) -> tuple[float, dict]:
    """img/s of ``db_feed`` at batch 256 over ``FEED_BATCHES`` batches
    after one warm one, with the native parse and crop or the per-record
    path and the numpy crop; and the warm batch."""
    from sparknet_tpu_torch.data.db import db_feed
    from sparknet_tpu_torch.proto import Phase
    with (contextlib.nullcontext() if native_on else numpy_paths()):
        feed = db_feed(lp, Phase.TRAIN, seed=SEED, device=dev)
        first = next(feed)
        t0 = time.perf_counter()
        for _ in range(FEED_BATCHES):
            next(feed)
        s = time.perf_counter() - t0
        feed.close()
    return FEED_BATCHES * SOLVER_TRAIN_BATCH / s, first


def augment_holds(dev_out: torch.Tensor, host_out: np.ndarray) -> bool:
    return same_bits(dev_out.cpu().numpy(), host_out)


def check_augment(dev, raw: np.ndarray, spec) -> dict:
    """``augment_batch`` on the card against ``augment_batch_host`` at the
    same draws, bit for bit, on one raw batch of the shards; planted: the
    card's mirror along the rows."""
    from sparknet_tpu_torch.data.transforms import augment_batch_host
    from sparknet_tpu_torch.ops import augment
    host = augment_batch_host(raw, torch.Generator().manual_seed(SEED), spec)
    x = torch.from_numpy(raw).to(dev)
    if not augment_holds(augment.augment_batch(
            x, torch.Generator().manual_seed(SEED), spec), host):
        fail("augment: the card's augment_batch differs from the host's")
    n, _, h, w = raw.shape
    ys, xs, flips = (t.to(dev) for t in augment.draw_offsets(
        torch.Generator().manual_seed(SEED), n, h, w, spec))
    flat = augment.apply(x, ys, xs, flips, spec._replace(mirror=False))
    planted = torch.where(flips.bool()[:, None, None, None],
                          flat.flip(-2), flat)
    if augment_holds(planted, host):
        fail("augment: a mirror along the wrong axis passed the check")
    return {"planted_mirror_wrong_axis": "refused"}


AUG_SOLVER = ('base_lr: 0.01\nlr_policy: "step"\ngamma: 0.1\nstepsize: 10\n'
              "momentum: 0.9\nweight_decay: 0.0005\n")


def solver_feed(ck, dev, lp, spec, mode: str) -> dict:
    """``AUG_ITERS`` iterations of full-width CaffeNet through the Solver
    from the shards: mode ``host_transform`` (``records_feed`` with its
    DataTransformer), ``augment_host`` or ``augment_device``
    (``records_feed(raw=True)`` and ``set_augment``).  ms an iteration
    (``step(1)``, which fetches the loss), the losses and launches."""
    from sparknet_tpu_torch.data.records import records_feed
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.proto import Phase, load_solver_prototxt_with_net
    from sparknet_tpu_torch.solvers import Solver
    sp = load_solver_prototxt_with_net(AUG_SOLVER, caffenet(
        SOLVER_TRAIN_BATCH, SOLVER_TEST_BATCH, crop=TRAIN_CROP))
    s = Solver(sp, seed=SEED, device=dev)
    feed = records_feed(lp, Phase.TRAIN, seed=SEED,
                        raw=mode != "host_transform")
    if mode != "host_transform":
        s.set_augment(spec, device=mode == "augment_device")
    s.set_train_data(feed)
    ck.reset_launch_counts()
    times, losses = [], []
    with cudnn_deterministic():
        for _ in range(AUG_ITERS):
            t0 = time.perf_counter()
            losses.append(s.step(1))
            times.append(time.perf_counter() - t0)
    launches = launched(ck)
    feed.close()
    del s
    torch.cuda.empty_cache()
    if launches != want_steps(AUG_ITERS):
        fail(f"augment: the Solver's {mode} run launched {launches}, want "
             f"{want_steps(AUG_ITERS)}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"augment: the Solver's {mode} run has a loss not finite")
    return {"ms_per_iter": float(np.median(times[AUG_WARM:])) * 1e3,
            "ms_each": [t * 1e3 for t in times],
            "losses": [v.hex() for v in losses], "launches": launches}


def augment_paths(ck, dev, d: str, d5c: str, data_path: dict) -> dict:
    """(b) the three feeds of full-width CaffeNet from 5c's LMDB as record
    shards, (b) and (c)'s losses bit for bit; 5c's ``caffe_cli train``
    with the native transform against the time before it."""
    from sparknet_tpu_torch.data.records import records_feed
    from sparknet_tpu_torch.ops.augment import AugmentSpec
    from sparknet_tpu_torch.proto import Phase, load_net_prototxt
    from sparknet_tpu_torch.tools import convert
    shards = os.path.join(d, "shards")
    t0 = time.perf_counter()
    if convert.main(["--source", os.path.join(d5c, "train_lmdb"),
                     "--out", shards]) != 0:
        fail("augment: the convert tool failed on 5c's LMDB")
    convert_s = time.perf_counter() - t0
    lp = load_net_prototxt(
        f'layer {{ name: "data" type: "Data" top: "data" top: "label" '
        f'transform_param {{ mirror: true crop_size: {TRAIN_CROP} '
        f'mean_file: "{os.path.join(d5c, "mean.binaryproto")}" }} '
        f'data_param {{ source: "{shards}" batch_size: '
        f'{SOLVER_TRAIN_BATCH} backend: RECORDS }} }}').layer[0]
    spec = AugmentSpec.from_transform_param(lp.sub("transform_param"),
                                            Phase.TRAIN)
    feed = records_feed(lp, Phase.TRAIN, seed=SEED, raw=True)
    raw = next(feed)["data"]
    feed.close()
    report = {"convert_s": convert_s, **check_augment(dev, raw, spec)}
    for mode in ("host_transform", "augment_host", "augment_device"):
        report[mode] = solver_feed(ck, dev, lp, spec, mode)
    if report["augment_host"]["losses"] != report["augment_device"]["losses"]:
        fail(f"augment: set_augment on the host gives the losses "
             f"{report['augment_host']['losses']}, on the card "
             f"{report['augment_device']['losses']}")
    report["caffe_cli_train_native_ms"] = data_path["iter_ms_median"]
    report["caffe_cli_train_earlier_ms"] = CAFFE_CLI_EARLIER_MS
    return report


def update_gap(got: dict, want: dict, params0: dict) -> float:
    """The worst leaf of ||Δgot − Δwant|| / ||Δwant||, each Δ a run's
    params less ``params0`` (all {layer: [tensors]})."""
    gaps = []
    for k, blobs in params0.items():
        for j, b in enumerate(blobs):
            b = b.detach().cpu().double()
            d_got = got[k][j].detach().cpu().double() - b
            d_want = want[k][j].detach().cpu().double() - b
            gaps.append(float((d_got - d_want).norm() / d_want.norm()))
    return max(gaps)


def proxy_card_vs_cpu(ck, dev) -> dict:
    """(c) the first ``PROXY_CHECK_ITERS`` iterations of the proxy's 1x run
    on the card and on the CPU from the same init and minibatches: their
    mean loss within ``PROXY_CPU_REL``, their updates within
    ``PROXY_UPDATE_REL``, and a card run with the mean one grey level off
    refused by the update bound."""
    from sparknet_tpu_torch.ops.augment import AugmentSpec
    from sparknet_tpu_torch.tools.learning_proxy import BATCH, Proxy, \
        schedule
    from sparknet_tpu_torch.utils.device import full_f32
    idxs = np.random.default_rng(5).integers(
        0, PROXY_CHECK_TRAIN, size=(PROXY_CHECK_ITERS, BATCH))
    loss, params = {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu")),
                    ("planted_mean", dev)):
        px = Proxy(schedule(PROXY_SCALE)[0], PROXY_CHECK_TRAIN, BATCH, d)
        if name == "planted_mean":
            px.spec = AugmentSpec(mean=px.spec.mean + 1)
        p = px.clone_params()
        ck.reset_launch_counts()
        with cudnn_deterministic(), full_f32():
            p, _, l = px.chunk_1x(p, px.rule.init(p), 0, idxs)
            loss[name] = float(l)
        params[name] = p
        if name == "card":
            launches = launched(ck)
            params0 = {k: [b.cpu() for b in v]
                       for k, v in px.params0.items()}
    rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    gap = update_gap(params["card"], params["cpu"], params0)
    planted = update_gap(params["planted_mean"], params["cpu"], params0)
    if not rel <= PROXY_CPU_REL:
        fail(f"learning proxy: the card's first {PROXY_CHECK_ITERS} "
             f"iterations' loss {loss['card']!r} is {rel:.3g} from the "
             f"CPU's {loss['cpu']!r} (bound {PROXY_CPU_REL})")
    if not gap <= PROXY_UPDATE_REL:
        fail(f"learning proxy: the card's update over the first "
             f"{PROXY_CHECK_ITERS} iterations is {gap:.3g} from the CPU's "
             f"at its worst leaf (bound {PROXY_UPDATE_REL})")
    if not planted > PROXY_UPDATE_REL:
        fail(f"learning proxy: a mean one grey level off reads {planted:.3g}"
             f", within the update bound {PROXY_UPDATE_REL}")
    return {"loss": loss, "rel": rel, "bound": PROXY_CPU_REL,
            "update_gap": gap, "update_bound": PROXY_UPDATE_REL,
            "planted_mean_update_gap": planted, "launches": launches}


def pool_only(n: int) -> dict:
    """Launches of ``n`` cifar10_full worker steps: its MAX pool backward,
    no LRN kernel (its LRN is WITHIN_CHANNEL)."""
    return {**want_steps(0), "max_pool_bwd": n}


def learning_proxy_runs(ck, dev, d: str) -> dict:
    """(c) the learning proxy at ``--scale 3500`` (1x, 8-way, hier) and the τ
    sweep, through their ``main``s on the card; exact launches, finite
    curves, img/s per card."""
    from sparknet_tpu_torch.parallel import comms
    from sparknet_tpu_torch.tools import learning_proxy, tausweep
    out = os.path.join(d, "proxy.json")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    rc = learning_proxy.main(["--scale", str(PROXY_SCALE), "--workers",
                              str(PROXY_WORKERS), "--out", out])
    proxy_s = time.perf_counter() - t0
    launches = launched(ck)
    with open(out) as f:
        res = json.load(f)
    curves = [res[f"curve_{t}"] for t in ("1x", "8way", "hier")]
    want = pool_only(PROXY_ITERS * (1 + 2 * PROXY_WORKERS))
    if rc != 0 or launches != want or not all(
            c and c[-1]["iter"] == PROXY_ITERS and all(
                math.isfinite(r["train_loss"]) for r in c) for c in curves):
        fail(f"learning proxy: rc {rc}, launches {launches} (want {want}), "
             f"curves {curves}")
    check = proxy_card_vs_cpu(ck, dev)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    sweep_rc = tausweep.main([
        "--taus", ",".join(map(str, SWEEP_TAUS)), "--codecs",
        ",".join(SWEEP_CODECS), "--scale", str(SWEEP_SCALE), "--workers",
        str(PROXY_WORKERS), "--out", out])
    sweep_s = time.perf_counter() - t0
    sweep_launches = launched(ck)
    with open(out) as f:
        sweep = json.load(f)["sweep"]
    cells = len(SWEEP_TAUS) * len(SWEEP_CODECS)
    want_sweep = pool_only(cells * PROXY_WORKERS * SWEEP_ITERS)
    bytes_ok = sweep["cells"][f"tau{SWEEP_TAUS[0]}_int8"][
        "exchange_bytes_per_round"] < sweep["exchange_bytes_none"]
    if sweep_rc != 0 or sweep_launches != want_sweep or \
            len(sweep["cells"]) != cells or not bytes_ok or not all(
                math.isfinite(r["train_loss"]) for c in
                sweep["cells"].values() for r in c["curve"]):
        fail(f"tausweep: rc {sweep_rc}, bands {sweep['band_ok']}, "
             f"launches {sweep_launches} (want {want_sweep}), "
             f"cells {sorted(sweep['cells'])}, int8 smaller {bytes_ok}")
    fin = res["final"]
    return {
        "device": res["device"], "seconds": proxy_s,
        "acc": {t: fin[f"acc_{t}"] for t in ("1x", "8way", "hier")},
        "img_s_per_card": {t: fin[f"img_s_{t}"]
                           for t in ("1x", "8way", "hier")},
        "wall_s": {t: fin[f"wall_s_{t}"] for t in ("1x", "8way", "hier")},
        "launches": launches, "card_vs_cpu": check,
        "sweep": {"rc": sweep_rc, "seconds": sweep_s,
                  "launches": sweep_launches,
                  "img_s_per_card": {k: c["img_s"]
                                     for k, c in sweep["cells"].items()},
                  "final_acc": {k: c["final_acc"]
                                for k, c in sweep["cells"].items()},
                  "exchange_bytes": {k: c["exchange_bytes_per_round"]
                                     for k, c in sweep["cells"].items()},
                  "band_ok": sweep["band_ok"]}}


def data_plane_and_proxy(ck, dev, smi: str, d5c: str,
                         data_path: dict) -> dict:
    """Phase 5k."""
    import tempfile
    from sparknet_tpu_torch.proto import load_net_prototxt
    t_phase = time.perf_counter()
    report = {"native": check_native(d5c)}
    with open(os.path.join(d5c, "train_val.prototxt")) as f:
        lp = load_net_prototxt(f.read()).layer[0]
    fast, a = host_feed(lp, dev, native_on=True)
    slow, b = host_feed(lp, dev, native_on=False)
    if not all(same_bits(a[k], b[k]) for k in a):
        fail("native: db_feed's first batch with the native parse and "
             "crop differs from the per-record path's")
    report["host_feed_img_s"] = {"native": fast, "per_record_numpy": slow}
    with tempfile.TemporaryDirectory(prefix="data_plane_smoke_") as d:
        report["augment"] = augment_paths(ck, dev, d, d5c, data_path)
        report["proxy"] = learning_proxy_runs(ck, dev, d)
    report["phase_s"] = time.perf_counter() - t_phase
    aug = report["augment"]
    print(f"data_plane [{smi}] " + json.dumps(report, default=str),
          flush=True)
    print(f"data_plane times [{smi}] " + json.dumps({
        "host_feed_img_s": report["host_feed_img_s"],
        "solver_ms_per_iter": {m: aug[m]["ms_per_iter"] for m in (
            "host_transform", "augment_host", "augment_device")},
        "caffe_cli_train_ms": {
            "native_transform": aug["caffe_cli_train_native_ms"],
            "earlier": aug["caffe_cli_train_earlier_ms"]},
        "proxy_img_s_per_card": report["proxy"]["img_s_per_card"],
        "proxy_acc": report["proxy"]["acc"],
        "phase_s": report["phase_s"]}), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5l: pycaffe's caffe module and the serving plane on the card:
# tools/serve.py over HTTP on full-width CaffeNet (f32) in a child, each
# row against the in-process solo reference at its padded shape, a
# registry version loaded and pinned, the SLO monitor and the beacons
# with planted faults, classify_cli --server against the local CLI, and
# caffe.Net / get_solver / NetSpec against the CPU
# ---------------------------------------------------------------------------

MODEL_5L = "caffenet"                  # the zoo model served
SERVE_SHAPES = (1, 4, 16, 64)          # the serving default
HTTP_INPUTS = 8
HTTP_LOOP_S, HTTP_CLIENTS, HTTP_WINDOW = 1.5, 4, 4
HTTP_BATCH1_REPS = 20
HTTP_ROW_TOL = 1e-6            # a served row against the solo reference
PLANTED_GOOD, PLANTED_CANARY = 5, 25   # requests to the planted server
PYCAFFE_FWD_TOL = 1e-4         # caffe.Net's deploy forward, card vs CPU
# caffe.Net's train-net diffs at batch 64 and each of get_solver's steps
# at batch 16 against an f64 run on the CPU that takes the card's own
# decisions (which units each ReLU passes, which element of each MAX
# window is its maximum): ||card - f64|| / ||f64|| a blob within
# PYCAFFE_BWD_REL, and a convolution's weight blob within LIB_ERR_FACTOR
# times the error cuDNN's backward filter shows on that geometry alone in
# the same run where that is more.  Without the decisions an f32 run sits
# up to 6.2e-3 from f64 on the CPU and on the card alike: a few near ties
# in 64 x 96 x 27 x 27 pool windows route the gradient elsewhere.
PYCAFFE_BWD_REL = 1e-3
LIB_ERR_FACTOR = 3.0
PLANTED_B3_SCALE = 1.05        # the planted fault: B3's output x 1.05
NET_TRAIN_BATCH = 64
SOLVER_5L_BATCH, SOLVER_5L_ITERS, SOLVER_5L_RECORDS = 16, 5, 48
SOLVER_5L_LOSS_REL = 1e-4      # each step's loss against the f64 step's
B2_ONLY = {"lrn_across_channels_fwd": 0, "lrn_across_channels_bwd": 0,
           "max_pool_bwd": 0}


def serve_child(out: str, argv: list[str]) -> int:
    """``python -m sparknet_tpu_torch.tools.serve`` in a process of its own
    (``--serve-child``): ``serve.main(argv)`` under deterministic cuDNN,
    then the kernels' launch counts of the whole process into ``out``
    (the kernels load from the parent's build)."""
    from sparknet_tpu_torch.ops import cuda_kernels as ck
    from sparknet_tpu_torch.tools import serve
    with cudnn_deterministic():
        rc = serve.main(argv)
    with open(out, "w") as f:
        json.dump({"rc": rc, "launches": launched(ck)}, f)
    return rc


class HttpServer:
    """A ``--serve-child`` server: started at construction, its URL from
    the ready line (``wait_ready``), SIGTERM, exit code and launch
    counts."""

    def __init__(self, d: str, name: str, argv: list[str], env: dict):
        self.name = name
        self.out = os.path.join(d, f"{name}.launches.json")
        self.err = open(os.path.join(d, f"{name}.stderr"), "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            self.command(argv), stdout=subprocess.PIPE, stderr=self.err,
            text=True, env={**os.environ, **env})

    def wait_ready(self) -> "HttpServer":
        ready = self.proc.stdout.readline().strip()
        self.ready_s = time.perf_counter() - self.t0
        if not ready.startswith("serving on http://"):
            self.proc.kill()
            self.proc.wait()
            fail(f"serve {self.name}: no ready line ({ready!r}): "
                 f"{self.stderr()[-3000:]}")
        self.url = ready.split()[2]
        return self

    def command(self, argv: list[str]) -> list[str]:
        return [sys.executable, os.path.abspath(__file__), "--serve-child",
                self.out, "--serve-args", json.dumps(argv)]

    def stderr(self) -> str:
        self.err.flush()
        self.err.seek(0)
        return self.err.read()

    def stop(self) -> dict:
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.err.close()
        if rc != 0 or not os.path.exists(self.out):
            fail(f"serve child exited {rc}")
        with open(self.out) as f:
            return json.load(f)


def row_gap(probs, ref: np.ndarray) -> float:
    return float(np.abs(np.asarray(probs, np.float32) - ref).max())


def http_closed_loop(url: str, inputs: list, refs: dict) -> dict:
    """``run_closed_loop`` over HTTP (its ``submit`` seam): every row held
    against ``refs[padded_to][i]``; the worst gap rides along."""
    from concurrent.futures import ThreadPoolExecutor
    from types import SimpleNamespace

    from sparknet_tpu_torch.classify import remote_classify
    from sparknet_tpu_torch.parallel.serving import (ServingError,
                                                     run_closed_loop)
    gaps: list[float] = []

    class Future:
        def __init__(self, fut, idx):
            self.fut, self.idx = fut, idx

        def done(self):
            return self.fut.done()

        def result(self, timeout=None):
            try:
                d = self.fut.result(timeout)
            except RuntimeError as e:       # an HTTP error, typed
                raise ServingError(str(e)) from e
            probs = np.asarray(d["probs"], np.float32)
            gaps.append(row_gap(probs, refs[d["padded_to"]][self.idx]))
            return SimpleNamespace(probs=probs, padded_to=d["padded_to"])

    with ThreadPoolExecutor(HTTP_CLIENTS * HTTP_WINDOW) as pool:
        report = run_closed_loop(
            None, MODEL_5L, inputs, clients=HTTP_CLIENTS,
            window=HTTP_WINDOW, duration_s=HTTP_LOOP_S, refs=refs,
            submit=lambda i, x: Future(pool.submit(
                remote_classify, url, MODEL_5L, x), i))
    report["max_abs_vs_solo"] = max(gaps) if gaps else float("nan")
    return report


def serve_over_http(ck, dev, smi: str, d: str, model: str,
                    weights: str) -> dict:
    """``tools/serve.py --models caffenet=W`` (f32) in a child: concurrent
    requests against the solo references, batch-1 latency, a registry
    version, the SLO verdict and the beacons, ``classify_cli --server``
    against the local CLI; then the planted server (``--slo-p99-ms
    0.001``, a ``bad_canary`` version)."""
    from sparknet_tpu_torch.classify import http_json, remote_classify
    from sparknet_tpu_torch.parallel import health
    from sparknet_tpu_torch.parallel.registry import ModelRegistry
    from sparknet_tpu_torch.parallel.serving import (LoadedModel,
                                                     ServeConfig,
                                                     solo_references,
                                                     zoo_models)
    from sparknet_tpu_torch.proto.caffemodel import (load_caffemodel,
                                                     save_caffemodel)
    from sparknet_tpu_torch.tools import classify_cli
    report: dict = {}
    # a second weight file (the last layer, fc8, halved) published as a
    # registry version
    w2 = os.path.join(d, "caffenet_v2.caffemodel")
    blobs = load_caffemodel(weights)
    last = next(reversed(blobs))
    blobs[last] = [b * 0.5 for b in blobs[last]]
    save_caffemodel(w2, blobs)
    reg_dir = os.path.join(d, "registry")
    reg = ModelRegistry(reg_dir)
    vid = reg.publish(MODEL_5L, weights=w2, slo={"p99_ms": 1000.0})
    reg.set_channels(MODEL_5L, stable=vid)
    canary = reg.publish(MODEL_5L, weights=w2, notes="planted canary")

    cfg = ServeConfig(batch_shapes=SERVE_SHAPES, dtype="f32")
    zoo = zoo_models()[MODEL_5L]
    with cudnn_deterministic():
        lm = LoadedModel(MODEL_5L, zoo(), cfg, device=dev, weights=weights)
        gen = np.random.default_rng(SEED + 17)
        inputs = [(IMAGE_STD * gen.normal(size=lm.in_shape)).astype(
            np.float32) for _ in range(HTTP_INPUTS)]
        refs = solo_references(lm, inputs)
        lm2 = LoadedModel(MODEL_5L, zoo(), cfg, device=dev, weights=w2)
        refs2 = solo_references(lm2, inputs[:1])
    del lm, lm2
    torch.cuda.empty_cache()

    beats = os.path.join(d, "beats")
    env = {"SPARKNET_REGISTRY_DIR": reg_dir, "SPARKNET_HEARTBEAT_DIR": beats,
           "SPARKNET_PROC_ID": "0", "SPARKNET_FAULT": ""}
    # both servers start now and warm up side by side
    srv = HttpServer(d, "main", [
        "--models", f"{MODEL_5L}={weights}", "--port", "0", "--dtype", "f32",
        "--shapes", ",".join(map(str, SERVE_SHAPES))], env)
    trace = os.path.join(d, "trace")
    planted = HttpServer(d, "planted", [
        "--models", f"{MODEL_5L},{MODEL_5L}@{canary}", "--port", "0",
        "--dtype", "f32", "--shapes", "1,4", "--slo-p99-ms", "0.001"], {
        "SPARKNET_REGISTRY_DIR": reg_dir, "SPARKNET_TRACE_DIR": trace,
        "SPARKNET_FAULT": f"bad_canary:{canary}",
        "SPARKNET_HEARTBEAT_DIR": ""})
    try:
        url = srv.wait_ready().url
        report["ready_s"] = srv.ready_s
        # batch-1 latency, one request at a time
        lat, infer = [], []
        for i in range(HTTP_BATCH1_REPS):
            t0 = time.perf_counter()
            r = remote_classify(url, MODEL_5L, inputs[i % HTTP_INPUTS])
            lat.append((time.perf_counter() - t0) * 1e3)
            infer.append(r["infer_ms"])
            if (r["batch_n"], r["padded_to"]) != (1, 1):
                fail(f"serve: a lone request rode {r['batch_n']}/"
                     f"{r['padded_to']}")
            gap = row_gap(r["probs"], refs[1][i % HTTP_INPUTS])
            if gap > HTTP_ROW_TOL:
                fail(f"serve: a batch-1 row {gap:.3e} from its solo "
                     f"reference")
        report["batch1_http_ms_median"] = float(np.median(lat))
        report["batch1_infer_ms_median"] = float(np.median(infer))
        # concurrent requests through run_closed_loop's submit seam
        loop = http_closed_loop(url, inputs, refs)
        report["closed_loop"] = loop
        if loop["completed"] < HTTP_INPUTS or loop["errors"]:
            fail(f"serve: closed loop over HTTP {loop}")
        if loop["max_abs_vs_solo"] > HTTP_ROW_TOL:
            fail(f"serve: a served row {loop['max_abs_vs_solo']:.3e} from "
                 f"its solo reference (bound {HTTP_ROW_TOL})")
        # the registry version: loaded over HTTP, pinned by version
        s, body = http_json(f"{url}/v1/models/load",
                            {"model": MODEL_5L, "version": vid},
                            with_status=True)
        if s != 200 or body["loaded"]["version"] != vid:
            fail(f"serve: loading version {vid}: {s} {body}")
        s, pinned = remote_classify(url, MODEL_5L, inputs[0],
                                    with_status=True, version=vid)
        s2, plain = remote_classify(url, MODEL_5L, inputs[0],
                                    with_status=True)
        if s != 200 or pinned["model"] != f"{MODEL_5L}@{vid}" or s2 != 200:
            fail(f"serve: pinned request {s} {pinned.get('model')}")
        report["version_row_vs_solo"] = row_gap(
            pinned["probs"], refs2[pinned["padded_to"]][0])
        if report["version_row_vs_solo"] > HTTP_ROW_TOL:
            fail(f"serve: the pinned version's row "
                 f"{report['version_row_vs_solo']:.3e} from its reference")
        if np.array_equal(pinned["probs"], plain["probs"]):
            fail("serve: the pinned version answered as the by-name model")
        models = http_json(f"{url}/v1/models")
        if models["models"][f"{MODEL_5L}@{vid}"]["channel"] != "stable":
            fail(f"serve: /v1/models {models}")
        # classify_cli --server against the local CLI, 10-crop JPEGs
        jpg_dir = os.path.join(d, "jpg")
        os.makedirs(jpg_dir)
        for i in range(8):
            with open(os.path.join(jpg_dir, f"imagenet_{i}.jpg"), "wb") as f:
                f.write(fixture(f"imagenet_{i}.jpg"))
        mean = os.path.join(d, "mean.npy")
        np.save(mean, np.array([104.0, 117.0, 123.0]))
        common = [jpg_dir, "--ext", "jpg", "--mean_file", mean]
        _, remote_s = run_cli(classify_cli.main, [
            common[0], os.path.join(d, "remote.npy"), "--server", url,
            "--model", MODEL_5L] + common[1:])
        ck.reset_launch_counts()
        with cudnn_deterministic():
            _, local_s = run_cli(classify_cli.main, [
                common[0], os.path.join(d, "local.npy"), "--model_def",
                model, "--pretrained_model", weights, "--device",
                str(dev)] + common[1:])
        report["launches_local_cli"] = launched(ck)
        remote = np.load(os.path.join(d, "remote.npy"))
        local = np.load(os.path.join(d, "local.npy"))
        report["cli_server_vs_local"] = float(np.abs(remote - local).max())
        report["cli_server_s"], report["cli_local_s"] = remote_s, local_s
        if (remote.argmax(1) != local.argmax(1)).any() \
                or report["cli_server_vs_local"] > CLASSIFY_TOL:
            fail(f"classify_cli --server: {report['cli_server_vs_local']:.3e}"
                 f" from the local CLI or another argmax")
        # the SLO verdict and the beacon while serving
        time.sleep(1.5)
        s, slo = http_json(f"{url}/slo", with_status=True)
        if s != 200 or slo["state"] != "ok":
            fail(f"serve: /slo {s} {slo}")
        beat = health.read_beat(beats, 0)
        if beat is None or beat.phase != "serving" \
                or beat.extras["completed"] < HTTP_BATCH1_REPS:
            fail(f"serve: beacon {beat}")
        report["beat_serving"] = {"phase": beat.phase, "round": beat.round,
                                  "completed": beat.extras["completed"]}
        hz = http_json(f"{url}/healthz")
        report["dispatches"] = hz["dispatches"]
        report["completed"] = hz["completed"]
        report["slo"] = hz["slo"]
    except BaseException:
        planted.stop()
        srv.stop()
        raise
    try:
        child = srv.stop()
        final = health.read_beat(beats, 0)
        if final is None or final.phase != "final":
            fail(f"serve: no final beat after SIGTERM ({final})")
        # every forward: 4 warm-ups a load (2 loads), each batch dispatched
        want = {"lrn_across_channels":
                2 * (len(SERVE_SHAPES) * 2 + report["dispatches"]),
                **B2_ONLY}
        if {k: child["launches"][k] for k in want} != want:
            fail(f"serve: launches {child['launches']}, want {want}")
        report["launches_child"] = child["launches"]
        want_local = {"lrn_across_channels": 2, **B2_ONLY}
        if {k: report["launches_local_cli"][k] for k in want_local} \
                != want_local:
            fail(f"classify_cli local: launches "
                 f"{report['launches_local_cli']}")
    except BaseException:
        planted.stop()
        raise
    report["planted"] = planted_server(planted, trace, inputs, canary)
    print(f"serve_http [{smi}] " + json.dumps(report, default=str),
          flush=True)
    return report


def planted_server(srv: HttpServer, trace: str, inputs: list,
                   canary: str) -> dict:
    """The planted server (``--slo-p99-ms 0.001`` with a ``bad_canary``
    version): the canary's requests fail typed (HTTP 400, no
    probabilities, never NaN), ``/slo`` reads 503 with both breaches and
    the flight recorder dumped."""
    from sparknet_tpu_torch.classify import http_json, remote_classify
    try:
        srv.wait_ready()
        time.sleep(1.2)              # samples before the traffic
        for i in range(PLANTED_GOOD):
            s, body = remote_classify(srv.url, MODEL_5L, inputs[i],
                                      with_status=True)
            if s != 200 or not np.isfinite(body["probs"]).all():
                fail(f"planted: a good request {s}")
        bad = []
        for i in range(PLANTED_CANARY):
            s, body = remote_classify(srv.url, MODEL_5L, inputs[0],
                                      with_status=True, version=canary)
            bad.append(s)
            if s != 400 or "probs" in body \
                    or "non-finite" not in body.get("error", ""):
                fail(f"planted: the canary answered {s} {body}")
        time.sleep(1.2)
        s, slo = http_json(f"{srv.url}/slo", with_status=True)
        dumps = sorted(os.listdir(trace)) if os.path.isdir(trace) else []
        hz = http_json(f"{srv.url}/healthz")
    except BaseException:
        srv.stop()
        raise
    child = srv.stop()
    if s != 503 or set(slo["breaches"]) != {"availability", "latency"}:
        fail(f"planted: /slo {s} {slo.get('breaches')} (want 503, "
             f"availability and latency)")
    if not any(n.startswith("flight_") and "slo_" in n for n in dumps):
        fail(f"planted: no flight dump of the breach in {dumps}")
    # forwards: 2 warm-ups a load (2 loads), each good and each canary
    # batch (the canary's rows are computed, then refused)
    want = {"lrn_across_channels":
            2 * (2 * 2 + hz["dispatches"] + hz["failed"]), **B2_ONLY}
    if {k: child["launches"][k] for k in want} != want:
        fail(f"planted: launches {child['launches']}, want {want}")
    # the main server's answer is unchanged by the plant
    return {"slo_status": s, "breaches": slo["breaches"],
            "flight_dumps": [n for n in dumps if n.startswith("flight_")],
            "canary_statuses": sorted(set(bad)), "failed": hz["failed"],
            "launches_child": child["launches"]}


def rel_gap(got, want) -> float:
    """||got - want|| / ||want||."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.linalg.norm(want.ravel()))
    return float(np.linalg.norm((got - want).ravel())) / (scale or 1.0)


class _Applied:
    """A layer whose ``apply`` is replaced; the rest is its impl's."""

    def __init__(self, impl, apply):
        self._impl, self.apply = impl, apply

    def __getattr__(self, name):
        return getattr(self._impl, name)


@contextlib.contextmanager
def applying(gnet, make):
    """Inside the scope each layer of a graph net whose output turns on a
    discrete choice, each ReLU (which units pass) and each MAX pool (which
    element of each window is its maximum), runs ``make(node, impl)`` as
    its ``apply``."""
    saved = [(n, n.impl) for n in gnet.nodes if n.lp.type == "ReLU" or (
        n.lp.type == "Pooling"
        and str(n.lp.sub("pooling_param").get("pool", "MAX")) == "MAX")]
    try:
        for n, impl in saved:
            n.impl = _Applied(impl, make(n, impl))
        yield
    finally:
        for n, impl in saved:
            n.impl = impl


def recorder(store: dict):
    """An ``applying`` maker: each decision node runs as it was and leaves
    a host f32 copy of what it decided on in ``store[layer]`` (a ReLU's
    top, a MAX pool's bottom)."""
    def make(node, impl):
        def apply(lp, p, bots, train, gen=None, **seam):
            tops = impl.apply(lp, p, bots, train, gen, **seam)
            src = tops[0] if lp.type == "ReLU" else bots[0]
            store[lp.name] = src.detach().float().cpu()
            return tops
        return apply
    return make


def replayer(decided: dict, flips: dict):
    """An ``applying`` maker for an f64 run: each ReLU passes the units
    ``decided[layer] > 0``, each MAX pool takes the first maximum of each
    window of ``decided[layer]``.  ``flips[layer]`` gets how many units or
    windows the f64 values themselves would decide otherwise, and the
    widest margin among them over the layer's largest |value| (a near tie
    reads ~1e-7)."""
    from sparknet_tpu_torch.ops import vision

    def make(node, impl):
        dec = decided[node.lp.name]

        def apply(lp, p, bots, train, gen=None, **seam):
            # the pool replays the recorded decisions whatever its seam
            # names
            x = bots[0]
            if lp.type == "ReLU":
                mask = (dec > 0).to(x.device)
                odd = (x.detach() > 0) != mask
                scale = float(x.detach().abs().max()) or 1.0
                flips[lp.name] = (int(odd.sum()), float(
                    x.detach()[odd].abs().max()) / scale if odd.any()
                    else 0.0)
                return [x * mask.to(x.dtype)]
            kh, kw, sh, sw, ph, pw, _ = vision._pool_geometry(
                lp, tuple(x.shape))
            oh, ow = vision.pool_output_size(x.shape[2], x.shape[3], kh, kw,
                                             sh, sw, ph, pw)
            pads = vision._pool_pads(x.shape[2], x.shape[3], kh, kw, sh, sw,
                                     ph, pw, oh, ow)

            def windows(t):          # as vision.max_pool pads and crops
                if any(pads):
                    t = F.pad(t, pads, value=-math.inf)
                return t[:, :, :(oh - 1) * sh + kh, :(ow - 1) * sw + kw]

            _, idx = F.max_pool2d(windows(dec), (kh, kw), (sh, sw),
                                  return_indices=True)
            idx = idx.to(x.device)
            xw = windows(x).flatten(2)
            n, c = x.shape[:2]
            best, own = F.max_pool2d(windows(x.detach()), (kh, kw), (sh, sw),
                                     return_indices=True)
            odd = own != idx
            taken = xw.detach().gather(2, idx.flatten(2)).view_as(best)
            scale = float(x.detach().abs().max()) or 1.0
            flips[lp.name] = (int(odd.sum()), float(
                (best - taken)[odd].max()) / scale if odd.any() else 0.0)
            return [xw.gather(2, idx.flatten(2)).view(n, c, oh, ow)]
        return apply
    return make


def conv_lib_err(lp, bottom_shape, batch: int, dev,
                 cache: dict) -> dict:
    """The error of a convolution's weight gradient, ||dW - dW_f64|| /
    ||dW_f64||, on the card through cuDNN (deterministic, TF32 off) and
    with cuDNN off, alone on this geometry at ``batch``: seeded inputs
    (x a ReLU's output, w 0.01 N(0, 1), dy N(0, 1)), f64 on the CPU."""
    from sparknet_tpu_torch.ops.vision import conv_geometry
    from sparknet_tpu_torch.utils.device import full_f32
    key = (lp.name, batch)
    if key in cache:
        return cache[key]
    kh, kw, sh, sw, ph, pw, dh, dw, nout, group, _ = conv_geometry(lp)
    xs = (batch,) + tuple(bottom_shape[1:])
    ws = (nout, xs[1] // group, kh, kw)
    g = np.random.default_rng(SEED + 29)
    x = np.maximum(g.normal(size=xs), 0).astype(np.float32)
    w = (0.01 * g.normal(size=ws)).astype(np.float32)
    args = ((sh, sw), (ph, pw), (dh, dw), group)
    with torch.no_grad():
        ys = F.conv2d(torch.from_numpy(x[:1]), torch.from_numpy(w), None,
                      *args).shape
    dy = g.normal(size=(batch,) + tuple(ys[1:])).astype(np.float32)

    def dwt(device, dtype):
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)
        return torch.nn.grad.conv2d_weight(t(x), ws, t(dy), *args
                                           ).cpu().double()

    want = dwt("cpu", torch.float64)
    out = {}
    for mode, enabled in (("cudnn", True), ("no_cudnn", False)):
        saved = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = enabled
        try:
            with full_f32(), cudnn_deterministic():
                out[mode] = rel_gap(dwt(dev, torch.float32), want)
        finally:
            torch.backends.cudnn.enabled = saved
    cache[key] = out
    return out


def blob_bounds(gaps: dict, gnet, batch: int, dev, cache: dict) -> dict:
    """Each blob's bound: PYCAFFE_BWD_REL, and for a convolution's weight
    blob LIB_ERR_FACTOR x cuDNN's own error on the layer's geometry
    (``conv_lib_err``, into ``cache``) where that is more."""
    bounds = dict.fromkeys(gaps, PYCAFFE_BWD_REL)
    for node in gnet.nodes:
        if node.lp.type == "Convolution":
            lib = conv_lib_err(node.lp, gnet.blob_shapes[node.bottoms[0]],
                               batch, dev, cache)
            key = f"{node.lp.name}[0]"
            bounds[key] = max(bounds[key], LIB_ERR_FACTOR * lib["cudnn"])
    return bounds


def beyond(gaps: dict, bounds: dict) -> dict:
    return {k: v for k, v in gaps.items() if v > bounds[k]}


def train_net_f64(net, x: np.ndarray, y: np.ndarray, decided: dict,
                  seed: int) -> tuple[dict, dict]:
    """The train net's diffs (``data`` and every param blob) in f64 on the
    CPU from ``net``'s mirrors, its Dropout masks of ``seed``, and the
    card's ReLU and MAX pool decisions; and the flips (``replayer``)."""
    g = net._net
    p = {k: [torch.tensor(b.data, dtype=torch.float64, requires_grad=True)
             for b in v] for k, v in net.params.items()}
    xx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    flips: dict = {}
    with torch.enable_grad(), applying(g, replayer(decided, flips)):
        out = g.apply_all(
            p, {"data": xx, "label": torch.tensor(y, dtype=torch.float64)},
            train=True, generator=net._layer_generators(seed), device="cpu")
        leaves = [xx] + [b for v in p.values() for b in v]
        grads = iter(torch.autograd.grad(out["loss"], leaves))
    diffs = {"data": next(grads).numpy()}
    diffs.update({f"{k}[{j}]": next(grads).numpy() for k, v in p.items()
                  for j in range(len(v))})
    return diffs, flips


def net_diffs(net) -> dict:
    out = {"data": net.blobs["data"].diff.copy()}
    out.update({f"{k}[{j}]": b.diff.copy() for k, v in net.params.items()
                for j, b in enumerate(v)})
    return out


@contextlib.contextmanager
def planted_b3():
    """The planted fault: B3 (the LRN backward kernel) scales its output
    by PLANTED_B3_SCALE."""
    from sparknet_tpu_torch.ops import vision
    bwd = vision.lrn_across_channels_bwd
    with mock.patch.object(vision, "lrn_across_channels_bwd",
                           lambda *a, **kw: PLANTED_B3_SCALE * bwd(*a, **kw)):
        yield


def pycaffe_on_card(ck, dev, smi: str, d: str, model: str,
                    weights: str) -> dict:
    """caffe.set_mode_gpu(); caffe.Net on CaffeNet's deploy net against
    the CPU's, the ms of a forward with its mirror copies; caffe.Net on
    the train net at batch 64, forward() and backward(), the diffs
    against f64 on the CPU with the card's decisions (``replayer``), and
    again with B3 planted; get_solver on a NetSpec-built CaffeNet from an
    LMDB (``get_solver_on_card``)."""
    from sparknet_tpu_torch import pycaffe_compat as caffe
    from sparknet_tpu_torch.classify import oversample, preprocess_image
    from sparknet_tpu_torch.pycaffe_io import load_image
    report: dict = {"launches": {}}
    caffe.set_mode_gpu()
    img = preprocess_image(load_image(os.path.join(FIXTURES,
                                                   "imagenet_0.jpg"),
                                      device="cpu"), (256, 256),
                           channel_swap=(2, 1, 0), raw_scale=255.0)
    with cudnn_deterministic():
        net = caffe.Net(model, weights, caffe.TEST)
        crops = oversample(img[None], net.blobs["data"].shape[-1]) \
            - np.array([104.0, 117.0, 123.0], np.float32).reshape(3, 1, 1)
        if net.device.type != "cuda":
            fail(f"caffe.set_mode_gpu(): the net is on {net.device}")
        ck.reset_launch_counts()
        out = net.forward(data=crops)["prob"].copy()
        report["launches"]["pycaffe_net_deploy_forward"] = launched(ck)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            net.forward(data=crops)
            times.append((time.perf_counter() - t0) * 1e3)
    report["deploy_forward_ms_median"] = float(np.median(times))
    report["deploy_param_mb"] = sum(
        b.data.nbytes for v in net.params.values() for b in v) / 2**20
    cpu = caffe.Net(model, weights, caffe.TEST, device="cpu")
    report["deploy_vs_cpu"] = float(np.abs(
        out - cpu.forward(data=crops)["prob"]).max())
    if report["deploy_vs_cpu"] > PYCAFFE_FWD_TOL:
        fail(f"caffe.Net deploy: {report['deploy_vs_cpu']:.3e} from the "
             f"CPU (bound {PYCAFFE_FWD_TOL})")
    want = {"lrn_across_channels": 2, **B2_ONLY}
    if report["launches"]["pycaffe_net_deploy_forward"] != {
            **want, **IMAGE_KERNELS_IDLE}:
        fail(f"caffe.Net deploy: launches "
             f"{report['launches']['pycaffe_net_deploy_forward']}")
    del net, cpu

    # the train net at batch 64: forward(), then backward() from the
    # loss, against the f64 diffs of the card's own decisions; B3 planted
    train_text = train_net_5l()
    gen = np.random.default_rng(SEED + 19)
    x = (IMAGE_STD * gen.normal(size=(NET_TRAIN_BATCH,) + crops.shape[1:])
         ).astype(np.float32)
    y = gen.integers(0, out.shape[1], NET_TRAIN_BATCH).astype(np.float32)
    net = caffe.Net(train_text, weights, caffe.TRAIN, device=dev)
    decided: dict = {}
    with cudnn_deterministic():
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(net.forward(data=x, label=y)["loss"])
        fwd_s = time.perf_counter() - t0
        report["launches"]["pycaffe_net_train_forward"] = launched(ck)
        ck.reset_launch_counts()
        net.blobs["loss"].diff[...] = 1.0
        t0 = time.perf_counter()
        net.backward()
        bwd_s = time.perf_counter() - t0
        report["launches"]["pycaffe_net_train_backward"] = launched(ck)
        card = net_diffs(net)
        # the same backward again (the same Dropout seed, deterministic
        # cuDNN: the same values), its decisions recorded
        with applying(net._net, recorder(decided)):
            net.backward()
        with planted_b3():
            net.backward()
        bad = net_diffs(net)
    t0 = time.perf_counter()
    want, flips = train_net_f64(net, x, y, decided, net._last_seed)
    f64_s = time.perf_counter() - t0
    gaps = {k: rel_gap(card[k], v) for k, v in want.items()}
    bad_gaps = {k: rel_gap(bad[k], v) for k, v in want.items()}
    lib: dict = {}
    bounds = blob_bounds(gaps, net._net, NET_TRAIN_BATCH, dev, lib)
    report["train_net"] = {
        "loss": loss, "worst_rel_vs_f64": max(gaps.values()),
        "worst_blob": max(gaps, key=gaps.get), "rel_vs_f64_by_blob": gaps,
        "bounds_beyond_default": {k: v for k, v in bounds.items()
                                  if v > PYCAFFE_BWD_REL},
        "conv_weight_grad_err": {k[0]: v for k, v in lib.items()},
        "flips_vs_f64": flips,
        "planted_b3_blobs_beyond": len(beyond(bad_gaps, bounds)),
        "planted_b3_worst": max(bad_gaps.values()),
        "forward_s": fwd_s, "backward_s": bwd_s, "f64_s": f64_s}
    if beyond(gaps, bounds):
        fail(f"caffe.Net train: diffs beyond their bounds "
             f"{beyond(gaps, bounds)}: {report['train_net']}")
    if not beyond(bad_gaps, bounds):
        fail(f"caffe.Net train: B3 x {PLANTED_B3_SCALE} passes the f64 "
             f"check ({bad_gaps})")
    want_fwd = {"lrn_across_channels": 2, **B2_ONLY, **IMAGE_KERNELS_IDLE}
    want_bwd = {"lrn_across_channels": 0, "lrn_across_channels_fwd": 2,
                "lrn_across_channels_bwd": 2, "max_pool_bwd": 3,
                **IMAGE_KERNELS_IDLE}
    if report["launches"]["pycaffe_net_train_forward"] != want_fwd \
            or report["launches"]["pycaffe_net_train_backward"] != want_bwd:
        fail(f"caffe.Net train: launches {report['launches']}")
    del net, card, bad, want, decided
    torch.cuda.empty_cache()
    report["solver"] = get_solver_on_card(ck, dev, d, weights)
    report["launches"]["pycaffe_get_solver_caffenet"] = \
        report["solver"].pop("launches")
    caffe.set_mode_gpu()
    print(f"pycaffe [{smi}] " + json.dumps(report, default=str), flush=True)
    return report


def train_net_5l() -> str:
    """CaffeNet's train net at NET_TRAIN_BATCH, its data and label fed."""
    from sparknet_tpu_torch.models import caffenet
    from sparknet_tpu_torch.proto import save_net_prototxt
    return save_net_prototxt(caffenet(NET_TRAIN_BATCH, 1))


def netspec_caffenet(caffe, source: str, batch: int) -> str:
    """CaffeNet's train net written the pycaffe way
    (caffe/examples/pycaffe/caffenet.py) over an LMDB, without Accuracy."""
    L, P = caffe.layers, caffe.params
    fixed = [dict(lr_mult=1, decay_mult=1), dict(lr_mult=2, decay_mult=0)]

    def conv_relu(bottom, ks, nout, stride=1, pad=0, group=1):
        conv = L.Convolution(bottom, kernel_size=ks, stride=stride,
                             num_output=nout, pad=pad, group=group,
                             param=fixed,
                             weight_filler=dict(type="gaussian", std=0.01),
                             bias_filler=dict(type="constant", value=0))
        return conv, L.ReLU(conv, in_place=True)

    def fc_relu(bottom, nout):
        fc = L.InnerProduct(bottom, num_output=nout, param=fixed,
                            weight_filler=dict(type="gaussian", std=0.005),
                            bias_filler=dict(type="constant", value=1))
        return fc, L.ReLU(fc, in_place=True)

    n = caffe.NetSpec()
    n.data, n.label = L.Data(source=source, backend=P.Data.LMDB,
                             batch_size=batch, ntop=2,
                             transform_param=dict(
                                 crop_size=227,
                                 mean_value=[104, 117, 123]))
    n.conv1, n.relu1 = conv_relu(n.data, 11, 96, stride=4)
    n.pool1 = L.Pooling(n.relu1, pool=P.Pooling.MAX, kernel_size=3,
                        stride=2)
    n.norm1 = L.LRN(n.pool1, local_size=5, alpha=1e-4, beta=0.75)
    n.conv2, n.relu2 = conv_relu(n.norm1, 5, 256, pad=2, group=2)
    n.pool2 = L.Pooling(n.relu2, pool=P.Pooling.MAX, kernel_size=3,
                        stride=2)
    n.norm2 = L.LRN(n.pool2, local_size=5, alpha=1e-4, beta=0.75)
    n.conv3, n.relu3 = conv_relu(n.norm2, 3, 384, pad=1)
    n.conv4, n.relu4 = conv_relu(n.relu3, 3, 384, pad=1, group=2)
    n.conv5, n.relu5 = conv_relu(n.relu4, 3, 256, pad=1, group=2)
    n.pool5 = L.Pooling(n.relu5, pool=P.Pooling.MAX, kernel_size=3,
                        stride=2)
    n.fc6, n.relu6 = fc_relu(n.pool5, 4096)
    n.drop6 = L.Dropout(n.relu6, in_place=True)
    n.fc7, n.relu7 = fc_relu(n.drop6, 4096)
    n.drop7 = L.Dropout(n.relu7, in_place=True)
    n.fc8 = L.InnerProduct(n.drop7, num_output=1000, param=fixed)
    n.loss = L.SoftmaxWithLoss(n.fc8, n.label)
    return str(n.to_proto())


def get_solver_on_card(ck, dev, d: str, deploy_weights: str) -> dict:
    """get_solver on the NetSpec-built CaffeNet over an LMDB of 256x256
    Datums (crop 227, batch 16, the published solver's lr), from the
    fillers' draw of ``random_seed`` with fc8's bias set through the
    mirrors (surgery the step must push to the Solver): 5 steps on the
    card, each step's loss and update (SGD's history, the ``v`` of
    ``p -= v``: the f32 params would round a small update to their own
    ulps) against the same step in f64 from the mirrors, the card's
    history, Dropout generator, batch and decisions, run on the card with
    the plain PyTorch versions in place of the hand kernels (on the 8
    cores of an H100 host 10 f64 steps took 23 s); the mirrors
    after the steps equal to the Solver's params; the second step again
    with B3 planted.  Then 5 steps from the deploy weights, timed, whose
    losses say why the check starts from the fillers."""
    from sparknet_tpu_torch import pycaffe_compat as caffe
    from sparknet_tpu_torch.data.db import array_to_datum
    from sparknet_tpu_torch.data.lmdb_io import write_lmdb
    db = os.path.join(d, "solver_lmdb")
    gen = np.random.default_rng(SEED + 23)
    write_lmdb(db, [(b"%08d" % i, array_to_datum(
        gen.integers(0, 256, (3, 256, 256)).astype(np.uint8), i % 1000))
        for i in range(SOLVER_5L_RECORDS)])
    fc8_bias = (0.1 * gen.normal(size=1000)).astype(np.float32)
    text = netspec_caffenet(caffe, db, SOLVER_5L_BATCH)
    with open(os.path.join(d, "netspec_train.prototxt"), "w") as f:
        f.write(text)
    path = os.path.join(d, "netspec_solver.prototxt")
    with open(path, "w") as f:
        f.write('net: "netspec_train.prototxt"\nbase_lr: 0.01\n'
                'momentum: 0.9\nweight_decay: 0.0005\nlr_policy: "fixed"\n'
                'random_seed: 5\n')

    def on_host(tree: dict) -> dict:
        return {k: [x.detach().cpu().double() for x in v]
                for k, v in tree.items()}

    def mirrors(solver) -> dict:
        return {k: [torch.from_numpy(b.data.astype(np.float64)) for b in v]
                for k, v in solver.net.params.items()}

    caffe.set_mode_gpu()
    steps = []
    with cudnn_deterministic():
        solver = caffe.get_solver(path)
        solver.net.params["fc8"][1].data[...] = fc8_bias
        inner = solver._solver
        feed = inner._train_iter

        def recorded():              # the batches the card's steps take
            for b in feed:
                steps[-1]["batch"] = {k: np.array(v) for k, v in b.items()}
                yield b

        inner.set_train_data(recorded())
        ck.reset_launch_counts()
        for t in range(SOLVER_5L_ITERS):
            steps.append({"before": mirrors(solver),
                          "history": on_host(inner.state["history"]),
                          "gen": inner.generator.get_state(),
                          "decided": {}})
            with applying(inner.train_net, recorder(steps[-1]["decided"])):
                steps[-1]["loss"] = float(solver.step(1))
        launches = launched(ck)
        history = [s["history"] for s in steps[1:]] + [
            on_host(inner.state["history"])]
        pulled = differing(mirrors(solver), on_host(inner.params))
        # B3 planted: the second step again, from its params and history
        # (the first has no gradient below fc8, whose filler is 0)
        planted = caffe.get_solver(path)
        for k, v in steps[1]["before"].items():
            for pb, b in zip(planted.net.params[k], v):
                pb.data[...] = b.numpy()
        ps = planted._solver
        ps.state = {"history": {k: [b.to(dev, torch.float32) for b in v]
                                for k, v in steps[1]["history"].items()}}
        ps.iter = 1
        ps.generator.set_state(steps[1]["gen"])
        ps.set_train_data(iter([steps[1]["batch"]]))
        with planted_b3():
            planted.step(1)
        bad = on_host(ps.state["history"])
        del planted, ps
        # from the deploy weights: the losses, and the time of a step
        solver = caffe.get_solver(path)
        solver.net.copy_from(deploy_weights)
        t0 = time.perf_counter()
        deploy_losses = [float(solver.step(1))
                         for _ in range(SOLVER_5L_ITERS)]
        ms = (time.perf_counter() - t0) * 1e3 / SOLVER_5L_ITERS
        del solver, inner, feed
    torch.cuda.empty_cache()

    # each step in f64 with the plain kernels, from the card's state and
    # decisions
    rs = caffe.get_solver(path)._solver
    t0 = time.perf_counter()
    gaps: dict = {}
    loss_rel, flips, want1 = 0.0, [], None
    for t, (s, card) in enumerate(zip(steps, history)):
        rs.params = {k: [b.to(dev) for b in v]
                     for k, v in s["before"].items()}
        rs.state = {"history": {k: [b.to(dev) for b in v]
                                for k, v in s["history"].items()}}
        rs.iter = t
        rs.generator.set_state(s["gen"])
        rs.set_train_data(iter([{k: torch.from_numpy(v).double()
                                 for k, v in s["batch"].items()}]))
        f: dict = {}
        with plain_kernels(), applying(rs.train_net,
                                       replayer(s["decided"], f)):
            loss = float(rs.step(1))
        flips.append(f)
        loss_rel = max(loss_rel, abs(s["loss"] - loss) / abs(loss))
        want = on_host(rs.state["history"])
        if t == 1:
            want1 = want
        for k, v in want.items():
            for j, w in enumerate(v):
                key = f"{k}[{j}]"
                gaps[key] = max(gaps.get(key, 0.0),
                                rel_gap(card[k][j], w.numpy()))
    gnet = rs.train_net
    del rs
    torch.cuda.empty_cache()
    f64_s = time.perf_counter() - t0
    lib: dict = {}
    bounds = blob_bounds(gaps, gnet, SOLVER_5L_BATCH, dev, lib)
    bad_gaps = {f"{k}[{j}]": rel_gap(bad[k][j], w.numpy())
                for k, v in want1.items() for j, w in enumerate(v)}
    report = {"losses_card": [s["loss"] for s in steps],
              "loss_rel_vs_f64": loss_rel,
              "update_rel_vs_f64_by_blob": gaps,
              "worst_update_rel": max(gaps.values()),
              "bounds_beyond_default": {k: v for k, v in bounds.items()
                                        if v > PYCAFFE_BWD_REL},
              "conv_weight_grad_err": {k[0]: v for k, v in lib.items()},
              "flips_vs_f64": {k: [f[k][0] for f in flips] for k in flips[0]},
              "mirrors_differ_from_solver": pulled,
              "planted_b3_blobs_beyond": len(beyond(bad_gaps, bounds)),
              "planted_b3_worst": max(bad_gaps.values()),
              "deploy_start_losses": deploy_losses,
              "ms_per_step_card": ms, "f64_s": f64_s,
              "netspec_layers": text.count("layer {"),
              "launches": launches}
    want = {"lrn_across_channels": 0,
            "lrn_across_channels_fwd": 2 * SOLVER_5L_ITERS,
            "lrn_across_channels_bwd": 2 * SOLVER_5L_ITERS,
            "max_pool_bwd": 3 * SOLVER_5L_ITERS, **IMAGE_KERNELS_IDLE}
    if launches != want:
        fail(f"get_solver: launches {launches}, want {want}")
    if loss_rel > SOLVER_5L_LOSS_REL or beyond(gaps, bounds) or pulled \
            or not np.isfinite(report["losses_card"]).all():
        fail(f"get_solver: card vs f64 loss {loss_rel:.3e}, updates "
             f"beyond their bounds {beyond(gaps, bounds)}, mirrors "
             f"differing from the Solver's params {pulled}: {report}")
    if not beyond(bad_gaps, bounds):
        fail(f"get_solver: B3 x {PLANTED_B3_SCALE} passes the f64 check "
             f"({bad_gaps})")
    return report


def serving_and_pycaffe(ck, dev, smi: str) -> dict:
    """Phase 5l."""
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serving_smoke_") as d:
        model, weights = caffenet_deploy(d)
        served = serve_over_http(ck, dev, smi, d, model, weights)
        torch.cuda.empty_cache()
        pycaffe = pycaffe_on_card(ck, dev, smi, d, model, weights)
    torch.cuda.empty_cache()
    report = {"serve": served, "pycaffe": pycaffe,
              "phase_s": time.perf_counter() - t_phase}
    loop = served["closed_loop"]
    print(f"serving_and_pycaffe times [{smi}] " + json.dumps({
        "http_batch1_ms": served["batch1_http_ms_median"],
        "http_batch1_infer_ms": served["batch1_infer_ms_median"],
        "http_closed_loop_qps": loop["achieved_qps"],
        "http_closed_loop_p50_ms": loop["p50_ms"],
        "http_closed_loop_p99_ms": loop["p99_ms"],
        "http_rows_vs_solo": loop["max_abs_vs_solo"],
        "pycaffe_forward_ms": pycaffe["deploy_forward_ms_median"],
        "get_solver_ms_per_step": pycaffe["solver"]["ms_per_step_card"],
        "phase_s": report["phase_s"]}), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5m: the fusion pass and the lowering tuner — fusebench on the card
# with planted faults, GoogLeNet trained under the committed plan against
# the same round per layer, GoogLeNet served at 64 with horizontal fusion
# on and off, and the committed tuning table's staleness check
# ---------------------------------------------------------------------------

FUSE_TAU = 2            # 5m's GoogLeNet round, 2 workers x batch 32
FUSE_SERVE_BATCH = 64
FUSE_BOUND = 1e-5       # fused against per-layer params and served rows
# horizontal fusion's step against per-layer: each blob's gradient within
# this share of its largest element.  The card reads 3.24e-5 (another
# summation order flips a few ReLU and pool branches); swapping a
# group's slices reads 2.112 in fusebench (both H100 80GB HBM3, 700 W)
HFUSE_GRAD_BOUND = 1e-3
STALENESS_BUDGET_S = 8     # 20 until phase 5p took the time


def committed_plan(model: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "sparknet_tpu_torch", "profiles", model,
                        "fusion_plan.json")


def relu_folds(model: str, plan: str | None = None) -> int:
    """How many relu+lrn chains ``model``'s train net fuses under
    ``plan`` (a plan file, else ``SPARKNET_FUSE`` as set)."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.graph import Net
    from sparknet_tpu_torch.proto import NetState, Phase
    env = {"SPARKNET_FUSE": plan} if plan else {}
    with mock.patch.dict(os.environ, env):
        net = Net(getattr(models, model)(2, 2), NetState(Phase.TRAIN))
    return sum(ch.epilogue == "relu+lrn" for ch in net._vfuse_head.values())


def fusebench_on_card(dev, d: str) -> dict:
    """``tools/fusebench.py`` on the card (f32 forward and gradients, the
    bf16 forward, horizontal fusion, the refusals), then with a planted
    epilogue that drops the ReLU fold and a planted horizontal split
    whose slices are swapped: both must fail."""
    from sparknet_tpu_torch.graph import net as netmod
    from sparknet_tpu_torch.ops import vision
    from sparknet_tpu_torch.tools import fusebench

    def run(label: str) -> tuple[int, dict]:
        out = os.path.join(d, f"fusebench_{label}.json")
        # --iters 0: its timing leg times a 14x14 net's host dispatch,
        # which moved 4.5 to 7.2 ms between two runs of one call
        rc = fusebench.main(["--device", str(dev), "--iters", "0",
                             "--out", out])
        with open(out) as f:
            return rc, json.load(f)

    rc, clean = run("clean")
    if rc != 0:
        fail(f"fusebench on the card: {clean['failures']}")
    real = vision.lrn_chain_epilogue
    with mock.patch.object(
            vision, "lrn_chain_epilogue",
            lambda x, *a, relu, **kw: real(x, *a, relu=False, **kw)):
        rc, fold = run("dropped_fold")
    if rc == 0 or "forward not bit-identical" not in fold["failures"][0]:
        fail(f"fusebench passed an epilogue without its ReLU: {fold}")
    with mock.patch.object(netmod, "_split_channels",
                           lambda y, sizes: tuple(reversed(
                               torch.split(y, list(sizes), dim=1)))):
        rc, swap = run("swapped_slices")
    if rc == 0 or "horizontal fusion" not in swap["failures"][0]:
        fail(f"fusebench passed swapped horizontal slices: {swap}")
    return {"clean": clean, "planted_refused": {
        "dropped_fold": fold["failures"], "swapped_slices": swap["failures"]}}


def googlenet_fused_round(ck, dev) -> dict:
    """GoogLeNet's round (2 workers x batch 32, τ=2) under the committed
    plan against the same round unfused (``SPARKNET_FUSE=off``, the same
    horizontal groups): the first forward bit for bit, every master
    param within FUSE_BOUND (max|Δ|/max|ref| per blob; the chains run the
    same arithmetic, so they come out equal), exact launches (the
    relu+lrn chain's under the ``_relu`` keys).  Horizontal fusion
    against per-layer (``SPARKNET_NO_HFUSE=1``) on one step: the loss
    within FUSE_BOUND, each blob's gradient within HFUSE_GRAD_BOUND of
    its largest element, so a gradient sent to the wrong member of a
    group fails at full width.  The wider convolution sums in another
    order, and where a ReLU input or a pool window's two largest values
    lie within that rounding of each other the gradient takes the other
    branch: on the CPU one step moved a few
    elements of inception_4e/3x3_reduce's gradient by 3.9e-3 of the
    blob's largest, the loss by 9.5e-8.  Deterministic cuDNN, TF32 off."""
    from sparknet_tpu_torch.apps.imagenet_app import SOLVER
    from sparknet_tpu_torch.graph import Net
    from sparknet_tpu_torch.models import googlenet
    from sparknet_tpu_torch.proto import (NetState, Phase,
                                          load_solver_prototxt_with_net)
    from sparknet_tpu_torch.utils.device import full_f32
    plan = committed_plan("googlenet")
    folds = relu_folds("googlenet", plan)
    if folds < 1:
        fail(f"5m: the committed GoogLeNet plan {plan} folds no ReLU")
    netp = googlenet(GN_BATCH, GN_BATCH, crop=GN_CROP)
    sp = load_solver_prototxt_with_net(SOLVER, netp)
    batches = image_batches(SEED + 11, 2 * GN_BATCH, GN_CROP, 1000,
                            tau=FUSE_TAU)
    steps = 2 * FUSE_TAU
    rounds, launches = {}, {}
    with cudnn_deterministic(), full_f32():
        for label, fuse in (("fused", plan), ("unfused", "off")):
            with mock.patch.dict(os.environ, {"SPARKNET_FUSE": fuse}):
                ck.reset_launch_counts()
                rounds[label] = one_round(sp, batches, dev)
                torch.cuda.synchronize()
                launches[label] = launched(ck)
        inputs = {"data": torch.from_numpy(
            batches["data"][0, :GN_BATCH]).to(dev), "label":
            torch.from_numpy(batches["label"][0, :GN_BATCH]).to(dev)}
        steps_of, params = {}, None
        for label, env in (("plan", {"SPARKNET_FUSE": plan}),
                           ("unfused", {"SPARKNET_FUSE": "off"}),
                           ("per_layer", {"SPARKNET_FUSE": "off",
                                          "SPARKNET_NO_HFUSE": "1"})):
            with mock.patch.dict(os.environ, env):
                net = Net(netp, NetState(Phase.TRAIN))
            params = params or net.init(torch.Generator().manual_seed(SEED),
                                        device=dev)
            p = {k: [b.detach().clone().requires_grad_(True) for b in v]
                 for k, v in params.items()}
            loss = net.forward(p, inputs, generator=torch.Generator(
            ).manual_seed(SEED)).loss
            loss.backward()
            steps_of[label] = (loss.detach(), {
                k: [b.grad.cpu().double() for b in v] for k, v in p.items()})
            del p, net
    want = {"fused": folded({
                **IMAGE_KERNELS_IDLE,
                "lrn_across_channels_fwd": (2 - folds) * steps,
                "lrn_across_channels_bwd": (2 - folds) * steps,
                "lrn_across_channels_fwd_relu": folds * steps,
                "lrn_across_channels_bwd_relu": folds * steps,
                "max_pool_bwd": 13 * steps, "lrn_across_channels": 0}),
            "unfused": {**IMAGE_KERNELS_IDLE,
                        "lrn_across_channels_fwd": 2 * steps,
                        "lrn_across_channels_bwd": 2 * steps,
                        "max_pool_bwd": 13 * steps,
                        "lrn_across_channels": 0}}
    if launches != want:
        fail(f"5m GoogLeNet round launches {launches}, want {want}")
    errs = rel_errors(rounds["fused"][1], rounds["unfused"][1])
    worst = max(errs.values())
    hgrad = rel_errors(steps_of["plan"][1], steps_of["per_layer"][1])
    hloss = abs(float(steps_of["plan"][0] - steps_of["per_layer"][0])) / \
        abs(float(steps_of["per_layer"][0]))
    if worst > FUSE_BOUND or not torch.equal(steps_of["plan"][0],
                                             steps_of["unfused"][0]):
        fail(f"5m GoogLeNet: fused params {worst:.3e} from unfused "
             f"(bound {FUSE_BOUND}); first forward "
             f"{float(steps_of['plan'][0])!r} vs "
             f"{float(steps_of['unfused'][0])!r}")
    hworst = max(hgrad.values())
    if hloss > FUSE_BOUND or hworst > HFUSE_GRAD_BOUND:
        fail(f"5m GoogLeNet: horizontal fusion's loss {hloss:.3e} from "
             f"per-layer (bound {FUSE_BOUND}), gradients {hworst:.3e} "
             f"(bound {HFUSE_GRAD_BOUND}, worst "
             f"{max(hgrad, key=hgrad.get)})")
    return {"plan": plan, "relu_folds": folds, "launches": launches,
            "losses": {k: v[0] for k, v in rounds.items()},
            "params_max_rel": worst,
            "hfuse_step": {"loss_rel": hloss,
                           "grad_max_rel": hworst,
                           "grad_top": dict(sorted(
                               hgrad.items(), key=lambda kv: -kv[1])[:3])},
            "first_forward_loss": float(steps_of["plan"][0])}


def googlenet_served_hfuse(ck, dev, smi: str) -> dict:
    """GoogLeNet's deploy net loaded through ``ModelHouse`` at batch 64,
    f32, under the committed plan (its conv2 chain folds the ReLU into
    B2), with horizontal fusion on and off: the rows within FUSE_BOUND
    of each other, each forward's device ms and launches."""
    from sparknet_tpu_torch.parallel.serving import ModelHouse, ServeConfig
    gen = np.random.default_rng(SEED + 12)
    batch = (IMAGE_STD * gen.normal(size=(FUSE_SERVE_BATCH, 3, GN_CROP,
                                          GN_CROP))).astype(np.float32)
    folds = relu_folds("googlenet", committed_plan("googlenet"))
    out = {}
    with cudnn_deterministic():
        for label, env in (("hfuse", {}), ("no_hfuse",
                                           {"SPARKNET_NO_HFUSE": "1"})):
            with mock.patch.dict(os.environ, {
                    "SPARKNET_FUSE": committed_plan("googlenet"), **env}):
                lm = ModelHouse(ServeConfig(
                    dtype="f32", batch_shapes=(FUSE_SERVE_BATCH,),
                    seed=SEED), device=dev).load("googlenet")
            ck.reset_launch_counts()
            rows = lm.infer(batch)
            torch.cuda.synchronize()
            out[label] = {"rows": rows, "launches": launched(ck),
                          "groups": len(lm.net._hfuse_first)
                          if lm.net._hfuse_enabled else 0,
                          "device_ms": device_forward_ms(
                              lm, FUSE_SERVE_BATCH, 10)}
            del lm
    want = {**IMAGE_KERNELS_IDLE, "lrn_across_channels_fwd": 0,
            "lrn_across_channels_bwd": 0, "max_pool_bwd": 0,
            "lrn_across_channels": 2 - folds,
            "lrn_across_channels_relu": folds}
    a, b = out["hfuse"]["rows"], out["no_hfuse"]["rows"]
    gap = float(np.abs(a - b).max() / np.abs(b).max())
    if any(r["launches"] != want for r in out.values()) or \
            gap > FUSE_BOUND or out["hfuse"]["groups"] != 9:
        fail(f"5m served GoogLeNet: rows {gap:.3e} apart (bound "
             f"{FUSE_BOUND}), launches "
             f"{[r['launches'] for r in out.values()]}, want {want}, "
             f"groups {out['hfuse']['groups']}")
    report = {"rows_max_rel": gap, **{
        k: {kk: v for kk, v in r.items() if kk != "rows"}
        for k, r in out.items()}}
    print(f"fused_serving [{smi}] " + json.dumps(report), flush=True)
    return report


def fusion_on_card(ck, dev, smi: str) -> dict:
    """Phase 5m."""
    import tempfile
    from sparknet_tpu_torch.tools import tune
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fusion_5m_") as d:
        report = {"fusebench": fusebench_on_card(dev, d)}
        report["train"] = googlenet_fused_round(ck, dev)
        report["serve"] = googlenet_served_hfuse(ck, dev, smi)
        stale = os.path.join(d, "staleness.json")
        rc = tune.main(["staleness", "--budget-s", str(STALENESS_BUDGET_S),
                        "--device", str(dev), "--json", stale])
        with open(stale) as f:
            st = json.load(f)
    if rc != 0 or not st["ok"] or not st["checked"]:
        fail(f"5m: the committed tuning table's staleness check: rc {rc}, "
             f"{st['rotten']}")
    report["staleness"] = {k: st[k] for k in ("ok", "checked",
                                               "total_entries", "budget_s")}
    report["phase_s"] = time.perf_counter() - t0
    print(f"fusion [{smi}] " + json.dumps({
        "fusebench": {k: report["fusebench"]["clean"].get(k) for k in (
            "plan_id", "grad_max_rel", "hfuse_loss_rel",
            "hfuse_grad_max_rel")},
        "planted_refused": report["fusebench"]["planted_refused"],
        "train": report["train"], "staleness": report["staleness"],
        "phase_s": report["phase_s"]}), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5n: the rest of the observability and bench plane
# ---------------------------------------------------------------------------

# perf_probe at the main path's shapes (GoogLeNet's 13 pools and the four
# LRN shapes at 32, f32; the census on CaffeNet's step at 256), its
# blocks cut to 10 ms (the tool's default is 2 s; the script took 1,093 s
# on PR 19's call 11 with 20 ms blocks, 1 s serveload points and a 3 s
# feedbench serial leg)
PROBE_ENV = {"PROBE_TARGET_S": "0.01", "PROBE_REPS": "3",
             "PROBE_POOL_BATCH": str(GN_BATCH), "PROBE_DTYPE": "f32",
             "PROBE_LRN_BATCH": str(GN_BATCH), "PROBE_LRN_DTYPE": "f32",
             "PROBE_BATCH": "256"}
# serveload on CaffeNet's deploy net: 0.5 s points (the tool's 2), the
# bench's fractions, overload at 2x
SERVELOAD_5N = dict(model="caffenet", dtype="f32", seconds=0.5,
                    fractions=(0.5, 1.0), overload_x=2.0)
SERVELOAD_INPUTS = 32           # run_report's default pool
CAPTURE_MS = 300
FEEDBENCH_S = 4.0
B2_KERNEL = r"lrn_fwd(_generic)?_kernel"
NO_LAUNCHES = want_steps(0)


def counted(ck, fn):
    """(``fn()``, the kernels' launches during it): the counts set to 0
    just before it and read just after."""
    ck.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launched(ck)


def probe_part(ck, dev, part: str) -> tuple[list[dict], dict, dict]:
    """One perf_probe part on the card: (its records, its returned
    record, the launches during it)."""
    import io
    from sparknet_tpu_torch.tools import perf_probe
    buf = io.StringIO()
    try:
        with mock.patch.dict(os.environ, PROBE_ENV), \
                contextlib.redirect_stdout(buf):
            rec, got = counted(ck, lambda: perf_probe.PARTS[part](dev))
    except RuntimeError as e:
        fail(f"5n perf_probe {part}: {e}")
    recs = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    bad = [r for r in recs if "skipped" in r or r.get("collapsed")]
    if bad:
        fail(f"5n perf_probe {part}: skipped or collapsed blocks {bad}")
    return recs, rec, got


def calls_of(recs: list[dict], pattern: str) -> int:
    return sum(r["calls"] for r in recs if re.fullmatch(pattern, r["exp"]))


def probe_on_card(ck, dev, smi: str) -> dict:
    """``perf_probe poolbwd``, ``lrn`` and ``hlo`` on the card: every
    variant held against the plain version before timing (inside the
    tool: pool dx bit for bit, LRN within rtol 1e-4 in f32), no skipped
    or collapsed block, and each kernel launched exactly once a kernel
    call the tool made (its checks and every timed call)."""
    from sparknet_tpu_torch.tools import perf_probe
    recs, total, got = probe_part(ck, dev, "poolbwd")
    pools = len(perf_probe.GOOGLENET_POOLS)
    want = {**NO_LAUNCHES,
            "max_pool_bwd": pools + calls_of(recs, r"poolbwd_.*_pallas")}
    if got != want:
        fail(f"5n perf_probe poolbwd: launches {got}, want {want}")
    launches = {"perf_probe_poolbwd_googlenet_b32_5n": got}
    per_pool = {r["exp"]: r["ms_per_iter"] for r in recs
                if r["exp"].startswith("poolbwd_") and "ms_per_iter" in r}
    lrecs, verdict, got = probe_part(ck, dev, "lrn")
    shapes = len(perf_probe.lrn_shapes())
    fb = shapes + calls_of(lrecs, r"lrn_.*_cuda_fwdbwd")
    want = {**NO_LAUNCHES,
            "lrn_across_channels": shapes + calls_of(lrecs,
                                                     r"lrn_.*_cuda_fwd"),
            "lrn_across_channels_fwd": fb, "lrn_across_channels_bwd": fb}
    if got != want:
        fail(f"5n perf_probe lrn: launches {got}, want {want}")
    launches["perf_probe_lrn_b32_5n"] = got
    per_lrn = {r["exp"]: r["ms_per_iter"] for r in lrecs
               if r["exp"].startswith("lrn_") and "ms_per_iter" in r}
    _, census, got = probe_part(ck, dev, "hlo")
    if got != want_steps(2) or not census["layout_kernels"]:
        fail(f"5n perf_probe hlo: launches {got}, census {census}")
    launches["perf_probe_hlo_caffenet_b256_5n"] = got
    report = {"poolbwd_total": total, "poolbwd_ms": per_pool,
              "lrn_ms": per_lrn, "lrn_verdict": verdict["per_shape"],
              "census": {k: census[k] for k in (
                  "device_ms", "layout_kernels", "layout_kernel_ms",
                  "layout_ops",
                  "layout_bytes_mb", "n_lines")},
              "launches": launches}
    print(f"perf_probe_5n [{smi}] " + json.dumps(
        {k: v for k, v in report.items() if k != "launches"}), flush=True)
    return report


def serveload_on_card(ck, dev, smi: str) -> dict:
    """``tools/serveload`` on CaffeNet's deploy net in f32: every served
    answer bit for bit its solo reference (saturation, the sweep at 0.5x
    and 1x, overload at 2x), the overload rejecting with its p99 under
    the bound, the SLO monitor ok after the sweep and in breach with a
    flight dump under overload, B2 twice a forward; then with one
    reference one ulp off, which the gate must catch."""
    from sparknet_tpu_torch.parallel import serving
    from sparknet_tpu_torch.tools import serveload
    with cudnn_deterministic():
        rep, got = counted(ck, lambda: serveload.run_report(
            **SERVELOAD_5N, device=dev))
    shapes = rep["batch_shapes"]
    forwards = (len(shapes) + len(shapes) * SERVELOAD_INPUTS + 1
                + rep["batch1"]["dispatches"]
                + rep["engine_stats"]["dispatches"])
    want = want_steps(0, forwards)
    bad = serveload.smoke_failures(rep)
    if bad or got != want or rep["device"] != f"cuda/{CARD}" or \
            [p["fraction_of_saturation"] for p in rep["sweep"]] != \
            [0.5, 1.0] or rep["slo_overload"]["flight_dumps"] < 1:
        fail(f"5n serveload: {bad}, launches {got} (want {want}), "
             f"verdicts {rep['verdicts']}")
    solo = serving.solo_references

    def one_ulp_off(lm, inputs):
        refs = solo(lm, inputs)
        for by_idx in refs.values():
            by_idx[0][0] = np.nextafter(by_idx[0][0], np.float32(np.inf))
        return refs

    with mock.patch.object(serving, "solo_references", one_ulp_off), \
            cudnn_deterministic():
        planted = serveload.run_report(
            **{**SERVELOAD_5N, "seconds": 0.3, "fractions": (0.5,)},
            shapes=(1, 4), inputs_n=8, device=dev)
    if not planted["verdicts"]["exact_mismatches"] or \
            not serveload.smoke_failures(planted):
        fail(f"5n serveload: an answer one ulp off passed: "
             f"{planted['verdicts']}")
    report = {k: rep[k] for k in ("p99_bound_ms", "verdicts", "device")}
    report.update({
        leg: {k: rep[leg][k] for k in (
            "offered_qps", "achieved_qps", "p50_ms", "p99_ms", "rejected",
            "completed", "exact_mismatches")}
        for leg in ("batch1", "saturation", "overload")})
    report["sweep"] = [{k: p[k] for k in (
        "fraction_of_saturation", "offered_qps", "achieved_qps", "p50_ms",
        "p99_ms", "rejected", "completed", "exact_mismatches")}
        for p in rep["sweep"]]
    report["slo"] = {leg: rep[leg]["state"] for leg in ("slo_paced",
                                                        "slo_overload")}
    report["planted_mismatches"] = planted["verdicts"]["exact_mismatches"]
    report["launches"] = {"serveload_caffenet_f32_5n": got}
    print(f"serveload_5n [{smi}] " + json.dumps(
        {k: v for k, v in report.items() if k != "launches"}), flush=True)
    return report


def capture_on_card(ck, dev, smi: str) -> dict:
    """One profiler-server capture while the engine serves CaffeNet
    batches in f32: the trace names the inference LRN kernel (B2) and the
    serving thread's ``L[norm1]`` range."""
    import threading
    from sparknet_tpu_torch.parallel.serving import (InferenceEngine,
                                                     ModelHouse, ServeConfig)
    from sparknet_tpu_torch.utils import profiling
    cfg = ServeConfig(batch_shapes=(1, 4), max_delay_ms=1.0, dtype="f32")
    gen = np.random.default_rng(SEED + 19)
    stop = threading.Event()
    ck.reset_launch_counts()
    house = ModelHouse(cfg, device=dev)
    lm = house.load("caffenet")
    x = (IMAGE_STD * gen.normal(size=lm.in_shape)).astype(np.float32)
    with InferenceEngine(house, cfg) as eng, profiling.server(0) as srv:
        def load():
            while not stop.is_set():
                eng.classify("caffenet", x)
        t = threading.Thread(target=load, daemon=True)
        t.start()
        try:
            doc = profiling.fetch_capture(srv.url, CAPTURE_MS)
        finally:
            stop.set()
            t.join(timeout=60)
        dispatches = eng.stats()["dispatches"]
    torch.cuda.synchronize()
    got = launched(ck)
    want = want_steps(0, len(cfg.batch_shapes) + dispatches)
    names = {e.get("name") for e in doc["traceEvents"] if e.get("name")}
    b2 = sorted(n for n in names if re.search(B2_KERNEL, n))
    if not b2 or "L[norm1]" not in names or got != want or \
            not doc["otherData"]["all_threads"]:
        cats = collections.Counter(e.get("cat") for e in doc["traceEvents"])
        fail(f"5n profiler capture: B2 kernels {b2}, L[norm1] "
             f"{'L[norm1]' in names}, all threads "
             f"{doc['otherData'].get('all_threads')}, launches {got} "
             f"(want {want}), events by category {dict(cats)}")
    report = {"events": len(doc["traceEvents"]), "b2_kernels": b2,
              "layers": sorted(n for n in names if n.startswith("L[")),
              "launches": {"profiler_capture_caffenet_f32_5n": got}}
    print(f"capture_5n [{smi}] " + json.dumps(
        {k: v for k, v in report.items() if k != "launches"}), flush=True)
    return report


def planted_shard_fails_check(d: str) -> None:
    """Two ranks' shards from the port's tracer pass ``obs merge
    --check``; one span stripped of its run id must fail it."""
    import io
    from sparknet_tpu_torch.tools import obs
    from sparknet_tpu_torch.utils import telemetry
    for rank in (0, 1):
        with mock.patch.dict(os.environ, {
                "SPARKNET_RUN_ID": "planted", "SPARKNET_TELEMETRY_RANK":
                str(rank)}):
            tr = telemetry.Tracer(os.path.join(d, f"r{rank}"))
            tr.complete("trainer.round", "trainer", time.time() * 1e6, 10.0)
            tr.flush()
    argv = ["merge", d, "--check", "--expect-ranks", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        clean = obs.main(argv)
        shard = [os.path.join(d, "r1", f) for f in os.listdir(
            os.path.join(d, "r1")) if f.startswith("trace_")][0]
        with open(shard) as f:
            lines = f.read().splitlines()
        ev = json.loads(lines[-1])
        del ev["args"]["run"]
        lines[-1] = json.dumps(ev)
        with open(shard, "w") as f:
            f.write("\n".join(lines) + "\n")
        planted = obs.main(argv)
    if clean != 0 or planted != 1:
        fail(f"5n obs merge --check: clean shards rc {clean}, a span "
             f"without its run id rc {planted}")


def observability_and_bench(ck, dev, smi: str, d5c: str) -> dict:
    """Phase 5n."""
    import io
    import tempfile
    from sparknet_tpu_torch.tools import feedbench
    from sparknet_tpu_torch.tools import knobs as knobs_tool
    from sparknet_tpu_torch.tools import obs, roundbench
    from sparknet_tpu_torch.utils import checkpoint
    t0 = time.perf_counter()
    seconds: dict = {}

    def lap(name: str) -> None:
        seconds[name] = round(time.perf_counter() - t0 - sum(
            seconds.values()), 1)
        print(f"5n {name}: {seconds[name]} s", flush=True)

    report = {"probe": probe_on_card(ck, dev, smi)}
    lap("perf_probe")
    report["serveload"] = serveload_on_card(ck, dev, smi)
    lap("serveload")
    report["capture"] = capture_on_card(ck, dev, smi)
    lap("capture")
    # 2 s of serial leg (the tool's default 1): enough batches of 5c's
    # 256x256 Datums that the cold pass streams past the 2 RAM shards
    # and the warm pass reads the disk tier
    fb, got = counted(ck, lambda: feedbench.run(
        os.path.join(d5c, "train_lmdb"), seconds=FEEDBENCH_S,
        records=DB_TRAIN, records_leg=True, device=dev))
    if fb["cache_warm"]["cache_disk_hits"] < 1:
        fail(f"5n feedbench: the disk tier never served ({fb})")
    if not fb["ok"] or got != NO_LAUNCHES:
        fail(f"5n feedbench --records-leg over 5c's LMDB: {fb['errors']}, "
             f"launches {got}")
    report["feedbench"] = {k: v for k, v in fb.items() if k != "errors"}
    lap("feedbench")
    # roundbench at its defaults: 4 lenet workers (2 pools each), τ=2,
    # 6 rounds, both loops
    rb, got = counted(ck, lambda: roundbench.run(device=dev))
    want = {**NO_LAUNCHES, "max_pool_bwd": 2 * 4 * roundbench.TAU * 6 * 2}
    if not rb["ok"] or got != want:
        fail(f"5n roundbench: {rb['failures']}, launches {got} (want "
             f"{want})")
    snap = checkpoint.snapshot_tree
    with mock.patch.object(checkpoint, "snapshot_tree", lambda tree: snap(
            {k: v for k, v in tree.items() if k != "torch_generators"})):
        planted = roundbench.run(rounds=2, devices=2, device=dev)
    if planted["ok"] or not any("'torch_generators'" in f
                                for f in planted["failures"]):
        fail(f"5n roundbench: an async checkpoint without its generator "
             f"states passed: {planted['failures']}")
    report["roundbench"] = {k: rb[k] for k in (
        "sync", "async", "stall_total_sync_s", "stall_total_async_s")}
    lap("roundbench")
    with tempfile.TemporaryDirectory(prefix="obs_5n_") as d:
        verdict_path = os.path.join(d, "verdict.json")
        with contextlib.redirect_stdout(sys.stderr):
            rc = obs.main(["smoke", "--device", str(dev), "--out",
                           verdict_path])
        with open(verdict_path) as f:
            verdict = json.load(f)
        if rc != 0 or not verdict["ok"]:
            fail(f"5n obs smoke: rc {rc}, {verdict['failures']}")
        planted_shard_fails_check(os.path.join(d, "planted"))
    report["obs_smoke"] = {k: verdict[k] for k in (
        "ranks", "spans", "metrics_families", "elapsed_s")}
    lap("obs_smoke")
    sink = io.StringIO()
    with contextlib.redirect_stdout(sink):
        rc = knobs_tool.main(["--check"])
    if rc != 0:
        fail(f"5n tools/knobs --check: {sink.getvalue()}")
    lap("knobs")
    report["launches"] = {**report["probe"]["launches"],
                          **report["serveload"]["launches"],
                          **report["capture"]["launches"],
                          "feedbench_records_5n": NO_LAUNCHES,
                          "roundbench_lenet_5n": want}
    report["phase_s"] = time.perf_counter() - t0
    report["seconds"] = seconds
    print(f"observability [{smi}] " + json.dumps(
        {k: report[k] for k in ("feedbench", "roundbench", "obs_smoke",
                                "phase_s", "seconds")}), flush=True)
    return report


# ---------------------------------------------------------------------------
# Phase 5o: the fleet on one card.  (a) ``tools/serve.py --fleet 2`` on
# CaffeNet f32 in a child: its two replicas placed by the fleet scheduler,
# every answer through the router bit for bit its solo reference; (b)
# serveload's fleet legs on CaffeNet (a replica SIGKILLed under load,
# healed, a drain-based scale-down); (c) a lenet training tenant (2
# workers) preempted at round 2 by a higher-priority job, requeued and
# resumed, bit for bit an unpreempted run; (d) a CaffeNet rollout at
# canary fraction 0.25, promoted, then a planted bad canary rolled back.
# (c) runs last, alone, so that no training overlaps the timed legs of
# the others.  Every replica and driver is a ``--fleet-child`` of this
# script that writes its own launch counts when it exits cleanly.
# ---------------------------------------------------------------------------

FLEET_MODEL = "caffenet"                # full width, f32
FLEET_SHAPES = SERVE_SHAPES             # (a)'s replicas
FLEET_REQUESTS, FLEET_INPUTS, FLEET_CLIENTS = 64, 8, 4
FLEET_SPILL_DEPTH = "2"                 # (a): both replicas take requests
# (b): the JAX tool's legs at 1 s points, 2 replicas in a budget of 3, no
# bystander model (the isolation leg needs a fourth replica start)
FLEET_REPORT_5O = dict(model=FLEET_MODEL, replicas=2, devices=3,
                       shapes=(1, 16), dtype="f32", clients=4,
                       seconds=1.0, inputs_n=8, isolation_model=None)
LENET_WORLD, LENET_ROUNDS, LENET_TAU = 2, 4, 2   # the driver's τ
LENET_POOLS = 2                          # lenet's MAX pools
# (c): the tenant sleeps 3 s at the start of round 2, the window in which
# the higher-priority job arrives and preempts it
LENET_FAULT = "straggle:3s@round:2"
ROLLOUT_SHAPES = (1, 4)
ROLLOUT_FRACTION = 0.25
PLANTED_CANARY_SCALE = 1.01             # (d): the bad canary's weights
FLEET_B2_ONLY = {"lrn_across_channels_fwd": 0, "lrn_across_channels_bwd": 0,
                 "max_pool_bwd": 0}
FLEET_POOL_ONLY = {"lrn_across_channels": 0, "lrn_across_channels_fwd": 0,
                   "lrn_across_channels_bwd": 0}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def child_command(kind: str, outdir: str) -> list[str]:
    """The argv prefix of a ``--fleet-child`` of this script; the tool's
    own arguments follow it."""
    return [sys.executable, os.path.abspath(__file__), "--fleet-child",
            kind, outdir, "--"]


def fleet_child(kind: str, outdir: str, argv: list[str]) -> int:
    """A process the fleet starts (``--fleet-child``), under
    deterministic cuDNN: ``front`` runs ``serve.main(argv)`` with the
    fleet's replica command pointed back here, ``serve`` a replica,
    ``driver`` the lenet driver (``driver-planted`` feeds round r the
    batch of round r + 1).  Each writes its kernels' launch counts, and
    what it did (a replica's warm-ups and dispatched batches, a driver's
    rounds), into ``outdir`` when it exits cleanly; a killed process
    writes nothing."""
    from sparknet_tpu_torch.ops import cuda_kernels as ck
    from sparknet_tpu_torch.parallel import fleet, serving, trainer
    from sparknet_tpu_torch.tools import multihost_driver, serve
    record: dict = {"kind": kind, "pid": os.getpid(),
                    "job": os.environ.get("SPARKNET_FLEET_JOB")}
    engines, houses, rounds, trained = [], [], [0], [0]
    if kind == "front":
        fleet.SERVE_CMD = child_command("serve", outdir)
        main_fn = serve.main
    elif kind == "serve":
        class Engine(serving.InferenceEngine):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                engines.append(self)

        class House(serving.ModelHouse):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                houses.append(self)

        serving.InferenceEngine, serving.ModelHouse = Engine, House
        main_fn = serve.main
    else:
        real_round = trainer.DistributedTrainer.train_round

        def counted_round(self, batches):
            rounds[0] += 1
            trips = self.audit_trips
            out = real_round(self, batches)
            # a round the audit dropped before it ran launched nothing
            trained[0] += self.audit_trips == trips
            return out

        trainer.DistributedTrainer.train_round = counted_round
        if kind == "driver-planted":
            real_batch = multihost_driver.round_batch
            multihost_driver.round_batch = \
                lambda r, tau, gb: real_batch(r + 1, tau, gb)
        main_fn = multihost_driver.main
    with cudnn_deterministic():
        rc = main_fn(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    record.update(rc=rc, launches=launched(ck))
    if kind == "serve":
        record["warmups"] = sum(len(h.cfg.batch_shapes) * len(h.loaded())
                                for h in houses)
        record["dispatches"] = sum(e.stats()["dispatches"] for e in engines)
    elif kind.startswith("driver"):
        record["rounds"] = rounds[0]
        record["trained"] = trained[0]
        record["workers"] = int(argv[argv.index("--local-devices") + 1])
    with open(os.path.join(outdir, f"{kind}-{os.getpid()}.json"), "w") as f:
        json.dump(record, f)
    return rc


def child_records(outdir: str, kind: str) -> list[dict]:
    out = []
    for name in sorted(os.listdir(outdir)):
        if re.fullmatch(rf"{re.escape(kind)}-\d+\.json", name):
            with open(os.path.join(outdir, name)) as f:
                out.append(json.load(f))
    return out


def replica_launches(recs: list[dict], what: str) -> dict:
    """B2 twice a forward in every cleanly exited replica: its warm-ups
    and its dispatched batches; the other kernels never."""
    total = dict(FLEET_B2_ONLY, lrn_across_channels=0)
    for r in recs:
        want = {"lrn_across_channels": 2 * (r["warmups"] + r["dispatches"]),
                **FLEET_B2_ONLY}
        got = {k: r["launches"][k] for k in want}
        if r["rc"] != 0 or got != want or not r["warmups"]:
            fail(f"5o {what}: replica pid {r['pid']} ({r['job']}) rc "
                 f"{r['rc']}, launches {got}, want {want}")
        for k, v in got.items():
            total[k] += v
    return total


def journal_pids(workdir: str) -> dict:
    """Every worker pid the fleet journal recorded, with its job."""
    from sparknet_tpu_torch.parallel.fleet import FleetJournal
    pids: dict = {}
    for ev in FleetJournal.read(os.path.join(workdir,
                                             "fleet_journal.jsonl")):
        if ev.get("ev") == "pids":
            for p in ev.get("pids", []):
                pids[p] = ev["job"]
    return pids


def fleet_orphans(workdir: str) -> list[int]:
    """The recorded worker pids still alive with their job's tag."""
    from sparknet_tpu_torch.parallel.fleet import _pid_is_fleet_job
    return sorted(p for p, job in journal_pids(workdir).items()
                  if _pid_is_fleet_job(p, job))


def fleet_env(**extra: str) -> dict:
    """The children's environment: the parent's without its
    ``SPARKNET_*`` knobs (they find the kernels this process built in
    the checkout's ``sparknet_tpu_torch/_build``)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SPARKNET_")}
    env.update(extra)
    return env


def caffenet_refs(ck, dev, shapes, seed_offset: int):
    """Solo references of full-width CaffeNet f32 (the seeded weights
    every replica draws) at ``shapes``, and the launches they took."""
    from sparknet_tpu_torch.parallel.serving import (LoadedModel,
                                                     ServeConfig,
                                                     solo_references,
                                                     zoo_models)
    cfg = ServeConfig(batch_shapes=tuple(shapes), dtype="f32")
    ck.reset_launch_counts()
    with cudnn_deterministic():
        lm = LoadedModel(FLEET_MODEL, zoo_models()[FLEET_MODEL](), cfg,
                         device=dev)
        gen = np.random.default_rng(SEED + seed_offset)
        inputs = [(IMAGE_STD * gen.normal(size=lm.in_shape)).astype(
            np.float32) for _ in range(FLEET_INPUTS)]
        refs = solo_references(lm, inputs)
    sync(dev)
    got = launched(ck)
    want = {"lrn_across_channels":
            2 * (len(shapes) + len(shapes) * FLEET_INPUTS), **FLEET_B2_ONLY}
    if {k: got[k] for k in want} != want:
        fail(f"5o references: launches {got}, want {want}")
    del lm
    return inputs, refs, got


def serve_fleet_5o(ck, dev, smi: str, d: str) -> dict:
    """(a) ``serve --fleet 2 --models caffenet`` (f32) in a child."""
    from sparknet_tpu_torch.classify import http_json, remote_classify
    out = os.path.join(d, "a_counts")
    wd = os.path.join(d, "a_fleet")
    os.makedirs(out)
    err = open(os.path.join(d, "a_front.stderr"), "w+")
    t0 = time.perf_counter()
    front = subprocess.Popen(
        child_command("front", out) + [
            "--models", FLEET_MODEL, "--fleet", "2", "--port", "0",
            "--dtype", "f32", "--shapes", ",".join(map(str, FLEET_SHAPES)),
            "--fleet-workdir", wd, "--device", dev.type],
        stdout=subprocess.PIPE, stderr=err, text=True,
        env=fleet_env(SPARKNET_ROUTER_SPILL_DEPTH=FLEET_SPILL_DEPTH))
    report: dict = {}
    try:
        inputs, refs, parent = caffenet_refs(ck, dev, FLEET_SHAPES, 31)
        ready = front.stdout.readline().strip()
        report["front_ready_s"] = time.perf_counter() - t0
        if not ready.startswith("serving on http://"):
            err.seek(0)
            fail(f"5o serve --fleet: no ready line ({ready!r}): "
                 f"{err.read()[-3000:]}")
        url = ready.split()[2]
        hz = http_json(f"{url}/healthz")
        live = sorted(r for r, v in hz["router"]["replicas"].items()
                      if v["state"] == "ACTIVE")
        report["healthz"] = {"live": live, "devices": hz["devices"]}
        if len(live) != 2 or hz["devices"] != {"total": 2, "free": 0}:
            fail(f"5o serve --fleet: /healthz {hz}")
        answers: list = [None] * FLEET_REQUESTS
        lat: list = [None] * FLEET_REQUESTS

        def client(k):
            for i in range(k, FLEET_REQUESTS, FLEET_CLIENTS):
                t1 = time.perf_counter()
                answers[i] = remote_classify(url, FLEET_MODEL,
                                             inputs[i % FLEET_INPUTS],
                                             tenant=f"c{k}")
                lat[i] = (time.perf_counter() - t1) * 1e3

        t1 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(FLEET_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        loop_s = time.perf_counter() - t1
        bad = [i for i, a in enumerate(answers) if a is None
               or not np.array_equal(np.asarray(a["probs"], np.float32),
                                     refs[a["padded_to"]][i % FLEET_INPUTS])]
        report.update(requests=FLEET_REQUESTS, mismatches=len(bad),
                      qps=FLEET_REQUESTS / loop_s,
                      p50_ms=float(np.median(lat)),
                      p99_ms=float(np.percentile(lat, 99)))
        if bad:
            fail(f"5o serve --fleet: {len(bad)} of {FLEET_REQUESTS} answers "
                 f"not bit for bit their solo references")
        status = http_json(f"{url}/fleet")
        report["jobs"] = {r["job"]: r["state"] for r in status["jobs"]}
    finally:
        import signal
        front.send_signal(signal.SIGTERM)
        try:
            rc = front.wait(timeout=120)
        except subprocess.TimeoutExpired:
            front.kill()
            rc = front.wait()
        err.close()
    if rc != 0:
        fail(f"5o serve --fleet: the front exited {rc}")
    (fr,) = child_records(out, "front")
    if any(fr["launches"].values()):
        fail(f"5o serve --fleet: the front launched {fr['launches']}")
    reps = child_records(out, "serve")
    if len(reps) != 2 or not all(r["dispatches"] for r in reps):
        fail(f"5o serve --fleet: replica records {reps}")
    report["replica_dispatches"] = [r["dispatches"] for r in reps]
    report["launches"] = {
        "serve_fleet_caffenet_f32_replicas_5o":
            replica_launches(reps, "serve --fleet"),
        "serve_fleet_caffenet_f32_references_5o": parent}
    report["orphans"] = fleet_orphans(wd)
    if report["orphans"]:
        fail(f"5o serve --fleet: orphans {report['orphans']}")
    return report


def fleet_report_5o(ck, dev, smi: str, d: str) -> dict:
    """(b) ``run_fleet_report`` on CaffeNet (f32), its replicas children
    of this script."""
    from sparknet_tpu_torch.parallel import fleet
    from sparknet_tpu_torch.tools import serveload
    out = os.path.join(d, "b_counts")
    wd = os.path.join(d, "b_fleet")
    os.makedirs(out)
    shapes = FLEET_REPORT_5O["shapes"]
    ck.reset_launch_counts()
    with mock.patch.object(fleet, "SERVE_CMD", child_command("serve", out)), \
            cudnn_deterministic():
        rep = serveload.run_fleet_report(**FLEET_REPORT_5O, workdir=wd,
                                         device=dev)
    sync(dev)
    parent = launched(ck)
    n = FLEET_REPORT_5O["inputs_n"]
    want = {"lrn_across_channels": 2 * (len(shapes) + len(shapes) * n),
            **FLEET_B2_ONLY}
    if {k: parent[k] for k in want} != want:
        fail(f"5o fleet report: this process launched {parent}, want "
             f"{want}")
    bad = serveload.fleet_failures(rep)
    v = rep["verdicts"]
    if bad or v["scaling_gated"] or "share one device" not in \
            v["scaling_gate_reason"] or not rep["device"].startswith(
                dev.type):
        fail(f"5o fleet report: {bad}, verdicts {v}")
    # every replica process the fleet started: a record from each that
    # exited cleanly, none from the one SIGKILLed
    recs = child_records(out, "serve")
    started = journal_pids(wd)
    clean = {r["pid"] for r in recs}
    lost = sorted(set(started) - clean)
    killed = rep["chaos"]["killed_pid"]
    if lost != [killed] or not clean <= set(started):
        fail(f"5o fleet report: started {started}, records from "
             f"{sorted(clean)}, killed {killed}")
    orphans = fleet_orphans(wd)
    if orphans:
        fail(f"5o fleet report: orphans {orphans}")
    legs = {leg: {k: rep[leg][k] for k in (
        "offered_qps", "achieved_qps", "p50_ms", "p99_ms", "completed",
        "errors", "exact_mismatches") if k in rep[leg]}
        for leg in ("solo", "saturation", "paced", "chaos", "drain")}
    report = {
        "verdicts": v, "legs": legs,
        "router_counts": rep["router"]["counts"],
        "heal_s": rep["chaos"]["heal_s"],
        "lost": [{"pid": killed, "job": started[killed],
                  "routed": rep["chaos"]["killed_replica_routed"]}],
        "replica_dispatches": {r["pid"]: r["dispatches"] for r in recs},
        "launches": {
            "serveload_fleet_caffenet_f32_replicas_5o":
                replica_launches(recs, "fleet report"),
            "serveload_fleet_caffenet_f32_references_5o": parent}}
    return report


def lenet_tenant_5o(dev, d: str) -> dict:
    """(c) A fleet of 4 slots on the card: an unpreempted lenet run (not
    preemptible) beside the tenant; when the tenant has checkpointed round
    2 a job of higher priority arrives and preempts it (SIGTERM: the
    driver finishes its round, checkpoints and exits cleanly), then the
    tenant is requeued and resumes.  Its final params must equal the
    unpreempted run's bit for bit.  Planted: the tenant's checkpoint
    resumed by a driver fed the next round's batch must differ.  Runs
    after (a), (b) and (d), so that no training overlaps their timed
    legs."""
    import shutil
    from sparknet_tpu_torch.parallel import fleet as fl
    out = os.path.join(d, "c_counts")
    wd = os.path.join(d, "c_fleet")
    os.makedirs(out)
    t0 = time.perf_counter()
    with mock.patch.object(fl, "DRIVER_CMD", child_command("driver", out)):
        sched = fl.FleetScheduler(wd, 2 * LENET_WORLD, device=dev.type,
                                  preempt_grace_s=60.0,
                                  extra_env=fleet_env())
        base = sched.submit(fl.JobSpec(name="lenet-base", world=LENET_WORLD,
                                       rounds=LENET_ROUNDS,
                                       preemptible=False))
        pre = sched.submit(fl.JobSpec(name="lenet-tenant",
                                      world=LENET_WORLD,
                                      rounds=LENET_ROUNDS,
                                      fault=LENET_FAULT))
        deadline = time.monotonic() + 240
        while (pre.newest_round() or 0) < 2:
            if time.monotonic() > deadline or sched.done():
                fail(f"5o lenet: the tenant never checkpointed round 2 "
                     f"({pre.state})")
            sched.step()
            time.sleep(0.02)
        t_pre = time.perf_counter()
        urgent = sched.submit(fl.JobSpec(name="lenet-urgent",
                                         world=LENET_WORLD, rounds=2,
                                         priority=50))
        t_resume = None
        while not sched.done():
            if time.monotonic() > deadline:
                fail("5o lenet: the fleet never finished")
            sched.step()
            if t_resume is None and pre.episodes >= 2:
                t_resume = time.perf_counter()
            time.sleep(0.02)
        sched.shutdown()
    states = {j.name: j.state for j in (base, pre, urgent)}
    if set(states.values()) != {fl.COMPLETED} or pre.preempt_count != 1 \
            or base.preempt_count:
        fail(f"5o lenet: states {states}, preempts {pre.preempt_count}")
    a, b = np.load(base.out_path), np.load(pre.out_path)
    diverged = [k for k in a.files if not k.startswith("__")
                and not np.array_equal(a[k], b[k])]
    if diverged:
        fail(f"5o lenet: the preempted tenant's params {diverged} differ "
             f"from the unpreempted run's")
    import glob
    logs = sorted(glob.glob(os.path.join(pre.job_dir, "runner", "**",
                                         "rank_0.log"), recursive=True))
    text = "".join(open(p).read() for p in logs)
    m = re.search(r"stopped cleanly at round boundary (\d+)", text)
    resumed = re.search(r"resumed at round (\d+)", text)
    if not m or not resumed or m.group(1) != resumed.group(1):
        fail(f"5o lenet: no clean stop and matching resume in the "
             f"tenant's logs")
    # planted: the tenant's checkpoint at its stop, resumed by a driver
    # that feeds round r the batch of round r + 1
    stop = int(m.group(1))
    planted_ck = os.path.join(d, "c_planted_ckpt")
    shutil.copytree(pre.ckpt_dir, planted_ck)
    for name in os.listdir(planted_ck):
        digits = re.findall(r"_(\d{8})\.", name)
        if digits and int(digits[0]) > stop:
            os.unlink(os.path.join(planted_ck, name))
    planted_out = os.path.join(d, "c_planted.npz")
    proc = subprocess.run(
        child_command("driver-planted", out) + [
            "--out", planted_out, "--ckpt-dir", planted_ck, "--rounds",
            str(LENET_ROUNDS), "--local-devices", str(LENET_WORLD),
            "--expect-devices", str(LENET_WORLD), "--device", dev.type],
        capture_output=True, text=True, timeout=240,
        # a later incarnation than every fleet episode: the directory's
        # fence admits its checkpoints
        env=fleet_env(SPARKNET_FENCE_TOKEN=str(10**9)))
    if proc.returncode != 0:
        fail(f"5o lenet: the planted resume exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    c = np.load(planted_out)
    if all(np.array_equal(a[k], c[k]) for k in a.files
           if not k.startswith("__")):
        fail("5o lenet: a resume fed the wrong round's batch was not "
             "caught")
    recs = child_records(out, "driver")
    total = dict(FLEET_POOL_ONLY, max_pool_bwd=0)
    for r in recs:
        want = {"max_pool_bwd": LENET_POOLS * r["workers"] * LENET_TAU
                * r["rounds"], **FLEET_POOL_ONLY}
        got = {k: r["launches"][k] for k in want}
        if r["rc"] != 0 or got != want:
            fail(f"5o lenet: driver pid {r['pid']} ({r['job']}) launches "
                 f"{got}, want {want}")
        total["max_pool_bwd"] += got["max_pool_bwd"]
    rounds = sorted((r["job"], r["rounds"]) for r in recs)
    if rounds != sorted([("lenet-base", LENET_ROUNDS), ("lenet-urgent", 2),
                         ("lenet-tenant", stop),
                         ("lenet-tenant", LENET_ROUNDS - stop)]):
        fail(f"5o lenet: rounds by process {rounds}")
    orphans = fleet_orphans(wd)
    if orphans:
        fail(f"5o lenet: orphans {orphans}")
    return {"stopped_at": stop, "rounds_by_process": rounds,
            "preempt_to_resume_s": t_resume - t_pre,
            "fleet_s": time.perf_counter() - t0,
            "launches": {"fleet_lenet_drivers_5o": total}}


def rollout_5o(ck, dev, smi: str, d: str) -> dict:
    """(d) Three published CaffeNet versions (the zoo's seeded weights:
    one golden answer set), each served by an engine of its own behind
    one router.  v2 canaried at 0.25 of the plain traffic and promoted on
    sustained health; v3, whose weights are planted at 1.01x, canaried
    and rolled back by the judge on its rows off the golden answers, with
    every request pinned to the stable version bit for bit golden.
    Planted: a router that resolves a pinned request to the canary must
    fail the pinned check."""
    from sparknet_tpu_torch.parallel.registry import ModelRegistry, versioned
    from sparknet_tpu_torch.parallel.rollout import (RolloutConfig,
                                                     RolloutController)
    from sparknet_tpu_torch.parallel.router import (InProcessReplica,
                                                    RolloutState, Router,
                                                    RouterConfig)
    from sparknet_tpu_torch.parallel.serving import (InferenceEngine,
                                                     ModelHouse, ServeConfig)
    inputs, refs, _ = caffenet_refs(ck, dev, ROLLOUT_SHAPES, 33)
    ck.reset_launch_counts()
    reg = ModelRegistry(os.path.join(d, "d_registry"))
    v1, v2, v3 = (reg.publish(FLEET_MODEL, notes=f"5o {n}")
                  for n in ("v1", "v2", "v3 (planted)"))
    cfg = ServeConfig(batch_shapes=ROLLOUT_SHAPES, dtype="f32", seed=0,
                      slo_fast_window_s=1.5, slo_window_s=6.0,
                      slo_min_requests=4, slo_reject_budget=0.05,
                      slo_sample_every_s=0.1)
    router = Router(RouterConfig(spill_depth=8))
    live: dict = {}
    counts = {"warmups": 0, "dispatches": 0}
    off_golden: dict = collections.Counter()

    def ensure(name):
        if name in live:
            return
        model, _, version = name.partition("@")
        house = ModelHouse(cfg, device=dev)
        lm = house.load_version(model, version, registry=reg)
        counts["warmups"] += len(cfg.batch_shapes)
        if version == v3:
            with torch.no_grad():
                for blobs in lm.params.values():
                    for b in blobs:
                        b.mul_(PLANTED_CANARY_SCALE)
        eng = InferenceEngine(house, cfg)
        router.add_replica(f"r-{version}", InProcessReplica(
            f"r-{version}", eng))
        live[name] = eng

    def retire(name):
        eng = live.pop(name, None)
        if eng is not None:
            router.drain(f"r-{name.partition('@')[2]}", timeout_s=30.0)
            counts["dispatches"] += eng.stats()["dispatches"]
            eng.stop()

    ctl = RolloutController(
        reg, os.path.join(d, "d_rollout"), ensure=ensure, retire=retire,
        verdict=lambda name: live[name].slo.evaluate() if name in live
        else None,
        bands=lambda name: ([f"{off_golden[name]} rows off the golden "
                             f"answers"] if off_golden[name] else []),
        router=router,
        cfg=RolloutConfig(fraction=ROLLOUT_FRACTION, judge_s=1.0,
                          poll_s=0.05, min_requests=8, breach_polls=2))

    seq = itertools.count()

    def drive(pin=None) -> tuple:
        """One request an input, each with a routing key of its own (the
        canary split is a hash of it): the versions that answered, and
        the requests pinned to ``pin`` that another version answered or
        that came back off the golden answers."""
        served, pinned_bad = collections.Counter(), 0
        for i, x in enumerate(inputs):
            res = router.classify(FLEET_MODEL, x, tenant="rollout",
                                  timeout=60, version=pin,
                                  rkey=f"req-{next(seq)}")
            served[res.model] += 1
            golden = np.array_equal(res.probs, refs[res.padded_to][i])
            if not golden:
                off_golden[res.model] += 1
            if pin is not None and (
                    res.model != versioned(FLEET_MODEL, pin) or not golden):
                pinned_bad += 1
        return served, pinned_bad

    report: dict = {}
    with cudnn_deterministic():
        reg.set_channels(FLEET_MODEL, stable=v1)
        ensure(versioned(FLEET_MODEL, v1))
        router.set_rollout(RolloutState(model=FLEET_MODEL, stable=v1))
        t0 = time.perf_counter()
        ctl.start_canary(FLEET_MODEL, v2)
        served, decision = collections.Counter(), "canary"
        deadline = time.monotonic() + 60
        while decision == "canary" and time.monotonic() < deadline:
            served.update(drive()[0])
            decision = ctl.judge(FLEET_MODEL)
        canary_share = served[versioned(FLEET_MODEL, v2)] / sum(
            served.values())
        if decision != "promote" or off_golden or not \
                0.1 <= canary_share <= 0.4:
            fail(f"5o rollout: v2 {decision}, served {dict(served)}, off "
                 f"golden {dict(off_golden)}")
        ctl.promote(FLEET_MODEL)
        report["promote_s"] = time.perf_counter() - t0
        report["canary_share"] = canary_share
        pre = [router.classify(FLEET_MODEL, x, version=v2).probs
               for x in inputs[:4]]
        # the planted canary
        t0 = time.perf_counter()
        ctl.start_canary(FLEET_MODEL, v3)
        decision, pinned_bad, polls = "canary", 0, 0
        while decision == "canary" and time.monotonic() < deadline + 60:
            drive()
            pinned_bad += drive(pin=v2)[1]
            decision = ctl.judge(FLEET_MODEL)
            polls += 1
        judged_s = time.perf_counter() - t0
        report["planted_rows_off_golden"] = off_golden[
            versioned(FLEET_MODEL, v3)]
        if decision != "rollback" or pinned_bad or \
                not report["planted_rows_off_golden"]:
            fail(f"5o rollout: planted canary {decision} after {polls} "
                 f"polls, pinned requests missed {pinned_bad}")
        # planted: a router that answers a request pinned to the stable
        # version from the canary, through the same pinned check
        with mock.patch.object(Router, "_resolve", lambda self, model, x,
                               tenant, version, rkey:
                               versioned(model, v3)):
            planted_bad = drive(pin=v2)[1]
        report["planted_router_pinned_missed"] = planted_bad
        if planted_bad != len(inputs):
            fail(f"5o rollout: a router answering pinned requests from "
                 f"the canary failed {planted_bad} of {len(inputs)} in "
                 f"the pinned check")
        t0 = time.perf_counter()
        ctl.rollback(FLEET_MODEL, reason="rows off the golden answers")
        # the canary's start to its rollback, the planted router's
        # requests left out
        report["rollback_s"] = judged_s + time.perf_counter() - t0
        post = [router.classify(FLEET_MODEL, x, version=v2).probs
                for x in inputs[:4]]
        ch = reg.channels(FLEET_MODEL)
        if not all(np.array_equal(a, b) for a, b in zip(pre, post)) or \
                ch["stable"] != v2 or ch["canary"] is not None or \
                versioned(FLEET_MODEL, v3) in live:
            fail(f"5o rollout: after the rollback {ch}, live {list(live)}")
        for name in list(live):
            retire(name)
    sync(dev)
    got = launched(ck)
    want = {"lrn_across_channels":
            2 * (counts["warmups"] + counts["dispatches"]), **FLEET_B2_ONLY}
    if {k: got[k] for k in want} != want:
        fail(f"5o rollout: launches {got}, want {want}")
    report["launches"] = {"rollout_caffenet_f32_5o": got}
    return report


def planted_orphan_caught(d: str) -> None:
    """An orphan left running: a process with a fleet job's tag whose
    pid the journal recorded must be found by the orphan check."""
    from sparknet_tpu_torch.parallel.fleet import ENV_JOB_TAG, FleetScheduler
    wd = os.path.join(d, "orphan_fleet")
    sched = FleetScheduler(wd, 1)
    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"],
                            env={**os.environ, ENV_JOB_TAG: "ghost"})
    try:
        sched.journal.append("pids", job="ghost", pids=[proc.pid])
        sched.journal.close()
        deadline = time.monotonic() + 30
        while fleet_orphans(wd) != [proc.pid]:
            if time.monotonic() > deadline:
                fail("5o: an orphan left running was not found")
            time.sleep(0.05)
    finally:
        proc.kill()
        proc.wait()


def fleet_on_card(ck, dev, smi: str) -> dict:
    """Phase 5o."""
    import tempfile
    t0 = time.perf_counter()
    report: dict = {}
    with tempfile.TemporaryDirectory(prefix="fleet_5o_") as d:
        report["serve_fleet"] = serve_fleet_5o(ck, dev, smi, d)
        report["fleet_report"] = fleet_report_5o(ck, dev, smi, d)
        report["rollout"] = rollout_5o(ck, dev, smi, d)
        planted_orphan_caught(d)
        report["lenet"] = lenet_tenant_5o(dev, d)
    report["launches"] = {k: v for part in report.values()
                          for k, v in part.pop("launches").items()}
    report["seconds"] = time.perf_counter() - t0
    print(f"fleet_5o [{smi}] " + json.dumps(
        {k: v for k, v in report.items() if k != "launches"},
        default=str), flush=True)
    return report


# Phase 5p: the round over the wire on the card.  (a) ``tools/commbench.py``
# in this process: lenet, 4 workers x 16 rows, τ=2, 8 rounds a training,
# its five verdicts (the overlap's stall gated on the card) with the
# planted residual dropper caught.  (b) ``tools/soak.py --net --net-slice``:
# its fault-free baseline and both legs' lenet drivers (4 workers) are
# ``--fleet-child`` drivers of this script, started over the fake-ssh wire
# with ``--device cuda`` on their command line.  (c) planted: the real
# ``_verified_copy`` with its crc checks skipped lands a flipped chunk,
# which the manifest's sha256 must refuse.
COMMBENCH_ROUNDS, COMMBENCH_WORKERS, COMMBENCH_TAU = 8, 4, 2
COMMBENCH_ARGV = ["--rounds", str(COMMBENCH_ROUNDS), "--devices",
                  str(COMMBENCH_WORKERS), "--batch", "16", "--tau",
                  str(COMMBENCH_TAU)]
# commbench's trainings: none three times (no codec, off, on), the three
# real codecs, int8 with overlap
COMMBENCH_TRAININGS = 7
NET_WORKERS = 4                  # soak's wire driver: --local-devices 4
SHIP_CHUNK = 65536               # the net legs' SPARKNET_SHIP_CHUNK_MB


def commbench_5p(ck, dev, d: str) -> dict:
    """(a) commbench in this process, every training's rounds counted."""
    import io
    from sparknet_tpu_torch.parallel import trainer
    from sparknet_tpu_torch.tools import commbench
    rounds = [0]
    real_round = trainer.DistributedTrainer.train_round

    def counted_round(self, batches):
        rounds[0] += 1
        return real_round(self, batches)

    want_rounds = COMMBENCH_TRAININGS * COMMBENCH_ROUNDS
    want = {"max_pool_bwd": LENET_POOLS * COMMBENCH_WORKERS * COMMBENCH_TAU
            * want_rounds, **FLEET_POOL_ONLY}
    path = os.path.join(d, "commbench.json")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(trainer.DistributedTrainer, "train_round",
                           counted_round), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = commbench.main(COMMBENCH_ARGV + ["--device", dev.type,
                                              "--out", path])
    sync(dev)
    wall = time.perf_counter() - t0
    got = launched(ck)
    with open(path) as f:
        doc = json.load(f)
    if rc != 0 or not doc["ok"] or doc["failures"]:
        fail(f"5p commbench: rc {rc}, failures {doc['failures']}")
    if not doc["stall_gated"] or doc["ef_invariant"]["int8_dropres"]:
        fail(f"5p commbench: stall gated {doc['stall_gated']}, planted "
             f"dropper {doc['ef_invariant']}")
    if not doc["comm_stall_overlap_s"] > 0:
        fail(f"5p commbench: no comm stall under overlap "
             f"{doc['overlap_int8']}")
    if rounds[0] != want_rounds or {k: got[k] for k in want} != want:
        fail(f"5p commbench: {rounds[0]} rounds, launches {got}, want "
             f"{want_rounds} rounds, {want}")
    return {"wall_s": wall, "device": doc["device"],
            "comm_stall_sync_s": doc["comm_stall_sync_s"],
            "comm_stall_overlap_s": doc["comm_stall_overlap_s"],
            "wall_s_by_codec": {"none": doc["none"]["wall_s"],
                                **{c: r["wall_s"]
                                   for c, r in doc["codecs"].items()},
                                "int8_overlap":
                                    doc["overlap_int8"]["wall_s"]},
            "exchange_bytes": {"none": doc["exchange_bytes_none"],
                               **{c: r["exchange_bytes"]
                                  for c, r in doc["codecs"].items()}},
            "shrink_x": doc["comm_bytes_shrink_x"],
            "launches": {"commbench_lenet_5p": {
                k: got[k] for k in want}}}


def net_soak_5p(ck, dev, d: str) -> dict:
    """(b) ``soak --net --net-slice`` on the card: the partition leg SUSPECT
    with no kill and no straggler, the fenced leg resumed past a torn ship
    with the zombie refused and no temporaries left, both bit for bit the
    baseline; each driver's pool launches exact."""
    from sparknet_tpu_torch.parallel import fleet as fl
    from sparknet_tpu_torch.tools import multihost_driver, soak
    out = os.path.join(d, "p_counts")
    os.makedirs(out)
    path = os.path.join(d, "net.json")
    rounds = soak.NET_ROUNDS
    want_rounds = sorted([rounds, rounds, rounds // 2, rounds - rounds // 2])
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ), \
            mock.patch.object(fl, "DRIVER_CMD", child_command("driver", out)):
        rc = soak.main(["--net", "--net-slice", "--device", dev.type,
                        "--out", path, "--workdir", os.path.join(d, "net")])
    wall = time.perf_counter() - t0
    with open(path) as f:
        rep = json.load(f)
    part, fenced = rep["episodes"]
    if rc != 0 or not rep["ok"]:
        fail(f"5p net soak: rc {rc}, " + json.dumps(rep["episodes"]))
    if part["suspects"] != ["hostb"] or part["stragglers"] \
            or part["cause"] != "clean" or not part["match"]:
        fail(f"5p net soak: partition leg {part}")
    ship = fenced["ship"]
    if not (ship["resumed_bytes"] > 0 and fenced["zombie"]["refused"]
            and fenced["match"] and "torn_leftovers" not in fenced):
        fail(f"5p net soak: fenced leg {fenced}")
    parent = {k: launched(ck)[k] for k in ("max_pool_bwd",
                                            *FLEET_POOL_ONLY)}
    if any(parent.values()):
        fail(f"5p net soak: this process launched {parent}")
    recs = child_records(out, "driver")
    total = dict(FLEET_POOL_ONLY, max_pool_bwd=0)
    for r in recs:
        want = {"max_pool_bwd": LENET_POOLS * r["workers"]
                * multihost_driver.TAU * r["rounds"], **FLEET_POOL_ONLY}
        got = {k: r["launches"][k] for k in want}
        if r["rc"] != 0 or got != want or r["workers"] != NET_WORKERS:
            fail(f"5p net soak: driver pid {r['pid']} launches {got}, "
                 f"want {want}")
        total["max_pool_bwd"] += got["max_pool_bwd"]
    if sorted(r["rounds"] for r in recs) != want_rounds:
        fail(f"5p net soak: rounds by driver "
             f"{sorted(r['rounds'] for r in recs)}, want {want_rounds}")
    return {"wall_s": wall,
            "partition_s": part["elapsed_s"],
            "lease_detect_s": part.get("lease_detect_s"),
            "suspect_to_heal_s": part.get("suspect_to_heal_s"),
            "fenced_s": fenced["elapsed_s"],
            "ship_bytes": ship["bytes"],
            "resumed_bytes": ship["resumed_bytes"],
            "ship_mb_per_s": ship["bytes"] / ship["wall_s"] / 1e6,
            "soak_s": rep["elapsed_s"],
            "rounds_by_driver": sorted(r["rounds"] for r in recs),
            "launches": {"net_soak_lenet_drivers_5p": total}}


def crc_skipping_copy(src: str, dst: str, *, chunk: int | None = None
                      ) -> dict:
    """``transport._verified_copy`` with its crc checks taken out: the
    torn temporary's whole chunks are kept as they are, the rest copied,
    nothing read back before the rename."""
    from sparknet_tpu_torch.parallel import transport as tp
    chunk = chunk or tp._ship_chunk_bytes()
    size = os.path.getsize(src)
    tmp = f"{dst}.tmp.ship"
    have = os.path.getsize(tmp) if os.path.exists(tmp) else 0
    resumed = min(have, size) // chunk * chunk
    with open(src, "rb") as f, open(tmp, "r+b" if resumed else "wb") as o:
        f.seek(resumed)
        o.seek(resumed)
        o.truncate(resumed)
        o.write(f.read())
    os.replace(tmp, dst)
    return {"bytes": size, "chunks": -(-(size - resumed) // chunk),
            "resumed_bytes": resumed}


def planted_crc_skip_caught(d: str) -> dict:
    """(c) The fenced leg's checkpoints shipped again onto a host whose
    temporary holds a torn earlier transfer with a flipped byte in its
    second chunk: the real copy resumes past the first chunk only and
    lands the manifest's bytes; the same copy with its crc checks skipped
    keeps the flipped chunk, and the manifest's sha256 must refuse it."""
    import shutil
    from sparknet_tpu_torch.parallel import transport as tp
    src = os.path.join(d, "net", "fenced_zombie_ship", "ckpt_host_hosta")
    r = tp.newest_valid_round(src)
    name = f"ckpt_round_{r:08d}.npz"
    with open(os.path.join(src, name), "rb") as f:
        torn = bytearray(f.read(3 * SHIP_CHUNK))
    torn[SHIP_CHUNK + 17] ^= 0x01
    out = {}
    for label in ("real", "planted"):
        dst = os.path.join(d, f"crc_{label}")
        os.makedirs(dst)
        with open(os.path.join(dst, name + ".tmp.ship"), "wb") as f:
            f.write(torn)
        copy = (crc_skipping_copy if label == "planted"
                else tp._verified_copy)
        with mock.patch.dict(os.environ, {"SPARKNET_SHIP_CHUNK_MB":
                                          str(SHIP_CHUNK / 2**20)}), \
                mock.patch.object(tp, "_verified_copy", copy):
            try:
                out[label] = tp.ship_latest_checkpoint(
                    tp.LocalTransport(), "hostc", src, dst)
            except tp.ShipError as e:
                out[label] = e
        if label == "real":
            rec = out["real"]
            if isinstance(rec, Exception) or rec["round"] != r \
                    or rec["resumed_bytes"] != SHIP_CHUNK \
                    or tp.newest_valid_round(dst) != r:
                fail(f"5p planted crc: the real copy gave {rec}")
        shutil.rmtree(dst)
    if not isinstance(out["planted"], tp.ShipError):
        fail(f"5p planted crc: a copy that skips the crc check landed a "
             f"flipped chunk unseen ({out['planted']})")
    return {"real": out["real"], "planted": str(out["planted"])}


def net_on_card(ck, dev, smi: str) -> dict:
    """Phase 5p."""
    import tempfile
    t0 = time.perf_counter()
    report: dict = {}
    with tempfile.TemporaryDirectory(prefix="net_5p_") as d:
        report["commbench"] = commbench_5p(ck, dev, d)
        report["net_soak"] = net_soak_5p(ck, dev, d)
        report["planted_crc"] = planted_crc_skip_caught(d)
    report["launches"] = {k: v for part in report.values()
                          if "launches" in part
                          for k, v in part.pop("launches").items()}
    report["seconds"] = time.perf_counter() - t0
    print(f"net_5p [{smi}] " + json.dumps(
        {k: v for k, v in report.items() if k != "launches"},
        default=str), flush=True)
    return report


# Phase 5q: the pod half's tensors on the card.  (a) ``tools/shardbench.py
# --device cuda`` in this process, its six verdicts on lenet (4 positions,
# τ=2, 3 rounds).  (b) CaffeNet at full width, the bench's round batch of
# 227 crops of 256² images over 4 positions, local_sgd, τ=2, one warm and
# one measured round, shard "off" then "auto" through the bench's
# ``shard_round_legs``: losses and params bit for bit, the boundary
# bytes, one shard_checkpoint write resumed bit for bit.  (c) gangs of 2
# processes x 2 workers through ``launch_local`` and multihost_driver, every
# rank a ``--fleet-child driver`` of this script on the one card, started
# together: hierarchical under SPARKNET_SHARD=auto and SPARKNET_SHARD_CKPT=1
# against the one-process 2x2 run, local_sgd with ``--audit-every 1`` and
# a flip on position 3 against the fault-free run, and (planted) a flip on
# position 1 with the audit off, which must not match.  (d) roundbench's
# audit leg.  Planted: a tile with one byte changed, which resume skips.
SHARD_WORKERS, SHARD_TAU = 4, 2
SHARD_BATCH = 256                 # the bench's round batch, 64 a worker
SHARD_BYTES_DP, SHARD_BYTES_4 = 243_860_896, 67_995_040
GANG_PROCS, GANG_LOCAL, GANG_ROUNDS = 2, 2, 4
GANG_TIMEOUT_S = 240


class counted_rounds:
    """Worker steps of every round run in this process while active: a
    round the audit dropped before it ran counts none."""

    def __init__(self):
        self.steps = 0

    def __enter__(self):
        from sparknet_tpu_torch.parallel import trainer
        real = trainer.DistributedTrainer.train_round
        outer = self

        def counted(tr, batches):
            trips = tr.audit_trips
            out = real(tr, batches)
            if tr.audit_trips == trips:
                outer.steps += tr.n_workers * tr.config.tau
            return out

        self._patch = mock.patch.object(trainer.DistributedTrainer,
                                        "train_round", counted)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)


def lenet_pools(steps: int) -> dict:
    return {"max_pool_bwd": LENET_POOLS * steps, **FLEET_POOL_ONLY}


def shardbench_5q(ck, dev, d: str) -> dict:
    """(a) shardbench in this process."""
    import io
    from sparknet_tpu_torch.tools import shardbench
    path = os.path.join(d, "shardbench.json")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with counted_rounds() as cr, \
            contextlib.redirect_stdout(io.StringIO()):
        rc = shardbench.main(["--device", dev.type, "--out", path])
    sync(dev)
    wall = time.perf_counter() - t0
    got, want = launched(ck), lenet_pools(cr.steps)
    with open(path) as f:
        doc = json.load(f)
    verdicts = {"parity": doc["parity"],
                "codec_int8_parity": doc["codec_int8_parity"],
                "ckpt_roundtrip_ok": doc["ckpt_roundtrip_ok"],
                "elastic_ok": doc["elastic_ok"], "audit_ok": doc["audit_ok"],
                "caffenet_shrink_x": doc["caffenet"]["shrink_x"]}
    if rc != 0 or not doc["ok"] or doc["failures"] \
            or not all(doc["parity"].values()):
        fail(f"5q shardbench: rc {rc}, {doc['failures']}, {verdicts}")
    if {k: got[k] for k in want} != want or not cr.steps:
        fail(f"5q shardbench: launches {got}, want {want}")
    return {"wall_s": wall, "verdicts": verdicts, "plan": doc["plan"],
            "round_s": {"dp": doc["dp"]["round_s"],
                        "sharded": doc["sharded"]["round_s"]},
            "boundary_bytes": {"dp": doc["dp"]["boundary_bytes_per_chip"],
                               "sharded":
                                   doc["sharded"]["boundary_bytes_per_chip"]},
            "launches": {"shardbench_lenet_5q": {k: got[k] for k in want}}}


def caffenet_shard_round_5q(ck, dev, d: str) -> dict:
    """(b) CaffeNet's replicated round against its sharded one, at full
    width, and one sharded checkpoint written and resumed."""
    from sparknet_tpu_torch import bench as bench_mod
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    from sparknet_tpu_torch.utils.profiling import (BENCH_SOLVER_PROTOTXT,
                                                    build_bench_model)
    net, in_shape, classes = build_bench_model("caffenet", SHARD_BATCH)
    sp = load_solver_prototxt_with_net(BENCH_SOLVER_PROTOTXT, net)
    rng = np.random.default_rng(SEED + 22)
    feed = {"data": torch.from_numpy(rng.normal(
                size=(SHARD_TAU, SHARD_BATCH) + in_shape).astype(
                    np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, classes, size=(SHARD_TAU, SHARD_BATCH)).astype(
                    np.float32)).to(dev)}
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    with cudnn_deterministic(), counted_rounds() as cr:
        legs = bench_mod.shard_round_legs(
            sp, feed, workers=SHARD_WORKERS, rounds=1, tau=SHARD_TAU,
            device=dev, shard_checkpoint=True, sync=lambda: sync(dev))
    got = launched(ck)
    want = want_steps(cr.steps)
    dp, sh = legs["off"], legs["auto"]
    if cr.steps != 2 * 2 * SHARD_WORKERS * SHARD_TAU or got != want:
        fail(f"5q caffenet shard round: {cr.steps} steps, launches {got}, "
             f"want {want}")
    if [np.float32(x).tobytes() for x in dp["losses"]] != \
            [np.float32(x).tobytes() for x in sh["losses"]] or \
            differing(host_params(dp["trainer"]),
                      host_params(sh["trainer"])):
        fail(f"5q caffenet shard round: sharded {sh['losses']} against dp "
             f"{dp['losses']}, params "
             f"{differing(host_params(dp['trainer']), host_params(sh['trainer']))}")
    plan = sh["trainer"].shard_plan
    if (dp["boundary_bytes_per_chip"], sh["boundary_bytes_per_chip"]) != \
            (SHARD_BYTES_DP, SHARD_BYTES_4) or plan is None or \
            plan.dims_dict() != {"fc6/0": 0, "fc7/0": 0, "fc8/0": 0}:
        fail(f"5q caffenet shard round: bytes "
             f"{dp['boundary_bytes_per_chip']} / "
             f"{sh['boundary_bytes_per_chip']}, plan {plan}")
    # one sharded checkpoint, written and resumed by a fresh trainer
    ckdir = os.path.join(d, "caffenet_ckpt")
    t1 = time.perf_counter()
    sh["trainer"].save_round_checkpoint(ckdir)
    sh["trainer"].flush_checkpoints()
    write_s = time.perf_counter() - t1
    tiles = sorted(f for f in os.listdir(ckdir) if ".shard" in f)
    t1 = time.perf_counter()
    back = DistributedTrainer(sp, SHARD_WORKERS, TrainerConfig(
        strategy="local_sgd", tau=SHARD_TAU, shard="auto",
        shard_checkpoint=True, checkpoint_dir=ckdir), seed=1, device=dev)
    resume_s = time.perf_counter() - t1
    if len(tiles) != SHARD_WORKERS or back.resumed is None or \
            differing(host_params(sh["trainer"]), host_params(back)):
        fail(f"5q caffenet sharded checkpoint: tiles {tiles}, resumed "
             f"{back.resumed}")
    mb = sum(os.path.getsize(os.path.join(ckdir, f))
             for f in os.listdir(ckdir) if f.endswith(".npz")) / 1e6
    del legs, back
    torch.cuda.empty_cache()
    return {"wall_s": time.perf_counter() - t0,
            "round_s": {"dp": {"warm": dp["warm_s"],
                               "measured": dp["round_s"]},
                        "sharded": {"warm": sh["warm_s"],
                                    "measured": sh["round_s"]}},
            "img_s": {"dp": dp["img_s"], "sharded": sh["img_s"]},
            "boundary_bytes": {"dp": dp["boundary_bytes_per_chip"],
                               "sharded": sh["boundary_bytes_per_chip"]},
            "plan": sh["trainer"].shard_plan_id,
            "checkpoint": {"mb": mb, "write_s": write_s,
                           "resume_s": resume_s, "tiles": len(tiles)},
            "launches": {"shard_round_caffenet_5q": got}}


def gang_5q(ck, dev, d: str) -> dict:
    """(c) three gangs started together, then the one-process runs they
    are held against in this process; each gang's ranks' launches from
    their records."""
    import threading
    from sparknet_tpu_torch.tools import multihost_driver
    from sparknet_tpu_torch.tools.launch import launch_local
    from sparknet_tpu_torch.utils import faults
    base = ["--rounds", str(GANG_ROUNDS)]
    gangs = {
        "hierarchical_sharded": (["--strategy", "hierarchical",
                                  "--ckpt-dir", os.path.join(d, "g_hier")],
                                 {"SPARKNET_SHARD": "auto",
                                  "SPARKNET_SHARD_CKPT": "1"}),
        "local_sgd_audit_flip": (["--strategy", "local_sgd",
                                  "--audit-every", "1", "--ckpt-dir",
                                  os.path.join(d, "g_audit")],
                                 {"SPARKNET_FAULT":
                                  "bitflip_params@rank:3@round:2"}),
        "planted_flip_no_audit": (["--strategy", "local_sgd"],
                                  {"SPARKNET_FAULT":
                                   "bitflip_params@rank:1@round:2"}),
    }
    rcs: dict = {}
    threads, spawned = [], []
    t0 = time.perf_counter()
    for name, (argv, env) in gangs.items():
        out = os.path.join(d, f"rec_{name}")
        os.makedirs(out)
        cmd = child_command("driver", out) + base + argv + [
            "--out", os.path.join(d, f"{name}.npz")]

        up = threading.Event()
        spawned.append(up)

        def go(name=name, cmd=cmd, env=env, up=up):
            try:
                rcs[name] = launch_local(
                    cmd, GANG_PROCS, device=dev.type,
                    local_devices=GANG_LOCAL, timeout=GANG_TIMEOUT_S,
                    extra_env={**env, "OMP_NUM_THREADS": "1"},
                    on_spawn=lambda procs: up.set())
            finally:
                up.set()
        threads.append(threading.Thread(target=go, daemon=True))
    for t in threads:
        t.start()
    # every rank started (with this process's environment as it was)
    # before the references below set theirs
    for up in spawned:
        up.wait(GANG_TIMEOUT_S)
    # the one-process runs, meanwhile: the 2x2 pod under the same plan,
    # and local_sgd on 4 workers with the audit and no fault
    ck.reset_launch_counts()
    refs = {}
    with cudnn_deterministic(), counted_rounds() as cr:
        for name, argv, env in (
                ("hierarchical_sharded", ["--strategy", "hierarchical",
                                          "--ckpt-dir",
                                          os.path.join(d, "r_hier")],
                 gangs["hierarchical_sharded"][1]),
                ("fault_free_audit", ["--strategy", "local_sgd",
                                      "--audit-every", "1", "--ckpt-dir",
                                      os.path.join(d, "r_audit")], {})):
            path = os.path.join(d, f"ref_{name}.npz")
            with mock.patch.dict(os.environ, env):
                faults.reset_injector()
                rc = multihost_driver.main(
                    base + argv + ["--out", path, "--local-devices",
                                   str(GANG_PROCS * GANG_LOCAL),
                                   "--device", dev.type])
            faults.reset_injector()
            if rc != 0:
                fail(f"5q gang reference {name}: rc {rc}")
            refs[name] = np.load(path)
    sync(dev)
    ref_launches = launched(ck)
    ref_want = lenet_pools(cr.steps)
    for t in threads:
        t.join(GANG_TIMEOUT_S + 30)
    wall = time.perf_counter() - t0
    if {k: ref_launches[k] for k in ref_want} != ref_want:
        fail(f"5q gang references: launches {ref_launches}, want "
             f"{ref_want}")
    report: dict = {"wall_s": wall, "launches": {
        "gang_references_one_process_5q":
            {k: ref_launches[k] for k in ref_want}}}
    got_npz = {}
    for name in gangs:
        recs = child_records(os.path.join(d, f"rec_{name}"), "driver")
        total = dict(FLEET_POOL_ONLY, max_pool_bwd=0)
        for r in recs:
            want = lenet_pools(r["workers"] * multihost_driver.TAU
                               * r["trained"])
            got = {k: r["launches"][k] for k in want}
            if r["rc"] != 0 or got != want or r["workers"] != GANG_LOCAL:
                fail(f"5q gang {name}: rank pid {r['pid']} rc {r['rc']}, "
                     f"launches {got}, want {want}")
            total["max_pool_bwd"] += got["max_pool_bwd"]
        if rcs.get(name) != 0 or len(recs) != GANG_PROCS:
            fail(f"5q gang {name}: launcher rc {rcs.get(name)}, "
                 f"{len(recs)} rank records")
        report["launches"][f"gang_{name}_5q"] = total
        got_npz[name] = np.load(os.path.join(d, f"{name}.npz"))

    def params_differ(a, b) -> list:
        return [k for k in a.files if not k.startswith("__")
                and not np.array_equal(a[k], b[k])]

    hier = params_differ(refs["hierarchical_sharded"],
                         got_npz["hierarchical_sharded"])
    if hier or not os.listdir(os.path.join(d, "g_hier")) or not any(
            ".shard" in f for f in os.listdir(os.path.join(d, "g_hier"))):
        fail(f"5q gang hierarchical sharded: params {hier} differ from "
             f"the one-process 2x2 run, or no tiles written")
    flip = got_npz["local_sgd_audit_flip"]
    flip_diff = params_differ(refs["fault_free_audit"], flip)
    if int(flip["__audit_trips__"]) != 1 or flip_diff:
        fail(f"5q gang audit: {int(flip['__audit_trips__'])} trips, params "
             f"{flip_diff} differ from the fault-free run")
    planted = params_differ(refs["fault_free_audit"],
                            got_npz["planted_flip_no_audit"])
    if not planted:
        fail("5q planted: a rank flipped a bit with the audit off and the "
             "gang's params still match the fault-free run")
    report.update(ranks=GANG_PROCS, workers_per_rank=GANG_LOCAL,
                  audit_trips=int(flip["__audit_trips__"]),
                  planted_params_differing=len(planted))
    return report


def roundbench_audit_5q(ck, dev) -> dict:
    """(d) roundbench with its audit leg on the card."""
    from sparknet_tpu_torch.tools import roundbench
    ck.reset_launch_counts()
    with counted_rounds() as cr:
        line = roundbench.run(device=dev.type)
    got, want = launched(ck), lenet_pools(cr.steps)
    stalls = (line["sync"]["stall_s"]["audit_fetch"],
              line["async"]["stall_s"]["audit_fetch"])
    if not line["ok"] or not all(isinstance(x, float) and x > 0
                                 for x in stalls):
        fail(f"5q roundbench: {line['failures']}, audit_fetch {stalls}")
    if {k: got[k] for k in want} != want:
        fail(f"5q roundbench: launches {got}, want {want}")
    return {"audit_fetch_s": {"sync": stalls[0], "async": stalls[1]},
            "wall_s": {"sync": line["sync"]["wall_s"],
                       "async": line["async"]["wall_s"]},
            "launches": {"roundbench_audit_5q": {k: got[k] for k in want}}}


def planted_tile_refused(ck, dev, d: str) -> dict:
    """Planted: the newest sharded checkpoint's tile with one byte
    changed; a fresh trainer must skip it and resume the one before."""
    from sparknet_tpu_torch.models import lenet
    from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                     TrainerConfig)
    from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
    sp = load_solver_prototxt_with_net(
        'base_lr: 0.005\nmomentum: 0.9\nlr_policy: "fixed"\n',
        lenet(16, 16))
    ckdir = os.path.join(d, "tile_plant")
    cfg = TrainerConfig(strategy="local_sgd", tau=SHARD_TAU, shard="auto",
                        shard_checkpoint=True, checkpoint_dir=ckdir,
                        async_checkpoint=False)
    ck.reset_launch_counts()
    with counted_rounds() as cr:
        tr = DistributedTrainer(sp, SHARD_WORKERS, cfg, seed=0, device=dev)
        rng = np.random.default_rng(SEED + 23)
        for _ in range(2):
            tr.train_round({
                "data": rng.normal(size=(SHARD_TAU, 16, 1, 28, 28)
                                   ).astype(np.float32),
                "label": rng.integers(0, 10, size=(SHARD_TAU, 16)
                                      ).astype(np.float32)})
    got, want = launched(ck), lenet_pools(cr.steps)
    tile = os.path.join(ckdir, "ckpt_round_00000002.shard01.npz")
    with open(tile, "r+b") as f:
        f.seek(os.path.getsize(tile) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x01]))
    back = DistributedTrainer(sp, SHARD_WORKERS, cfg, seed=0, device=dev)
    if back.resumed is None or back.resumed["round"] != 1 or \
            {k: got[k] for k in want} != want:
        fail(f"5q planted tile: resume took "
             f"{back.resumed and back.resumed['round']} (want 1, the tile "
             f"of round 2 changed), launches {got}")
    return {"resumed_round": back.resumed["round"],
            "launches": {"planted_tile_lenet_5q": {k: got[k] for k in want}}}


def pod_tensors_on_card(ck, dev, smi: str) -> dict:
    """Phase 5q."""
    import tempfile
    t0 = time.perf_counter()
    report: dict = {}
    with tempfile.TemporaryDirectory(prefix="pod_5q_") as d:
        report["shardbench"] = shardbench_5q(ck, dev, d)
        report["caffenet_shard_round"] = caffenet_shard_round_5q(ck, dev, d)
        report["gangs"] = gang_5q(ck, dev, d)
        report["roundbench_audit"] = roundbench_audit_5q(ck, dev)
        report["planted_tile"] = planted_tile_refused(ck, dev, d)
    report["launches"] = {k: v for part in report.values()
                          if "launches" in part
                          for k, v in part.pop("launches").items()}
    report["seconds"] = time.perf_counter() - t0
    print(f"pod_5q [{smi}] " + json.dumps(
        {k: v for k, v in report.items() if k != "launches"},
        default=str), flush=True)
    return report


def kernel_entry(name: str, source: str, replaces: str, launches: dict,
                 rows: list[dict], main: list[dict],
                 relu_launches: dict | None = None) -> dict:
    """One kernel's entry: launches per main path (those with the ReLU
    folded in, under the ``_relu`` keys, counted in ``launches`` and
    listed apart), the worst error over every check, and times, bounds
    and library times summed over the main-path rows (one launch of each
    per step or forward)."""
    libs = [r["library_ms"] for r in main]
    relu_launches = relu_launches or {}
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(launches.values()) + sum(relu_launches.values()),
        "launches_by_path": launches,
        "relu_launches": sum(relu_launches.values()),
        "relu_launches_by_path": relu_launches,
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
    if sys.argv[1:2] == ["--fleet-child"]:
        # phase 5o's replicas, fronts and drivers: ``--fleet-child KIND
        # OUTDIR -- <the tool's arguments>``
        if not torch.cuda.is_available():
            return 2
        kind, outdir = sys.argv[2:4]
        return fleet_child(kind, outdir, sys.argv[5:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="write per-kernel device-time tables of batch-64 "
                         "bf16 forwards and of one steady round of each "
                         "CaffeNet and GoogLeNet training run to PATH; "
                         "print the host-side split of one batch-64 "
                         "dispatch and each profiled round's device busy "
                         "share and host-to-device copies")
    # phase 5e's recovery runs, each in a process of its own
    ap.add_argument("--round-child", help=argparse.SUPPRESS)
    ap.add_argument("--round-dir", help=argparse.SUPPRESS)
    ap.add_argument("--round-out", help=argparse.SUPPRESS)
    # phase 5l's servers, each in a process of its own
    ap.add_argument("--serve-child", help=argparse.SUPPRESS)
    ap.add_argument("--serve-args", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if args.round_child:
        return round_child(args.round_child, args.round_dir, args.round_out)
    if args.serve_child:
        return serve_child(args.serve_child, json.loads(args.serve_args))
    from sparknet_tpu_torch.ops import cuda_kernels as ck
    # the per-phase timeline: (phase, its seconds), printed before the
    # kernels line
    timeline: list = []
    t_mark = [time.perf_counter()]

    def mark(phase: str) -> None:
        now = time.perf_counter()
        timeline.append((phase, round(now - t_mark[0], 1)))
        t_mark[0] = now

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
    mark("2 build")
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
    mark("3 kernels")

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
    mark("4 serving")

    # phase 4b: the crop and the feed on the card
    check_crop(dev)
    check_feed(dev)
    torch.cuda.empty_cache()
    mark("4b crop and feed")

    # phase 5: training through the apps.  CaffeNet and GoogLeNet each
    # with the crop on the feed's host thread and on the card, and
    # through the synchronous loop the device feed replaced (the
    # same-call baseline); CaffeNet also one sync round with a snapshot;
    # each model with a round on the card against the CPU.
    prof = args.profile
    if prof:
        open(prof, "a").close()
    # the apps' synthetic images, drawn once a set from here to 5f
    drawn = drawn_once().__enter__()
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
    mark("5 training")

    # phase 5b: the Solver at full width, its snapshot on disk and served,
    # and Caffe's six rules
    solved = solver_and_weights(ck, dev, smi)
    mark("5b solver")

    import tempfile
    # 5c's LMDBs stay until phase 5n, the last phase, has read them
    d5c_dir = tempfile.TemporaryDirectory(prefix="data_path_smoke_")
    d5c = d5c_dir.name
    # phase 5c: Caffe's data path, CaffeNet trained from an LMDB
    # through caffe_cli train, tested and timed, its features
    # extracted
    data_path = caffe_data_path(
        ck, dev, smi, solved["caffenet"]["solver_ms_per_iter_b256"],
        d5c)
    mark("5c data path")

    # phase 5d: real images, decoded on the card: the image kernels
    # and nvJPEG against their plain versions and libjpeg, CaffeNet
    # from tars of JPEGs through imagenet_app --tar-dir, encoded
    # Datums and ImageData through caffe_cli, a WindowData batch
    images = real_images(
        ck, dev, smi, trained["caffenet_device_pre"]["report"]
        ["steady_medians"])
    mark("5d real images")

    # phase 5e: the round: hierarchical through caffe_cli over 5c's
    # LMDB, the codecs, crash/resume, the guard, elastic, the lag
    round_report = the_round(ck, dev, smi, {
        "dir": d5c, "model": os.path.join(d5c, "train_val.prototxt")})
    mark("5e the round")

    # phase 5i: SparkNet's data tier over 5c's LMDBs: record shards
    # through the convert tool, the verifying store and the tiered
    # cache, CaffeNet from them through caffe_cli with HDF5
    # snapshots, the Spark bridge in a round, HDF5Data
    tier = data_tier(ck, dev, smi, d5c, data_path)
    mark("5i data tier")

    # phase 5k: the training data plane and the learning proxy: the
    # native pipeline against numpy over 5c's Datums and its feed,
    # CaffeNet from 5c's LMDB as shards through the Solver with the
    # host transform and set_augment on the host and the card, the
    # learning proxy and the τ sweep on cifar10_full
    plane = data_plane_and_proxy(ck, dev, smi, d5c, data_path)
    mark("5k data plane and proxy")

    # phase 5f: the bench at its defaults, its CLI, profile_step on
    # CaffeNet b256 and the telemetry plane on the card
    bench_report = the_bench(ck, dev, smi,
                             solved["caffenet"]["solver_ms_per_iter_b256"])
    drawn.__exit__()
    mark("5f bench")

    # phase 5g: the layers of the slice on the card, mnist_siamese and
    # mnist_autoencoder through caffe_cli train, each against the CPU
    graph = graph_compiler_rest(ck, dev, smi)
    mark("5g graph compiler")

    # phase 5h: the layer library's last types on the card, and Caffe's
    # cifar10_full_sigmoid_bn through caffe_cli on one device and on two
    # workers (sync, local_sgd), BatchNorm's statistics carried
    bn = batchnorm_slice(ck, dev, smi)
    mark("5h layer library")

    # phase 5j: Caffe's tools and pycaffe's classifiers: train_cifar on
    # cifar10_quick (the pool backward once a worker iteration) and its log
    # through parse_log, upgrade_net_proto and draw_net, PNG and CMYK
    # images without PIL (and CaffeNet over an ImageData list with PNGs),
    # classify_cli and detect_cli on full-width CaffeNet (LRN inference
    # twice a forward), each against the CPU
    tools = tools_and_classifiers(ck, dev, smi)
    mark("5j tools and classifiers")

    # phase 5l: pycaffe's caffe module and the serving plane:
    # tools/serve.py over HTTP on CaffeNet f32 (rows against the solo
    # references, a registry version, the SLO monitor and beacons with
    # planted faults, classify_cli --server), caffe.Net, get_solver and a
    # NetSpec-built CaffeNet against the CPU
    serving_5l = serving_and_pycaffe(ck, dev, smi)
    mark("5l serving and pycaffe")

    # phase 5m: the fusion pass and the lowering tuner: fusebench on the
    # card (planted: a dropped ReLU fold, swapped horizontal slices),
    # GoogLeNet's round under the committed plan against per-layer, its
    # deploy net served at 64 with horizontal fusion on and off, and the
    # committed tuning table's staleness check
    fused = fusion_on_card(ck, dev, smi)
    mark("5m fusion and tuner")

    # phase 5n: the rest of the observability and bench plane:
    # perf_probe's poolbwd, lrn and hlo parts, serveload's sweep and
    # overload on CaffeNet, a profiler-server capture of served
    # batches, feedbench --records-leg over 5c's LMDB, roundbench,
    # obs smoke and tools/knobs --check, with planted faults.  It runs
    # last: run before 5f in one process, it left 5f's profile_step
    # trace without the first ~5 ms of its block's kernels (B1's first
    # launch among them) in 3 of 4 profiles (PERF.md §7)
    obs5n = observability_and_bench(ck, dev, smi, d5c)
    mark("5n observability and bench plane")
    d5c_dir.cleanup()

    # phase 5o: the fleet on one card: serve --fleet on CaffeNet through
    # the router, serveload's fleet legs (a replica killed and healed, a
    # drain), a lenet tenant preempted and resumed, a rollout with a
    # planted bad canary; every replica and driver a child of this script
    fleet5o = fleet_on_card(ck, dev, smi)
    mark("5o fleet")

    # phase 5p: the round over the wire: commbench's five verdicts on the
    # card, soak's partition and fenced-ship legs with every lenet driver
    # a child of this script started over the fake-ssh wire, and a planted
    # copy that skips its crc checks
    net5p = net_on_card(ck, dev, smi)
    mark("5p the round over the wire")

    # phase 5q: the pod half's tensors: shardbench's six verdicts, CaffeNet's
    # sharded round against its replicated one at full width with a
    # sharded checkpoint, 2-process gangs (hierarchical under a plan, the
    # audit catching a flip) against one process, roundbench's audit leg,
    # planted faults
    pod5q = pod_tensors_on_card(ck, dev, smi)
    mark("5q the pod half's tensors")

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
        "caffe_cli_extract_features": data_path["extract_launches"],
        "caffenet_training_tar_dir": images["tar_dir"]["launches"],
        **images["cli"]["launches"],
        "window_data_batch": images["window"]["launches"],
        # phase 5e: caffe_cli's hierarchical run and each codec's rounds
        "caffe_cli_train_hierarchical":
            round_report["hierarchical"]["launches"],
        "round_hierarchical_2x2_b64":
            round_report["hierarchical_b64"]["launches"],
        **{f"round_codec_{c}": r["launches"]
           for c, r in round_report["codecs"].items()
           if isinstance(r, dict)},
        # phase 5f: the bench's paths, profile_step and the telemetry runs
        **bench_report["launches"],
        # phase 5g: mnist_siamese through caffe_cli and its card-vs-CPU
        # iterations
        "caffe_cli_train_mnist_siamese": graph["siamese"]["launches"],
        "solver_mnist_siamese_card_vs_cpu":
            graph["siamese"]["card_vs_cpu_launches"],
        # phase 5h: cifar10_full_sigmoid_bn through caffe_cli on one
        # device and two workers, and its card-vs-CPU iterations
        "caffe_cli_train_cifar10_full_sigmoid_bn": bn["single"]["launches"],
        "caffe_cli_train_cifar10_full_sigmoid_bn_sync2":
            bn["sync2"]["launches"],
        "caffe_cli_train_cifar10_full_sigmoid_bn_local_sgd2":
            bn["local_sgd2"]["launches"],
        "solver_cifar10_full_sigmoid_bn_card_vs_cpu":
            bn["single"]["card_vs_cpu_launches"],
        # phase 5i: CaffeNet from record shards through caffe_cli (and the
        # same-seed LMDB run, the HDF5 and binary weights scored, the
        # resume from the .solverstate.h5), the bridge's rounds, HDF5Data
        "caffe_cli_train_records": tier["train"]["launches"],
        "caffe_cli_train_lmdb_same_seed": tier["train"]["lmdb5_launches"],
        "caffe_cli_test_hdf5_and_binary_weights":
            tier["train"]["test_launches"],
        "caffe_cli_train_resume_solverstate_h5":
            tier["train"]["resume_launches"],
        **{f"round_{name}_local_sgd": n
           for name, n in tier["bridge"]["launches"].items()},
        "caffe_cli_train_hdf5_classification":
            tier["hdf5_classification"]["launches"],
        # phase 5j: train_cifar's Solver run, its two-worker run and its
        # card-vs-CPU iterations, CaffeNet over JPEGs and PNGs through
        # caffe_cli, each classify_cli run and detect_cli
        **tools["train_cifar"]["launches"],
        "caffe_cli_train_image_data_png":
            tools["image_data_png"]["launches"],
        **tools["classify"]["launches"],
        # phase 5k: CaffeNet's Solver from shards with each feed, the
        # learning proxy (1x, 8-way, hier in one run), its card-vs-CPU
        # iterations and the τ sweep
        **{f"solver_caffenet_records_{m}": plane["augment"][m]["launches"]
           for m in ("host_transform", "augment_host", "augment_device")},
        "learning_proxy_cifar10_full": plane["proxy"]["launches"],
        "learning_proxy_card_vs_cpu":
            plane["proxy"]["card_vs_cpu"]["launches"],
        "tausweep_cifar10_full": plane["proxy"]["sweep"]["launches"],
        # phase 5l: tools/serve.py's process (warm-ups, every request and
        # classify_cli --server's crops), the planted server's, the local
        # classify_cli it is held against, and caffe.Net and get_solver
        "serve_http_caffenet_f32":
            serving_5l["serve"]["launches_child"],
        "serve_http_planted_slo_canary":
            serving_5l["serve"]["planted"]["launches_child"],
        "classify_cli_local_vs_server":
            serving_5l["serve"]["launches_local_cli"],
        **serving_5l["pycaffe"]["launches"],
        # phase 5n: perf_probe's parts, serveload, the profiler capture,
        # feedbench (no kernel) and roundbench
        **obs5n["launches"],
        # phase 5o: the fleet's replicas (each cleanly exited process's
        # own counts, summed), this process's references and rollout
        # engines, and the lenet drivers
        **fleet5o["launches"],
        # phase 5p: commbench's trainings and the net soak's drivers
        **net5p["launches"],
        # phase 5q: shardbench, CaffeNet's sharded and replicated rounds,
        # each gang's ranks (summed), the one-process references,
        # roundbench and the planted tile's trainer
        **pod5q["launches"]}
    def solver_launches(kernel):   # the paths that run ``kernel``
        return {m: c[kernel] for m, c in solver_paths.items()
                if c.get(kernel)}
    def rows_of(rows, kernel=None, dtype="float32", batch=GN_BATCH):
        # norm1 and norm2 without the fold, as the per-layer path runs
        # them: the folded norm2 (same shape, one max an element more)
        # is checked and timed in per_shape, and no single library call
        # computes ReLU + LRN
        return [r for r in rows if r["case"].startswith("googlenet_")
                and r["case"].endswith(f"_b{batch}")
                and r["dtype"] == dtype and not r.get("relu")
                and (kernel is None or r["kernel"] == kernel)]
    fwd_rows = [r for r in lrn_train_rows
                if r["kernel"] == "lrn_across_channels_fwd"]
    bwd_rows = [r for r in lrn_train_rows
                if r["kernel"] == "lrn_across_channels_bwd"]
    lrn_paths = [m for m in tl if m.startswith(("caffenet", "googlenet"))]
    # the ReLU-folded launches, by path: GoogLeNet's app runs under the
    # committed auto plan (phase 5) and phase 5m's fused round and
    # fused serving
    fz = fused["train"]["launches"]["fused"]
    fs = {k: r["launches"] for k, r in fused["serve"].items()
          if isinstance(r, dict) and "launches" in r}

    def folds_of(key: str, suffix: str, extra: dict) -> dict:
        return {p: n for p, n in {
            **{f"{m}_training{suffix}": tl[m].get(key, 0)
               for m in lrn_paths}, **extra}.items() if n}

    kernels = [
        kernel_entry(
            "lrn_across_channels", "sparknet_tpu_torch/ops/csrc/lrn.cu",
            "sparknet_tpu/ops/pallas_kernels.py:72",
            {**{f"{m}_serving_{d}": served[m][d]["lrn_launches"]
                for m in served for d in ("bf16", "f32")},
             **{f"{m}_training_eval": tl[m]["lrn_across_channels"]
                for m in lrn_paths},
             **solver_launches("lrn_across_channels"),
             **{f"googlenet_serving_f32_b64_{k}_5m":
                r["lrn_across_channels"] for k, r in fs.items()}},
            lrn_rows, rows_of(lrn_rows, dtype="bfloat16", batch=64),
            folds_of("lrn_across_channels_relu", "_eval", {
                f"googlenet_serving_f32_b64_{k}_5m":
                    r.get("lrn_across_channels_relu", 0)
                for k, r in fs.items()})),
        kernel_entry(
            "lrn_across_channels_fwd", "sparknet_tpu_torch/ops/csrc/lrn.cu",
            "sparknet_tpu/ops/pallas_kernels.py:56",
            {**{f"{m}_training": tl[m]["lrn_across_channels_fwd"]
                for m in lrn_paths},
             **solver_launches("lrn_across_channels_fwd"),
             "googlenet_fused_round_5m": fz["lrn_across_channels_fwd"]},
            fwd_rows, rows_of(fwd_rows),
            folds_of("lrn_across_channels_fwd_relu", "", {
                "googlenet_fused_round_5m":
                    fz.get("lrn_across_channels_fwd_relu", 0)})),
        kernel_entry(
            "lrn_across_channels_bwd",
            "sparknet_tpu_torch/ops/csrc/lrn_bwd.cu",
            "sparknet_tpu/ops/pallas_kernels.py:83",
            {**{f"{m}_training": tl[m]["lrn_across_channels_bwd"]
                for m in lrn_paths},
             **solver_launches("lrn_across_channels_bwd"),
             "googlenet_fused_round_5m": fz["lrn_across_channels_bwd"]},
            bwd_rows, rows_of(bwd_rows),
            folds_of("lrn_across_channels_bwd_relu", "", {
                "googlenet_fused_round_5m":
                    fz.get("lrn_across_channels_bwd_relu", 0)})),
        kernel_entry(
            "max_pool_bwd", "sparknet_tpu_torch/ops/csrc/maxpool_bwd.cu",
            "sparknet_tpu/ops/pallas_kernels.py:203",
            {**{f"{m}_training": tl[m]["max_pool_bwd"] for m in tl},
             **solver_launches("max_pool_bwd"),
             "googlenet_fused_round_5m": fz["max_pool_bwd"],
             # a path without a pool: its count stays 0
             "caffe_cli_train_mnist_autoencoder":
                 graph["autoencoder"]["launches"]["max_pool_bwd"],
             "caffe_cli_train_hdf5_classification":
                 tier["hdf5_classification"]["launches"]["max_pool_bwd"]},
            pool_rows, rows_of(pool_rows)),
        # no TPU counterpart: they take the place of the JAX package's
        # native libjpeg decode and its resize.  Main path: CaffeNet from
        # tars, each image 375x500 4:2:0 (ImageNet's commonest) to 256.
        kernel_entry(
            "ycc_to_rgb", "sparknet_tpu_torch/ops/csrc/jpeg.cu",
            "sparknet_tpu/native/data_pipeline.cpp:217",
            solver_launches("ycc_to_rgb"), images["kernels"]["ycc_rows"],
            images["kernels"]["ycc_rows"][:1]),
        kernel_entry(
            "resize_bilinear", "sparknet_tpu_torch/ops/csrc/jpeg.cu",
            "sparknet_tpu/native/data_pipeline.cpp:248",
            solver_launches("resize_bilinear"),
            images["kernels"]["resize_rows"],
            images["kernels"]["resize_rows"][:1]),
    ]
    for k in kernels:
        if len(k["main_path_rows"]) != {"max_pool_bwd": 13, "ycc_to_rgb": 1,
                                        "resize_bilinear": 1}.get(
                                            k["name"], 2):
            fail(f"kernels line: main-path rows of {k['name']}: "
                 f"{k['main_path_rows']}")
    mark("6 kernels line")
    print(f"timeline [{smi}] " + json.dumps(
        {"phases_s": dict(timeline),
         "total_s": round(sum(t for _, t in timeline), 1)}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
