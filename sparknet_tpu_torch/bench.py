"""Headline benchmark of the port: CaffeNet training throughput on the card.

    python -m sparknet_tpu_torch.bench [--device cuda|cpu]

The port's counterpart of the root ``bench.py`` (which belongs to the JAX
package and stays as it is).  The methodology is the reference's
published one: 20 training iterations at batch 256, full forward,
backward and update, data resident on the device (reference:
caffe/docs/performance_hardware.md:19-25, the ``caffe train`` 20-iteration
protocol; best single-GPU baseline 19.2 s, about 267 img/s on a K40 with
cuDNN), plus the eval-pass throughput (performance_hardware.md:20,25) and
model-FLOPs MFU.

Prints ONE JSON line on stdout, with the JAX bench line's keys and
meanings; progress and diagnostics go to stderr.  The measurement runs in
a child process under ``BENCH_TIMEOUT_S``; on any failure the line
carries ``error`` and the process exits non-zero.  It runs on the card
unless ``--device cpu`` asks for the CPU; with no CUDA device and no
``--device cpu`` it fails, never measuring the CPU in the card's place.

Tiers (each a key of the line):

- **Headline** (``by_dtype``): per compute dtype (f32 with TF32 off, and
  bf16 mixed precision), ``REPS`` blocks of ``ITERS`` Solver steps
  (``utils/profiling.py::train_block``) enqueued back to back, the window
  ending at ``torch.cuda.synchronize()``, the median of ``WINDOWS``
  windows; the eval pass the same way over test-net forwards.  ``mfu``
  is ``flops_per_step`` (``profiling.step_cost_flops``) over the step
  time, against the card's peak for that dtype (``peak_flops``, named in
  each dtype's entry): the share of the whole step, elementwise work and
  update included, that the counted multiply-adds would take at peak.
  ``value`` is the faster dtype's img/s.
- **Feed** (``feed_in_loop``): ``data/prefetch.py::device_feed`` into
  ``Solver.set_train_data`` with uint8 staging and a cast on the card;
  feed-alone, compute-alone and in-loop at one batch, the overlap, and
  the per-stage seconds of ``FeedStats``.
- **Round** (``round_overhead``): ``parallel/trainer.py``'s
  ``DistributedTrainer`` on one card, bare rounds against rounds with
  checkpoints and the guard, synchronous against asynchronous
  (``SPARKNET_ASYNC_CKPT``, ``harvest_lag``), with the ``stall_s``
  components.  The cross-replica audit leg is ROADMAP A12 (``null``,
  the reason under ``not_ported_legs``).
- **Serving** (``serving``): ``tools/serveload.run_report`` as the JAX
  bench runs it: closed-loop batch-1 against dynamic saturation through
  ``InferenceEngine``/``run_closed_loop``, a paced sweep at 0.5x and 1x
  saturation and a 2x-overload point, every served answer held bit for
  bit against its solo run, the SLO monitor's verdicts.
- **Records** (``feed_records``): the convert-once leg, the JAX line's
  keys.  Sustained host feed img/s from record shards
  (``data/records.py``) through a warm ``ShardCache`` against the
  per-epoch decode of encoded Datums through ``db_feed`` on one decode
  thread, the same transform and batch, and the one-time ``convert_s``.
  The Datums carry the committed ImageNet-sized JPEG fixtures
  (``data/jpeg_fixtures/imagenet_*.jpg``), cycled to ``BENCH_RECORDS_N``
  and force-resized to ``BENCH_RECORDS_EDGE`` (the JAX bench encodes
  random pixels with PIL, which the card's machine cannot do); they
  decode on the port's own path, nvJPEG and the resize kernel on the
  card.  The defaults are CaffeNet's feed: 1,024 records at its stored
  256² (``create_imagenet.sh``'s resize), batch 256, 5 epochs, so that
  the timed records window holds 5,120 images (the JAX bench's are 96
  of 64², batch 32, 3 epochs).
- ``shard_round`` (ROADMAP A12) is reported as ``{"not_ported": ...}``.

Env knobs, the JAX bench's names where they apply: BENCH_MODEL
(caffenet | googlenet | vgg16 | lenet), BENCH_BATCH, BENCH_ITERS,
BENCH_REPS, BENCH_WINDOWS, BENCH_DTYPE (f32 | bf16), BENCH_TIMEOUT_S;
BENCH_FEED=0, BENCH_FEED_BATCH, BENCH_FEED_ITERS, BENCH_FEED_DELAY_S,
BENCH_FEED_U8; BENCH_ROUND=0, BENCH_ROUND_N, BENCH_ROUND_TAU,
BENCH_ROUND_LAG, BENCH_ROUND_BATCH, BENCH_ROUND_EVERY; BENCH_SERVING=0,
BENCH_SERVE_MODEL, BENCH_SERVE_CLIENTS, BENCH_SERVE_WINDOW,
BENCH_SERVE_SECONDS; BENCH_FEED_RECORDS=0, BENCH_RECORDS_N,
BENCH_RECORDS_EDGE, BENCH_RECORDS_BATCH, BENCH_RECORDS_EPOCHS.  The JAX bench's ``BENCH_PLATFORM=cpu`` is
``--device cpu`` here; ``BENCH_SCAN`` does not apply (a block is a
plain loop); ``BENCH_FUSE`` (off | auto | all | a plan file) sets
``SPARKNET_FUSE`` for every net the child builds, and the line's
``fuse_plan`` and ``tune_plan`` are the train net's ids;
``BENCH_SHARD`` raises (ROADMAP A12).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable

# Per-model K40+cuDNN baselines (the rows the JAX bench cites):
#   caffenet: 19.2 s / 20 iter x 256 train, 60.7 s / 50k eval
#     (caffe/docs/performance_hardware.md:24-25)
#   googlenet: 1123.8 ms fwd+bwd avg / 562.8 ms fwd @ batch 128
#     (caffe/models/bvlc_googlenet/readme.md:24-27)
_BASELINES = {
    "caffenet": (267.0, 50000 / 60.7, 19.2),
    "googlenet": (128 / 1.1238, 128 / 0.5628, None),
}

NOT_PORTED = {
    "shard_round": {"not_ported": "ROADMAP A12"},
}
_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name) or default)


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name) or default)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """What one bench run measures; :meth:`from_env` reads the knobs."""

    model: str = "caffenet"
    batch: int = 256
    iters: int = 20
    reps: int = 5
    windows: int = 3
    dtypes: tuple[str, ...] = ("bf16", "f32")
    feed: bool = True
    feed_batch: int | None = None       # None: ``batch``
    feed_iters: int = 8
    feed_delay_s: float = 0.0
    feed_u8: bool = True
    round: bool = True
    round_n: int = 4
    round_tau: int = 4
    round_lag: int = 2
    round_batch: int | None = None      # None: ``batch``
    round_every: int = 2
    serving: bool = True
    serve_model: str | None = None      # None: ``model``
    serve_clients: int = 8
    serve_window: int = 16
    serve_seconds: float = 1.5
    feed_records: bool = True
    records_n: int = 1024
    records_edge: int = 256
    records_batch: int = 256
    records_epochs: int = 5

    @classmethod
    def from_env(cls) -> "BenchConfig":
        env = os.environ
        fuse = env.get("BENCH_FUSE")
        if fuse and fuse not in ("off", "0", "auto", "all") \
                and not os.path.isfile(fuse):
            raise ValueError(f"BENCH_FUSE={fuse!r}: not off|auto|all and "
                             f"no such plan file")
        if env.get("BENCH_SHARD", "0") != "0" or any(
                env.get(k) for k in ("BENCH_SHARD_N", "BENCH_SHARD_TAU",
                                     "BENCH_SHARD_BATCH")):
            raise NotImplementedError(
                "BENCH_SHARD: the sharded round is not ported (ROADMAP A12)")
        dtype = env.get("BENCH_DTYPE") or None
        if dtype not in (None, "f32", "bf16"):
            raise ValueError(f"BENCH_DTYPE={dtype!r} invalid (use f32 or "
                             f"bf16)")
        model = env.get("BENCH_MODEL") or "caffenet"
        return cls(
            model=model, batch=_env_int("BENCH_BATCH", 256),
            iters=_env_int("BENCH_ITERS", 20),
            reps=_env_int("BENCH_REPS", 5),
            windows=_env_int("BENCH_WINDOWS", 3),
            dtypes=(dtype,) if dtype else ("bf16", "f32"),
            feed=env.get("BENCH_FEED", "1") != "0",
            feed_batch=_env_int("BENCH_FEED_BATCH", 0) or None,
            feed_iters=_env_int("BENCH_FEED_ITERS", 8),
            feed_delay_s=_env_float("BENCH_FEED_DELAY_S", 0.0),
            feed_u8=env.get("BENCH_FEED_U8", "1") != "0",
            round=env.get("BENCH_ROUND", "1") != "0",
            round_n=_env_int("BENCH_ROUND_N", 4),
            round_tau=_env_int("BENCH_ROUND_TAU", 4),
            round_lag=_env_int("BENCH_ROUND_LAG", 2),
            round_batch=_env_int("BENCH_ROUND_BATCH", 0) or None,
            round_every=_env_int("BENCH_ROUND_EVERY", 2),
            serving=env.get("BENCH_SERVING", "1") != "0",
            serve_model=env.get("BENCH_SERVE_MODEL") or None,
            serve_clients=_env_int("BENCH_SERVE_CLIENTS", 8),
            serve_window=_env_int("BENCH_SERVE_WINDOW", 16),
            serve_seconds=_env_float("BENCH_SERVE_SECONDS", 1.5),
            feed_records=env.get("BENCH_FEED_RECORDS", "1") != "0",
            records_n=_env_int("BENCH_RECORDS_N", 1024),
            records_edge=_env_int("BENCH_RECORDS_EDGE", 256),
            records_batch=_env_int("BENCH_RECORDS_BATCH", 256),
            records_epochs=_env_int("BENCH_RECORDS_EPOCHS", 5))


def timed_windows(run: Callable[[], Any], reps: int, windows: int,
                  sync: Callable[[], None]) -> list[float]:
    """Host seconds of each of ``windows`` windows, each ``reps`` calls of
    ``run`` enqueued back to back and ended by ``sync()`` (on the card
    ``torch.cuda.synchronize``: the window ends when the device's work
    does, not when the host's last launch returns)."""
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def run(cfg: BenchConfig, device: str = "cuda",
        on_phase: Callable[[str | None], None] | None = None) -> dict:
    """Measure every tier of ``cfg`` on ``device`` and return the bench
    line as a dict.  ``on_phase(name)`` is called as each phase that
    runs the port's kernels starts (``bench_<model>_train_<dtype>``,
    ``bench_<model>_eval_<dtype>``, ``bench_feed_compute``,
    ``bench_feed_loop``, ``bench_feed_records``, ``bench_round_<leg>``,
    ``bench_serving``) and with None after the last.  A failing tier raises."""
    import numpy as np
    import torch

    from .data.pipeline import (FeedStats, ShardCache, feed_depth,
                                feed_workers)
    from .data.prefetch import device_feed
    from .proto.caffe_pb import load_solver_prototxt_with_net
    from .solvers.solver import Solver
    from .utils import perfledger
    from .utils.device import resolve_device
    from .utils.profiling import (BENCH_SOLVER_PROTOTXT, build_bench_model,
                                  eval_block, eval_cost_flops, peak_flops,
                                  record_fusion_plan, record_tuning,
                                  step_cost_flops, train_block)

    dev = resolve_device(device)
    phase = on_phase or (lambda name: None)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        sync = torch.cuda.synchronize
    else:
        kind = "cpu"
        sync = lambda: None   # noqa: E731  (CPU work is done on return)
    device_name = f"{dev.type}/{kind}"
    _log(f"device {device_name}")
    batch_n, iters, reps, windows = cfg.batch, cfg.iters, cfg.reps, \
        cfg.windows
    net, in_shape, classes = build_bench_model(cfg.model, batch_n)
    sp = load_solver_prototxt_with_net(BENCH_SOLVER_PROTOTXT, net)
    rng = np.random.default_rng(0)
    batch = {
        "data": torch.from_numpy(rng.normal(size=(batch_n,) + in_shape)
                                 .astype(np.float32)).to(dev),
        "label": torch.from_numpy(rng.integers(0, classes, size=batch_n)
                                  .astype(np.float32)).to(dev)}

    def solver_for(dtype: str) -> Solver:
        return Solver(sp, seed=0, device=dev, compute_dtype=(
            torch.bfloat16 if dtype == "bf16" else None))

    def measure(dtype: str) -> dict:
        phase(f"bench_{cfg.model}_train_{dtype}")
        solver = solver_for(dtype)
        solver.set_train_data(itertools.repeat(batch))
        flops_per_step = step_cost_flops(solver)
        block = train_block(solver, iters)
        t0 = time.perf_counter()
        block()
        sync()
        _log(f"[{dtype}] warm-up block in {time.perf_counter() - t0:.1f}s")
        dts = timed_windows(block, reps, windows, sync)
        for win, dt in enumerate(dts):
            _log(f"[{dtype}] train window {win + 1}/{windows}: "
                 f"{batch_n * iters * reps / dt:.1f} img/s ({dt:.3f}s / "
                 f"{reps}x{iters} iters)")
        dt = statistics.median(dts)
        img_s = batch_n * iters * reps / dt
        block_s = dt / reps * (20 / iters)   # the 20-iteration protocol
        phase(f"bench_{cfg.model}_eval_{dtype}")
        eval_block(solver, 1, batch)()
        sync()
        eval_dts = timed_windows(eval_block(solver, iters * reps, batch),
                                 1, windows, sync)
        eval_img_s = batch_n * iters * reps / statistics.median(eval_dts)
        _log(f"[{dtype}] eval: {eval_img_s:.1f} img/s")
        peak = peak_flops(kind, dtype)
        step_s = block_s / 20.0
        mfu = flops_per_step / step_s / peak if peak else None
        return {
            "images_per_sec": round(img_s, 1),
            "block_20x256_s": round(block_s, 3),
            "eval_images_per_sec": round(eval_img_s, 1),
            "mfu": round(mfu, 4) if mfu is not None else None,
            "flops_per_step": flops_per_step,
            "eval_flops_per_forward": eval_cost_flops(solver),
            "peak_flops": peak,
            "fuse_plan": record_fusion_plan(solver.train_net),
            "tune_plan": record_tuning(solver.train_net),
        }

    def measure_feed(dtype: str) -> dict:
        """Feed-alone, compute-alone and in-loop at one batch: distinct
        host batches flow through ``device_feed`` into the Solver (uint8
        shipped, cast to f32 on the card unless ``BENCH_FEED_U8=0``).
        ``BENCH_FEED_DELAY_S`` adds a per-batch host delay (a stand-in
        for decode) to the feed leg and the in-loop producer alike."""
        fbatch = cfg.feed_batch or batch_n
        depth = feed_depth()
        m = 4
        if cfg.feed_u8:
            host = [{"data": rng.integers(0, 256, size=(fbatch,) + in_shape
                                          ).astype(np.uint8),
                     "label": rng.integers(0, classes, size=fbatch
                                           ).astype(np.float32)}
                    for _ in range(m)]
            cast = {"data": torch.float32}
        else:
            host = [{"data": rng.normal(size=(fbatch,) + in_shape
                                        ).astype(np.float32),
                     "label": rng.integers(0, classes, size=fbatch
                                           ).astype(np.float32)}
                    for _ in range(m)]
            cast = None

        def stage(hb) -> dict:
            out = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
            return {k: v.to(cast[k]) if cast and k in cast else v
                    for k, v in out.items()}

        phase("bench_feed_compute")
        solver = solver_for(dtype)
        resident = [stage(hb) for hb in host]
        sync()
        solver.set_train_data(itertools.cycle(resident))
        solver.step(2)
        sync()
        t0 = time.perf_counter()
        solver.step(cfg.feed_iters)
        sync()
        compute_s = (time.perf_counter() - t0) / cfg.feed_iters
        del resident, solver

        t0 = time.perf_counter()
        staged = []
        for hb in host:
            if cfg.feed_delay_s:
                time.sleep(cfg.feed_delay_s)
            staged.append(stage(hb))
        sync()
        feed_alone = (time.perf_counter() - t0) / m
        del staged

        stats = FeedStats()

        def source():
            for hb in itertools.islice(itertools.cycle(host),
                                       cfg.feed_iters + 4):
                if cfg.feed_delay_s:
                    t = time.perf_counter()
                    time.sleep(cfg.feed_delay_s)
                    stats.note("decode", time.perf_counter() - t)
                yield hb

        phase("bench_feed_loop")
        solver = solver_for(dtype)
        feed = device_feed(source(), dev, depth=depth, device_cast=cast,
                           stats=stats)
        try:
            solver.set_train_data(feed)
            solver.step(2)
            sync()
            t0 = time.perf_counter()
            solver.step(cfg.feed_iters)
            sync()
            total = (time.perf_counter() - t0) / cfg.feed_iters
        finally:
            feed.close()
        # 1.0 when total == max(feed, compute), 0.0 when feed + compute
        denom = min(feed_alone, compute_s) or 1.0
        overlap = (feed_alone + compute_s - total) / denom * 100.0
        stages = stats.per_batch()
        out = {
            "batch": fbatch,
            "images_per_sec": round(fbatch / total, 1),
            "step_s": round(total, 4),
            "feed_alone_s_per_batch": round(feed_alone, 4),
            "compute_s_per_step": round(compute_s, 4),
            "bound": "feed" if feed_alone > compute_s else "compute",
            "feed_compute_ratio": round(feed_alone / max(compute_s, 1e-9),
                                        2),
            "overlap_pct": round(max(0.0, min(100.0, overlap)), 1),
            "read_s": stages["read_s"],
            "decode_s": stages["decode_s"],
            "transform_s": stages["transform_s"],
            "device_put_s": stages["device_put_s"],
            "workers": feed_workers(),
            "depth": depth,
            "staged_dtype": "uint8" if cfg.feed_u8 else "float32",
            "steps": 2 * (2 + cfg.feed_iters),
        }
        _log(f"[{dtype}] feed-in-loop @ b{fbatch}: {out['images_per_sec']} "
             f"img/s (feed-alone {feed_alone:.4f}s, compute "
             f"{compute_s:.4f}s, {out['bound']}-bound, overlap "
             f"{out['overlap_pct']}%)")
        return out

    def measure_feed_records() -> dict:
        """The decode-once leg: host feed img/s from record shards behind
        a warm tiered ``ShardCache`` against the per-epoch decode of
        encoded Datums through ``db_feed`` on one decode thread (the JAX
        bench's serial ``workers=0``), the same transform and batch; the
        records leg pays the decode once, at convert (``convert_s``)."""
        import tempfile

        from .data.db import datum_to_array, db_feed, open_db
        from .data.lmdb_io import write_lmdb
        from .data.records import convert_to_shards, records_feed
        from .models.dsl import layer
        from .proto.caffe_pb import Phase
        from .proto.textformat import PMessage
        from .proto.wireformat import encode
        phase("bench_feed_records")
        n, edge = cfg.records_n, cfg.records_edge
        rbatch, epochs = cfg.records_batch, cfg.records_epochs
        rrng = np.random.default_rng(0)
        fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "jpeg_fixtures")
        jpegs = []
        for i in range(8):
            with open(os.path.join(fixtures, f"imagenet_{i}.jpg"),
                      "rb") as f:
                jpegs.append(f.read())

        def encoded_datum(raw: bytes, label: int) -> bytes:
            # force-resized to edge x edge on decode (ReadImageToDatum
            # with a new height and width, encoded)
            m = PMessage()
            for k, v in (("channels", 3), ("height", edge), ("width", edge),
                         ("data", raw), ("label", label), ("encoded", True)):
                m.add(k, v)
            return encode(m, "Datum")

        def mk_lp(source: str, backend: str):
            return layer("d", "Data", [], ["data", "label"],
                         data_param={"source": source, "batch_size": rbatch,
                                     "backend": backend},
                         transform_param={"scale": 1.0 / 255})

        n_batches = max(1, epochs * n // rbatch)
        with tempfile.TemporaryDirectory() as tmp:
            db_path = os.path.join(tmp, "lmdb")
            write_lmdb(db_path, [
                (b"%08d" % i, encoded_datum(jpegs[i % len(jpegs)],
                                            int(rrng.integers(10))))
                for i in range(n)])

            # the per-epoch decode: every image decoded in every epoch
            stats_s = FeedStats()
            feedg = db_feed(mk_lp(db_path, "LMDB"), Phase.TRAIN, seed=0,
                            workers=1, stats=stats_s, device=dev)
            for _ in range(2):
                next(feedg)   # warm the LMDB pages and the decoder
            t0 = time.perf_counter()
            for _ in range(n_batches):
                next(feedg)
            serial_s = time.perf_counter() - t0
            feedg.close()

            # convert once: the decode paid here, never again
            shards_dir = os.path.join(tmp, "shards")
            reader = open_db(db_path, "LMDB")

            def decoded():
                for key, val in reader.items():
                    img, label = datum_to_array(val, key=key,
                                                source=db_path, device=dev)
                    yield (np.clip(np.round(img), 0, 255).astype(np.uint8),
                           label)

            t0 = time.perf_counter()
            conv = convert_to_shards(decoded(), shards_dir)
            convert_s = time.perf_counter() - t0
            reader.close()

            # the warm records leg: one epoch fills the cache, then timed
            cache = ShardCache(max_shards=max(4, len(conv["shards"])))
            stats_r = FeedStats()
            rfeed = records_feed(mk_lp(shards_dir, "RECORDS"), Phase.TRAIN,
                                 seed=0, stats=stats_r, cache=cache)
            for _ in range(max(1, n // rbatch)):
                next(rfeed)
            t0 = time.perf_counter()
            for _ in range(n_batches):
                next(rfeed)
            records_s = time.perf_counter() - t0
            rfeed.close()

        images = n_batches * rbatch
        out = {
            "feed_source": "records",
            "records": n,
            "edge": edge,
            "batch": rbatch,
            "epochs": epochs,
            "images_per_sec": round(images / records_s, 1),
            "serial_img_s": round(images / serial_s, 1),
            "speedup_x": round(serial_s / records_s, 2),
            "convert_s": round(convert_s, 3),
            "read_s": stats_r.per_batch()["read_s"],
            "serial_decode_s": stats_s.per_batch()["decode_s"],
            "cache": cache.tier_counts(),
        }
        _log(f"feed_records: warm {out['images_per_sec']} img/s vs serial "
             f"decode {out['serial_img_s']} img/s ({out['speedup_x']}x, "
             f"convert paid once: {convert_s:.2f}s)")
        return out

    def measure_round_overhead() -> dict:
        """Bare rounds against rounds with checkpoints and the guard, the
        synchronous outer loop against the asynchronous one (the
        asynchronous writer and ``harvest_lag``), f32, one worker on the
        card, the round's inputs resident on the card so the legs differ
        only in host bookkeeping; per-component stall seconds from
        ``DistributedTrainer.stall_s``."""
        from .parallel.trainer import DistributedTrainer, TrainerConfig
        rounds_n, tau, lag = cfg.round_n, cfg.round_tau, cfg.round_lag
        rbatch = cfg.round_batch or batch_n
        every = cfg.round_every
        feed = {
            "data": torch.from_numpy(rng.normal(
                size=(tau, rbatch) + in_shape).astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(
                0, classes, size=(tau, rbatch)).astype(np.float32)).to(dev)}
        # retention must cover the harvest lag
        keep = max(3, (lag + 1 + every - 1 + every - 1) // every + 1)

        def leg(name: str, async_on: bool, instrumented: bool) -> dict:
            phase(f"bench_round_{name}")
            saved = os.environ.get("SPARKNET_ASYNC_CKPT")
            os.environ["SPARKNET_ASYNC_CKPT"] = "1" if async_on else "0"
            try:
                with tempfile.TemporaryDirectory(prefix="bench_round_") \
                        as ck:
                    tr = DistributedTrainer(sp, 1, TrainerConfig(
                        strategy="local_sgd", tau=tau,
                        harvest_lag=lag if async_on else 0,
                        checkpoint_dir=ck if instrumented else None,
                        checkpoint_every=every, checkpoint_keep=keep,
                        guard_numerics=instrumented), seed=0, device=dev)
                    tr.train_round(feed)   # warm-up
                    tr.drain()
                    tr.stall_s = {k: 0.0 for k in tr.stall_s}
                    t0 = time.perf_counter()
                    for _ in range(rounds_n):
                        tr.train_round(feed)
                    tr.drain()
                    sync()
                    dt = time.perf_counter() - t0
                    rounds_run = tr.round
            finally:
                if saved is None:
                    os.environ.pop("SPARKNET_ASYNC_CKPT", None)
                else:
                    os.environ["SPARKNET_ASYNC_CKPT"] = saved
            stalls = {k: round(v / rounds_n, 4)
                      for k, v in tr.stall_s.items()}
            out = {"img_s": round(rbatch * tau * rounds_n / dt, 1),
                   "round_s": round(dt / rounds_n, 4),
                   "stall_s_per_round": stalls,
                   "stall_total_s_per_round": round(sum(stalls.values()),
                                                    4),
                   "rounds": rounds_run, "guard_trips": tr.guard_trips}
            _log(f"round_overhead[{name}]: {out['img_s']} img/s "
                 f"({out['round_s']}s/round, stalls {stalls})")
            return out

        bare = leg("bare", async_on=True, instrumented=False)
        sync_leg = leg("sync", async_on=False, instrumented=True)
        async_leg = leg("async", async_on=True, instrumented=True)
        return {
            "batch": rbatch, "tau": tau, "rounds": rounds_n,
            "harvest_lag": lag, "checkpoint_every": every,
            "workers": 1, "dtype": "f32",
            "bare": bare, "sync": sync_leg, "async": async_leg,
            "audit": None, "not_ported_legs": {"audit": "ROADMAP A12"},
            "sync_overhead_pct": round(
                (sync_leg["round_s"] - bare["round_s"])
                / bare["round_s"] * 100, 1),
            "async_overhead_pct": round(
                (async_leg["round_s"] - bare["round_s"])
                / bare["round_s"] * 100, 1),
            "stall_reduction_x": round(
                sync_leg["stall_total_s_per_round"]
                / max(async_leg["stall_total_s_per_round"], 1e-6), 1),
        }

    def measure_serving() -> dict:
        """The serving tier: ``tools/serveload.run_report`` in-process, as
        the JAX bench runs the root ``tools/serveload.py``: batch-1
        against dynamic saturation through the micro-batching engine, a
        paced sweep at 0.5x and 1x saturation with every served answer
        held bit for bit against its solo run, and a 2x-overload point
        (typed rejections, p99 under its bound, the SLO monitor's
        breach)."""
        from .tools import serveload
        phase("bench_serving")
        rep = serveload.run_report(
            model=cfg.serve_model or cfg.model, clients=cfg.serve_clients,
            window=cfg.serve_window, seconds=cfg.serve_seconds,
            fractions=(0.5, 1.0), device=dev)
        stats = rep.pop("engine_stats")   # the line stays one screen
        shapes = rep["batch_shapes"]
        # forwards on the device: each model's warm-up at every shape,
        # the solo references, and every dispatched batch
        rep["device_forwards"] = (len(shapes) + len(shapes) * 32 + 1
                                  + rep["batch1"]["dispatches"]
                                  + stats["dispatches"])
        _log(f"serving[{rep['model']}]: dynamic "
             f"{rep['saturation']['achieved_qps']} qps vs batch1 "
             f"{rep['batch1']['achieved_qps']} qps "
             f"({rep['verdicts']['batching_speedup_x']}x), overload p99 "
             f"{rep['overload']['p99_ms']} ms with "
             f"{rep['verdicts']['overload_rejected']} rejections, "
             f"mismatches {rep['verdicts']['exact_mismatches']}")
        return rep

    runs = {d: measure(d) for d in cfg.dtypes}
    best = max(cfg.dtypes, key=lambda d: runs[d]["images_per_sec"])
    b = runs[best]
    feed = measure_feed(best) if cfg.feed else None
    feed_records = measure_feed_records() if cfg.feed_records else None
    round_overhead = measure_round_overhead() if cfg.round else None
    serving = measure_serving() if cfg.serving else None
    if serving is not None and not serving["verdicts"]["bit_identical"]:
        raise RuntimeError(f"serving: {serving['verdicts']['exact_mismatches']}"
                           f" served answers differ from their solo runs")
    phase(None)
    base_img_s, base_eval_img_s, base_block_s = _BASELINES.get(
        cfg.model, (None, None, None))
    fp = perfledger.fingerprint(
        model=cfg.model, dtype=best, batch=batch_n, world=1,
        device=device_name, fuse_plan=b["fuse_plan"],
        tune_plan=b["tune_plan"],
        feed_source="records" if feed_records else "lmdb")
    return {
        "metric": f"{cfg.model}_train_images_per_sec",
        "value": b["images_per_sec"],
        "unit": "img/s",
        "vs_baseline": round(b["images_per_sec"] / base_img_s, 2)
        if base_img_s else None,
        "block_20x256_s": b["block_20x256_s"],
        "baseline_block_s": base_block_s,
        "eval_images_per_sec": b["eval_images_per_sec"],
        "eval_vs_baseline": round(b["eval_images_per_sec"]
                                  / base_eval_img_s, 2)
        if base_eval_img_s else None,
        "mfu": b["mfu"],
        "flops_per_step": b["flops_per_step"],
        "peak_flops": b["peak_flops"],
        "device": device_name,
        "dtype": best,
        "dtype_note": ("mixed precision; f32 master params and losses"
                       if best == "bf16" else None),
        "fuse_plan": b["fuse_plan"],
        "tune_plan": b["tune_plan"],
        "batch": batch_n,
        "iters_per_block": iters,
        "reps": reps,
        "windows": windows,
        "by_dtype": runs,
        "feed_in_loop": feed,
        "feed_records": feed_records,
        "round_overhead": round_overhead,
        "serving": serving,
        **NOT_PORTED,
        "provenance": perfledger.provenance(fp),
    }


# ---------------------------------------------------------------------------
# Parent and child
# ---------------------------------------------------------------------------

def _failure_line(model: str, note: str) -> str:
    return json.dumps({"metric": f"{model}_train_images_per_sec",
                       "value": 0.0, "unit": "img/s", "error": note})


def run_child(device: str) -> int:
    """Measure in this process and print the line; a failure prints the
    error line and returns 1."""
    model = os.environ.get("BENCH_MODEL") or "caffenet"
    # the plan source for every net this child builds (graph/fusion.py);
    # unset keeps the ambient SPARKNET_FUSE.  Nets latch it when built.
    if os.environ.get("BENCH_FUSE"):
        os.environ["SPARKNET_FUSE"] = os.environ["BENCH_FUSE"]
    try:
        result = run(BenchConfig.from_env(), device)
    except Exception as e:   # the boundary: the line names the failure
        import traceback
        traceback.print_exc()
        print(_failure_line(model, f"{type(e).__name__}: {e}"), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


def run_parent(device: str) -> int:
    """Run the child under ``BENCH_TIMEOUT_S`` (default 900 s) and relay
    its one line; a child that fails, times out or prints no JSON gives
    the error line and exit 1."""
    model = os.environ.get("BENCH_MODEL") or "caffenet"
    timeout_s = _env_float("BENCH_TIMEOUT_S", 900.0)
    child = subprocess.Popen(
        [sys.executable, "-m", "sparknet_tpu_torch.bench", "--child",
         "--device", device], stdout=subprocess.PIPE, cwd=_REPO_DIR)

    def on_signal(signum, frame):
        child.kill()
        print(_failure_line(model, f"benchmark killed by signal {signum}"),
              flush=True)
        os._exit(1)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    try:
        stdout, _ = child.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        print(_failure_line(model, f"timed out after {timeout_s:g}s"),
              flush=True)
        return 1
    lines = stdout.decode().strip().splitlines()
    try:
        result = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        print(_failure_line(model, f"child rc={child.returncode} printed "
                                   f"no JSON line"), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0 if child.returncode == 0 and "error" not in result else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to measure (default cuda)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    return run_child(args.device) if args.child else run_parent(args.device)


if __name__ == "__main__":
    sys.exit(main())
