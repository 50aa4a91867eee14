"""Serial against parallel feed: the input pipeline's parity gate.

    python -m sparknet_tpu_torch.tools.feedbench [--seconds 2] [--batch 32]
        [--records 256] [--workers N] [--corrupt] [--records-leg]
        [--seed 0] [--out FILE] [--device cuda|cpu]

The port's copy of the root ``tools/feedbench.py``, with the port's
``--device`` (where ``db_feed`` decodes encoded Datums: the card unless
the caller asks for the CPU).  It builds a small synthetic LMDB, then
streams the same batches through ``db_feed`` twice, once on the serial
reference path and once through the decode pool, and
fails (exit 1) unless the parallel stream is bit-identical: the same
pixels, the same labels and, with ``--corrupt`` (``corrupt_record:0.1``
fault injection), the same quarantine accounting.  The serial leg runs
for half of ``--seconds``; the parallel leg replays its batch count.

``--records-leg`` extends the triangle to record shards: the LMDB is
converted once (the ``tools/convert.py`` path), then the same batches
are replayed from local shards through the ranged-read pool, and from a
``VerifyingStore`` through a tiered ``ShardCache`` (2 RAM shards and a
spill directory) cold and warm; all of them must equal the serial LMDB
stream, the cache's tiers must show misses, new hits and (once the cold
pass streamed past the RAM tier) disk hits, and a corrupt byte planted
mid-block in a copy of the shards must be quarantined and attributed to
its shard.  :func:`run` takes any LMDB of raw Datums (the card's smoke
runs it over full-size CaffeNet records).

Prints one JSON verdict line on stdout, the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# the serial reference leg's decode threads: the JAX package's
# ``workers=0`` path is one pool thread in the port (``feed_workers``),
# which pulls, decodes and delivers in the same order
SERIAL_WORKERS = 1


def build_db(path: str, n: int, shape=(3, 16, 16), seed: int = 0) -> None:
    from ..data.db import array_to_datum
    from ..data.lmdb_io import write_lmdb
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, size=(n,) + shape).astype(np.uint8)
    labels = rng.integers(0, 10, size=n)
    write_lmdb(path, [(b"%08d" % i, array_to_datum(imgs[i], int(labels[i])))
                      for i in range(n)])


def _data_layer(source: str, batch: int, backend: str):
    from ..models.dsl import layer
    return layer("d", "Data", [], ["data", "label"],
                 data_param={"source": source, "batch_size": batch,
                             "backend": backend},
                 transform_param={"scale": 0.5, "mean_value": [16.0]})


def _drain(feed, n_batches: int | None, seconds: float) -> tuple:
    batches = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while (len(batches) < n_batches if n_batches is not None
           else time.perf_counter() < deadline):
        b = next(feed)
        # copy: the feed may reuse its buffers, and the compare holds
        # every batch at once
        batches.append({k: np.array(v) for k, v in b.items()})
    return batches, time.perf_counter() - t0


def _leg(batches: list, quarantine, stats, dt: float) -> dict:
    images = sum(b["data"].shape[0] for b in batches)
    return {"batches": batches, "quarantine": quarantine.report(),
            "stats": stats.snapshot(), "seconds": round(dt, 3),
            "img_s": round(images / dt, 1) if dt > 0 else 0.0}


def run_leg(path: str, batch: int, workers: int, n_batches: int | None,
            seconds: float, seed: int, records: int = 0,
            device: str = "cuda") -> dict:
    """Stream batches off one fresh ``db_feed``: the arrays, the
    quarantine report and the throughput.  Bounded by ``n_batches``
    when given (the parity replay), else by the time budget."""
    from ..data.db import db_feed
    from ..data.integrity import Quarantine, QuarantinePolicy
    from ..data.pipeline import FeedStats
    from ..proto.caffe_pb import Phase
    from ..utils import faults

    faults.reset_injector()   # each leg re-arms one-shot fault state
    quarantine = Quarantine(QuarantinePolicy(max_fraction=0.5),
                            epoch_size=records or None, source=path)
    stats = FeedStats()
    feed = db_feed(_data_layer(path, batch, "LMDB"), Phase.TRAIN, seed=seed,
                   quarantine=quarantine, workers=workers, stats=stats,
                   device=device)
    try:
        batches, dt = _drain(feed, n_batches, seconds)
    finally:
        feed.close()
    return _leg(batches, quarantine, stats, dt)


def compare(serial: dict, parallel: dict, cross_source: bool = False,
            label: str = "parallel") -> list[str]:
    errs = []
    a, b = serial["batches"], parallel["batches"]
    if len(a) != len(b):
        return [f"batch count mismatch: serial {len(a)} vs {label} "
                f"{len(b)}"]
    for i, (x, y) in enumerate(zip(a, b)):
        for k in x:
            if not np.array_equal(x[k], y[k]):
                errs.append(f"batch {i} key {k!r} differs vs {label} "
                            f"(max abs diff "
                            f"{np.abs(x[k] - y[k]).max():.3g})")
    qa, qb = dict(serial["quarantine"]), dict(parallel["quarantine"])
    for q in (qa, qb):   # examples carry reprs; counts are the contract
        q.pop("examples", None)
        if cross_source:
            # the LMDB and records legs name different sources by
            # construction; admission counts are the cross-source contract
            q.pop("by_source", None)
    if qa != qb:
        errs.append(f"quarantine accounting differs: serial {qa} vs "
                    f"{label} {qb}")
    return errs


def run_records_leg(shards: str, batch: int, workers: int, n_batches: int,
                    seed: int, records: int = 0, verify: bool = False,
                    cache=None) -> dict:
    """Replay ``n_batches`` from a record-shard source through
    ``records_feed``, with :func:`run_leg`'s transform and quarantine, so
    the streams must be bit-identical."""
    from ..data.integrity import Quarantine, QuarantinePolicy
    from ..data.pipeline import FeedStats
    from ..data.records import records_feed
    from ..proto.caffe_pb import Phase
    from ..utils import faults

    faults.reset_injector()
    quarantine = Quarantine(QuarantinePolicy(max_fraction=0.5),
                            epoch_size=records or None, source=shards)
    stats = FeedStats()
    feed = records_feed(_data_layer(shards, batch, "RECORDS"), Phase.TRAIN,
                        seed=seed, quarantine=quarantine, workers=workers,
                        stats=stats, verify=verify, cache=cache)
    try:
        batches, dt = _drain(feed, n_batches, 0.0)
    finally:
        feed.close()
    return _leg(batches, quarantine, stats, dt)


def convert_db_to_shards(db: str, out_dir: str, shard_bytes: int,
                         device: str = "cuda") -> dict:
    """LMDB -> shards in cursor order (the ``tools/convert.py`` path)."""
    from ..data.records import convert_to_shards
    from . import convert
    return convert_to_shards(convert.iter_db(db, "LMDB", device=device),
                             out_dir, shard_bytes=shard_bytes)


def check_planted_corruption(shards_dir: str, tmp: str, batch: int,
                             records: int, seed: int) -> list[str]:
    """Flip one byte inside a record block of a copy of the shard set;
    the records feed must quarantine that record, attributed to its
    shard: never wrong pixels, never a crash."""
    from ..data.records import RecordShard
    from ..utils import faults

    faults.reset_injector()
    planted = os.path.join(tmp, "planted")
    shutil.copytree(shards_dir, planted)
    name = sorted(n for n in os.listdir(planted) if n.endswith(".rec"))[0]
    victim = os.path.join(planted, name)
    shard = RecordShard.open(victim)
    pos = shard.offset(0) + shard.stride // 2
    with open(victim, "r+b") as f:     # flip a byte mid-block of record 0
        f.seek(pos)
        orig = f.read(1)[0]
        f.seek(pos)
        f.write(bytes([orig ^ 0xFF]))
    leg = run_records_leg(planted, batch, 2,
                          max(1, records // batch), seed, records=records)
    rep = leg["quarantine"]
    errs = []
    if rep["total_bad"] < 1:
        errs.append("planted corrupt record block was NOT quarantined")
    if not any(name in src for src in rep.get("by_source", {})):
        errs.append(f"planted corruption not attributed to shard "
                    f"{name!r}: by_source={rep.get('by_source')}")
    return errs


def _datum_stride(db: str, device) -> int:
    """Bytes of one raw record of ``db`` as a shard stores it: the
    first Datum's pixels and an int64 label."""
    from ..data.db import datum_to_array, open_db
    img, _ = datum_to_array(open_db(db, "LMDB").first()[1], device=device)
    return int(np.prod(img.shape)) + 8


def _cache_counts(cache) -> dict:
    t = cache.tier_counts()
    return {"cache_hits": t["ram_hits"], "cache_disk_hits": t["disk_hits"],
            "cache_misses": t["misses"]}


def records_triangle(db: str, tmp: str, serial: dict, *, batch: int,
                     records: int, workers: int, corrupt: bool, seed: int,
                     device) -> tuple[list[str], dict]:
    """``--records-leg``: the shards against the serial LMDB stream
    (local, through the verifying store and a tiered cache cold and
    warm), the cache's tiers and the planted corrupt block."""
    from ..data.pipeline import ShardCache
    shards_dir = os.path.join(tmp, "shards")
    n_batches = len(serial["batches"])
    stride = _datum_stride(db, device)
    conv = convert_db_to_shards(
        db, shards_dir, shard_bytes=max(stride, records * stride // 4),
        device=device)
    n_shards = len(conv["shards"])
    per_shard = -(-records // max(1, n_shards))
    rec_local = run_records_leg(shards_dir, batch, workers, n_batches, seed,
                                records=records)
    errs = compare(serial, rec_local, cross_source=True, label="records")
    cache = ShardCache(max_shards=2, spill_dir=os.path.join(tmp, "spill"),
                       max_spill=16)
    rec_store = run_records_leg(shards_dir, batch, workers, n_batches, seed,
                                records=records, verify=True, cache=cache)
    errs += compare(serial, rec_store, cross_source=True,
                    label="records+store")
    cold = _cache_counts(cache)
    rec_warm = run_records_leg(shards_dir, batch, workers, n_batches, seed,
                               records=records, verify=True, cache=cache)
    errs += compare(serial, rec_warm, cross_source=True,
                    label="records+warm-cache")
    warm = _cache_counts(cache)
    if cold["cache_misses"] < 1:
        errs.append("cold records replay never missed the cache (cache "
                    "not exercised)")
    if not (warm["cache_hits"] + warm["cache_disk_hits"]
            > cold["cache_hits"] + cold["cache_disk_hits"]):
        errs.append("warm records replay produced no new cache hits")
    # the disk tier fires only once the cold pass streamed past the
    # 2-shard RAM tier (evictions spilled, the warm pass rereads them)
    if (n_shards > 2 and n_batches * batch > 2 * per_shard
            and warm["cache_disk_hits"] < 1):
        errs.append(f"disk spill tier never hit (shards={n_shards}, "
                    f"tiers={cache.tier_counts()}, warm={warm})")
    if corrupt:
        rep = rec_local["quarantine"]
        if rep["total_bad"] and not any(
                shards_dir in s for s in rep.get("by_source", {})):
            errs.append("injected corruption not attributed to the shard "
                        f"source: by_source={rep.get('by_source')}")
    else:
        errs += check_planted_corruption(shards_dir, tmp, batch, records,
                                         seed)
    return errs, {
        "records_leg": True,
        "shards": n_shards,
        "records_img_s": rec_local["img_s"],
        "records_store_img_s": rec_store["img_s"],
        "records_warm_img_s": rec_warm["img_s"],
        "records_speedup": round(rec_local["img_s"] / serial["img_s"], 2)
        if serial["img_s"] else None,
        "records_read_s": rec_local["stats"].get("read_s"),
        "cache_cold": cold,
        "cache_warm": warm,
    }


def run(db: str, *, seconds: float = 2.0, batch: int = 32,
        records: int = 256, workers: int | None = None,
        corrupt: bool = False, records_leg: bool = False, seed: int = 0,
        device: str = "cuda") -> dict:
    """The verdict over the LMDB ``db`` of ``records`` raw Datums (what
    :func:`main` prints).  ``corrupt`` expects ``SPARKNET_FAULT`` to hold
    the injection, as :func:`main` sets it."""
    from ..data.pipeline import feed_workers
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    workers = workers if workers is not None else max(2, feed_workers())
    rec: dict = {}
    serial = run_leg(db, batch, SERIAL_WORKERS, None, seconds / 2, seed,
                     records=records, device=dev)
    parallel = run_leg(db, batch, workers, len(serial["batches"]), seconds,
                       seed, records=records, device=dev)
    errs = compare(serial, parallel)
    if records_leg:
        with tempfile.TemporaryDirectory(prefix="feedbench_") as tmp:
            more, rec = records_triangle(
                db, tmp, serial, batch=batch, records=records,
                workers=workers, corrupt=corrupt, seed=seed, device=dev)
        errs += more
    return {
        "metric": "feed_parity",
        "ok": not errs,
        "errors": errs,
        "batches": len(serial["batches"]),
        "batch": batch,
        "workers": workers,
        "corrupt": bool(corrupt),
        "serial_img_s": serial["img_s"],
        "parallel_img_s": parallel["img_s"],
        "speedup": round(parallel["img_s"] / serial["img_s"], 2)
        if serial["img_s"] else None,
        "quarantined": serial["quarantine"]["total_bad"],
        **rec,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="wall budget for the serial leg (default 2)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--records", type=int, default=256)
    ap.add_argument("--workers", type=int, default=None,
                    help="parallel-leg pool width (default "
                         "SPARKNET_FEED_WORKERS, min 2 so the pool is "
                         "exercised)")
    ap.add_argument("--corrupt", action="store_true",
                    help="run with corrupt_record:0.1 fault injection: "
                         "parity must hold through the quarantine path")
    ap.add_argument("--records-leg", action="store_true",
                    help="also convert to record shards and replay through "
                         "records_feed (local, store + tiered cache, warm "
                         "cache), all bit-identical to the serial leg")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.corrupt:
        os.environ["SPARKNET_FAULT"] = "corrupt_record:0.1"
        os.environ["SPARKNET_FAULT_ATTEMPT"] = "0"
    with tempfile.TemporaryDirectory(prefix="feedbench_db_") as tmp:
        db = os.path.join(tmp, "lmdb")
        build_db(db, args.records, seed=args.seed)
        verdict = run(db, seconds=args.seconds, batch=args.batch,
                      records=args.records, workers=args.workers,
                      corrupt=args.corrupt, records_leg=args.records_leg,
                      seed=args.seed, device=args.device)
    line = json.dumps(verdict)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if verdict["errors"]:
        for e in verdict["errors"]:
            print(f"feedbench: PARITY FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
