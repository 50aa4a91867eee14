"""Performance ledger: the port's perf history as machine data.

The port's own copy of the parts of ``sparknet_tpu/utils/perfledger.py``
that its bench and op tables feed:

- :class:`PerfLedger` — an append-only, schema-versioned JSONL file, one
  entry per (capture, fingerprint): the **config fingerprint** (model /
  dtype / batch / world / device / backend ...), git sha, the
  correlation IDs (``utils/telemetry.correlation_ids``), the source
  artifact path and a flat ``metrics`` map.  The port's ledger has no
  default path: nothing is written unless the caller names the file, and
  the JAX package's ``perf/LEDGER.jsonl`` is never the port's.
- **Ingesters** — ``entries_from_bench`` (``python -m
  sparknet_tpu_torch.bench``'s line, or the driver's ``{"parsed": ...}``
  wrapper), ``entries_from_serving``, ``entries_from_roundbench``,
  ``entries_from_op_table`` (``tools/profile_step.py``'s
  ``op_table.json``), ``entries_from_tuning_table`` (``tools/tune.py
  run``'s ``tuning.json``) and ``entries_from_metrics_rollup``
  (``telemetry.fold_snapshots``), ``entries_from_serving_fleet``
  (``serveload --fleet``), ``entries_from_netsoak`` and
  ``entries_from_rollout`` (``soak --net`` and ``--rollout``) and
  ``entries_from_commbench`` and ``entries_from_shardbench``
  (``tools/shardbench.py``).  A bench tier the port marks
  ``{"not_ported": ...}`` yields no entry.  The pod soak's reader waits
  for the pod soak (ROADMAP A, order 3b).
- **Noise-aware baselines** — per (metric, fingerprint key):
  ``median ± k·1.4826·MAD`` over a trailing window; small samples refuse
  to gate, and because device and backend are part of the key, a CPU
  capture never gates against the card's (``fp.backend`` is ``"cuda"``
  for the card's captures, whose ``device`` is ``cuda/<card name>``).
- **Verdicts** — :func:`verdict` classifies a fresh value against its
  band as ``regression`` / ``improvement`` / ``within_band`` /
  ``not_gated``, with per-metric direction.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import time
from typing import Any, Iterable, Mapping

SCHEMA_VERSION = 1

# fingerprint fields, in canonical key order
FINGERPRINT_FIELDS = ("model", "dtype", "batch", "world", "device",
                      "backend", "fuse_plan", "replicas", "tune_plan",
                      "feed_source", "tau", "comm_codec", "sharding")

# fields newer than an entry read as their historical default, as in
# the JAX package, so the two ledgers key alike
_FINGERPRINT_DEFAULTS = {"fuse_plan": "off", "replicas": 1,
                         "tune_plan": "off", "feed_source": "lmdb",
                         "tau": 1, "comm_codec": "none", "sharding": "dp"}

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# Provenance helpers
# ---------------------------------------------------------------------------

_GIT_SHA: dict[str, str | None] = {}


def git_sha(root: str | None = None, short: bool = True) -> str | None:
    """The repo HEAD sha (cached per root), or None outside a checkout —
    a missing sha is recorded honestly, never invented."""
    root = root or _REPO_ROOT
    key = f"{root}:{short}"
    if key not in _GIT_SHA:
        try:
            cmd = ["git", "rev-parse"] + (["--short"] if short else [])
            out = subprocess.run(
                cmd + ["HEAD"], cwd=root, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, timeout=10)
            sha = out.stdout.decode().strip() if out.returncode == 0 else ""
            _GIT_SHA[key] = sha or None
        except (OSError, subprocess.SubprocessError):
            _GIT_SHA[key] = None
    return _GIT_SHA[key]


def fingerprint(model: str | None = None, dtype: str | None = None,
                batch: int | None = None, world: int | None = None,
                device: str | None = None,
                backend: str | None = None,
                fuse_plan: str | None = None,
                replicas: int | None = None,
                tune_plan: str | None = None,
                feed_source: str | None = None,
                tau: int | None = None,
                comm_codec: str | None = None,
                sharding: str | None = None) -> dict[str, Any]:
    """Canonical config fingerprint.  ``backend`` defaults to the
    platform half of ``device`` (``"cuda/NVIDIA H100 80GB HBM3"`` ->
    ``"cuda"``) — the field the baseline isolation hinges on.  ``fuse_plan`` is the
    vertical-fusion plan id (``Net.fuse_plan_id()``): a fused capture
    and an unfused one are different programs, so they must never pool
    into one baseline band.  ``replicas`` is the serving-fleet size —
    a one-engine capture (the default, 1) and an N-replica routed
    capture are different deployments with different qps bands.
    ``tune_plan`` is the lowering-autotuner table id
    (``Net.tune_plan_id()``): tuned lowerings are a different program
    than the hardcoded defaults ("off"), same isolation argument.
    ``feed_source`` is the input-pipeline source family ("lmdb" decode
    path vs pre-decoded "records" shards): feed throughput bands are
    incomparable across them, so they must not pool.  ``tau`` (steps
    per averaging round) and ``comm_codec`` (the weight-delta wire
    format) shape the round's collective traffic: a τ=10 int8 capture
    and a τ=1 full-precision one are different communication programs
    and must band separately.  ``sharding`` is the partition plan id
    (``parallel.partition.shard_plan_id()``): "dp" is pure data
    parallelism (the historical default), a plan hash is a different
    resident layout with different round collectives — never pooled."""
    if backend is None and device:
        backend = str(device).split("/", 1)[0]
    return {"model": model or "unknown", "dtype": dtype or "unknown",
            "batch": int(batch) if batch is not None else 0,
            "world": int(world) if world is not None else 1,
            "device": device or "unknown",
            "backend": backend or "unknown",
            "fuse_plan": fuse_plan or "off",
            "replicas": int(replicas) if replicas is not None else 1,
            "tune_plan": tune_plan or "off",
            "feed_source": feed_source or "lmdb",
            "tau": int(tau) if tau is not None else 1,
            "comm_codec": comm_codec or "none",
            "sharding": sharding or "dp"}


def fp_key(fp: Mapping[str, Any]) -> str:
    """The fingerprint as one canonical string — the baseline grouping
    key.  Two captures gate against each other iff their keys match, so
    device/dtype/batch isolation is structural, not a special case.
    Fields newer than an entry (fuse_plan) read as their historical
    default, so the committed pre-fusion history keeps gating."""
    def val(k):
        v = fp.get(k)
        return _FINGERPRINT_DEFAULTS.get(k, "unknown") if v is None else v
    return "|".join(f"{k}={val(k)}" for k in FINGERPRINT_FIELDS)


def provenance(result_fp: Mapping[str, Any] | None = None) -> dict[str, Any]:
    """The stamp the bench attaches to every capture and tier: git sha +
    the telemetry plane's correlation IDs (+ the config fingerprint when
    the caller knows it)."""
    from . import telemetry
    corr = telemetry.correlation_ids()
    out: dict[str, Any] = {
        "git_sha": git_sha(),
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "run": corr.get("run"),
        "rank": corr.get("rank"),
    }
    if corr.get("job"):
        out["job"] = corr["job"]
    if result_fp is not None:
        out["fingerprint"] = dict(result_fp)
    return out


# ---------------------------------------------------------------------------
# Metric direction
# ---------------------------------------------------------------------------

# explicit overrides win; otherwise suffix heuristics decide
_HIGHER_BETTER_SUFFIX = ("_img_s", "_qps", "_speedup_x", "_shrink_x",
                         "_gbs", "_gflops")
_LOWER_BETTER_SUFFIX = ("_ms", "_s", "_seconds", "_pct_overhead",
                        "_rejected", "_errors", "_mismatches")
_DIRECTION_OVERRIDES = {
    "mfu": True,
    "profile_mfu": True,
    "mfu_device_busy": True,
    "overlap_pct": True,
}


def higher_is_better(metric: str) -> bool | None:
    """True = up is good, False = down is good, None = don't gate
    (unknown direction must never produce a verdict)."""
    if metric in _DIRECTION_OVERRIDES:
        return _DIRECTION_OVERRIDES[metric]
    base = metric.split("/", 1)[0]   # "cat_ms/loop fusion" -> "cat_ms"
    if base in _DIRECTION_OVERRIDES:
        return _DIRECTION_OVERRIDES[base]
    for suf in _HIGHER_BETTER_SUFFIX:
        if base.endswith(suf):
            return True
    for suf in _LOWER_BETTER_SUFFIX:
        if base.endswith(suf):
            return False
    return None


# ---------------------------------------------------------------------------
# Baselines + verdicts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Baseline:
    """One (metric, fingerprint) gating band, or the reason there isn't
    one.  ``gated`` False means the sentinel REFUSES to judge — too few
    runs, no matching fingerprint (e.g. a CPU capture against a
    TPU-only ledger), or an unknown metric direction."""

    metric: str
    fpk: str
    n: int
    median: float | None = None
    mad: float | None = None
    lo: float | None = None
    hi: float | None = None
    gated: bool = False
    reason: str = ""


def compute_baseline(metric: str, fpk: str, history: Iterable[float], *,
                     window: int = 8, k: float = 4.0,
                     min_history: int = 3,
                     min_band_frac: float = 0.0) -> Baseline:
    """``median ± max(k·1.4826·MAD, min_band_frac·|median|)`` over the
    trailing ``window`` values.  MAD (not stdev) so one outlier run
    can't blow the band open; ``min_band_frac`` puts a floor under the
    band for noisy rigs (the "wide CPU bands" knob — three identical
    smoke runs otherwise yield MAD 0 and a zero-width band)."""
    vals = [float(v) for v in history][-window:]
    if len(vals) < min_history:
        return Baseline(metric, fpk, n=len(vals), gated=False,
                        reason=f"insufficient history ({len(vals)} run(s) "
                               f"< {min_history}) — refusing to gate")
    if higher_is_better(metric) is None:
        return Baseline(metric, fpk, n=len(vals), gated=False,
                        reason=f"unknown direction for {metric!r}")
    med = statistics.median(vals)
    mad = statistics.median(abs(v - med) for v in vals)
    band = max(k * 1.4826 * mad, min_band_frac * abs(med))
    return Baseline(metric, fpk, n=len(vals), median=med, mad=mad,
                    lo=med - band, hi=med + band, gated=True)


def verdict(metric: str, value: float, baseline: Baseline) -> str:
    """``regression`` / ``improvement`` / ``within_band`` /
    ``not_gated`` for one fresh value against its band."""
    if not baseline.gated:
        return "not_gated"
    up_good = higher_is_better(metric)
    assert up_good is not None   # gated baselines imply a direction
    if baseline.lo <= value <= baseline.hi:
        return "within_band"
    worse = value < baseline.lo if up_good else value > baseline.hi
    return "regression" if worse else "improvement"


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------

def make_entry(source: str, path: str | None, fp: Mapping[str, Any],
               metrics: Mapping[str, float], *,
               round_tag: str | None = None, t: float | None = None,
               sha: str | None = None, run: str | None = None,
               rank: int | None = None, job: str | None = None,
               notes: str | None = None) -> dict[str, Any]:
    """One schema-versioned ledger entry.  ``metrics`` is a flat
    name -> number map (non-finite and non-numeric values are
    dropped — a ledger line must always be gateable arithmetic)."""
    clean: dict[str, float] = {}
    for name, v in metrics.items():
        try:
            fv = float(v)
        except (TypeError, ValueError):
            continue
        if fv != fv or fv in (float("inf"), float("-inf")):
            continue
        clean[name] = fv
    entry: dict[str, Any] = {
        "v": SCHEMA_VERSION,
        "t": round(float(t), 3) if t is not None else round(time.time(), 3),
        "round": round_tag,
        "source": source,
        "path": path,
        "sha": sha,
        "fp": dict(fp),
        "metrics": clean,
    }
    if run is not None:
        entry["run"] = run
    if rank is not None:
        entry["rank"] = int(rank)
    if job:
        entry["job"] = job
    if notes:
        entry["notes"] = notes
    return entry


class PerfLedger:
    """Append-only JSONL perf history at ``path`` (required: the port's
    ledger has no default file).  Reads tolerate torn/alien lines
    (skipped, counted); appends are whole-line writes flushed per entry
    so a crash can tear at most the final line."""

    def __init__(self, path: str):
        self.path = path
        self._entries: list[dict] | None = None
        self.skipped_lines = 0

    # -- IO ---------------------------------------------------------------
    def entries(self, reload: bool = False) -> list[dict]:
        if self._entries is not None and not reload:
            return self._entries
        out: list[dict] = []
        self.skipped_lines = 0
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        doc = json.loads(line)
                    except json.JSONDecodeError:
                        self.skipped_lines += 1
                        continue
                    if not isinstance(doc, dict) or "metrics" not in doc:
                        self.skipped_lines += 1
                        continue
                    out.append(doc)
        except OSError:
            pass
        out.sort(key=lambda e: (e.get("t") or 0.0))
        self._entries = out
        return out

    def append(self, entry: Mapping[str, Any]) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(dict(entry), sort_keys=True) + "\n")
            f.flush()
        if self._entries is not None:
            self._entries.append(dict(entry))
            self._entries.sort(key=lambda e: (e.get("t") or 0.0))

    def extend(self, entries: Iterable[Mapping[str, Any]]) -> int:
        n = 0
        for e in entries:
            self.append(e)
            n += 1
        return n

    # -- queries ----------------------------------------------------------
    def history(self, metric: str, fpk: str,
                before_t: float | None = None) -> list[float]:
        """Time-ordered values of one metric for one fingerprint key
        (optionally only strictly before ``before_t`` — so a capture
        already ingested doesn't gate against itself)."""
        out = []
        for e in self.entries():
            if before_t is not None and (e.get("t") or 0.0) >= before_t:
                continue
            if fp_key(e.get("fp") or {}) != fpk:
                continue
            v = (e.get("metrics") or {}).get(metric)
            if v is not None:
                out.append(float(v))
        return out

    def baseline(self, metric: str, fpk: str, *, window: int = 8,
                 k: float = 4.0, min_history: int = 3,
                 min_band_frac: float = 0.0,
                 before_t: float | None = None) -> Baseline:
        hist = self.history(metric, fpk, before_t=before_t)
        return compute_baseline(metric, fpk, hist, window=window, k=k,
                                min_history=min_history,
                                min_band_frac=min_band_frac)

    def fingerprints(self) -> list[str]:
        return sorted({fp_key(e.get("fp") or {}) for e in self.entries()})

    def rounds(self) -> list[str]:
        tags = {e.get("round") for e in self.entries() if e.get("round")}
        return sorted(tags, key=_round_sort_key)


_ROUND_RE = re.compile(r"r(\d+)")


def _round_sort_key(tag: str) -> tuple:
    m = _ROUND_RE.fullmatch(tag or "")
    return (0, int(m.group(1))) if m else (1, tag)


def round_tag_from_path(path: str) -> str | None:
    """``BENCH_r05.json`` / ``BENCH_serving_r07.json`` -> ``r05``/``r07``."""
    m = re.search(r"_r(\d+)\b", os.path.basename(path or ""))
    return f"r{int(m.group(1)):02d}" if m else None


# ---------------------------------------------------------------------------
# Ingesters — every perf artifact the repo emits, one entry shape out
# ---------------------------------------------------------------------------

def _prov_fields(doc: Mapping[str, Any]) -> dict[str, Any]:
    p = doc.get("provenance") or {}
    return {"sha": p.get("git_sha"), "run": p.get("run"),
            "rank": p.get("rank"), "job": p.get("job")}


def _model_from_metric(metric: str | None) -> str | None:
    if not metric:
        return None
    return metric.split("_train_images_per_sec")[0] if (
        metric.endswith("_train_images_per_sec")) else None


def entries_from_bench(doc: Mapping[str, Any], path: str | None = None, *,
                       round_tag: str | None = None,
                       t: float | None = None,
                       device_hint: str | None = None) -> list[dict]:
    """Bench captures: either the bare one-line JSON or the driver's
    ``{"n", "cmd", "rc", "tail", "parsed"}`` wrapper.  Failed captures
    (rc != 0, value 0, or an ``error`` key) yield no entries — a failed
    run is not a data point — and neither does a tier marked
    ``{"not_ported": ...}``."""
    if "parsed" in doc:          # driver wrapper
        if doc.get("rc") != 0:
            return []
        doc = doc["parsed"]
    if not doc or doc.get("error") or not doc.get("value"):
        return []
    prov = _prov_fields(doc)
    device = doc.get("device") or device_hint
    model = _model_from_metric(doc.get("metric")) or "unknown"
    batch = doc.get("batch")
    fuse = doc.get("fuse_plan")
    tune = doc.get("tune_plan")
    out: list[dict] = []

    by_dtype = doc.get("by_dtype") or {
        # pre-round-4 captures measured one dtype and carry it at the
        # top level only
        doc.get("dtype") or "unknown": {
            "images_per_sec": doc.get("value"),
            "eval_images_per_sec": doc.get("eval_images_per_sec"),
            "block_20x256_s": doc.get("block_20x256_s"),
            "mfu": doc.get("mfu"),
        }}
    for dtype, run in by_dtype.items():
        fp = fingerprint(model=model, dtype=dtype, batch=batch, world=1,
                         device=device, fuse_plan=run.get("fuse_plan")
                         or fuse,
                         tune_plan=run.get("tune_plan") or tune)
        metrics = {
            "train_img_s": run.get("images_per_sec"),
            "eval_img_s": run.get("eval_images_per_sec"),
            "block_s": run.get("block_20x256_s"),
            "mfu": run.get("mfu"),
        }
        out.append(make_entry("bench", path, fp,
                              {k: v for k, v in metrics.items()
                               if v is not None},
                              round_tag=round_tag, t=t, **prov))

    feed = doc.get("feed_in_loop") or {}
    if feed and not feed.get("error")\
            and not feed.get("not_ported"):
        fp = fingerprint(model=model,
                         dtype=feed.get("staged_dtype") or doc.get("dtype"),
                         batch=feed.get("batch"), world=1, device=device)
        metrics = {
            "feed_img_s": feed.get("images_per_sec"),
            "feed_step_s": feed.get("step_s"),
            "feed_alone_s": feed.get("feed_alone_s_per_batch"),
            "compute_s": feed.get("compute_s_per_step"),
            "overlap_pct": feed.get("overlap_pct"),
            # PR-4 per-stage breakdown (absent in pre-PR-4 captures) —
            # the fields regress-attribution names a stage from
            "feed_read_s": feed.get("read_s"),
            "feed_decode_s": feed.get("decode_s"),
            "feed_transform_s": feed.get("transform_s"),
            "feed_device_put_s": feed.get("device_put_s"),
        }
        out.append(make_entry("bench_feed", path, fp,
                              {k: v for k, v in metrics.items()
                               if v is not None},
                              round_tag=round_tag, t=t, **prov))

    rec = doc.get("feed_records") or {}
    if rec and not rec.get("error")\
            and not rec.get("not_ported"):
        # the records leg stages uint8 and bands under its own
        # feed_source so it never pools with decode-path feed captures
        fp = fingerprint(model=model, dtype="uint8",
                         batch=rec.get("batch"), world=1, device=device,
                         feed_source=rec.get("feed_source") or "records")
        metrics = {
            "feed_img_s": rec.get("images_per_sec"),
            "feed_serial_img_s": rec.get("serial_img_s"),
            "feed_records_speedup_x": rec.get("speedup_x"),
            "feed_convert_s": rec.get("convert_s"),
            "feed_read_s": rec.get("read_s"),
        }
        out.append(make_entry("bench_feed", path, fp,
                              {k: v for k, v in metrics.items()
                               if v is not None},
                              round_tag=round_tag, t=t, **prov))

    ro = doc.get("round_overhead") or {}
    if ro and not ro.get("error")\
            and not ro.get("not_ported"):
        fp = fingerprint(model=model, dtype=ro.get("dtype", "f32"),
                         batch=ro.get("batch"), world=ro.get("workers"),
                         device=device)
        metrics: dict[str, Any] = {
            "round_bare_s": (ro.get("bare") or {}).get("round_s"),
            "round_sync_s": (ro.get("sync") or {}).get("round_s"),
            "round_async_s": (ro.get("async") or {}).get("round_s"),
            "round_stall_sync_s": (ro.get("sync") or {}).get(
                "stall_total_s_per_round"),
            "round_stall_async_s": (ro.get("async") or {}).get(
                "stall_total_s_per_round"),
        }
        for comp, v in ((ro.get("async") or {}).get(
                "stall_s_per_round") or {}).items():
            metrics[f"stall_{comp}_s"] = v
        out.append(make_entry("bench_round", path, fp,
                              {k: v for k, v in metrics.items()
                               if v is not None},
                              round_tag=round_tag, t=t, **prov))

    sr = doc.get("shard_round") or {}
    if sr and not sr.get("error")\
            and not sr.get("not_ported"):
        # dp vs sharded band separately: the `sharding` fingerprint
        # field keys each leg against its own history, so the sharded
        # round's smaller wire bytes never "regress" the dp baseline
        for mode, shard_id in (("dp", "dp"),
                               ("sharded", sr.get("plan") or "sharded")):
            leg = sr.get(mode) or {}
            if not leg or leg.get("error"):
                continue
            fp = fingerprint(model=model, dtype=sr.get("dtype", "f32"),
                             batch=sr.get("batch"),
                             world=sr.get("workers"), device=device,
                             tau=sr.get("tau"), sharding=shard_id)
            metrics = {
                "shard_round_s": leg.get("round_s"),
                "shard_boundary_bytes": leg.get(
                    "boundary_bytes_per_chip"),
            }
            if mode == "sharded":
                metrics["shard_bytes_shrink_x"] = sr.get(
                    "bytes_shrink_x")
            out.append(make_entry(
                "bench_shard", path, fp,
                {k: v for k, v in metrics.items() if v is not None},
                round_tag=round_tag, t=t,
                notes=None if sr.get("parity_ok", True)
                else "shard parity FAILED", **prov))

    serving = doc.get("serving") or {}
    if serving and not serving.get("error")\
            and not serving.get("not_ported"):
        out.extend(entries_from_serving(serving, path,
                                        round_tag=round_tag, t=t,
                                        device_hint=device))
    return out


def entries_from_serving(doc: Mapping[str, Any], path: str | None = None, *,
                         round_tag: str | None = None,
                         t: float | None = None,
                         device_hint: str | None = None) -> list[dict]:
    """serveload / BENCH_serving reports (also the nested ``serving``
    leg of a bench capture)."""
    if not doc or doc.get("error"):
        return []
    prov = _prov_fields(doc)
    shapes = doc.get("batch_shapes") or []
    fp = fingerprint(model=doc.get("model"), dtype=doc.get("dtype"),
                     batch=max(shapes) if shapes else None, world=1,
                     device=doc.get("device") or device_hint)
    sat = doc.get("saturation") or {}
    b1 = doc.get("batch1") or {}
    over = doc.get("overload") or {}
    v = doc.get("verdicts") or {}
    metrics = {
        "serve_sat_qps": sat.get("achieved_qps"),
        "serve_sat_p99_ms": sat.get("p99_ms"),
        "serve_batch1_qps": b1.get("achieved_qps"),
        "serve_speedup_x": v.get("batching_speedup_x") or doc.get("value"),
        "serve_overload_p99_ms": over.get("p99_ms"),
        "serve_overload_qps": over.get("achieved_qps"),
        "serve_overload_rejected": over.get("rejected"),
    }
    return [make_entry("serving", path, fp,
                       {k: val for k, val in metrics.items()
                        if val is not None},
                       round_tag=round_tag, t=t, **prov)]


def entries_from_serving_fleet(doc: Mapping[str, Any],
                               path: str | None = None, *,
                               round_tag: str | None = None,
                               t: float | None = None,
                               device_hint: str | None = None
                               ) -> list[dict]:
    """``serveload --fleet`` reports: N routed replicas.  ``replicas``
    rides the fingerprint, so these never pool with the single-engine
    serving bands."""
    if not doc or doc.get("error"):
        return []
    prov = _prov_fields(doc)
    shapes = doc.get("batch_shapes") or []
    fp = fingerprint(model=doc.get("model"), dtype=doc.get("dtype"),
                     batch=max(shapes) if shapes else None, world=1,
                     device=doc.get("device") or device_hint,
                     replicas=doc.get("replicas"))
    sat = doc.get("saturation") or {}
    solo = doc.get("solo") or {}
    v = doc.get("verdicts") or {}
    metrics = {
        "serve_fleet_sat_qps": sat.get("achieved_qps"),
        "serve_fleet_sat_p99_ms": sat.get("p99_ms"),
        "serve_fleet_solo_qps": solo.get("achieved_qps"),
        "serve_fleet_speedup_x": v.get("fleet_scaling_x")
        or doc.get("value"),
        "serve_fleet_mismatches": v.get("exact_mismatches"),
    }
    return [make_entry("serving_fleet", path, fp,
                       {k: val for k, val in metrics.items()
                        if val is not None},
                       round_tag=round_tag, t=t, **prov)]


def entries_from_netsoak(doc: Mapping[str, Any],
                         path: str | None = None, *,
                         round_tag: str | None = None,
                         t: float | None = None,
                         device_hint: str | None = None) -> list[dict]:
    """``soak --net`` verdicts: the partition-recovery wall (suspend,
    heal, bit-identical finish), the fenced ship's rate, the fenced
    resume's wall and, on full runs, the slow-link episode's wall."""
    if doc.get("mode") != "net" or not doc.get("episodes"):
        return []
    by_name = {ep.get("episode"): ep for ep in doc["episodes"]}
    prov = _prov_fields(doc)
    fp = fingerprint(model="lenet", dtype="f32", world=4,
                     device=device_hint)
    metrics: dict[str, Any] = {}
    part = by_name.get("partition_suspend_heal")
    if part:
        metrics["netsoak_partition_recovery_s"] = part.get("elapsed_s")
    fenced = by_name.get("fenced_zombie_ship")
    if fenced:
        metrics["netsoak_fenced_resume_s"] = fenced.get("elapsed_s")
        ship = fenced.get("ship") or {}
        wall = ship.get("wall_s")
        if wall and ship.get("bytes"):
            metrics["netsoak_ship_mb_per_s"] = round(
                ship["bytes"] / wall / 1e6, 3)
    slow = by_name.get("slow_link_attribution")
    if slow:
        metrics["netsoak_slow_link_episode_s"] = slow.get("elapsed_s")
    metrics = {k: v for k, v in metrics.items() if v is not None}
    if not metrics:
        return []
    return [make_entry("netsoak", path, fp, metrics,
                       round_tag=round_tag, t=t,
                       notes=None if doc.get("ok") else "net soak FAILED",
                       **prov)]


def entries_from_rollout(doc: Mapping[str, Any],
                         path: str | None = None, *,
                         round_tag: str | None = None,
                         t: float | None = None,
                         device_hint: str | None = None) -> list[dict]:
    """``soak --rollout`` verdicts: the promote wall, the bad canary's
    detection-to-rollback wall, the journal-replay resume wall and the
    stable-pinned error count (which must stay 0)."""
    if doc.get("mode") != "rollout" or not doc.get("episodes"):
        return []
    by_name = {ep.get("episode"): ep for ep in doc["episodes"]}
    prov = _prov_fields(doc)
    fp = fingerprint(model="lenet", dtype="f32", world=1, replicas=2,
                     device=device_hint)
    metrics: dict[str, Any] = {}
    promo = by_name.get("canary_promote")
    if promo:
        metrics["rollout_promote_s"] = promo.get("elapsed_s")
        metrics["rollout_stable_errors"] = promo.get("stable_errors")
    bad = by_name.get("bad_canary_rollback")
    if bad:
        metrics["rollout_detect_s"] = bad.get("detect_s")
        if bad.get("stable_errors") is not None:
            metrics["rollout_stable_errors"] = (
                (metrics.get("rollout_stable_errors") or 0)
                + bad["stable_errors"])
    kill = by_name.get("controller_kill_resume")
    if kill:
        metrics["rollout_resume_s"] = kill.get("elapsed_s")
    metrics = {k: v for k, v in metrics.items() if v is not None}
    if not metrics:
        return []
    return [make_entry("rollout", path, fp, metrics,
                       round_tag=round_tag, t=t,
                       notes=None if doc.get("ok")
                       else "rollout soak FAILED",
                       **prov)]


def entries_from_commbench(doc: Mapping[str, Any],
                           path: str | None = None, *,
                           round_tag: str | None = None,
                           t: float | None = None,
                           device_hint: str | None = None) -> list[dict]:
    """``tools/commbench.py`` reports: one entry per codec (its
    ``comm_codec`` in the fingerprint) with the round wall, the comm
    stall by component and the exchange bytes, and one summary entry on
    the full-precision fingerprint with the sync and overlapped stall
    and int8's wire shrink."""
    if not doc.get("commbench"):
        return []
    prov = _prov_fields(doc)
    tau = doc.get("tau")
    world = doc.get("devices")
    device = doc.get("device") or device_hint
    note = None if doc.get("ok") else "commbench gate FAILED"
    out: list[dict] = []
    for codec, leg in (doc.get("codecs") or {}).items():
        fp = fingerprint(model="lenet", dtype="f32",
                         batch=doc.get("batch"), world=world,
                         device=device, tau=tau, comm_codec=codec)
        metrics = {
            "commbench_wall_s": leg.get("wall_s"),
            "comm_stall_s": leg.get("comm_stall_s"),
            "comm_exchange_bytes": leg.get("exchange_bytes"),
        }
        for comp, v in (leg.get("stall_s") or {}).items():
            if comp.startswith("comm_"):
                metrics[f"stall_{comp}_s"] = v
        out.append(make_entry(
            "commbench", path, fp,
            {k: v for k, v in metrics.items() if v is not None},
            round_tag=round_tag, t=t, notes=note, **prov))
    summary = {
        "comm_stall_sync_s": doc.get("comm_stall_sync_s"),
        "comm_stall_overlap_s": doc.get("comm_stall_overlap_s"),
        "comm_bytes_shrink_x": doc.get("comm_bytes_shrink_x"),
        "commbench_wall_s": (doc.get("none") or {}).get("wall_s"),
    }
    summary = {k: v for k, v in summary.items() if v is not None}
    if summary:
        fp = fingerprint(model="lenet", dtype="f32",
                         batch=doc.get("batch"), world=world,
                         device=device, tau=tau, comm_codec="none")
        out.append(make_entry("commbench", path, fp, summary,
                              round_tag=round_tag, t=t, notes=note,
                              **prov))
    return out


def entries_from_shardbench(doc: Mapping[str, Any],
                            path: str | None = None, *,
                            round_tag: str | None = None,
                            t: float | None = None,
                            device_hint: str | None = None) -> list[dict]:
    """``tools/shardbench.py`` reports: one entry on the ``sharding="dp"``
    fingerprint (the replicated round's wall and boundary bytes) and one
    on the plan's (its wall, per-position boundary bytes and the
    ``shard_bytes_shrink_x`` headline), so the two histories band apart."""
    if not doc.get("shardbench"):
        return []
    prov = _prov_fields(doc)
    world = doc.get("devices")
    tau = doc.get("tau")
    device = doc.get("device") or device_hint
    note = None if doc.get("ok") else "shardbench gate FAILED"
    out: list[dict] = []
    for mode, shard_id in (("dp", "dp"),
                           ("sharded", doc.get("plan") or "sharded")):
        leg = doc.get(mode) or {}
        if not leg:
            continue
        fp = fingerprint(model=doc.get("model") or "lenet", dtype="f32",
                         batch=doc.get("batch"), world=world,
                         device=device, tau=tau, sharding=shard_id)
        metrics = {
            "shard_round_s": leg.get("round_s"),
            "shard_boundary_bytes": leg.get("boundary_bytes_per_chip"),
            "shard_exchange_bytes": leg.get("exchange_bytes"),
        }
        if mode == "sharded":
            metrics["shard_bytes_shrink_x"] = doc.get(
                "shard_bytes_shrink_x")
            metrics["shard_caffenet_shrink_x"] = (
                doc.get("caffenet") or {}).get("shrink_x")
        out.append(make_entry(
            "shardbench", path, fp,
            {k: v for k, v in metrics.items() if v is not None},
            round_tag=round_tag, t=t, notes=note, **prov))
    return out


def entries_from_roundbench(doc: Mapping[str, Any],
                            path: str | None = None, *,
                            round_tag: str | None = None,
                            t: float | None = None,
                            device_hint: str | None = None) -> list[dict]:
    """Round parity reports in the JAX package's ``tools/roundbench.py``
    layout (sync vs async outer loop)."""
    if not doc or "stall_total_sync_s" not in doc:
        return []
    prov = _prov_fields(doc)
    fp = fingerprint(model=doc.get("model"), dtype="f32",
                     batch=doc.get("batch"), world=doc.get("devices"),
                     device=doc.get("device") or device_hint)
    metrics = {
        "roundbench_sync_wall_s": (doc.get("sync") or {}).get("wall_s"),
        "roundbench_async_wall_s": (doc.get("async") or {}).get("wall_s"),
        "roundbench_stall_sync_s": doc.get("stall_total_sync_s"),
        "roundbench_stall_async_s": doc.get("stall_total_async_s"),
    }
    return [make_entry("roundbench", path, fp,
                       {k: v for k, v in metrics.items() if v is not None},
                       round_tag=round_tag, t=t,
                       notes=None if doc.get("ok") else "parity FAILED",
                       **prov)]


def entries_from_op_table(doc: Mapping[str, Any],
                          path: str | None = None, *,
                          round_tag: str | None = None,
                          t: float | None = None) -> list[dict]:
    """``op_table.json`` of ``tools/profile_step.py``: the summary row
    plus per-category device time and bandwidth."""
    summary = doc.get("summary") or {}
    if not summary:
        return []
    fp = fingerprint(model=summary.get("model"),
                     dtype=summary.get("dtype"),
                     batch=summary.get("batch"), world=1,
                     device=summary.get("device"),
                     fuse_plan=summary.get("fuse_plan"),
                     tune_plan=summary.get("tune_plan"))
    # profile captures run with profiling overhead — their MFU/img_s
    # must not pool into the bench baselines, hence the profile_ prefix
    metrics: dict[str, Any] = {
        "step_ms": summary.get("step_ms"),
        "profile_img_s": summary.get("img_s"),
        "profile_mfu": summary.get("mfu"),
        "mfu_device_busy": summary.get("mfu_device_busy"),
        "device_busy_ms": summary.get("device_busy_ms_per_step"),
    }
    for cat in doc.get("by_category") or []:
        name = cat.get("op")
        if not name:
            continue
        metrics[f"cat_ms/{name}"] = cat.get("total_ms")
        metrics[f"cat_gbs/{name}"] = cat.get("gb_per_s")
    mode = summary.get("mode")
    return [make_entry("profile", path, fp,
                       {k: v for k, v in metrics.items() if v is not None},
                       round_tag=round_tag, t=t,
                       notes=f"mode={mode}" if mode else None)]


def entries_from_metrics_rollup(folded: Mapping[str, Any],
                                path: str | None = None, *,
                                round_tag: str | None = None,
                                t: float | None = None,
                                fp: Mapping[str, Any] | None = None
                                ) -> list[dict]:
    """A ``telemetry.fold_snapshots`` rollup (obs.py merge's metrics
    half): the PR-8 stage gauges/histograms become ledger metrics —
    ``feed_stage_seconds{stage}``, ``trainer_stall_seconds{component}``,
    ``ckpt_write_seconds`` mean — so stage attribution has history."""
    metrics: dict[str, float] = {}
    for name in ("feed_stage_seconds", "trainer_stall_seconds"):
        fam = folded.get(name) or {}
        for s in fam.get("samples") or []:
            labels = s.get("labels") or {}
            label = (labels.get("stage") or labels.get("component")
                     or ",".join(f"{k}={v}"
                                 for k, v in sorted(labels.items()))
                     or "all")
            if s.get("value") is not None:
                metrics[f"{name}/{label}"] = s["value"]
    ck = folded.get("ckpt_write_seconds") or {}
    for s in ck.get("samples") or []:
        if s.get("count"):
            metrics["ckpt_write_mean_s"] = s["sum"] / s["count"]
    if not metrics:
        return []
    return [make_entry("telemetry", path, fp or fingerprint(),
                       metrics, round_tag=round_tag, t=t)]


def entries_from_tuning_table(doc: Mapping[str, Any],
                              path: str | None = None, *,
                              round_tag: str | None = None,
                              t: float | None = None) -> list[dict]:
    """``sparknet_tpu_torch/profiles/<backend>/tuning.json``
    (``graph/tuner.py``): every candidate timing at every key becomes a
    metric, so the next capture of the same key gates against this one.
    Metric names: ``tune_ms/<key>`` for the winner (``_ms``: lower is
    better), ``tune_cand_ms/<key>=<candidate>`` for the rest, and
    ``tune_margin/<key>`` for the winner's lead over the runner-up
    (higher is better: a shrinking margin is the early rot signal)."""
    if doc.get("kind") != "tuning_table":
        return []
    entries = doc.get("entries") or []
    if not entries:
        return []
    prov = doc.get("provenance") or {}
    backend = doc.get("backend") or "unknown"
    device = (prov.get("fingerprint") or {}).get("device")
    if not device or device == "unknown":
        device = backend
    dtypes = {parts[2] for e in entries
              if len(parts := str(e.get("key", "")).split("/")) >= 3}
    fp = fingerprint(model="tuner",
                     dtype=dtypes.pop() if len(dtypes) == 1 else "mixed",
                     batch=0, world=1, device=device, backend=backend,
                     tune_plan=doc.get("table_id"))
    metrics: dict[str, Any] = {}
    for e in entries:
        key, winner = e.get("key"), e.get("winner")
        if not key or not winner:
            continue
        for cand, rec in (e.get("timings") or {}).items():
            if not isinstance(rec, Mapping) or rec.get("ms") is None:
                continue  # typed skip — no measurement, never 0
            if cand == winner:
                metrics[f"tune_ms/{key}"] = rec["ms"]
            else:
                metrics[f"tune_cand_ms/{key}={cand}"] = rec["ms"]
        if e.get("margin") is not None:
            metrics[f"tune_margin/{key}"] = e["margin"]
    if not metrics:
        return []
    ts = [e.get("measured_at") for e in entries
          if isinstance(e.get("measured_at"), (int, float))]
    return [make_entry("tuning", path, fp, metrics, round_tag=round_tag,
                       t=t if t is not None else (max(ts) if ts else None),
                       sha=prov.get("git_sha"), run=prov.get("run"),
                       rank=prov.get("rank"), job=prov.get("job"))]


def entries_from_any(doc: Mapping[str, Any], path: str | None = None, *,
                     round_tag: str | None = None, t: float | None = None,
                     device_hint: str | None = None) -> list[dict]:
    """Sniff the artifact type and dispatch; unknown shapes yield []."""
    if round_tag is None and path:
        round_tag = round_tag_from_path(path)
    if "parsed" in doc or str(doc.get("metric", "")).endswith(
            "_train_images_per_sec"):
        return entries_from_bench(doc, path, round_tag=round_tag, t=t,
                                  device_hint=device_hint)
    if doc.get("metric") == "serving_dynamic_vs_batch1_speedup_x":
        return entries_from_serving(doc, path, round_tag=round_tag, t=t,
                                    device_hint=device_hint)
    if doc.get("metric") == "serving_fleet_scaling_x":
        return entries_from_serving_fleet(doc, path, round_tag=round_tag,
                                          t=t, device_hint=device_hint)
    if doc.get("mode") == "net" and "episodes" in doc:
        return entries_from_netsoak(doc, path, round_tag=round_tag, t=t,
                                    device_hint=device_hint)
    if doc.get("mode") == "rollout" and "episodes" in doc:
        return entries_from_rollout(doc, path, round_tag=round_tag, t=t,
                                    device_hint=device_hint)
    if doc.get("kind") == "tuning_table":
        return entries_from_tuning_table(doc, path, round_tag=round_tag,
                                         t=t)
    if "summary" in doc and "by_category" in doc:
        return entries_from_op_table(doc, path, round_tag=round_tag, t=t)
    if doc.get("commbench"):
        return entries_from_commbench(doc, path, round_tag=round_tag,
                                      t=t, device_hint=device_hint)
    if doc.get("shardbench"):
        return entries_from_shardbench(doc, path, round_tag=round_tag,
                                       t=t, device_hint=device_hint)
    if "stall_total_sync_s" in doc:
        return entries_from_roundbench(doc, path, round_tag=round_tag,
                                       t=t, device_hint=device_hint)
    # a folded metrics rollup is a {name: {kind, samples}} map
    if doc and all(isinstance(v, Mapping) and "samples" in v
                   for v in doc.values()):
        return entries_from_metrics_rollup(doc, path, round_tag=round_tag,
                                           t=t)
    return []
