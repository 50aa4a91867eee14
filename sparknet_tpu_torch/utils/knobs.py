"""Typed registry of the ``SPARKNET_*`` environment knobs the port reads.

The port's own copy of ``sparknet_tpu/utils/knobs.py``: every knob has a
name, a type, a default (the unset behaviour, in env spelling), a
one-line doc and an owner (the port's module that reads it).  The
registry is the one source of

- **runtime reads**: the port reads knobs through :func:`raw`,
  :func:`get_str`, :func:`get_int`, :func:`get_float` and
  :func:`get_bool`.  Reading a name that was never registered raises
  :class:`UnknownKnob`, so a typo'd knob fails loudly instead of
  silently meaning "default"; reading a tombstone raises
  :class:`RemovedKnob` naming its replacement; a value that does not
  parse as its type raises :class:`InvalidKnobValue`.
- **docs**: ``sparknet_tpu_torch/KNOBS.md`` is :func:`knobs_md`,
  written and drift-checked by ``python -m sparknet_tpu_torch.tools.knobs
  --emit|--check`` (the counterpart of the root ``tools/lint.py knobs``).

It registers the JAX package's names the port refuses by name
(``SPARKNET_SHARD``, ``SPARKNET_SHARD_CKPT``: reading one that is set
raises, ROADMAP A12) and the JAX package's tombstones.  Values are never
cached: every accessor reads ``os.environ`` live.  Imports nothing of
the rest of the port.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable

__all__ = [
    "Knob", "KnobError", "UnknownKnob", "RemovedKnob", "InvalidKnobValue",
    "KNOBS", "get", "all_knobs", "raw", "is_set", "get_str", "get_int",
    "get_float", "get_bool", "knobs_md",
]


class KnobError(Exception):
    """Base of the knob registry's errors."""


class UnknownKnob(KnobError, KeyError):
    """A read of a ``SPARKNET_*`` name that was never registered."""


class RemovedKnob(KnobError, KeyError):
    """A read of a knob whose deprecation window has closed."""


class InvalidKnobValue(KnobError, ValueError):
    """A set knob whose value does not parse as its type."""


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered env knob (the module docstring has the contract)."""

    name: str
    type: str                  # bool | int | float | str | enum | path | spec
    default: str               # unset behaviour, in env spelling ("" = unset)
    doc: str                   # one line; a row of KNOBS.md
    owner: str                 # repo-relative path of the reading module
    choices: tuple[str, ...] = ()          # for type == "enum"
    validator: Callable[[str], object] | None = None
    deprecated: str = ""       # window open:   "r<N>: use X instead"
    removed: str = ""          # window closed: "r<N>: use X instead"


_REGISTRY: dict[str, Knob] = {}


def _register(*knobs: Knob) -> None:
    for k in knobs:
        if k.name in _REGISTRY:
            raise ValueError(f"duplicate knob registration: {k.name}")
        _REGISTRY[k.name] = k


def get(name: str) -> Knob:
    """The registry entry of ``name``; raises :class:`UnknownKnob` or
    :class:`RemovedKnob`, the check every accessor runs first."""
    try:
        k = _REGISTRY[name]
    except KeyError:
        raise UnknownKnob(
            f"{name} is not a registered knob of the port: add it to "
            f"sparknet_tpu_torch/utils/knobs.py (and KNOBS.md through "
            f"`python -m sparknet_tpu_torch.tools.knobs --emit`)") from None
    if k.removed:
        raise RemovedKnob(f"{name} was removed ({k.removed})")
    return k


def all_knobs() -> list[Knob]:
    """Every registered knob (tombstones included), sorted by name."""
    return sorted(_REGISTRY.values(), key=lambda k: k.name)


def raw(name: str, default: str | None = None) -> str | None:
    """Registry-checked ``os.environ.get``: the primitive every other
    accessor bottoms out in."""
    get(name)
    return os.environ.get(name, default)


def is_set(name: str) -> bool:
    """True when the knob is present and non-empty."""
    return bool(raw(name))


def get_str(name: str, default: str = "") -> str:
    val = raw(name)
    return default if val is None or val == "" else val


def get_int(name: str, default: int) -> int:
    val = raw(name)
    if val is None or val == "":
        return default
    try:
        return int(val)
    except ValueError:
        raise InvalidKnobValue(
            f"{name} must be an integer, got {val!r}") from None


def get_float(name: str, default: float) -> float:
    val = raw(name)
    if val is None or val == "":
        return default
    try:
        return float(val)
    except ValueError:
        raise InvalidKnobValue(
            f"{name} must be a number, got {val!r}") from None


def get_bool(name: str, default: bool) -> bool:
    """``"0"`` -> False, ``"1"`` -> True, unset or anything else ->
    ``default``."""
    val = raw(name)
    if val == "0":
        return False
    if val == "1":
        return True
    return default


# ---------------------------------------------------------------------------
# The registry, grouped by owner.  Each doc is one line of KNOBS.md; a
# default of "" means unset, with the unset behaviour in the doc.
# ---------------------------------------------------------------------------

_P = "sparknet_tpu_torch/"
_TUNER, _FUSION, _NET = _P + "graph/tuner.py", _P + "graph/fusion.py", \
    _P + "graph/net.py"
_SERVING, _TRAINER = _P + "parallel/serving.py", _P + "parallel/trainer.py"
_PIPELINE, _RECORDS = _P + "data/pipeline.py", _P + "data/records.py"
_TELEMETRY, _FAULTS = _P + "utils/telemetry.py", _P + "utils/faults.py"
_CKPT = _P + "utils/checkpoint.py"
_CLUSTER, _RESIL = _P + "parallel/cluster.py", _P + "parallel/resilience.py"
_FLEET, _ROUTER = _P + "parallel/fleet.py", _P + "parallel/router.py"
_AUTOSCALE, _ROLLOUT = _P + "parallel/autoscale.py", \
    _P + "parallel/rollout.py"

_register(
    # --- graph: the lowering tuner, fusion ---
    Knob("SPARKNET_TUNE", "enum", "auto",
         "Lowering table: off = the built-in defaults, auto = the port's "
         "committed profiles/<backend>/tuning.json, else a table path; "
         "latched at Net construction.",
         _TUNER, choices=("off", "auto", "<path>")),
    Knob("SPARKNET_TUNE_REPS", "int", "5",
         "Timed repetitions per tuning candidate.", _TUNER),
    Knob("SPARKNET_TUNE_TARGET_S", "float", "0.1",
         "Target seconds per timed repetition on the CPU.", _TUNER),
    Knob("SPARKNET_TUNE_WARMUP", "int", "2",
         "Untimed warm-up runs per tuning candidate.", _TUNER),
    Knob("SPARKNET_FUSE", "enum", "auto",
         "Vertical fusion plan: off/0 = unfused, auto = the port's "
         "committed profile worklist, all = every legal chain, else a "
         "plan-file path; latched at Net construction.",
         _FUSION, choices=("off", "0", "auto", "all", "<path>")),
    Knob("SPARKNET_NO_HFUSE", "bool", "",
         "Set to 1 to turn off the horizontal fusion of sibling 1x1 "
         "convolutions (latched at Net construction).", _NET),
    # --- fault injection ---
    Knob("SPARKNET_FAULT", "spec", "",
         "Comma-separated fault specs (e.g. crash_after:3,slow_feed:200ms) "
         "injected by utils/faults.py; empty = none.", _FAULTS),
    Knob("SPARKNET_FAULT_ATTEMPT", "int", "0",
         "Relaunch attempt index; faults can gate on it so a fault fires "
         "once, not on every restart.", _FAULTS),
    Knob("SPARKNET_PROC_ID", "int", "0",
         "This process's rank, which faults gate on; also the telemetry "
         "and beacon shard rank.", _FAULTS),
    # --- checkpointing, IO ---
    Knob("SPARKNET_ASYNC_CKPT", "bool", "1",
         "Set to 0 to force synchronous round checkpoints (default "
         "asynchronous).", _CKPT),
    Knob("SPARKNET_FENCE_TOKEN", "int", "0",
         "This writer's incarnation fence token: checkpoint directories "
         "refuse publishes from tokens below their claimed fence; 0 = "
         "fencing off.", _CKPT),
    Knob("SPARKNET_IO_RETRIES", "int", "3",
         "Attempts for data-plane file and DB opens (io_retry policy).",
         _P + "utils/retry.py"),
    Knob("SPARKNET_IO_BACKOFF", "float", "0.05",
         "Base seconds of the backoff between those attempts.",
         _P + "utils/retry.py"),
    # --- telemetry plane ---
    Knob("SPARKNET_TELEMETRY", "bool", "1",
         "Set to 0 to turn the telemetry plane off (null registry, no "
         "spans, no flight recorder).", _TELEMETRY),
    Knob("SPARKNET_TELEMETRY_RANK", "int", "",
         "Trace-shard rank of a process outside a launcher; wins over "
         "SPARKNET_PROC_ID.", _TELEMETRY),
    Knob("SPARKNET_TRACE_DIR", "path", "",
         "Write trace_*.jsonl span shards and flight dumps here; empty "
         "traces nothing.", _TELEMETRY),
    Knob("SPARKNET_METRICS_SNAP", "path", "",
         "Write metrics_rank*.json/.prom snapshots here; empty disables.",
         _TELEMETRY),
    Knob("SPARKNET_METRICS_SNAP_S", "float", "2",
         "Least seconds between metrics snapshots.", _TELEMETRY),
    Knob("SPARKNET_FLIGHT_EVENTS", "int", "256",
         "Flight-recorder ring size.", _TELEMETRY),
    Knob("SPARKNET_RUN_ID", "str", "",
         "Correlation run id stamped on all telemetry; derived once per "
         "process when unset.", _TELEMETRY),
    Knob("SPARKNET_INCARNATION", "int", "0",
         "Relaunch incarnation in the correlation ids.", _TELEMETRY),
    Knob("SPARKNET_FLEET_JOB", "str", "",
         "Fleet job name in the correlation ids.", _TELEMETRY),
    # --- data plane ---
    Knob("SPARKNET_QUARANTINE_FRACTION", "float", "0",
         "Most bad records an epoch may skip, as a fraction of the epoch.",
         _P + "data/integrity.py"),
    Knob("SPARKNET_QUARANTINE_RECORDS", "int", "0",
         "Most bad records an epoch may skip, a count added to the "
         "fraction.", _P + "data/integrity.py"),
    Knob("SPARKNET_FEED_WORKERS", "int", "",
         "Decode-pool width of the DB feeds; 0 = the serial reference "
         "path; unset = the CPU count capped at 8.", _PIPELINE),
    Knob("SPARKNET_FEED_DEPTH", "int", "4",
         "Host batches the feeds stage ahead.", _PIPELINE),
    Knob("SPARKNET_FEED_PUTTERS", "int", "2",
         "The device feed's host-to-device copy threads.",
         _P + "data/prefetch.py"),
    Knob("SPARKNET_RECORD_READERS", "int", "",
         "Ranged-read pool width of record-shard feeds; 0 = one thread; "
         "unset = SPARKNET_FEED_WORKERS.", _RECORDS),
    Knob("SPARKNET_RECORD_SHARD_MB", "int", "64",
         "Shard roll size in MiB of the record-shard converter.", _RECORDS),
    Knob("SPARKNET_CACHE_SHARDS", "int", "4",
         "ShardCache RAM tier: resident shards before LRU eviction.",
         _PIPELINE),
    Knob("SPARKNET_CACHE_SPILL_DIR", "path", "",
         "ShardCache disk tier directory for RAM evictees; unset drops "
         "them.", _PIPELINE),
    Knob("SPARKNET_CACHE_SPILL_SHARDS", "int", "16",
         "ShardCache disk tier: most spilled shards, the oldest deleted "
         "first.", _PIPELINE),
    Knob("SPARKNET_AUG_DEVICE", "bool", "1",
         "Solver.set_augment's default: 1 runs the crop, mirror, mean and "
         "scale on the device, 0 on the host (the same bits).",
         _P + "solvers/solver.py"),
    # --- serving engine, SLO monitor, registry, beacons ---
    Knob("SPARKNET_SERVE_SHAPES", "spec", "1,4,16,64",
         "Padded batch shapes the engine warms up (comma-separated ints).",
         _SERVING),
    Knob("SPARKNET_SERVE_MAX_DELAY_MS", "float", "5.0",
         "Micro-batching window: most milliseconds a request waits for "
         "batchmates.", _SERVING),
    Knob("SPARKNET_SERVE_QUEUE", "int", "256",
         "Admission bound on outstanding requests; beyond it requests get "
         "typed rejections.", _SERVING),
    Knob("SPARKNET_SERVE_INFLIGHT", "int", "2",
         "Dispatched-but-not-demuxed batch window.", _SERVING),
    Knob("SPARKNET_SERVE_HBM_MB", "float", "2048",
         "Device-memory budget of resident models in MB (LRU eviction "
         "above it).", _SERVING),
    Knob("SPARKNET_SERVE_DTYPE", "str", "bf16",
         "Serving compute dtype, bf16 or f32.", _SERVING),
    Knob("SPARKNET_SERVE_QUOTAS", "spec", "",
         "Per-tenant offered-QPS caps, tenant=qps comma-separated; * = "
         "every unlisted tenant.", _SERVING),
    Knob("SPARKNET_SERVE_FORCE_ADMIT", "bool", "",
         "Set to 1 to admit models larger than the budget.", _SERVING),
    Knob("SPARKNET_SLO_P99_MS", "float", "",
         "Declared p99 latency SLO in ms; unset or 0 leaves the latency "
         "SLO undeclared.", _SERVING),
    Knob("SPARKNET_SLO_REJECT_BUDGET", "float", "0.02",
         "Rejection-rate error budget of the SLO burn accounting.",
         _SERVING),
    Knob("SPARKNET_SLO_WINDOW_S", "float", "60",
         "Slow burn-rate window seconds.", _SERVING),
    Knob("SPARKNET_SLO_FAST_S", "float", "5",
         "Fast burn-rate window seconds.", _SERVING),
    Knob("SPARKNET_REGISTRY_DIR", "path", "",
         "Root of the model registry (version bundles and per-model "
         "channel files); unset serves by name only.",
         _P + "parallel/registry.py"),
    Knob("SPARKNET_HEARTBEAT_DIR", "path", "",
         "Directory of liveness beat files; unset writes no beats.",
         _P + "parallel/health.py"),
    # --- the round (τ, codec, overlap) and the refused sharding knobs ---
    Knob("SPARKNET_TAU", "int", "",
         "Steps per round for comm_config_from_env; unset keeps the "
         "config's tau.", _TRAINER),
    Knob("SPARKNET_COMM_CODEC", "str", "",
         "Exchange codec for comm_config_from_env: none, bf16, int8, "
         "int8_channel or a registered name; unset keeps the config's.",
         _TRAINER),
    Knob("SPARKNET_COMM_OVERLAP", "bool", "",
         "Set to 1 to dispatch encode/exchange/decode without host syncs "
         "(bit-identical results); unset keeps the config's.", _TRAINER),
    Knob("SPARKNET_SHARD", "str", "",
         "Refused by name: the JAX package's partition rule table; "
         "comm_config_from_env raises when it is set (sharding is "
         "ROADMAP A12).", _TRAINER),
    Knob("SPARKNET_SHARD_CKPT", "bool", "",
         "Refused by name: the JAX package's per-shard round "
         "checkpoints; comm_config_from_env raises when it is set "
         "(ROADMAP A12).", _TRAINER),
    # --- the fleet: launcher contract, supervision, scheduler ---
    Knob("SPARKNET_COORDINATOR", "str", "",
         "Gang coordinator address set by tools/launch.py with NUM_PROCS "
         "and PROC_ID; the port accepts only the one-process contract.",
         _CLUSTER),
    Knob("SPARKNET_NUM_PROCS", "int", "",
         "World size under the launcher contract; above 1 is refused "
         "(ROADMAP A12, pod half).", _CLUSTER),
    Knob("SPARKNET_RESTART_COUNT", "int", "0",
         "Exported by the supervisor to relaunched children: restarts so "
         "far.", _RESIL),
    Knob("SPARKNET_FENCE_BASE", "int", "0",
         "Fleet-stamped incarnation fence base (episode * 1e5); the runner "
         "adds its attempt to mint SPARKNET_FENCE_TOKEN; 0 = fencing off.",
         _RESIL),
    Knob("SPARKNET_LEASE_S", "float", "2",
         "Heartbeat lease: a host whose newest beat is older than "
         "LEASE_S * LEASE_MISSES is SUSPECT (suspended, never killed).",
         _P + "parallel/health.py"),
    Knob("SPARKNET_LEASE_MISSES", "int", "3",
         "Missed leases before a host turns SUSPECT.",
         _P + "parallel/health.py"),
    Knob("SPARKNET_SSH_CMD", "str", "",
         "ssh binary of SshTransport's wire path (default 'ssh'); point it "
         "at a local fake-ssh script to drive the remote argv, env and "
         "stdio with no sshd.  Set, it sends loopback addresses over the "
         "ssh path too.", _P + "parallel/transport.py"),
    Knob("SPARKNET_SHIP_CHUNK_MB", "float", "4",
         "Chunk size (MB) of crc-verified checkpoint shipping.",
         _P + "parallel/transport.py"),
    Knob("SPARKNET_SHIP_RETRIES", "int", "4",
         "Attempts for one ship (each retry keeps the destination's "
         "valid prefix).", _P + "parallel/transport.py"),
    Knob("SPARKNET_FLEET_HOSTS", "spec", "",
         "Host inventory for placement: 'name=devices[@addr],...' inline "
         "or a JSON list path; a remote addr places over a host "
         "transport; unset = the single-host device budget.", _FLEET),
    Knob("SPARKNET_FLEET_HOST", "str", "",
         "Host label the launcher stamps on each worker; joins beats and "
         "telemetry to the placement.", _P + "tools/launch.py"),
    Knob("SPARKNET_FLEET_HOSTVEC", "str", "",
         "Comma-separated per-slot host labels of the gang's placement, "
         "exported to fleet tenants.", _FLEET),
    # --- router, autoscaler, rollout ---
    Knob("SPARKNET_ROUTER_SPILL_DEPTH", "int", "16",
         "Queue depth at the home replica beyond which the router spills "
         "to the next ring member.", _ROUTER),
    Knob("SPARKNET_ROUTER_FAILOVERS", "int", "3",
         "Most alternate replicas tried before a typed routing failure.",
         _ROUTER),
    Knob("SPARKNET_ROUTER_DRAIN_S", "float", "30",
         "Seconds a draining replica keeps answering in-flight work.",
         _ROUTER),
    Knob("SPARKNET_AUTOSCALE_MIN", "int", "1", "Replica floor.", _AUTOSCALE),
    Knob("SPARKNET_AUTOSCALE_MAX", "int", "4",
         "Replica ceiling (device budget).", _AUTOSCALE),
    Knob("SPARKNET_AUTOSCALE_UP_QUEUE", "float", "8.0",
         "Mean queue depth per replica that triggers scale-up.",
         _AUTOSCALE),
    Knob("SPARKNET_AUTOSCALE_DOWN_IDLE_S", "float", "10.0",
         "Idle seconds before a replica may be scaled down.", _AUTOSCALE),
    Knob("SPARKNET_AUTOSCALE_COOLDOWN_S", "float", "5.0",
         "Least seconds between scaling decisions.", _AUTOSCALE),
    Knob("SPARKNET_AUTOSCALE_EVAL_S", "float", "1.0",
         "Policy evaluation period in seconds.", _AUTOSCALE),
    Knob("SPARKNET_ROLLOUT_CANARY_FRACTION", "float", "0.1",
         "Traffic share a newly started canary takes, in (0, 1].",
         _ROLLOUT),
    Knob("SPARKNET_ROLLOUT_JUDGE_S", "float", "8.0",
         "Seconds of sustained health before the judge promotes a canary.",
         _ROLLOUT),
    Knob("SPARKNET_ROLLOUT_POLL_S", "float", "0.5",
         "Judge poll interval in seconds.", _ROLLOUT),
    Knob("SPARKNET_ROLLOUT_MIN_REQUESTS", "int", "20",
         "Observed requests needed before a canary may be promoted.",
         _ROLLOUT),
    Knob("SPARKNET_ROLLOUT_BREACH_POLLS", "int", "2",
         "Consecutive breach verdicts that trigger the rollback.",
         _ROLLOUT),
    # --- tombstones: the JAX package's, window closed ---
    Knob("SPARKNET_LRN_CUMSUM", "bool", "",
         "REMOVED: pin LRN window-sum form per key in the SPARKNET_TUNE "
         "table instead.", _TUNER,
         removed="r14: use a SPARKNET_TUNE table pin (winner=cumsum / "
                 "reduce_window)"),
    Knob("SPARKNET_FUSE_PALLAS", "bool", "",
         "REMOVED: pin the lrn_epilogue lowering per key in the "
         "SPARKNET_TUNE table instead.", _TUNER,
         removed="r14: use a SPARKNET_TUNE table pin (winner=reference / "
                 "pallas)"),
)

# name -> doc of every live knob (the read-only view older callers use)
KNOBS: dict[str, str] = {k.name: k.doc for k in all_knobs() if not k.removed}


# ---------------------------------------------------------------------------
# KNOBS.md
# ---------------------------------------------------------------------------

_MD_HEADER = """\
# SPARKNET_* knob reference (the PyTorch port)

Auto-generated from `sparknet_tpu_torch/utils/knobs.py` by
`python -m sparknet_tpu_torch.tools.knobs --emit` — do not edit by hand;
`python -m sparknet_tpu_torch.tools.knobs --check` gates drift.

Conventions: bool knobs take `0`/`1` (the doc line states which side is
the default); `default` is the unset behavior; removed knobs are listed
last as tombstones (reading one raises `RemovedKnob`).
"""


def _md_table(rows: Iterable[Knob]) -> list[str]:
    out = ["| Knob | Type | Default | Owner | Doc |",
           "| --- | --- | --- | --- | --- |"]
    for k in rows:
        default = k.default if k.default != "" else "*(unset)*"
        out.append(f"| `{k.name}` | {k.type} | {default} | `{k.owner}` | "
                   f"{k.doc} |")
    return out


def knobs_md() -> str:
    """The full text of ``sparknet_tpu_torch/KNOBS.md``."""
    live = [k for k in all_knobs() if not k.removed]
    dead = [k for k in all_knobs() if k.removed]
    lines = [_MD_HEADER]
    by_owner: dict[str, list[Knob]] = {}
    for k in live:
        by_owner.setdefault(k.owner, []).append(k)
    for owner in sorted(by_owner):
        lines.append(f"\n## `{owner}`\n")
        lines.extend(_md_table(by_owner[owner]))
    if dead:
        lines.append("\n## Removed (tombstones)\n")
        lines.append("| Knob | Removed | Replacement |")
        lines.append("| --- | --- | --- |")
        for k in dead:
            since, _, repl = k.removed.partition(": ")
            lines.append(f"| `{k.name}` | {since} | {repl or k.doc} |")
    lines.append("")
    return "\n".join(lines)
