"""The ``SPARKNET_*`` environment knobs the port reads.

The port's own copy of the read half of ``sparknet_tpu/utils/knobs.py``
(``raw``, ``is_set``, ``get_str``, ``get_int``, ``get_float``,
``get_bool``, :106-157), for the knobs of the serving path, its SLO
monitor, the model registry, the health beacons, the training feed, the
DB readers, the record shards and their tiered cache, the trainer's
round shape (``comm_config_from_env``), the checkpoint
writer, the fault injector and the telemetry plane
(``utils/telemetry.py``).  Reading a name that is not declared here
raises :class:`UnknownKnob`, so a typo'd knob fails loudly instead of
silently meaning "default".  Values are read live from ``os.environ``.
"""

from __future__ import annotations

import os

# name -> one-line doc (defaults live with the readers: ServeConfig,
# parallel/registry.py, parallel/health.py, data/pipeline.py,
# parallel/trainer.py, utils/checkpoint.py,
# utils/faults.py, utils/telemetry.py; each doc names the JAX package's
# default)
KNOBS: dict[str, str] = {
    "SPARKNET_SERVE_SHAPES": "serving batch shapes, comma-separated",
    "SPARKNET_SERVE_MAX_DELAY_MS": "coalesce deadline in milliseconds",
    "SPARKNET_SERVE_QUEUE": "admission bound on outstanding requests",
    "SPARKNET_SERVE_INFLIGHT": "dispatched-but-not-demuxed batch window",
    "SPARKNET_SERVE_HBM_MB": "model-house device-memory budget in MB",
    "SPARKNET_SERVE_DTYPE": "serving compute dtype, bf16 or f32",
    "SPARKNET_SERVE_QUOTAS": "tenant=qps[,tenant=qps...] caps",
    "SPARKNET_SERVE_FORCE_ADMIT": "1 admits models larger than the budget",
    "SPARKNET_SLO_P99_MS": "declared p99 latency SLO in ms; unset or 0 (the "
                           "default) leaves the latency SLO undeclared",
    "SPARKNET_SLO_REJECT_BUDGET": "rejection-rate error budget of the SLO "
                                  "burn accounting; default 0.02",
    "SPARKNET_SLO_WINDOW_S": "slow burn-rate window in seconds; default 60",
    "SPARKNET_SLO_FAST_S": "fast burn-rate window in seconds; default 5",
    "SPARKNET_REGISTRY_DIR": "root of the model registry (version bundles "
                             "and per-model channel files); unset (the "
                             "default) serves by name only",
    "SPARKNET_HEARTBEAT_DIR": "directory for liveness beat files; unset "
                              "(the default) writes no beats",
    "SPARKNET_FEED_DEPTH": "host batches the device feed stages ahead",
    "SPARKNET_FEED_PUTTERS": "device feed's host-to-device copy threads",
    "SPARKNET_FEED_WORKERS": "DB feed's decode threads",
    "SPARKNET_AUG_DEVICE": "Solver.set_augment's default: 1 (default) runs "
                           "the crop, mirror, mean and scale on the "
                           "device, 0 on the host (the same bits)",
    "SPARKNET_RECORD_READERS": "record-shard feed's ranged-read threads; "
                               "0 = one thread; unset = "
                               "SPARKNET_FEED_WORKERS",
    "SPARKNET_RECORD_SHARD_MB": "record-shard converter's roll size in "
                                "MiB; default 64",
    "SPARKNET_CACHE_SHARDS": "ShardCache RAM tier: resident shards before "
                             "LRU eviction; default 4",
    "SPARKNET_CACHE_SPILL_DIR": "ShardCache disk tier directory for RAM "
                                "evictees; unset (the default) drops them",
    "SPARKNET_CACHE_SPILL_SHARDS": "ShardCache disk tier: most spilled "
                                   "shards, the oldest deleted first; "
                                   "default 16",
    "SPARKNET_IO_RETRIES": "attempts for data-plane file and DB opens",
    "SPARKNET_IO_BACKOFF": "base backoff in seconds between those attempts",
    "SPARKNET_QUARANTINE_FRACTION": "bad records an epoch may skip, as a "
                                    "fraction of the epoch",
    "SPARKNET_QUARANTINE_RECORDS": "bad records an epoch may skip, a count",
    "SPARKNET_TAU": "steps per round for comm_config_from_env; unset (the "
                    "default) keeps the config's tau",
    "SPARKNET_COMM_CODEC": "τ-boundary exchange codec for "
                           "comm_config_from_env: none, bf16, int8, "
                           "int8_channel or a registered name; unset (the "
                           "default) keeps the config's",
    "SPARKNET_COMM_OVERLAP": "1 dispatches encode/exchange/decode without "
                             "host syncs; unset (the default) keeps the "
                             "config's",
    "SPARKNET_SHARD": "partition rule table (not ported, ROADMAP A12); "
                      "unset by default",
    "SPARKNET_SHARD_CKPT": "per-shard round checkpoints (not ported, "
                           "ROADMAP A12); unset by default",
    "SPARKNET_ASYNC_CKPT": "0 forces synchronous round checkpoints; default "
                           "1 (asynchronous)",
    "SPARKNET_FENCE_TOKEN": "this writer's incarnation fence token; default "
                            "0 (fencing off)",
    "SPARKNET_FAULT": "comma-separated fault specs (utils/faults.py); "
                      "empty (the default) injects none",
    "SPARKNET_FAULT_ATTEMPT": "relaunch attempt index faults gate on; "
                              "default 0",
    "SPARKNET_PROC_ID": "this process's rank, which faults gate on; "
                        "default 0",
    "SPARKNET_TELEMETRY": "0 turns the telemetry plane off (null registry, "
                          "no spans, no recorder); default on",
    "SPARKNET_TRACE_DIR": "write trace_*.jsonl span shards and flight "
                          "dumps here; unset (the default) traces nothing",
    "SPARKNET_METRICS_SNAP": "write metrics_rank*.json/.prom snapshots "
                             "here; unset by default",
    "SPARKNET_METRICS_SNAP_S": "least seconds between metrics snapshots; "
                               "default 2",
    "SPARKNET_FLIGHT_EVENTS": "flight-recorder ring size; default 256",
    "SPARKNET_RUN_ID": "telemetry correlation run id; default derived "
                       "once per process",
    "SPARKNET_TELEMETRY_RANK": "trace-shard rank of a process outside a "
                               "launcher; wins over SPARKNET_PROC_ID",
    "SPARKNET_INCARNATION": "relaunch incarnation in the correlation ids; "
                            "default 0",
    "SPARKNET_FLEET_JOB": "fleet job name in the correlation ids; unset by "
                          "default",
}


class UnknownKnob(KeyError):
    """A read of a ``SPARKNET_*`` name the port does not declare."""


class InvalidKnobValue(ValueError):
    """A set knob whose value does not parse as its type."""


def raw(name: str, default: str | None = None) -> str | None:
    """Declaration-checked ``os.environ.get``."""
    if name not in KNOBS:
        raise UnknownKnob(f"{name} is not a knob of the port "
                          f"(known: {sorted(KNOBS)})")
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
