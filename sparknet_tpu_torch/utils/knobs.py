"""The ``SPARKNET_*`` environment knobs the port reads.

The port's own copy of the read half of ``sparknet_tpu/utils/knobs.py``,
for the knobs of the serving path, the training feed and the DB
readers.  Reading a name that is not declared
here raises :class:`UnknownKnob`, so a typo'd knob fails loudly instead of
silently meaning "default".  Values are read live from ``os.environ``.
"""

from __future__ import annotations

import os

# name -> one-line doc (defaults live with the readers: ServeConfig,
# data/pipeline.py)
KNOBS: dict[str, str] = {
    "SPARKNET_SERVE_SHAPES": "serving batch shapes, comma-separated",
    "SPARKNET_SERVE_MAX_DELAY_MS": "coalesce deadline in milliseconds",
    "SPARKNET_SERVE_QUEUE": "admission bound on outstanding requests",
    "SPARKNET_SERVE_INFLIGHT": "dispatched-but-not-demuxed batch window",
    "SPARKNET_SERVE_HBM_MB": "model-house device-memory budget in MB",
    "SPARKNET_SERVE_DTYPE": "serving compute dtype, bf16 or f32",
    "SPARKNET_SERVE_QUOTAS": "tenant=qps[,tenant=qps...] caps",
    "SPARKNET_SERVE_FORCE_ADMIT": "1 admits models larger than the budget",
    "SPARKNET_FEED_DEPTH": "host batches the device feed stages ahead",
    "SPARKNET_FEED_PUTTERS": "device feed's host-to-device copy threads",
    "SPARKNET_FEED_WORKERS": "DB feed's decode threads",
    "SPARKNET_IO_RETRIES": "attempts for data-plane file and DB opens",
    "SPARKNET_IO_BACKOFF": "base backoff in seconds between those attempts",
    "SPARKNET_QUARANTINE_FRACTION": "bad records an epoch may skip, as a "
                                    "fraction of the epoch",
    "SPARKNET_QUARANTINE_RECORDS": "bad records an epoch may skip, a count",
}


class UnknownKnob(KeyError):
    """A read of a ``SPARKNET_*`` name the port does not declare."""


def raw(name: str, default: str | None = None) -> str | None:
    """Declaration-checked ``os.environ.get``."""
    if name not in KNOBS:
        raise UnknownKnob(f"{name} is not a knob of the port "
                          f"(known: {sorted(KNOBS)})")
    return os.environ.get(name, default)

