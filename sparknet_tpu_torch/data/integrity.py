"""Record-level data integrity: typed corruption errors and quarantine.

The port's own copy of ``sparknet_tpu/data/integrity.py`` (:39-175).  The
reference's data plane trusts every byte it reads: a truncated LMDB datum
dies deep inside protobuf (reference: caffe/src/caffe/
data_transformer.cpp Transform aborts on a CHECK).  Here:

- :class:`DataCorruptionError`: every detected bad record surfaces as one
  typed error carrying its attribution (source, key, byte offset, reason)
  instead of an opaque numpy or struct error from five frames down.
- :class:`Quarantine`: bad records are accounted, under a bounded
  per-epoch budget (:class:`QuarantinePolicy`).  Within budget the feed
  skips the record and :meth:`Quarantine.report` says what was skipped
  and where; one record past the budget raises
  :class:`QuarantineExceeded`.  The default budget is zero.
- :func:`crc32`: the per-record checksum primitive.

Consumed by ``data/db.py::db_feed`` (decode-time validation).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any

from ..utils import knobs


def crc32(data: bytes) -> int:
    """The per-record checksum (zlib.crc32, masked to unsigned 32-bit)."""
    return zlib.crc32(data) & 0xFFFFFFFF


class DataCorruptionError(ValueError):
    """A record failed an integrity check (undecodable bytes, impossible
    shape, checksum mismatch).  Carries attribution so a quarantine report
    — or a crash log — names the byte range to go look at, not just
    "cannot reshape array".  Subclasses ``ValueError`` so callers that
    already guard the decode path keep working."""

    def __init__(self, reason: str, *, source: str | None = None,
                 key: Any = None, offset: int | None = None):
        self.reason = reason
        self.source = source
        self.key = key
        self.offset = offset
        where = []
        if source is not None:
            where.append(f"source={source!r}")
        if key is not None:
            where.append(f"key={key!r}")
        if offset is not None:
            where.append(f"offset={offset}")
        suffix = f" [{', '.join(where)}]" if where else ""
        super().__init__(f"{reason}{suffix}")


class QuarantineExceeded(DataCorruptionError):
    """The per-epoch quarantine budget is spent: the data source is too
    corrupt to keep training on.  Carries the quarantine's structured
    ``report`` for post-mortem attribution."""

    def __init__(self, reason: str, report: dict[str, Any], **kw):
        super().__init__(reason, **kw)
        self.report = report


@dataclasses.dataclass(frozen=True)
class QuarantinePolicy:
    """How many bad records an epoch may absorb before the feed fails.

    budget = ``max_records`` + floor(``max_fraction`` · epoch_size); with
    an unknown epoch size only ``max_records`` applies.  The default is
    zero tolerance — corruption is *detected and attributed* but never
    silently budgeted unless the operator opts in (env knobs
    ``SPARKNET_QUARANTINE_FRACTION`` / ``SPARKNET_QUARANTINE_RECORDS``
    for feeds that build their own policy)."""

    max_fraction: float = 0.0
    max_records: int = 0

    def __post_init__(self):
        if not 0.0 <= self.max_fraction <= 1.0:
            raise ValueError(
                f"max_fraction must be in [0, 1], got {self.max_fraction}")
        if self.max_records < 0:
            raise ValueError(
                f"max_records must be >= 0, got {self.max_records}")

    @classmethod
    def from_env(cls, env=None) -> "QuarantinePolicy":
        """The policy of the ``SPARKNET_QUARANTINE_*`` knobs, read from
        ``env`` (a mapping) or, when None, from the process environment."""
        get = knobs.raw if env is None else env.get
        return cls(
            max_fraction=float(
                get("SPARKNET_QUARANTINE_FRACTION", "0") or 0),
            max_records=int(
                get("SPARKNET_QUARANTINE_RECORDS", "0") or 0))

    def budget(self, epoch_size: int | None) -> int:
        frac = (int(self.max_fraction * epoch_size)
                if epoch_size else 0)
        return self.max_records + frac


class Quarantine:
    """Bounded skip-and-count router for detected-bad records.

    One instance guards one feed.  :meth:`admit` files a bad record:
    within the per-epoch budget it returns (caller skips the record and
    pulls a replacement); the first record PAST the budget raises
    :class:`QuarantineExceeded` carrying the full report.  Counts are
    kept per source (DB path, partition, store key) so the report
    attributes rot to where it lives; :meth:`start_epoch` resets the
    budget clock while cumulative counts keep accruing."""

    _MAX_EXAMPLES = 16

    def __init__(self, policy: QuarantinePolicy | None = None,
                 epoch_size: int | None = None, source: str | None = None):
        self.policy = policy or QuarantinePolicy()
        self.epoch_size = epoch_size
        self.default_source = source
        self.budget = self.policy.budget(epoch_size)
        self.epoch_bad = 0
        self.total_bad = 0
        self.epochs = 0
        self.by_source: dict[str, int] = {}
        self.examples: list[dict[str, Any]] = []

    def start_epoch(self) -> None:
        """A full pass over the source completed: re-arm the budget."""
        self.epochs += 1
        self.epoch_bad = 0

    def admit(self, err: DataCorruptionError,
              source: str | None = None) -> None:
        """File one detected-bad record; raises :class:`QuarantineExceeded`
        when this record exceeds the per-epoch budget."""
        src = source or err.source or self.default_source or "<unknown>"
        self.epoch_bad += 1
        self.total_bad += 1
        self.by_source[src] = self.by_source.get(src, 0) + 1
        if len(self.examples) < self._MAX_EXAMPLES:
            self.examples.append({"source": src, "key": repr(err.key),
                                  "offset": err.offset,
                                  "reason": err.reason})
        if self.epoch_bad > self.budget:
            raise QuarantineExceeded(
                f"quarantine budget exceeded: {self.epoch_bad} bad records "
                f"this epoch > budget {self.budget} "
                f"(policy: max_fraction={self.policy.max_fraction}, "
                f"max_records={self.policy.max_records}, "
                f"epoch_size={self.epoch_size}); last: {err}",
                self.report(), source=src, key=err.key, offset=err.offset)

    def report(self) -> dict[str, Any]:
        """Structured skip accounting (JSON-serializable)."""
        return {
            "total_bad": self.total_bad,
            "epoch_bad": self.epoch_bad,
            "budget": self.budget,
            "epochs_completed": self.epochs,
            "by_source": dict(self.by_source),
            "examples": list(self.examples),
        }
