"""Partition rule tables: hybrid model+data sharding of the params.

The port's own copy of ``sparknet_tpu/parallel/partition.py``.  SparkNet's
rounds replicate the full weight vector on every worker, so the
τ-boundary broadcast and the resident copy both scale with total
parameter bytes, and the FC layers that dominate CaffeNet's and VGG's
parameter counts shard cleanly along their ``num_output`` rows.  An
ordered rule table of ``(regex, dim)`` pairs is matched against every
parameter leaf (named ``"<layer>/<blob_idx>"``: ``"fc6/0"`` is fc6's
weight, ``"fc6/1"`` its bias) and resolved into a :class:`ShardPlan`, a
frozen map of which dimension of which leaf lives on the layout's shard
axis.  ``parallel/trainer.py`` keeps one resident tree per position: the
replicated leaves whole, each sharded leaf as the position's own tile.

Rule semantics (first match wins, the JAX package's):

* rules are tried in order; the first regex that ``re.search``-matches a
  leaf name decides that leaf;
* ``dim = None`` replicates; ``dim = k`` shards dimension *k* across the
  plan's axis;
* a scalar (0-d) leaf is never partitioned, whatever the rule says;
* a matched dim that does not exist or does not divide by the shard
  count falls back to replicated, listed in ``plan.fallbacks``;
* leaves no rule matches are collected and raised all at once (the zoo
  table ends with an explicit catch-all).

``DEFAULT_RULES`` is the zoo default: FC / inner-product weights shard
their output rows, convolutions and every bias replicate.  A custom table
is a versioned JSON file (``SPARKNET_SHARD=<path>``); an unknown version
is refused.  ``shard_plan_id()`` hashes everything that changes the
placement, the same ``plan_id`` as the JAX package's for the same table
and world: the ledger's ``sharding`` field and the checkpoint manifests
carry it.

The JAX package's ``shard_map`` pieces become data movement on tensors:
``spec_tree`` describes the layout (a ``PartitionSpec``-like tuple per
leaf), ``gather`` is ``torch.cat`` of the positions' tiles along the
plan's dim and ``take_shard`` is ``narrow``.  No arithmetic, so the
sharded round's bits are the replicated round's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any, Sequence

import numpy as np

RULE_TABLE_VERSION = 1

# (regex, dim), first match wins: blob 0 of ip*/fc*/*classifier layers
# (shape (num_output, dim_in)) shards its output rows; everything else
# replicates.  The catch-all is explicit: a table with holes raises.
DEFAULT_RULES: tuple[tuple[str, int | None], ...] = (
    (r"(^|/)(fc|ip|classifier)[^/]*/0$", 0),
    (r".*", None),
)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Resolved placement: which dim of which leaf lives on ``axis``.

    ``dims`` maps leaf name -> sharded dimension for the sharded leaves
    only; every other leaf is replicated over ``axis``.  ``fallbacks``
    lists leaves a rule wanted sharded that had to replicate (scalar,
    missing dim, or not divisible by ``n_shards``)."""

    axis: str
    n_shards: int
    table_id: str
    dims: tuple[tuple[str, int], ...]
    fallbacks: tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "_dim_map", dict(self.dims))

    @property
    def sharded(self) -> bool:
        return bool(self.dims)

    def dim_of(self, key: str) -> int | None:
        return self._dim_map.get(key)

    def plan_id(self) -> str:
        """Content hash of the placement (the JAX package's, digit for
        digit)."""
        doc = {"axis": self.axis, "n_shards": self.n_shards,
               "dims": sorted(self.dims)}
        digest = hashlib.sha256(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()[:12]
        return f"shard:{digest}"

    def dims_dict(self) -> dict[str, int]:
        return dict(self.dims)

    def spec_tree(self, params) -> dict[str, list[tuple]]:
        """A params-shaped tree of layout descriptions, the JAX
        ``PartitionSpec``'s entries as a tuple: ``()`` for a replicated
        leaf, ``(None,) * dim + (axis,)`` for a sharded one."""
        out = {}
        for name, blobs in params.items():
            row = []
            for i in range(len(blobs)):
                dim = self.dim_of(f"{name}/{i}")
                row.append(() if dim is None
                           else (None,) * dim + (self.axis,))
            out[name] = row
        return out

    def gather(self, own, tiles: Sequence) -> dict[str, list]:
        """Widen to full leaves: the replicated leaves of ``own`` (one
        position's resident tree) as they are, each sharded leaf the
        ``torch.cat`` of ``tiles`` (the resident trees of every position
        on the axis, in axis order) along its dim.  Exact: no
        arithmetic."""
        import torch
        out = {}
        for name, blobs in own.items():
            row = []
            for i, b in enumerate(blobs):
                dim = self.dim_of(f"{name}/{i}")
                row.append(b if dim is None else torch.cat(
                    [t[name][i] for t in tiles], dim=dim))
            out[name] = row
        return out

    def take_shard(self, params, index: int) -> dict[str, list]:
        """Tile ``index`` of every sharded leaf of full ``params`` (a
        ``narrow``, a view of the leaf), the replicated leaves as they
        are.  Exact: no arithmetic."""
        out = {}
        for name, blobs in params.items():
            row = []
            for i, b in enumerate(blobs):
                dim = self.dim_of(f"{name}/{i}")
                if dim is None:
                    row.append(b)
                else:
                    size = b.shape[dim] // self.n_shards
                    row.append(b.narrow(dim, index * size, size))
            out[name] = row
        return out


def shard_plan_id(plan: ShardPlan | None) -> str:
    """The ledger's and the manifests' stamp; ``"dp"`` is pure data
    parallelism."""
    return plan.plan_id() if plan is not None else "dp"


def load_rule_table(path: str
                    ) -> tuple[tuple[tuple[str, int | None], ...], str]:
    """Load a versioned JSON rule table; returns (rules, table_id).

    Format::

        {"version": 1,
         "rules": [{"pattern": "(^|/)fc[^/]*/0$", "dim": 0},
                   {"pattern": ".*", "dim": null}]}

    An unknown version is refused."""
    with open(path) as f:
        doc = json.load(f)
    version = doc.get("version")
    if version != RULE_TABLE_VERSION:
        raise ValueError(
            f"rule table {path}: version {version!r} != supported "
            f"{RULE_TABLE_VERSION} — refusing to guess its semantics")
    rules = []
    for i, r in enumerate(doc.get("rules", [])):
        pat, dim = r.get("pattern"), r.get("dim")
        if not isinstance(pat, str) or not (dim is None
                                            or isinstance(dim, int)):
            raise ValueError(f"rule table {path}: rule #{i} malformed: {r!r}")
        re.compile(pat)   # a bad regex fails at load, not at first match
        rules.append((pat, dim))
    if not rules:
        raise ValueError(f"rule table {path}: no rules")
    digest = hashlib.sha256(
        json.dumps(rules, sort_keys=True).encode()).hexdigest()[:12]
    return tuple(rules), f"table:{digest}"


def match_partition_rules(rules, params, n_shards: int):
    """Apply an ordered rule table to a params tree; returns ``(dims,
    fallbacks, unmatched)`` over leaf names."""
    compiled = [(re.compile(pat), dim) for pat, dim in rules]
    dims: dict[str, int] = {}
    fallbacks: list[str] = []
    unmatched: list[str] = []
    for name in sorted(params):
        for i, leaf in enumerate(params[name]):
            key = f"{name}/{i}"
            for rx, dim in compiled:
                if rx.search(key) is None:
                    continue
                if dim is not None:
                    shape = tuple(leaf.shape)
                    if (len(shape) == 0 or dim >= len(shape)
                            or shape[dim] % n_shards):
                        fallbacks.append(key)
                    else:
                        dims[key] = dim
                break
            else:
                unmatched.append(key)
    return dims, fallbacks, unmatched


def resolve_plan(mode: str, params, *, axis: str, n_shards: int,
                 ) -> ShardPlan | None:
    """Resolve ``SPARKNET_SHARD`` / ``TrainerConfig.shard`` into a plan
    against the params' shapes (only ``.shape`` is read: meta tensors
    do).  ``""``/``"off"`` or one shard -> None (pure data parallelism,
    the one-copy path); ``"auto"`` -> :data:`DEFAULT_RULES`; anything
    else is a JSON rule table's path.  A table that leaves leaves
    undecided raises, listing every hole."""
    mode = (mode or "off").strip()
    if mode.lower() in ("", "off", "0", "dp"):
        return None
    if n_shards <= 1:
        return None
    if mode.lower() == "auto":
        rules, table_id = DEFAULT_RULES, f"auto-v{RULE_TABLE_VERSION}"
    else:
        rules, table_id = load_rule_table(mode)
    dims, fallbacks, unmatched = match_partition_rules(rules, params,
                                                       n_shards)
    if unmatched:
        raise ValueError(
            f"partition rule table {table_id} leaves {len(unmatched)} "
            f"leaves undecided: {unmatched} — add rules (or a catch-all "
            f"'.*' -> replicate) so every placement is deliberate")
    if not dims:
        return None
    return ShardPlan(axis=axis, n_shards=n_shards, table_id=table_id,
                     dims=tuple(sorted(dims.items())),
                     fallbacks=tuple(fallbacks))


def _itemsize(leaf: Any) -> int:
    """Bytes an element of a tensor, numpy array or shape struct."""
    size = getattr(leaf, "element_size", None)
    if callable(size):
        return int(size())
    return np.dtype(leaf.dtype).itemsize


def boundary_bytes_per_chip(params, plan: ShardPlan | None,
                            n_shards: int | None = None) -> int:
    """Bytes one position receives at the τ boundary to end the round in
    its resident layout (codec ``none``): the whole tree without a plan,
    the replicated leaves whole and 1/n of each sharded leaf under
    one."""
    n = n_shards if n_shards is not None else (plan.n_shards if plan else 1)
    total = 0
    for name, blobs in params.items():
        for i, leaf in enumerate(blobs):
            nbytes = 1
            for d in leaf.shape:
                nbytes *= int(d)
            nbytes *= _itemsize(leaf)
            if plan is not None and plan.dim_of(f"{name}/{i}") is not None:
                nbytes //= n
            total += nbytes
    return total
