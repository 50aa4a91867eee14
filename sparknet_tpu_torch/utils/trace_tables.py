"""Per-op, per-category and per-layer time tables from a ``torch.profiler``
profile.

The port's counterpart of ``sparknet_tpu/utils/xplane.py::op_tables`` and
``format_tables`` (:248-346).  It reads the profiler's events, not an
XSpace, and writes the same ``op_table.json`` tables: ``plane``,
``total_ms`` and the ``by_category``, ``by_op`` and ``by_layer`` rows
{op, total_ms, count, pct, gflops_per_s, gb_per_s}.

What is timed:

- **On the card**, every device activity of the profile (kernels, copies,
  memsets): ``by_op`` keys it by the kernel's name, ``by_category`` by the
  host op that launched it (an ``aten::`` op, or a custom autograd
  function's forward or backward for the hand kernels), as the profiler
  joined them through the launch's correlation id (each host op's
  ``kernels``).
- **On the CPU** (no device activity), every host op's self time, keyed
  by its name in both tables.

``by_layer`` charges that time to the Caffe layer whose ``L[<layer>]``
range (``utils/profiling.py::layer_scope``, the JAX package's convention,
``xplane.py:26``) holds the launching op.  A backward op runs outside
every forward range, on autograd's thread: it is joined to its forward
op through autograd's sequence number (the backward node's ``Sequence
number`` and ``Fwd thread id`` against the forward op's own).  Time
that joins no layer (the update, the loss seed, copies outside the net)
goes to the row :data:`UNATTRIBUTED`; nothing is dropped, so the
``by_layer`` rows sum to ``total_ms``.  Each ``by_layer`` row also
carries ``backward_ms``, the part of its time joined through a backward
op.  The profiler gives no per-kernel operation or byte counts, so
``gflops_per_s`` and ``gb_per_s`` are 0.0, as in the JAX package's CPU
tables; MFU comes from ``profiling.step_cost_flops``.
"""

from __future__ import annotations

import re
from typing import Any, Callable

_LAYER_RE = re.compile(r"L\[([^\]]+)\]")
_BACKWARD_PREFIX = "autograd::engine::evaluate_function"
UNATTRIBUTED = "(unattributed)"


def _is_cpu(e) -> bool:
    return str(e.device_type).endswith("CPU")


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or \
        _LAYER_RE.fullmatch(e.name) is not None


class _Joiner:
    """Layer (and pass) of a host op: its own ``L[...]`` ancestor in the
    forward, its forward op's through autograd's sequence number in the
    backward."""

    def __init__(self, cpu_events: list):
        self._fwd: dict[tuple[int, int], Any] = {}
        self._memo: dict[int, tuple[str | None, bool]] = {}
        # forward ops that recorded a sequence number, the newest winning
        # (ops that create no autograd node share the next one's number)
        for e in sorted(cpu_events, key=lambda e: e.time_range.start):
            if e.sequence_nr >= 0 and not self._backward_root(e):
                self._fwd[(e.sequence_nr, e.thread)] = e
                self._fwd[(e.sequence_nr, -1)] = e

    @staticmethod
    def _backward_root(e):
        """The ``evaluate_function`` ancestor of a backward op, or None."""
        while e is not None:
            if e.name.startswith(_BACKWARD_PREFIX):
                return e
            e = e.cpu_parent
        return None

    @staticmethod
    def _forward_layer(e) -> str | None:
        while e is not None:
            m = _LAYER_RE.fullmatch(e.name)
            if m:
                return m.group(1)
            e = e.cpu_parent
        return None

    def layer(self, op) -> tuple[str | None, bool]:
        """(layer name or None, joined through a backward op)."""
        hit = self._memo.get(id(op))
        if hit is not None:
            return hit
        root = self._backward_root(op)
        if root is None:
            out = (self._forward_layer(op), False)
        else:
            fwd = (self._fwd.get((root.sequence_nr, root.fwd_thread))
                   or self._fwd.get((root.sequence_nr, -1)))
            out = ((self._forward_layer(fwd) if fwd is not None else None),
                   True)
        self._memo[id(op)] = out
        return out


def _leaves(events: list) -> tuple[str, list[tuple[float, str, str, Any]]]:
    """(plane, [(microseconds, op key, category, launching host op)])."""
    cpu = [e for e in events if _is_cpu(e)]
    device = [e for e in events if not _is_cpu(e) and not _is_annotation(e)]
    if not device:
        return "/host:CPU", [(e.self_cpu_time_total, e.name, e.name, e)
                             for e in cpu if not e.is_async
                             and not _is_annotation(e)]
    # the profiler hands each device activity to the host op whose
    # launch's correlation id it carries (FunctionEvent.kernels)
    out = []
    claimed: dict[str, list] = {}
    for op in cpu:
        if getattr(op, "is_legacy", False):
            continue
        for k in op.kernels:
            if _LAYER_RE.fullmatch(k.name):
                continue
            out.append((k.duration, k.name, op.name, op))
            c = claimed.setdefault(k.name, [0, 0.0])
            c[0] += 1
            c[1] += k.duration
    # device activity no host op claimed: unattributed, never dropped
    by_name: dict[str, list] = {}
    for k in device:
        c = by_name.setdefault(k.name, [0, 0.0])
        c[0] += 1
        c[1] += k.time_range.end - k.time_range.start
    for name, (n, us) in by_name.items():
        cn, cus = claimed.get(name, (0, 0.0))
        if n > cn:
            out += [((us - cus) / (n - cn), name, UNATTRIBUTED, None)] \
                * (n - cn)
    return f"/device:GPU:{device[0].device_index}", out


def _rows(leaves: list, key: Callable, total_us: float,
          backward: Callable | None = None) -> list[dict]:
    acc: dict[str, list] = {}
    for leaf in leaves:
        r = acc.setdefault(key(leaf), [0.0, 0, 0.0])
        r[0] += leaf[0]
        r[1] += 1
        if backward is not None and backward(leaf):
            r[2] += leaf[0]
    out = []
    for name, (us, n, bwd_us) in sorted(acc.items(), key=lambda kv: -kv[1][0]):
        row = {"op": name, "total_ms": round(us / 1e3, 3), "count": n,
               "pct": round(100 * us / (total_us or 1.0), 1),
               "gflops_per_s": 0.0, "gb_per_s": 0.0}
        if backward is not None:
            row["backward_ms"] = round(bwd_us / 1e3, 3)
        out.append(row)
    return out


def op_tables(prof, *, top: int | None = 30) -> dict:
    """The tables of a finished ``torch.profiler.profile`` (or any object
    with its ``events()``): ``{plane, total_ms, by_category, by_op,
    by_layer}``, ``by_op`` cut to the ``top`` rows (all with None)."""
    events = list(prof.events())
    plane, leaves = _leaves(events)
    joiner = _Joiner([e for e in events if _is_cpu(e)])
    joined = [(leaf, *(joiner.layer(leaf[3]) if leaf[3] is not None
                       else (None, False))) for leaf in leaves]
    total_us = sum(leaf[0] for leaf in leaves)
    by_op = _rows(leaves, lambda leaf: leaf[1], total_us)
    layer_leaves = [(leaf[0], layer or UNATTRIBUTED, bwd)
                    for leaf, layer, bwd in joined]
    return {
        "plane": plane,
        "total_ms": round(total_us / 1e3, 3),
        "by_category": _rows(leaves, lambda leaf: leaf[2], total_us),
        "by_op": by_op if top is None else by_op[:top],
        "by_layer": _rows(layer_leaves, lambda leaf: leaf[1], total_us,
                          backward=lambda leaf: leaf[2]),
    }


def format_tables(tables: dict) -> str:
    """The tables as text, one section each."""
    out = [f"plane: {tables['plane']}  "
           f"(busy {tables['total_ms']:.1f} ms total)"]
    for title, rows in (("by category (launching op)",
                         tables["by_category"]),
                        ("top ops", tables["by_op"]),
                        ("by layer (L[...] ranges)", tables["by_layer"])):
        out.append(f"\n-- {title} --")
        out.append(f"{'op':<40} {'ms':>9} {'count':>6} {'%':>6}")
        for r in rows:
            out.append(f"{r['op'][:40]:<40} {r['total_ms']:>9.2f} "
                       f"{r['count']:>6} {r['pct']:>6.1f}")
    return "\n".join(out)
