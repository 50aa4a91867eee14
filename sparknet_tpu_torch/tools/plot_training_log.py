"""plot_training_log — chart a training log (reference:
caffe/tools/extra/plot_training_log.py.example, all 8 chart types).

  0: Test accuracy  vs. Iters        1: Test accuracy  vs. Seconds
  2: Test loss      vs. Iters        3: Test loss      vs. Seconds
  4: Train learning rate vs. Iters   5: Train learning rate vs. Seconds
  6: Train loss     vs. Iters        7: Train loss     vs. Seconds

Seconds come from the glog timestamp prefix the Solver emits
(utils/glog.log_line; reference: tools/extra/extract_seconds.py), the
learning rate from the per-display-interval "Iteration N, lr = R" lines
(reference: sgd_solver.cpp:104-106).  A log missing those lines (e.g.
produced before they were emitted) raises a clear error for the chart
types that need them rather than plotting a wrong axis.

The port's own copy of ``sparknet_tpu/tools/plot_training_log.py``.  It
imports matplotlib inside ``plot`` only: a host tool, for a machine that
has matplotlib (the card's does not).

Usage:
  python -m sparknet_tpu_torch.tools.plot_training_log CHART_TYPE OUT.png \
      LOG [LOG ...]
"""

from __future__ import annotations

import argparse
import os

# chart type -> (title, y field, x field, train|test)
_CHARTS = {
    0: ("Test accuracy vs. Iters", "accuracy", "Iters", "test"),
    1: ("Test accuracy vs. Seconds", "accuracy", "Seconds", "test"),
    2: ("Test loss vs. Iters", "loss", "Iters", "test"),
    3: ("Test loss vs. Seconds", "loss", "Seconds", "test"),
    4: ("Train learning rate vs. Iters", "lr", "Iters", "train"),
    5: ("Train learning rate vs. Seconds", "lr", "Seconds", "train"),
    6: ("Train loss vs. Iters", "loss", "Iters", "train"),
    7: ("Train loss vs. Seconds", "loss", "Seconds", "train"),
}


def _series(path: str, field: str, xfield: str, which: str):
    """-> {label_suffix: (xs, ys)} — one series per test net, so
    multi-test-net logs don't interleave into a zigzag."""
    from .parse_log import parse_log
    train, test = parse_log(path)
    if which == "train":
        rows = [(r.seconds if xfield == "Seconds" else r.iter,
                 r.lr if field == "lr" else r.loss) for r in train]
        missing = [i for i, (x, y) in enumerate(rows)
                   if x is None or y is None]
        if rows and len(missing) == len(rows):
            what = ("glog timestamps" if xfield == "Seconds"
                    else "'Iteration N, lr =' lines")
            raise ValueError(
                f"{path}: no {what} found — this log predates the "
                f"Solver emitting them, so chart x/y field "
                f"{xfield}/{field} cannot be drawn")
        rows = [(x, y) for x, y in rows if x is not None and y is not None]
        return {"": ([x for x, _ in rows], [y for _, y in rows])}
    by_net: dict[int, tuple[list, list]] = {}
    for (it, net), row in sorted(test.items()):
        if field in row:
            x = row.get("Seconds") if xfield == "Seconds" else it
            if x is None:
                raise ValueError(
                    f"{path}: test pass at iter {it} has no glog "
                    f"timestamp; Seconds charts need timestamped logs")
            xs, ys = by_net.setdefault(net, ([], []))
            xs.append(x)
            ys.append(row[field])
    multi = len(by_net) > 1
    return {(f" (test net #{n})" if multi else ""): s
            for n, s in sorted(by_net.items())}


def plot(chart_type: int, out_path: str, logs: list[str]) -> None:
    if chart_type not in _CHARTS:
        raise ValueError(
            f"unknown chart type {chart_type} "
            f"(supported: {sorted(_CHARTS)})")
    title, field, xfield, which = _CHARTS[chart_type]

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for path in logs:
        series = _series(path, field, xfield, which)
        if not any(xs for xs, _ in series.values()):
            raise ValueError(f"{path}: no {which} '{field}' entries found")
        for suffix, (xs, ys) in series.items():
            ax.plot(xs, ys, marker=".", linewidth=1,
                    label=os.path.basename(path) + suffix)
    ax.set_xlabel(xfield)
    ax.set_ylabel(title.split(" vs.")[0])
    ax.set_title(title)
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("chart_type", type=int)
    ap.add_argument("out_path")
    ap.add_argument("logs", nargs="+")
    args = ap.parse_args(argv)
    plot(args.chart_type, args.out_path, args.logs)
    print(args.out_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
