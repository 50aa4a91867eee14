"""parse_log — split a training log into train/test CSVs (reference:
caffe/tools/extra/parse_log.py, which greps glog output for
"Iteration N, loss" / "Iteration N, lr" and "Test net output" lines and
mines the glog timestamp prefix for a Seconds column via
tools/extra/extract_seconds.py; this framework's Solver prints the same
shapes — solver.py step/solve/_print_test_scores through
utils/glog.log_line).

The port's own copy of ``sparknet_tpu/tools/parse_log.py``: the same
CSVs from the port's glog lines (``utils/glog.py::log_line``).  Host
work.

Usage:
  python -m sparknet_tpu_torch.tools.parse_log LOGFILE [OUT_DIR]

Writes LOGFILE.train (NumIters,Seconds,LearningRate,loss) and
LOGFILE.test (NumIters,Seconds,TestNet,<output columns>) into OUT_DIR
(default: the log's directory), mirroring the reference's
<log>.train/<log>.test CSVs.  Logs without glog prefixes (or without lr
lines) still parse — the Seconds/LearningRate cells are left empty, and
the plot tool refuses the chart types that would need them.
"""

from __future__ import annotations

import argparse
import calendar
import csv
import datetime
import os
import re

_FLOAT = r"([-+]?(?:[0-9][0-9.]*(?:[eE][-+]?\d+)?|nan|inf))"
_ITER_RE = re.compile(r"Iteration (\d+), loss = " + _FLOAT)
_LR_RE = re.compile(r"Iteration (\d+), lr = " + _FLOAT)
_TESTING_RE = re.compile(r"Iteration (\d+), Testing net \(#(\d+)\)")
_TEST_RE = re.compile(
    r"Test net(?: #(\d+))? output: (\S+?)(?:\[(\d+)\])? = " + _FLOAT)
# glog prefix: I<mmdd> <HH:MM:SS.ffffff> <pid> <source>]  (the reference's
# extract_seconds.py format; utils/glog.log_line emits the same shape)
_GLOG_RE = re.compile(
    r"^[IWEF](\d{2})(\d{2}) (\d{2}):(\d{2}):(\d{2})\.(\d+)\b")


def _log_year(path: str) -> int:
    """The year the glog prefix omits, recovered from the log file's
    mtime (the reference extract_seconds.py uses ctime the same way —
    the log was last written in the year it logged, modulo a New Year
    boundary handled by the wrap logic in parse_log).  If the log
    carries a Feb 29 stamp but the mtime year is not leap (the file was
    copied or touched later), walk back to the nearest leap year — the
    log cannot postdate its mtime, and ONE year must govern the whole
    log or neighboring lines would land a year apart."""
    try:
        year = datetime.datetime.fromtimestamp(
            os.path.getmtime(path)).year
    except OSError:
        year = datetime.date.today().year
    if not calendar.isleap(year):
        try:
            with open(path) as f:
                has_feb29 = any(line[1:5] == "0229"
                                and _GLOG_RE.match(line) for line in f)
        except OSError:
            has_feb29 = False
        if has_feb29:
            while not calendar.isleap(year):
                year -= 1
    return year


def _glog_datetime(line: str, year: int) -> datetime.datetime | None:
    """Full datetime of a glog-prefixed line in ``year``.  Computing
    deltas from real datetimes (not a fixed-leap-year day-of-year
    table) keeps Feb 28 → Mar 1 spans exact: the old 2024-anchored
    scheme charged every non-leap-year log a phantom Feb 29 (+86400 s).
    A Feb 29 stamp with a non-leap ``year`` walks back to the nearest
    leap year — the log predates its mtime, it can't postdate it."""
    m = _GLOG_RE.match(line)
    if not m:
        return None
    mo, d, h, mi, s, frac = m.groups()
    us = round(int(frac) / 10 ** len(frac) * 1e6)
    for y in range(year, year - 8, -1):
        try:
            return datetime.datetime(y, int(mo), int(d), int(h),
                                     int(mi), int(s), us)
        except ValueError:
            if (int(mo), int(d)) != (2, 29):
                return None  # regex-shaped but not a date — unprefixed
    return None


def _glog_seconds(line: str, year: int | None = None) -> float | None:
    """Seconds since ``year``'s Jan 1 of a glog-prefixed line (year
    defaults to the current one — prefer passing _log_year(path))."""
    if year is None:
        year = datetime.date.today().year
    dt = _glog_datetime(line, year)
    if dt is None:
        return None
    return (dt - datetime.datetime(dt.year, 1, 1)).total_seconds()


def parse_log(path: str):
    """-> (train_rows, test_rows): train [(iter, loss, seconds|None,
    lr|None)], test {(iter, net_id): {column: value, "Seconds": s}} in
    encounter order.  For back-compat, train rows unpack as
    ``for it, loss in train`` too (see _TrainRow)."""
    train: list[_TrainRow] = []
    test: dict[tuple[int, int], dict[str, float]] = {}
    cur_iter = 0
    cur_test_net = 0
    year = _log_year(path)
    first_dt: datetime.datetime | None = None
    cur_lr: float | None = None
    lr_by_iter: dict[int, float] = {}
    with open(path) as f:
        for line in f:
            ts: float | None = None
            dt = _glog_datetime(line, year)
            if dt is not None:
                if first_dt is None:
                    first_dt = dt
                if dt < first_dt:  # new-year wrap within one log
                    try:
                        dt = dt.replace(year=dt.year + 1)
                    except ValueError:  # Feb 29 wrapped into a non-leap
                        dt = (dt.replace(year=dt.year + 1, day=28)
                              + datetime.timedelta(days=1))
                ts = (dt - first_dt).total_seconds()
            m = _LR_RE.search(line)
            if m:
                cur_lr = float(m.group(2))
                lr_by_iter[int(m.group(1))] = cur_lr
                continue
            m = _ITER_RE.search(line)
            if m:
                cur_iter = int(m.group(1))
                # lr in effect NOW (last lr line seen so far); a
                # same-iteration lr line printed just after this loss
                # line overrides it below
                train.append(_TrainRow(cur_iter, float(m.group(2)), ts,
                                       cur_lr))
                continue
            m = _TESTING_RE.search(line)
            if m:  # the authoritative iteration for following scores —
                #    covers the pre-training pass on resume, where no
                #    "Iteration N, loss" line has printed yet
                cur_iter = int(m.group(1))
                cur_test_net = int(m.group(2))
                if ts is not None:
                    test.setdefault((cur_iter, cur_test_net), {})[
                        "Seconds"] = ts
                continue
            m = _TEST_RE.search(line)
            if m:
                net_id = int(m.group(1) or cur_test_net)
                col = m.group(2)
                if m.group(3) is not None:  # indexed per-class outputs
                    col = f"{col}[{m.group(3)}]"
                test.setdefault((cur_iter, net_id), {})[col] = \
                    float(m.group(4))
    # the lr line prints at the same display boundary as (just after)
    # the loss line; prefer the exact same-iteration lr over the
    # scan-time "last seen" value each row was stamped with, so the
    # display-pair rows get their own boundary's rate and the
    # solve()-chunk-boundary rows keep the rate in effect at that point
    for row in train:
        row.lr = lr_by_iter.get(row.iter, row.lr)
    return train, test


class _TrainRow:
    """(iter, loss) tuple-compatible row carrying seconds + lr."""

    __slots__ = ("iter", "loss", "seconds", "lr")

    def __init__(self, it: int, loss: float, seconds: float | None,
                 lr: float | None = None):
        self.iter, self.loss, self.seconds, self.lr = it, loss, seconds, lr

    def __iter__(self):  # back-compat: `for it, loss in train`
        return iter((self.iter, self.loss))

    def __getitem__(self, i):
        return (self.iter, self.loss)[i]

    def __eq__(self, other):
        try:
            return tuple(self) == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(tuple(self))

    def __repr__(self):
        return (f"_TrainRow({self.iter}, {self.loss}, "
                f"seconds={self.seconds}, lr={self.lr})")


def write_csvs(path: str, out_dir: str | None = None) -> tuple[str, str]:
    train, test = parse_log(path)
    out_dir = out_dir or (os.path.dirname(os.path.abspath(path)))
    base = os.path.join(out_dir, os.path.basename(path))
    train_path, test_path = base + ".train", base + ".test"
    fmt = lambda v: "" if v is None else v
    with open(train_path, "w", newline="") as f:
        w = csv.writer(f)
        # the reference's column set (parse_log.py train_dict_names)
        w.writerow(["NumIters", "Seconds", "LearningRate", "loss"])
        for row in train:
            w.writerow([row.iter, fmt(row.seconds), fmt(row.lr), row.loss])
    cols: list[str] = []
    for row in test.values():
        for k in row:
            if k not in cols and k != "Seconds":
                cols.append(k)
    with open(test_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["NumIters", "Seconds", "TestNet"] + cols)
        for (it, net_id), row in test.items():
            w.writerow([it, fmt(row.get("Seconds")), net_id]
                       + [row.get(c, "") for c in cols])
    return train_path, test_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("logfile")
    ap.add_argument("out_dir", nargs="?", default=None)
    args = ap.parse_args(argv)
    train_path, test_path = write_csvs(args.logfile, args.out_dir)
    print(train_path)
    print(test_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
