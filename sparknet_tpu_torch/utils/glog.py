"""glog-style training-log lines.

The port's own copy of ``sparknet_tpu/utils/glog.py``.  The reference
logs through glog (``I0416 13:23:03.089758 21823 solver.cpp:218]
Iteration 80, loss = ...``) and its log tooling mines the prefix for a
wall-clock axis (reference: caffe/tools/extra/extract_seconds.py).  The
Solver's "Iteration N, loss = ..." and "Test net output" lines go through
``log_line``, so ``tools/parse_log.py`` reads them.  Lines keep the
reference's field order (level and date, time, pid, source]).
"""

from __future__ import annotations

import datetime
import os
import sys

_PID = os.getpid()


def log_line(msg: str, *, file=None, now: datetime.datetime | None = None,
             tag: str = "solver.py") -> None:
    """Print ``msg`` with a glog 'I' (INFO) prefix, the severity the
    reference trains at (sgd_solver.cpp logs rate and loss via LOG(INFO))."""
    now = now or datetime.datetime.now()
    print(f"{now:I%m%d %H:%M:%S.%f} {_PID} {tag}] {msg}",
          file=file or sys.stdout)
