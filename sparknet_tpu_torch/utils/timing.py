"""App-level phase logging.

The port's copy of ``PhaseLogger`` from ``sparknet_tpu/utils/timing.py``,
the ``training_log_<ts>.txt`` analog (reference: CifarApp.scala:41-50),
printing to standard output only.
"""

from __future__ import annotations

import time


class PhaseLogger:
    """Prints each phase line with the seconds since the logger was
    made."""

    def __init__(self):
        self.t0 = time.time()

    def log(self, msg: str) -> None:
        print(f"{time.time() - self.t0:10.3f}s  {msg}", flush=True)
