"""App-level phase logging.

The port's copy of ``PhaseLogger`` from ``sparknet_tpu/utils/timing.py``,
the ``training_log_<ts>.txt`` analog (reference: CifarApp.scala:41-50).
"""

from __future__ import annotations

import time


class PhaseLogger:
    """Prints each phase line with the seconds since the logger was made,
    and appends it to ``path`` when one is given."""

    def __init__(self, path: str | None = None):
        self.t0 = time.time()
        self.path = path

    def log(self, msg: str) -> None:
        line = f"{time.time() - self.t0:10.3f}s  {msg}"
        print(line, flush=True)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(line + "\n")
