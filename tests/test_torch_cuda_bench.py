"""The bench on the card: ``python -m sparknet_tpu_torch.bench`` at a short
configuration prints one JSON line naming the card, each dtype's ``mfu``
in (0, 1].  Marked ``cuda``: it skips where ``torch.cuda.is_available()``
is false.  It imports no JAX, so it runs on the card's machine with
``--noconftest``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.cuda

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_on_the_card_reports_mfu_in_range():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bench measures the card")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "SPARKNET_"))}
    env.update(BENCH_BATCH="64", BENCH_ITERS="2", BENCH_REPS="1",
               BENCH_WINDOWS="1", BENCH_FEED="0", BENCH_ROUND="0",
               BENCH_SERVING="0")
    p = subprocess.run([sys.executable, "-m", "sparknet_tpu_torch.bench"],
                       cwd=_ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"] == "cuda/" + torch.cuda.get_device_name(0)
    for run in line["by_dtype"].values():
        assert 0 < run["mfu"] <= 1
