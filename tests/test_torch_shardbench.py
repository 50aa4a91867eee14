"""The port's ``tools/shardbench.py`` on the CPU, against the JAX tool's
report.

All six verdicts hold on lenet, 4 positions, τ=2, 3 rounds: the three
strategies' sharded rounds bit for bit their replicated ones, int8 under
the plan, the per-shard checkpoint round trip, the elastic re-tile onto 2
positions, the audit blaming exactly ``[2]`` and passing after its
rollback, and the boundary-byte shrink (3.289x on lenet, 6.304x on
CaffeNet's shapes at 8 shards).  Its line has the JAX report's keys
(``BENCH_shard_r20.json``) and ``device``, the same plan ids and bytes,
and ``perfledger.entries_from_shardbench`` reads it as the JAX reader
does but for the device the port puts in the fingerprint.
"""

from __future__ import annotations

import json
import os

import pytest

from sparknet_tpu.utils import perfledger as j_ledger
from sparknet_tpu_torch.tools import shardbench
from sparknet_tpu_torch.utils import perfledger as p_ledger
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    out = tmp_path_factory.mktemp("sb") / "shardbench.json"
    assert shardbench.main(["--device", "cpu", "--out", str(out)]) == 0
    with open(out) as f:
        return json.load(f)


def _jax_doc() -> dict:
    with open(os.path.join(ROOT, "BENCH_shard_r20.json")) as f:
        return json.load(f)


def test_all_six_verdicts_hold(line):
    assert line["ok"] and line["failures"] == []
    assert line["parity"] == {"local_sgd": True, "sync": True,
                              "hierarchical": True}
    assert line["codec_int8_parity"] and line["ckpt_roundtrip_ok"]
    assert line["elastic_ok"] and line["audit_ok"]
    assert line["shard_bytes_shrink_x"] == 3.289
    assert line["caffenet"]["shrink_x"] == 6.304
    assert line["device"] == "cpu/cpu"


def test_the_line_is_the_jax_reports(line):
    doc = _jax_doc()
    assert set(line) == set(doc) | {"device"}
    for k in ("plan", "plan_dims", "rounds", "tau", "batch", "devices"):
        assert line[k] == doc[k], k
    for leg in ("dp", "sharded"):
        for k in ("boundary_bytes_per_chip", "exchange_bytes"):
            assert line[leg][k] == doc[leg][k], (leg, k)
    assert line["caffenet"] == doc["caffenet"]


def test_the_ledger_reads_it_as_the_jax_reader(line):
    ours = p_ledger.entries_from_any(line, "shardbench.json")
    theirs = j_ledger.entries_from_any(
        {k: v for k, v in line.items() if k != "device"},
        "shardbench.json", device_hint="cpu/cpu")
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a["metrics"] == b["metrics"]
        assert {k: v for k, v in a["fp"].items() if k != "backend"} == \
            {k: v for k, v in b["fp"].items() if k != "backend"}
    assert ours[1]["fp"]["sharding"] == line["plan"]
    assert p_ledger.entries_from_any(dict(line, ok=False))[0]["notes"] == \
        "shardbench gate FAILED"
