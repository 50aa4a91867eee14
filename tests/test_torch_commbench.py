"""The port's ``tools/commbench.py`` against the root ``tools/commbench.py``
(the JAX tool), on the CPU.

Both tools run once at ``--rounds 4 --devices 4 --batch 16 --tau 2`` (the
JAX tool as its own module, on the rig's virtual CPU devices; the port's
with ``--device cpu``).  Both exit 0 with no failure, their
error-feedback verdicts are the same dict (the planted ``int8_dropres``
caught by both), and the exchanged bytes (full precision, each codec)
and int8's shrink are exactly equal.  The port's stall comparison is
reported, not gated, on the CPU (``stall_gated``: the two settings run
the same host code there), and its stall under overlap is above 0 (F4).
Its report is read back by both packages' ledgers to the same entries.
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

from sparknet_tpu.utils import perfledger as j_ledger
from sparknet_tpu_torch.tools import commbench as p_commbench
from sparknet_tpu_torch.utils import perfledger as p_ledger
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--rounds", "4", "--devices", "4", "--batch", "16", "--tau", "2"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "root_commbench", os.path.join(ROOT, "tools", "commbench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    d = tmp_path_factory.mktemp("commbench")
    out = {}
    for name, main, extra in (("jax", _jax_tool().main, []),
                              ("port", p_commbench.main,
                               ["--device", "cpu"])):
        path = str(d / f"{name}.json")
        rc = main(ARGS + extra + ["--out", path])
        with open(path) as f:
            out[name] = (rc, json.load(f))
    return out


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_every_gate_holds(reports, pkg):
    rc, doc = reports[pkg]
    assert rc == 0 and doc["ok"] and doc["failures"] == [], doc["failures"]
    assert doc["commbench"] is True


def test_error_feedback_verdicts_equal_and_the_dropper_is_caught(reports):
    ef = {k: doc["ef_invariant"] for k, (_, doc) in reports.items()}
    assert ef["jax"] == ef["port"]
    assert ef["port"]["int8_dropres"] is False
    assert all(ef["port"][c] for c in ("bf16", "int8", "int8_channel"))


def test_exchange_bytes_and_shrink_are_exactly_the_jax_tools(reports):
    j, p = reports["jax"][1], reports["port"][1]
    assert p["exchange_bytes_none"] == j["exchange_bytes_none"]
    assert set(p["codecs"]) == set(j["codecs"])
    for codec in j["codecs"]:
        assert p["codecs"][codec]["exchange_bytes"] == \
            j["codecs"][codec]["exchange_bytes"], codec
    assert p["comm_bytes_shrink_x"] == j["comm_bytes_shrink_x"] >= 3.0


def test_port_stall_under_overlap_is_charged_and_reported(reports):
    doc = reports["port"][1]
    assert doc["stall_gated"] is False and doc["device"] == "cpu/cpu"
    assert doc["comm_stall_overlap_s"] > 0 and doc["comm_stall_sync_s"] > 0
    stall = doc["overlap_int8"]["stall_s"]
    assert stall["comm_encode"] > 0 and stall["comm_decode"] > 0


def test_both_ledgers_read_the_ports_report_alike(reports):
    doc = reports["port"][1]
    got = [p_ledger.entries_from_any(doc, "BENCH_comm_r21.json"),
           j_ledger.entries_from_any(doc, "BENCH_comm_r21.json")]
    assert len(got[0]) == len(got[1]) == 4
    for pe, je in zip(*got):
        assert pe["metrics"] == je["metrics"]
        assert pe["fp"]["comm_codec"] == je["fp"]["comm_codec"]
