"""The port's roundbench (``sparknet_tpu_torch/tools/roundbench.py``)
against the root ``tools/roundbench.py``, on the CPU.

Parity holds: the asynchronous loop's round losses equal the
synchronous loop's, its params and its newest checkpoint's fields are
bit for bit (exact equality).  A planted asynchronous writer that drops
a checkpoint field fails the run.  The line's keys are the JAX tool's
line's plus ``not_ported_legs`` (the audit, ROADMAP A12), and it reads
through ``perfledger.entries_from_roundbench``."""

from __future__ import annotations

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from sparknet_tpu_torch.tools import roundbench
from sparknet_tpu_torch.utils import checkpoint
from sparknet_tpu_torch.utils import perfledger as pl
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(rounds=3, lag=2, devices=2, batch=4, device="cpu")


def _jax_line(capsys) -> dict:
    spec = importlib.util.spec_from_file_location(
        "jax_roundbench", ROOT / "tools" / "roundbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--rounds", "2", "--lag", "1", "--devices", "2",
                     "--batch", "4"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def line():
    return roundbench.run(**SMALL)


def test_parity_holds(line):
    assert line["ok"] and line["failures"] == []
    assert len(line["sync"]["losses"]) == 3
    assert all(np.isfinite(line["sync"]["losses"]))
    for mode in ("sync", "async"):
        assert line[mode]["stall_s"]["audit_fetch"] is None
        assert line[mode]["stall_s"]["checkpoint"] >= 0.0
    assert line["not_ported_legs"] == {"audit": "ROADMAP A12"}


def test_line_has_the_jax_lines_keys(line, capsys):
    jline = _jax_line(capsys)
    assert jline["ok"]
    assert set(line) == set(jline) | {"not_ported_legs"}
    for mode in ("sync", "async"):
        assert set(line[mode]) == set(jline[mode])
        assert set(jline[mode]["stall_s"]) <= set(line[mode]["stall_s"])


def test_line_reads_through_the_ledger_ingester(line):
    entries = pl.entries_from_roundbench(line, "roundbench.json")
    assert len(entries) == 1 and not entries[0].get("notes")
    assert pl.entries_from_roundbench({**line, "ok": False}, "x")[0][
        "notes"] == "parity FAILED"
    assert set(entries[0]["metrics"]) == {
        "roundbench_sync_wall_s", "roundbench_async_wall_s",
        "roundbench_stall_sync_s", "roundbench_stall_async_s"}


@pytest.mark.parametrize("field", ["torch_generators", "params"])
def test_an_async_writer_that_drops_a_field_fails(monkeypatch, field):
    snap = checkpoint.snapshot_tree

    def dropping(tree):
        return snap({k: v for k, v in tree.items() if k != field})

    monkeypatch.setattr(checkpoint, "snapshot_tree", dropping)
    bad = roundbench.run(**{**SMALL, "rounds": 2})
    assert not bad["ok"]
    assert any(repr(field) in f and "missing" in f for f in bad["failures"])


def test_diverging_losses_and_params_are_caught():
    a = {"losses": [1.0, 2.0], "params": {"w": [np.zeros(3)]},
         "newest_ckpt": "x.npz",
         "ckpt_blob": {k: [np.zeros(2)] for k in roundbench.CKPT_FIELDS}}
    b = {**a, "losses": [1.0, 2.5], "params": {"w": [np.ones(3)]}}
    fails = roundbench.parity_failures(a, b)
    assert any("losses diverge" in f for f in fails)
    assert any("param w[0]" in f for f in fails)
    c = {**a, "ckpt_blob": {**a["ckpt_blob"], "iter": [np.ones(2)]}}
    assert roundbench.parity_failures(a, c) == [
        "checkpoint field 'iter' not bit-identical"]
    assert "newest checkpoint differs" in roundbench.parity_failures(
        a, {**a, "newest_ckpt": "y.npz"})[0]


def test_cli_exit_code_and_line(capsys):
    assert roundbench.main(["--rounds", "2", "--devices", "2", "--batch",
                            "4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["ok"] and out["rounds"] == 2 and out["devices"] == 2
