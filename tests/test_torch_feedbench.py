"""The port's feedbench (``sparknet_tpu_torch/tools/feedbench.py``)
against the root ``tools/feedbench.py``, on the CPU.

On one LMDB, written by the JAX tool's ``build_db``, the port's serial
and parallel ``db_feed`` streams are bit for bit the JAX tool's serial
stream (exact array equality), with the same quarantine accounting under
``corrupt_record`` injection; the records triangle passes (local shards,
the verifying store through a tiered cache cold and warm), and a corrupt
byte planted in a record block is quarantined and attributed to its
shard."""

from __future__ import annotations

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from sparknet_tpu_torch.tools import feedbench
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, BATCH, BATCHES = 96, 16, 9        # past one epoch: the cursor wraps


def _jax_feedbench():
    spec = importlib.util.spec_from_file_location(
        "jax_feedbench", ROOT / "tools" / "feedbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jfeedbench = _jax_feedbench()


@pytest.fixture(scope="module")
def lmdb(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("feedbench") / "lmdb")
    jfeedbench.build_db(path, N, seed=3)
    return path


def _fault(monkeypatch, corrupt: bool) -> None:
    if corrupt:
        monkeypatch.setenv("SPARKNET_FAULT", "corrupt_record:0.1")
        monkeypatch.setenv("SPARKNET_FAULT_ATTEMPT", "0")
    else:
        monkeypatch.delenv("SPARKNET_FAULT", raising=False)


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("workers", [feedbench.SERIAL_WORKERS, 3])
def test_streams_equal_the_jax_tools(lmdb, monkeypatch, corrupt, workers):
    _fault(monkeypatch, corrupt)
    want = jfeedbench.run_leg(lmdb, BATCH, 0, BATCHES, 0.0, 0, records=N)
    got = feedbench.run_leg(lmdb, BATCH, workers, BATCHES, 0.0, 0,
                            records=N, device="cpu")
    assert len(got["batches"]) == BATCHES
    for a, b in zip(want["batches"], got["batches"]):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert feedbench.compare(want, got) == []
    qa, qb = want["quarantine"], got["quarantine"]
    assert (qa["total_bad"], qa["by_source"]) == (qb["total_bad"],
                                                  qb["by_source"])
    assert (qb["total_bad"] > 0) == corrupt


def test_the_port_tools_serial_and_parallel_legs_agree(lmdb):
    verdict = feedbench.run(lmdb, seconds=0.2, batch=BATCH, records=N,
                            workers=3, device="cpu")
    assert verdict["ok"], verdict["errors"]
    assert verdict["batches"] > 0 and verdict["workers"] == 3
    assert verdict["metric"] == "feed_parity" and "records_leg" not in verdict


@pytest.mark.parametrize("corrupt", [False, True])
def test_the_records_triangle(lmdb, monkeypatch, corrupt):
    _fault(monkeypatch, corrupt)
    verdict = feedbench.run(lmdb, seconds=0.2, batch=BATCH, records=N,
                            workers=2, corrupt=corrupt, records_leg=True,
                            device="cpu")
    assert verdict["ok"], verdict["errors"]
    assert verdict["records_leg"] and verdict["shards"] >= 3
    assert verdict["cache_cold"]["cache_misses"] >= 1
    assert verdict["cache_warm"]["cache_disk_hits"] >= 1
    assert (verdict["quarantined"] > 0) == corrupt


def test_the_planted_block_is_attributed_to_its_shard(lmdb, tmp_path):
    shards = tmp_path / "shards"
    stride = 3 * 16 * 16 + 8
    conv = feedbench.convert_db_to_shards(lmdb, str(shards),
                                          N * stride // 4, device="cpu")
    assert len(conv["shards"]) >= 3
    assert feedbench.check_planted_corruption(str(shards), str(tmp_path),
                                              BATCH, N, 0) == []


def test_a_stream_that_differs_is_caught(lmdb):
    a = feedbench.run_leg(lmdb, BATCH, 1, 2, 0.0, 0, records=N,
                          device="cpu")
    b = feedbench.run_leg(lmdb, BATCH, 2, 2, 0.0, 0, records=N,
                          device="cpu")
    assert feedbench.compare(a, b) == []
    b["batches"][1]["data"][3, 0, 0, 0] += 0.5     # one pixel off
    errs = feedbench.compare(a, b)
    assert errs and "differs" in errs[0]
    assert "batch count mismatch" in feedbench.compare(
        a, {**b, "batches": b["batches"][:1]})[0]


def test_cli_prints_the_jax_tools_keys(capsys, monkeypatch):
    monkeypatch.delenv("SPARKNET_FAULT", raising=False)
    assert feedbench.main(["--device", "cpu", "--seconds", "0.2",
                           "--records", "64", "--records-leg"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {
        "metric", "ok", "errors", "batches", "batch", "workers", "corrupt",
        "serial_img_s", "parallel_img_s", "speedup", "quarantined",
        "records_leg", "shards", "records_img_s", "records_store_img_s",
        "records_warm_img_s", "records_speedup", "records_read_s",
        "cache_cold", "cache_warm"}
    assert line["ok"]
