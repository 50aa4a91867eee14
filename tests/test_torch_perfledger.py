"""The port's performance ledger against the JAX package's, on the CPU.

Every ingester the port keeps gives the JAX function's entries, exactly,
on the same document and timestamp: the JAX bench capture
(``BENCH_r05.json``, driver wrapper and bare line), a bench line of the
port's shape (device ``cuda/<card>``, so ``fp.backend`` is ``"cuda"``,
its round tier with the audit's stall and its sharded round's dp and
plan legs), the serving capture (``BENCH_serving_r07.json``), a round
parity report, the op table (``profiles/caffenet_cpu/op_table.json``) and
a folded metrics rollup.  ``fingerprint``, ``fp_key``,
``higher_is_better``, ``compute_baseline`` and ``verdict`` agree on the
same inputs, and a ledger file the port writes reads back the same in
both packages.
"""

from __future__ import annotations

import json
import os

import pytest

from sparknet_tpu.utils import perfledger as jpl
from sparknet_tpu_torch.utils import perfledger as pl
from sparknet_tpu_torch.utils import telemetry as tel

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_T = 1_700_000_000.0
_CARD = "cuda/NVIDIA H100 80GB HBM3"


def _load(name):
    with open(os.path.join(_ROOT, name)) as f:
        return json.load(f)


def _port_line() -> dict:
    """A bench line of the port's shape, numbers from the JAX capture."""
    doc = dict(_load("BENCH_r05.json")["parsed"])
    doc["device"] = _CARD
    doc["feed_in_loop"] = dict(doc["feed_in_loop"], read_s=0.0,
                               decode_s=0.0, transform_s=0.0,
                               device_put_s=0.01, staged_dtype="uint8")
    stalls = {"loss_fetch": 0.01, "finite_check": 0.002,
              "audit_fetch": 0.004, "checkpoint": 0.3}
    doc["round_overhead"] = {
        "batch": 256, "tau": 4, "workers": 1, "dtype": "f32",
        "bare": {"round_s": 0.2}, "sync": {
            "round_s": 0.9, "stall_total_s_per_round": 0.7},
        "async": {"round_s": 0.3, "stall_total_s_per_round": 0.1,
                  "stall_s_per_round": stalls},
        }
    serving = _load("BENCH_serving_r07.json")
    doc["serving"] = dict(serving, device=_CARD, overload=None, sweep=None)
    doc["feed_records"] = {
        "feed_source": "records", "records": 96, "edge": 64, "batch": 32,
        "epochs": 3, "images_per_sec": 5000.0, "serial_img_s": 400.0,
        "speedup_x": 12.5, "convert_s": 0.4, "read_s": 0.001,
        "serial_decode_s": 0.07, "cache": {"ram_hits": 90, "misses": 1}}
    doc["shard_round"] = {
        "batch": 256, "tau": 2, "rounds": 1, "workers": 4, "dtype": "f32",
        "plan": "shard:f20c289b1d11",
        "dp": {"img_s": 4236.2, "round_s": 0.1209,
               "boundary_bytes_per_chip": 243860896},
        "sharded": {"img_s": 4270.4, "round_s": 0.1199,
                    "boundary_bytes_per_chip": 67995040},
        "bytes_shrink_x": 3.59, "parity_ok": True}
    return doc


@pytest.mark.parametrize("which", ["wrapper", "bare", "port"])
def test_entries_from_bench_equal_the_jax_entries(which):
    doc = {"wrapper": lambda: _load("BENCH_r05.json"),
           "bare": lambda: _load("BENCH_r05.json")["parsed"],
           "port": _port_line}[which]()
    ours = pl.entries_from_bench(doc, "x.json", round_tag="r05", t=_T)
    theirs = [e for e in jpl.entries_from_bench(doc, "x.json",
                                                round_tag="r05", t=_T)
              if e["metrics"]]
    assert ours == theirs
    assert len(ours) >= 3
    if which == "port":
        assert {e["fp"]["backend"] for e in ours} == {"cuda"}
        assert {e["fp"]["device"] for e in ours} == {_CARD}
        assert {e["source"] for e in ours} == {
            "bench", "bench_feed", "bench_round", "bench_shard", "serving"}


def test_other_ingesters_equal_the_jax_entries(tmp_path, monkeypatch):
    serving = _load("BENCH_serving_r07.json")
    assert (pl.entries_from_serving(serving, "s.json", t=_T)
            == jpl.entries_from_serving(serving, "s.json", t=_T))
    table = _load(os.path.join("profiles", "caffenet_cpu", "op_table.json"))
    assert (pl.entries_from_op_table(table, "o.json", t=_T)
            == jpl.entries_from_op_table(table, "o.json", t=_T))
    rb = {"model": "lenet", "batch": 16, "devices": 4, "device": _CARD,
          "ok": True, "sync": {"wall_s": 2.0}, "async": {"wall_s": 1.5},
          "stall_total_sync_s": 0.8, "stall_total_async_s": 0.2}
    assert (pl.entries_from_roundbench(rb, "r.json", t=_T)
            == jpl.entries_from_roundbench(rb, "r.json", t=_T))
    monkeypatch.setenv("SPARKNET_TELEMETRY", "1")
    monkeypatch.setenv("SPARKNET_RUN_ID", "ledger")
    tel.reset()
    reg = tel.get_registry()
    reg.gauge("trainer_stall_seconds").set(0.4, comp="checkpoint")
    reg.histogram("feed_stage_seconds").observe(0.01, stage="decode")
    reg.histogram("ckpt_write_seconds").observe(2.0)
    path = reg.write_snapshot(str(tmp_path))
    tel.reset()
    folded = tel.fold_snapshots([path])
    ours = pl.entries_from_metrics_rollup(folded, "m.json", t=_T)
    assert ours == jpl.entries_from_metrics_rollup(folded, "m.json", t=_T)
    assert ours[0]["metrics"]["ckpt_write_mean_s"] == 2.0
    for doc in (serving, table, rb, folded, _port_line()):
        assert [e for e in jpl.entries_from_any(doc, "r_r07.json", t=_T)
                if e["metrics"]] == pl.entries_from_any(doc, "r_r07.json",
                                                        t=_T)


def test_baselines_verdicts_and_keys_agree():
    histories = [[], [1.0, 1.1], [10.0, 10.5, 9.8, 10.2, 30.0],
                 [5.0] * 9, [0.2, 0.25, 0.22, 0.21]]
    metrics = ["train_img_s", "block_s", "mfu", "overlap_pct",
               "cat_ms/convolution", "serve_overload_rejected", "mystery"]
    for m in metrics:
        assert pl.higher_is_better(m) == jpl.higher_is_better(m)
        for hist in histories:
            for kw in ({}, {"min_band_frac": 0.05, "window": 3}):
                ours = pl.compute_baseline(m, "k", hist, **kw)
                theirs = jpl.compute_baseline(m, "k", hist, **kw)
                assert ours.__dict__ == theirs.__dict__
                for v in (0.0, 5.0, 10.1, 100.0):
                    assert pl.verdict(m, v, ours) == jpl.verdict(m, v,
                                                                 theirs)
    fp = dict(model="caffenet", dtype="bf16", batch=256, world=1,
              device=_CARD, tau=4)
    assert pl.fingerprint(**fp) == jpl.fingerprint(**fp)
    assert pl.fingerprint(**fp)["backend"] == "cuda"
    assert pl.fp_key(pl.fingerprint(**fp)) == jpl.fp_key(
        jpl.fingerprint(**fp))


def test_the_port_ledger_is_only_where_the_caller_says(tmp_path):
    with pytest.raises(TypeError):
        pl.PerfLedger()
    path = str(tmp_path / "ledger.jsonl")
    led = pl.PerfLedger(path)
    entries = pl.entries_from_bench(_port_line(), "b.json", t=_T)
    assert led.extend(entries) == len(entries)
    fpk = pl.fp_key(entries[0]["fp"])
    assert led.history("train_img_s", fpk) == [
        entries[0]["metrics"]["train_img_s"]]
    assert not led.baseline("train_img_s", fpk).gated
    assert jpl.PerfLedger(path).entries() == pl.PerfLedger(path).entries()
    assert os.listdir(tmp_path) == ["ledger.jsonl"]
