"""The port's perf_probe (``sparknet_tpu_torch/tools/perf_probe.py``) on
the CPU at a tiny size.

The typed-skip contract (the port's copy of the JAX package's
``tests/test_tuner.py::test_perf_probe_time_block_typed_skip``): a
candidate that raises emits ``{"exp", "skipped": reason}`` and returns
None, and a total with a hole is null, never a sum.  The ``poolbwd``,
``lrn`` and ``hlo`` parts run at a tiny size, each variant held against
the plain version before any timing (pool dx bit for bit, LRN values
within rtol 1e-4 of the largest element in f32), and a planted wrong
kernel stops the part."""

from __future__ import annotations

import json

import pytest
import torch

from sparknet_tpu_torch.ops import vision
from sparknet_tpu_torch.tools import perf_probe
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    for k, v in {"PROBE_TARGET_S": "0.002", "PROBE_REPS": "1",
                 "PROBE_BATCH": "2", "PROBE_POOL_BATCH": "1",
                 "PROBE_DTYPE": "f32", "PROBE_LRN_BATCH": "1",
                 "PROBE_LRN_DTYPE": "f32", "PROBE_NET_ITERS": "1"}.items():
        monkeypatch.setenv(k, v)


def _records(capsys) -> list[dict]:
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines() if line]


def test_perf_probe_time_block_typed_skip(capsys):
    def bad_iter():
        raise ValueError("no backend for this op")

    got = perf_probe.time_block("probe_bad", bad_iter, extra={"tag": 1})
    assert got is None
    rec = next(r for r in _records(capsys) if r.get("exp") == "probe_bad")
    assert rec["skipped"].startswith("ValueError: no backend")
    assert rec["tag"] == 1


def test_time_block_counts_its_calls_and_flags_a_collapse(capsys):
    calls = []
    ms = perf_probe.time_block("probe_noop", lambda: calls.append(1),
                               device=CPU)
    rec = _records(capsys)[-1]
    assert ms is not None and rec["calls"] == len(calls)
    assert rec["timer"] == "host_clock" and rec["iters"] >= 1
    assert rec["collapsed"] is True        # a no-op reads implausibly fast
    perf_probe.time_block("probe_fixed", lambda: calls.append(1), 3,
                          device=CPU, images=8)
    rec = _records(capsys)[-1]
    assert rec["iters"] == 3 and rec["calls"] == 1 + 3
    assert rec["img_s"] > 0 and rec["ms_per_step"] == rec["ms_per_iter"]


def test_poolbwd_variants_equal_the_plain_version(capsys):
    total = perf_probe.run_poolbwd(CPU)
    recs = _records(capsys)
    names = {r["exp"] for r in recs}
    for name, *_ in perf_probe.GOOGLENET_POOLS:
        for label in perf_probe.POOL_VARIANTS:
            assert f"poolbwd_{name}_{label}" in names
    assert total["exp"] == "poolbwd_total_ms_per_step"
    assert total["incomplete"] is None
    assert all(total[k] > 0 for k in ("select_and_scatter", "pallas_vmem",
                                      "plain"))


def test_a_total_with_a_hole_is_null(monkeypatch, capsys):
    measured = perf_probe._time_block_measured

    def failing(name, *a, **kw):
        if name.endswith("_pallas") and "icp4" in name:
            raise RuntimeError("out of memory")
        return measured(name, *a, **kw)

    monkeypatch.setattr(perf_probe, "_time_block_measured", failing)
    total = perf_probe.run_poolbwd(CPU)
    assert total["pallas_vmem"] is None and total["incomplete"] == ["pallas"]
    assert total["select_and_scatter"] is not None
    skipped = [r for r in _records(capsys) if "skipped" in r]
    assert len(skipped) == 5 and skipped[0]["skipped"].startswith(
        "RuntimeError: out of memory")


def test_a_wrong_pool_kernel_stops_the_part(monkeypatch):
    from sparknet_tpu_torch.ops import cuda_kernels as ck

    def doubled(x, dy, *geom):
        return 2 * ck.max_pool_bwd_reference(x, dy, *geom)

    monkeypatch.setattr(vision, "max_pool_bwd", doubled)
    with pytest.raises(RuntimeError, match="pallas: dx differs"):
        perf_probe.run_poolbwd(CPU)


def test_lrn_variants_hold_to_the_plain_version(capsys):
    verdict = perf_probe.run_lrn(CPU)
    names = {r["exp"] for r in _records(capsys)}
    assert verdict["exp"] == "lrn_verdict" and verdict["dtype"] == "float32"
    assert set(verdict["per_shape"]) == set(perf_probe.lrn_shapes())
    for name in perf_probe.lrn_shapes():
        for label in perf_probe.LRN_VARIANTS:
            for tag in ("fwd", "fwdbwd"):
                assert f"lrn_{name}_{label}_{tag}" in names
        r = verdict["per_shape"][name]
        assert r["speedup_fwdbwd_vs_plain"] > 0
        assert r["speedup_fwdbwd_vs_library"] > 0


def test_lrn_shapes_follow_the_batch_knobs(monkeypatch):
    monkeypatch.delenv("PROBE_LRN_BATCH")
    monkeypatch.setenv("PROBE_LRN_BATCH_DIV", "4")
    assert set(perf_probe.lrn_shapes()) == {
        "googlenet_norm1_b32", "googlenet_norm2_b32",
        "caffenet_norm1_b64", "caffenet_norm2_b64"}
    monkeypatch.setenv("PROBE_LRN_SHAPES", "norm2")
    assert len(perf_probe.lrn_shapes()) == 2


def test_a_wrong_lrn_kernel_stops_the_part(monkeypatch):
    monkeypatch.setattr(vision, "lrn_across_channels",
                        lambda x, *a, **kw: x.clone())   # identity
    monkeypatch.setenv("PROBE_LRN_SHAPES", "googlenet_norm1")
    with pytest.raises(RuntimeError, match="cuda y"):
        perf_probe.run_lrn(CPU)


def test_the_layout_census_of_a_caffenet_step(capsys):
    rec = perf_probe.run_hlo(CPU)
    assert set(rec) >= {"exp", "op_counts", "layout_bytes_mb", "n_lines"}
    assert rec["exp"] == "hlo_census" and rec["plane"] == "/host:CPU"
    assert rec["n_lines"] > 100 and rec["layout_ops"]
    assert rec["layout_bytes_mb"] and rec["op_counts"]
    assert _records(capsys)[-1] == rec


def test_cli_parts_and_device_line(capsys):
    assert perf_probe.main(["hlo", "--device", "cpu"]) == 0
    recs = _records(capsys)
    assert recs[0] == {"exp": "device", "device": "cpu/cpu", "batch": 2}
    assert recs[-1]["exp"] == "hlo_census"
    with pytest.raises(SystemExit):
        perf_probe.main(["nope", "--device", "cpu"])
