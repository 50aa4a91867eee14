"""The port's perfwatch (``sparknet_tpu_torch/tools/perfwatch.py``)
against the root ``tools/perfwatch.py``, on the CPU.

Held equal to the JAX tool on the same documents and ledgers: the
regress sentinel's verdicts, bands and stage attribution (a slowed feed
leg attributed to the decode stage; a capture of another device never
gated), the op-profile differ's categories and layers, and the
trajectory rows and their markdown.  The port's own rules: its ledger
has no default path (``--ledger`` is required), ``ingest --backfill``
walks only the port's own captures and a JAX-package or TPU capture is
refused by name, ``trajectory`` writes only the file it is given, and
the differ's worklist is the port's ``graph/fusion.py``'s.
"""

from __future__ import annotations

import importlib.util
import json
import os
from unittest import mock

import pytest

from sparknet_tpu.utils import perfledger as jpl
from sparknet_tpu_torch.graph import fusion
from sparknet_tpu_torch.tools import perfwatch
from sparknet_tpu_torch.utils import perfledger as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_perfwatch():
    spec = importlib.util.spec_from_file_location(
        "jax_perfwatch", os.path.join(REPO, "tools", "perfwatch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jperfwatch = _jax_perfwatch()


def _bench_doc(img_s=800.0, decode_s=0.001, device="cuda/NVIDIA H100"):
    return {
        "metric": "lenet_train_images_per_sec", "value": 120.0,
        "dtype": "f32", "batch": 8, "device": device,
        "by_dtype": {"f32": {"images_per_sec": 120.0,
                             "eval_images_per_sec": 3000.0,
                             "block_20x256_s": 1.2, "mfu": 0.01}},
        "feed_in_loop": {"batch": 8, "images_per_sec": img_s,
                         "step_s": 0.01 if img_s == 800.0 else 0.04,
                         "staged_dtype": "uint8", "decode_s": decode_s,
                         "transform_s": 0.0, "device_put_s": 0.002},
        "provenance": {"git_sha": "abc1234", "run": "run-x", "rank": 0},
    }


def _seeded(tmp_path, mod_pl, name):
    led = mod_pl.PerfLedger(str(tmp_path / name))
    for i in range(3):
        for e in mod_pl.entries_from_bench(_bench_doc(), "seed",
                                           t=float(i)):
            led.append(e)
    return led


@pytest.mark.parametrize("case", ["within", "slowed", "other_device"])
def test_regress_equals_the_jax_tools(tmp_path, case):
    doc = {"within": _bench_doc(),
           "slowed": _bench_doc(img_s=200.0, decode_s=0.031),
           "other_device": _bench_doc(img_s=10.0, device="cpu/cpu")}[case]
    got = perfwatch.run_regress(doc, _seeded(tmp_path, pl, "p.jsonl"),
                                min_band_frac=0.10)
    want = jperfwatch.run_regress(doc, _seeded(tmp_path, jpl, "j.jsonl"),
                                  min_band_frac=0.10)
    assert got == want
    if case == "slowed":
        tripped = {r["metric"]: r for r in got["results"]
                   if r["verdict"] == "regression"}
        assert tripped["feed_img_s"]["attribution"]["metric"] == \
            "feed_decode_s"
    if case == "other_device":
        assert got["ok"] and got["metrics_gated"] == 0


def _profile(step_ms, lrn_ms, lrn_gbs, with_cat=True):
    by_cat = [{"op": "aten::cudnn_convolution", "total_ms": 100.0,
               "pct": 50.0, "gb_per_s": 0.0, "gflops_per_s": 0.0}]
    if with_cat:
        by_cat.append({"op": "LRNAcrossChannels", "total_ms": 15.0,
                       "pct": 7.0, "gb_per_s": 0.0, "gflops_per_s": 0.0})
    return {
        "summary": {"model": "googlenet", "dtype": "f32", "batch": 256,
                    "device": "cuda/NVIDIA H100 80GB HBM3, 700.00 W",
                    "step_ms": step_ms},
        "by_category": by_cat,
        "by_layer": [
            {"op": "conv2/3x3", "total_ms": 50.0, "pct": 25.0,
             "gb_per_s": 400.0, "gflops_per_s": 90000.0},
            {"op": "conv2/norm2", "total_ms": lrn_ms, "pct": 30.0,
             "gb_per_s": lrn_gbs, "gflops_per_s": 0.0},
            {"op": "conv2/relu_3x3", "total_ms": 20.0, "pct": 10.0,
             "gb_per_s": 2500.0, "gflops_per_s": 0.0},
            {"op": "(unattributed)", "total_ms": 5.0, "pct": 2.0,
             "gb_per_s": 0.0},
        ],
    }


def test_diff_equals_the_jax_tools_but_for_the_worklist_source():
    a = _profile(60.0, 61.0, 900.0)
    b = _profile(50.0, 55.0, 900.0, with_cat=False)
    got = perfwatch.diff_profiles(a, b)
    want = jperfwatch.diff_profiles(a, b)
    assert {k: v for k, v in got.items() if k != "fusion_worklist"} == \
        {k: v for k, v in want.items() if k != "fusion_worklist"}
    assert got["fusion_worklist"] == fusion.fusion_worklist(b)
    top = got["fusion_worklist"]["candidates"][0]
    assert top["chain"] == "conv2/norm2"
    assert top["reclaimable_ms"] == pytest.approx(55.0 * (1 - 900 / 2500),
                                                  abs=0.02)
    cat = next(c for c in got["categories"] if c["op"] == "LRNAcrossChannels")
    assert cat["status"] == "only_in_a"


def test_ingest_refuses_jax_and_tpu_captures_by_name(tmp_path, capsys):
    led = str(tmp_path / "L.jsonl")
    root_capture = os.path.join(REPO, "profiles", "googlenet",
                                "op_table.json")
    assert perfwatch.main(["ingest", "--ledger", led, root_capture]) == 2
    assert "profiles/googlenet/op_table.json" in capsys.readouterr().err
    tpu = tmp_path / "op_table.json"
    doc = _profile(50.0, 55.0, 900.0)
    doc["summary"]["device"] = "tpu/TPU v5 lite"
    tpu.write_text(json.dumps(doc))
    assert perfwatch.main(["ingest", "--ledger", led, str(tpu)]) == 2
    assert "a TPU capture" in capsys.readouterr().err
    assert not os.path.exists(led) or not pl.PerfLedger(led).entries()


def test_backfill_walks_only_the_ports_captures(tmp_path):
    pkg = tmp_path / "sparknet_tpu_torch"
    for model in ("caffenet", "googlenet"):
        d = pkg / "profiles" / model
        d.mkdir(parents=True)
        (d / "op_table.json").write_text(json.dumps(
            _profile(50.0, 55.0, 900.0)))
    led = str(tmp_path / "L.jsonl")
    with mock.patch.object(perfwatch, "PKG", str(pkg)), \
            mock.patch.object(perfwatch, "REPO", str(tmp_path)):
        assert perfwatch.main(["ingest", "--backfill", "--ledger", led]) == 0
    paths = {e["path"] for e in pl.PerfLedger(led).entries()}
    assert paths == {f"sparknet_tpu_torch/profiles/{m}/op_table.json"
                     for m in ("caffenet", "googlenet")}


def test_the_ledger_path_is_required():
    for cmd in (["ingest"], ["regress", "--capture", "x"], ["trajectory",
                                                           "--out", "x"],
                ["perfgate"]):
        with pytest.raises(SystemExit):
            perfwatch.main(cmd)


def test_trajectory_writes_only_the_named_files(tmp_path):
    led = pl.PerfLedger(str(tmp_path / "L.jsonl"))
    fp = pl.fingerprint(model="caffenet", dtype="f32", batch=256,
                        device="cuda/NVIDIA H100 80GB HBM3")
    for tag, v, t in (("r16", 6300.0, 1.0), ("r18", 6400.0, 2.0)):
        led.append(pl.make_entry("bench", f"x_{tag}.json", fp,
                                 {"train_img_s": v, "mfu": 0.39},
                                 round_tag=tag, t=t, sha=tag))
    results = os.path.join(REPO, "RESULTS.md")
    before = os.path.getmtime(results)
    out, md = tmp_path / "traj.json", tmp_path / "T.md"
    args = ["trajectory", "--ledger", led.path, "--out", str(out), "--md",
            str(md)]
    assert perfwatch.main(args) == 0
    assert perfwatch.main(args) == 0
    assert os.path.getmtime(results) == before
    traj = json.loads(out.read_text())
    assert [r["round"] for r in traj["rounds"]] == ["r16", "r18"]
    jled = jpl.PerfLedger(led.path)
    assert traj["rounds"] == jperfwatch.build_trajectory(jled)["rounds"]
    text = md.read_text()
    assert text.count(perfwatch._TRAJ_BEGIN) == 1
    assert "| r18 |" in text
