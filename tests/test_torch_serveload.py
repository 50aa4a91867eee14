"""The port's serveload (``sparknet_tpu_torch/tools/serveload.py``)
against the root ``tools/serveload.py``, on the CPU, lenet.

Both reports of one configuration carry the same top-level keys and
verdict names; the port's every sweep point has 0 mismatches against
its solo references (bit for bit), its overload leg rejects and keeps
its p99 under the bound, the SLO monitor reads ok after the paced sweep
and breach (with a flight dump) under overload; ``--smoke`` exits 0; a
served answer one ulp off its reference is caught; ``--url`` counts a
429 as the engine's typed rejection; ``--fleet`` needs the card unless
the CPU is asked for."""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest

from sparknet_tpu_torch.parallel import serving
from sparknet_tpu_torch.tools import serve, serveload
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent

# a CPU-sized configuration: the overload leg must overfill the queue
SMALL = dict(model="lenet", shapes=(1, 4, 8), queue=32, dtype="f32",
             clients=2, window=4, seconds=0.4, inputs_n=8,
             fractions=(0.5,), overload_x=2.0)


def _jax_serveload():
    spec = importlib.util.spec_from_file_location(
        "jax_serveload", ROOT / "tools" / "serveload.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reports():
    port = serveload.run_report(**SMALL, device="cpu")
    jax_report = _jax_serveload().run_report(**SMALL)
    return port, jax_report


def test_reports_have_the_jax_keys_and_verdicts(reports):
    port, jax_report = reports
    assert set(port) == set(jax_report)
    assert set(port["verdicts"]) == set(jax_report["verdicts"])
    for leg in ("saturation", "overload"):
        assert set(port[leg]) == set(jax_report[leg])
    assert [set(p) for p in port["sweep"]] == \
        [set(p) for p in jax_report["sweep"]]
    # the batch-1 engine's dispatches: the port's one key beyond
    assert set(port["batch1"]) == set(jax_report["batch1"]) | {"dispatches"}
    assert port["device"] == "cpu/cpu"
    assert port["provenance"]["fingerprint"]["model"] == "lenet"


def test_sweep_is_bit_identical_and_overload_is_bounded(reports):
    port, _ = reports
    assert [p["fraction_of_saturation"] for p in port["sweep"]] == [0.5]
    for p in port["sweep"] + [port["saturation"], port["overload"]]:
        assert p["exact_mismatches"] == 0 and p["errors"] == 0
        assert p["completed"] > 0
    v = port["verdicts"]
    assert v["bit_identical"] and v["exact_mismatches"] == 0
    assert port["overload"]["rejected"] > 0
    assert port["overload"]["p99_ms"] <= port["p99_bound_ms"]
    assert v["overload_p99_bounded"] and v["overload_rejected"] > 0
    assert v["slo_paced_healthy"] and v["slo_overload_breached"]
    assert port["slo_overload"]["flight_dumps"] >= 1
    assert port["batch1"]["dispatches"] == port["batch1"]["completed"]
    assert serveload.smoke_failures(port) == []


def test_smoke_exits_zero(capsys):
    assert serveload.main(["--smoke", "--device", "cpu"]) == 0
    assert "smoke ok" in capsys.readouterr().err


def test_an_answer_one_ulp_off_fails_the_gate(monkeypatch):
    solo = serving.solo_references

    def planted(lm, inputs):
        refs = solo(lm, inputs)
        for by_idx in refs.values():
            row = by_idx[0]
            row[0] = np.nextafter(row[0], np.float32(np.inf))
        return refs

    monkeypatch.setattr(serving, "solo_references", planted)
    rep = serveload.run_report(**{**SMALL, "seconds": 0.2}, device="cpu")
    assert rep["verdicts"]["exact_mismatches"] > 0
    assert any("mismatches" in f for f in serveload.smoke_failures(rep))


def test_remote_transport_maps_429_to_the_typed_rejection(monkeypatch):
    from sparknet_tpu_torch import classify

    def busy(url, model, x, tenant):
        raise RuntimeError(f"{url}/v1/classify: HTTP 429 (queue_full )")

    monkeypatch.setattr(classify, "remote_classify", busy)
    submit = serveload.make_remote_submit("http://h:1", "lenet", "t")
    with pytest.raises(serving.Overloaded):
        submit(0, np.zeros((1, 28, 28), np.float32))


def test_remote_transport_builds_the_engines_result(monkeypatch):
    from sparknet_tpu_torch import classify
    answer = {"model": "lenet", "probs": [0.25] * 4, "request_id": 3,
              "queue_ms": 1.0, "infer_ms": 2.0, "total_ms": 3.0,
              "batch_n": 1, "padded_to": 4}
    monkeypatch.setattr(classify, "remote_classify",
                        lambda url, model, x, tenant: answer)
    fut = serveload.make_remote_submit("http://h:1", "lenet", "t")(
        0, np.zeros((1, 28, 28), np.float32))
    res = fut.result()
    assert fut.done() and res.padded_to == 4 and res.probs.dtype == np.float32


@pytest.mark.parametrize("argv", [["--fleet", "2"],
                                  ["--fleet-devices", "3"],
                                  ["--workdir", "/tmp/x"]])
def test_fleet_legs_raise_naming_a12(monkeypatch, argv):
    """The fleet legs left to their default device on a machine with no
    card raise before any replica starts (the legs themselves are held
    in tests/test_torch_fleet_serving.py)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fleet = [] if argv[0] == "--fleet" else ["--fleet", "2"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serveload.main(fleet + argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serveload.run_fleet_report()


def test_the_card_is_required_unless_the_cpu_is_asked_for(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serveload.run_report(**SMALL)
