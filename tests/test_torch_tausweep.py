"""The port's τ × codec sweep against the JAX package's, on the CPU.

Both tools run once for the module on the learning proxy's tiny scale
(tests/test_torch_learning_proxy.py: the published cifar10_full schedule
divided by 8,750, 400 + 100 images, 4 workers, a row every 4
iterations), τ=2 and the codecs none and int8, the port from the JAX
tool's init.  Per cell and row the iteration and lr are equal,
``train_loss`` agrees within 1e-4 relative (the port's int8 encode is
the op-by-op quantizer, the JAX one its compiled form: ROADMAP C) and
the accuracies within one image of the 100; the wire bytes, the band
verdicts and the exit codes are the same.  The loss sits on the ln(10)
plateau at this depth, so each row's params are held too: the port's
are taken where its row is made, the JAX tool's where its jitted
accuracy runs (a ``jax.debug.callback`` on the test net's forward).
Each cell's update agrees with the JAX tool's within the proxy test's
1e-2 for the worst leaf (2.3e-3 here), and the codec's own effect (the
int8 cell's params less the none cell's, over all leaves) within 0.25 of
the JAX tool's (5.1e-3 and 6.0e-2 here; at the last row int8 without
error feedback reads 3.6 and int8 replaced by none 1.0, both refused).
The sweep merges into an existing RESULTS file, and the figure draws its
panel.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from unittest import mock

import jax
import numpy as np
import pytest

from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu_torch.parallel import comms
from sparknet_tpu_torch.tools import learning_proxy as tlp
from sparknet_tpu_torch.tools import plot_learning_proxy as tplot
from sparknet_tpu_torch.tools import tausweep as tsweep
from tests.test_torch_learning_proxy import (UPDATE_RTOL, jax_init,
                                             jax_tool, rows_agree,
                                             update_gap)
from tests.torch_threads import one_torch_thread  # noqa: F401

ARGS = ["--scale", "8750", "--n-train", "400", "--n-test", "100",
        "--workers", "4", "--eval-every", "4", "--taus", "2",
        "--codecs", "none,int8"]
CELLS = ["tau2_none", "tau2_int8"]
CODEC_RTOL = 0.25     # the int8 cell's params less the none cell's


def port_rows(argv, params0) -> list:
    """Runs the port's sweep; the params of each row, in run order."""
    rows, row = [], tlp.Proxy.row

    def keep(self, it, loss, params):
        rows.append({k: [b.detach().cpu().numpy().copy() for b in v]
                     for k, v in params.items()})
        return row(self, it, loss, params)

    with mock.patch.object(tlp.Proxy, "row", keep):
        rc = tsweep.main(argv, params0=params0)
    return rc, rows


def jax_rows(argv) -> tuple:
    """Runs the JAX tool's sweep; the params of each row, taken where its
    jitted accuracy runs the test net (twice a row, train then test set,
    one batch each at this size, on the same params)."""
    seen, apply = [], JaxNet.apply

    def keep(self, params, inputs, *, train=None, rng=None):
        if train is False:
            jax.debug.callback(lambda p: seen.append(
                jax.tree_util.tree_map(np.array, p)), params)
        return apply(self, params, inputs, train=train, rng=rng)

    # the JAX tool puts its own folder on sys.path to import its
    # sibling learning_proxy; take it off again after the run
    path = list(sys.path)
    try:
        with mock.patch.object(JaxNet, "apply", keep):
            rc = jax_tool("tausweep").main(argv)
    finally:
        sys.path[:] = path
    return rc, seen


def by_cell(rows: list, sweep: dict) -> dict:
    """{cell: its rows' params}, ``rows`` in the sweep's run order."""
    out, i = {}, 0
    for name in CELLS:
        n = len(sweep["cells"][name]["curve"])
        out[name], i = rows[i:i + n], i + n
    assert i == len(rows)
    return out


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep")
    jax_out, out = d / "jax.json", d / "torch.json"
    jax_rc, seen = jax_rows(ARGS + ["--out", str(jax_out),
                                    "--platform", "cpu"])
    assert len(seen) % 2 == 0 and all(
        all(np.array_equal(x, y) for x, y in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
        for a, b in zip(seen[0::2], seen[1::2]))
    out.write_text(json.dumps({"curve_1x": [], "kept": 1}))
    params0 = jax_init()
    rc, rows = port_rows(ARGS + ["--out", str(out), "--device", "cpu"],
                         params0)
    want = json.loads(jax_out.read_text())["sweep"]
    got = json.loads(out.read_text())
    return (jax_rc, want, rc, got, out, params0,
            by_cell(rows, got["sweep"]), by_cell(seen[1::2], want))


def codec_gap(int8: dict, none: dict, want_int8: dict, want_none: dict,
              params0: dict) -> float:
    """||E − Ejax|| / ||Ejax|| over all leaves, E a tool's int8 params less
    its none params at one row."""
    def flat(p):
        return np.concatenate([np.asarray(p[k][j], np.float64).ravel()
                               for k in params0
                               for j in range(len(params0[k]))])
    got = flat(int8) - flat(none)
    want = flat(want_int8) - flat(want_none)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("cell", CELLS)
def test_cells_track_the_jax_tool(sweeps, cell):
    _, want, _, got, *_ = sweeps
    g, w = got["sweep"]["cells"][cell], want["cells"][cell]
    rows_agree(g["curve"], w["curve"])
    for k in ("tau", "codec", "rounds", "exchange_bytes_per_round",
              "bytes_shrink_x"):
        assert g[k] == w[k], k
    assert abs(g["final_acc"] - w["final_acc"]) <= 1 / 100 + 1e-6
    assert g["img_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_cell_updates_track_the_jax_tool(sweeps, cell):
    """Each row's params less the init, against the JAX tool's."""
    *_, params0, got, want = sweeps
    assert len(got[cell]) == len(want[cell]) > 0
    for i, (g, w) in enumerate(zip(got[cell], want[cell])):
        gap = update_gap(g, w, params0)
        print(f"update gap {cell} row {i}: {gap!r}")
        assert gap <= UPDATE_RTOL, (cell, i, gap)


def test_codec_effect_tracks_the_jax_tool(sweeps):
    """What int8 with error feedback changed against none, row by row."""
    *_, params0, got, want = sweeps
    for i in range(len(got["tau2_int8"])):
        gap = codec_gap(got["tau2_int8"][i], got["tau2_none"][i],
                        want["tau2_int8"][i], want["tau2_none"][i], params0)
        print(f"codec gap row {i}: {gap!r}")
        assert gap <= CODEC_RTOL, (i, gap)


PLANTED_CODECS = {
    "int8_without_error_feedback": lambda: dataclasses.replace(
        comms.get_codec("int8"), keep_residual=False),
    "int8_as_none": lambda: dataclasses.replace(comms.get_codec("none"),
                                                name="int8")}


@pytest.mark.parametrize("fault", sorted(PLANTED_CODECS))
def test_codec_bound_refuses_planted_codecs(sweeps, fault, tmp_path):
    """The int8 cell run again with a planted codec reads beyond
    ``CODEC_RTOL`` at its last row."""
    *_, params0, got, want = sweeps
    argv = list(ARGS)
    argv[argv.index("none,int8")] = "int8"
    with mock.patch.dict(comms._CODECS, {"int8": PLANTED_CODECS[fault]()}):
        rc, rows = port_rows(argv + ["--out", str(tmp_path / "p.json"),
                                     "--device", "cpu"], params0)
    assert rc == 0 and len(rows) == len(got["tau2_int8"])
    gap = codec_gap(rows[-1], got["tau2_none"][-1], want["tau2_int8"][-1],
                    want["tau2_none"][-1], params0)
    print(f"planted {fault}: {gap!r}")
    assert gap > CODEC_RTOL, (fault, gap)


def test_sweep_config_verdict_and_merge(sweeps):
    jax_rc, want, rc, got, *_ = sweeps
    assert rc == jax_rc
    assert got["sweep"]["config"] == want["config"]
    assert got["sweep"]["exchange_bytes_none"] == want["exchange_bytes_none"]
    assert {k: v["ok"] for k, v in got["sweep"]["band_ok"].items()} == \
        {k: v["ok"] for k, v in want["band_ok"].items()}
    assert got["sweep"]["device"] == "cpu/cpu"
    assert got["kept"] == 1 and got["curve_1x"] == []


def test_sweep_panel_renders_png(sweeps, tmp_path):
    pytest.importorskip("matplotlib")
    out = sweeps[4]
    results = json.loads(out.read_text())
    fig = tmp_path / "sweep.png"
    info = tplot.render_sweep(results["sweep"], str(fig))
    assert info["out"] == str(fig)
    assert fig.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
