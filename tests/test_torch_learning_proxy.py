"""The port's learning proxy against the JAX package's, on the CPU.

Both tools run once for the module at a tiny scale (the published
cifar10_full schedule divided by 8,750: 8 iterations, the lr drops at 6
and 7, 400 + 100 images, 4 workers, τ=2, a row every 4 iterations; the
divisor keeps every chunk of the JAX tool one compiled shape), the port
from the JAX tool's init, carried across by ``main``'s ``params0``.  Per
row and curve the iteration and lr are equal, ``train_loss`` agrees
within 1e-4 relative and the accuracies within one image of the 100.
At this depth the loss sits on cifar10_full's ln(10) plateau (conv1 is
drawn with std 1e-4), so the rows alone cannot tell a wrong input or
partition from a right one: each curve's update (the params the resume
file holds after the last row, less the init) is held against the JAX
tool's, the worst leaf of ||Δport − Δjax|| / ||Δjax|| within 1e-2.  That
reads 2.5e-4 for 1x and 2.1e-3 for 8-way and hier here; a mean one grey
level off reads 0.12, a partition one image off 0.69 and hier run as
local SGD 0.062, and each of those planted faults is refused.
The 8-way run's trainer equals a round of the workers run by hand
(``local_update`` from the same params, then the mean) bit for bit, and
hier on one chip a host equals 8-way; the resume files resume bit for
bit; the figure renders from the port's RESULTS.  Each tool's flags are
the JAX tool's (plus ``--device``).
"""

from __future__ import annotations

import ast
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu_torch.tools import learning_proxy as tlp
from sparknet_tpu_torch.tools import plot_learning_proxy as tplot
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARGS = ["--scale", "8750", "--n-train", "400", "--n-test", "100",
        "--workers", "4", "--tau", "2", "--eval-every", "4"]
LOSS_RTOL = 1e-4
ACC_ATOL = 1.0 / 100 + 1e-6       # one image of --n-test
UPDATE_RTOL = 1e-2                # the worst leaf's update, port vs JAX


def jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_init() -> dict:
    """The JAX tool's initial params ({layer: [numpy]})."""
    from sparknet_tpu.models import cifar10_full
    params = jax_tool("learning_proxy").build(
        tlp.schedule(8750)[0], cifar10_full(100, 100))[3]
    return {k: [np.asarray(b) for b in v]
            for k, v in jax.device_get(params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("proxy")
    jax_out, out = d / "jax.json", d / "torch.json"
    assert jax_tool("learning_proxy").main(
        ARGS + ["--out", str(jax_out), "--platform", "cpu"]) == 0
    params0 = jax_init()
    assert tlp.main(ARGS + ["--out", str(out), "--device", "cpu"],
                    params0=params0) == 0
    return (json.loads(jax_out.read_text()), json.loads(out.read_text()),
            params0, out, jax_out)


def update_gap(got: dict, want: dict, params0: dict) -> float:
    """The worst leaf of ||Δgot − Δwant|| / ||Δwant||, each Δ a run's
    params ({layer: [arrays]}) less ``params0``."""
    gaps = []
    for k, blobs in params0.items():
        for j, b in enumerate(blobs):
            b = np.asarray(b, np.float64)
            d_got = np.asarray(got[k][j], np.float64) - b
            d_want = np.asarray(want[k][j], np.float64) - b
            gaps.append(np.linalg.norm(d_got - d_want)
                        / np.linalg.norm(d_want))
    return float(max(gaps))


def resume_params(path, params0: dict, *, jax_order: bool,
                  stacked: bool = False) -> dict:
    """The params a tool's ``<out>.resume_<tag>.npz`` holds, as
    {layer: [arrays]}.  Its leaves are (params, state) flattened: the
    port's in the params' layer order, the JAX tool's with the layers
    sorted (pytree order) and, for 8-way and hier, a leading worker or
    host axis whose rows the last average made equal."""
    keys = sorted(params0) if jax_order else list(params0)
    order = [(k, j) for k in keys for j in range(len(params0[k]))]
    out = {k: [None] * len(v) for k, v in params0.items()}
    with np.load(path) as z:
        for i, (k, j) in enumerate(order):
            leaf = z[f"l{i}"]
            out[k][j] = leaf[0] if stacked else leaf
    return out


def port_update_gap(port_out, jax_out, params0, tag: str) -> float:
    return update_gap(
        resume_params(f"{port_out}.resume_{tag}.npz", params0,
                      jax_order=False),
        resume_params(f"{jax_out}.resume_{tag}.npz", params0,
                      jax_order=True, stacked=tag != "1x"),
        params0)


def rows_agree(got: list, want: list) -> None:
    assert [r["iter"] for r in got] == [r["iter"] for r in want]
    for g, w in zip(got, want):
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)   # f32 in JAX
        assert g["train_loss"] == pytest.approx(w["train_loss"],
                                                rel=LOSS_RTOL)
        for k in ("train_acc", "test_acc"):
            assert abs(g[k] - w[k]) <= ACC_ATOL, (g["iter"], k, g[k], w[k])


@pytest.mark.parametrize("curve", ["curve_1x", "curve_8way", "curve_hier"])
def test_curves_track_the_jax_tool(runs, curve):
    want, got, *_ = runs
    rows_agree(got[curve], want[curve])


@pytest.mark.parametrize("tag", ["1x", "8way", "hier"])
def test_updates_track_the_jax_tool(runs, tag):
    """What the run changed in the params, against the JAX tool's."""
    _, _, params0, out, jax_out = runs
    gap = port_update_gap(out, jax_out, params0, tag)
    print(f"update gap {tag}: {gap!r}")
    assert gap <= UPDATE_RTOL, (tag, gap)


def _mean_off_by_one(self, img_u8):
    from sparknet_tpu_torch.ops.augment import AugmentSpec, apply
    zeros = np.zeros(img_u8.shape[0], np.int32)
    return apply(img_u8, zeros, zeros, zeros,
                 AugmentSpec(mean=self.spec.mean + 1))


def _partition_off_by_one(self, idxs):
    part = self.n_train // idxs.shape[1]
    return ROUND_BATCHES(self, np.minimum(idxs + 1, part - 1))


def _hier_as_local_sgd(self, strategy, workers, tau, codec="none"):
    if strategy == "hierarchical":
        strategy = "local_sgd"
    return TRAINER(self, strategy, workers, tau, codec)


ROUND_BATCHES, TRAINER = tlp.Proxy.round_batches, tlp.Proxy.trainer
PLANTED = {"mean_off_by_one": ("1x", "prep", _mean_off_by_one),
           "partition_off_by_one": ("8way", "round_batches",
                                    _partition_off_by_one),
           "hier_as_local_sgd": ("hier", "trainer", _hier_as_local_sgd)}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_update_bound_refuses_planted_faults(runs, fault, tmp_path,
                                             monkeypatch):
    """A port with a planted fault in its input, its partitions or its
    strategy reads beyond ``UPDATE_RTOL``."""
    _, _, params0, merge, jax_out = runs
    tag, attr, planted = PLANTED[fault]
    out = tmp_path / "planted.json"
    monkeypatch.setattr(tlp.Proxy, attr, planted)
    assert tlp.main(ARGS + ["--out", str(out), "--device", "cpu",
                            "--runs", tag, "--merge", str(merge)],
                    params0=params0) == 0
    gap = port_update_gap(out, jax_out, params0, tag)
    print(f"planted {fault}: {gap!r}")
    assert gap > UPDATE_RTOL, (fault, gap)


def test_results_schema_and_final(runs):
    want, got, *_ = runs
    assert set(want) <= set(got)
    assert set(want["final"]) <= set(got["final"])
    assert {k: v for k, v in got["config"].items()} == want["config"]
    assert got["device"] == "cpu/cpu"
    for tag in ("1x", "8way", "hier"):
        assert got["final"][f"img_s_{tag}"] > 0
        assert abs(got["final"][f"acc_{tag}"]
                   - want["final"][f"acc_{tag}"]) <= ACC_ATOL


def _px(params0):
    return tlp.Proxy(tlp.schedule(8750)[0], 400, 100,
                     torch.device("cpu"), params0=params0)


def test_8way_trainer_round_equals_the_workers_by_hand(runs):
    """The proxy's local_sgd round: each worker's τ steps from the same
    params on its own partition, one after another, then the mean."""
    px = _px(runs[2])
    W, tau, b = 4, 2, 100
    idxs = np.random.default_rng(3).integers(0, 100, size=(tau, W, b))
    tr = px.trainer("local_sgd", W, tau)
    tr.train_round(px.round_batches(idxs))
    workers = []
    for w in range(W):
        params = px.clone_params()
        state = px.rule.init(params)
        for t in range(tau):
            i = torch.from_numpy(idxs[t, w] + w * 100)
            params, state, _ = px.local_update(
                params, state, t, {"data": px.prep(px.tx[i])[None],
                                   "label": px.ty[i][None]}, None)
        workers.append(params)
    for k in tr.params:
        for j, got in enumerate(tr.params[k]):
            want = torch.stack([p[k][j] for p in workers]).mean(0)
            assert torch.equal(got, want), (k, j)


def test_hier_with_one_chip_a_host_equals_8way(runs):
    """Hierarchical on 2 hosts of 1 chip: each step's chip mean is the
    one chip's gradient, so its rounds equal local_sgd's on 2 workers."""
    px = _px(runs[2])
    idxs = np.random.default_rng(4).integers(0, 200, size=(2, 2, 2, 100))
    hier = px.trainer("hierarchical", 2, 2)
    local = px.trainer("local_sgd", 2, 2)
    for i in idxs:
        assert hier.train_round(px.round_batches(i)) == \
            local.train_round(px.round_batches(i))
    for k in hier.params:
        assert all(torch.equal(a, b) for a, b in zip(hier.params[k],
                                                     local.params[k])), k


def test_resume_files_resume_bit_for_bit(runs, tmp_path, monkeypatch):
    """A 1x run stopped by a fault after its first row, then rerun, resumes
    from ``<out>.resume_1x.npz`` and ends as the uninterrupted run did."""
    _, got, params0, merge, _ = runs
    out = tmp_path / "r.json"
    args = ARGS + ["--out", str(out), "--device", "cpu", "--runs", "1x",
                   "--merge", str(merge)]
    row = tlp.Proxy.row

    def row_then_fault(self, it, loss, params):
        if it > 4:
            raise RuntimeError("planted fault after the first row")
        return row(self, it, loss, params)

    with monkeypatch.context() as m:
        m.setattr(tlp.Proxy, "row", row_then_fault)
        with pytest.raises(RuntimeError, match="planted"):
            tlp.main(args, params0=params0)
    assert (tmp_path / "r.json.resume_1x.npz").exists()
    assert tlp.main(args, params0=params0) == 0
    resumed = json.loads(out.read_text())["curve_1x"]
    assert [r["iter"] for r in resumed] == [4, 8]
    for a, b in zip(resumed, got["curve_1x"]):
        assert {k: a[k] for k in a if k != "wall_s"} == \
            {k: b[k] for k in b if k != "wall_s"}


def test_plot_renders_png(runs, tmp_path):
    pytest.importorskip("matplotlib")
    fig = tmp_path / "proxy.png"
    assert tplot.main(["--in", str(runs[3]), "--out", str(fig)]) == 0
    assert fig.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def _flags(path: pathlib.Path) -> set[str]:
    return {a.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)
            and str(a.value).startswith("--")}


@pytest.mark.parametrize("tool", ["learning_proxy", "tausweep",
                                  "plot_learning_proxy"])
def test_flags_are_the_jax_tools_plus_device(tool):
    ours = _flags(ROOT / "sparknet_tpu_torch" / "tools" / f"{tool}.py")
    theirs = _flags(ROOT / "tools" / f"{tool}.py")
    assert ours - {"--device"} == theirs and theirs
