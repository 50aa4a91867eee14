"""The port's ``upgrade_net_proto``, ``draw_net``, ``parse_log`` and
``plot_training_log`` against the JAX package's tools, on the CPU.

- ``upgrade_net_proto``: a V0 prototxt (padding layer folded into the
  convolution), a V1 prototxt, a binary ``.caffemodel`` with weights, one
  whose name field makes its first byte look like text, and a net with a
  ``NetState``: the output files equal the JAX tool's byte for byte (the
  cases of tests/test_tools.py:196-282).
- ``draw_net``: the DOT files equal the JAX tool's byte for byte, at
  every ``--rankdir`` and ``--phase`` (tests/test_tools.py:312-333), and
  ``draw_net``/``draw_net_to_file`` give the same bytes.
- ``parse_log``: the ``.train`` and ``.test`` CSVs equal the JAX tool's on
  a log the port's Solver wrote, on a resumed log with ``inf`` and
  ``nan``, and on the Feb 28 -> Mar 1, Feb 29 and new-year spans
  (tests/test_tools.py:522-656).
- ``plot_training_log``: every chart type hands matplotlib the same
  series, labels and titles as the JAX tool (recorded from
  ``Axes.plot``, ``set_title`` and the axis labels, not compared as PNG
  bytes), and refuses what the JAX tool refuses.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os

import numpy as np
import pytest

from sparknet_tpu.proto.caffemodel import save_caffemodel as jax_save
from sparknet_tpu.tools import draw_net as jax_draw
from sparknet_tpu.tools import parse_log as jax_parse
from sparknet_tpu.tools import plot_training_log as jax_plot
from sparknet_tpu.tools import upgrade_net_proto as jax_upgrade
from sparknet_tpu_torch.proto import load_net_prototxt, \
    load_solver_prototxt_with_net
from sparknet_tpu_torch.proto.caffemodel import save_caffemodel
from sparknet_tpu_torch.solvers import Solver
from sparknet_tpu_torch.tools import (draw_net, parse_log,
                                      plot_training_log, upgrade_net_proto)

from torch_threads import one_torch_thread  # noqa: F401

V0 = """
name: "v0"
input: "data"
input_dim: 1 input_dim: 1 input_dim: 8 input_dim: 8
layers { layer { name: "pad" type: "padding" pad: 1 }
         bottom: "data" top: "p" }
layers { layer { name: "c" type: "conv" num_output: 2 kernelsize: 3
                 weight_filler { type: "xavier" } } bottom: "p" top: "c" }
layers { layer { name: "r" type: "relu" } bottom: "c" top: "c" }
"""
V1 = """
name: "v1net"
layers { name: "data" type: DATA top: "data" top: "label"
  data_param { source: "x" batch_size: 4 }
  transform_param { crop_size: 6 mirror: true }
  include { phase: TRAIN } }
layers { name: "data" type: DATA top: "data" top: "label"
  data_param { source: "y" batch_size: 2 } include { phase: TEST } }
layers { name: "conv" type: CONVOLUTION bottom: "data" top: "conv"
  blobs_lr: 1 blobs_lr: 2 weight_decay: 1 weight_decay: 0
  convolution_param { num_output: 4 kernel_size: 3 stride: 2 } }
layers { name: "pool" type: POOLING bottom: "conv" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layers { name: "ip" type: INNER_PRODUCT bottom: "pool" top: "ip"
  inner_product_param { num_output: 3 } }
layers { name: "loss" type: SOFTMAX_LOSS bottom: "ip" bottom: "label" }
layers { name: "acc" type: ACCURACY bottom: "ip" bottom: "label"
  top: "acc" include { phase: TEST } }
"""
STAGED = """
name: "staged"
state { phase: TEST stage: "deploy" }
layer { name: "d" type: "Input" top: "x"
        input_param { shape { dim: 1 dim: 2 } } }
"""
TOY = """
name: "toy"
layer { name: "data" type: "Input" top: "data"
        input_param { shape { dim: 1 dim: 3 dim: 8 dim: 8 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
        convolution_param { num_output: 2 kernel_size: 3
                            weight_filler { type: "xavier" } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "pool" type: "Pooling" bottom: "conv" top: "pool"
        pooling_param { pool: AVE kernel_size: 2 stride: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "pool" top: "ip"
        inner_product_param { num_output: 5 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
        include { phase: TRAIN } }
layer { name: "prob" type: "Softmax" bottom: "ip" top: "prob"
        include { phase: TEST } }
"""


def _both(tmp_path, port_main, jax_main, args, suffix):
    """Run both tools on ``args`` (inputs), writing ``ours``/``theirs``."""
    ours, theirs = tmp_path / f"ours{suffix}", tmp_path / f"theirs{suffix}"
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_main([args[0], str(ours)] + args[1:]) == 0
        assert jax_main([args[0], str(theirs)] + args[1:]) == 0
    return ours.read_bytes(), theirs.read_bytes()


@pytest.mark.parametrize("case", ["v0", "v1", "staged", "toy"])
@pytest.mark.parametrize("binary", [False, True])
def test_upgrade_net_proto_text_input_equals_jax(tmp_path, case, binary):
    src = tmp_path / f"{case}.prototxt"
    src.write_text({"v0": V0, "v1": V1, "staged": STAGED, "toy": TOY}[case])
    extra = ["--binary"] if binary else []
    ours, theirs = _both(tmp_path, upgrade_net_proto.main,
                         jax_upgrade.main, [str(src)] + extra,
                         ".caffemodel" if binary else ".prototxt")
    assert ours == theirs
    if not binary:
        text = ours.decode()
        assert "layers {" not in text
        net = load_net_prototxt(text)
        if case == "v0":
            assert [lp.type for lp in net.layer] == ["Convolution", "ReLU"]
        if case == "staged":
            assert net.state.stage == ["deploy"]


@pytest.mark.parametrize("name", ["", "CaffeNet"])
def test_upgrade_net_proto_binary_input_equals_jax(tmp_path, name):
    """A ``.caffemodel`` (with weights; a named one starts with b'\\n',
    which looks like text) upgrades to the JAX tool's bytes, text and
    binary, and the weights survive."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    src = tmp_path / "w.caffemodel"
    save_caffemodel(str(src), {"ip": [w, np.ones(3, np.float32)]},
                    **({"name": name} if name else {}))
    theirs_src = tmp_path / "w_jax.caffemodel"
    jax_save(str(theirs_src), {"ip": [w, np.ones(3, np.float32)]},
             **({"name": name} if name else {}))
    assert src.read_bytes() == theirs_src.read_bytes()
    if name:
        assert src.read_bytes()[:1] == b"\n"
    for extra, suffix in (([], ".prototxt"), (["--binary"], ".caffemodel")):
        ours, theirs = _both(tmp_path, upgrade_net_proto.main,
                             jax_upgrade.main, [str(src)] + extra, suffix)
        assert ours == theirs, suffix
    from sparknet_tpu_torch.proto import load_net_binaryproto
    net = load_net_binaryproto(str(tmp_path / "ours.caffemodel"))
    np.testing.assert_array_equal({lp.name: lp for lp in net.layer}["ip"]
                                  .blobs[0], w)


@pytest.mark.parametrize("case", ["v1", "toy"])
@pytest.mark.parametrize("rankdir", ["LR", "TB", "RL", "BT"])
@pytest.mark.parametrize("phase", ["ALL", "TRAIN", "TEST"])
def test_draw_net_dot_equals_jax(tmp_path, case, rankdir, phase):
    src = tmp_path / "net.prototxt"
    src.write_text({"v1": V1, "toy": TOY}[case])
    ours, theirs = _both(tmp_path, draw_net.main, jax_draw.main,
                         [str(src), "--rankdir", rankdir, "--phase", phase],
                         ".dot")
    assert ours == theirs
    assert ours.decode().startswith(f'digraph "{case if case == "toy" else "v1net"}"')
    assert f"rankdir={rankdir};" in ours.decode()


def test_draw_net_api_equals_jax(tmp_path):
    src = tmp_path / "net.prototxt"
    src.write_text(TOY)
    dot = draw_net.draw_net(str(src), "TB", "dot")
    assert dot == jax_draw.draw_net(str(src), "TB", "dot")
    draw_net.draw_net_to_file(str(src), str(tmp_path / "n.gv"), "TB")
    assert (tmp_path / "n.gv").read_bytes() == dot
    assert draw_net.draw_net(load_net_prototxt(str(src)), "TB", "gv") == dot


NET_FOR_LOG = """
layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { shape { dim: 4 dim: 3 } shape { dim: 4 }
    data_filler { type: "gaussian" std: 1.0 }
    data_filler { type: "constant" value: 1.0 } } }
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 2 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" }
layer { name: "acc" type: "Accuracy" bottom: "ip" bottom: "label"
  top: "accuracy" include { phase: TEST } }
"""


def _solver_log(tmp_path) -> str:
    """A log the port's Solver writes: glog lines, lr lines, a test pass
    at iteration 0 and every 3."""
    sp = load_solver_prototxt_with_net(
        "base_lr: 0.1\nmax_iter: 6\ndisplay: 2\ntest_interval: 3\n"
        "test_iter: 2\ntest_initialization: true\n",
        load_net_prototxt(NET_FOR_LOG))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        Solver(sp, seed=0, device="cpu").solve()
    log = tmp_path / "train.log"
    log.write_text(buf.getvalue())
    return str(log)


def _logs(tmp_path) -> dict[str, str]:
    logs = {"solver": _solver_log(tmp_path)}
    cases = {
        "resume_inf": (
            "Iteration 300, Testing net (#0)\n"
            "    Test net output: accuracy = 0.75\n"
            "Iteration 302, loss = -inf\n"
            "Iteration 304, loss = nan\n"
            "Iteration 304, Testing net (#1)\n"
            "    Test net output: loss = 1e+30\n"
            "    Test net #1 output: acc[2] = 0.5\n", None),
        "feb28_mar1": (
            "I0228 23:59:50.000000  1 solver.py:1] Iteration 0, loss = 1.0\n"
            "I0301 00:00:10.000000  1 solver.py:1] Iteration 2, loss = 0.9\n",
            datetime.datetime(2025, 3, 1, 1, 0, 0)),
        "leap_feb29": (
            "I0229 10:00:00.000000  1 solver.py:1] Iteration 0, loss = 1.0\n"
            "I0301 10:00:00.000000  1 solver.py:1] Iteration 2, lr = 0.01\n"
            "I0301 10:00:00.000000  1 solver.py:1] Iteration 2, loss = 0.9\n",
            datetime.datetime(2025, 3, 6, 1, 0, 0)),
        "new_year": (
            "I1231 23:59:00.000000  1 solver.py:1] Iteration 0, loss = 1.0\n"
            "I0101 00:01:00.000000  1 solver.py:1] Iteration 2, loss = 0.9\n",
            datetime.datetime(2026, 1, 1, 2, 0, 0)),
    }
    for name, (text, mtime) in cases.items():
        path = tmp_path / f"{name}.log"
        path.write_text(text)
        if mtime is not None:
            t = mtime.timestamp()
            os.utime(path, (t, t))
        logs[name] = str(path)
    return logs


@pytest.mark.parametrize("case", ["solver", "resume_inf", "feb28_mar1",
                                  "leap_feb29", "new_year"])
def test_parse_log_csvs_equal_jax(tmp_path, case):
    log = _logs(tmp_path)[case]
    ours_dir, theirs_dir = tmp_path / "ours", tmp_path / "theirs"
    ours_dir.mkdir()
    theirs_dir.mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        assert parse_log.main([log, str(ours_dir)]) == 0
        assert jax_parse.main([log, str(theirs_dir)]) == 0
    for ext in (".train", ".test"):
        name = os.path.basename(log) + ext
        assert (ours_dir / name).read_bytes() == \
            (theirs_dir / name).read_bytes(), ext
    train, test = parse_log.parse_log(log)
    jtrain, jtest = jax_parse.parse_log(log)
    assert [(r.iter, r.seconds, r.lr) for r in train] == \
        [(r.iter, r.seconds, r.lr) for r in jtrain]
    np.testing.assert_array_equal([r.loss for r in train],
                                  [r.loss for r in jtrain])
    assert list(test) == list(jtest)
    if case == "solver":
        assert (0, 0) in test and any(it == 6 for it, _ in test)
        assert all(r.lr == 0.1 and r.seconds is not None for r in train)


class _Recorder:
    """What a chart hands matplotlib: each ``plot`` call's x, y and label,
    the title and the axis labels."""

    def __init__(self, monkeypatch):
        from matplotlib.axes import Axes
        self.calls: list = []
        rec = self.calls
        for name in ("plot", "set_title", "set_xlabel", "set_ylabel"):
            orig = getattr(Axes, name)

            def wrapped(ax, *a, _orig=orig, _name=name, **k):
                rec.append((_name, [list(map(float, v)) if isinstance(
                    v, (list, tuple, np.ndarray)) else v for v in a],
                    k.get("label")))
                return _orig(ax, *a, **k)
            monkeypatch.setattr(Axes, name, wrapped)

    def take(self) -> list:
        out = list(self.calls)
        self.calls.clear()
        return out


@pytest.mark.parametrize("chart", range(8))
def test_plot_training_log_hands_matplotlib_the_jax_series(
        tmp_path, monkeypatch, chart):
    logs = _logs(tmp_path)
    rec = _Recorder(monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        assert plot_training_log.main(
            [str(chart), str(tmp_path / "ours.png"), logs["solver"]]) == 0
        ours = rec.take()
        assert jax_plot.main(
            [str(chart), str(tmp_path / "theirs.png"), logs["solver"]]) == 0
        theirs = rec.take()
    assert ours == theirs
    assert sum(name == "plot" for name, _, _ in ours) >= 1
    assert (tmp_path / "ours.png").stat().st_size > 1000


@pytest.mark.parametrize("chart,match", [(1, "timestamp"), (4, "lr"),
                                         (9, "unknown chart type")])
def test_plot_training_log_refuses_as_jax(tmp_path, chart, match):
    log = tmp_path / "t.log"
    log.write_text(
        "Iteration 0, Testing net (#0)\n"
        "    Test net output: accuracy = 0.1\n"
        "Iteration 2, loss = 2.0\n"
        "Iteration 4, Testing net (#0)\n"
        "    Test net output: accuracy = 0.6\n")
    for plot in (plot_training_log.plot, jax_plot.plot):
        with pytest.raises(ValueError, match=match):
            plot(chart, str(tmp_path / "x.png"), [str(log)])
