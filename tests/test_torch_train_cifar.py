"""The port's ``tools/train_cifar.py`` against the JAX package's, on the
CPU (``--device cpu``).

Both tools read one solver and one net written here: cifar10_quick's
layout (conv 5x5 pad 2, MAX pool 3x3 stride 2, ReLU, InnerProduct,
SoftmaxWithLoss, Accuracy at TEST) at a narrow width, MemoryData layers
of batch 8.  Both run ``--synthetic`` (the same seeded stand-in, mean and
feeds) for 20-40 iterations, on the Solver path and with ``--workers 2``
under ``local_sgd`` and ``sync``.  The weights are moved through a
``.caffemodel``: the JAX Solver or trainer writes its initial weights,
the port's reads them (the two packages draw their fillers from
different generators).  Every trajectory point (iteration, loss,
accuracy) the port prints and writes is within 1e-5 of the JAX tool's;
the JSON's other keys are equal.  Without ``--device cpu`` and without a
card the tool refuses to run.
"""

from __future__ import annotations

import json
import re

import jax
import numpy as np
import pytest
import torch

import sparknet_tpu.parallel as jax_parallel
import sparknet_tpu.solvers as jax_solvers
from sparknet_tpu.proto.caffemodel import save_caffemodel as jax_save
from sparknet_tpu.tools import train_cifar as jax_tool
from sparknet_tpu_torch.parallel import trainer as port_trainer
from sparknet_tpu_torch import solvers as port_solvers
from sparknet_tpu_torch.solvers.solver import load_weights_into
from sparknet_tpu_torch.tools import train_cifar

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
NET = """
name: "CIFAR10_quick_narrow"
layer {{ name: "cifar" type: "MemoryData" top: "data" top: "label"
  include {{ phase: TRAIN }}
  memory_data_param {{ batch_size: 8 channels: 3 height: 32 width: 32 }} }}
layer {{ name: "cifar" type: "MemoryData" top: "data" top: "label"
  include {{ phase: TEST }}
  memory_data_param {{ batch_size: 8 channels: 3 height: 32 width: 32 }} }}
layer {{ name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  param {{ lr_mult: 1 }} param {{ lr_mult: 2 }}
  convolution_param {{ num_output: 4 pad: 2 kernel_size: 5 stride: 1
    weight_filler {{ type: "gaussian" std: 0.01 }}
    bias_filler {{ type: "constant" }} }} }}
layer {{ name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
  pooling_param {{ pool: MAX kernel_size: 3 stride: 2 }} }}
layer {{ name: "relu1" type: "ReLU" bottom: "pool1" top: "pool1" }}
layer {{ name: "ip1" type: "InnerProduct" bottom: "pool1" top: "ip1"
  param {{ lr_mult: 1 }} param {{ lr_mult: 2 }}
  inner_product_param {{ num_output: 10
    weight_filler {{ type: "gaussian" std: 0.001 }}
    bias_filler {{ type: "constant" }} }} }}
layer {{ name: "accuracy" type: "Accuracy" bottom: "ip1" bottom: "label"
  top: "accuracy" include {{ phase: TEST }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip1" bottom: "label"
  top: "loss" }}
"""
SOLVER = """
net: "{net}"
test_iter: 5
test_interval: 10
base_lr: 0.0001
momentum: 0.9
weight_decay: 0.004
lr_policy: "fixed"
display: 5
max_iter: {max_iter}
"""


@pytest.fixture
def solver(tmp_path):
    (tmp_path / "net.prototxt").write_text(NET.format())
    path = tmp_path / "solver.prototxt"
    path.write_text(SOLVER.format(net=tmp_path / "net.prototxt",
                                  max_iter=20))
    return path


def _weights_through_caffemodel(monkeypatch, path):
    """The JAX Solver and trainer write their initial weights to
    ``path``; the port's read them."""

    class JaxSolver(jax_solvers.Solver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            jax_save(str(path), jax.device_get(self.params))

    class JaxTrainer(jax_parallel.DistributedTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            jax_save(str(path), jax.device_get(self.params))

    class PortSolver(port_solvers.Solver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.load_weights(str(path))

    class PortTrainer(port_trainer.DistributedTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.params = load_weights_into(self.train_net, self.params,
                                            str(path))

    monkeypatch.setattr(jax_solvers, "Solver", JaxSolver)
    monkeypatch.setattr(jax_parallel, "DistributedTrainer", JaxTrainer)
    monkeypatch.setattr(port_solvers, "Solver", PortSolver)
    monkeypatch.setattr(port_trainer, "DistributedTrainer", PortTrainer)


_POINT = re.compile(r"iter +(\d+) +t= *[\d.]+s +loss=(\S+) +acc=(\S+)")


def _printed(out: str) -> list[tuple[int, float, float]]:
    return [(int(i), float(l), float(a)) for i, l, a in _POINT.findall(out)]


def _run_both(monkeypatch, capsys, tmp_path, solver, extra):
    _weights_through_caffemodel(monkeypatch, tmp_path / "init.caffemodel")
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    jax_tool.main(["--solver", str(solver), "--synthetic",
                   "--out", str(jax_out)] + extra)
    theirs = _printed(capsys.readouterr().out)
    train_cifar.main(["--solver", str(solver), "--synthetic", "--device",
                      "cpu", "--out", str(port_out)] + extra)
    ours = _printed(capsys.readouterr().out)
    return ours, theirs, json.loads(port_out.read_text()), json.loads(
        jax_out.read_text())


def _assert_same_trajectory(ours, theirs, port_json, jax_json):
    assert ours and [p[0] for p in ours] == [p[0] for p in theirs]
    np.testing.assert_allclose([p[1:] for p in ours],
                               [p[1:] for p in theirs], rtol=TOL, atol=TOL)
    assert all(np.isfinite(p[1]) for p in ours)
    for key in ("net", "data", "batch", "max_iter", "workers", "strategy",
                "solver"):
        assert port_json[key] == jax_json[key], key
    assert [p["iter"] for p in port_json["points"]] == \
        [p["iter"] for p in jax_json["points"]]
    for field in ("loss", "accuracy"):
        np.testing.assert_allclose(
            [p[field] for p in port_json["points"]],
            [p[field] for p in jax_json["points"]], rtol=TOL, atol=1e-4)
    assert port_json["final_accuracy"] == port_json["points"][-1]["accuracy"]


def test_solver_path_tracks_the_jax_tool(monkeypatch, capsys, tmp_path,
                                         solver):
    ours, theirs, pj, jj = _run_both(monkeypatch, capsys, tmp_path, solver,
                                     ["--max-iter", "30"])
    _assert_same_trajectory(ours, theirs, pj, jj)
    assert [p[0] for p in ours] == [10, 20, 30]
    assert pj["strategy"] == "single"


@pytest.mark.parametrize("strategy", ["local_sgd", "sync"])
def test_two_workers_track_the_jax_tool(monkeypatch, capsys, tmp_path,
                                        solver, strategy):
    ours, theirs, pj, jj = _run_both(
        monkeypatch, capsys, tmp_path, solver,
        ["--workers", "2", "--strategy", strategy, "--tau", "5"])
    _assert_same_trajectory(ours, theirs, pj, jj)
    assert pj["workers"] == 2 and pj["strategy"] == strategy


def test_cifar_binaries_through_data_dir(tmp_path, solver):
    from sparknet_tpu_torch.data import write_cifar10_binary
    rng = np.random.default_rng(0)
    d = tmp_path / "cifar"
    d.mkdir()
    for name, n in (("data_batch_1.bin", 48), ("data_batch_2.bin", 48),
                    ("test_batch.bin", 40)):
        write_cifar10_binary(str(d / name),
                             rng.integers(0, 256, (n, 3, 32, 32)),
                             rng.integers(0, 10, n))
    traj = train_cifar.main(["--solver", str(solver), "--data-dir", str(d),
                             "--device", "cpu", "--max-iter", "10",
                             "--out", str(tmp_path / "t.json")])
    assert traj["data"] == "cifar10"
    assert traj["published_band"] == [0.71, 0.75]
    assert [p["iter"] for p in traj["points"]] == [10]


def test_refuses_to_leave_the_card_unasked(monkeypatch, tmp_path, solver):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cifar.main(["--solver", str(solver), "--synthetic",
                          "--max-iter", "5", "--out",
                          str(tmp_path / "t.json")])


def test_without_data_asks_for_synthetic(solver):
    with pytest.raises(SystemExit, match="--synthetic"):
        train_cifar.main(["--solver", str(solver), "--device", "cpu"])
