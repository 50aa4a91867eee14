"""The port's ``caffe_cli``, ``compute_image_mean``, ``extract_features``
and ``time_net`` against the JAX package's tools, on the CPU
(``--device cpu``).

The net is tests/test_tools.py:72-92's (a ``Data`` layer over an LMDB of
twelve 3x8x8 images, batch 4, an InnerProduct of 3, SoftmaxWithLoss at
TRAIN and Accuracy at TEST); the LMDB is written with ``write_lmdb`` from
seeded arrays.  Both CLIs start from one ``.caffemodel`` (``--weights``,
Caffe's finetune path) drawn by the port.

- ``train`` then ``test`` on the snapshot: every ``Iteration N, loss =``
  and ``Test net output`` value, and ``test``'s scores, equal the JAX
  CLI's within 1e-4 relative.
- ``--snapshot`` resume from the port's ``.solverstate``: the same
  resumed losses as the JAX CLI resuming from that file.
- ``--devices 2`` with ``sync`` and with ``local_sgd`` at τ 2: the
  round losses and test outputs of the JAX CLI on its 2-device virtual
  CPU mesh, within 1e-4 relative; the npz snapshot resumes.
- ``time`` and ``device_query`` run; without CUDA ``device_query`` says
  so and exits 1, and every action without ``--device cpu`` raises
  instead of running on the CPU.
- ``compute_image_mean`` writes the JAX tool's binaryproto byte for
  byte; ``extract_features`` writes records equal to the net's blob.
- Refusals name their ROADMAP item: an encoded Datum and ImageData/
  WindowData/HDF5Data (A15, A6), ``backend: RECORDS`` (A6),
  ``--strategy hierarchical`` (A5), ``--hosts`` (A12), ``time_net
  --trace`` (A13).
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from sparknet_tpu.tools import caffe_cli as jax_cli
from sparknet_tpu.tools import compute_image_mean as jax_mean
from sparknet_tpu_torch.data.db import array_to_datum, datum_to_array, \
    open_db
from sparknet_tpu_torch.data.lmdb_io import write_lmdb
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.proto import (NetState, Phase, load_net_prototxt,
                                      save_caffemodel)
from sparknet_tpu_torch.tools import caffe_cli, compute_image_mean, \
    extract_features, time_net

REL = 1e-4
NET = """
name: "toolnet"
layer {{ name: "data" type: "Data" top: "data" top: "label"
        data_param {{ source: "{db}" batch_size: 4 backend: LMDB }} }}
layer {{ name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
        inner_product_param {{ num_output: 3
                              weight_filler {{ type: "xavier" }} }} }}
layer {{ name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
        top: "loss" include {{ phase: TRAIN }} }}
layer {{ name: "acc" type: "Accuracy" bottom: "ip" bottom: "label"
        top: "acc" include {{ phase: TEST }} }}
"""
SOLVER = """
net: "{model}"
base_lr: 0.01
momentum: 0.9
lr_policy: "fixed"
max_iter: {max_iter}
display: {display}
test_iter: 2
test_interval: {test_interval}
snapshot_prefix: "{prefix}"
snapshot: {snapshot}
"""


@pytest.fixture(scope="module")
def tool(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(12, 3, 8, 8)).astype(np.uint8)
    write_lmdb(str(d / "train_lmdb"),
               [(b"%08d" % i, array_to_datum(imgs[i], i % 3))
                for i in range(12)])
    model = d / "net.prototxt"
    model.write_text(NET.format(db=d / "train_lmdb"))
    net = Net(load_net_prototxt(str(model)), NetState(Phase.TRAIN))
    params = net.init(torch.Generator().manual_seed(7), device="cpu")
    save_caffemodel(str(d / "init.caffemodel"), params)
    return d, model, imgs


def _solver(d, model, name, max_iter=6, display=1, test_interval=3,
            snapshot=3):
    path = d / f"{name}.prototxt"
    path.write_text(SOLVER.format(model=model, max_iter=max_iter,
                                  display=display,
                                  test_interval=test_interval,
                                  prefix=d / name, snapshot=snapshot))
    return str(path)


def _numbers(out: str) -> dict[str, list[float]]:
    """Every logged train loss (by iteration) and test output value."""
    got: dict[str, list[float]] = {"loss": [], "test": []}
    for m in re.finditer(r"Iteration (\d+), loss = ([-\d.e+]+)", out):
        got["loss"].append((int(m.group(1)), float(m.group(2))))
    for m in re.finditer(r"Test net output: (\S+) = ([-\d.e+]+)", out):
        got["test"].append((m.group(1), float(m.group(2))))
    return got


def _assert_same_numbers(ours: str, theirs: str):
    a, b = _numbers(ours), _numbers(theirs)
    assert a["loss"] and a["test"], ours
    for key in ("loss", "test"):
        assert [x for x, _ in a[key]] == [x for x, _ in b[key]], key
        np.testing.assert_allclose([v for _, v in a[key]],
                                   [v for _, v in b[key]], rtol=REL,
                                   err_msg=key)


def _run(capsys, main, argv) -> str:
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def test_train_then_test_match_the_jax_cli(tool, capsys):
    d, model, _ = tool
    init = str(d / "init.caffemodel")
    ours = _run(capsys, caffe_cli.main,
                ["train", "--solver", _solver(d, model, "p"), "--weights",
                 init, "--device", "cpu"])
    theirs = _run(capsys, jax_cli.main,
                  ["train", "--solver", _solver(d, model, "j"), "--weights",
                   init])
    assert "Finetuning from" in ours and "Optimization Done." in ours
    assert "Train feed: " in ours
    _assert_same_numbers(ours, theirs)
    assert os.path.exists(d / "p_iter_6.caffemodel")
    # test on the port's snapshot, in both CLIs
    argv = ["test", "--model", str(model), "--weights",
            str(d / "p_iter_6.caffemodel"), "--iterations", "3"]
    ours = _run(capsys, caffe_cli.main, argv + ["--device", "cpu"])
    theirs = _run(capsys, jax_cli.main, argv)
    pat = r"^acc = ([\d.]+)$"
    want = float(re.search(pat, theirs, re.M).group(1))
    assert float(re.search(pat, ours, re.M).group(1)) == \
        pytest.approx(want, rel=REL)
    assert ours.count("Batch ") == 3


def test_snapshot_resume_matches_the_jax_cli(tool, capsys):
    d, model, _ = tool
    _run(capsys, caffe_cli.main,
         ["train", "--solver", _solver(d, model, "r", max_iter=3),
          "--weights", str(d / "init.caffemodel"), "--device", "cpu"])
    state = str(d / "r_iter_3.solverstate")
    solver = _solver(d, model, "resume")
    ours = _run(capsys, caffe_cli.main, ["train", "--solver", solver,
                                         "--snapshot", state,
                                         "--device", "cpu"])
    theirs = _run(capsys, jax_cli.main, ["train", "--solver", solver,
                                         "--snapshot", state])
    assert "Resuming from" in ours and "(iter 3)" in ours
    assert [i for i, _ in _numbers(ours)["loss"]][0] == 4
    _assert_same_numbers(ours, theirs)


@pytest.mark.parametrize("strategy,tau", [("sync", 1), ("local_sgd", 2)])
def test_two_workers_match_the_jax_mesh(tool, capsys, strategy, tau):
    d, model, _ = tool
    args = ["--devices", "2", "--strategy", strategy, "--tau", str(tau),
            "--weights", str(d / "init.caffemodel")]
    kw = dict(max_iter=4, display=1, test_interval=2, snapshot=0)
    ours = _run(capsys, caffe_cli.main,
                ["train", "--solver", _solver(d, model, f"m{strategy}", **kw)]
                + args + ["--device", "cpu"])
    theirs = _run(capsys, jax_cli.main,
                  ["train", "--solver", _solver(d, model, f"jm{strategy}",
                                                **kw)] + args)
    assert f"strategy={strategy}" in ours and "2 workers" in ours
    _assert_same_numbers(ours, theirs)
    snap = d / f"m{strategy}_iter_4.npz"
    assert snap.exists()
    resumed = _run(capsys, caffe_cli.main,
                   ["train", "--solver", _solver(d, model, f"m{strategy}",
                                                 **dict(kw, max_iter=6)),
                    "--devices", "2", "--strategy", strategy, "--tau",
                    str(tau), "--snapshot", str(snap), "--device", "cpu"])
    assert "(iter 4)" in resumed and "Iteration 6" in resumed


def test_time_and_device_query(tool, capsys):
    d, model, _ = tool
    out = _run(capsys, caffe_cli.main, ["time", "--model", str(model),
                                        "--iterations", "2", "--per-layer",
                                        "--device", "cpu"])
    assert "Average Forward pass" in out and "Average Forward-Backward" in out
    assert re.search(r"^ip\s+InnerProduct", out, re.M)
    res = time_net.time_net(load_net_prototxt(str(model)), iterations=1,
                            device="cpu")
    assert res["forward_ms"] > 0 and res["forward_backward_ms"] > 0
    if torch.cuda.is_available():
        pytest.skip("device_query's refusal needs a machine without CUDA")
    capsys.readouterr()
    assert caffe_cli.main(["device_query"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_no_cuda_raises_instead_of_using_the_cpu(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    d, model, _ = tool
    for argv in (["train", "--solver", _solver(d, model, "nocuda")],
                 ["test", "--model", str(model), "--iterations", "1"],
                 ["time", "--model", str(model), "--iterations", "1"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            caffe_cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract_features.main([str(d / "init.caffemodel"), str(model), "ip",
                               str(tmp_path / "f"), "1"])


def test_compute_image_mean_equals_the_jax_tool(tool, capsys):
    d, _, imgs = tool
    ours, theirs = str(d / "mean_p.binaryproto"), str(d / "mean_j.binaryproto")
    assert compute_image_mean.main([str(d / "train_lmdb"), ours]) == 0
    assert jax_mean.main([str(d / "train_lmdb"), theirs]) == 0
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(
        compute_image_mean.compute_mean(str(d / "train_lmdb")),
        imgs.astype(np.float64).mean(0).astype(np.float32))


def test_extract_features_records_equal_the_blob(tool, tmp_path):
    d, model, imgs = tool
    weights = str(d / "init.caffemodel")
    out_db = str(tmp_path / "feat_lmdb")
    assert extract_features.main([weights, str(model), "ip", out_db, "2",
                                  "--device", "cpu"]) == 0
    net = Net(load_net_prototxt(str(model)), NetState(Phase.TEST))
    from sparknet_tpu_torch.proto import load_caffemodel
    params = {k: [torch.from_numpy(np.array(b)) for b in v]
              for k, v in load_caffemodel(weights).items()}
    x = torch.from_numpy(imgs[:8].astype(np.float32))
    with torch.no_grad():
        want = net.apply(params, {"data": x, "label": torch.zeros(8)},
                         blobs=["ip"])["ip"].numpy()
    with open_db(out_db, "LMDB") as r:
        recs = list(r.items())
    assert [k for k, _ in recs] == [b"%010d" % i for i in range(8)]
    got = np.stack([datum_to_array(v)[0].reshape(-1) for _, v in recs])
    np.testing.assert_array_equal(got, want)


def _encoded_db(path):
    from sparknet_tpu_torch.proto.textformat import PMessage
    from sparknet_tpu_torch.proto.wireformat import encode
    m = PMessage()
    for k, v in (("channels", 3), ("height", 0), ("width", 0),
                 ("data", b"\xff\xd8\xff\xe0"), ("encoded", True)):
        m.add(k, v)
    write_lmdb(path, [(b"00000000", encode(m, "Datum"))])


@pytest.mark.parametrize("case,item", [
    ("encoded", "ROADMAP A15"), ("records", "ROADMAP A6, records"),
    ("ImageData", "ROADMAP A15"), ("WindowData", "ROADMAP A15"),
    ("HDF5Data", "ROADMAP A6, HDF5"), ("hierarchical", "ROADMAP A5"),
    ("hosts", "ROADMAP A12")])
def test_refusals_name_their_item(tool, tmp_path, case, item):
    d, model, _ = tool
    extra = []
    if case == "encoded":
        _encoded_db(str(tmp_path / "enc"))
        model = tmp_path / "enc.prototxt"
        model.write_text(NET.format(db=tmp_path / "enc"))
    elif case == "records":
        model = tmp_path / "rec.prototxt"
        model.write_text(NET.format(db=d / "train_lmdb").replace(
            "backend: LMDB", "backend: RECORDS"))
    elif case in ("ImageData", "WindowData", "HDF5Data"):
        model = tmp_path / "img.prototxt"
        model.write_text(NET.format(db=d / "train_lmdb").replace(
            'type: "Data"', f'type: "{case}"'))
    elif case == "hierarchical":
        extra = ["--devices", "2", "--strategy", "hierarchical"]
    else:
        extra = ["--devices", "2", "--hosts", "2"]
    with pytest.raises(NotImplementedError, match=item):
        caffe_cli.main(["train", "--solver",
                        _solver(tmp_path, model, "refused"), "--device",
                        "cpu"] + extra)


def test_time_net_trace_names_a13():
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        time_net.main(["--model", "lenet", "--trace", "--device", "cpu"])
