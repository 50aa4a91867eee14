"""The slice as a whole on the CPU: Caffe's mnist_siamese and
mnist_autoencoder examples trained through the port's
``caffe_cli.main(["train", ..., "--device", "cpu"])`` and the JAX
package's ``caffe_cli`` from one ``.caffemodel`` on the same in-repo
LevelDB and LMDB.

The nets are the published prototxt, transcribed below with their widths
as fields; the tests run them narrow (siamese 4/6/16/4/2 in place of
20/50/500/10/2, the autoencoder 784-64-32-16-4-16-32-64-784 in place of
784-1000-500-250-30-250-500-1000-784) on synthetic 28x28 digits: ten
class templates plus noise, drawn from a seed (real MNIST is not in the
repository).  Every logged training loss and test output agrees at 1e-4
relative (the bound of tests/test_torch_caffe_cli.py), and the final
``.caffemodel``s blob for blob at rtol 2e-4, atol 2e-5 (that of
tests/test_torch_solver.py), each sharer carrying its owner's blobs.
``caffe_cli test`` on the siamese snapshot gives the last test pass's
loss.  The published autoencoder solver's two ``test_state`` stages
(``test-on-train``, ``test-on-test``) run in the port as two test nets,
each on its own database; the JAX Solver builds one TEST net without
stages, whose data layers the stages exclude (ROADMAP C).
"""

from __future__ import annotations

import re
import string

import numpy as np
import pytest
import torch

from sparknet_tpu.tools import caffe_cli as jax_cli
from sparknet_tpu_torch.data.db import array_to_datum, db_feed
from sparknet_tpu_torch.data.leveldb_io import write_leveldb
from sparknet_tpu_torch.data.lmdb_io import write_lmdb
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.proto import (NetState, Phase, load_caffemodel,
                                      load_net_prototxt, save_caffemodel)
from sparknet_tpu_torch.tools import caffe_cli
from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-4
RTOL, ATOL = 2e-4, 2e-5


def _siamese_branch(s: str, bottom: str) -> str:
    def param(name, lr):
        return f'param {{ name: "{name}" lr_mult: {lr} }}'

    def fillers():
        return ('weight_filler { type: "xavier" } '
                'bias_filler { type: "constant" }')
    return f"""
layer {{ name: "conv1{s}" type: "Convolution" bottom: "{bottom}"
  top: "conv1{s}" {param("conv1_w", 1)} {param("conv1_b", 2)}
  convolution_param {{ num_output: $conv1 kernel_size: 5 stride: 1
    {fillers()} }} }}
layer {{ name: "pool1{s}" type: "Pooling" bottom: "conv1{s}" top: "pool1{s}"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "conv2{s}" type: "Convolution" bottom: "pool1{s}"
  top: "conv2{s}" {param("conv2_w", 1)} {param("conv2_b", 2)}
  convolution_param {{ num_output: $conv2 kernel_size: 5 stride: 1
    {fillers()} }} }}
layer {{ name: "pool2{s}" type: "Pooling" bottom: "conv2{s}" top: "pool2{s}"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "ip1{s}" type: "InnerProduct" bottom: "pool2{s}"
  top: "ip1{s}" {param("ip1_w", 1)} {param("ip1_b", 2)}
  inner_product_param {{ num_output: $ip1 {fillers()} }} }}
layer {{ name: "relu1{s}" type: "ReLU" bottom: "ip1{s}" top: "ip1{s}" }}
layer {{ name: "ip2{s}" type: "InnerProduct" bottom: "ip1{s}" top: "ip2{s}"
  {param("ip2_w", 1)} {param("ip2_b", 2)}
  inner_product_param {{ num_output: $ip2 {fillers()} }} }}
layer {{ name: "feat{s}" type: "InnerProduct" bottom: "ip2{s}"
  top: "feat{s}" {param("feat_w", 1)} {param("feat_b", 2)}
  inner_product_param {{ num_output: 2 {fillers()} }} }}
"""


# Caffe's examples/siamese/mnist_siamese_train_test.prototxt (BVLC
# caffe, master): a LevelDB of 2-channel pair Datums, sliced into the two
# branches, which share every blob by name, then ContrastiveLoss
SIAMESE_NET = string.Template("""
name: "mnist_siamese_train_test"
layer { name: "pair_data" type: "Data" top: "pair_data" top: "sim"
  include { phase: TRAIN } transform_param { scale: 0.00390625 }
  data_param { source: "$train" batch_size: $batch } }
layer { name: "pair_data" type: "Data" top: "pair_data" top: "sim"
  include { phase: TEST } transform_param { scale: 0.00390625 }
  data_param { source: "$test" batch_size: $test_batch } }
layer { name: "slice_pair" type: "Slice" bottom: "pair_data"
  top: "data" top: "data_p" slice_param { slice_dim: 1 slice_point: 1 } }
""" + _siamese_branch("", "data") + _siamese_branch("_p", "data_p") + """
layer { name: "loss" type: "ContrastiveLoss" bottom: "feat"
  bottom: "feat_p" bottom: "sim" top: "loss"
  contrastive_loss_param { margin: 1 } }
""")
# examples/siamese/mnist_siamese_solver.prototxt, cut in iterations
SIAMESE_SOLVER = string.Template("""
net: "$net"
test_iter: $test_iter
test_interval: $test_interval
base_lr: 0.01
momentum: 0.9
weight_decay: 0.0000
lr_policy: "inv"
gamma: 0.0001
power: 0.75
display: 1
max_iter: $max_iter
snapshot: $max_iter
snapshot_prefix: "$prefix"
""")
PUBLISHED_SIAMESE = {"batch": 64, "test_batch": 100, "conv1": 20,
                     "conv2": 50, "ip1": 500, "ip2": 10}
NARROW_SIAMESE = {"batch": 8, "test_batch": 4, "conv1": 4, "conv2": 6,
                  "ip1": 16, "ip2": 4}


def siamese_net(train: str, test: str, **widths) -> str:
    return SIAMESE_NET.substitute(train=train, test=test,
                                  **{**PUBLISHED_SIAMESE, **widths})


def _autoencoder_data(stages: bool) -> str:
    """The data layers: the published TEST pair, one a ``test_state``
    stage, or (``stages=False``) one TEST layer on the test set."""
    test = [("test-on-train", "$train"), ("test-on-test", "$test")] \
        if stages else [(None, "$test")]
    out = ["""
layer { name: "data" type: "Data" top: "data" include { phase: TRAIN }
  transform_param { scale: 0.0039215684 }
  data_param { source: "$train" batch_size: $batch backend: LMDB } }"""]
    for stage, src in test:
        rule = f' stage: "{stage}"' if stage else ""
        out.append(f"""
layer {{ name: "data" type: "Data" top: "data"
  include {{ phase: TEST{rule} }}
  transform_param {{ scale: 0.0039215684 }}
  data_param {{ source: "{src}" batch_size: $batch backend: LMDB }} }}""")
    return "".join(out)


def _ip(name: str, bottom: str, width: str) -> str:
    return f"""
layer {{ name: "{name}" type: "InnerProduct" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 1 decay_mult: 1 }} param {{ lr_mult: 1 decay_mult: 0 }}
  inner_product_param {{ num_output: {width}
    weight_filler {{ type: "gaussian" std: 1 sparse: 15 }}
    bias_filler {{ type: "constant" value: 0 }} }} }}"""


def _sigmoid(name: str) -> str:
    return (f'\nlayer {{ name: "{name}neuron" type: "Sigmoid" '
            f'bottom: "{name}" top: "{name}neuron" }}')


_CODER = [("encode1", "data", "$w1"), ("encode2", "encode1neuron", "$w2"),
          ("encode3", "encode2neuron", "$w3"),
          ("encode4", "encode3neuron", "$w4"),
          ("decode4", "encode4", "$w3"), ("decode3", "decode4neuron", "$w2"),
          ("decode2", "decode3neuron", "$w1"),
          ("decode1", "decode2neuron", "784")]
# Caffe's examples/mnist/mnist_autoencoder.prototxt (BVLC caffe, master):
# 784-1000-500-250-30 encoder, mirrored decoder, Sigmoid between layers
# (none after encode4), SigmoidCrossEntropyLoss, and EuclideanLoss on the
# reconstruction at loss_weight 0
AUTOENCODER_LAYERS = """
layer { name: "flatdata" type: "Flatten" bottom: "data" top: "flatdata" }
""" + "".join(_ip(n, b, w) + ("" if n in ("encode4", "decode1")
                              else _sigmoid(n)) for n, b, w in _CODER) + """
layer { name: "loss" type: "SigmoidCrossEntropyLoss" bottom: "decode1"
  bottom: "flatdata" top: "cross_entropy_loss" loss_weight: 1 }
layer { name: "decode1neuron" type: "Sigmoid" bottom: "decode1"
  top: "decode1neuron" }
layer { name: "loss" type: "EuclideanLoss" bottom: "decode1neuron"
  bottom: "flatdata" top: "l2_error" loss_weight: 0 }
"""
# examples/mnist/mnist_autoencoder_solver.prototxt, cut in iterations
AUTOENCODER_SOLVER = string.Template("""
net: "$net"
$test_states
test_interval: $test_interval
base_lr: 0.01
lr_policy: "step"
gamma: 0.1
stepsize: 10000
display: 1
max_iter: $max_iter
weight_decay: 0.0005
snapshot: $max_iter
snapshot_prefix: "$prefix"
momentum: 0.9
""")
PUBLISHED_AUTOENCODER = {"batch": 100, "w1": 1000, "w2": 500, "w3": 250,
                         "w4": 30}
NARROW_AUTOENCODER = {"batch": 4, "w1": 64, "w2": 32, "w3": 16, "w4": 4}


def autoencoder_net(train: str, test: str, stages: bool = True,
                    **widths) -> str:
    return string.Template(
        'name: "MNISTAutoencoder"' + _autoencoder_data(stages)
        + AUTOENCODER_LAYERS).substitute(
            train=train, test=test, **{**PUBLISHED_AUTOENCODER, **widths})


def digits(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` synthetic 28x28 uint8 digits and their classes: one smooth
    template a class, drawn from ``seed``, plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(10, 7, 7))
    templates = np.kron(base, np.ones((4, 4)))           # 28x28 blocks
    labels = rng.integers(0, 10, size=n)
    x = 200.0 * templates[labels] + rng.normal(0.0, 25.0, size=(n, 28, 28))
    return np.clip(x, 0, 255).astype(np.uint8), labels


def write_pairs(path: str, n: int, seed: int) -> None:
    """A LevelDB of ``n`` 2x28x28 pair Datums, half of them one class,
    label 1 for a same-class pair (examples/siamese/
    convert_mnist_siamese_data.cpp's layout)."""
    imgs, labels = digits(2 * n, seed)
    rng = np.random.default_rng(seed + 1)
    items = []
    for i in range(n):
        a = i
        same = rng.random() < 0.5
        pool = np.flatnonzero((labels == labels[a]) == same)
        pool = pool[pool != a]
        if not len(pool):                  # a class of one
            pool = np.flatnonzero(labels != labels[a])
        b = int(rng.choice(pool))
        pair = np.stack([imgs[a], imgs[b]])
        items.append((b"%08d" % i,
                      array_to_datum(pair, int(labels[a] == labels[b]))))
    write_leveldb(path, items)


def write_digits(path: str, n: int, seed: int) -> None:
    imgs, labels = digits(n, seed)
    write_lmdb(path, [(b"%08d" % i, array_to_datum(imgs[i][None],
                                                   int(labels[i])))
                      for i in range(n)])


def _numbers(out: str) -> dict:
    got = {"loss": [], "test": []}
    for m in re.finditer(r"Iteration (\d+), loss = ([-\d.e+]+)", out):
        got["loss"].append((int(m.group(1)), float(m.group(2))))
    for m in re.finditer(r"Test net( #\d)? output: (\S+) = ([-\d.e+]+)",
                         out):
        got["test"].append(((m.group(1) or "").strip() + m.group(2),
                            float(m.group(3))))
    return got


def _run(capsys, main, argv) -> str:
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _same_numbers(ours: str, theirs: str) -> dict:
    a, b = _numbers(ours), _numbers(theirs)
    assert a["loss"] and a["test"], ours
    for key in ("loss", "test"):
        assert [x for x, _ in a[key]] == [x for x, _ in b[key]], key
        np.testing.assert_allclose([v for _, v in a[key]],
                                   [v for _, v in b[key]], rtol=REL,
                                   err_msg=key)
    return a


def _init_weights(path: str, text: str) -> None:
    """The port's draw of the net, written as Caffe writes a model: every
    layer with its full blob list."""
    net = Net(load_net_prototxt(text), NetState(Phase.TRAIN))
    params = net.init(torch.Generator().manual_seed(7), device="cpu")
    save_caffemodel(path, net.full_params(params))


def _same_models(ours: str, theirs: str) -> None:
    a, b = load_caffemodel(ours), load_caffemodel(theirs)
    assert sorted(a) == sorted(b)
    for k in b:
        assert len(a[k]) == len(b[k]), k
        for x, y in zip(a[k], b[k]):
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    write_pairs(str(d / "pairs_train_leveldb"), 48, 0)
    write_pairs(str(d / "pairs_test_leveldb"), 16, 10)
    write_digits(str(d / "digits_train_lmdb"), 24, 20)
    write_digits(str(d / "digits_test_lmdb"), 12, 30)
    return d


def test_the_pair_database_holds_labelled_pairs(dbs):
    lp = load_net_prototxt(siamese_net(
        str(dbs / "pairs_train_leveldb"), "x", **NARROW_SIAMESE)).layer[0]
    batch = next(db_feed(lp, Phase.TRAIN))
    assert batch["pair_data"].shape == (8, 2, 28, 28)
    assert batch["pair_data"].max() <= 1.0
    assert set(np.unique(batch["sim"])) == {0.0, 1.0}


def _siamese_files(d, name, max_iter=6):
    net = d / f"{name}_siamese.prototxt"
    net.write_text(siamese_net(str(d / "pairs_train_leveldb"),
                               str(d / "pairs_test_leveldb"),
                               **NARROW_SIAMESE))
    solver = d / f"{name}_siamese_solver.prototxt"
    solver.write_text(SIAMESE_SOLVER.substitute(
        net=net, test_iter=2, test_interval=3, max_iter=max_iter,
        prefix=d / f"{name}_siamese"))
    return str(net), str(solver)


def test_siamese_cli_train_and_test_track_the_jax_cli(dbs, capsys):
    init = str(dbs / "siamese_init.caffemodel")
    net, solver = _siamese_files(dbs, "p")
    _init_weights(init, open(net).read())
    ours = _run(capsys, caffe_cli.main, ["train", "--solver", solver,
                                         "--weights", init, "--device",
                                         "cpu"])
    _, jsolver = _siamese_files(dbs, "j")
    theirs = _run(capsys, jax_cli.main, ["train", "--solver", jsolver,
                                         "--weights", init])
    got = _same_numbers(ours, theirs)
    assert sorted({i for i, _ in got["loss"]}) == [1, 2, 3, 4, 5, 6]
    model = str(dbs / "p_siamese_iter_6.caffemodel")
    _same_models(model, str(dbs / "j_siamese_iter_6.caffemodel"))
    saved = load_caffemodel(model)
    for layer in ("conv1", "conv2", "ip1", "ip2", "feat"):
        for a, b in zip(saved[layer], saved[layer + "_p"]):
            assert a.tobytes() == b.tobytes()
    # caffe_cli test on the snapshot: the last test pass's loss
    scored = _run(capsys, caffe_cli.main, ["test", "--model", net,
                                           "--weights", model,
                                           "--iterations", "2",
                                           "--device", "cpu"])
    last = got["test"][-1][1]
    loss = float(re.search(r"^loss = ([-\d.e+]+)$", scored, re.M).group(1))
    assert loss == pytest.approx(last, rel=REL)


def _autoencoder_files(d, name, stages, max_iter=4):
    net = d / f"{name}_ae.prototxt"
    net.write_text(autoencoder_net(str(d / "digits_train_lmdb"),
                                   str(d / "digits_test_lmdb"), stages,
                                   **NARROW_AUTOENCODER))
    states = ('test_state: { stage: "test-on-train" }\ntest_iter: 3\n'
              'test_state: { stage: "test-on-test" }\ntest_iter: 2'
              if stages else "test_iter: 2")
    solver = d / f"{name}_ae_solver.prototxt"
    solver.write_text(AUTOENCODER_SOLVER.substitute(
        net=net, test_states=states, test_interval=2, max_iter=max_iter,
        prefix=d / f"{name}_ae"))
    return str(net), str(solver)


def test_autoencoder_cli_tracks_the_jax_cli(dbs, capsys):
    init = str(dbs / "ae_init.caffemodel")
    net, solver = _autoencoder_files(dbs, "p", stages=False)
    _init_weights(init, open(net).read())
    ours = _run(capsys, caffe_cli.main, ["train", "--solver", solver,
                                         "--weights", init, "--device",
                                         "cpu"])
    _, jsolver = _autoencoder_files(dbs, "j", stages=False)
    theirs = _run(capsys, jax_cli.main, ["train", "--solver", jsolver,
                                         "--weights", init])
    got = _same_numbers(ours, theirs)
    names = {k for k, _ in got["test"]}
    assert names == {"cross_entropy_loss", "l2_error"}
    _same_models(str(dbs / "p_ae_iter_4.caffemodel"),
                 str(dbs / "j_ae_iter_4.caffemodel"))


def _test_outputs(net_text, state, src_layer, params, iters):
    """Each output's mean over ``iters`` batches of a TEST net in
    ``state`` fed from its own data layer (the expected test pass)."""
    net = Net(load_net_prototxt(net_text), state)
    feed = db_feed(src_layer, Phase.TEST)
    sums = {}
    with torch.no_grad():
        for _ in range(iters):
            b = {k: torch.from_numpy(v) for k, v in next(feed).items()}
            for k, v in net.forward(params, b).blobs.items():
                sums[k] = sums.get(k, 0.0) + float(v)
    feed.close()
    return {k: v / iters for k, v in sums.items()}


def test_autoencoder_test_stages_are_two_test_nets_on_their_own_data(
        dbs, capsys):
    from sparknet_tpu_torch.solvers.solver import load_weights_into
    init = str(dbs / "ae_staged_init.caffemodel")
    net, solver = _autoencoder_files(dbs, "s", stages=True, max_iter=2)
    text = open(net).read()
    _init_weights(init, text)
    out = _run(capsys, caffe_cli.main, ["train", "--solver", solver,
                                        "--weights", init, "--device",
                                        "cpu"])
    got = _numbers(out)
    first = {k: v for k, v in got["test"][:4]}
    assert sorted(first) == ["#0cross_entropy_loss", "#0l2_error",
                             "#1cross_entropy_loss", "#1l2_error"]
    assert "WARNING" not in out
    layers = [lp for lp in load_net_prototxt(text).layer
              if lp.type == "Data"]
    for i, (stage, lp, iters) in enumerate((("test-on-train", layers[1], 3),
                                            ("test-on-test", layers[2], 2))):
        state = NetState(Phase.TEST, stage=[stage])
        tnet = Net(load_net_prototxt(text), state)
        params = load_weights_into(
            tnet, tnet.init(torch.Generator(), device="cpu"), init)
        want = _test_outputs(text, state, lp, params, iters)
        for k, v in want.items():
            assert first[f"#{i}{k}"] == pytest.approx(v, rel=REL), (stage, k)
    assert first["#0cross_entropy_loss"] != first["#1cross_entropy_loss"]


def test_a_test_state_for_each_test_net_is_required():
    from sparknet_tpu_torch.proto import load_solver_prototxt
    from sparknet_tpu_torch.solvers.solver import _test_net_specs
    sp = load_solver_prototxt(
        'test_state: { stage: "a" }\ntest_iter: 1\nbase_lr: 0.1\n')
    net = load_net_prototxt(autoencoder_net("t", "s", **NARROW_AUTOENCODER))
    two = load_net_prototxt(autoencoder_net("t", "s", **NARROW_AUTOENCODER))
    sp.test_net_param = [net, two]
    with pytest.raises(ValueError, match="test_state"):
        _test_net_specs(sp, net)
    sp.test_net_param = []
    ((p, state),) = _test_net_specs(sp, net)
    assert p is net and state.stage == ["a"] and state.phase == Phase.TEST
