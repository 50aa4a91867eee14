"""The port's ``Solver`` against the JAX package's, on the CPU, with the
weights moved through a ``.caffemodel``.

- Solver against Solver: the JAX ``Solver`` writes its initial weights as
  a ``.caffemodel``, the port's ``Solver.load_weights`` reads them (bit
  for bit), and both run 30 steps of each of Caffe's six rules on
  cifar10_quick from the in-repo builder (batch 8) on the same numpy
  batches (unit-scale images whose class shows in one row).  Per-step
  losses agree at rtol 2e-4, atol 2e-5, the trainer tests' bound
  (tests/test_torch_trainer.py:6): the two frameworks sum convolutions
  and products in other orders, and the differences grow over the steps.
  AdaGrad needs rtol 2e-3: its first step moves every weight by about
  base_lr x sign(g), so gradients that are rounding noise around zero
  take full-size steps, and each package's f32 run ends up 2.9e-4 (the
  port) and 5.5e-4 (the JAX package) from an f64 run of the port on
  these batches.
  The batches are unit-scale: at pixel scale (std 30, random labels) the
  30-step trajectory is ill-conditioned, and an f32 run of either
  package drifts 1.6e-4 to 3.2e-4 from an f64 run of the port, so a
  comparison there measures the conditioning, not the port.
- The kernel-holding path: SGD with CaffeNet's solver on the narrow
  CaffeNet of tests/test_torch_net.py (Dropout at ratio 0; the plain
  B1/B3/B5 on the CPU), and its ``test()`` pass (plain B2), at the same
  bound.
- Resume: Caffe-format snapshot, restore into a fresh Solver, continue:
  equal to the uninterrupted run (the fork of tests/test_wireformat.py:
  199-223, the Dropout generator's state carried across); snapshots of
  either package restore into the other's Solver with params and history
  bit for bit.
- Serving: ``ModelHouse.load(name, weights=)`` serves the JAX engine's
  probabilities for the same ``.caffemodel`` (rtol 1e-4, atol 1e-6, the
  serving tests' bound).
- HDF5 weights and snapshots (``snapshot_format: HDF5``) write and
  restore bit for bit; across the two packages: tests/test_torch_hdf5.py.
- Refusals: a history one blob short, a transposed weight and a file
  without weights raise.  A V0 net and a shared param load, and
  ``set_augment`` takes a spec and ``None`` (its parity:
  tests/test_torch_augment.py).
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from sparknet_tpu.models import cifar10_quick as jax_quick
from sparknet_tpu.models import lenet as jax_lenet
from sparknet_tpu.parallel.serving import ModelHouse as JaxModelHouse
from sparknet_tpu.parallel.serving import ServeConfig as JaxServeConfig
from sparknet_tpu.proto import caffemodel as jax_cm
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_sp
from sparknet_tpu.solvers import Solver as JaxSolver
from sparknet_tpu_torch.models import cifar10_quick, lenet
from sparknet_tpu_torch.parallel.serving import ModelHouse, ServeConfig
from sparknet_tpu_torch.proto import (load_caffemodel, load_net_prototxt,
                                      load_solver_prototxt,
                                      load_solver_prototxt_with_net,
                                      load_solverstate, save_caffemodel,
                                      save_solverstate)
from sparknet_tpu_torch.solvers import Solver
from test_torch_net import NARROW_CAFFENET

RTOL, ATOL = 2e-4, 2e-5
BATCH = 8
STEPS = 30
RULE_SOLVERS = {
    "SGD": ('type: "SGD"\nbase_lr: 0.001\nmomentum: 0.9\n'
            'weight_decay: 0.004\nlr_policy: "fixed"\n'),
    "Nesterov": ('type: "Nesterov"\nbase_lr: 0.001\nmomentum: 0.9\n'
                 'weight_decay: 0.004\nlr_policy: "fixed"\n'),
    "AdaGrad": ('type: "AdaGrad"\nbase_lr: 0.01\ndelta: 1e-8\n'
                'weight_decay: 0.004\nlr_policy: "fixed"\n'),
    "RMSProp": ('type: "RMSProp"\nbase_lr: 0.001\nrms_decay: 0.98\n'
                'delta: 1e-8\nweight_decay: 0.004\nlr_policy: "fixed"\n'),
    "Adam": ('type: "Adam"\nbase_lr: 0.001\nmomentum: 0.9\n'
             'momentum2: 0.999\ndelta: 1e-8\nweight_decay: 0.004\n'
             'lr_policy: "fixed"\n'),
    "AdaDelta": ('type: "AdaDelta"\nbase_lr: 1.0\nmomentum: 0.95\n'
                 'delta: 1e-6\nweight_decay: 0.004\nlr_policy: "fixed"\n'),
}
# CaffeNet's solver with a step every 4 iterations, so the policy acts
CAFFENET_SOLVER = ('base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
                   'lr_policy: "step"\ngamma: 0.1\nstepsize: 4\n')
NARROW_NO_DROPOUT = NARROW_CAFFENET.replace("dropout_ratio: 0.5",
                                            "dropout_ratio: 0.0")


def _quick_batches(n, seed, batch=BATCH, scale=1.0):
    """Images at std ``scale`` whose label k raises row k of channel
    k % 3, so the nets can learn."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 10, size=(batch,))
        x = scale * rng.normal(size=(batch, 3, 32, 32))
        for k in range(10):
            x[labels == k, k % 3, k, :] += 2.0 * scale
        out.append({"data": x.astype(np.float32),
                    "label": labels.astype(np.float32)})
    return out


def _narrow_batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"data": (30.0 * rng.normal(size=(2, 3, 67, 67)))
             .astype(np.float32),
             "label": rng.integers(0, 16, size=(2,)).astype(np.float32)}
            for _ in range(n)]


def _host(tree):
    return {k: [np.asarray(b) for b in v]
            for k, v in jax.device_get(tree).items()}


def _pair_through_file(jsolver: JaxSolver, solver: Solver, tmp_path):
    """The JAX Solver's initial weights, written as a .caffemodel by the
    JAX package and read by the port's Solver: equal bit for bit."""
    path = str(tmp_path / "init.caffemodel")
    jax_cm.save_caffemodel(path, _host(jsolver.params),
                           jsolver.sp.net_param)
    solver.load_weights(path)
    want = _host(jsolver.params)
    assert list(solver.params) == list(want)
    for k, blobs in solver.params.items():
        for i, b in enumerate(blobs):
            assert b.numpy().tobytes() == want[k][i].tobytes(), f"{k}[{i}]"


def _run_both(jsolver, solver, batches):
    jsolver.set_train_data(iter(batches))
    solver.set_train_data(iter(batches))
    jl, pl = [], []
    for _ in batches:
        jl.append(jsolver.step(1))
        pl.append(solver.step(1))
    return np.asarray(pl), np.asarray(jl)


@pytest.mark.parametrize("rule", list(RULE_SOLVERS))
def test_each_rule_tracks_the_jax_solver_from_a_caffemodel(rule, tmp_path):
    txt = RULE_SOLVERS[rule]
    jsolver = JaxSolver(jax_sp(txt, jax_quick(BATCH, BATCH)), seed=0)
    solver = Solver(load_solver_prototxt_with_net(
        txt, cifar10_quick(BATCH, BATCH)), seed=1, device="cpu")
    assert solver.rule.name == jsolver.rule.name == rule.upper()
    assert set(solver.state) == set(jsolver.state)
    _pair_through_file(jsolver, solver, tmp_path)
    ours, theirs = _run_both(jsolver, solver, _quick_batches(STEPS, 17))
    np.testing.assert_allclose(ours, theirs,
                               rtol=2e-3 if rule == "AdaGrad" else RTOL,
                               atol=ATOL)
    assert solver.iter == jsolver.iter == STEPS
    assert ours[-1] < ours[0] - 0.005


def test_narrow_caffenet_sgd_and_test_pass_track_the_jax_solver(tmp_path):
    """SGD with CaffeNet's solver through the plain B1/B3/B5 (the CPU's
    versions of the card's kernels) for 30 steps, then ``test()`` (plain
    B2) on 2 test batches: losses and test sums at the bound."""
    jsolver = JaxSolver(jax_sp(CAFFENET_SOLVER,
                               jax_load_net(NARROW_NO_DROPOUT)), seed=0)
    solver = Solver(load_solver_prototxt_with_net(
        CAFFENET_SOLVER, load_net_prototxt(NARROW_NO_DROPOUT)),
        device="cpu")
    _pair_through_file(jsolver, solver, tmp_path)
    ours, theirs = _run_both(jsolver, solver, _narrow_batches(STEPS, 3))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)
    tests = _narrow_batches(2, 4)
    jsolver.set_test_data(lambda: iter(tests))
    solver.set_test_data(lambda: iter(tests))
    got, want = solver.test(2), jsolver.test(2)
    assert set(got) == set(want) == {"loss", "accuracy"}
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _narrow_solver(txt=CAFFENET_SOLVER, net=NARROW_CAFFENET, seed=0):
    return Solver(load_solver_prototxt_with_net(txt, load_net_prototxt(net)),
                  seed=seed, device="cpu")


@pytest.mark.parametrize("rule", ["SGD", "Adam", "AdaDelta"])
def test_caffe_snapshot_resume_equals_the_uninterrupted_run(rule, tmp_path):
    """Dropout on (ratio 0.5): 3 steps, snapshot_caffe, 2 more; a fresh
    Solver restores the snapshot (params and history bit for bit, iter
    3), takes the Dropout generator's state at the fork and the same 2
    batches, and ends where the first did, at the bound."""
    txt = RULE_SOLVERS[rule]
    batches = _narrow_batches(5, 6)
    a = _narrow_solver(txt)
    a.set_train_data(iter(batches))
    a.step(3)
    model, state = a.snapshot_caffe(str(tmp_path / "snap"))
    assert model.endswith("snap_iter_3.caffemodel")
    assert load_solverstate(state)["learned_net"] == model
    fork_params = {k: [b.clone() for b in v] for k, v in a.params.items()}
    fork_state = {s: {k: [b.clone() for b in v] for k, v in t.items()}
                  for s, t in a.state.items()}
    fork_gen = a.generator.get_state()
    a.step(2)

    b = _narrow_solver(txt, seed=9)
    b.restore_caffe(state)
    assert b.iter == 3
    for k in fork_params:
        for x, y in zip(fork_params[k], b.params[k]):
            assert torch.equal(x, y), k
        for s in fork_state:
            for x, y in zip(fork_state[s][k], b.state[s][k]):
                assert torch.equal(x, y), (s, k)
    b.generator.set_state(fork_gen)
    b.set_train_data(iter(batches[3:]))
    b.step(2)
    for k in a.params:
        for x, y in zip(a.params[k], b.params[k]):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("rule", ["SGD", "Adam", "AdaDelta"])
def test_caffe_snapshots_restore_across_the_two_packages(rule, tmp_path):
    """A port snapshot restores into the JAX Solver, and a JAX snapshot
    into the port's, with params, every history slot and iter equal bit
    for bit."""
    txt = RULE_SOLVERS[rule]
    batches = _quick_batches(2, 8)
    port = Solver(load_solver_prototxt_with_net(txt, cifar10_quick(8, 8)),
                  device="cpu")
    port.set_train_data(iter(batches))
    port.step(2)
    _, state = port.snapshot_caffe(str(tmp_path / "port"))
    jback = JaxSolver(jax_sp(txt, jax_quick(8, 8)), seed=3)
    jback.restore_caffe(state)
    assert jback.iter == 2
    jstate = jax.device_get(jback.state)
    for k, blobs in port.params.items():
        for i, b in enumerate(blobs):
            assert b.numpy().tobytes() == np.asarray(
                jback.params[k][i]).tobytes()
            for s in port.state:
                assert port.state[s][k][i].numpy().tobytes() == \
                    np.asarray(jstate[s][k][i]).tobytes(), (s, k, i)

    jsolver = JaxSolver(jax_sp(txt, jax_quick(8, 8)), seed=4)
    jsolver.set_train_data(iter(batches))
    jsolver.step(2)
    _, jstate_path = jsolver.snapshot_caffe(str(tmp_path / "jax"))
    back = Solver(load_solver_prototxt_with_net(txt, cifar10_quick(8, 8)),
                  seed=5, device="cpu")
    back.restore_caffe(jstate_path)
    assert back.iter == 2
    want = jax.device_get(jsolver.state)
    for k, blobs in back.params.items():
        for i, b in enumerate(blobs):
            assert b.numpy().tobytes() == np.asarray(
                jsolver.params[k][i]).tobytes()
            for s in back.state:
                assert back.state[s][k][i].numpy().tobytes() == \
                    np.asarray(want[s][k][i]).tobytes(), (s, k, i)


def test_npz_snapshot_round_trips_and_reads_the_jax_layout(tmp_path):
    txt = RULE_SOLVERS["Adam"]
    a = Solver(load_solver_prototxt_with_net(txt, lenet(4, 4)), device="cpu")
    batches = [{"data": np.random.default_rng(i).normal(
        size=(4, 1, 28, 28)).astype(np.float32),
        "label": np.arange(4, dtype=np.float32)} for i in range(2)]
    a.set_train_data(iter(batches))
    a.step(2)
    path = str(tmp_path / "a.npz")
    a.snapshot(path)
    b = Solver(load_solver_prototxt_with_net(txt, lenet(4, 4)), seed=7,
               device="cpu")
    b.restore(path)
    assert b.iter == 2
    assert torch.equal(b.params["ip2"][0], a.params["ip2"][0])
    assert torch.equal(b.state["v"]["conv1"][0], a.state["v"]["conv1"][0])
    j = JaxSolver(jax_sp(txt, jax_lenet(4, 4)), seed=0)
    j.restore(path)                    # the JAX package reads the port's
    assert int(j.iter) == 2
    assert np.asarray(j.state["m"]["ip1"][0]).tobytes() == \
        a.state["m"]["ip1"][0].numpy().tobytes()
    jpath = str(tmp_path / "j.npz")
    j.snapshot(jpath)
    c = Solver(load_solver_prototxt_with_net(txt, lenet(4, 4)), seed=8,
               device="cpu")
    c.restore(jpath)                   # and the port the JAX package's
    assert torch.equal(c.state["m"]["ip1"][0], a.state["m"]["ip1"][0])
    c.load_weights(jpath)              # a weights-only load of an npz
    assert torch.equal(c.params["conv2"][0], a.params["conv2"][0])


def test_solve_runs_the_test_and_snapshot_schedule(tmp_path, capsys):
    """solve(): a test pass at the start, one every test_interval and at
    the end; display lines in Caffe's format; snapshots on schedule."""
    prefix = str(tmp_path / "quick")
    txt = (RULE_SOLVERS["SGD"] + "test_iter: 2\ntest_interval: 2\n"
           "display: 1\nmax_iter: 4\nsnapshot: 2\n")
    sp = load_solver_prototxt_with_net(txt, cifar10_quick(4, 4),
                                       snapshot_prefix=prefix)
    s = Solver(sp, device="cpu")
    train = _quick_batches(4, 9, batch=4)
    s.set_train_data(iter(train))
    s.set_test_data(lambda: iter(_quick_batches(2, 10, batch=4)))
    loss = s.solve()
    assert s.iter == 4 and np.isfinite(loss)
    out = capsys.readouterr().out
    assert out.count("Testing net (#0)") == 3          # iters 0, 2, 4
    assert out.count("Test net output: accuracy") == 3
    assert "Iteration 1, loss = " in out and "Iteration 4, lr = " in out
    assert sorted(os.listdir(tmp_path)) == [
        "quick_iter_2.caffemodel", "quick_iter_2.solverstate",
        "quick_iter_4.caffemodel", "quick_iter_4.solverstate"]


def test_dedicated_test_nets_keep_their_own_layers():
    """Every test_net_param entry is a test net of its own, in place of
    the shared net; a test net's layers the train net lacks keep their
    filler init, the shared ones are the trained params."""
    sp = load_solver_prototxt_with_net(RULE_SOLVERS["SGD"],
                                       load_net_prototxt(NARROW_NO_DROPOUT))
    renamed = NARROW_NO_DROPOUT.replace('"fc8"', '"fc8_test"')
    sp.test_net_param = [load_net_prototxt(renamed),
                         load_net_prototxt(NARROW_NO_DROPOUT)]
    s = Solver(sp, device="cpu")
    assert len(s.test_nets) == 2
    assert list(s._test_extras[0]) == ["fc8_test"] and s._test_extras[1] == {}
    tests = _narrow_batches(1, 2)
    for i in range(2):
        s.set_test_data(lambda: iter(tests), net_id=i)
    s.params["fc8"][0].zero_()          # only test net 1 sees it
    s.params["fc8"][1].zero_()
    a, b = s.test(1, net_id=0), s.test(1, net_id=1)
    np.testing.assert_allclose(b["loss"], np.log(16), rtol=1e-6)
    assert abs(a["loss"] - np.log(16)) > 1e-4


def test_serving_a_caffemodel_matches_the_jax_engine(tmp_path):
    """The JAX Solver's lenet weights written as a .caffemodel (a train
    net: its loss layer has no blobs, the deploy net ignores it), served
    by both packages in f32."""
    jsolver = JaxSolver(jax_sp(RULE_SOLVERS["SGD"], jax_lenet(4, 4)), seed=3)
    path = str(tmp_path / "lenet.caffemodel")
    jax_cm.save_caffemodel(path, _host(jsolver.params), jsolver.sp.net_param)
    cfg = ServeConfig(batch_shapes=(1, 4), dtype="f32")
    house = ModelHouse(cfg, device="cpu")
    lm = house.load("lenet", weights=path)
    assert lm.info()["weights"] == path
    assert house.load("lenet", weights=path) is lm       # cache hit
    seeded = house.load("lenet")                          # other weights
    assert seeded is not lm and seeded.weights is None
    jlm = JaxModelHouse(JaxServeConfig(batch_shapes=(1, 4), dtype="f32")
                        ).load("lenet", weights=path)
    x = np.random.default_rng(0).normal(size=(4, 1, 28, 28)).astype(
        np.float32)
    got, want = lm.infer(x), np.asarray(jlm.infer(x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert not np.allclose(seeded.infer(x), got, atol=1e-3)
    assert torch.equal(lm.params["ip2"][0],
                       torch.from_numpy(load_caffemodel(path)["ip2"][0]
                                        .copy()))


# -- refusals and checks ----------------------------------------------------

def _small_solver(extra=""):
    return Solver(load_solver_prototxt_with_net(
        RULE_SOLVERS["AdaDelta"] + extra, lenet(2, 2)), device="cpu")


def test_hdf5_weights_and_snapshots(tmp_path):
    """``snapshot_format: HDF5`` writes the ``.caffemodel.h5`` and
    ``.solverstate.h5`` pair; a fresh Solver restores it (params, history
    and iter bit for bit, the model found through ``learned_net``), and
    ``load_weights`` reads the ``.caffemodel.h5``.  The files' layout
    against h5py and the JAX package: tests/test_torch_hdf5.py."""
    s = _small_solver("snapshot_format: HDF5\n")
    s.set_train_data(iter(_lenet_batches(2)))
    s.step(2)
    model, state = s.snapshot_caffe(str(tmp_path / "x"))
    assert model.endswith("x_iter_2.caffemodel.h5")
    assert state.endswith("x_iter_2.solverstate.h5")
    back = _small_solver()
    back.restore_caffe(state)
    assert back.iter == 2
    for k in s.params:
        for a, b in zip(s.params[k], back.params[k]):
            assert torch.equal(a, b), k
        for slot in s.state:
            for a, b in zip(s.state[slot][k], back.state[slot][k]):
                assert torch.equal(a, b), (slot, k)
    w = _small_solver()
    w.load_weights(model)
    for k in s.params:
        assert all(torch.equal(a, b) for a, b in zip(s.params[k],
                                                      w.params[k])), k


def _lenet_batches(n):
    return [{"data": np.random.default_rng(i).normal(
        size=(2, 1, 28, 28)).astype(np.float32),
        "label": np.arange(2, dtype=np.float32)} for i in range(n)]


def test_debug_info_set_augment_v0_and_shared_params_are_refused():
    # debug_info runs now (tests/test_torch_bench.py holds its lines
    # against the JAX Solver's), and so do V0 nets, a bare input_dim and
    # shared params (tests/test_torch_proto_upgrade.py and
    # test_torch_shared_params.py hold them against the JAX package);
    # set_augment runs (tests/test_torch_augment.py holds it against the
    # JAX package) and spec=None takes it off again
    from sparknet_tpu_torch.ops.augment import AugmentSpec
    aug = _small_solver()
    aug.set_augment(AugmentSpec(crop=28, mirror=True))
    aug.set_train_data(iter([{"data": np.full((2, 1, 32, 32), 7, np.uint8),
                              "label": np.arange(2, dtype=np.float32)}]))
    assert np.isfinite(aug.step(1))
    aug.set_augment(None)
    aug.set_train_data(iter(_lenet_batches(1)))
    assert np.isfinite(aug.step(1))
    v0 = ('name: "v0" layers { layer { name: "ip" type: "innerproduct" '
          'num_output: 2 } bottom: "data" top: "ip" }')
    lp = load_net_prototxt(v0).layer[0]
    assert (lp.type, lp.bottom, lp.top) == ("InnerProduct", ["data"], ["ip"])
    assert load_net_prototxt('input: "data"\ninput_dim: 1 input_dim: 3 '
                             'input_dim: 8 input_dim: 8\n'
                             ).input_shape[0].dim == [1, 3, 8, 8]
    s = Solver(load_solver_prototxt_with_net(
        RULE_SOLVERS["SGD"], load_net_prototxt(LEGACY_SHARED)), device="cpu")
    # ip_b shares ip_a's weight and stores only its own bias
    assert [len(s.params[k]) for k in ("ip_a", "ip_b")] == [2, 1]
    ip_b = s.train_net.node_params(s.params, s.train_net.nodes[2])
    assert ip_b[0] is s.params["ip_a"][0] and ip_b[1] is s.params["ip_b"][0]


LEGACY_SHARED = """
name: "shared"
layer { name: "in" type: "Input" top: "a" top: "label"
  input_param { shape { dim: 2 dim: 4 } shape { dim: 2 } } }
layer { name: "ip_a" type: "InnerProduct" bottom: "a" top: "fa"
  param { name: "w" } inner_product_param { num_output: 4 } }
layer { name: "ip_b" type: "InnerProduct" bottom: "fa" top: "fb"
  param { name: "w" } inner_product_param { num_output: 4 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "fb" bottom: "label"
  top: "loss" }
"""


def test_restore_and_load_check_counts_shapes_and_content(tmp_path):
    s = _small_solver()
    model, state = s.snapshot_caffe(str(tmp_path / "s"))
    st = load_solverstate(state)
    short = str(tmp_path / "short.solverstate")
    save_solverstate(short, st["iter"], st["history"][:-1],
                     learned_net=model)
    with pytest.raises(ValueError, match="history blobs"):
        s.restore_caffe(short)
    # swapped AdaDelta slots: the shapes agree, so the restore succeeds,
    # and the restored history differs from the saved one
    n = len(st["history"]) // 2
    swapped = str(tmp_path / "swapped.solverstate")
    s.state["sq_grad"]["ip1"][0].fill_(1.0)
    model, state = s.snapshot_caffe(str(tmp_path / "t"))
    st = load_solverstate(state)
    save_solverstate(swapped, st["iter"], st["history"][n:] +
                     st["history"][:n], learned_net=model)
    back = _small_solver()
    back.restore_caffe(swapped)
    assert not torch.equal(back.state["sq_grad"]["ip1"][0],
                           s.state["sq_grad"]["ip1"][0])
    missing = str(tmp_path / "missing.solverstate")
    save_solverstate(missing, 1, st["history"],
                     learned_net=str(tmp_path / "absent.caffemodel"))
    with pytest.raises(FileNotFoundError):
        back.restore_caffe(missing)
    weights = load_caffemodel(model)
    transposed = {**weights, "ip1": [weights["ip1"][0].T.copy(),
                                     weights["ip1"][1]]}
    bad = str(tmp_path / "transposed.caffemodel")
    save_caffemodel(bad, transposed)
    before = {k: [b.clone() for b in v] for k, v in back.params.items()}
    with pytest.raises(ValueError, match="incompatible"):
        back.load_weights(bad)
    for k, blobs in before.items():      # nothing was written
        assert all(torch.equal(x, y) for x, y in zip(blobs, back.params[k]))
    wrong_count = str(tmp_path / "count.caffemodel")
    save_caffemodel(wrong_count, {"ip1": weights["ip1"][:1]})
    with pytest.raises(ValueError, match="blobs"):
        back.load_weights(wrong_count)
    empty = str(tmp_path / "empty.caffemodel")
    save_caffemodel(empty, {})
    with pytest.raises(ValueError, match="no weight blobs"):
        back.load_weights(empty)


def test_solver_prototxt_nets_resolve_from_files(tmp_path):
    from sparknet_tpu_torch.proto import resolve_solver_nets
    (tmp_path / "train.prototxt").write_text(NARROW_CAFFENET)
    (tmp_path / "test.prototxt").write_text(NARROW_NO_DROPOUT)
    solver_path = tmp_path / "solver.prototxt"
    solver_path.write_text('net: "elsewhere/train.prototxt"\n'
                           'test_net: "test.prototxt"\nbase_lr: 0.1\n')
    sp = load_solver_prototxt(str(solver_path))
    assert sp.net == "elsewhere/train.prototxt" and sp.net_param is None
    resolve_solver_nets(sp, str(solver_path))
    assert sp.net_param.name == "CaffeNetNarrow"
    assert len(sp.test_net_param) == 1
    s = Solver(sp, device="cpu")
    assert len(s.test_nets) == 1 and s._test_extras == [{}]
