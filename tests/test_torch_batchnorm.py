"""BatchNorm and its forward state, the port against the JAX package on
the CPU: the layer; Caffe's cifar10_full_sigmoid_bn, narrow, through the
``Solver`` (10 steps, and with ``iter_size`` 2), in bf16, and through
the ``sync``, ``local_sgd`` and ``hierarchical`` rounds; and the net at
its published widths.

The net is Caffe's examples/cifar10/cifar10_full_sigmoid_train_test_bn
.prototxt with its cifar10_full_sigmoid_solver_bn.prototxt, transcribed
below (the reference files are not in the repository) with the widths
as fields.  The tests run it at conv widths 4/4/8 and batch 8 in place
of 32/32/64 and 100, on Input layers in place of the LMDB Data layers,
with seeded unit-scale 32x32 images whose class raises one row.

Tolerances: the layer in f32 at rtol 1e-5, atol 1e-6 (its updated blobs
and its gradients too); the Solver, the rounds and the whole net's
gradients at rtol 2e-4, atol 2e-5 (the bound of
tests/test_torch_trainer.py), on every blob, the running statistics
included (the full-width net's gradients at batch 4 miss the layer bound
by 1.9e-6 in 11 of conv1's 2400 values); bf16 at atol 2e-2
(tests/test_torch_zoo_layers.py), with no relative term and not scaled
by the values.  In the code: ``LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6``
for the layer's forward, gradients and updated blobs, and the narrow
net's updated BatchNorm blobs; ``RTOL, ATOL = 2e-4, 2e-5`` for the
Solver's and the rounds' losses, params and statistics and the whole
net's gradients; a fresh layer's stored variance and the whole net's
loss at rtol 1e-5; the ``sync`` round's statistics against the mean of
the two workers' forwards at rtol 1e-6, atol 1e-7; ``BF16_ATOL =
2e-2`` for the bf16 forward.  Weights
go from the JAX ``Solver`` to the port's through a ``.caffemodel``, bit
for bit; ``.caffemodel`` and ``.solverstate`` carry BatchNorm's three
blobs in Caffe's order both ways bit for bit.
"""

from __future__ import annotations

import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_impl
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh as jax_mesh
from sparknet_tpu.parallel import make_pod_mesh as jax_pod_mesh
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu.proto import caffemodel as jax_cm
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_sp
from sparknet_tpu.solvers import Solver as JaxSolver
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.graph import Net
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import get_layer_impl as torch_impl
from sparknet_tpu_torch.parallel.mesh import make_pod_mesh
from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                 TrainerConfig)
from sparknet_tpu_torch.proto import (NetState, Phase, load_net_prototxt,
                                      load_solver_prototxt_with_net)
from sparknet_tpu_torch.solvers import Solver
from torch_threads import one_torch_thread  # noqa: F401

LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6
RTOL, ATOL = 2e-4, 2e-5
BF16_ATOL = 2e-2


def _conv(name: str, bottom: str, width: str, std: str) -> str:
    return f"""
layer {{ name: "{name}" type: "Convolution" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 1 }}
  convolution_param {{ num_output: ${width} pad: 2 kernel_size: 5 stride: 1
    bias_term: false weight_filler {{ type: "gaussian" std: {std} }} }} }}"""


def _bn(name: str, bottom: str) -> str:
    return f"""
layer {{ name: "{name}" type: "BatchNorm" bottom: "{bottom}" top: "{name}"
  param {{ lr_mult: 0 }} param {{ lr_mult: 0 }} param {{ lr_mult: 0 }} }}"""


def _layer(name: str, type_: str, bottom: str, body: str = "") -> str:
    return (f'\nlayer {{ name: "{name}" type: "{type_}" bottom: "{bottom}" '
            f'top: "{name}" {body} }}')


def _pool(name: str, bottom: str, method: str) -> str:
    return _layer(name, "Pooling", bottom, f"pooling_param {{ pool: {method} "
                  "kernel_size: 3 stride: 2 }")


# examples/cifar10/cifar10_full_sigmoid_train_test_bn.prototxt (BVLC
# caffe, master) past its two Data layers
BN_BODY = string.Template(
    _conv("conv1", "data", "conv1", "0.0001") + _pool("pool1", "conv1", "MAX")
    + _bn("bn1", "pool1") + _layer("Sigmoid1", "Sigmoid", "bn1")
    + _conv("conv2", "Sigmoid1", "conv2", "0.01") + _bn("bn2", "conv2")
    + _layer("Sigmoid2", "Sigmoid", "bn2") + _pool("pool2", "Sigmoid2", "AVE")
    + _conv("conv3", "pool2", "conv3", "0.01") + _bn("bn3", "conv3")
    + _layer("Sigmoid3", "Sigmoid", "bn3") + _pool("pool3", "Sigmoid3", "AVE")
    + """
layer { name: "ip1" type: "InnerProduct" bottom: "pool3" top: "ip1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 1 decay_mult: 0 }
  inner_product_param { num_output: 10
    weight_filler { type: "gaussian" std: 0.01 }
    bias_filler { type: "constant" } } }
layer { name: "accuracy" type: "Accuracy" bottom: "ip1" bottom: "label"
  top: "accuracy" include { phase: TEST } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip1" bottom: "label"
  top: "loss" }
""")
INPUTS = string.Template("""name: "CIFAR10_full"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: $batch dim: 3 dim: 32 dim: 32 } } }
layer { name: "label" type: "Input" top: "label"
  input_param { shape { dim: $batch } } }
""")
PUBLISHED = {"batch": 100, "conv1": 32, "conv2": 32, "conv3": 64}
NARROW = {"batch": 8, "conv1": 4, "conv2": 4, "conv3": 8}
# examples/cifar10/cifar10_full_sigmoid_solver_bn.prototxt (its
# weight_decay line is commented out there), the step policy's gamma 1
SOLVER_TXT = ('base_lr: 0.001\nmomentum: 0.9\nlr_policy: "step"\n'
              'gamma: 1\nstepsize: 5000\n')
STEPS = 10


def bn_net(**widths) -> str:
    w = {**PUBLISHED, **widths}
    return INPUTS.substitute(w) + BN_BODY.substitute(w)


def _batches(n, seed, batch=NARROW["batch"]):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 10, size=(batch,))
        x = rng.normal(size=(batch, 3, 32, 32))
        for k in range(10):
            x[labels == k, k % 3, 3 * k, :] += 2.0
        out.append({"data": x.astype(np.float32),
                    "label": labels.astype(np.float32)})
    return out


def _host(tree):
    return {k: [np.asarray(b) for b in v]
            for k, v in jax.device_get(tree).items()}


# -- the layer ---------------------------------------------------------------

def _bn_both(x, blobs, sub, train, dtype=torch.float32):
    """(port tops, port updated blobs, port grads) and the JAX package's,
    of one BatchNorm on ``x`` with ``blobs`` under a shared cotangent."""
    jlp = jax_layer("bn", "BatchNorm", ["x"], ["y"], **sub)
    tlp = torch_layer("bn", "BatchNorm", ["x"], ["y"], **sub)

    def jfn(x, *p):
        (y,), new = jax_impl("BatchNorm").apply(jlp, list(p), [x], train,
                                                None)
        return y, new
    jargs = [jnp.asarray(x)] + [jnp.asarray(b) for b in blobs]
    (y, new), vjp = jax.vjp(jfn, *jargs)
    cot = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    jgrads = vjp((jnp.asarray(cot), [jnp.zeros_like(b) for b in new]))
    xs = torch.from_numpy(x.copy()).to(dtype).requires_grad_()
    ps = [torch.from_numpy(b.copy()).requires_grad_() for b in blobs]
    (ty,), tnew = torch_impl("BatchNorm").apply(tlp, ps, [xs], train)
    leaves = [xs] + ps
    grads = torch.autograd.grad(ty, leaves, torch.from_numpy(cot).to(dtype),
                                allow_unused=True)
    grads = [np.zeros(l.shape, np.float32) if g is None
             else g.float().numpy() for g, l in zip(grads, leaves)]
    return ((ty.detach().float().numpy(), [b.detach().numpy() for b in tnew],
             grads),
            (np.asarray(y), [np.asarray(b) for b in new],
             [np.asarray(g) for g in jgrads]))


STATS = [np.array([0.4, -1.2, 3.0], np.float32),
         np.array([2.0, 0.5, 7.5], np.float32), np.array([2.5], np.float32)]
BN_CASES = {
    "train_fresh": ({}, True, [np.zeros(3, np.float32),
                               np.zeros(3, np.float32),
                               np.zeros(1, np.float32)]),
    "train_decayed": ({"batch_norm_param": {"moving_average_fraction": 0.9,
                                            "eps": 1e-3}}, True, STATS),
    "test_global_stats": ({}, False, STATS),
    "test_scale_factor_zero": ({}, False, STATS[:2]
                               + [np.zeros(1, np.float32)]),
    "train_use_global_stats": ({"batch_norm_param": {
        "use_global_stats": True}}, True, STATS),
}


@pytest.mark.parametrize("case", list(BN_CASES))
@pytest.mark.parametrize("shape", [(4, 3, 5, 6), (6, 3)], ids=["nchw", "nc"])
def test_batchnorm_layer_matches_jax(case, shape):
    """Forward, the updated blobs and the gradients of the input and the
    blobs: training normalises by the batch (biased variance) and stores
    λ-decayed sums with the m/(m−1) correction; global stats divide by
    the scale factor (0 gives 0); an explicit ``use_global_stats`` in
    TRAIN hands the blobs back unchanged."""
    sub, train, blobs = BN_CASES[case]
    x = (2.0 + 3.0 * np.random.default_rng(0).normal(size=shape)).astype(
        np.float32)
    (y, new, g), (jy, jnew, jg) = _bn_both(x, blobs, sub, train)
    np.testing.assert_allclose(y, jy, rtol=LAYER_RTOL, atol=LAYER_ATOL)
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(a, b, rtol=LAYER_RTOL, atol=LAYER_ATOL)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a, b, rtol=LAYER_RTOL, atol=LAYER_ATOL)
    if case in ("test_global_stats", "train_use_global_stats",
                "test_scale_factor_zero"):
        assert all(np.array_equal(a, b) for a, b in zip(new, blobs))
    if case == "train_fresh":
        m = x.size // x.shape[1]
        axes = (0,) + tuple(range(2, x.ndim))
        np.testing.assert_allclose(new[1], x.var(axes) * m / (m - 1),
                                   rtol=1e-5)
        assert new[2][0] == 1.0


def test_batchnorm_bf16_matches_jax():
    """In bf16 the layer's input is cast to f32 by the net, so both
    packages normalise in f32 and store f32 statistics."""
    net_txt = """
name: "bn16"
layer { name: "x" type: "Input" top: "x"
  input_param { shape { dim: 4 dim: 3 dim: 5 dim: 6 } } }
layer { name: "bn" type: "BatchNorm" bottom: "x" top: "bn" }
layer { name: "sc" type: "Scale" bottom: "bn" top: "sc"
  scale_param { bias_term: true filler { type: "uniform" } } }
"""
    x = (1.0 + 2.0 * np.random.default_rng(3).normal(size=(4, 3, 5, 6))
         ).astype(np.float32)
    jnet = JaxNet(jax_load_net(net_txt), JaxNetState(JaxPhase.TRAIN),
                  compute_dtype=jnp.bfloat16)
    jp = jnet.init(jax.random.PRNGKey(0))
    out = jnet.apply(jp, {"x": jnp.asarray(x)}, train=True)
    net = Net(load_net_prototxt(net_txt), NetState(Phase.TRAIN),
              compute_dtype=torch.bfloat16)
    params = params_from_jax(_host(jp), net, device="cpu")
    got = net.forward(params, {"x": torch.from_numpy(x)}, train=True)
    assert got.blobs["sc"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.blobs["sc"].float().numpy(),
                               np.asarray(out.blobs["sc"], np.float32),
                               atol=BF16_ATOL)
    want = _host(out.params)
    for i, b in enumerate(got.params["bn"]):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), want["bn"][i],
                                   rtol=LAYER_RTOL, atol=LAYER_ATOL)


def test_batchnorm_blobs_take_no_learning_rate():
    """lr_mult and decay_mult 0 on the three blobs whatever the prototxt
    says; the forward writes the statistics into ``NetOutputs.params``
    and leaves the caller's params alone."""
    txt = bn_net(**NARROW).replace(
        'name: "bn1" type: "BatchNorm" bottom: "pool1" top: "bn1"\n'
        '  param { lr_mult: 0 } param { lr_mult: 0 } param { lr_mult: 0 }',
        'name: "bn1" type: "BatchNorm" bottom: "pool1" top: "bn1"\n'
        '  param { lr_mult: 3 decay_mult: 2 }')
    net = Net(load_net_prototxt(txt), NetState(Phase.TRAIN))
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    lr, decay = net.lr_mult_tree(params), net.decay_mult_tree(params)
    for name in ("bn1", "bn2", "bn3"):
        assert lr[name] == decay[name] == [0.0, 0.0, 0.0]
    b = _batches(1, 2)[0]
    out = net.forward(params, {k: torch.from_numpy(v) for k, v in b.items()})
    for name in ("bn1", "bn2", "bn3"):
        assert all(float(v.abs().sum()) == 0 for v in params[name])
        assert float(out.params[name][2]) == 1.0
    assert out.params["conv1"] is params["conv1"]


# -- the net through the Solver ---------------------------------------------

def _solver_pair(tmp_path, txt=SOLVER_TXT):
    net_txt = bn_net(**NARROW)
    jsolver = JaxSolver(jax_sp(txt, jax_load_net(net_txt)), seed=0)
    solver = Solver(load_solver_prototxt_with_net(
        txt, load_net_prototxt(net_txt)), seed=1, device="cpu")
    path = str(tmp_path / "init.caffemodel")
    jax_cm.save_caffemodel(path, _host(jsolver.params), jsolver.sp.net_param)
    solver.load_weights(path)
    want = _host(jsolver.params)
    assert set(solver.params) == set(want)
    for k, blobs in solver.params.items():
        for i, b in enumerate(blobs):
            assert b.numpy().tobytes() == want[k][i].tobytes(), f"{k}[{i}]"
    return jsolver, solver


def _assert_tree_close(got, want, rtol=RTOL, atol=ATOL):
    want = _host(want)
    assert set(got) == set(want)
    for k, blobs in got.items():
        assert len(blobs) == len(want[k])
        for i, b in enumerate(blobs):
            np.testing.assert_allclose(b.numpy(), want[k][i], rtol=rtol,
                                       atol=atol, err_msg=f"{k}[{i}]")


@pytest.mark.parametrize("iter_size", [1, 2])
def test_solver_tracks_the_jax_solver_stats_included(iter_size, tmp_path):
    """10 steps of the published solver from one ``.caffemodel``: every
    loss, then every blob, BatchNorm's running sums and scale factors
    included; with ``iter_size`` 2 each micro-batch's forward starts from
    the statistics the one before wrote.  Then a test pass, which reads
    the updated statistics (use_global_stats at TEST)."""
    txt = SOLVER_TXT + f"iter_size: {iter_size}\n"
    jsolver, solver = _solver_pair(tmp_path, txt)
    batches = _batches(STEPS * iter_size, 5)
    jsolver.set_train_data(iter(batches))
    solver.set_train_data(iter(batches))
    jl = [jsolver.step(1) for _ in range(STEPS)]
    pl = [solver.step(1) for _ in range(STEPS)]
    np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    _assert_tree_close(solver.params, jsolver.params)
    assert float(solver.params["bn1"][2]) == pytest.approx(
        sum(0.999 ** i for i in range(STEPS * iter_size)), rel=1e-6)
    for slot in solver.state:
        for k in ("bn1", "bn2", "bn3"):
            assert all(float(h.abs().sum()) == 0
                       for h in solver.state[slot][k])
    tests = _batches(2, 6)
    jsolver.set_test_data(lambda: iter(tests))
    solver.set_test_data(lambda: iter(tests))
    got, want = solver.test(2), jsolver.test(2)
    assert set(got) == set(want) == {"loss", "accuracy"}
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("rule", ["Adam", "RMSProp", "AdaDelta"])
def test_stat_blobs_stay_finite_and_historyless_under_every_rule(rule):
    """A statistic has a zero gradient and lr_mult 0: no rule divides it
    into NaN or moves it, and its history stays 0."""
    txt = {"Adam": 'type: "Adam"\nmomentum2: 0.999\ndelta: 1e-8\n',
           "RMSProp": 'type: "RMSProp"\nrms_decay: 0.98\ndelta: 1e-8\n',
           "AdaDelta": 'type: "AdaDelta"\ndelta: 1e-6\n'}[rule]
    solver = Solver(load_solver_prototxt_with_net(
        txt + SOLVER_TXT + "weight_decay: 0.004\n",
        load_net_prototxt(bn_net(**NARROW))), device="cpu")
    solver.set_train_data(iter(_batches(3, 7)))
    solver.step(3)
    sums = [0.999 ** 2 + 0.999 + 1.0]
    for k in ("bn1", "bn2", "bn3"):
        assert all(torch.isfinite(b).all() for b in solver.params[k])
        assert float(solver.params[k][2]) == pytest.approx(sums[0])
        for slot in solver.state:
            assert all(float(h.abs().sum()) == 0
                       for h in solver.state[slot][k])


def test_caffe_files_carry_the_stats_both_ways_bit_for_bit(tmp_path):
    """After 3 steps, a port snapshot restores into the JAX Solver and a
    JAX snapshot into the port's: params (the three BatchNorm blobs in
    Caffe's order), every history slot and iter, bit for bit."""
    jsolver, solver = _solver_pair(tmp_path)
    batches = _batches(3, 8)
    solver.set_train_data(iter(batches))
    solver.step(3)
    _, state = solver.snapshot_caffe(str(tmp_path / "port"))
    jback = JaxSolver(jax_sp(SOLVER_TXT, jax_load_net(bn_net(**NARROW))),
                      seed=3)
    jback.restore_caffe(state)
    assert jback.iter == 3
    jstate = _host(jback.state["history"])
    got = _host(jback.params)
    for k, blobs in solver.params.items():
        for i, b in enumerate(blobs):
            assert b.numpy().tobytes() == got[k][i].tobytes(), (k, i)
            assert solver.state["history"][k][i].numpy().tobytes() == \
                jstate[k][i].tobytes(), (k, i)
    assert float(solver.params["bn3"][2]) != 0.0

    jsolver.set_train_data(iter(batches))
    jsolver.step(3)
    # the JAX Solver's jitted step hands its params back with the layer
    # names sorted, and it writes a .solverstate's history in that order;
    # Caffe's (and the port's) is the net's.  Its trees are put back in
    # the net's order first (ROADMAP C).
    order = list(solver.params)
    assert list(jsolver.params) == sorted(order) != order
    jsolver.params = {k: jsolver.params[k] for k in order}
    jsolver.state = {s: {k: t[k] for k in order}
                     for s, t in jsolver.state.items()}
    _, jpath = jsolver.snapshot_caffe(str(tmp_path / "jax"))
    back = Solver(load_solver_prototxt_with_net(
        SOLVER_TXT, load_net_prototxt(bn_net(**NARROW))), seed=5,
        device="cpu")
    back.restore_caffe(jpath)
    assert back.iter == 3
    want, wstate = _host(jsolver.params), _host(jsolver.state["history"])
    for k, blobs in back.params.items():
        for i, b in enumerate(blobs):
            assert b.numpy().tobytes() == want[k][i].tobytes(), (k, i)
            assert back.state["history"][k][i].numpy().tobytes() == \
                wstate[k][i].tobytes(), (k, i)


# -- the rounds -------------------------------------------------------------

# the BatchNorm net of tests/test_parallel.py:423 (BN_DP_NET)
BN_DP_NET = """
name: "bn_dp"
layer { name: "data" type: "Input" top: "data"
  input_param { shape { dim: 8 dim: 1 dim: 12 dim: 12 } } }
layer { name: "label" type: "Input" top: "label"
  input_param { shape { dim: 8 } } }
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.1 } } }
layer { name: "bn1" type: "BatchNorm" bottom: "conv1" top: "bn1" }
layer { name: "sc1" type: "Scale" bottom: "bn1" top: "sc1"
  scale_param { bias_term: true } }
layer { name: "relu1" type: "ReLU" bottom: "sc1" top: "sc1" }
layer { name: "ip" type: "InnerProduct" bottom: "sc1" top: "ip"
  inner_product_param { num_output: 5 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" }
"""
ROUND_SOLVER = 'base_lr: 0.05\nmomentum: 0.9\nlr_policy: "fixed"\n'


def _round_batches(seed, rounds, steps, batch=16):
    rng = np.random.default_rng(seed)
    return [{"data": (1.0 + rng.normal(size=(steps, batch, 1, 12, 12)))
             .astype(np.float32),
             "label": rng.integers(0, 5, size=(steps, batch))
             .astype(np.float32)} for _ in range(rounds)]


def _round_pair(net_txt, strategy, layout, jlayout, tau):
    jtr = JaxTrainer(jax_sp(ROUND_SOLVER, jax_load_net(net_txt)), jlayout,
                     JaxConfig(strategy=strategy, tau=tau), seed=0)
    tr = DistributedTrainer(load_solver_prototxt_with_net(
        ROUND_SOLVER, load_net_prototxt(net_txt)), layout,
        TrainerConfig(strategy=strategy, tau=tau), seed=0, device="cpu")
    tr.params = params_from_jax(_host(jtr.params), tr.train_net,
                                device="cpu")
    tr.state = tr.init_state()
    return jtr, tr


ROUNDS = {
    "sync": (2, lambda: jax_mesh(2)),
    "local_sgd": (2, lambda: jax_mesh(2)),
    "hierarchical": (make_pod_mesh(2, 2), lambda: jax_pod_mesh(2, 2)),
}


@pytest.mark.parametrize("strategy", list(ROUNDS))
def test_rounds_track_the_jax_trainer_stats_included(strategy):
    """Two rounds of τ=2 on the BatchNorm net of tests/test_parallel.py:
    the losses, then every blob.  ``sync`` (and ``hierarchical``'s chip
    tier) re-average the statistics after each step; ``local_sgd``
    averages every blob at the τ boundary."""
    layout, jlayout = ROUNDS[strategy]
    jtr, tr = _round_pair(BN_DP_NET, strategy, layout, jlayout(), tau=2)
    for r, batches in enumerate(_round_batches(3, rounds=2, steps=2)):
        jloss = jtr.train_round(batches)
        loss = tr.train_round(batches)
        np.testing.assert_allclose(loss, jloss, rtol=RTOL,
                                   err_msg=f"round {r} loss")
        _assert_tree_close(tr.params, jtr.params)
    # four steps, each worker's forward adding 1 to the decayed factor
    assert float(tr.params["bn1"][2]) == pytest.approx(
        sum(0.999 ** i for i in range(4)), rel=1e-6)


def test_sync_step_averages_what_each_worker_wrote():
    """One sync step of two workers: each worker's forward starts from
    the same pre-step statistics, and the step's statistics are the mean
    of what the two forwards wrote: a one-worker forward on each half
    from the pre-step params."""
    sp = load_solver_prototxt_with_net(ROUND_SOLVER,
                                       load_net_prototxt(BN_DP_NET))
    tr = DistributedTrainer(sp, 2, TrainerConfig(strategy="sync", tau=1),
                            seed=0, device="cpu")
    with torch.no_grad():
        for b in tr.params["bn1"]:
            b.fill_(0.5)
    start = {k: [b.clone() for b in v] for k, v in tr.params.items()}
    batches = _round_batches(4, rounds=1, steps=1)[0]
    tr.train_round(batches)
    halves = []
    for w in range(2):
        out = tr.train_net.forward(start, {
            "data": torch.from_numpy(batches["data"][0, 8 * w:8 * w + 8]),
            "label": torch.from_numpy(batches["label"][0, 8 * w:8 * w + 8])},
            train=True)
        halves.append(out.params["bn1"])
    for i in range(3):
        want = (halves[0][i] + halves[1][i]) / 2
        np.testing.assert_allclose(tr.params["bn1"][i].numpy(),
                                   want.numpy(), rtol=1e-6, atol=1e-7)


# -- the published widths ----------------------------------------------------

FULL_SHAPES = {"conv1": (100, 32, 32, 32), "pool1": (100, 32, 16, 16),
               "bn1": (100, 32, 16, 16), "conv2": (100, 32, 16, 16),
               "pool2": (100, 32, 8, 8), "conv3": (100, 64, 8, 8),
               "pool3": (100, 64, 4, 4), "ip1": (100, 10)}


@pytest.mark.parametrize("phase", ["TRAIN", "TEST"])
def test_full_width_shapes_match_jax(phase):
    txt = bn_net()
    net = Net(load_net_prototxt(txt), NetState(getattr(Phase, phase)))
    jnet = JaxNet(jax_load_net(txt), JaxNetState(getattr(JaxPhase, phase)))
    assert net.blob_shapes == {k: tuple(v)
                               for k, v in jnet.blob_shapes.items()}
    for k, s in FULL_SHAPES.items():
        assert net.blob_shapes[k] == s
    assert ("accuracy" in net.blob_shapes) == (phase == "TEST")
    assert net.param_shapes()["bn3"] == [(64,), (64,), (1,)]
    assert net.param_shapes()["conv1"] == [(32, 3, 5, 5)]


def test_full_width_forward_and_backward_at_batch_4():
    """The published widths at batch 4: one training forward and backward
    from the same weights, the loss, the gradients and the statistics the
    forward wrote."""
    txt = bn_net(batch=4)
    jnet = JaxNet(jax_load_net(txt), JaxNetState(JaxPhase.TRAIN))
    jp = jnet.init(jax.random.PRNGKey(0))
    b = _batches(1, 9, batch=4)[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        out = jnet.apply(p, jb, train=True)
        return out.loss, out.params
    (jl, jnew), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    net = Net(load_net_prototxt(txt), NetState(Phase.TRAIN))
    params = params_from_jax(_host(jp), net, device="cpu")
    leaves = {k: [t.requires_grad_() for t in v] for k, v in params.items()}
    out = net.forward(leaves, {k: torch.from_numpy(v) for k, v in b.items()})
    flat = [t for v in leaves.values() for t in v]
    grads = torch.autograd.grad(out.loss, flat, allow_unused=True)
    np.testing.assert_allclose(float(out.loss.detach()), float(jl),
                               rtol=1e-5)
    jg, it = _host(jg), iter(grads)
    for k, v in leaves.items():
        for i, _ in enumerate(v):
            g = next(it)
            g = np.zeros_like(jg[k][i]) if g is None else g.numpy()
            np.testing.assert_allclose(g, jg[k][i], rtol=RTOL, atol=ATOL,
                                       err_msg=f"grad {k}[{i}]")
    jnew = _host(jnew)
    for k in ("bn1", "bn2", "bn3"):
        for i, t in enumerate(out.params[k]):
            np.testing.assert_allclose(t.detach().numpy(), jnew[k][i],
                                       rtol=LAYER_RTOL, atol=LAYER_ATOL)


def test_weight_math_snapshots_and_time_net_carry_the_stats(tmp_path,
                                                            capsys):
    """SparkNet's weight average covers the statistics; an npz snapshot
    of the port's Solver restores into the JAX Solver with them bit for
    bit; ``time_net --per-layer`` times a stateful layer."""
    from sparknet_tpu_torch.graph.net import weights_add, weights_scalar_divide
    from sparknet_tpu_torch.tools import time_net
    solver = Solver(load_solver_prototxt_with_net(
        SOLVER_TXT, load_net_prototxt(bn_net(**NARROW))), device="cpu")
    solver.set_train_data(iter(_batches(2, 10)))
    solver.step(2)
    avg = weights_scalar_divide(weights_add(solver.params, solver.params),
                                2.0)
    for k in ("bn1", "bn2", "bn3"):
        for a, b in zip(avg[k], solver.params[k]):
            assert torch.equal(a, b)
    path = str(tmp_path / "s.npz")
    solver.snapshot(path)
    jsolver = JaxSolver(jax_sp(SOLVER_TXT, jax_load_net(bn_net(**NARROW))),
                        seed=2)
    jsolver.restore(path)
    got = _host(jsolver.params)
    for k in ("bn1", "bn2", "bn3"):
        for i, b in enumerate(solver.params[k]):
            assert b.numpy().tobytes() == got[k][i].tobytes()
    model = tmp_path / "bn.prototxt"
    model.write_text(bn_net(batch=2, conv1=4, conv2=4, conv3=8))
    assert time_net.main(["--prototxt", str(model), "--per-layer",
                          "--iterations", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "bn3" in out and "BatchNorm" in out
