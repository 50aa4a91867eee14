"""Parameters shared across layers (``ParamSpec.name``, Caffe's
``AppendParam``), the port against the JAX package on the CPU.

The nets are tests/test_net.py's two (every blob shared; the weight only)
and a narrow mnist_siamese: Caffe's examples/siamese/
mnist_siamese_train_test.prototxt at 16x16 pairs with num_output 4/6/16/4
in place of 20/50/500/10, its two branches sharing every blob by name.
Storage is owner-only and compacted in both packages, so the port's
storage keys, shapes and multipliers equal the JAX ``init``'s; weights
cross by ``convert.params_from_jax`` and through ``.caffemodel`` files
each package writes with every layer's full blob list.  Forwards, losses
and gradients agree in f32 at rtol 1e-5, atol 1e-6 (bf16 at 2e-2, the
bound of tests/test_torch_net.py); ten Solver steps and a trainer round
agree at rtol 2e-4, atol 2e-5, the bound of tests/test_torch_solver.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.parallel import DistributedTrainer as JaxTrainer
from sparknet_tpu.parallel import TrainerConfig as JaxConfig
from sparknet_tpu.parallel import make_mesh
from sparknet_tpu.proto import NetState as JaxNetState
from sparknet_tpu.proto import Phase as JaxPhase
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_sp
from sparknet_tpu.solvers import Solver as JaxSolver
from sparknet_tpu_torch.convert import params_from_jax
from sparknet_tpu_torch.graph.net import Net
from sparknet_tpu_torch.parallel.trainer import (DistributedTrainer,
                                                 TrainerConfig)
from sparknet_tpu_torch.proto import (NetState, Phase, load_caffemodel,
                                      load_net_prototxt,
                                      load_solver_prototxt_with_net)
from sparknet_tpu_torch.solvers import Solver
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
STEP_RTOL, STEP_ATOL = 2e-4, 2e-5
BATCH = 8

# tests/test_net.py:86-131
SHARE_ALL = """
name: "siamese"
layer { name: "d" type: "Input" top: "a" top: "b"
        input_param { shape { dim: 2 dim: 4 } } }
layer { name: "ip_a" type: "InnerProduct" bottom: "a" top: "fa"
        param { name: "w" } param { name: "bias" }
        inner_product_param { num_output: 3
                              weight_filler { type: "xavier" } } }
layer { name: "ip_b" type: "InnerProduct" bottom: "b" top: "fb"
        param { name: "w" } param { name: "bias" }
        inner_product_param { num_output: 3
                              weight_filler { type: "xavier" } } }
"""
SHARE_WEIGHT = """
name: "partial"
layer { name: "d" type: "Input" top: "a" top: "b"
        input_param { shape { dim: 2 dim: 4 } } }
layer { name: "ip_a" type: "InnerProduct" bottom: "a" top: "fa"
        param { name: "w" }
        inner_product_param { num_output: 3
                              weight_filler { type: "xavier" }
                              bias_filler { type: "constant" value: 1 } } }
layer { name: "ip_b" type: "InnerProduct" bottom: "b" top: "fb"
        param { name: "w" }
        inner_product_param { num_output: 3
                              weight_filler { type: "xavier" }
                              bias_filler { type: "constant" value: 2 } } }
"""


def _branch(suffix: str, bottom: str) -> str:
    def p(name, lr):
        return f'param {{ name: "{name}" lr_mult: {lr} }}'

    def fillers():
        return ('weight_filler { type: "xavier" } '
                'bias_filler { type: "constant" }')
    s = suffix
    return f"""
layer {{ name: "conv1{s}" type: "Convolution" bottom: "{bottom}"
  top: "conv1{s}" {p("conv1_w", 1)} {p("conv1_b", 2)}
  convolution_param {{ num_output: 4 kernel_size: 5 stride: 1 {fillers()} }} }}
layer {{ name: "pool1{s}" type: "Pooling" bottom: "conv1{s}" top: "pool1{s}"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "conv2{s}" type: "Convolution" bottom: "pool1{s}"
  top: "conv2{s}" {p("conv2_w", 1)} {p("conv2_b", 2)}
  convolution_param {{ num_output: 6 kernel_size: 3 stride: 1 {fillers()} }} }}
layer {{ name: "pool2{s}" type: "Pooling" bottom: "conv2{s}" top: "pool2{s}"
  pooling_param {{ pool: MAX kernel_size: 2 stride: 2 }} }}
layer {{ name: "ip1{s}" type: "InnerProduct" bottom: "pool2{s}" top: "ip1{s}"
  {p("ip1_w", 1)} {p("ip1_b", 2)}
  inner_product_param {{ num_output: 16 {fillers()} }} }}
layer {{ name: "relu1{s}" type: "ReLU" bottom: "ip1{s}" top: "ip1{s}" }}
layer {{ name: "ip2{s}" type: "InnerProduct" bottom: "ip1{s}" top: "ip2{s}"
  {p("ip2_w", 1)} {p("ip2_b", 2)}
  inner_product_param {{ num_output: 4 {fillers()} }} }}
layer {{ name: "feat{s}" type: "InnerProduct" bottom: "ip2{s}" top: "feat{s}"
  {p("feat_w", 1)} {p("feat_b", 2)}
  inner_product_param {{ num_output: 2 {fillers()} }} }}
"""


NARROW_SIAMESE = f"""
name: "mnist_siamese_narrow"
input: "pair_data"
input_shape {{ dim: {BATCH} dim: 2 dim: 16 dim: 16 }}
input: "sim"
input_shape {{ dim: {BATCH} }}
layer {{ name: "slice_pair" type: "Slice" bottom: "pair_data"
  top: "data" top: "data_p" slice_param {{ slice_dim: 1 slice_point: 1 }} }}
{_branch("", "data")}
{_branch("_p", "data_p")}
layer {{ name: "loss" type: "ContrastiveLoss" bottom: "feat"
  bottom: "feat_p" bottom: "sim" top: "loss"
  contrastive_loss_param {{ margin: 1 }} }}
"""
# Caffe's mnist_siamese_solver.prototxt with a weight decay, so that the
# regularization of the summed gradient acts
SIAMESE_SOLVER = ('base_lr: 0.01\nmomentum: 0.9\nweight_decay: 0.0005\n'
                  'lr_policy: "inv"\ngamma: 0.0001\npower: 0.75\n')
OWNERS = ["conv1", "conv2", "ip1", "ip2", "feat"]


def _pairs(n: int, seed: int) -> list[dict]:
    """Pairs of 16x16 digits-like templates plus noise, label 1 when the
    two halves share a class."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0.0, 1.0, size=(4, 16, 16))
    out = []
    for _ in range(n):
        a = rng.integers(0, 4, size=BATCH)
        b = np.where(rng.random(BATCH) < 0.5, a, rng.integers(0, 4, BATCH))
        x = np.stack([templates[a], templates[b]], 1)
        x = x + 0.2 * rng.normal(size=x.shape)
        out.append({"pair_data": x.astype(np.float32),
                    "sim": (a == b).astype(np.float32)})
    return out


def _jax_net(text, phase=JaxPhase.TRAIN, **kw):
    return JaxNet(jax_load_net(text), JaxNetState(phase), **kw)


def _host(tree) -> dict:
    return {k: [np.asarray(b) for b in v]
            for k, v in jax.device_get(tree).items()}


@pytest.mark.parametrize("text", [SHARE_ALL, SHARE_WEIGHT, NARROW_SIAMESE],
                         ids=["share_all", "share_weight", "siamese"])
def test_storage_and_multipliers_equal_the_jax_init(text):
    net = Net(load_net_prototxt(text), NetState(Phase.TRAIN))
    jnet = _jax_net(text)
    want = _host(jnet.init(jax.random.PRNGKey(0)))
    assert net.param_shapes() == {k: [b.shape for b in v]
                                  for k, v in want.items()}
    params = net.init(device="cpu")
    assert {k: [tuple(b.shape) for b in v] for k, v in params.items()} == \
        net.param_shapes()
    jparams = jnet.init(jax.random.PRNGKey(0))
    for tree, jtree in ((net.lr_mult_tree(params), jnet.lr_mult_tree(jparams)),
                        (net.decay_mult_tree(params),
                         jnet.decay_mult_tree(jparams))):
        assert tree == {k: [float(m) for m in v] for k, v in jtree.items()}


def test_the_siamese_stores_owners_only_and_hands_sharers_their_tensor():
    net = Net(load_net_prototxt(NARROW_SIAMESE), NetState(Phase.TRAIN))
    params = net.init(device="cpu")
    assert list(params) == OWNERS
    by_name = {n.lp.name: n for n in net.nodes}
    for owner in OWNERS:
        mine = net.node_params(params, by_name[owner])
        theirs = net.node_params(params, by_name[owner + "_p"])
        assert len(theirs) == 2
        assert all(a is b for a, b in zip(mine, theirs))
    full = net.full_params(params)
    assert sorted(full) == sorted(OWNERS + [o + "_p" for o in OWNERS])
    # the test net resolves the same owners (tests/test_net.py:38)
    test = Net(load_net_prototxt(NARROW_SIAMESE), NetState(Phase.TEST))
    assert test.param_shapes() == net.param_shapes()
    assert {n.lp.name: n.shared_refs for n in test.nodes} == \
        {n.lp.name: n.shared_refs for n in net.nodes}


def test_share_all_and_share_weight_outputs():
    x = np.random.default_rng(0).normal(size=(2, 4)).astype(np.float32)
    net = Net(load_net_prototxt(SHARE_ALL))
    out = net.apply(net.init(device="cpu"), {"a": torch.from_numpy(x),
                                              "b": torch.from_numpy(x)})
    torch.testing.assert_close(out["fa"], out["fb"], rtol=0, atol=0)
    net = Net(load_net_prototxt(SHARE_WEIGHT))
    params = net.init(device="cpu")
    assert [len(params[k]) for k in ("ip_a", "ip_b")] == [2, 1]
    out = net.apply(params, {"a": torch.from_numpy(x),
                             "b": torch.from_numpy(x)})
    torch.testing.assert_close(out["fb"] - out["fa"], torch.ones(2, 3),
                               rtol=1e-5, atol=1e-6)


def _loss_and_grads(net, params, batch):
    leaves = {k: [b.detach().clone().requires_grad_() for b in v]
              for k, v in params.items()}
    out = net.forward(leaves, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, train=True)
    flat = [b for v in leaves.values() for b in v]
    grads = iter(torch.autograd.grad(out.loss, flat))
    return float(out.loss.detach()), {k: [next(grads).numpy() for _ in v]
                             for k, v in leaves.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("text", [SHARE_ALL, SHARE_WEIGHT, NARROW_SIAMESE],
                         ids=["share_all", "share_weight", "siamese"])
def test_loss_and_gradients_match_jax(text, dtype):
    bf16 = dtype == "bf16"
    jnet = _jax_net(text, compute_dtype=jnp.bfloat16 if bf16 else None)
    net = Net(load_net_prototxt(text), NetState(Phase.TRAIN),
              compute_dtype=torch.bfloat16 if bf16 else None)
    jparams = jnet.init(jax.random.PRNGKey(3))
    params = params_from_jax(_host(jparams), net, device="cpu")
    if text is NARROW_SIAMESE:
        batch = _pairs(1, 5)[0]
        tops = ["loss"]
    else:
        rng = np.random.default_rng(5)
        batch = {k: rng.normal(size=(2, 4)).astype(np.float32)
                 for k in ("a", "b")}
        tops = ["fa", "fb"]
    # the siamese's own loss; the two-branch nets a weighted sum of their
    # tops, so that both branches' gradients reach the owner
    weights = {"fa": np.arange(6.0).reshape(2, 3),
               "fb": np.arange(6.0)[::-1].reshape(2, 3).copy()}

    def jloss(p):
        out = jnet.apply(p, {k: jnp.asarray(v) for k, v in batch.items()},
                         train=True)
        if tops == ["loss"]:
            return out.loss
        return sum(jnp.sum(out.blobs[t].astype(jnp.float32) * weights[t])
                   for t in tops)

    jl, jg = jax.value_and_grad(jloss)(jparams)
    if tops == ["loss"]:
        loss, grads = _loss_and_grads(net, params, batch)
    else:
        leaves = {k: [b.detach().clone().requires_grad_() for b in v]
                  for k, v in params.items()}
        out = net.apply(leaves, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, train=True)
        total = sum((out[t].float() * torch.from_numpy(weights[t]).float()
                     ).sum() for t in tops)
        flat = [b for v in leaves.values() for b in v]
        g = iter(torch.autograd.grad(total, flat))
        loss, grads = float(total.detach()), {k: [next(g).numpy() for _ in v]
                                     for k, v in leaves.items()}
    rtol, atol = (2e-2, 2e-2) if bf16 else (RTOL, ATOL)
    assert loss == pytest.approx(float(jl), rel=rtol, abs=atol)
    want = _host(jg)
    assert sorted(grads) == sorted(want)
    for k in want:
        for g, w in zip(grads[k], want[k]):
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * scale)


def test_owner_gradient_is_the_sum_of_both_branches():
    net = Net(load_net_prototxt(SHARE_ALL))
    params = net.init(device="cpu")
    rng = np.random.default_rng(6)
    a, b = (torch.from_numpy(rng.normal(size=(2, 4)).astype(np.float32))
            for _ in range(2))
    w = params["ip_a"][0].detach().requires_grad_()
    live = {"ip_a": [w, params["ip_a"][1]]}
    out = net.apply(live, {"a": a, "b": b})
    (gw,) = torch.autograd.grad((out["fa"] + out["fb"]).sum(), [w])
    torch.testing.assert_close(gw, (a + b).sum(0).expand(3, 4),
                               rtol=1e-6, atol=1e-6)


MERGE = """
layer {{ name: "d" type: "Input" top: "a" top: "b"
        input_param {{ shape {{ dim: 2 dim: 4 }} shape {{ dim: 2 dim: {b} }} }} }}
layer {{ name: "ip_a" type: "{owner_type}" bottom: "a" top: "fa"
        param {{ name: "w" {owner} }}
        inner_product_param {{ num_output: 3 }} }}
layer {{ name: "ip_b" type: "InnerProduct" bottom: "b" top: "fb"
        param {{ name: "w" {sharer} }}
        inner_product_param {{ num_output: 3 }} }}
"""


@pytest.mark.parametrize("owner,sharer", [
    ("", "lr_mult: 3 decay_mult: 0.5"), ("lr_mult: 2", "decay_mult: 0"),
    ("lr_mult: 2 decay_mult: 0", "lr_mult: 2")])
def test_a_sharers_explicit_multiplier_goes_to_an_unset_owner(owner, sharer):
    text = MERGE.format(b=4, owner_type="InnerProduct", owner=owner,
                        sharer=sharer)
    net = Net(load_net_prototxt(text))
    params = net.init(device="cpu")
    jnet = _jax_net(text, JaxPhase.TEST)
    jparams = jnet.init(jax.random.PRNGKey(0))
    for tree, jtree in ((net.lr_mult_tree(params), jnet.lr_mult_tree(jparams)),
                        (net.decay_mult_tree(params),
                         jnet.decay_mult_tree(jparams))):
        assert tree == {k: [float(m) for m in v] for k, v in jtree.items()}


@pytest.mark.parametrize("fields,match", [
    ({"owner": "lr_mult: 1", "sharer": "lr_mult: 2"},
     "shared param lr_mult mismatch"),
    ({"owner": "decay_mult: 1", "sharer": "decay_mult: 0"},
     "shared param decay_mult mismatch"),
    ({"b": 5}, "shared param shape mismatch"),
    ({"owner_type": "ReLU"}, "which has only 0 blobs"),
], ids=["lr_mult", "decay_mult", "shape", "owner_blob_count"])
def test_sharing_errors_match_jax(fields, match):
    text = MERGE.format(**{"b": 4, "owner_type": "InnerProduct",
                           "owner": "", "sharer": "", **fields})
    with pytest.raises(ValueError, match=match):
        _jax_net(text, JaxPhase.TEST)
    with pytest.raises(ValueError, match=match):
        Net(load_net_prototxt(text))


def _solvers(tmp_path):
    jsolver = JaxSolver(jax_sp(SIAMESE_SOLVER, jax_load_net(NARROW_SIAMESE)),
                        seed=0)
    solver = Solver(load_solver_prototxt_with_net(
        SIAMESE_SOLVER, load_net_prototxt(NARROW_SIAMESE)), seed=1,
        device="cpu")
    path, _ = jsolver.snapshot_caffe(str(tmp_path / "jax_init"))
    solver.load_weights(path)
    want = _host(jsolver.params)
    assert sorted(solver.params) == sorted(want) == sorted(OWNERS)
    for k, blobs in solver.params.items():
        for b, w in zip(blobs, want[k]):
            assert b.numpy().tobytes() == w.tobytes(), k
    return jsolver, solver


def test_ten_solver_steps_track_the_jax_solver(tmp_path):
    jsolver, solver = _solvers(tmp_path)
    batches = _pairs(10, 11)
    jsolver.set_train_data(iter(batches))
    solver.set_train_data(iter(batches))
    ours = [solver.step(1) for _ in batches]
    theirs = [jsolver.step(1) for _ in batches]
    np.testing.assert_allclose(ours, theirs, rtol=STEP_RTOL, atol=STEP_ATOL)
    want = _host(jsolver.params)
    for k, blobs in solver.params.items():
        for b, w in zip(blobs, want[k]):
            np.testing.assert_allclose(b.numpy(), w, rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
    # the momentum history is the owners' too
    for k, blobs in solver.state["history"].items():
        for b, w in zip(blobs, _host(jsolver.state["history"])[k]):
            np.testing.assert_allclose(b.numpy(), w, rtol=1e-3, atol=STEP_ATOL)


def test_caffemodels_carry_full_blob_lists_both_ways(tmp_path):
    jsolver, solver = _solvers(tmp_path)
    solver.set_train_data(iter(_pairs(2, 12)))
    solver.step(2)
    model, _ = solver.snapshot_caffe(str(tmp_path / "port"))
    saved = load_caffemodel(model)
    assert sorted(saved) == sorted(OWNERS + [o + "_p" for o in OWNERS])
    for o in OWNERS:
        for a, b, p in zip(saved[o], saved[o + "_p"], solver.params[o]):
            assert a.tobytes() == b.tobytes() == p.numpy().tobytes()
    jsolver.load_weights(model)
    want = _host(jsolver.params)
    for k, blobs in solver.params.items():
        for b, w in zip(blobs, want[k]):
            assert b.numpy().tobytes() == w.tobytes(), k


def test_a_sharers_blobs_load_into_the_owner_last_write_winning(tmp_path):
    _, solver = _solvers(tmp_path)
    full = {k: [b.numpy().copy() for b in v]
            for k, v in solver.train_net.full_params(solver.params).items()}
    full["conv1_p"][0] = full["conv1_p"][0] + 1.0    # the later writer
    solver.copy_trained_layers_from(full)
    np.testing.assert_array_equal(solver.params["conv1"][0].numpy(),
                                  full["conv1_p"][0])
    # a sharer with a short blob list fails before anything is written
    before = solver.params["conv2"][0].clone()
    full["conv2"][0] = full["conv2"][0] + 1.0
    full["ip1_p"] = full["ip1_p"][:1]
    with pytest.raises(ValueError, match="ip1_p"):
        solver.copy_trained_layers_from(full)
    torch.testing.assert_close(solver.params["conv2"][0], before,
                               rtol=0, atol=0)


def _rounds(n: int, seed: int, tau: int, workers: int) -> list[dict]:
    pairs = _pairs(n * tau * workers, seed)
    out = []
    for r in range(n):
        chunk = pairs[r * tau * workers:(r + 1) * tau * workers]
        out.append({k: np.stack([np.concatenate(
            [chunk[t * workers + w][k] for w in range(workers)])
            for t in range(tau)]) for k in chunk[0]})
    return out


def test_trainer_round_codec_and_snapshot_run_over_the_shared_storage(
        tmp_path):
    jsp = jax_sp(SIAMESE_SOLVER, jax_load_net(NARROW_SIAMESE))
    sp = load_solver_prototxt_with_net(SIAMESE_SOLVER,
                                       load_net_prototxt(NARROW_SIAMESE))
    jtr = JaxTrainer(jsp, make_mesh(2), JaxConfig(tau=2), seed=0)
    tr = DistributedTrainer(sp, 2, TrainerConfig(tau=2), seed=0,
                            device="cpu")
    tr.params = params_from_jax(jax.device_get(jtr.params), tr.train_net,
                                device="cpu")
    for batches in _rounds(2, 13, 2, 2):
        ours = tr.train_round(batches)
        theirs = float(jtr.train_round(batches))
        assert ours == pytest.approx(theirs, rel=STEP_RTOL, abs=STEP_ATOL)
    want = _host(jtr.params)
    assert sorted(tr.params) == sorted(want) == sorted(OWNERS)
    for k, blobs in tr.params.items():
        for b, w in zip(blobs, want[k]):
            np.testing.assert_allclose(b.numpy(), w, rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
    path = str(tmp_path / "round.npz")
    tr.snapshot(path)
    back = DistributedTrainer(sp, 2, TrainerConfig(tau=2), seed=5,
                              device="cpu")
    back.restore(path)
    for k, blobs in tr.params.items():
        for a, b in zip(blobs, back.params[k]):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    # a compressed exchange keeps a residual a stored blob
    ctr = DistributedTrainer(sp, 2, TrainerConfig(tau=2, comm_codec="int8"),
                             seed=0, device="cpu")
    ctr.train_round(_rounds(1, 14, 2, 2)[0])
    assert {k: [tuple(b.shape[1:]) for b in v]
            for k, v in ctr.comm_residual.items()} == \
        ctr.train_net.param_shapes()
