"""The training layers and the solver pieces of the port against the JAX
package, on the CPU.

SoftmaxWithLoss (with and without ``ignore_label``, both normalizations)
and Accuracy (``top_k``, ``ignore_label``) take the same numpy inputs in
both packages and agree at rtol 1e-5, atol 1e-6.  Dropout cannot match
the JAX package's ``jax.random`` masks, so it is held by its statistics
and its gradient.  The seven learning-rate policies agree with the JAX
package's at rtol 1e-5: the JAX package computes them in f32, whose
``pow`` is ~1e-6 off at iteration 39, the port in f64.  SGD with
momentum, gradient clipping, ``iter_size`` normalization and L2 or L1
weight decay tracks the JAX rule over 20 steps at rtol 1e-5, atol 1e-7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_impl
from sparknet_tpu.proto import SolverParameter as JaxSolverParameter
from sparknet_tpu.proto import load_solver_prototxt as jax_load_solver
from sparknet_tpu.solvers.lr_policies import learning_rate as jax_rate
from sparknet_tpu.solvers.update_rules import make_update_rule as jax_rule
from sparknet_tpu.solvers.update_rules import (
    preprocess_grads as jax_preprocess)
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import get_layer_impl as torch_impl
from sparknet_tpu_torch.proto import SolverParameter, load_solver_prototxt
from sparknet_tpu_torch.solvers import (learning_rate, make_update_rule,
                                        preprocess_grads)

RTOL, ATOL = 1e-5, 1e-6


def _both(type_, bottoms, **sub):
    want = jax_impl(type_).apply(
        jax_layer("l", type_, ["a", "b"], ["y"], **sub), [],
        [jnp.asarray(b) for b in bottoms], True, None)[0]
    got = torch_impl(type_).apply(
        torch_layer("l", type_, ["a", "b"], ["y"], **sub), [],
        [torch.from_numpy(b) for b in bottoms], True)[0]
    return got.numpy(), np.asarray(want)


def _scores_labels(shape, classes, seed, ignore=None):
    rng = np.random.default_rng(seed)
    scores = (3.0 * rng.normal(size=shape)).astype(np.float32)
    lshape = (shape[0],) + tuple(shape[2:])
    labels = rng.integers(0, classes, size=lshape).astype(np.float32)
    if ignore is not None:
        labels.flat[::3] = ignore
    return scores, labels


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("ignore", [None, 255, 2])
@pytest.mark.parametrize("shape", [(8, 10), (4, 5, 3, 2)],
                         ids=["flat", "spatial"])
def test_softmax_with_loss_matches_jax(shape, ignore, normalize):
    scores, labels = _scores_labels(shape, shape[1], 0, ignore)
    loss_param = {"normalize": normalize}
    if ignore is not None:
        loss_param["ignore_label"] = ignore
    got, want = _both("SoftmaxWithLoss", [scores, labels],
                      loss_param=loss_param)
    assert got.shape == () and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_softmax_with_loss_gradient_matches_jax():
    scores, labels = _scores_labels((6, 7), 7, 1, ignore=3)
    sub = {"loss_param": {"ignore_label": 3}}
    lp = jax_layer("l", "SoftmaxWithLoss", ["a", "b"], ["y"], **sub)
    want = jax.grad(lambda s: jax_impl("SoftmaxWithLoss").apply(
        lp, [], [s, jnp.asarray(labels)], True, None)[0])(jnp.asarray(scores))
    t = torch.from_numpy(scores).requires_grad_()
    loss = torch_impl("SoftmaxWithLoss").apply(
        torch_layer("l", "SoftmaxWithLoss", ["a", "b"], ["y"], **sub), [],
        [t, torch.from_numpy(labels)], True)[0]
    (got,) = torch.autograd.grad(loss, t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("top_k", [1, 3])
@pytest.mark.parametrize("ignore", [None, 1])
@pytest.mark.parametrize("shape", [(16, 10), (4, 6, 2, 3)],
                         ids=["flat", "spatial"])
def test_accuracy_matches_jax(shape, ignore, top_k):
    scores, labels = _scores_labels(shape, shape[1], 2, ignore)
    # integer scores make ties, which count in the label's favour
    scores = np.round(scores).astype(np.float32)
    acc = {"top_k": top_k}
    if ignore is not None:
        acc["ignore_label"] = ignore
    got, want = _both("Accuracy", [scores, labels], accuracy_param=acc)
    assert got.shape == ()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _dropout(x, ratio, gen, train=True):
    lp = torch_layer("d", "Dropout", ["x"], ["x"],
                     dropout_param={"dropout_ratio": ratio})
    return torch_impl("Dropout").apply(lp, [], [x], train, gen)[0]


@pytest.mark.parametrize("ratio", [0.5, 0.2])
def test_dropout_keep_rate_scaling_and_gradient(ratio):
    x = torch.full((256, 1024), 3.0, requires_grad=True)
    y = _dropout(x, ratio, torch.Generator().manual_seed(0))
    kept = y != 0
    keep = 1.0 - ratio
    # 262,144 Bernoulli draws: the keep rate's std is under 0.001
    assert abs(float(kept.float().mean()) - keep) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 3.0 / keep))
    (g,) = torch.autograd.grad(y.sum(), x)
    torch.testing.assert_close(g, kept.float() / keep)


def test_dropout_masks_follow_the_generator():
    x = torch.ones(64, 4096)
    a = _dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = _dropout(x, 0.5, torch.Generator().manual_seed(3))
    c = _dropout(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(_dropout(x, 0.5, None, train=False), x)
    assert torch.equal(_dropout(x, 0.0, None), x)


# every policy, with the fields it reads
POLICIES = {
    "fixed": {},
    "step": {"gamma": 0.1, "stepsize": 7},
    "exp": {"gamma": 0.97},
    "inv": {"gamma": 0.01, "power": 0.75},
    "multistep": {"gamma": 0.5, "stepvalue": [3, 9, 15]},
    "poly": {"power": 2.0, "max_iter": 40},
    "sigmoid": {"gamma": -0.3, "stepsize": 10},
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_lr_policy_matches_jax(policy):
    fields = dict(base_lr=0.02, lr_policy=policy, **POLICIES[policy])
    sp, jsp = SolverParameter(**fields), JaxSolverParameter(**fields)
    for it in range(0, 40, 3):
        np.testing.assert_allclose(learning_rate(sp, it),
                                   float(jax_rate(jsp, it)), rtol=1e-5,
                                   err_msg=f"iteration {it}")


def test_solver_fields_parse_like_jax():
    text = ('base_lr: 0.05 momentum: 0.9 weight_decay: 0.0005 '
            'lr_policy: "multistep" gamma: 0.1 stepvalue: 10 stepvalue: 20 '
            'iter_size: 2 clip_gradients: 5 regularization_type: "L1" '
            'type: "SGD"\n')
    sp, jsp = load_solver_prototxt(text), jax_load_solver(text)
    for f in ("base_lr", "momentum", "weight_decay", "lr_policy", "gamma",
              "stepvalue", "iter_size", "clip_gradients",
              "regularization_type", "solver_type", "stepsize", "power",
              "max_iter"):
        assert getattr(sp, f) == getattr(jsp, f), f


@pytest.mark.parametrize("extra", [
    {"weight_decay": 5e-3},
    {"weight_decay": 5e-3, "regularization_type": "L1"},
    {"clip_gradients": 0.5, "iter_size": 2, "weight_decay": 1e-3},
], ids=["l2", "l1", "clip-itersize"])
def test_sgd_with_preprocess_tracks_jax_for_20_steps(extra):
    fields = dict(base_lr=0.05, momentum=0.9, lr_policy="step", gamma=0.5,
                  stepsize=6, **extra)
    sp, jsp = SolverParameter(**fields), JaxSolverParameter(**fields)
    rng = np.random.default_rng(0)
    p0 = {"w": [rng.normal(size=(5, 4)).astype(np.float32),
                rng.normal(size=(5,)).astype(np.float32)]}
    lr_mults = {"w": [1.0, 2.0]}
    decay_mults = {"w": [1.0, 0.0]}
    params = {"w": [torch.from_numpy(b.copy()) for b in p0["w"]]}
    jparams = {"w": [jnp.asarray(b) for b in p0["w"]]}
    rule, jrule = make_update_rule(sp), jax_rule(jsp)
    state, jstate = rule.init(params), jrule.init(jparams)
    jl = {"w": [jnp.asarray(m) for m in lr_mults["w"]]}
    jd = {"w": [jnp.asarray(m) for m in decay_mults["w"]]}
    for it in range(20):
        g = [rng.normal(size=b.shape).astype(np.float32) for b in p0["w"]]
        grads = preprocess_grads(sp, params, {"w": [torch.from_numpy(a)
                                                    for a in g]},
                                 lr_mults, decay_mults)
        params, state = rule.apply(params, grads, state,
                                   learning_rate(sp, it), it,
                                   lr_mults=lr_mults)
        jgrads = jax_preprocess(jsp, jparams, {"w": [jnp.asarray(a)
                                                     for a in g]}, jl, jd)
        jparams, jstate = jrule.apply(jparams, jgrads, jstate,
                                      jax_rate(jsp, it), it, lr_mults=jl)
        for a, b in zip(params["w"], jparams["w"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {it}")


@pytest.mark.parametrize("solver", ["NESTEROV", "ADAGRAD", "RMSPROP",
                                    "ADADELTA", "ADAM"])
def test_unported_rules_raise(solver):
    """The five rules once refused here are ported: each, updating params
    and state in place, tracks the JAX rule for 20 steps (params and
    every state slot, rtol 1e-5, atol 1e-7, with lr_mults, weight decay
    and the step policy acting); an unknown solver type still raises."""
    fields = dict(base_lr=0.05 if solver != "ADADELTA" else 1.0,
                  momentum=0.9, lr_policy="step", gamma=0.5, stepsize=6,
                  weight_decay=5e-3, solver_type=solver, delta=1e-6,
                  momentum2=0.99, rms_decay=0.9)
    sp, jsp = SolverParameter(**fields), JaxSolverParameter(**fields)
    rng = np.random.default_rng(1)
    p0 = {"w": [rng.normal(size=(5, 4)).astype(np.float32),
                rng.normal(size=(5,)).astype(np.float32)]}
    lr_mults = {"w": [1.0, 2.0]}
    decay_mults = {"w": [1.0, 0.0]}
    params = {"w": [torch.from_numpy(b.copy()) for b in p0["w"]]}
    jparams = {"w": [jnp.asarray(b) for b in p0["w"]]}
    rule, jrule = make_update_rule(sp), jax_rule(jsp)
    assert rule.name == jrule.name == solver
    state, jstate = rule.init(params), jrule.init(jparams)
    assert sorted(state) == sorted(jstate)
    jl = {"w": [jnp.asarray(m) for m in lr_mults["w"]]}
    jd = {"w": [jnp.asarray(m) for m in decay_mults["w"]]}
    for it in range(20):
        g = [rng.normal(size=b.shape).astype(np.float32) for b in p0["w"]]
        grads = preprocess_grads(sp, params, {"w": [torch.from_numpy(a)
                                                    for a in g]},
                                 lr_mults, decay_mults)
        params, state = rule.apply(params, grads, state,
                                   learning_rate(sp, it), it,
                                   lr_mults=lr_mults)
        jgrads = jax_preprocess(jsp, jparams, {"w": [jnp.asarray(a)
                                                     for a in g]}, jl, jd)
        jparams, jstate = jrule.apply(jparams, jgrads, jstate,
                                      jax_rate(jsp, it), it, lr_mults=jl)
        pairs = list(zip(params["w"], jparams["w"])) + [
            (a, b) for slot in state
            for a, b in zip(state[slot]["w"], jstate[slot]["w"])]
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {it}")
    with pytest.raises(ValueError, match="unknown solver type"):
        make_update_rule(SolverParameter(solver_type=solver + "_X"))
