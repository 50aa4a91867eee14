"""The neuron and loss layers, the port against the JAX package on the CPU:
AbsVal, BNLL, Exp, Log, Power, PReLU, Sigmoid, TanH and Threshold;
MultinomialLogisticLoss, EuclideanLoss, SigmoidCrossEntropyLoss,
HingeLoss, InfogainLoss and ContrastiveLoss.

Each layer takes the same numpy inputs (and, for PReLU, the same slopes)
in both packages, and the same numpy cotangent on each top; forwards and
the gradients of every float bottom and param (``jax.vjp`` against
``torch.autograd``) agree in f32 at rtol 1e-5, atol 1e-6.  In bf16 both
packages compute in bf16 and agree at rtol and atol 2e-2, the bf16 bound
of tests/test_torch_net.py: a loss's sum over bf16 terms accumulates in
bf16 in XLA and in f32 in torch.  The edge cases are those of
tests/test_ops.py: a zero probability at the label (clamped at 1e-20 in
both), InfogainLoss's H as a third bottom and from a ``source``
binaryproto, ContrastiveLoss at distance 0 and in its legacy form, and
Power's ``power: 1`` shortcut.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_impl
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import get_layer_impl as torch_impl
from torch_threads import one_torch_thread  # noqa: F401

TOL = {"f32": (1e-5, 1e-6), "bf16": (2e-2, 2e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _run(type_, bottoms, *, params=(), wrt=None, dtype="f32", **sub):
    """(port tops, JAX tops, port grads, JAX grads) of one layer: the
    grads of the bottoms listed in ``wrt`` (all by default), then of
    every param, under one random cotangent a top."""
    jdt, tdt = DTYPES[dtype]
    wrt = list(range(len(bottoms))) if wrt is None else wrt
    names = [f"b{i}" for i in range(len(bottoms))]
    jlp = jax_layer("l", type_, names, ["y"], **sub)
    tlp = torch_layer("l", type_, names, ["y"], **sub)
    cast = lambda a: a.astype(np.float32) if a.dtype.kind == "f" else a

    def jax_fn(diff, ps):
        bots = [jnp.asarray(b) for b in bottoms]
        for i, d in zip(wrt, diff):
            bots[i] = d
        bots = [b.astype(jdt) if i in wrt else b for i, b in enumerate(bots)]
        return tuple(jax_impl(type_).apply(
            jlp, [p.astype(jdt) for p in ps], bots, True, None))

    diff0 = [jnp.asarray(cast(bottoms[i])).astype(jdt) for i in wrt]
    ps0 = [jnp.asarray(p).astype(jdt) for p in params]
    want, vjp = jax.vjp(jax_fn, diff0, ps0)
    rng = np.random.default_rng(7)
    cots = [rng.normal(size=np.shape(w)).astype(np.float32) for w in want]
    jd, jp = vjp(tuple(jnp.asarray(c).astype(jdt) for c in cots))

    xs = [torch.from_numpy(np.array(b)) for b in bottoms]
    xs = [x.to(tdt).requires_grad_() if i in wrt else x
          for i, x in enumerate(xs)]
    ps = [torch.from_numpy(np.array(p)).to(tdt).requires_grad_()
          for p in params]
    got = torch_impl(type_).apply(tlp, ps, xs, True)
    leaves = [xs[i] for i in wrt] + ps
    live = [g for g in got if g.requires_grad]
    grads = [None] * len(leaves)
    if live:
        grads = torch.autograd.grad(
            live, leaves, [torch.from_numpy(c).to(tdt)
                           for g, c in zip(got, cots) if g.requires_grad],
            allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    f = lambda t: t.detach().float().numpy()
    j = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return ([f(g) for g in got], [j(w) for w in want],
            [f(g) for g in grads], [j(g) for g in list(jd) + list(jp)])


def _check(type_, bottoms, dtype, **kw):
    got, want, grads, jgrads = _run(type_, bottoms, dtype=dtype, **kw)
    rtol, atol = TOL[dtype]
    assert len(got) == len(want) and len(grads) == len(jgrads)
    for g, w in zip(got + grads, want + jgrads):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return got, grads


X = np.random.default_rng(0).normal(size=(2, 3, 4, 5)).astype(np.float32)
POS = np.abs(X) + 0.5

NEURON_CASES = [
    ("AbsVal", X, {}),
    ("BNLL", 3.0 * X, {}),
    ("Exp", X, {}),
    ("Exp_base2", X, {"exp_param": {"base": 2.0, "scale": 0.5,
                                    "shift": 0.1}}),
    ("Log", POS, {}),
    ("Log_base10", POS, {"log_param": {"base": 10.0, "scale": 2.0,
                                       "shift": 1.0}}),
    ("Power", X, {"power_param": {"power": 2.0, "scale": 3.0,
                                  "shift": 1.0}}),
    ("Power_one", X, {"power_param": {"scale": 2.0, "shift": 0.5}}),
    ("Power_sqrt", POS, {"power_param": {"power": 0.5}}),
    ("Sigmoid", 3.0 * X, {}),
    ("TanH", 2.0 * X, {}),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", NEURON_CASES, ids=lambda c: c[0])
def test_neuron_matches_jax(case, dtype):
    name, x, sub = case
    _check(name.split("_")[0], [x], dtype, **sub)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shared", [False, True])
def test_prelu_matches_jax_with_its_slope_gradient(shared, dtype):
    slopes = np.random.default_rng(1).uniform(
        0.0, 0.5, size=(1 if shared else 3,)).astype(np.float32)
    _, grads = _check("PReLU", [X], dtype, params=[slopes],
                      prelu_param={"channel_shared": shared})
    assert np.abs(grads[1]).max() > 0


@pytest.mark.parametrize("shared", [False, True])
def test_prelu_init_is_a_quarter_or_its_filler(shared):
    lp = torch_layer("l", "PReLU", ["x"], ["y"],
                     prelu_param={"channel_shared": shared})
    blobs = torch_impl("PReLU").init(torch.Generator(), lp, [(2, 3, 4, 5)])
    jblobs = jax_impl("PReLU").init(
        jax.random.PRNGKey(0), jax_layer("l", "PReLU", ["x"], ["y"],
                                         prelu_param={"channel_shared":
                                                      shared}),
        [(2, 3, 4, 5)])
    assert blobs[0].shape == jblobs[0].shape == ((1,) if shared else (3,))
    np.testing.assert_array_equal(blobs[0].numpy(), np.asarray(jblobs[0]))
    assert torch_impl("PReLU").param_shapes(lp, [(2, 3, 4, 5)]) == [
        tuple(blobs[0].shape)]
    lp = torch_layer("l", "PReLU", ["x"], ["y"], prelu_param={
        "filler": {"type": "constant", "value": 0.1}})
    assert torch_impl("PReLU").init(torch.Generator(), lp,
                                    [(2, 3, 4, 5)])[0].tolist() == \
        pytest.approx([0.1] * 3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_threshold_forward_and_zero_gradient(dtype):
    x = X.copy()
    x[0, 0, 0, :3] = 0.3                   # on the threshold: not above it
    got, grads = _check("Threshold", [x], dtype,
                        threshold_param={"threshold": 0.3})
    assert got[0][0, 0, 0, :3].tolist() == [0.0, 0.0, 0.0]
    assert not np.any(grads[0])


def _probs(n: int, c: int, seed: int) -> np.ndarray:
    z = np.random.default_rng(seed).normal(size=(n, c))
    return (np.exp(z) / np.exp(z).sum(1, keepdims=True)).astype(np.float32)


LABELS = np.array([0, 3, 1, 4], np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_multinomial_logistic_loss_with_a_zero_probability(dtype):
    p = _probs(4, 5, 2)
    p[1, 3] = 0.0                          # the label's probability
    got, grads = _check("MultinomialLogisticLoss", [p, LABELS], dtype,
                        wrt=[0])
    # the clamped term is -log(1e-20) = 46.05 over the batch of 4
    assert got[0] > 46.0 / 4
    assert grads[0][1, 3] == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_euclidean_loss(dtype):
    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2))
    got, _ = _check("EuclideanLoss", [a, b], dtype)
    if dtype == "f32":
        assert got[0] == pytest.approx(((a - b) ** 2).sum() / 8, rel=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sigmoid_cross_entropy_loss(dtype):
    rng = np.random.default_rng(4)
    x = (4.0 * rng.normal(size=(4, 6))).astype(np.float32)
    t = rng.uniform(size=(4, 6)).astype(np.float32)
    got, _ = _check("SigmoidCrossEntropyLoss", [x, t], dtype)
    if dtype == "f32":
        p = 1 / (1 + np.exp(-x.astype(np.float64)))
        ref = -np.sum(t * np.log(p) + (1 - t) * np.log(1 - p)) / 4
        assert got[0] == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("norm", ["L1", "L2"])
def test_hinge_loss(norm, dtype):
    s = np.random.default_rng(5).normal(size=(4, 5)).astype(np.float32)
    _check("HingeLoss", [s, LABELS], dtype, wrt=[0],
           hinge_loss_param={"norm": norm})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_infogain_loss_from_a_third_bottom(dtype):
    p = _probs(4, 5, 6)
    p[2, 0] = 0.0                          # a clamped log, weighted by H
    H = np.random.default_rng(7).uniform(0.0, 2.0, size=(5, 5)).astype(
        np.float32)
    _check("InfogainLoss", [p, LABELS, H], dtype, wrt=[0, 2])


def test_infogain_loss_from_a_source_binaryproto(tmp_path):
    from sparknet_tpu_torch.proto.caffemodel import save_mean_binaryproto
    p = _probs(4, 5, 8)
    H = (2.0 * np.eye(5) + 0.1).astype(np.float32)
    path = str(tmp_path / "H.binaryproto")
    save_mean_binaryproto(path, H[None])
    from_file = _run("InfogainLoss", [p, LABELS], wrt=[0],
                     infogain_loss_param={"source": path})
    from_bottom = _run("InfogainLoss", [p, LABELS, H], wrt=[0])
    for got, want in zip(from_file[0] + from_file[2],
                         from_file[1] + from_file[3]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(from_file[0][0], from_bottom[0][0],
                               rtol=1e-6)
    lp = torch_layer("l", "InfogainLoss", ["p", "y"], ["loss"])
    with pytest.raises(ValueError, match="needs H"):
        torch_impl("InfogainLoss").apply(
            lp, [], [torch.from_numpy(p), torch.from_numpy(LABELS)], True)


CONTRASTIVE_A = np.random.default_rng(9).normal(size=(6, 2)).astype(
    np.float32)
SIM = np.array([1, 0, 1, 0, 0, 1], np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("legacy", [False, True])
def test_contrastive_loss_with_a_zero_distance(legacy, dtype):
    b = np.random.default_rng(10).normal(size=(6, 2)).astype(np.float32)
    b[1] = CONTRASTIVE_A[1]                # d = 0 on a dissimilar pair
    b[3] = CONTRASTIVE_A[3] + 0.01         # inside the margin
    got, grads = _check("ContrastiveLoss", [CONTRASTIVE_A, b, SIM], dtype,
                        wrt=[0, 1], contrastive_loss_param={
                            "margin": 1.0, "legacy_version": legacy})
    assert np.all(np.isfinite(grads[0])) and np.all(np.isfinite(grads[1]))
    if dtype == "f32":
        a64, b64 = CONTRASTIVE_A.astype(np.float64), b.astype(np.float64)
        d2 = ((a64 - b64) ** 2).sum(1)
        neg = (np.maximum(1.0 - d2, 0.0) if legacy
               else np.maximum(1.0 - np.sqrt(d2 + 1e-12), 0.0) ** 2)
        ref = np.sum(SIM * d2 + (1 - SIM) * neg) / 12
        assert got[0] == pytest.approx(ref, rel=1e-5)


def test_contrastive_loss_legacy_differs():
    """The two forms disagree on these pairs, so a flipped
    ``legacy_version`` shows."""
    b = np.random.default_rng(11).normal(size=(6, 2)).astype(np.float32)
    new = _run("ContrastiveLoss", [CONTRASTIVE_A, b, SIM], wrt=[0, 1])[0][0]
    old = _run("ContrastiveLoss", [CONTRASTIVE_A, b, SIM], wrt=[0, 1],
               contrastive_loss_param={"legacy_version": True})[0][0]
    assert abs(float(new) - float(old)) > 1e-3


def test_the_port_registers_the_new_types():
    from sparknet_tpu.ops.registry import _REGISTRY as jax_registry
    from sparknet_tpu_torch.ops.registry import _REGISTRY
    new = {"AbsVal", "BNLL", "Exp", "Log", "Power", "PReLU", "Sigmoid",
           "TanH", "Threshold", "MultinomialLogisticLoss", "EuclideanLoss",
           "SigmoidCrossEntropyLoss", "HingeLoss", "InfogainLoss",
           "ContrastiveLoss", "Slice"}
    assert new <= set(_REGISTRY) <= set(jax_registry)
    # every type since the layer library's last slice
    assert len(_REGISTRY) == len(jax_registry) == 54
