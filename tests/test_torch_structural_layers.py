"""The structural layers of ``ops/common.py``, the port against the JAX
package on the CPU: Scale, Bias, MVN, Embed, Reshape, Eltwise,
Reduction, Tile, BatchReindex, Filter, ArgMax, Silence and BatchNorm,
forward and the gradients of the float bottoms and the blobs, in f32
and in bf16, with the Caffe edge cases that tests/test_ops.py holds
(and those of the JAX package's indexing: an index out of range is
clamped, a negative one counts from the end, a float one truncates).

Both packages take the same numpy inputs, blobs and cotangent.  f32 at
rtol 1e-5, atol 1e-6 (tests/test_torch_zoo_layers.py), the forwards and
the gradients alike.  bf16 at atol 2e-2 (the bf16 bound of
tests/test_torch_zoo_layers.py) times max(1, max|want|): 2e-2 is under
one bf16 step of a value above 4, and Bias's and Scale's values reach
14; the worst reading is Scale's scale gradient, 0.156 off at a
largest value of 9.56 (0.0163 of the scale, 0.82 of the bound).  The
bounds in the code: f32 forwards and gradients ``RTOL, ATOL = 1e-5,
1e-6``; bf16 forwards and gradients ``BF16_ATOL * max(1, max|want|)``
with ``BF16_ATOL = 2e-2`` and no relative term; BatchNorm's stored
variance against m/(m-1) times the biased one at rtol 1e-5; the
BatchNorm net's ``y`` at rtol 1e-5, atol 1e-6.  Index outputs (ArgMax
without values, Embed's gather) agree exactly in f32.
The registry: the port registers the JAX package's 54 types.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu.graph.net import Net as JaxNet
from sparknet_tpu.models.dsl import layer as jax_layer
from sparknet_tpu.ops import get_layer_impl as jax_impl
from sparknet_tpu.ops import registered_types as jax_types
from sparknet_tpu.proto import load_net_prototxt as jax_load_net
from sparknet_tpu_torch.graph import Net
from sparknet_tpu_torch.models.dsl import layer as torch_layer
from sparknet_tpu_torch.ops import get_layer_impl as torch_impl
from sparknet_tpu_torch.ops import registered_types
from sparknet_tpu_torch.proto import load_net_prototxt
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
BF16_ATOL = 2e-2

_G = np.random.default_rng(7)
X = _G.normal(size=(4, 3, 5, 6)).astype(np.float32)
X2 = _G.normal(size=(4, 3, 5, 6)).astype(np.float32)
X3 = _G.normal(size=(4, 3, 5, 6)).astype(np.float32)
V3 = _G.uniform(0.5, 1.5, size=(3,)).astype(np.float32)
M35 = _G.normal(size=(3, 5)).astype(np.float32)
TABLE = _G.normal(size=(7, 4)).astype(np.float32)
BIAS4 = _G.normal(size=(4,)).astype(np.float32)
# indices at the edges: in range, one past the end, far past, -1, a
# negative beyond -n, and floats that truncate toward zero
IDX = np.array([[0, 6, 7], [-1, -9, 2.7], [-0.5, 100, 3]], np.float32)
TIES = np.array([[[1, 3, 3, 0], [3, 2, 3, -1]],
                 [[0, 0, 0, 0], [5, 5, 1, 5]]], np.float32)
SEL = np.array([1, 0, 1, 1], np.float32)

# (id, type, bottoms, float bottoms to differentiate, blobs, sub-messages,
#  tops)
CASES = [
    ("scale", "Scale", [X], [0], [V3], {}, 1),
    ("scale_bias_axes2", "Scale", [X], [0], [M35, M35 + 1.0],
     {"scale_param": {"num_axes": 2, "bias_term": True}}, 1),
    ("scale_two_bottoms_bias", "Scale", [X, M35], [0, 1], [V3[:1] * M35],
     {"scale_param": {"bias_term": True}}, 1),
    ("scale_axis0_all", "Scale", [X[0], X2[0] + 2.0], [0, 1], [],
     {"scale_param": {"axis": 0, "num_axes": -1}}, 1),
    ("bias", "Bias", [X], [0], [V3], {}, 1),
    ("bias_two_bottoms_axis2", "Bias", [X, X2[0, 0]], [0, 1], [],
     {"bias_param": {"axis": 2}}, 1),
    ("mvn", "MVN", [3.0 + 2.0 * X], [0], [], {}, 1),
    ("mvn_across_channels", "MVN", [3.0 + 2.0 * X], [0], [],
     {"mvn_param": {"across_channels": True, "eps": 1e-3}}, 1),
    ("mvn_mean_only", "MVN", [X], [0], [],
     {"mvn_param": {"normalize_variance": False}}, 1),
    ("embed_edges", "Embed", [IDX], [], [TABLE, BIAS4],
     {"embed_param": {"num_output": 4, "input_dim": 7}}, 1),
    ("embed_no_bias", "Embed", [IDX[0]], [], [TABLE],
     {"embed_param": {"num_output": 4, "input_dim": 7,
                      "bias_term": False}}, 1),
    ("reshape_0_-1", "Reshape", [X], [0], [],
     {"reshape_param": {"shape": {"dim": [0, -1, 10]}}}, 1),
    ("reshape_axis_num_axes", "Reshape", [X], [0], [],
     {"reshape_param": {"shape": {"dim": [3, 1]}, "axis": 1,
                        "num_axes": 1}}, 1),
    ("reshape_axis_-1", "Reshape", [X], [0], [],
     {"reshape_param": {"shape": {"dim": [2, 3]}, "axis": -1}}, 1),
    ("eltwise_sum_default", "Eltwise", [X, X2], [0, 1], [], {}, 1),
    ("eltwise_sum_coeffs", "Eltwise", [X, X2, X3], [0, 1, 2], [],
     {"eltwise_param": {"operation": "SUM", "coeff": [1.0, -0.5, 2.0]}}, 1),
    ("eltwise_prod", "Eltwise", [X, X2, X3], [0, 1, 2], [],
     {"eltwise_param": {"operation": "PROD"}}, 1),
    ("eltwise_max", "Eltwise", [X, X2], [0, 1], [],
     {"eltwise_param": {"operation": "MAX"}}, 1),
    ("reduction_sum", "Reduction", [X], [0], [], {}, 1),
    ("reduction_asum_axis1", "Reduction", [X], [0], [],
     {"reduction_param": {"operation": "ASUM", "axis": 1}}, 1),
    ("reduction_sumsq_coeff", "Reduction", [X], [0], [],
     {"reduction_param": {"operation": "SUMSQ", "axis": 2,
                          "coeff": 0.5}}, 1),
    ("reduction_mean_axis-1", "Reduction", [X], [0], [],
     {"reduction_param": {"operation": "MEAN", "axis": -1}}, 1),
    ("tile_axis1", "Tile", [X], [0], [], {"tile_param": {"tiles": 3}}, 1),
    ("tile_axis-1", "Tile", [X], [0], [],
     {"tile_param": {"axis": -1, "tiles": 2}}, 1),
    ("batch_reindex_edges", "BatchReindex",
     [X, np.array([2, 0, 0, 3, -1, 7, -6.5], np.float32)], [0], [], {}, 1),
    ("filter", "Filter", [X, X2, SEL], [0, 1], [], {}, 2),
    ("argmax_ties", "ArgMax", [TIES], [], [],
     {"argmax_param": {"top_k": 3}}, 1),
    ("argmax_values", "ArgMax", [TIES + 0.25 * TIES ** 2], [0], [],
     {"argmax_param": {"top_k": 2, "out_max_val": True}}, 1),
    ("argmax_axis", "ArgMax", [TIES], [], [],
     {"argmax_param": {"top_k": 2, "axis": 2}}, 1),
    ("argmax_axis_values", "ArgMax", [X], [0], [],
     {"argmax_param": {"top_k": 2, "axis": 1, "out_max_val": True}}, 1),
    ("silence", "Silence", [X, X2], [], [], {}, 0),
    ("batchnorm_train", "BatchNorm", [2.0 + X], [0],
     [np.zeros(3, np.float32)] * 2 + [np.zeros(1, np.float32)], {}, 1),
]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _is_index(type_: str, i: int) -> bool:
    return (type_ == "Embed" and i == 0) or (type_ == "BatchReindex"
                                             and i == 1)


def _both(type_, bottoms, wrt, blobs, sub, ntop, dtype):
    """The tops and the gradients (the ``wrt`` bottoms, then the blobs) of
    both packages as f32 numpy, under one seeded cotangent a top."""
    tdt, jdt = DTYPES[dtype]
    names = [f"b{i}" for i in range(len(bottoms))]
    tops = [f"t{i}" for i in range(ntop)]
    jlp = jax_layer("l", type_, names, tops, **sub)
    tlp = torch_layer("l", type_, names, tops, **sub)
    stateful = type_ == "BatchNorm"

    def jfn(*args):
        xs = list(args[:len(bottoms)])
        out = jax_impl(type_).apply(jlp, list(args[len(bottoms):]), xs,
                                    True, None)
        return tuple(out[0] if stateful else out)

    jx = [jnp.asarray(b, jnp.float32 if _is_index(type_, i) else jdt)
          for i, b in enumerate(bottoms)]
    jp = [jnp.asarray(b, jnp.float32 if stateful else jdt) for b in blobs]
    diff = set(wrt)

    def jfn_wrt(*vary):
        it = iter(vary)
        args = [next(it) if i in diff else x for i, x in enumerate(jx)]
        return jfn(*args, *it)
    want, vjp = jax.vjp(jfn_wrt, *[jx[i] for i in wrt], *jp)
    rng = np.random.default_rng(3)
    cots = [rng.normal(size=np.shape(w)).astype(np.float32) for w in want]
    jgrads = vjp(tuple(jnp.asarray(c, w.dtype) for c, w in zip(cots, want)))

    tx = [torch.from_numpy(b.copy()).to(torch.float32 if _is_index(type_, i)
                                        else tdt)
          for i, b in enumerate(bottoms)]
    for i in wrt:
        tx[i].requires_grad_()
    tp = [torch.from_numpy(b.copy()).to(torch.float32 if stateful else tdt)
          .requires_grad_() for b in blobs]
    got = torch_impl(type_).apply(tlp, tp, tx, True)
    if stateful:
        got = got[0]
    leaves = [tx[i] for i in wrt] + tp
    grads = []
    if leaves and got:
        grads = torch.autograd.grad(
            list(got), leaves, [torch.from_numpy(c).to(t.dtype)
                                for c, t in zip(cots, got)],
            allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for g, l in zip(grads, leaves)]
    f32 = lambda t: np.asarray(t, np.float32)
    return ([f32(t.detach().float()) for t in got], [f32(w) for w in want],
            [f32(g.float()) for g in grads], [f32(g) for g in jgrads])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_layer_matches_jax(case, dtype):
    label, type_, bottoms, wrt, blobs, sub, ntop = case
    got, want, grads, jgrads = _both(type_, bottoms, wrt, blobs, sub, ntop,
                                     dtype)
    assert len(got) == len(want) == ntop
    assert len(grads) == len(jgrads)
    exact = (type_ == "ArgMax" and not sub["argmax_param"].get(
        "out_max_val")) or type_ == "Embed"
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if exact and dtype == "f32":
            np.testing.assert_array_equal(g, w)
        elif dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(
                g, w, atol=BF16_ATOL * max(1.0, float(np.abs(w).max())))
    for g, w in zip(grads, jgrads):
        assert g.shape == w.shape
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(
                g, w, atol=BF16_ATOL * max(1.0, float(np.abs(w).max())))


def test_index_edges_follow_jax():
    """Embed and BatchReindex read an index as JAX does: truncated, a
    negative one from the end, then clamped into range."""
    lp = torch_layer("l", "Embed", ["i"], ["y"], embed_param={
        "num_output": 4, "input_dim": 7, "bias_term": False})
    y = torch_impl("Embed").apply(lp, [torch.from_numpy(TABLE)],
                                  [torch.from_numpy(IDX)], False)[0]
    rows = [[0, 6, 6], [6, 0, 2], [0, 6, 3]]
    np.testing.assert_array_equal(y.numpy(), TABLE[rows])
    lp = torch_layer("l", "BatchReindex", ["x", "i"], ["y"])
    y = torch_impl("BatchReindex").apply(
        lp, [], [torch.from_numpy(X), torch.tensor([3.0, -1.0, 9.0, -8.0])],
        False)[0]
    np.testing.assert_array_equal(y.numpy(), X[[3, 3, 3, 0]])


def test_argmax_puts_the_lower_index_first_on_ties():
    lp = torch_layer("l", "ArgMax", ["x"], ["y"],
                     argmax_param={"top_k": 4})
    y = torch_impl("ArgMax").apply(lp, [], [torch.from_numpy(TIES)],
                                   False)[0]
    assert y.dtype == torch.float32
    # over each item's 8 entries: 3 at 1, 2, 4, 6; 5 at 4, 5, 7, then 1
    np.testing.assert_array_equal(y[:, 0].numpy(), [[1, 2, 4, 6],
                                                    [4, 5, 7, 6]])


def test_batchnorm_stores_the_unbiased_variance():
    """Caffe keeps the variance with the m/(m−1) correction; a layer that
    stores the biased one is off by that factor."""
    lp = torch_layer("l", "BatchNorm", ["x"], ["y"])
    x = torch.from_numpy(2.0 + X)
    _, new = torch_impl("BatchNorm").apply(
        lp, [torch.zeros(3), torch.zeros(3), torch.zeros(1)], [x], True)
    m = X.size // 3
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(new[1].numpy(), (biased * m / (m - 1)).numpy(),
                               rtol=1e-5)
    assert not np.allclose(new[1].numpy(), biased.numpy(), rtol=1e-3)


FILTER_NET = """
layer { name: "d" type: "Input" top: "x" top: "sel"
        input_param { shape { dim: 4 dim: 3 } shape { dim: 4 } } }
layer { name: "f" type: "Filter" bottom: "x" bottom: "sel" top: "fx" }
layer { name: "ip" type: "InnerProduct" bottom: "fx" top: "y"
        inner_product_param { num_output: 2
                              weight_filler { type: "xavier" } } }
"""


def test_filter_runs_in_a_net_and_taints_its_consumers():
    """tests/test_ops.py:594: downstream of a Filter, InnerProduct on axis
    1 builds and runs at the filtered batch; one on axis 0 (its blob
    sized by the batch) is refused at build time, in both packages."""
    net = Net(load_net_prototxt(FILTER_NET))
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    x = np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32)
    out = net.forward(params, {"x": torch.from_numpy(x),
                               "sel": torch.from_numpy(SEL)}, train=False)
    assert out.blobs["y"].shape == (3, 2)
    want = x[[0, 2, 3]] @ params["ip"][0].numpy().T + params["ip"][1].numpy()
    np.testing.assert_allclose(out.blobs["y"].numpy(), want, rtol=1e-5,
                               atol=1e-6)
    bad = FILTER_NET.replace("num_output: 2", "num_output: 2 axis: 0")
    with pytest.raises(ValueError, match="data-dependent batch"):
        JaxNet(jax_load_net(bad))
    with pytest.raises(ValueError, match="data-dependent batch"):
        Net(load_net_prototxt(bad))


def test_silence_makes_no_blob():
    txt = """
layer { name: "d" type: "Input" top: "x"
        input_param { shape { dim: 2 dim: 3 } } }
layer { name: "s" type: "Silence" bottom: "x" }
"""
    net = Net(load_net_prototxt(txt))
    assert net.output_blobs == [] and set(net.blob_shapes) == {"x"}
    assert net.forward({}, {"x": torch.ones(2, 3)}).blobs == {}


def test_registered_types_equal_the_jax_packages():
    assert registered_types() == jax_types()
    assert len(registered_types()) == 54


@pytest.mark.parametrize("type_,bottoms", [
    ("Accuracy", ["x"]), ("SoftmaxWithLoss", ["x"]),
    ("ContrastiveLoss", ["x", "x"]), ("BatchReindex", ["x"]),
    ("Filter", ["x"]), ("Scale", [])])
def test_net_refuses_a_layer_short_of_its_bottoms(type_, bottoms):
    """A layer with fewer bottoms than its ``min_bottoms`` is refused when
    the net is built, naming the layer and the count (the JAX package
    builds such a net and fails when it runs)."""
    bots = "".join(f' bottom: "{b}"' for b in bottoms)
    txt = f"""
layer {{ name: "d" type: "Input" top: "x"
        input_param {{ shape {{ dim: 4 dim: 3 }} }} }}
layer {{ name: "l" type: "{type_}"{bots} top: "y" }}
"""
    need = torch_impl(type_).min_bottoms()
    assert need == jax_impl(type_).min_bottoms() > len(bottoms)
    with pytest.raises(ValueError, match=f"'l' \\({type_}\\) needs at least "
                       f"{need} bottoms, has {len(bottoms)}"):
        Net(load_net_prototxt(txt))
