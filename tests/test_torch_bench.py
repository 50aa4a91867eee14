"""The port's bench entry point, its FLOP counts and the Solver's
``debug_info``, on the CPU.

- ``python -m sparknet_tpu_torch.bench --device cpu`` (lenet, 2
  iterations, short tiers) prints exactly one JSON line on stdout, whose
  keys cover those of the JAX bench line committed in ``BENCH_r05.json``
  (``parsed``) plus the tiers the port names as not ported, and its
  ``feed_records`` tier (16 records of 32x32) carries the JAX records
  line's keys; without a
  CUDA device and without ``--device cpu`` it exits non-zero with an
  ``error`` line.  ``BENCH_SHARD`` refuses by ROADMAP item, and a
  ``BENCH_FUSE`` that names no plan source by name; ``BENCH_FUSE=all``
  reaches the child's nets as ``SPARKNET_FUSE``.
- ``step_cost_flops``/``eval_cost_flops`` against the JAX package's XLA
  ``cost_analysis`` on the CPU, lenet and cifar10_quick.  The port counts
  the convolution and inner-product multiply-adds, padding taps
  included; XLA counts no multiply-add on a padding tap and adds the
  elementwise work and the update.  Measured: the JAX count is 3.8%
  above the port's for lenet (no padding: the elementwise work and the
  update) and 15.2% below for cifar10_quick (its 5x5 pad-2 convolutions
  on 32x32 and 16x16 maps).  Tolerance: 20% for the whole counts, and 5%
  once the test removes the padding taps from the port's count.
- ``debug_info`` on lenet from one ``.caffemodel``: the port's
  ``[Forward]`` and ``[Update]`` lines name the JAX Solver's blobs and
  params in the same order, values within rtol 1e-5 (f32).
(The bench on the card: tests/test_torch_cuda_bench.py.)
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparknet_tpu import models as jax_models
from sparknet_tpu.proto import caffemodel as jax_cm
from sparknet_tpu.proto import load_solver_prototxt_with_net as jax_solver
from sparknet_tpu.solvers import Solver as JaxSolver
from sparknet_tpu.utils import profiling as jprof
from sparknet_tpu_torch import bench, models
from sparknet_tpu_torch.ops.vision import conv_geometry
from sparknet_tpu_torch.proto import load_solver_prototxt_with_net
from sparknet_tpu_torch.solvers import Solver
from sparknet_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SHORT = {"BENCH_MODEL": "lenet", "BENCH_BATCH": "16", "BENCH_ITERS": "2",
          "BENCH_REPS": "1", "BENCH_WINDOWS": "1", "BENCH_FEED_ITERS": "2",
          "BENCH_ROUND_N": "1", "BENCH_ROUND_TAU": "2",
          "BENCH_SERVE_SECONDS": "0.3", "BENCH_SERVE_CLIENTS": "2",
          "BENCH_SERVE_WINDOW": "2", "BENCH_RECORDS_N": "16",
          "BENCH_RECORDS_EDGE": "32", "BENCH_RECORDS_BATCH": "8",
          "BENCH_RECORDS_EPOCHS": "1", "OMP_NUM_THREADS": "1"}


def _bench(args: list[str], **env) -> subprocess.CompletedProcess:
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("BENCH_", "SPARKNET_"))}
    full.update(_SHORT, **env)
    return subprocess.run([sys.executable, "-m", "sparknet_tpu_torch.bench",
                           *args], cwd=_ROOT, env=full, capture_output=True,
                          text=True, timeout=600)


def test_cpu_bench_prints_one_line_with_the_jax_keys():
    p = _bench(["--device", "cpu"])
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    with open(os.path.join(_ROOT, "BENCH_r05.json")) as f:
        jax_keys = set(json.load(f)["parsed"])
    assert jax_keys | {"shard_round"} <= set(line)
    # one worker (no --local-devices): nothing to shard, as in the JAX
    # bench on one device
    assert line["shard_round"] == {"skipped": "1 worker(s): nothing to "
                                              "shard"}
    assert set(line["by_dtype"]) == {"bf16", "f32"}
    assert line["device"] == "cpu/cpu" and "error" not in line
    assert line["value"] == max(r["images_per_sec"]
                                for r in line["by_dtype"].values())
    serving = line["serving"]
    assert serving["verdicts"]["bit_identical"]
    # the paced sweep at 0.5x and 1x saturation and the 2x overload point
    assert [p["fraction_of_saturation"] for p in serving["sweep"]] == \
        [0.5, 1.0]
    assert all(p["exact_mismatches"] == 0 for p in serving["sweep"])
    assert serving["overload"]["fraction_of_saturation"] == 2.0
    assert "not_ported_legs" not in serving
    assert "audit" not in line["round_overhead"]
    assert line["round_overhead"]["sync"]["stall_s_per_round"][
        "audit_fetch"] > 0
    assert line["round_overhead"]["async"]["rounds"] == 2
    assert line["feed_in_loop"]["staged_dtype"] == "uint8"
    # the records tier at a tiny size: the JAX line's keys
    rec = line["feed_records"]
    assert set(rec) == {"feed_source", "records", "edge", "batch",
                        "epochs", "images_per_sec", "serial_img_s",
                        "speedup_x", "convert_s", "read_s",
                        "serial_decode_s", "cache"}
    assert (rec["records"], rec["edge"], rec["batch"]) == (16, 32, 8)
    assert rec["images_per_sec"] > 0 and rec["serial_img_s"] > 0
    assert rec["cache"]["misses"] >= 1 and rec["cache"]["ram_hits"] > 0
    assert line["provenance"]["fingerprint"]["feed_source"] == "records"


def test_bench_refuses_the_cpu_in_the_cards_place():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would measure it")
    p = _bench([], BENCH_FEED="0", BENCH_ROUND="0", BENCH_SERVING="0")
    assert p.returncode != 0
    line = json.loads(p.stdout.splitlines()[-1])
    assert "CUDA is not available" in line["error"]
    assert line["value"] == 0.0


@pytest.mark.parametrize("env, item", [({"BENCH_FUSE": "onn"}, "BENCH_FUSE"),
                                       ({"BENCH_SHARD_N": "x"}, "literal"),
                                       ({"BENCH_DTYPE": "f16"}, "f32")])
def test_unported_bench_knobs_refuse(monkeypatch, env, item):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises((NotImplementedError, ValueError), match=item):
        bench.BenchConfig.from_env()


# ---------------------------------------------------------------------------
# FLOPs against XLA's cost analysis
# ---------------------------------------------------------------------------

_SP = profiling.BENCH_SOLVER_PROTOTXT


def _padding_taps(net) -> dict[str, int]:
    """Per convolution, its forward FLOPs on padding taps (2 a
    multiply-add): the part of the port's count that XLA leaves out."""
    def valid(size, k, s, p, o):
        return sum(0 <= i * s - p + j < size
                   for i in range(o) for j in range(k))
    out = {}
    for node, _ in net.layer_flops():
        if node.lp.type != "Convolution":
            continue
        kh, kw, sh, sw, ph, pw, *_, group, _ = conv_geometry(node.lp)
        n, cin, h, w = net.blob_shapes[node.bottoms[0]]
        _, cout, oh, ow = net.blob_shapes[node.tops[0]]
        taps = oh * kh * ow * kw - valid(h, kh, sh, ph, oh) \
            * valid(w, kw, sw, pw, ow)
        out[node.lp.name] = 2 * n * cout * (cin // group) * taps
    return out


@pytest.mark.parametrize("name, shape", [("lenet", (1, 28, 28)),
                                         ("cifar10_quick", (3, 32, 32))])
def test_flop_counts_against_xla(name, shape):
    b = 8
    js = JaxSolver(jax_solver(_SP, getattr(jax_models, name)(b, b)), seed=0)
    ts = Solver(load_solver_prototxt_with_net(
        _SP, getattr(models, name)(b, b)), device="cpu")
    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.normal(size=(1, b) + shape).astype(np.float32))
    label = jnp.asarray(rng.integers(0, 10, (1, b)).astype(np.float32))
    xla_step = jprof.step_cost_flops(js, {"data": data, "label": label})
    xla_eval = jprof.eval_cost_flops(js, {"data": data[0],
                                          "label": label[0]})
    step = profiling.step_cost_flops(ts)
    fwd = profiling.eval_cost_flops(ts)
    assert abs(xla_step - step) <= 0.20 * step
    assert abs(xla_eval - fwd) <= 0.20 * fwd
    # the forward, the weight gradient and (above the data blob) the
    # input gradient each carry a convolution's padding taps
    net = ts.train_net
    no_input_grad = {n.lp.name for n, _ in net.layer_flops()
                     if n.bottoms[0] in net.input_blobs}
    pads = _padding_taps(net)
    step_valid = step - sum((2 if k in no_input_grad else 3) * p
                            for k, p in pads.items())
    fwd_valid = fwd - sum(_padding_taps(ts.test_net).values())
    assert abs(xla_step - step_valid) <= 0.05 * xla_step
    assert abs(xla_eval - fwd_valid) <= 0.05 * xla_eval
    assert (sum(pads.values()) > 0) == (name == "cifar10_quick")


def test_peak_table_names_the_card_and_refuses_others():
    name = "NVIDIA H100 80GB HBM3"
    assert profiling.peak_flops(name, "bf16") == 989.4e12
    assert profiling.peak_flops(name, "f32") == 67e12
    assert profiling.peak_flops("cpu", "f32") is None
    assert profiling.peak_flops("NVIDIA A100-SXM4-80GB") is None


def test_caffenet_step_count_is_three_forwards_less_conv1_input_grad():
    net, _, _ = profiling.build_bench_model("caffenet", 256)
    s = Solver(load_solver_prototxt_with_net(_SP, net), device="cpu")
    fwd = s.train_net.forward_flops()
    conv1 = s.train_net.layer_flops()[0][1]
    assert profiling.step_cost_flops(s) == 3 * fwd - conv1
    assert math.isclose(fwd / 256 / 2, 724e6, rel_tol=0.01)


# ---------------------------------------------------------------------------
# debug_info
# ---------------------------------------------------------------------------

_LINE = re.compile(r"\[(Forward|Update)\] Layer (\S+), (.*?) data: "
                   r"([-0-9.e+]+)(?:; diff: ([-0-9.e+]+))?")


def _debug_lines(text: str) -> list[tuple]:
    return [m.groups() for m in map(_LINE.search, text.splitlines()) if m]


def test_debug_info_lines_match_the_jax_solver(tmp_path, capsys):
    txt = ('base_lr: 0.01\nmomentum: 0.9\nlr_policy: "fixed"\n'
           'debug_info: true\ndisplay: 2\n')
    js = JaxSolver(jax_solver(txt, jax_models.lenet(8, 8)), seed=0)
    ts = Solver(load_solver_prototxt_with_net(txt, models.lenet(8, 8)),
                device="cpu")
    path = str(tmp_path / "init.caffemodel")
    jax_cm.save_caffemodel(path, {k: [np.asarray(b) for b in v] for k, v in
                                  jax.device_get(js.params).items()},
                           js.sp.net_param)
    ts.load_weights(path)
    rng = np.random.default_rng(5)
    batches = [{"data": rng.normal(size=(8, 1, 28, 28)).astype(np.float32),
                "label": rng.integers(0, 10, 8).astype(np.float32)}
               for _ in range(2)]
    capsys.readouterr()
    js.set_train_data(iter(batches))
    js.step(2)
    theirs = _debug_lines(capsys.readouterr().out)
    ts.set_train_data(iter(batches))
    ts.step(2)
    ours = _debug_lines(capsys.readouterr().out)
    # display 2: the lines of the second step only
    assert len(ours) == len(theirs) > 10
    for a, b in zip(ours, theirs):
        assert a[:3] == b[:3]
        for x, y in zip(a[3:], b[3:]):
            if y is not None:
                assert math.isclose(float(x), float(y), rel_tol=1e-5,
                                    abs_tol=1e-12), (a, b)
