"""Forward and backward timing of a net, the ``caffe time`` analog.

The port's counterpart of ``sparknet_tpu/tools/time_net.py`` (:23-159),
after the reference's timing tool (reference: caffe/tools/caffe.cpp:290-376
``time()``: average forward and forward-backward milliseconds over N
iterations, and per layer).  On the card each pass is timed with CUDA
events after warm-up; on the CPU (``--device cpu``) with the host clock.
The net runs in the TRAIN phase in full f32 (TF32 off), as the Solver
trains it: the forward under ``no_grad`` (the inference LRN kernel), the
forward-backward under autograd (the training kernels).  Input blobs are
synthetic: pixel-scale normal values for blobs of rank 2 or more, zeros
(a valid label for any classifier) for the rest.  ``--trace`` profiles
the forward-backward iterations (``utils/profiling.py::trace``) and
prints the per-layer partition of their device time (CPU op time on the
CPU), ``utils/trace_tables.py``'s ``by_layer``: each layer's forward and
backward, the JAX tool's ``--trace`` table.

Run:  python -m sparknet_tpu_torch.tools.time_net --model caffenet \\
          --iterations 10
      python -m sparknet_tpu_torch.tools.time_net --prototxt net.prototxt
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

MODELS = ("lenet", "cifar10_quick", "cifar10_full", "alexnet", "caffenet",
          "googlenet", "vgg16")


def time_fn(fn: Callable[[], object], iters: int, device: torch.device,
            warmup: int = 2) -> float:
    """Mean milliseconds of one call of ``fn`` over ``iters`` calls, after
    ``warmup`` calls: CUDA events around the run on the card, the host
    clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def synthetic_inputs(net, device: torch.device,
                     seed: int = 0) -> dict[str, torch.Tensor]:
    """Every input blob of ``net``: std-50 normal values for rank >= 2,
    zeros for labels."""
    rng = np.random.default_rng(seed)
    return {name: torch.from_numpy(
        (50.0 * rng.normal(size=shape)).astype(np.float32) if len(shape) > 1
        else np.zeros(shape, np.float32)).to(device)
        for name, shape in net.input_blobs.items()}


def time_net(net_param, *, iterations: int = 10, per_layer: bool = False,
             trace_dir: str | None = None,
             device: str | torch.device = "cuda") -> dict:
    """Forward and forward-backward ms of ``net_param`` in the TRAIN phase
    (and, with ``per_layer``, each layer's forward alone; with
    ``trace_dir``, the per-layer partition of a profiled run of
    ``iterations`` forward-backward passes, its trace kept there); prints
    the ``caffe time`` lines and returns the numbers."""
    from ..graph.net import Net
    from ..proto.caffe_pb import NetState, Phase
    from ..utils.device import full_f32, resolve_device
    dev = resolve_device(device)
    net = Net(net_param, NetState(Phase.TRAIN))
    params = net.init(torch.Generator().manual_seed(0), device=dev)
    inputs = synthetic_inputs(net, dev)
    gen = torch.Generator().manual_seed(1)
    leaves = [b.requires_grad_() for blobs in params.values() for b in blobs]

    def fwd():
        with torch.no_grad():
            return net.forward(params, inputs, train=True, generator=gen,
                               device=dev).loss

    def fwdbwd():
        loss = net.forward(params, inputs, train=True, generator=gen,
                           device=dev).loss
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    out = {"device": str(dev), "iterations": iterations}
    with full_f32():
        out["forward_ms"] = time_fn(fwd, iterations, dev)
        out["forward_backward_ms"] = time_fn(fwdbwd, iterations, dev)
        print(f"Average Forward pass:          {out['forward_ms']:10.3f} ms")
        print(f"Average Forward-Backward:      "
              f"{out['forward_backward_ms']:10.3f} ms")
        if per_layer:
            out["layers"] = _per_layer(net, params, inputs, gen, dev,
                                       iterations)
        if trace_dir is not None:
            out["trace_layers"] = _trace_layers(net, fwdbwd, dev,
                                                iterations, trace_dir)
    return out


def _trace_layers(net, fwdbwd, dev, iterations: int,
                  trace_dir: str) -> list[dict]:
    """The ``by_layer`` rows of a profiled run of ``iterations``
    forward-backward passes, a zero row for a layer that recorded no
    work; printed as ms per iteration."""
    from ..utils import profiling, trace_tables
    with profiling.trace(trace_dir) as prof:
        for _ in range(iterations):
            fwdbwd()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    rows = trace_tables.op_tables(prof)["by_layer"]
    seen = {r["op"] for r in rows}
    rows += [{"op": n.lp.name, "total_ms": 0.0, "count": 0, "pct": 0.0,
              "gflops_per_s": 0.0, "gb_per_s": 0.0, "backward_ms": 0.0}
             for n in net.nodes
             if not n.impl.is_input() and n.lp.name not in seen]
    print(f"\nPer-layer {'device' if dev.type == 'cuda' else 'CPU op'} "
          f"time over {iterations} forward-backward iterations (trace: "
          f"{trace_dir}):")
    print(f"{'layer':<28} {'ms/iter':>10} {'bwd ms/iter':>12} {'%':>6}")
    for r in rows:
        print(f"{r['op']:<28} {r['total_ms'] / iterations:>10.3f} "
              f"{r['backward_ms'] / iterations:>12.3f} {r['pct']:>6.1f}")
    return rows


def _per_layer(net, params, inputs, gen, dev, iterations) -> dict:
    """Each layer's train-mode forward alone, on the blobs the layers
    before it produced (no autograd)."""
    print(f"{'layer':<28} {'type':<18} {'fwd ms':>10}")
    blobs = dict(inputs)
    rows = {}
    with torch.no_grad():
        for node in net.nodes:
            if node.impl.is_input():
                continue
            p = net.node_params(params, node)
            bots = [blobs[b] for b in node.bottoms]

            def one(node=node, p=p, bots=bots):
                return node.impl.apply(node.lp, p, bots, True, gen,
                                       **node.seam(bots))

            ms = time_fn(one, iterations, dev)
            rows[node.lp.name] = ms
            print(f"{node.lp.name:<28} {node.lp.type:<18} {ms:>10.3f}")
            tops = one()
            if node.impl.has_state:
                tops = tops[0]   # BatchNorm's updated statistics aside
            if not node.bottoms:
                tops = [t.to(dev) for t in tops]
            blobs.update(zip(node.tops, tops))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="forward/backward timing")
    ap.add_argument("--model", default="caffenet", choices=MODELS)
    ap.add_argument("--prototxt", default=None,
                    help="time a prototxt net instead of a zoo model")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--per-layer", action="store_true",
                    help="also time each layer's forward alone")
    ap.add_argument("--trace", action="store_true",
                    help="profile the forward-backward iterations and "
                         "print the per-layer partition of their device "
                         "time (L[...] ranges)")
    ap.add_argument("--trace-dir", default=None,
                    help="keep the profiler trace here (default: temp)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.prototxt:
        from ..proto.caffe_pb import load_net_prototxt
        net_param = load_net_prototxt(args.prototxt)
    else:
        from .. import models
        kw = (dict(train_batch=args.batch, test_batch=args.batch)
              if args.batch else {})
        net_param = getattr(models, args.model)(**kw)
    trace_dir = None
    if args.trace:
        import tempfile
        trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="time_net_")
    time_net(net_param, iterations=args.iterations,
             per_layer=args.per_layer, trace_dir=trace_dir,
             device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
