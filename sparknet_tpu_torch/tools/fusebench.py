"""Fused-against-per-layer parity gate for the fusion passes.

    python -m sparknet_tpu_torch.tools.fusebench [--batch 4] [--iters 6]
        [--out FILE] [--device cuda|cpu]

The port's copy of the root ``tools/fusebench.py``, plus a horizontal
group.  It builds one synthetic net holding every chain shape the
planner emits —

    conv+bias+relu            (in-block, no epilogue op)
    conv+bias+relu+pool       (in-block)
    conv+bias+relu+LRN        (the relu+lrn epilogue: the ReLU folded)
    conv+bias+relu+pool+LRN   (the lrn epilogue)

— and two sibling 1x1 convolutions (a horizontal group), and fails
unless, on ``--device`` (the card by default):

- ``SPARKNET_FUSE=off`` against ``all``: the forward loss and every
  net-output blob are bit-identical in f32 and under a bf16
  ``compute_dtype``, and every parameter gradient is within rtol 1e-5
  (f32);
- horizontal fusion against ``SPARKNET_NO_HFUSE=1``: the loss and the
  gradients within rtol 1e-5 (one wider convolution may sum in another
  order than the narrow ones);
- the planner refuses a planted unfusable hotspot (a fan-out conv named
  by a profile worklist) with a reason;
- ``SPARKNET_FUSE=off`` plans nothing.

On the card every leg runs with TF32 off and deterministic cuDNN.  It
also times the LRN-chain train step fused against unfused and fails if
fusion is more than 25% slower (``--iters 0`` skips that leg).

Prints one JSON line on stdout; exit 0 when parity holds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _build_layers(batch: int, channels: int = 32, side: int = 14):
    from ..models.dsl import (concat_layer, convolution_layer,
                              inner_product_layer, layer, lrn_layer,
                              pooling_layer, relu_layer,
                              softmax_with_loss_layer)
    wf = {"type": "gaussian", "std": 0.05}
    bf = {"type": "constant", "value": 0.1}
    return [
        layer("data", "Input", tops=["data", "label"],
              input_param={"shape": [{"dim": [batch, 3, side, side]},
                                     {"dim": [batch]}]}),
        # conv+bias+relu (in-block)
        convolution_layer("c1", "data", "c1", num_output=channels, kernel=3,
                          pad=1, weight_filler=wf, bias_filler=bf),
        relu_layer("r1", "c1", "c1"),
        # conv+bias+relu+pool (in-block)
        convolution_layer("c2", "c1", "c2", num_output=channels, kernel=3,
                          pad=1, weight_filler=wf, bias_filler=bf),
        relu_layer("r2", "c2", "c2"),
        pooling_layer("p2", "c2", "p2", kernel=2, stride=2),
        # conv+bias+relu+LRN (the relu+lrn epilogue)
        convolution_layer("c3", "p2", "c3", num_output=channels, kernel=3,
                          pad=1, weight_filler=wf, bias_filler=bf),
        relu_layer("r3", "c3", "c3"),
        lrn_layer("n3", "c3", "n3", local_size=5, alpha=1e-4, beta=0.75),
        # conv+bias+relu+pool+LRN (the lrn epilogue after the pool)
        convolution_layer("c4", "n3", "c4", num_output=channels, kernel=3,
                          pad=1, weight_filler=wf, bias_filler=bf),
        relu_layer("r4", "c4", "c4"),
        pooling_layer("p4", "c4", "p4", kernel=2, stride=2),
        lrn_layer("n4", "p4", "n4", local_size=3, alpha=2e-4, beta=0.5),
        # a horizontal group: two sibling 1x1 convs of one width
        convolution_layer("h1", "n4", "h1", num_output=channels // 2,
                          kernel=1, weight_filler=wf, bias_filler=bf),
        convolution_layer("h2", "n4", "h2", num_output=channels // 2,
                          kernel=1, weight_filler=wf, bias_filler=bf),
        concat_layer("hcat", ["h1", "h2"], "hcat"),
        inner_product_layer("ip", "hcat", "ip", num_output=10,
                            weight_filler={"type": "gaussian", "std": 0.01}),
        softmax_with_loss_layer("loss", ["ip", "label"]),
    ]


EXPECTED_CHAINS = {
    "c1+r1": "none",
    "c2+r2+p2": "none",
    "c3+r3+n3": "relu+lrn",
    "c4+r4+p4+n4": "lrn",
}
EXPECTED_HFUSE = {"h1": ["h1", "h2"]}


class _deterministic(contextlib.AbstractContextManager):
    """TF32 off and deterministic cuDNN for the scope: two runs of the
    same convolution from the same bits give the same bits."""

    def __enter__(self):
        import torch

        from ..utils.device import full_f32
        self._f32 = full_f32()
        self._f32.__enter__()
        self._saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        return self

    def __exit__(self, *exc):
        import torch
        torch.backends.cudnn.deterministic = self._saved
        return self._f32.__exit__(*exc)


def _max_rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6,
                    help="timed iterations of the LRN-chain microbench "
                         "(0 skips it)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..graph import fusion
    from ..graph.net import Net
    from ..models.dsl import net_param
    from ..proto.caffe_pb import NetState, Phase
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    failures: list[str] = []
    netp = net_param("fusebench", _build_layers(args.batch))

    def build(fuse: str, dtype=None, hfuse: bool = True) -> Net:
        os.environ["SPARKNET_FUSE"] = fuse
        if not hfuse:
            os.environ["SPARKNET_NO_HFUSE"] = "1"
        try:
            return Net(netp, NetState(Phase.TRAIN), compute_dtype=dtype)
        finally:
            os.environ.pop("SPARKNET_FUSE", None)
            os.environ.pop("SPARKNET_NO_HFUSE", None)

    net_off = build("off")
    net_all = build("all")

    # -- plan shape: every chain family present, the escape hatch clean --
    planned = {c.scope(): c.epilogue for c in net_all._fuse_plan.chains}
    if planned != EXPECTED_CHAINS:
        failures.append(f"planned chains {planned} != {EXPECTED_CHAINS}")
    if net_off.fuse_plan_id() != "off" or net_off._vfuse_head:
        failures.append("SPARKNET_FUSE=off still planned chains")
    groups = {h: [m.lp.name for m in ms]
              for h, ms in net_all._hfuse_first.items()}
    if groups != EXPECTED_HFUSE:
        failures.append(f"horizontal groups {groups} != {EXPECTED_HFUSE}")

    params = net_off.init(torch.Generator().manual_seed(0), device=dev)
    r = np.random.default_rng(0)
    ins = {"data": torch.from_numpy(r.normal(
        size=net_off.input_blobs["data"]).astype(np.float32)).to(dev),
        "label": torch.from_numpy(r.integers(
            0, 10, size=net_off.input_blobs["label"]).astype(
            np.float32)).to(dev)}

    def run(net, grads: bool = True):
        p = {k: [b.detach().clone().requires_grad_(grads) for b in v]
             for k, v in params.items()}
        out = net.forward(p, ins)
        if not grads:
            return out.loss.detach(), out.blobs, None
        out.loss.backward()
        return (out.loss.detach(), out.blobs,
                {k: [b.grad for b in v] for k, v in p.items()})

    def grad_rel(ga, gb) -> float:
        return max(_max_rel(b, a) for k in ga for a, b in zip(ga[k], gb[k]))

    with _deterministic():
        # -- vertical: forward bit for bit, gradients within 1e-5 (f32) --
        l_off, b_off, g_off = run(net_off)
        l_all, b_all, g_all = run(net_all)
        if not torch.equal(l_off, l_all) or any(
                not torch.equal(b_off[k], b_all[k]) for k in b_off):
            failures.append(
                f"f32 forward not bit-identical: loss {float(l_off)!r} "
                f"(off) vs {float(l_all)!r} (all)")
        vgrad = grad_rel(g_off, g_all)
        if vgrad > 1e-5:
            failures.append(f"f32 gradient divergence {vgrad:.3e} exceeds "
                            f"the 1e-5 bound")
        # -- vertical under bf16 compute: forward bit for bit ------------
        lb_off = run(build("off", torch.bfloat16), grads=False)[0]
        lb_all = run(build("all", torch.bfloat16), grads=False)[0]
        if not torch.equal(lb_off, lb_all):
            failures.append(f"bf16 forward not bit-identical: "
                            f"{float(lb_off)!r} vs {float(lb_all)!r}")
        # -- horizontal against per-layer: within 1e-5 -------------------
        l_nh, _, g_nh = run(build("all", hfuse=False))
        hfwd = _max_rel(l_all, l_nh)
        hgrad = grad_rel(g_nh, g_all)
        if hfwd > 1e-5 or hgrad > 1e-5:
            failures.append(f"horizontal fusion off per-layer: loss rel "
                            f"{hfwd:.3e}, gradients {hgrad:.3e} (bound "
                            f"1e-5)")

    # -- the planted unfusable hotspot is refused ---------------------------
    from ..models.dsl import (concat_layer, convolution_layer, layer,
                              relu_layer)
    fan = net_param("fanout", [
        layer("data", "Input", tops=["data"],
              input_param={"shape": [{"dim": [1, 3, 8, 8]}]}),
        convolution_layer("hot", "data", "hot", num_output=4, kernel=3,
                          pad=1, weight_filler={"type": "xavier"}),
        relu_layer("hotrelu", "hot", "hotr"),
        concat_layer("skip", ["hot", "hotr"], "out"),
    ])
    os.environ["SPARKNET_FUSE"] = "off"
    try:
        fan_net = Net(fan, NetState(Phase.TEST))
    finally:
        os.environ.pop("SPARKNET_FUSE", None)
    fake_profile = {"by_layer": [
        {"op": "hot", "total_ms": 50.0, "pct": 40.0, "gb_per_s": 300.0,
         "gflops_per_s": 100.0},
        {"op": "neighbor", "total_ms": 30.0, "pct": 30.0,
         "gb_per_s": 1000.0},
    ]}
    plan = fusion.plan_from_profile(fan_net, fake_profile, source="planted")
    if plan.chains:
        failures.append(f"planner fused a fan-out conv: "
                        f"{[c.scope() for c in plan.chains]}")
    if not any(rf.get("candidate") == "hot" and rf.get("reason")
               for rf in plan.refused):
        failures.append(f"fan-out hotspot not refused with a reason: "
                        f"{plan.refused}")

    # -- the LRN-chain step, fused against unfused --------------------------
    timing: dict = {}
    if args.iters > 0:
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else (lambda: None))

        def timed(net) -> float:
            run(net)
            sync()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                run(net)
            sync()
            return (time.perf_counter() - t0) / args.iters

        t_off, t_all = timed(net_off), timed(net_all)
        timing = {"unfused_step_ms": round(t_off * 1e3, 3),
                  "fused_step_ms": round(t_all * 1e3, 3),
                  "fused_speedup_x": round(t_off / t_all, 3)}
        if t_all > 1.25 * t_off:
            failures.append(f"fused step {t_all * 1e3:.2f} ms is >25% "
                            f"slower than unfused {t_off * 1e3:.2f} ms")

    result = {
        "ok": not failures,
        "failures": failures,
        "device": (f"cuda/{torch.cuda.get_device_name(dev)}"
                   if dev.type == "cuda" else "cpu"),
        "plan_id": net_all.fuse_plan_id(),
        "chains": planned,
        "hfuse_groups": groups,
        "grad_max_rel": vgrad,
        "hfuse_loss_rel": hfwd,
        "hfuse_grad_max_rel": hgrad,
        "refused": plan.refused,
        **timing,
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if failures:
        print(f"[fusebench] PARITY FAILURE: {failures}", file=sys.stderr,
              flush=True)
        return 1
    print(f"[fusebench] parity holds over {len(planned)} chain shapes and "
          f"{len(groups)} horizontal group (grad {vgrad:.1e}, hfuse grad "
          f"{hgrad:.1e})", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
