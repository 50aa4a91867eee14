"""Profile the bench's train step and print per-op and per-layer tables.

The port's counterpart of the root ``tools/profile_step.py``: it traces
one steady block of the program the bench times (``build_bench_model``,
``train_block``; with ``--eval`` the test-net forward of ``eval_block``)
under ``utils/profiling.py::trace``, turns the profile into the
``op_table.json`` tables (``utils/trace_tables.py``), prints them and the
summary (step time, img/s, MFU, device busy ms a step), and writes
``op_table.json`` and the Chrome trace into the directory named by
``--out``.  It never writes anywhere else.

Run:  python -m sparknet_tpu_torch.tools.profile_step --out DIR \\
          [--model caffenet] [--batch 256] [--iters 20] [--dtype f32] \\
          [--eval] [--top 25] [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time


def profile(model: str, batch: int, iters: int, dtype: str, out_dir: str,
            *, eval_pass: bool = False, device: str = "cuda",
            top: int | None = 25):
    """Warm up, trace one block of ``iters`` steps (or forwards) into
    ``out_dir`` and return ``(summary, tables, prof)``."""
    import numpy as np
    import torch

    from ..proto.caffe_pb import load_solver_prototxt_with_net
    from ..solvers.solver import Solver
    from ..utils import profiling, trace_tables
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    net, in_shape, classes = profiling.build_bench_model(model, batch)
    sp = load_solver_prototxt_with_net(profiling.BENCH_SOLVER_PROTOTXT, net)
    solver = Solver(sp, seed=0, device=dev, compute_dtype=(
        torch.bfloat16 if dtype == "bf16" else None))
    rng = np.random.default_rng(0)
    data = {"data": torch.from_numpy(rng.normal(size=(batch,) + in_shape)
                                     .astype(np.float32)).to(dev),
            "label": torch.from_numpy(rng.integers(0, classes, size=batch)
                                      .astype(np.float32)).to(dev)}
    if eval_pass:
        block = profiling.eval_block(solver, iters, data)
        flops = profiling.eval_cost_flops(solver)
    else:
        solver.set_train_data(itertools.repeat(data))
        block = profiling.train_block(solver, iters)
        flops = profiling.step_cost_flops(solver)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    block()
    sync()
    print(f"[profile] warm-up {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.perf_counter()
    with profiling.trace(out_dir) as prof:
        block()
        sync()
    step_s = (time.perf_counter() - t0) / iters
    tables = trace_tables.op_tables(prof, top=top)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = profiling.peak_flops(kind, dtype)
    busy_s = tables["total_ms"] / iters / 1e3
    summary = {
        "model": model, "batch": batch, "dtype": dtype,
        "mode": "eval_forward" if eval_pass else "train_step",
        "fuse_plan": profiling.record_fusion_plan(solver.train_net),
        "tune_plan": profiling.record_tuning(solver.train_net),
        "device": f"{dev.type}/{kind}",
        "step_ms": round(step_s * 1e3, 2),
        "img_s": round(batch / step_s, 1),
        "mfu": round(flops / step_s / peak, 4) if peak else None,
        "flops_per_step": flops,
        "peak_flops": peak,
        "trace_dir": out_dir,
        "device_busy_ms_per_step": round(busy_s * 1e3, 2),
        "mfu_device_busy": (round(flops / busy_s / peak, 4)
                            if peak and busy_s else None),
    }
    return summary, tables, prof


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="caffenet",
                    choices=["caffenet", "googlenet", "vgg16", "lenet"])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--out", required=True,
                    help="directory for op_table.json and the trace")
    ap.add_argument("--top", type=int, default=25,
                    help="rows of by_op kept (0: all)")
    ap.add_argument("--eval", action="store_true",
                    help="profile the test-net forward instead of the "
                         "train step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils import trace_tables
    summary, tables, _ = profile(
        args.model, args.batch, args.iters, args.dtype, args.out,
        eval_pass=args.eval, device=args.device, top=args.top or None)
    print(trace_tables.format_tables(tables))
    print(json.dumps(summary))
    doc = {"summary": summary, **tables}
    with open(os.path.join(args.out, "op_table.json"), "w") as f:
        json.dump(doc, f, indent=1)
    return doc


if __name__ == "__main__":
    main()
