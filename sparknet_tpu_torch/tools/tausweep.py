"""τ × codec sweep of the learning proxy: the communication period
against the bytes each exchange costs on the wire.

The port's counterpart of the root ``tools/tausweep.py``.  It runs the
grid τ ∈ ``--taus`` × codec ∈ ``--codecs`` through the learning proxy's
8-way local SGD (``tools/learning_proxy.py``): each cell is a
``DistributedTrainer`` ``local_sgd`` round with ``comm_codec`` set, so
each τ-boundary exchange encodes every worker's delta against the last
broadcast reference through ``parallel/comms.py``, decodes and averages
it, and carries the compression error forward as the worker's residual
(error feedback), as the trainer does on one card.  The cells of one τ
share the init and the minibatch stream (numpy seed 11, the JAX tool's),
so the codec is the only difference inside a τ.

Each cell gives the proxy's row shape (iter, lr, train_loss, train_acc,
test_acc, wall_s), ``final_acc`` (the mean of the last two rows), the
wire bytes of a round (``comms.exchange_bytes`` over the real encode) and
the verdict per τ: each lossy codec within ``--band`` of codec ``none``.
The sweep merges into the RESULTS file under ``sweep``;
``tools/plot_learning_proxy.py`` draws it.  Exits 1 when a codec leaves
its band.

Run:  python -m sparknet_tpu_torch.tools.tausweep [--taus 2,10]
          [--codecs none,bf16,int8] [--scale 200]
          [--out RESULTS_learning_proxy_torch.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .learning_proxy import (DEFAULT_OUT, Proxy, device_name, device_of,
                             schedule, sync)


def main(argv=None, *, params0=None) -> int:
    """``params0``: the initial params ({layer: [arrays]}) in place of
    the port's own init (tests start both tools from one init)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--taus", default="2,10",
                    help="comma list of communication periods")
    ap.add_argument("--codecs", default="none,bf16,int8",
                    help="comma list of comms.py codec names")
    ap.add_argument("--scale", type=int, default=200,
                    help="schedule divisor vs the published 70k config")
    ap.add_argument("--batch", type=int, default=100,
                    help="per-worker batch (recorded in the sweep config)")
    ap.add_argument("--base-lr", type=float, default=0.001,
                    help="base learning rate (recorded in the config)")
    ap.add_argument("--snr-boost", type=float, default=1.0,
                    help="scale the generator's class signal-to-noise: "
                         "template amp x this, distractor amp and pixel "
                         "noise / this; 1.0 is the published generator")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=2000)
    ap.add_argument("--n-test", type=int, default=400)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="iters between eval rows (0 = max_iter//5)")
    ap.add_argument("--band", type=float, default=0.05,
                    help="τ-matched accuracy band vs codec none")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--platform", default=None,
                    help="the JAX tool's backend flag: cpu runs on the CPU")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    taus = [int(t) for t in args.taus.split(",")]
    codec_names = args.codecs.split(",")

    from ..parallel import comms
    from ..utils.device import full_f32

    dev = device_of(args)
    S = args.scale
    sp_text, max_iter, steps = schedule(S, args.base_lr)
    eval_every = args.eval_every or max(max_iter // 5, 1)
    data_kw = {}
    if args.snr_boost != 1.0:
        data_kw = dict(amp=0.9 * args.snr_boost,
                       distract_amp=0.7 / args.snr_boost,
                       noise=1.15 / args.snr_boost)
    px = Proxy(sp_text, args.n_train, args.n_test, dev, batch=args.batch,
               params0=params0, **data_kw)
    print(f"# {device_name(dev)}; generated {args.n_train}+{args.n_test} "
          f"images in {px.gen_s:.1f}s", flush=True)
    W, batch = args.workers, args.batch
    part = args.n_train // W
    bytes_none = comms.exchange_bytes(comms.get_codec("none"), px.params0,
                                      W)

    def run_cell(codec_name: str, tau: int) -> dict:
        tr = px.trainer("local_sgd", W, tau, codec_name)
        rng_idx = np.random.default_rng(11)   # same batches per cell
        rounds_per_eval = max(eval_every // tau, 1)
        curve, it, train_s = [], 0, 0.0
        t_run = time.time()
        while it < max_iter:
            n_rounds = min(rounds_per_eval, (max_iter - it) // tau)
            if n_rounds == 0:
                break
            idxs = rng_idx.integers(0, part,
                                    size=(n_rounds, tau, W, batch))
            t0 = time.perf_counter()
            losses = [tr.train_round(px.round_batches(i)) for i in idxs]
            sync(dev)
            train_s += time.perf_counter() - t0
            it += n_rounds * tau
            row = px.row(it, float(np.mean(losses)), tr.params)
            row["wall_s"] = round(time.time() - t_run, 1)
            curve.append(row)
            print(f"tau{tau:<3d} {codec_name:12s} iter {it:5d} "
                  f"loss {row['train_loss']:.3f} "
                  f"test_acc {row['test_acc']:.3f} "
                  f"({row['wall_s']}s)", flush=True)
        cell_bytes = comms.exchange_bytes(comms.get_codec(codec_name),
                                          px.params0, W)
        # the mean of the last two rows: the lr drops land in the last
        # fifth of the schedule, and one row's eval noise would decide
        # the band otherwise
        tail = [r["test_acc"] for r in curve[-2:]]
        return {
            "tau": tau, "codec": codec_name, "curve": curve,
            "final_acc": float(np.mean(tail)),
            "wall_s": round(time.time() - t_run, 1),
            "img_s": round(it * batch * W / max(train_s, 1e-9), 1),
            "rounds": max_iter // tau,
            "exchange_bytes_per_round": cell_bytes,
            "bytes_shrink_x": round(bytes_none / cell_bytes, 3),
        }

    cells = {}
    with full_f32():
        for tau in taus:
            for name in codec_names:
                cells[f"tau{tau}_{name}"] = run_cell(name, tau)

    band_ok = {}
    for tau in taus:
        base = cells.get(f"tau{tau}_none")
        if base is None:
            continue
        for name in codec_names:
            if name == "none":
                continue
            drift = abs(cells[f"tau{tau}_{name}"]["final_acc"]
                        - base["final_acc"])
            band_ok[f"tau{tau}_{name}"] = {"drift": round(drift, 4),
                                           "ok": bool(drift <= args.band)}

    sweep = {
        "config": {
            "scale": S, "max_iter": max_iter, "stepvalues": list(steps),
            "base_lr": args.base_lr, "snr_boost": args.snr_boost,
            "batch": batch, "n_train": args.n_train,
            "n_test": args.n_test, "workers": W,
            "taus": taus, "codecs": codec_names, "band": args.band,
        },
        "device": device_name(dev),
        "exchange_bytes_none": bytes_none,
        "cells": cells,
        "band_ok": band_ok,
    }
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    results["sweep"] = sweep
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({
        "final_acc": {k: c["final_acc"] for k, c in cells.items()},
        "wall_s": {k: c["wall_s"] for k, c in cells.items()},
        "img_s": {k: c["img_s"] for k, c in cells.items()},
        "bytes_shrink_x": {k: c["bytes_shrink_x"]
                           for k, c in cells.items()},
        "band_ok": band_ok}), flush=True)
    return 0 if all(v["ok"] for v in band_ok.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
