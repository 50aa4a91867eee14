"""Lowering autotuner CLI: measured per-(op, shape, dtype, backend)
selection (``graph/tuner.py`` is the library; this is the capture and
check surface).

    python -m sparknet_tpu_torch.tools.tune <command> [--device cuda|cpu]

The port's copy of the root ``tools/tune.py``.  Every command runs on the
card unless ``--device cpu`` asks for the CPU.

  run        Measure the keys ``graph.tuner.keys_for_net`` gives for
             CaffeNet's and GoogLeNet's train nets at the bench's batch
             (256) under their committed fusion plans, and write the
             schema-versioned winners table
             ``sparknet_tpu_torch/profiles/<backend>/tuning.json`` that
             ``SPARKNET_TUNE=auto`` reads, stamped with the card's name
             and power limit.  Every candidate's timing is kept,
             disqualified, ineligible and skipped ones too, so the table
             is the evidence.  ``--ingest LEDGER`` appends it to a perf
             ledger.

  staleness  Re-probe the table's worst-margin and oldest entries within
             ``--budget-s`` and exit 1 if a persisted winner no longer
             wins by more than the noise band.

  tunebench  The self-test: tunes a 2-op synthetic net and requires that
             the winner beats a planted 3x-work candidate, a planted
             wrong candidate is never persisted, ``SPARKNET_TUNE=off``
             against the fresh table is forward bit-identical (gradients
             within 1e-5) through the layers, the fresh table passes
             the staleness check, and a planted rotten winner fails it.

Usage:
    python -m sparknet_tpu_torch.tools.tune run [--batch 256]
        [--models caffenet,googlenet] [--only lrn,conv] [--out FILE]
        [--ingest LEDGER] [--allow-inexact] [--device cuda]
    python -m sparknet_tpu_torch.tools.tune staleness [--table FILE]
        [--budget-s 60] [--device cuda]
    python -m sparknet_tpu_torch.tools.tune tunebench [--json FILE]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _log(msg: str) -> None:
    print(f"[tune] {msg}", file=sys.stderr, flush=True)


def _card(device) -> str:
    from ..utils import profiling
    return profiling.card_line(device) if device.type == "cuda" else "cpu"


# ---------------------------------------------------------------------------
# run: the keys of the bench's nets
# ---------------------------------------------------------------------------

def bench_keys(models=("caffenet", "googlenet"), batch: int = 256,
               dtype: str = "f32"):
    """Every key the train nets of ``models`` consult at ``batch``, under
    the fusion plans their nets resolve (``SPARKNET_FUSE``, the committed
    ``auto`` plans by default), in graph order, duplicates dropped."""
    from ..graph import tuner
    from ..graph.net import Net
    from ..proto.caffe_pb import NetState, Phase
    from ..utils import profiling
    keys, seen = [], set()
    saved = os.environ.get("SPARKNET_TUNE")
    os.environ["SPARKNET_TUNE"] = "off"   # keys must not need a table
    try:
        for model in models:
            netp, _, _ = profiling.build_bench_model(model, batch)
            net = Net(netp, NetState(Phase.TRAIN))
            for k in tuner.keys_for_net(net, dtype):
                if str(k) not in seen:
                    seen.add(str(k))
                    keys.append(k)
    finally:
        if saved is None:
            os.environ.pop("SPARKNET_TUNE", None)
        else:
            os.environ["SPARKNET_TUNE"] = saved
    return keys


def _ingest(table_path: str, ledger_path: str) -> int:
    from ..utils import perfledger as pl
    ledger = pl.PerfLedger(ledger_path)
    with open(table_path) as f:
        doc = json.load(f)
    rel = os.path.relpath(os.path.abspath(table_path), REPO)
    if rel.startswith(".."):
        rel = table_path
    n = ledger.extend(pl.entries_from_any(doc, rel))
    _log(f"ingested {n} ledger entr{'y' if n == 1 else 'ies'} "
         f"from {rel} into {ledger_path}")
    return n


def _describe(e: dict) -> str:
    tags = []
    for name, rec in e["timings"].items():
        if "skipped" in rec:
            tags.append(f"{name}:skip")
        elif "disqualified" in rec:
            tags.append(f"{name}:DQ {rec['ms']}ms")
        elif "ineligible" in rec:
            tags.append(f"{name}:inel {rec['ms']}ms")
        else:
            tags.append(f"{name}:{rec['ms']}ms")
    flip = " FLIP" if e["flip"] else ""
    return (f"{e['key']}: winner {e['winner']}{flip} "
            f"(margin {e['margin']}, {'; '.join(tags)})")


def cmd_run(args, dev) -> int:
    from ..graph import tuner
    keys = bench_keys(tuple(m for m in args.models.split(",") if m),
                      args.batch, args.dtype)
    if args.only:
        pats = [p for p in args.only.split(",") if p]
        keys = [k for k in keys if any(p in str(k) for p in pats)]
    if not keys:
        _log("no keys selected (check --only)")
        return 2
    card = _card(dev)
    _log(f"measuring {len(keys)} keys on {card} (batch {args.batch})")
    t0 = time.monotonic()
    table = tuner.build_table(
        keys, reps=args.reps, target_s=args.target_s, warmup=args.warmup,
        allow_inexact=args.allow_inexact,
        progress=lambda e: _log(_describe(e)), device=dev,
        provenance={"card": card, "batch": args.batch,
                    "models": args.models})
    out = args.out or tuner.default_table_path(dev.type)
    table.save(out)
    flips = sum(1 for e in table.entries if e.get("flip"))
    _log(f"wrote {len(table.entries)} entries ({flips} flips vs the "
         f"defaults) -> {out} [{table.table_id()}] in "
         f"{time.monotonic() - t0:.0f}s")
    if args.ingest:
        _ingest(out, args.ingest)
    print(json.dumps({"ok": True, "table": out, "card": card,
                      "table_id": table.table_id(),
                      "entries": len(table.entries), "flips": flips}),
          flush=True)
    return 0


# ---------------------------------------------------------------------------
# staleness: the re-probe gate
# ---------------------------------------------------------------------------

def cmd_staleness(args, dev) -> int:
    from ..graph import tuner
    path = args.table or tuner.default_table_path(dev.type)
    if not os.path.isfile(path):
        _log(f"no tuning table at {path} — nothing to check (run "
             f"`tune run` first)")
        return 0 if args.missing_ok else 2
    table = tuner.TuningTable.load(path)
    if table.backend != dev.type:
        _log(f"{path} was captured on {table.backend!r}; this run is on "
             f"{dev.type!r} — its timings do not compare, skipping")
        return 0
    _log(f"re-probing {path} [{table.table_id()}] on {_card(dev)} within "
         f"{args.budget_s:.0f}s budget")
    report = tuner.staleness_check(
        table, budget_s=args.budget_s, reps=args.reps,
        target_s=args.target_s, warmup=args.warmup,
        allow_inexact=args.allow_inexact, device=dev)
    for rec in report["results"]:
        state = "ROTTEN" if "rotten" in rec else "fresh"
        _log(f"{rec['key']}: {state} (persisted {rec['persisted_winner']}, "
             f"fresh {rec['fresh_winner']}, slack {rec.get('slack')}, "
             f"band {rec['noise_band']})")
    line = json.dumps(report)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    if not report["ok"]:
        for rec in report["rotten"]:
            _log(f"STALE: {rec['rotten']}")
        _log(f"{len(report['rotten'])}/{report['checked']} re-probed "
             f"entries are stale — re-run `tune run` and commit the "
             f"fresh table")
        return 1
    _log(f"{report['checked']}/{report['total_entries']} entries "
         f"re-probed, all winners still win")
    return 0


# ---------------------------------------------------------------------------
# tunebench: the self-test
# ---------------------------------------------------------------------------

def _tunebench_net():
    """conv -> lrn -> ip -> loss: the 2-op tunable net (one conv key,
    one lrn key) the self-test tunes."""
    from ..models.dsl import (convolution_layer, inner_product_layer, layer,
                              lrn_layer, net_param, softmax_with_loss_layer)
    layers = [
        layer("data", "Input", tops=["data", "label"],
              input_param={"shape": [{"dim": [2, 3, 12, 12]},
                                     {"dim": [2]}]}),
        convolution_layer("c1", "data", "c1", num_output=8, kernel=3,
                          pad=1, weight_filler={"type": "gaussian",
                                                "std": 0.05},
                          bias_filler={"type": "constant", "value": 0.1}),
        lrn_layer("n1", "c1", "n1", local_size=5, alpha=1e-4, beta=0.75),
        inner_product_layer("ip", "n1", "ip", num_output=5,
                            weight_filler={"type": "gaussian",
                                           "std": 0.01}),
        softmax_with_loss_layer("loss", ["ip", "label"]),
    ]
    return net_param("tunebench", layers)


def _grad_rel(a: dict, b: dict) -> float:
    worst = 0.0
    for k in a:
        for x, y in zip(a[k], b[k]):
            x64, y64 = x.double().cpu(), y.double().cpu()
            denom = float(x64.abs().max()) or 1.0
            worst = max(worst, float((x64 - y64).abs().max()) / denom)
    return worst


def cmd_tunebench(args, dev) -> int:
    import numpy as np
    import tempfile
    import torch

    from ..graph import tuner
    from ..graph.net import Net
    from ..proto.caffe_pb import NetState, Phase

    failures: list[str] = []
    t0 = time.monotonic()
    netp = _tunebench_net()
    timing = {"reps": args.reps, "target_s": args.target_s,
              "warmup": args.warmup}

    def build(tune: str) -> Net:
        saved = os.environ.get("SPARKNET_FUSE")
        os.environ.update(SPARKNET_TUNE=tune, SPARKNET_FUSE="off")
        try:
            return Net(netp, NetState(Phase.TRAIN))
        finally:
            os.environ.pop("SPARKNET_TUNE", None)
            if saved is None:
                os.environ.pop("SPARKNET_FUSE")
            else:
                os.environ["SPARKNET_FUSE"] = saved

    # planted_slow: three evaluations of the default on inputs no
    # compiler can prove equal, declared inexact: it must be timed, must
    # lose, and being no bit-copy of the default stays ineligible
    def slow_factory(key, prob):
        base = prob.fns["cuda" if dev.type == "cuda" else "plain"]

        def slow(x):
            return (base(x) + base(x * (1.0 + 1e-5))
                    + base(x * (1.0 - 1e-5))) / 3.0
        return slow

    # planted_bad: declares forward-exact but is off by 9e-4 — the
    # numerics check must disqualify it before it can ever win
    def bad_factory(key, prob):
        native = prob.fns["native"]
        return lambda x, w: native(x, w) * 1.0009

    tuner.clear_extra_candidates()
    tuner.register_candidate(
        "lrn", tuner.Candidate("planted_slow", exact=False, rtol=1e-3,
                               grad_rtol=1e-3,
                               note="tunebench: 3x-work decoy, must lose"),
        slow_factory)
    tuner.register_candidate(
        "conv", tuner.Candidate("planted_bad", exact=True,
                                note="tunebench: wrong numerics, must be "
                                     "disqualified"),
        bad_factory)
    slow_rec, bad_rec, grad_rel = {}, {}, None
    fresh = rot = {"ok": None}
    try:
        probe_net = build("off")
        keys = tuner.keys_for_net(probe_net)
        if sorted({k.op for k in keys}) != ["conv", "lrn"]:
            failures.append(f"expected one conv + one lrn key, got "
                            f"{[str(k) for k in keys]}")
        table = tuner.build_table(keys, device=dev, **timing)
        lrn_e = next(e for e in table.entries if e["op"] == "lrn")
        conv_e = next(e for e in table.entries if e["op"] == "conv")

        slow_rec = lrn_e["timings"].get("planted_slow", {})
        win_ms = lrn_e["timings"][lrn_e["winner"]]["ms"]
        if "ms" not in slow_rec:
            failures.append(f"planted_slow was not timed: {slow_rec}")
        elif slow_rec["ms"] <= win_ms:
            failures.append(
                f"winner {lrn_e['winner']} ({win_ms} ms) did not beat "
                f"the planted 3x-work candidate ({slow_rec['ms']} ms) — "
                f"the timer is not measuring")
        if lrn_e["winner"] == "planted_slow":
            failures.append("planted_slow WON the lrn key")
        bad_rec = conv_e["timings"].get("planted_bad", {})
        if "disqualified" not in bad_rec:
            failures.append(f"planted_bad was not disqualified: {bad_rec}")
        if conv_e["winner"] == "planted_bad":
            failures.append("numerics-failing planted_bad was persisted "
                            "as winner")

        # -- off against the fresh table through the layers -------------
        with tempfile.TemporaryDirectory(prefix="tunebench_") as d:
            table_path = os.path.join(d, "tuning.json")
            table.save(table_path)
            if tuner.TuningTable.load(table_path).table_id() != \
                    table.table_id():
                failures.append("table did not round-trip")
            net_off = build("off")
            net_tab = build(table_path)
        if net_off.tune_plan_id() != "off":
            failures.append(f"SPARKNET_TUNE=off latched "
                            f"{net_off.tune_plan_id()!r}")
        if net_tab.tune_plan_id() != table.table_id():
            failures.append(f"table net latched {net_tab.tune_plan_id()!r}"
                            f" != {table.table_id()!r}")
        params = net_off.init(device=dev)
        r = np.random.default_rng(0)
        ins = {"data": torch.from_numpy(r.normal(
            size=net_off.input_blobs["data"]).astype(np.float32)).to(dev),
            "label": torch.from_numpy(r.integers(
                0, 5, size=net_off.input_blobs["label"]).astype(
                np.float32)).to(dev)}

        def run(net):
            p = {k: [b.detach().clone().requires_grad_(True) for b in v]
                 for k, v in params.items()}
            loss = net.forward(p, ins).loss
            loss.backward()
            return loss.detach(), {k: [b.grad for b in v]
                                   for k, v in p.items()}

        from ..utils.device import full_f32
        with full_f32():
            l_off, g_off = run(net_off)
            l_tab, g_tab = run(net_tab)
        if not torch.equal(l_off, l_tab):
            failures.append(f"forward loss not bit-identical: "
                            f"{float(l_off)!r} (off) vs {float(l_tab)!r} "
                            f"(tuned)")
        grad_rel = _grad_rel(g_off, g_tab)
        if grad_rel > 1e-5:
            failures.append(f"tuned-vs-off gradient divergence "
                            f"{grad_rel:.3e} exceeds 1e-5")

        # -- staleness: the fresh table passes ----------------------------
        fresh = tuner.staleness_check(table, budget_s=60.0, device=dev,
                                      **timing)
        if not fresh["ok"]:
            failures.append(f"fresh table flagged stale: "
                            f"{[x['rotten'] for x in fresh['rotten']]}")

        # -- staleness: a planted rotten winner fails ---------------------
        rot_entries = json.loads(json.dumps(table.entries))
        for e in rot_entries:
            if e["op"] == "lrn":
                e["winner"] = "planted_slow"
                e["margin"] = 0.0
                e["noise_band"] = 0.05
        rot = tuner.staleness_check(
            tuner.TuningTable(table.backend, rot_entries, table.provenance),
            budget_s=60.0, device=dev, **timing)
        if rot["ok"]:
            failures.append("staleness check missed the planted rotten "
                            "winner")
        else:
            bad = next((x for x in rot["rotten"]
                        if x["persisted_winner"] == "planted_slow"), None)
            if bad is None:
                failures.append(f"rot report does not name the planted "
                                f"winner: {rot['rotten']}")
            elif not bad.get("fresh_timings"):
                failures.append("rot report is missing the re-probed "
                                "timings")
    finally:
        tuner.clear_extra_candidates()
        tuner._clear_caches()

    result = {
        "ok": not failures,
        "failures": failures,
        "device": _card(dev),
        "table_id": table.table_id(),
        "winners": {e["key"]: e["winner"] for e in table.entries},
        "planted_slow_ms": slow_rec.get("ms"),
        "planted_bad": bad_rec.get("disqualified"),
        "grad_max_rel": grad_rel,
        "staleness_fresh_ok": fresh["ok"],
        "staleness_planted_caught": rot["ok"] is False,
        "elapsed_s": round(time.monotonic() - t0, 1),
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    if failures:
        _log(f"TUNEBENCH FAILURE: {failures}")
        return 1
    _log(f"tunebench ok in {result['elapsed_s']}s: winners "
         f"{result['winners']}; planted_slow lost, planted_bad "
         f"disqualified, off-vs-tuned bit-identical (grad {grad_rel:.1e}),"
         f" the staleness check catches the planted rot")
    return 0


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="lowering autotuner: measure, persist, re-probe")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, reps=None, target_s=None, warmup=None):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")
        p.add_argument("--reps", type=int, default=reps,
                       help="median-of-k reps (SPARKNET_TUNE_REPS)")
        p.add_argument("--target-s", type=float, default=target_s,
                       help="per-rep wall target on the CPU "
                            "(SPARKNET_TUNE_TARGET_S)")
        p.add_argument("--warmup", type=int, default=warmup,
                       help="discarded warm-up runs "
                            "(SPARKNET_TUNE_WARMUP)")

    p_run = sub.add_parser("run", help="measure the bench nets' keys and "
                                       "write profiles/<backend>/"
                                       "tuning.json")
    common(p_run)
    p_run.add_argument("--batch", type=int, default=256,
                       help="the nets' batch (the bench's, 256)")
    p_run.add_argument("--models", default="caffenet,googlenet")
    p_run.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    p_run.add_argument("--only", default="",
                       help="comma-separated substring filter on keys")
    p_run.add_argument("--out", default=None,
                       help="table path (default: the port's committed "
                            "profiles/<backend>/tuning.json)")
    p_run.add_argument("--ingest", default=None, metavar="LEDGER",
                       help="append the capture to this perf ledger")
    p_run.add_argument("--allow-inexact", action="store_true",
                       help="let non-bit-identical candidates win "
                            "(declared bounds still hold; never a "
                            "candidate that takes a hand kernel off "
                            "the path on cuda)")
    p_run.set_defaults(fn=cmd_run)

    p_st = sub.add_parser("staleness", help="re-probe worst-margin and "
                                            "oldest entries; rc 1 if a "
                                            "winner rotted")
    common(p_st)
    p_st.add_argument("--table", default=None)
    p_st.add_argument("--budget-s", type=float, default=60.0)
    p_st.add_argument("--json", default=None,
                      help="also write the report here")
    p_st.add_argument("--missing-ok", action="store_true",
                      help="rc 0 when no table exists yet")
    p_st.add_argument("--allow-inexact", action="store_true")
    p_st.set_defaults(fn=cmd_staleness)

    p_tb = sub.add_parser("tunebench", help="the self-test")
    common(p_tb, reps=3, target_s=0.02, warmup=1)
    p_tb.add_argument("--json", default=None)
    p_tb.set_defaults(fn=cmd_tunebench)

    args = ap.parse_args(argv)
    from ..utils.device import resolve_device
    dev = resolve_device(args.device)
    os.environ.pop("SPARKNET_TUNE", None)  # measure, don't inherit
    return args.fn(args, dev)


if __name__ == "__main__":
    raise SystemExit(main())
