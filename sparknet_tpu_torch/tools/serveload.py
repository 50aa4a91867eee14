"""Closed-loop serving load generator: latency against offered QPS.

    python -m sparknet_tpu_torch.tools.serveload [--model lenet]
        [--seconds 2] [--clients 8] [--window 16] [--smoke]
        [--url http://...] [--out FILE] [--device cuda|cpu]

The port's copy of the root ``tools/serveload.py`` (its single-engine
half), with the port's ``--device`` (the card unless the caller asks for
the CPU; without a card and without ``--device cpu`` it raises).  It
drives the serving plane (``parallel/serving.py``) with closed-loop
clients and prints one JSON report of the three claims of the serving
subsystem:

(a) **dynamic batching wins**: saturation throughput of the
    micro-batching engine against a batch-1 engine (the same model and
    kernels, shapes pinned to ``(1,)`` and coalescing off).
(b) **overload degrades into typed rejections, not latency collapse**:
    at ``--overload-x`` times the measured saturation QPS the bounded
    queue and admission control keep the p99 of accepted requests under
    ``2·queue/throughput + 5·p99_sat + delay`` while the rejection
    counters absorb the excess.
(c) **batching never changes answers**: every completed request of every
    paced sweep point (and of saturation and overload) is compared bit
    for bit with its solo run at the same batch shape
    (``solo_references``).

The bound is declared as the engine's latency SLO, so ``slo_paced`` (the
SLO monitor after the paced sweep) must read ok and ``slo_overload``
must read breach, with a flight-recorder dump.

Modes: in-process (default) builds the engine here, the full report;
``--url`` drives a running ``tools/serve.py`` over HTTP (the timing and
rejection legs; exactness needs engine-side references and is
skipped); ``--smoke`` is the short gate (a tiny sweep; exit 1 unless
(b), (c) and both SLO verdicts hold).  ``--fleet N`` (replicas behind the
request router) is not ported: it raises naming :data:`FLEET_ITEM`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .serve import FLEET_ITEM


def _log(msg: str) -> None:
    print(f"[serveload] {msg}", file=sys.stderr, flush=True)


class _ReadyFuture:
    """Future of a synchronous transport (one HTTP round trip per client
    thread: remote windows degrade to window=1)."""

    def __init__(self, value):
        self._value = value

    def done(self) -> bool:
        return True

    def result(self, timeout=None):
        return self._value


def make_remote_submit(url: str, model: str, tenant: str):
    """HTTP transport for ``run_closed_loop``: a 429 re-raises as the
    engine's typed ``Overloaded``, so rejections count as in-process."""
    from ..classify import remote_classify
    from ..parallel.serving import Overloaded, ServeResult

    def submit(idx: int, x: np.ndarray) -> _ReadyFuture:
        try:
            d = remote_classify(url, model, x, tenant=tenant)
        except RuntimeError as e:
            if "HTTP 429" in str(e):
                raise Overloaded("queue_full", str(e)) from None
            raise
        return _ReadyFuture(ServeResult(
            model=d["model"], probs=np.asarray(d["probs"], np.float32),
            tenant=tenant, request_id=d["request_id"],
            queue_ms=d["queue_ms"], infer_ms=d["infer_ms"],
            total_ms=d["total_ms"], batch_n=d["batch_n"],
            padded_to=d["padded_to"]))

    return submit


def run_report(model: str = "lenet", weights: str | None = None,
               shapes: tuple[int, ...] | None = None,
               delay_ms: float | None = None, queue: int | None = None,
               dtype: str | None = None, clients: int = 8,
               window: int = 16,
               seconds: float = 2.0, inputs_n: int = 32, seed: int = 0,
               fractions: tuple[float, ...] = (0.25, 0.5, 1.0),
               overload_x: float = 2.0,
               url: str | None = None, device: str = "cuda") -> dict:
    """The full load report (the module docstring says what it holds).
    In-process on ``device`` unless ``url`` is given."""
    from ..parallel.serving import (InferenceEngine, ModelHouse,
                                    ServeConfig, run_closed_loop,
                                    solo_references)
    from ..utils import perfledger
    from ..utils.device import device_label, resolve_device

    base = ServeConfig()
    cfg = ServeConfig(
        batch_shapes=shapes or base.batch_shapes,
        max_delay_ms=base.max_delay_ms if delay_ms is None else delay_ms,
        max_queue=queue or base.max_queue,
        dtype=dtype or base.dtype, seed=seed)
    rng = np.random.default_rng(seed)

    report: dict = {
        "metric": "serving_dynamic_vs_batch1_speedup_x",
        "unit": "x",
        "model": model,
        "mode": "remote" if url else "in_process",
        "clients": clients,
        "window": window,
        "seconds_per_point": seconds,
        "batch_shapes": list(cfg.batch_shapes),
        "max_delay_ms": cfg.max_delay_ms,
        "max_queue": cfg.max_queue,
        "dtype": cfg.dtype,
    }

    engine = None
    batch1 = None
    if url:
        from ..classify import http_json
        info = http_json(f"{url.rstrip('/')}/v1/models")["models"]
        if model not in info:
            raise SystemExit(f"server has no model {model!r} "
                             f"(loaded: {sorted(info)})")
        in_shape = tuple(info[model]["in_shape"])
        inputs = [rng.normal(size=in_shape).astype(np.float32)
                  for _ in range(inputs_n)]
        refs = None
        submit = make_remote_submit(url.rstrip("/"), model, "loadgen")
    else:
        dev = resolve_device(device)
        house = ModelHouse(cfg, device=dev)
        lm = house.load(model, weights=weights)
        report["model_info"] = lm.info()
        inputs = [rng.normal(size=lm.in_shape).astype(np.float32)
                  for _ in range(inputs_n)]
        _log(f"building solo references over {len(cfg.batch_shapes)} "
             f"shapes × {inputs_n} inputs")
        refs = solo_references(lm, inputs)
        submit = None

        # leg (a)'s baseline: batch-1 serving, the same kernels, the
        # harness off
        b1cfg = ServeConfig(batch_shapes=(1,), max_delay_ms=0.0,
                            max_queue=cfg.max_queue, dtype=cfg.dtype,
                            seed=seed)
        b1house = ModelHouse(b1cfg, device=dev)
        b1house.load(model, weights=weights)
        with InferenceEngine(b1house, b1cfg) as b1eng:
            batch1 = run_closed_loop(b1eng, model, inputs,
                                     clients=clients, window=window,
                                     duration_s=seconds)
            # the port's one key beyond the JAX report's: the batch-1
            # engine's dispatches (the bench counts forwards on the card)
            batch1["dispatches"] = b1eng.stats()["dispatches"]
        _log(f"batch1 saturation: {batch1['achieved_qps']} qps "
             f"(p50 {batch1['p50_ms']} ms)")
        report["batch1"] = batch1
        engine = InferenceEngine(house, cfg)

    try:
        # dynamic saturation (leg (a)'s numerator, the yardstick of (b))
        sat = run_closed_loop(engine, model, inputs, clients=clients,
                              window=window, duration_s=seconds, refs=refs,
                              submit=submit)
        _log(f"dynamic saturation: {sat['achieved_qps']} qps "
             f"(p50 {sat['p50_ms']} ms, p99 {sat['p99_ms']} ms)")
        report["saturation"] = sat
        sat_qps = max(sat["achieved_qps"], 1.0)

        # the p99 bound: the queue's drain time at the measured throughput
        # (doubled for slack) + the deadline + 5x the saturation p99;
        # crossing it means the queue is not bounding latency.  Declared
        # as the engine's latency SLO so the slo_* verdicts judge against
        # the bound this run measured.
        p99_bound_ms = (2000.0 * cfg.max_queue / sat_qps
                        + 5.0 * max(sat["p99_ms"], 1.0) + cfg.max_delay_ms)
        report["p99_bound_ms"] = round(p99_bound_ms, 1)
        if engine is not None:
            engine.slo.p99_ms = p99_bound_ms
            # fence off the saturation probe: its rejections are the
            # probe working, not the paced legs' budget
            engine.slo.reset()

        # the paced sweep with the exactness audit at every point (c)
        sweep = []
        for frac in fractions:
            point = run_closed_loop(engine, model, inputs, clients=clients,
                                    window=window, duration_s=seconds,
                                    offered_qps=max(frac * sat_qps, 1.0),
                                    refs=refs, submit=submit)
            point["fraction_of_saturation"] = frac
            _log(f"sweep {frac:.2f}x ({point['offered_qps']} qps offered): "
                 f"achieved {point['achieved_qps']} "
                 f"p50 {point['p50_ms']} p99 {point['p99_ms']} "
                 f"rejected {point['rejected']} "
                 f"mismatches {point['exact_mismatches']}")
            sweep.append(point)
        report["sweep"] = sweep
        if engine is not None:
            # the paced traffic must keep both the rejection budget and
            # the declared p99 bound
            report["slo_paced"] = engine.slo.evaluate()
            _log(f"slo after paced sweep: {report['slo_paced']['state']} "
                 f"(burn fast "
                 f"{report['slo_paced']['windows']['fast']['burn']}x)")

        # the overload leg (b): overload_x times saturation through the
        # bounded queue.  The clients' concurrency must exceed the
        # admission bound, or the closed loop never offers more than the
        # engine accepts: the window grows until clients*window overfills
        # the queue.
        over_window = max(window,
                          (int(1.5 * cfg.max_queue) + clients - 1) // clients)
        over = run_closed_loop(engine, model, inputs, clients=clients,
                               window=over_window, duration_s=seconds,
                               offered_qps=overload_x * sat_qps,
                               refs=refs, submit=submit)
        over["fraction_of_saturation"] = overload_x
        report["overload"] = over
        _log(f"overload {overload_x}x: achieved {over['achieved_qps']} "
             f"p99 {over['p99_ms']} (bound {p99_bound_ms:.0f}) "
             f"rejected {over['rejected']}")
        if engine is not None:
            # the typed rejections burn the budget, so this leg must
            # breach, with a flight-recorder dump of the windows
            report["slo_overload"] = engine.slo.evaluate()
            _log(f"slo under overload: {report['slo_overload']['state']} "
                 f"(burn fast "
                 f"{report['slo_overload']['windows']['fast']['burn']}x, "
                 f"dumps {report['slo_overload']['flight_dumps']})")
            report["engine_stats"] = engine.stats()
    finally:
        if engine is not None:
            engine.stop()

    if not url:
        report["device"] = device_label(dev)
    report["provenance"] = perfledger.provenance(perfledger.fingerprint(
        model=model, dtype=cfg.dtype, batch=max(cfg.batch_shapes),
        world=1, device=report.get("device")))

    mismatches = sum(p["exact_mismatches"] or 0 for p in sweep)
    mismatches += sat["exact_mismatches"] or 0
    mismatches += over["exact_mismatches"] or 0
    speedup = (round(sat["achieved_qps"]
                     / max(batch1["achieved_qps"], 1e-9), 2)
               if batch1 else None)
    report["value"] = speedup
    report["verdicts"] = {
        # (a) the harness's win at saturation
        "batching_speedup_x": speedup,
        "batching_beats_4x": (None if speedup is None else speedup >= 4.0),
        # (b) bounded p99, typed rejections, no throughput collapse
        "overload_rejected": over["rejected"],
        "overload_p99_bounded": over["p99_ms"] <= p99_bound_ms,
        "overload_no_collapse": over["achieved_qps"] >= 0.5 * sat_qps,
        # (c) bit-identical to solo runs at every swept QPS
        "exact_mismatches": None if refs is None else mismatches,
        "bit_identical": None if refs is None else mismatches == 0,
        # the SLO monitor's verdicts (in-process only)
        "slo_paced_healthy": (report.get("slo_paced", {}).get("state")
                              == "ok" if not url else None),
        "slo_overload_breached": (
            report.get("slo_overload", {}).get("state") == "breach"
            if not url else None),
    }
    return report


def smoke_failures(report: dict) -> list[str]:
    """What ``--smoke`` fails on: mismatches, an overload p99 over its
    bound, no rejections under overload, a paced breach, or no breach
    under overload."""
    v = report["verdicts"]
    bad = []
    if v["bit_identical"] is False:
        bad.append(f"{v['exact_mismatches']} result mismatches vs solo "
                   f"references")
    if not v["overload_p99_bounded"]:
        bad.append(f"overload p99 {report['overload']['p99_ms']} ms over "
                   f"bound {report['p99_bound_ms']} ms")
    if not v["overload_rejected"]:
        bad.append("overload produced zero rejections (admission control "
                   "never engaged)")
    if v["slo_paced_healthy"] is False:
        bad.append("SLO monitor reported a breach under paced traffic")
    if v["slo_overload_breached"] is False:
        bad.append("SLO monitor failed to declare a breach under "
                   "overload")
    return bad


def run_fleet_report(*args, **kwargs) -> dict:
    """The fleet legs (N replicas behind the request router): not
    ported."""
    raise NotImplementedError(f"serveload's fleet legs are not ported "
                              f"yet ({FLEET_ITEM})")


def fleet_cli(args) -> int:
    """The ``--fleet N`` entry: not ported."""
    raise NotImplementedError(f"serveload --fleet {args.fleet} is not "
                              f"ported yet ({FLEET_ITEM})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="closed-loop serving load "
                                             "generator")
    ap.add_argument("--model", default="lenet")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--shapes", default=None,
                    help="batch shapes, e.g. 1,4,16,64")
    ap.add_argument("--delay-ms", type=float, default=None)
    ap.add_argument("--queue", type=int, default=None)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default=None)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--window", type=int, default=16,
                    help="outstanding requests per client (total "
                         "concurrency = clients*window)")
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="duration per sweep point")
    ap.add_argument("--inputs", type=int, default=32,
                    help="distinct-input pool size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--overload-x", type=float, default=2.0)
    ap.add_argument("--url", default=None,
                    help="drive a running tools/serve.py instead of an "
                         "in-process engine")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help=f"the fleet legs (not ported: {FLEET_ITEM})")
    ap.add_argument("--fleet-devices", type=int, default=None,
                    help=f"the fleet's device budget (not ported: "
                         f"{FLEET_ITEM})")
    ap.add_argument("--isolation-model", default="cifar10_quick",
                    help=f"the fleet's bystander model (not ported: "
                         f"{FLEET_ITEM})")
    ap.add_argument("--workdir", default=None,
                    help=f"the fleet's state dir (not ported: "
                         f"{FLEET_ITEM})")
    ap.add_argument("--out", default=None, help="write the JSON report "
                                                "here (stdout always)")
    ap.add_argument("--smoke", action="store_true",
                    help="gate: bounded p99 under overload and "
                         "bit-identical results; exit 1 on a violation")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.fleet:
        return fleet_cli(args)
    if args.fleet_devices is not None or args.workdir is not None:
        raise NotImplementedError(f"--fleet-devices and --workdir belong "
                                  f"to --fleet ({FLEET_ITEM})")

    if args.smoke:
        args.seconds = min(args.seconds, 0.4)
        args.clients = min(args.clients, 4)
        args.window = min(args.window, 16)
        args.queue = args.queue or 32   # overload must trip the bound
        shapes = (1, 4, 8)
        # paced below saturation: pacing at capacity on the smoke's tiny
        # queue rejects legitimately
        fractions = (0.5,)
    else:
        shapes = (tuple(int(s) for s in args.shapes.split(","))
                  if args.shapes else None)
        fractions = (0.25, 0.5, 1.0)

    report = run_report(
        model=args.model, weights=args.weights, shapes=shapes,
        delay_ms=args.delay_ms, queue=args.queue, dtype=args.dtype,
        clients=args.clients, window=args.window, seconds=args.seconds,
        inputs_n=args.inputs, seed=args.seed, fractions=fractions,
        overload_x=args.overload_x, url=args.url, device=args.device)
    report["captured_at"] = time.strftime("%Y-%m-%dT%H:%M:%S%z")
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    if args.smoke:
        bad = smoke_failures(report)
        if bad:
            _log("SMOKE FAIL: " + "; ".join(bad))
            return 1
        v = report["verdicts"]
        _log(f"smoke ok: speedup {v['batching_speedup_x']}x, overload "
             f"p99 {report['overload']['p99_ms']} ms "
             f"<= {report['p99_bound_ms']} ms with "
             f"{v['overload_rejected']} rejections, bit-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
