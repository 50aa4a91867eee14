"""Closed-loop serving load generator: latency against offered QPS.

    python -m sparknet_tpu_torch.tools.serveload [--model lenet]
        [--seconds 2] [--clients 8] [--window 16] [--smoke]
        [--url http://...] [--out FILE] [--device cuda|cpu]

The port's copy of the root ``tools/serveload.py``, with the port's
``--device`` (the card unless the caller asks for the CPU; without a card
and without ``--device cpu`` it raises).  It
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
(b), (c) and both SLO verdicts hold).

``--fleet N`` (:func:`run_fleet_report`) runs N replicas as serve-kind
fleet jobs behind the request router, each a process of
``sparknet_tpu_torch.tools.serve`` on ``--device``: a solo baseline
through the router, N-replica saturation, a replica SIGKILLed under
load (typed failover, no wrong answer, the fleet healed back to N), a
drain-based scale-down that completes every admitted request, and
tenant isolation with the autoscaler reacting to the hot model.  Every
answer of every leg is held bit for bit against an in-process solo
reference.  The scaling gate (>= 0.8 N) is off: every replica shares
the one device, and the report says so in ``scaling_gate_reason``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


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


# ---------------------------------------------------------------------------
# Fleet legs: N replicas behind the request router, as fleet tenants
# ---------------------------------------------------------------------------

def _paced_with_midpoint(router, model, inputs, refs, *, clients, window,
                         seconds, qps, midpoint, tenant="loadgen"):
    """One paced closed loop with a ``midpoint()`` action fired halfway
    through (the kill / scale-down injection point); returns (report,
    midpoint result)."""
    import threading

    from ..parallel.serving import run_closed_loop

    result = {}

    def fire():
        time.sleep(seconds / 2.0)
        try:
            result["value"] = midpoint()
        except Exception as e:   # surface, don't kill the load thread
            result["error"] = repr(e)

    t = threading.Thread(target=fire, daemon=True)
    t.start()
    rep = run_closed_loop(
        None, model, inputs, clients=clients, window=window,
        duration_s=seconds, offered_qps=qps, refs=refs,
        timeout_s=20.0, tenant=tenant,
        submit=lambda idx, x: router.submit(model, x, tenant=tenant))
    t.join(timeout=seconds + 10.0)
    return rep, result


def run_fleet_report(model: str = "lenet", replicas: int = 3,
                     devices: int | None = None,
                     shapes: tuple[int, ...] = (1, 4, 8),
                     delay_ms: float | None = None,
                     queue: int | None = None, dtype: str | None = None,
                     clients: int = 8, seconds: float = 2.0,
                     inputs_n: int = 16, seed: int = 0,
                     isolation_model: str | None = "cifar10_quick",
                     workdir: str | None = None,
                     device: str = "cuda") -> dict:
    """The fleet acceptance story, one JSON report:

    (a) **scale-out**: saturation qps through the router at N replicas
        vs one replica (same knobs).  The JAX tool gates the >= 0.8*N
        claim on cores >= N; here every replica shares the one device
        of ``--device``, so ``fleet_scales_0p8N`` is None, on the card
        and on the CPU alike, and ``scaling_gate_reason`` says why.
    (b) **exactness**: every completed request in every leg is compared
        bit-for-bit against an in-process solo reference built from the
        same config + seed (replica processes init identical params).
    (c) **failover**: one replica SIGKILLed mid-leg; typed failover
        only, zero request errors, zero hangs, and the fleet heals (the
        ResilientRunner relaunches the replica, the router re-admits
        it).
    (d) **lossless scale-down**: a replica drained + released mid-leg;
        every admitted request completes, the job ends COMPLETED.
    (e) **tenant isolation**: the main model driven at 2x saturation
        while ``isolation_model`` stays paced at 0.5x its own — the
        bystander's ``GET /slo`` must stay ok while the hot model's
        autoscaler reacts (scale-up recorded, or up_blocked + typed
        rejections absorbing the excess).
    """
    import os
    import signal as _signal
    import tempfile

    from ..classify import http_json
    from ..parallel.autoscale import (
        Autoscaler, AutoscaleConfig, fleet_stats_fn,
    )
    from ..parallel.fleet import COMPLETED, FleetJournal
    from ..parallel.router import RouterConfig, ServingFleet
    from ..parallel.serving import (
        ModelHouse, ServeConfig, run_closed_loop, solo_references,
    )
    from ..utils import perfledger
    from ..utils.device import device_label, resolve_device

    dev = resolve_device(device)

    base = ServeConfig()
    cfg = ServeConfig(
        batch_shapes=shapes or base.batch_shapes,
        max_delay_ms=base.max_delay_ms if delay_ms is None else delay_ms,
        max_queue=queue or base.max_queue,
        dtype=dtype or base.dtype, seed=seed)
    rng = np.random.default_rng(seed)
    cores = os.cpu_count() or 1
    # every replica runs on the one device the fleet hands them all
    # (``--device``), so the scaling claim is never gated
    gate_reason = (f"not gated: the {replicas} replica(s) share one device "
                   f"({dev}); the ratio measures how they share it, not "
                   f"the architecture")
    devices = devices or replicas + 1
    workdir = workdir or tempfile.mkdtemp(prefix="sparknet-fleetload-")

    serve_env = {
        "SPARKNET_SERVE_SHAPES": ",".join(str(s)
                                          for s in cfg.batch_shapes),
        "SPARKNET_SERVE_MAX_DELAY_MS": str(cfg.max_delay_ms),
        "SPARKNET_SERVE_QUEUE": str(cfg.max_queue),
        "SPARKNET_SERVE_DTYPE": cfg.dtype,
    }
    report: dict = {
        "metric": "serving_fleet_scaling_x",
        "unit": "x",
        "model": model,
        "replicas": replicas,
        "devices": devices,
        "cores": cores,
        "clients": clients,
        "seconds_per_point": seconds,
        "batch_shapes": list(cfg.batch_shapes),
        "max_delay_ms": cfg.max_delay_ms,
        "max_queue": cfg.max_queue,
        "dtype": cfg.dtype,
        "workdir": workdir,
    }

    # in-process references: same config + seed as every replica, so the
    # remote fleet must be bit-identical to this house's solo rows
    _log(f"building local reference model + solo references for "
         f"{model!r}")
    ref_house = ModelHouse(cfg, device=dev)
    ref_lm = ref_house.load(model)
    inputs = [rng.normal(size=ref_lm.in_shape).astype(np.float32)
              for _ in range(inputs_n)]
    refs = solo_references(ref_lm, inputs)

    fleet = ServingFleet(
        workdir, devices, serve_env=serve_env,
        router_cfg=RouterConfig(spill_depth=max(cfg.batch_shapes)),
        replica_timeout_s=20.0, preempt_grace_s=15.0, device=dev.type)
    autoscaler = Autoscaler(
        fleet_stats_fn(fleet), fleet.scale_up, fleet.scale_down,
        cfg=AutoscaleConfig(max_replicas=max(replicas + 1, 2),
                            up_queue=4.0, cooldown_s=2.0,
                            down_idle_s=3600.0, sample_every_s=0.25),
        state_path=os.path.join(workdir, "autoscale.json"))
    router = fleet.router
    try:
        # -- (a) solo baseline through the router, then the full fleet -
        fleet.ensure(model, 1)
        fleet.run_background()
        fleet.wait_ready(model, 1, timeout_s=240.0)
        _log("replica 1 ready — measuring single-replica saturation")
        solo = run_closed_loop(
            None, model, inputs, clients=clients, window=1,
            duration_s=seconds, refs=refs, timeout_s=20.0,
            submit=lambda idx, x: router.submit(model, x,
                                                tenant="loadgen"))
        _log(f"solo: {solo['achieved_qps']} qps "
             f"(p99 {solo['p99_ms']} ms)")
        report["solo"] = solo

        fleet.ensure(model, replicas)
        fleet.wait_ready(model, replicas, timeout_s=240.0)
        _log(f"{replicas} replicas ready — measuring fleet saturation")
        sat = run_closed_loop(
            None, model, inputs, clients=clients, window=1,
            duration_s=seconds, refs=refs, timeout_s=20.0,
            submit=lambda idx, x: router.submit(model, x,
                                                tenant="loadgen"))
        report["saturation"] = sat
        sat_qps = max(sat["achieved_qps"], 1.0)
        scaling = round(sat["achieved_qps"]
                        / max(replicas * solo["achieved_qps"], 1e-9), 3)
        report["value"] = scaling
        _log(f"fleet: {sat['achieved_qps']} qps across {replicas} "
             f"replicas = {scaling}x per-replica scaling "
             f"({gate_reason})")
        # autoscaler joins only now: a scale-up racing the baseline
        # legs would steal cycles from the very numbers being compared
        fleet.attach_autoscaler(autoscaler)
        autoscaler.start()

        # -- paced leg: healthy traffic, exactness audited -------------
        paced, _ = _paced_with_midpoint(
            router, model, inputs, refs, clients=clients, window=1,
            seconds=seconds, qps=max(0.5 * sat_qps, 2.0),
            midpoint=lambda: None)
        report["paced"] = paced
        _log(f"paced 0.5x: errors {paced['errors']} "
             f"mismatches {paced['exact_mismatches']}")

        # -- (c) chaos: SIGKILL one replica mid-leg --------------------
        victim = router.home(model)
        victim_pid = router.stats()["replicas"][victim].get("pid")
        killed_routed: dict = {}

        def kill():
            _log(f"killing replica {victim} (pid {victim_pid})")
            # what the router had routed to it: a killed process writes
            # no record of its own
            rec = router.stats()["replicas"].get(victim, {})
            killed_routed.update({k: rec.get(k) for k in (
                "completed", "failed", "outstanding")})
            killed_routed["t_kill"] = time.monotonic()
            os.kill(int(victim_pid), _signal.SIGKILL)
            return victim

        chaos, killed = _paced_with_midpoint(
            router, model, inputs, refs, clients=clients, window=1,
            seconds=max(seconds, 1.0), qps=max(0.4 * sat_qps, 2.0),
            midpoint=kill)
        chaos["killed_replica"] = killed.get("value") or killed
        chaos["killed_pid"] = victim_pid
        chaos["killed_replica_routed"] = killed_routed
        report["chaos"] = chaos
        counts = router.stats()["counts"]
        report["router_counts_after_chaos"] = dict(counts)
        _log(f"chaos: errors {chaos['errors']} "
             f"mismatches {chaos['exact_mismatches']} "
             f"failovers {counts['failovers']} deaths {counts['deaths']}")
        # the ResilientRunner must heal the fleet back to N
        recovered = True
        try:
            fleet.wait_ready(model, replicas, timeout_s=240.0)
        except TimeoutError:
            recovered = False
        report["chaos"]["recovered"] = recovered
        # seconds from the SIGKILL to N replicas answering again
        t_kill = killed_routed.pop("t_kill", None)
        report["chaos"]["heal_s"] = (
            round(time.monotonic() - t_kill, 3)
            if recovered and t_kill is not None else None)
        _log(f"fleet healed to {replicas} replicas: {recovered}")

        # -- (d) lossless scale-down mid-load --------------------------
        drain_result: dict = {}

        def scale_down():
            rid = fleet.scale_down(model)
            drain_result["rid"] = rid
            return rid

        drain, _ = _paced_with_midpoint(
            router, model, inputs, refs, clients=clients, window=1,
            seconds=max(seconds, 1.0), qps=max(0.4 * sat_qps, 2.0),
            midpoint=scale_down)
        rid = drain_result.get("rid")
        deadline = time.monotonic() + 60.0
        released = False
        while time.monotonic() < deadline and rid:
            job = fleet.sched.jobs.get(rid)
            if job is not None and job.state == COMPLETED:
                released = True
                break
            time.sleep(0.1)
        drain_events = [e for e in FleetJournal.read(
            os.path.join(workdir, "fleet_journal.jsonl"))
            if e.get("ev") == "drain_done" and e.get("job") == rid]
        drain.update(
            released_replica=rid, released_completed=released,
            drain_clean=bool(drain_events and drain_events[-1]
                             .get("ok")))
        report["drain"] = drain
        _log(f"drain: released {rid} completed={released} "
             f"clean={drain['drain_clean']} errors {drain['errors']} "
             f"mismatches {drain['exact_mismatches']}")

        # -- (e) tenant isolation under single-model overload ----------
        if isolation_model:
            iso: dict = {"model": isolation_model}
            fleet.ensure(isolation_model, 1)
            fleet.wait_ready(isolation_model, 1, timeout_s=240.0)
            iso_rng = np.random.default_rng(seed + 1)
            iso_lm = ref_house.load(isolation_model)
            iso_inputs = [iso_rng.normal(size=iso_lm.in_shape)
                          .astype(np.float32) for _ in range(inputs_n)]
            iso_refs = solo_references(iso_lm, iso_inputs)
            probe = run_closed_loop(
                None, isolation_model, iso_inputs, clients=2, window=1,
                duration_s=min(seconds, 1.0), timeout_s=20.0,
                submit=lambda idx, x: router.submit(
                    isolation_model, x, tenant="bystander"))
            iso["bystander_saturation_qps"] = probe["achieved_qps"]
            results: dict = {}

            def hot():
                results["hot"] = run_closed_loop(
                    None, model, inputs, clients=clients,
                    window=max(2, (2 * cfg.max_queue) // clients
                               // max(replicas, 1)),
                    duration_s=seconds,
                    offered_qps=2.0 * sat_qps, refs=refs,
                    timeout_s=20.0,
                    submit=lambda idx, x: router.submit(
                        model, x, tenant="hot"))

            t = __import__("threading").Thread(target=hot, daemon=True)
            t.start()
            results["bystander"] = run_closed_loop(
                None, isolation_model, iso_inputs, clients=2, window=1,
                duration_s=seconds,
                offered_qps=max(0.5 * probe["achieved_qps"], 1.0),
                refs=iso_refs, timeout_s=20.0,
                submit=lambda idx, x: router.submit(
                    isolation_model, x, tenant="bystander"))
            # the bystander's own replica must still answer "SLO ok"
            # while the hot model burns — per-model verdict, straight
            # from the replica's GET /slo
            slo_docs = {}
            for brid in router.replica_ids(model=isolation_model,
                                           live_only=True):
                url = fleet._endpoints.get(brid)
                if url:
                    try:
                        slo_docs[brid] = http_json(f"{url}/slo",
                                                   timeout=10.0)
                    except RuntimeError as e:
                        slo_docs[brid] = {"state": "breach",
                                          "error": str(e)}
            t.join(timeout=seconds + 30.0)
            iso["hot"] = results.get("hot")
            iso["bystander"] = results.get("bystander")
            iso["bystander_slo"] = slo_docs
            iso["bystander_slo_ok"] = bool(slo_docs) and all(
                d.get("state") == "ok" for d in slo_docs.values())
            iso["autoscale_reaction"] = autoscaler.last.get(model)
            hot_rep = results.get("hot") or {}
            iso["hot_absorbed_typed"] = (hot_rep.get("rejected", 0) > 0
                                         or hot_rep.get("errors", 1) == 0)
            report["isolation"] = iso
            _log(f"isolation: bystander slo_ok="
                 f"{iso['bystander_slo_ok']} errors "
                 f"{(iso['bystander'] or {}).get('errors')} "
                 f"mismatches "
                 f"{(iso['bystander'] or {}).get('exact_mismatches')} | "
                 f"hot rejected {hot_rep.get('rejected')} "
                 f"autoscale {iso['autoscale_reaction']}")

        report["router"] = router.stats()
        report["autoscale"] = {m: dict(d)
                               for m, d in autoscaler.last.items()}
    finally:
        fleet.stop()

    report["device"] = device_label(dev)
    report["provenance"] = perfledger.provenance(perfledger.fingerprint(
        model=model, dtype=cfg.dtype, batch=max(cfg.batch_shapes),
        world=1, device=report["device"], replicas=replicas))

    legs = [report.get(k) for k in ("solo", "saturation", "paced",
                                    "chaos", "drain")]
    legs += [(report.get("isolation") or {}).get("hot"),
             (report.get("isolation") or {}).get("bystander")]
    mismatches = sum((p or {}).get("exact_mismatches") or 0
                     for p in legs)
    counts = report["router"]["counts"]
    iso = report.get("isolation") or {}
    report["verdicts"] = {
        # (a) scale-out: the replicas share one device, so not gated
        "fleet_scaling_x": scaling,
        "scaling_gated": False,
        "scaling_gate_reason": gate_reason,
        "fleet_scales_0p8N": None,
        # (b) exactness across every leg, remote replicas vs local solo
        "exact_mismatches": mismatches,
        "bit_identical": mismatches == 0,
        # (c) failover: typed-only, zero errors, healed
        "chaos_errors": report["chaos"]["errors"],
        "chaos_failover_engaged": counts["failovers"] > 0,
        "chaos_recovered": report["chaos"]["recovered"],
        # (d) lossless scale-down
        "drain_errors": report["drain"]["errors"],
        "drain_clean": report["drain"]["drain_clean"],
        "drain_released_completed": report["drain"]
        ["released_completed"],
        # (e) isolation (None when the leg was skipped)
        "bystander_slo_ok": iso.get("bystander_slo_ok"),
        "bystander_errors": (iso.get("bystander") or {}).get("errors"),
        "hot_model_reacted": (
            None if not iso else bool(iso.get("autoscale_reaction"))
            or iso.get("hot_absorbed_typed")),
    }
    return report


def fleet_failures(report: dict) -> list[str]:
    """The fleet report's violated contracts (empty when it passes):
    exactness, typed failover, healing, lossless drain, and the scaling
    gate where it is on."""
    v = report["verdicts"]
    bad = []
    if not v["bit_identical"]:
        bad.append(f"{v['exact_mismatches']} mismatches vs solo "
                   f"references")
    if report["paced"]["errors"]:
        bad.append(f"paced leg saw {report['paced']['errors']} "
                   f"request errors")
    if v["chaos_errors"]:
        bad.append(f"replica kill leaked {v['chaos_errors']} "
                   f"request errors past failover")
    if not v["chaos_failover_engaged"]:
        bad.append("replica kill produced zero failovers (the "
                   "router never noticed)")
    if not v["chaos_recovered"]:
        bad.append("fleet never healed back to N replicas")
    if v["drain_errors"]:
        bad.append(f"scale-down dropped {v['drain_errors']} "
                   f"admitted requests")
    if not v["drain_clean"] or not v["drain_released_completed"]:
        bad.append("scale-down did not drain cleanly to COMPLETED")
    return bad


def fleet_cli(args) -> int:
    """The ``--fleet N`` entry: run the fleet report, smoke-assert the
    lossless/typed/exact contracts when ``--smoke``."""
    if args.smoke:
        args.seconds = min(args.seconds, 0.8)
        args.clients = min(args.clients, 4)
        args.isolation_model = ""      # the ~10s budget skips it
        devices = args.fleet_devices or args.fleet
    else:
        devices = args.fleet_devices or args.fleet + 1
    report = run_fleet_report(
        model=args.model, replicas=args.fleet, devices=devices,
        shapes=(tuple(int(s) for s in args.shapes.split(","))
                if args.shapes else (1, 4, 8)),
        delay_ms=args.delay_ms, queue=args.queue or 64,
        dtype=args.dtype, clients=args.clients, seconds=args.seconds,
        inputs_n=min(args.inputs, 16), seed=args.seed,
        isolation_model=args.isolation_model or None,
        workdir=args.workdir, device=args.device)
    report["captured_at"] = time.strftime("%Y-%m-%dT%H:%M:%S%z")
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    if args.smoke:
        v = report["verdicts"]
        bad = fleet_failures(report)
        if bad:
            _log("FLEET SMOKE FAIL: " + "; ".join(bad))
            return 1
        scaling_note = (f"{v['fleet_scaling_x']}x/replica "
                        f"({v['scaling_gate_reason']})")
        _log(f"fleet smoke ok: {scaling_note}, failovers "
             f"{report['router']['counts']['failovers']}, drain clean, "
             f"bit-identical")
    return 0


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
                    help="fleet mode: N replicas as fleet tenants behind "
                         "the request router (scale-out, failover, drain, "
                         "isolation legs)")
    ap.add_argument("--fleet-devices", type=int, default=None,
                    help="device budget for --fleet (default N+1; N "
                         "with --smoke)")
    ap.add_argument("--isolation-model", default="cifar10_quick",
                    help="bystander model for the --fleet isolation leg "
                         "('' skips it)")
    ap.add_argument("--workdir", default=None,
                    help="fleet state dir for --fleet (default: temp)")
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
