"""Long-lived inference server over the serving plane.

The port's own copy of the root ``tools/serve.py``, with
the port's ``--device`` (cuda unless the caller asks for the CPU).  A thin
stdlib-HTTP shell around ``parallel/serving.py``: the engine owns dynamic
micro-batching, admission control, hot load and evict, the SLO monitor and
the health beacons; this process owns the sockets and the JSON wire
format.  Models load, every serving batch shape run once as warm-up,
before the socket opens, so the request path never meets a first call.

Endpoints:
  POST /v1/classify      {"model": m, "tenant": t, "shape": [C,H,W],
                          "dtype": "float32"|"uint8",
                          "data_b64": <raw little-endian bytes>}
                         (or "data": nested lists) ->
                         {"probs": [...], "top": k, "queue_ms": ...,
                          "infer_ms": ..., "total_ms": ...,
                          "batch_n": n, "padded_to": s}
                         429 on admission rejection (typed reason),
                         404 unknown model, 503 engine dead.
  GET  /healthz          engine liveness and stats (503 when dead).
  GET  /slo              declared-SLO verdict (serving.SLOMonitor): 200
                         while healthy, 503 on breach (the breaching
                         windows are dumped through the flight recorder).
  GET  /metrics          Prometheus text of the telemetry registry.
  GET  /v1/models        loaded models with shapes, classes and bytes (and
                         version and channel for registry loads).
  POST /v1/models/load   {"name": m, "weights": path?} hot-loads; or
                         {"model": m, "version": v} loads a published
                         registry version (needs SPARKNET_REGISTRY_DIR)
                         under its versioned key m@v.
  POST /v1/models/evict  {"name": m}.

/v1/classify takes an optional "version": v, which pins the request to
that published version (serving name m@v).  --models takes versioned
specs ("lenet@mv-abc123") that load from the registry; the strictest p99
their manifests declare becomes the SLO bound unless --slo-p99-ms sets
one.

Usage:
  python -m sparknet_tpu_torch.tools.serve --models lenet,caffenet \
      --port 8100 --shapes 1,4,16,64 --max-delay-ms 5 --queue-depth 256 \
      --quota acme=200 --hbm-budget-mb 2048 --dtype bf16 [--device cpu]
  python -m sparknet_tpu_torch.tools.serve --models caffenet --fleet 2 \
      --port 8100 --dtype f32 [--device cpu]

With SPARKNET_HEARTBEAT_DIR set the engine writes serving beacons.  The
ready line on stdout starts with ``serving on http://``.
``--endpoint-file`` publishes {url, pid, models} atomically once the
socket is up.

``--fleet N`` runs N replicas per model as serve-kind jobs of a
``FleetScheduler`` (each a process of this tool with the front's
``--device``, configured through the ``SPARKNET_SERVE_*`` knobs of
:func:`serve_env_from`), the request router at the front and the
autoscaler behind it.  The front owns no engine: ``/v1/classify`` routes
(consistent-hash home, depth spill, typed failover), ``/healthz`` gives
the router table and the device budget, ``/fleet`` the scheduler's
status, ``/slo`` the replicas' verdicts, ``/v1/scale`` sets a model's
replica count; ``--fleet-devices``, ``--fleet-workdir``,
``--fleet-tenant`` and ``--fleet-priority`` shape the fleet.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

def decode_array(payload: dict) -> np.ndarray:
    """The wire formats the server accepts: raw-bytes b64 (the fast path,
    what RemoteClassifier sends) or nested lists."""
    if "data_b64" in payload:
        dtype = np.dtype(payload.get("dtype", "float32"))
        arr = np.frombuffer(
            base64.b64decode(payload["data_b64"]), dtype=dtype)
        shape = payload.get("shape")
        if shape:
            arr = arr.reshape([int(d) for d in shape])
        return arr.astype(np.float32)
    if "data" in payload:
        return np.asarray(payload["data"], np.float32)
    raise ValueError("payload needs data_b64 (+shape/dtype) or data")


def make_handler(engine, house):
    from ..parallel.serving import (
        EngineDead, OverBudget, Overloaded, ServingError, UnknownModel,
    )

    class Handler(BaseHTTPRequestHandler):
        # quiet access log: a load generator would drown stderr
        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", "0") or 0)
            if not n:
                return {}
            return json.loads(self.rfile.read(n).decode())

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                st = engine.stats()
                self._send(200 if st["alive"] else 503, st)
            elif self.path == "/slo":
                st = engine.slo.evaluate()
                self._send(200 if st["state"] == "ok" else 503, st)
            elif self.path == "/metrics":
                from ..utils import telemetry
                body = telemetry.get_registry().render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/v1/models":
                models = house.loaded()
                reg = None
                if any(info.get("version") for info in models.values()):
                    from ..parallel.registry import active_registry
                    reg = active_registry()
                if reg is not None:
                    for info in models.values():
                        if info.get("version"):
                            info["channel"] = reg.channel_of(
                                info["name"].partition("@")[0],
                                info["version"])
                self._send(200, {"models": models})
            else:
                self._send(404, {"error": f"no route {self.path!r}"})

        def do_POST(self):  # noqa: N802
            try:
                payload = self._read_json()
            except (ValueError, json.JSONDecodeError) as e:
                return self._send(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path == "/v1/classify":
                    model = payload.get("model", "")
                    if payload.get("version"):
                        # version pin: the request hits exactly that
                        # published version
                        model = f"{model}@{payload['version']}"
                    res = engine.classify(
                        model, decode_array(payload),
                        tenant=str(payload.get("tenant", "anon")),
                        timeout=float(payload.get("timeout_s", 30.0)))
                    return self._send(200, {
                        "model": res.model, "request_id": res.request_id,
                        "probs": [float(p) for p in res.probs],
                        "top": res.top, "queue_ms": res.queue_ms,
                        "infer_ms": res.infer_ms, "total_ms": res.total_ms,
                        "batch_n": res.batch_n, "padded_to": res.padded_to})
                if self.path == "/v1/models/load":
                    if payload.get("version"):
                        # registry path: {"model": m, "version": v} loads
                        # the published bundle under its versioned key
                        lm = house.load_version(
                            payload.get("model") or payload.get("name"),
                            payload["version"],
                            force=(True if payload.get("force")
                                   else None))
                        return self._send(200, {"loaded": lm.info()})
                    lm = house.load(payload["name"],
                                    weights=payload.get("weights"),
                                    force=(True if payload.get("force")
                                           else None))
                    return self._send(200, {"loaded": lm.info()})
                if self.path == "/v1/models/evict":
                    gone = house.evict(payload["name"])
                    return self._send(200 if gone else 404,
                                      {"evicted": bool(gone),
                                       "name": payload["name"]})
                return self._send(404, {"error": f"no route {self.path!r}"})
            except Overloaded as e:
                self._send(429, {"error": str(e), "reason": e.reason})
            except OverBudget as e:
                # 507 Insufficient Storage: the model alone cannot fit the
                # budget; {"force": true} admits it
                self._send(507, {"error": str(e), "reason": "over_budget",
                                 "param_mb": round(e.param_mb, 1),
                                 "budget_mb": e.budget_mb})
            except UnknownModel as e:
                self._send(404, {"error": str(e), "reason": "unknown_model"})
            except EngineDead as e:
                self._send(503, {"error": str(e), "reason": "engine_dead"})
            except (ServingError, TimeoutError, KeyError, ValueError) as e:
                self._send(400, {"error": str(e)})

    return Handler


def make_fleet_handler(fleet):
    """The front endpoint of ``--fleet`` mode: same wire format as a
    single replica, but /v1/classify routes through the request router
    (consistent-hash home + spill + failover) and the observability
    routes aggregate the whole fleet."""
    from ..classify import http_json
    from ..parallel.serving import (
        EngineDead, Overloaded, ServingError, UnknownModel,
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _send(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length", "0") or 0)
            return json.loads(self.rfile.read(n).decode()) if n else {}

        def do_GET(self):  # noqa: N802
            from urllib.parse import parse_qs, urlparse
            u = urlparse(self.path)
            if u.path == "/healthz":
                st = fleet.router.stats()
                live = [r for r, v in st["replicas"].items()
                        if v["state"] == "ACTIVE"]
                self._send(200 if live else 503, {
                    "alive": bool(live), "router": st,
                    "devices": {
                        "total": fleet.sched.allocator.total,
                        "free": fleet.sched.allocator.free_count}})
            elif u.path == "/slo":
                # per-replica verdicts, scoped to ?model= when given —
                # tenant isolation is judged per model, not fleet-wide
                model = (parse_qs(u.query).get("model") or [None])[0]
                docs, ok = {}, True
                for rid in fleet.router.replica_ids(model=model,
                                                    live_only=False):
                    url = fleet._endpoints.get(rid)
                    if not url:
                        continue
                    try:
                        docs[rid] = http_json(f"{url}/slo", timeout=10.0)
                    except RuntimeError as e:
                        if "HTTP 503" in str(e):
                            docs[rid] = {"state": "breach",
                                         "error": str(e)}
                        else:
                            docs[rid] = {"state": "unknown",
                                         "error": str(e)}
                    except OSError as e:
                        docs[rid] = {"state": "unknown",
                                     "error": repr(e)}
                    ok = ok and docs[rid].get("state") == "ok"
                self._send(200 if (ok and docs) else 503,
                           {"state": "ok" if (ok and docs) else "breach",
                            "model": model, "replicas": docs})
            elif u.path == "/fleet":
                self._send(200, fleet.sched.status())
            elif u.path == "/v1/models":
                models: dict = {}
                for r in fleet.router.stats()["replicas"].values():
                    for m in r["models"]:
                        models.setdefault(m, {"replicas": 0})
                        models[m]["replicas"] += 1
                reg = None
                if any("@" in m for m in models):
                    from ..parallel.registry import active_registry
                    reg = active_registry()
                for m, info in models.items():
                    base, sep, ver = m.partition("@")
                    if sep:
                        info["version"] = ver
                        if reg is not None:
                            info["channel"] = reg.channel_of(base, ver)
                self._send(200, {"models": models})
            elif u.path == "/metrics":
                from ..utils import telemetry
                body = telemetry.get_registry().render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"no route {self.path!r}"})

        def do_POST(self):  # noqa: N802
            try:
                payload = self._read_json()
            except (ValueError, json.JSONDecodeError) as e:
                return self._send(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path == "/v1/classify":
                    res = fleet.router.classify(
                        payload.get("model", ""), decode_array(payload),
                        tenant=str(payload.get("tenant", "anon")),
                        timeout=float(payload.get("timeout_s", 30.0)),
                        version=payload.get("version") or None)
                    return self._send(200, {
                        "model": res.model, "request_id": res.request_id,
                        "probs": [float(p) for p in res.probs],
                        "top": res.top, "queue_ms": res.queue_ms,
                        "infer_ms": res.infer_ms, "total_ms": res.total_ms,
                        "batch_n": res.batch_n, "padded_to": res.padded_to})
                if self.path == "/v1/scale":
                    model = payload["model"]
                    want = int(payload["replicas"])
                    have = fleet.active_replica_jobs(model)
                    while len(have) < want and fleet.scale_up(model):
                        have = fleet.active_replica_jobs(model)
                    while len(have) > want \
                            and fleet.scale_down(model) is not None:
                        have = fleet.active_replica_jobs(model)
                    return self._send(200, {"model": model,
                                            "replicas": len(have)})
                return self._send(404, {"error": f"no route {self.path!r}"})
            except Overloaded as e:
                self._send(429, {"error": str(e), "reason": e.reason})
            except UnknownModel as e:
                self._send(404, {"error": str(e),
                                 "reason": "unknown_model"})
            except EngineDead as e:
                self._send(503, {"error": str(e), "reason": "engine_dead"})
            except (ServingError, TimeoutError, KeyError, ValueError) as e:
                self._send(400, {"error": str(e)})

    return Handler


def parse_models(specs) -> list[tuple[str, str | None]]:
    """``lenet,caffenet=weights.caffemodel`` -> [(name, weights|None)]."""
    out = []
    for chunk in specs or ():
        for item in chunk.split(","):
            item = item.strip()
            if not item:
                continue
            name, _, weights = item.partition("=")
            out.append((name, weights or None))
    return out


def parse_quotas(pairs) -> dict[str, float]:
    quotas: dict[str, float] = {}
    for p in pairs or ():
        name, _, val = p.partition("=")
        if not name or not val:
            raise SystemExit(f"bad --quota {p!r} (want tenant=qps)")
        try:
            quotas[name] = float(val)
        except ValueError:
            raise SystemExit(f"bad --quota {p!r}: {val!r} is not a number")
    return quotas


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="micro-batched inference server")
    ap.add_argument("--models", action="append", required=True,
                    metavar="NAME[=WEIGHTS]",
                    help="zoo models to pre-load (comma-separable, "
                         "repeatable); optional =path to .caffemodel/npz "
                         "weights")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100,
                    help="0 picks an ephemeral port (printed on ready)")
    ap.add_argument("--shapes", default=None,
                    help="batch shapes, e.g. 1,4,16,64 "
                         "(default SPARKNET_SERVE_SHAPES)")
    ap.add_argument("--max-delay-ms", type=float, default=None,
                    help="micro-batch coalesce deadline "
                         "(default SPARKNET_SERVE_MAX_DELAY_MS)")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="admission bound (default SPARKNET_SERVE_QUEUE)")
    ap.add_argument("--hbm-budget-mb", type=float, default=None,
                    help="model-house budget (default SPARKNET_SERVE_HBM_MB)")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default=None,
                    help="compute dtype (default SPARKNET_SERVE_DTYPE)")
    ap.add_argument("--quota", action="append", default=[],
                    metavar="TENANT=QPS",
                    help="per-tenant QPS cap (repeatable; '*' caps "
                         "tenants without an explicit entry)")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="declared p99 latency bound for GET /slo "
                         "(default SPARKNET_SLO_P99_MS; unset = latency "
                         "SLO undeclared)")
    ap.add_argument("--slo-reject-budget", type=float, default=None,
                    help="rejection-rate error budget as a fraction "
                         "(default SPARKNET_SLO_REJECT_BUDGET, 0.02)")
    ap.add_argument("--slo-window-s", type=float, default=None,
                    help="slow burn window seconds "
                         "(default SPARKNET_SLO_WINDOW_S, 60)")
    ap.add_argument("--endpoint-file", default=None,
                    help="publish {url, pid, models} here (atomic) once "
                         "the socket is up")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="fleet mode: run N serving replicas per model "
                         "as fleet tenants behind a request router + "
                         "autoscaler, and serve the router at --port")
    ap.add_argument("--fleet-devices", type=int, default=None,
                    help="device budget for the replica fleet "
                         "(default: N x models)")
    ap.add_argument("--fleet-workdir", default=None,
                    help="fleet state dir (journal, replica job dirs, "
                         "autoscale.json/router.json; default: a temp "
                         "dir)")
    ap.add_argument("--fleet-tenant", default="serving",
                    help="tenant the replica jobs bill against")
    ap.add_argument("--fleet-priority", type=int, default=0,
                    help="priority of the replica jobs (training jobs "
                         "above it can preempt them — through drain)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..parallel.serving import InferenceEngine, ModelHouse, ServeConfig

    base = ServeConfig()   # env defaults
    cfg = ServeConfig(
        batch_shapes=(tuple(int(s) for s in args.shapes.split(","))
                      if args.shapes else base.batch_shapes),
        max_delay_ms=(args.max_delay_ms if args.max_delay_ms is not None
                      else base.max_delay_ms),
        max_queue=(args.queue_depth if args.queue_depth is not None
                   else base.max_queue),
        hbm_budget_mb=(args.hbm_budget_mb if args.hbm_budget_mb is not None
                       else base.hbm_budget_mb),
        dtype=args.dtype or base.dtype,
        tenant_qps=parse_quotas(args.quota),
        slo_p99_ms=(args.slo_p99_ms if args.slo_p99_ms is not None
                    else base.slo_p99_ms),
        slo_reject_budget=(args.slo_reject_budget
                           if args.slo_reject_budget is not None
                           else base.slo_reject_budget),
        slo_window_s=(args.slo_window_s if args.slo_window_s is not None
                      else base.slo_window_s))

    # signal handlers first: a server stopped while still warming up
    # exits cleanly instead of dying to the default SIGTERM disposition
    stop = threading.Event()

    def on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    if args.fleet:
        return fleet_main(args, cfg, stop)

    house = ModelHouse(cfg, device=args.device)
    declared_p99: list[float] = []
    for name, weights in parse_models(args.models):
        if stop.is_set():
            print("[serve] stopped during warm-up", file=sys.stderr,
                  flush=True)
            return 0
        if "@" in name:
            # registry spec ("lenet@mv-abc123"): the published bundle
            # resolves the weights; =path would be a second truth
            if weights:
                raise SystemExit(f"--models {name}={weights}: a "
                                 f"versioned spec takes no =weights "
                                 f"(the registry bundle IS the weights)")
            model, version = name.split("@", 1)
            lm = house.load_version(model, version)
            slo = lm.declared_slo
            if isinstance(slo, dict) and slo.get("p99_ms"):
                declared_p99.append(float(slo["p99_ms"]))
        else:
            lm = house.load(name, weights=weights)
        print(f"[serve] loaded {name}: in={lm.in_shape} "
              f"classes={lm.classes} {lm.param_bytes / 2**20:.1f} MB on "
              f"{lm.device}, warmed {len(cfg.batch_shapes)} shapes in "
              f"{lm.warmup_s:.1f}s", file=sys.stderr, flush=True)

    engine = InferenceEngine(house, cfg)
    if cfg.slo_p99_ms is None and declared_p99:
        # the strictest manifest-declared p99 across versioned loads
        engine.slo.p99_ms = min(declared_p99)
    httpd = Server((args.host, args.port), make_handler(engine, house))
    host, port = httpd.server_address[:2]

    server_thread = threading.Thread(target=httpd.serve_forever,
                                     daemon=True)
    server_thread.start()
    # the ready line: tests and operators key off this exact prefix
    print(f"serving on http://{host}:{port} "
          f"(models: {', '.join(sorted(house.loaded()))})", flush=True)
    if args.endpoint_file:
        write_endpoint(args.endpoint_file, host, port,
                       sorted(house.loaded()))
    stop.wait()
    print("[serve] shutting down", file=sys.stderr, flush=True)
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    return 0


def serve_env_from(cfg) -> dict:
    """The ServeConfig as env knobs — how fleet replicas inherit the
    front's serving configuration with no per-replica CLI."""
    env = {
        "SPARKNET_SERVE_SHAPES": ",".join(str(s)
                                          for s in cfg.batch_shapes),
        "SPARKNET_SERVE_MAX_DELAY_MS": str(cfg.max_delay_ms),
        "SPARKNET_SERVE_QUEUE": str(cfg.max_queue),
        "SPARKNET_SERVE_INFLIGHT": str(cfg.inflight_batches),
        "SPARKNET_SERVE_HBM_MB": str(cfg.hbm_budget_mb),
        "SPARKNET_SERVE_DTYPE": cfg.dtype,
        "SPARKNET_SLO_REJECT_BUDGET": str(cfg.slo_reject_budget),
        "SPARKNET_SLO_WINDOW_S": str(cfg.slo_window_s),
        "SPARKNET_SLO_FAST_S": str(cfg.slo_fast_window_s),
    }
    if cfg.tenant_qps:
        env["SPARKNET_SERVE_QUOTAS"] = ",".join(
            f"{t}={q:g}" for t, q in sorted(cfg.tenant_qps.items()))
    if cfg.slo_p99_ms is not None:
        env["SPARKNET_SLO_P99_MS"] = str(cfg.slo_p99_ms)
    return env


def write_endpoint(path: str, host, port: int, models: list) -> None:
    """Atomic endpoint publication (tmp + rename: a reader never sees a
    torn doc)."""
    doc = {"url": f"http://{host}:{port}", "pid": os.getpid(),
           "models": models}
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


class Server(ThreadingHTTPServer):
    """The HTTP server: a thread a request, and a listen backlog that a
    client posting a batch's crops at once (``RemoteClassifier``, up to
    32) does not overflow; socketserver's default of 5 had the kernel
    reset connections under such bursts."""
    daemon_threads = True
    request_queue_size = 128


def fleet_main(args, cfg, stop) -> int:
    """``--fleet N``: N replicas per model as serve-kind fleet tenants,
    the request router at the front, the autoscaler closing the SLO
    loop.  The front process owns no engine — replicas are subprocesses
    the FleetScheduler placed, each a full single-model server started
    with the front's ``--device``."""
    import tempfile

    from ..parallel.autoscale import Autoscaler, fleet_stats_fn
    from ..parallel.router import ServingFleet
    from ..utils.device import resolve_device

    model_specs = [name if not weights else f"{name}={weights}"
                   for name, weights in parse_models(args.models)]
    if not model_specs:
        raise SystemExit("--fleet needs at least one --models entry")
    device = resolve_device(args.device).type   # no card: raise here
    devices = args.fleet_devices or args.fleet * len(model_specs)
    workdir = args.fleet_workdir or tempfile.mkdtemp(
        prefix="sparknet-servefleet-")
    fleet = ServingFleet(
        workdir, devices, tenant=args.fleet_tenant,
        priority=args.fleet_priority, serve_env=serve_env_from(cfg),
        device=device)
    autoscaler = Autoscaler(
        fleet_stats_fn(fleet), fleet.scale_up, fleet.scale_down,
        state_path=os.path.join(workdir, "autoscale.json"))
    for spec in model_specs:
        fleet.ensure(spec, args.fleet)
    fleet.run_background()
    try:
        for spec in model_specs:
            fleet.wait_ready(spec, args.fleet, timeout_s=300.0)
    except TimeoutError as e:
        print(f"[serve] fleet never became ready: {e}", file=sys.stderr,
              flush=True)
        fleet.stop()
        return 1
    # the autoscaler starts once every replica answers: started with the
    # fleet, its idle rule can release a replica still in its cold start
    # (a CaffeNet replica on an H100 took longer than the idle window)
    fleet.attach_autoscaler(autoscaler)
    autoscaler.start()

    httpd = Server((args.host, args.port), make_fleet_handler(fleet))
    host, port = httpd.server_address[:2]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    print(f"serving on http://{host}:{port} "
          f"(fleet: {args.fleet} replica(s) x "
          f"{', '.join(model_specs)}; workdir {workdir})", flush=True)
    if args.endpoint_file:
        write_endpoint(args.endpoint_file, host, port, model_specs)
    stop.wait()
    print("[serve] shutting the fleet down", file=sys.stderr, flush=True)
    httpd.shutdown()
    fleet.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
