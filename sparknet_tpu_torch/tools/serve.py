"""Long-lived inference server over the serving plane.

The port's own copy of the root ``tools/serve.py`` (its single mode), with
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

With SPARKNET_HEARTBEAT_DIR set the engine writes serving beacons.  The
ready line on stdout starts with ``serving on http://``.  ``--fleet N``
(replicas behind a request router) is not ported: it and each of its
``--fleet-*`` flags raise naming :data:`FLEET_ITEM`.  ``--endpoint-file`` publishes {url, pid, models}
atomically once the socket is up.
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

FLEET_ITEM = "ROADMAP A11, fleet half (A12)"


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
                    help=f"fleet mode: N serving replicas per model behind "
                         f"a request router (not ported: {FLEET_ITEM})")
    # the fleet's own flags, kept for the JAX tool's command lines: each
    # raises as --fleet does
    ap.add_argument("--fleet-devices", type=int, default=None,
                    help=f"device budget for the replica fleet (not "
                         f"ported: {FLEET_ITEM})")
    ap.add_argument("--fleet-workdir", default=None,
                    help=f"fleet state dir (not ported: {FLEET_ITEM})")
    ap.add_argument("--fleet-tenant", default=None,
                    help=f"tenant the replica jobs bill against (not "
                         f"ported: {FLEET_ITEM})")
    ap.add_argument("--fleet-priority", type=int, default=None,
                    help=f"priority of the replica jobs (not ported: "
                         f"{FLEET_ITEM})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fleet_flags = [f"--{k.replace('_', '-')}" for k, v in vars(args).items()
                   if k.startswith("fleet") and v]
    if fleet_flags:
        return fleet_main(fleet_flags)

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


def fleet_main(flags: list[str]) -> int:
    """``--fleet N`` and its flags: replicas behind the request router
    and the autoscaler.  Not ported; never falls back to single mode."""
    raise NotImplementedError(
        f"serve {' '.join(flags)}: replica fleets behind a request router "
        f"are not ported yet ({FLEET_ITEM})")


if __name__ == "__main__":
    sys.exit(main())
